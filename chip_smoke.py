#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

Three paths, each at the full width of a model the repository supports, with
random weights drawn from seed 0:

* DLRM training at ``bench.py`` width: a 1,000,000 x 16 embedding table
  stored in bf16 with stochastic-rounding Adam, bottom MLP 13→512→256→64→16,
  top MLP (729+16)→512→256→1, batch 8192 (212,992 ids a step), lr 1e-3, on
  ``SyntheticCTR`` batches;
* BST training at ``benchmarks/bench_models.py::bench_bst`` width
  (``bst_amazon_b1024_T100``, f32 tables): item table 400,000 x 18, cat
  table 1,500 x 18, 2 post-LN blocks of 4 heads (Dh 9, FFN 144) over
  history + target (L 101), max_len 512, MLP 72→200→80→1 with input
  BatchNorm, batch 1024, lr 1e-3, on ``SyntheticSequence`` batches, with
  flash attention (the K2 kernels) on both blocks; and the same BST at the
  TPU flash probe's history of 1,000 (batch 128), whose L 1,001 takes K2's
  long backward route;
* DIEN training at ``benchmarks/bench_models.py::bench_dien`` width
  (``dien_amazon_b1024_T100``): the same two tables, masked GRU and AUGRU of
  36 hidden units over a history of 100, the auxiliary net and loss, MLP
  72→200→80→1 with input BatchNorm, batch 1024, lr 1e-3, with f32 and with
  bf16 tables; DIN at the same width; DIEN at history 1,000 (batch 128) with
  and without rematerialized recurrences; and the
  ``recommender_tpu_torch.cli.train_dien`` entry point with a checkpoint and
  a resume;
* the CTR family through ``recommender_tpu_torch.cli.train_ctr`` at
  ``bench.py`` width (DLRM with dedup plans off and on, DeepFM, DCN, the
  .npz shard stream, a resume) and ``recommender_tpu_torch.cli.predict``
  scoring its checkpoint;
* MMOE and ESMM at ``benchmarks/bench_models.py::bench_mmoe_large`` width
  (per-table f32 and bf16 tables, and the stacked table), the
  ``cli.train_esmm`` entry point with a resume, and ``cli.predict --family
  esmm``; EGES at ``bench_models.py::bench_eges`` width and the
  ``cli.train_eges`` entry point (BGE, GES, EGES, per-path update scales,
  an int8 export);
* retrieval and serving: PinSage at ``bench_models.py::bench_pinsage``
  width and the ``cli.train_pinsage`` entry point with its f32, int8 and
  IVF bundles served by ``cli.serve``; ``cli.train_twotower`` at the
  RESULTS protocol's width; ``serve_topk`` on a 2M x 128 corpus (f32 and
  int8, query batches of 1 to 1,024) and IVF at ``exp_ivf.py --quick``
  width;
* distribution at ``bench.py``'s DLRM width: ``cli.train_ctr`` launched as
  a one-rank NCCL job, and as two ranks on this card with the table
  row-sharded (psum and all-to-all exchanges), data-parallel training, a
  skewed all-to-all, the two-tower's cross-rank negatives, and a
  checkpoint written at mesh (1, 2) and resumed at (1, 1). One card holds
  the two ranks, and NCCL refuses two ranks on one device, so they run over
  gloo through the port's one-card transport (their times are not NCCL's).

Run from the repository root (it builds the CUDA kernels from the sources
in this checkout at first use, into build/recommender_tpu_torch/):

    python3 chip_smoke.py

Phases, one JSON line each (k2 one per shape):

1. device       — the card, its power limit, torch and CUDA versions; TF32 off.
2. build        — build and load K1 (sorted scatter-add) and K2 (flash
                  attention forward, and backward), one ``nvcc`` per
                  source, started together, and the host's dedup-plan
                  library (``make -C native``) beside them.
3. k1           — K1 against its plain PyTorch version at the DLRM shape
                  (212,992 ids into [1M, 16]): f32 and bf16 rounding, with
                  and without ``order``, with ids >= V; at BST's item and
                  cat history lookups (102,400 ids into [400,000, 18] and
                  [1,500, 18]); at DIEN's negative-history lookup (f32 and
                  bf16) and at the ``shared_gather`` lookup (205,824 ids:
                  target, positive and negative history in one); and at the
                  DLRM shape with bf16 + ``order``
                  for the worst skew (every id equal) and its uniform twin
                  (ids uniform in [0, 1M)), whose times must stay within 2x;
                  the dedup'd lookup's two calls at DLRM b8192 with a bf16
                  cotangent on a real batch's plan (the segment sum of the
                  212,992 rows into [U_cap, 16], then the unique rows into
                  [1M, 16]); MMOE's per-table lookup (8,192 ids into
                  [100,000, 18], f32 and bf16 cotangents) and its stacked
                  one (147,456 ids into [1.8M, 18]); EGES's output table
                  (24,576 ids into [100,000, 128]), cat table (4,096 ids
                  into [200, 128]) and weight table (4,096 ids into
                  [100,000, 3]); PinSage's year and id tables (18,432 ids
                  into [81, 8] and [3,706, 8]) and the two-tower's (1,024
                  ids into [6,000, 32] and [3,700, 32]); bitwise
                  repeatability; kernel and plain times (CUDA events,
                  median of 25).
4. k2           — K2 (forward and backward) against ``flash_mha_ref`` at
                  BST's shape (B 1024, L 101, H 4, Dh 9, ``valid`` from a
                  real batch; fused forward and backward), at L 128 (fused)
                  and L 129 (long routes), B 256, and at the TPU probe's
                  B 128, L 1001, H 4 with Dh 9, 64 and 128 (long routes);
                  then the Dh > 64 kernels at BST's rows with one head of
                  Dh 128 (long forward, fused backward) and of Dh 72
                  (fused both ways), and Dh 256 at B 256, H 2 (long
                  forward, fused backward): the
                  routes ``fwd_route`` and ``bwd_route`` pick, errors,
                  bitwise repeatability; times of the forward, of forward +
                  backward, of the backward and of each kernel alone
                  (``kernel_ms``: the forward's route, the backward's;
                  ``fwd_long_route``, ``fwd_fused_route``,
                  ``bwd_long_route`` and ``bwd_fused_route`` hold the time
                  and error of the route not taken, on the same inputs,
                  where it takes the shape), against the plain version and
                  against
                  ``scaled_dot_product_attention`` with the same mask (the
                  yardstick, and the backend it took); each kernel's bound
                  from bytes and FLOPs, and its share (CUDA events, median
                  of 25); above Dh 64 each wide kernel's registers, local
                  memory bytes and blocks an SM (``kernel_info``: the
                  forward on its route, the fused backward or the long
                  backward's two; the other routes' beside their times).
                  Then ``k2_routes``: both routes of each direction alone
                  at 17 wide shapes on BST's rows (L 33-101, H 1-2, Dh
                  65-256: ``K2_ROUTE_SWEEP``), which one each rule picks
                  and which one was faster.
5. train        — 50 DLRM Trainer steps at full width, then ``evaluate`` on
                  20 held-out batches; K1's launch count must equal the steps.
6. card_cpu     — a small f32-table DLRM for 3 steps from one init on the
                  card and on the CPU; the losses must agree.
7. bst_train    — 50 BST Trainer steps at full width with flash attention,
                  then ``evaluate`` on 20 held-out batches; the K1 and K2
                  launch counts must be exact (the fused forward and
                  backward only).
                  Then the same 50 steps with the plain attention from the
                  same init: the per-step losses must agree.
8. bst_long     — 5 BST Trainer steps at history 1,000, batch 128, with
                  flash attention (exact launch counts: the long forward
                  and the long backward's dK/dV and dQ kernels only), then
                  with plain attention
                  from the same init: the losses must agree.
9. bst_card_cpu — a small BST for 3 steps from one init on the card (K2)
                  and on the CPU (its plain version); the losses must agree.
    bst_dh128   — BST on the same data with item_dim = cat_dim = 64 and one
                  head (Dh 128): 30 steps with flash attention (exact K2
                  launch counts on the Dh > 64 kernels: the long forward,
                  the fused backward), then 30 from the same init with
                  plain attention: the losses must agree.
10. dien_train  — 50 DIEN Trainer steps at full width (f32 tables, the
                  auxiliary-loss task), then ``evaluate`` on 20 held-out
                  batches; K1 must launch exactly 6 times a step. Then 10
                  steps with bf16 tables and stochastic rounding, and 10 with
                  ``shared_gather`` (K1 exactly 2 a step, the f32 run's losses).
11. din_train   — 20 DIN Trainer steps at the same width; K1 exactly 4 a step.
12. dien_long   — DIEN at history 1,000, batch 128: 3 steps with the
                  recurrences rematerialized (the default above 256 steps) and
                  3 from the same init without; the losses must agree.
13. dien_card_cpu — a small DIEN for 3 steps from one init on the card and on
                  the CPU; the losses must agree.
14. dien_cli    — ``cli.train_dien.main`` on the card (``--synthetic``, DIEN,
                  a checkpoint directory under build/): the final exact eval
                  AUC must clear 0.5 by ``DIEN_CLI_AUC_MARGIN``; then the same
                  command for half the steps and ``--resume`` for the rest:
                  the final parameters must equal the straight run's bit for
                  bit.
15. ctr_cli     — ``cli.train_ctr.main`` on the card at ``bench.py`` width
                  (``CTR_ARGS``): DLRM 100 steps with dedup plans off (K1 once
                  a step), on (twice), on and off again, the same per-step
                  losses in each pair, final exact eval AUC > 0.7; DeepFM and DCN 50 steps each; 20
                  steps of the .npz shard stream with two workers; 80
                  steps straight against 40 + ``--resume`` 40 (dedup on,
                  the warmup + cosine schedule): every parameter and moment
                  bit for bit. Each run's synced ms/step, examples/s and the
                  host's put and enqueue times.
16. ctr_predict — ``cli.predict.main`` on the card from the resumed
                  checkpoint at b8192: its scores equal the restored model's
                  eval forward on the same batches; examples/s.
    accum       — gradient accumulation at ``bench.py`` width: the
                  Trainer's f32 gradients of one b8192 batch at
                  ``accum_steps`` 4 against the four quarter batches run one
                  by one and averaged (bit for bit, or within
                  ``ACCUM_GRAD_REL_TOL``); ``cli.train_ctr --accum_steps 4``
                  and 1, 20 steps each: the losses within ``ACCUM_LOSS_TOL``,
                  ms a step and peak device memory of each.
    profiling   — ``core.profiling.trace`` around 5 DLRM steps, each step's
                  copy and step in an ``annotate`` mark: the trace file names
                  both marks and K1's kernels.
17. mmoe_train  — MMOE at ``bench_models.py::bench_mmoe_large`` width (18
                  tables of 100,000 x 18, 8 experts 324→200→80, 2 gates,
                  towers 80→40→1, b8192), 50 steps each with per-table f32
                  tables (K1 18 a step), per-table bf16 tables with
                  stochastic rounding, and one stacked [1.8M, 18] f32 table
                  from the per-table run's init (K1 once a step; the losses
                  must agree); then 20 ESMM steps. Synced ms/step, the
                  host's enqueue and put, peak memory.
18. mt_graph_card_cpu — a small MMOE and a small EGES, 3 steps each from
                  one init on the card and on the CPU; the losses must agree.
19. esmm_cli    — ``cli.train_esmm.main`` on the card (``--synthetic``): ESMM,
                  MMOE and BASE, each with CVR / CTCVR AUC guards; MMOE 80
                  steps straight against 40 + ``--resume`` 40, bit for bit;
                  ``cli.predict --family esmm`` on that checkpoint: the three
                  heads equal the restored model's eval forward.
20. eges_train  — EGES at ``bench_models.py::bench_eges`` width (100,000
                  nodes, 2,000,000 edges, D 128, b4096), 50 steps through
                  ``Trainer.fit`` with the native walk sampler in its
                  prefetch thread (K1 5 a step); the sampler alone.
21. eges_cli    — ``cli.train_eges.main`` on the card (``--synthetic``): BGE,
                  GES, EGES and EGES with ``--shared_lr_scale 0.5``, each
                  scored by link prediction on intra-community pairs.
22. eges_export — ``cli.train_eges --export --export_int8``: the bundle holds
                  the trained model's corpus, quantized; ``cli.serve`` once.
23. pinsage_train — PinSage at ``bench_pinsage`` width (6,040 users, 3,706
                  items, 900,000 edges, embed 8, conv 64 / 32): b512 30
                  steps on one resident batch, 50 with the native sampler
                  in 3 prefetch threads, b32 50 steps; K1 exactly 4 a step;
                  the sampler alone.
24. pinsage_cli — ``cli.train_pinsage.main`` on the card (``--synthetic``,
                  300 steps) exported f32, int8 and int8 + IVF, each served
                  by ``cli.serve.main`` (``--items``, ``--all --out``):
                  community similarity and hit-rate guards, int8 against
                  f32 top-10 overlap and top-1, IVF at full probes equal
                  to int8 brute force, 150 + ``--resume`` 150 bit for bit.
                  (The k1 phase also times K1 at the row-sharded DLRM
                  table's two backward shapes on shard 0 [500,000, 16].)
25. twotower_cli — ``cli.train_twotower.main --data_dir`` at the RESULTS
                  protocol's width (written as MovieLens files), exported
                  int8 and served; ``tests/test_two_tower.py``'s set-up
                  through the Trainer (hit rate > 0.25).
26. serve_corpus — ``serve_topk`` on a 2M x 128 clustered corpus made on the
                  card: f32 and int8 in-memory bundles, Q 1, 16, 256 and
                  1,024, 200 requests each: p50 / p99 ms, requests/s, peak
                  memory, bound, int8 against f32 overlap; the ids against
                  a plain top-k of the whole product; IVF at ``exp_ivf.py
                  --quick`` width: build seconds, spill share, recall
                  against int8 brute force at 8 and 32 probes.
27. retrieval_card_cpu — a small PinSage and a small two-tower, 3 steps each
                  from one init on the card and on the CPU, then served:
                  the losses must agree.
28. dist_reference — single-process runs (no process group): ``cli.train_ctr``
                  at ``DIST_ARGS`` for 20 steps (1M x 16 bf16 + SR-Adam,
                  b8192), 20 DLRM Trainer steps at b8192 and 20 two-tower
                  steps at the RESULTS width, b1024, each as shipped and
                  with f32 tables and MLPs; DLRM's first batch also in
                  two halves (``_half_batch_step``).
29. dist_nccl1  — ``cli.train_ctr`` launched with ``--coordinator_address
                  127.0.0.1:P --num_processes 1 --process_id 0`` (NCCL):
                  the losses equal the unlaunched run's bit for bit.
                  Each dist phase's ms a step is the median of its last
                  half of steps; its first half times each collective
                  between syncs (the transport's ms and its share of
                  those serialized steps).
30. dist_sharded — two ranks on this card (gloo), ``--mesh_model 2``: with
                  ``--lookup_mode psum`` the losses and every trained param
                  equal the single-process run's bit for bit; with ``a2a``
                  (capacity 2.0) the losses within ``DIST_A2A_LOSS_TOL``;
                  each rank's shard is [500,000, 16], K1 launches once a
                  step per rank, the dense params are equal across ranks;
                  ms a step per rank and the transport's share of it.
31. dist_skew   — the a2a lookup at capacity 1.0 on a batch of Zipf ids:
                  ``a2a_overflow`` > 0, equal to ``a2a_overflow_fraction``
                  x ids x 2 (each rank counts its own copy), the dropped
                  rows 0, the others the table's.
32. dist_dp     — mesh (2, 1), 4,096 rows a rank of each b8192 batch, the
                  table's gradient gathered over the ranks, the rest
                  averaged by the Trainer; as shipped and with an f32
                  table and MLPs (dist_dp_f32): the first step's loss and
                  gradients against one process's two half batches
                  averaged (the dense ones expected bit for bit), the first
                  loss within ``DIST_DP_LOSS_TOL`` of the b8192 run's, the
                  20 within ``DIST_TRAJECTORY_TOL``; an all-reduce of the
                  [1M, 16] f32 table gradient timed beside it. Then
                  dist_twotower: two ranks of 512 against one of 1,024,
                  the in-batch negatives gathered across ranks.
                  dist_dryrun: ``python -m recommender_tpu_torch.dryrun``'s
                  ``main`` on the card in the NCCL rank (1 x 1) and in the
                  two gloo ranks (1, 2): equal finite losses, K1 5 times.
33. dist_checkpoint — the (1, 2) psum run stopped at step 10 with a
                  checkpoint, resumed here at (1, 1) to step 20: every param
                  and moment equal to the uninterrupted run's.

Then it prints the card line from nvidia-smi, a JSON line of the kernels,
and as the last line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile-bst

profiles the BST step instead (``profile_bst``: synced and unsynced step
times, then ``torch.profiler`` over 10 steps), in a process of its own: a
profiler run slows every later launch of the process.

    python3 chip_smoke.py --profile-dien

does the same for the DIEN step (``profile_dien``): launches per step and
device busy time by part of the model (the two recurrences, forward and
backward, attention, auxiliary net, embeddings with K1, head, optimizer).

    python3 chip_smoke.py --profile-mt-graph

does the same for the MMOE step at bench_mmoe_large width (per-table f32,
per-table bf16 + SR, stacked f32) and the EGES step at bench_eges width
(``profile_mt_graph``).

    python3 chip_smoke.py --fwd-occupancy

times K2's forward as built against the same source with its register
limits at 1 (``fwd_occupancy``), each at the k2 shape its limit governs.

    python3 chip_smoke.py --dist

runs the distribution phases (28-33) alone, after the build, and

    python3 chip_smoke.py --probe-gloo-cuda

asks two ranks on this card which of the port's four collectives gloo
takes on CUDA tensors (``probe_gloo_cuda``), and

    python3 chip_smoke.py --k2

runs phase k2 alone (every K2 kernel against ``flash_mha_ref`` at its
nine cases, with times, bounds and SDPA's, then ``k2_routes``), after the
build, and

    python3 chip_smoke.py --ptxas

compiles the K2 sources with ``nvcc -Xptxas -v`` and prints each kernel's
registers, spill bytes and stack (``ptxas_report``).

Any failed check raises, so the script exits non-zero without the last
line. It exits non-zero at once where no CUDA device is available.
"""
from __future__ import annotations

import bisect
import contextlib
import copy
import ctypes
import functools
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F

from recommender_tpu_torch.cli import (
    predict,
    serve,
    train_ctr,
    train_dien,
    train_eges,
    train_esmm,
    train_pinsage,
    train_twotower,
)
from recommender_tpu_torch.core import profiling
from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import (
    SyntheticCTR,
    SyntheticMultiTask,
    SyntheticSequence,
    batch_iterator,
    criteo,
    dedup,
)
from recommender_tpu_torch.data.movielens import ground_truth_matrix
from recommender_tpu_torch.data.pipeline import prefetch_to_device, with_dedup_plans
from recommender_tpu_torch.graph import WeightedGraph, native, skipgram_batches
from recommender_tpu_torch.graph.bipartite import BipartiteGraph
from recommender_tpu_torch.nn.mlp import MLP
from recommender_tpu_torch.models import (
    BST,
    DIEN,
    DIN,
    DLRM,
    EGES,
    ESMM,
    MMOE,
    ItemFeatures,
    PinSage,
    TwoTower,
    corpus_item_reprs,
    evaluate_head,
    init_model,
    interaction_batches,
    link_prediction_auc,
    make_aux_loss_task,
    make_ctr_task,
    make_head_eval,
    make_multitask_task,
    make_pinsage_task,
    make_skipgram_task,
    make_two_tower_task,
    pinsage_train_batches,
)
from recommender_tpu_torch.ops import _build
from recommender_tpu_torch.ops import embedding_kernels as ek
from recommender_tpu_torch.ops import flash_attention as fa
from recommender_tpu_torch.retrieval import (
    IVFIndex,
    build_ivf,
    export_serving_bundle,
    full_corpus_reprs,
    hit_rate,
    load_serving_bundle,
    quantize_reprs,
    recommend_topk_from_queries,
    search_ivf,
    serve_topk,
)
from recommender_tpu_torch.retrieval import quantize as rq

VOCAB = 1_000_000
DIM = 16
BATCH = 8192
STEPS = 50
TIMED_STEPS = 40  # ms/step: median over the last 40 steps
EVAL_BATCHES = 20
LR = 1e-3
SEED = 0

# K1 vs its plain version: both accumulate in f32, in different orders, so
# a row may differ by f32 roundoff of its sum.
K1_REL_TOL = 1e-5  # of the row's abs-sum
K1_ABS_FLOOR = 1e-6
# K1's time must not follow the longest run: every id equal vs uniform ids
K1_SKEW_RATIO = 2.0
# Eval AUC after 50 steps must clear 0.5 by this margin. Measured on an
# H100 80GB HBM3 (700 W limit): 0.7769 for these seeds; the run is
# deterministic up to GEMM rounding, so 0.2 leaves room without letting a
# model that learned nothing through.
AUC_MARGIN = 0.2
# Card vs CPU losses: the MLPs compute in bf16, and cuBLAS and the CPU's
# bf16 GEMMs round some products to a different bf16 neighbour.
CARD_CPU_LOSS_TOL = 2e-3

# BST at bench_models.py::bench_bst width (bst_amazon_b1024_T100, f32 tables)
BST_ITEMS = 400_000
BST_CATS = 1500
BST_T = 100
BST_BATCH = 1024
# K2 vs flash_mha_ref, as a share of the largest magnitude of the plain
# result: the kernels' exp2 differs from torch's exp by a few ulp and the
# sums run in another order (tests/test_torch_flash_attention.py).
K2_FWD_REL_TOL = 1e-5
K2_BWD_REL_TOL = 1e-4
# Eval AUC of the 50-step BST run must clear 0.5 by this margin. Measured
# on an H100 80GB HBM3 (700 W limit): 0.50371 for these seeds. At lr 1e-3,
# 50 steps of b1024 learn the label rate and little else on this data (the
# loss falls 0.713 → 0.695), so the margin is 0: the check catches a head
# that scores below chance. That training is right is checked by the
# flash and plain runs agreeing, and by bst_card_cpu.
BST_AUC_MARGIN = 0.0
# Flash vs plain attention, 50 steps from one init (measured on that card:
# losses within 1.1e-3; the kernels' last-ulp differences grow through
# Adam, as in tests/test_torch_bst.py): per-step losses and eval AUC.
BST_PATHS_LOSS_TOL = 1e-2
BST_PATHS_AUC_TOL = 5e-3

# BST at the TPU flash probe's shape (benchmarks/logs/bst_flash_r5.log,
# bst_Dh9_T1000_b128): history 1,000, so L 1,001 takes K2's long backward
# route; a few Trainer steps with flash, then with plain attention.
# BST at Dh 128 (phase bst_dh128): item_dim = cat_dim = 64, one head
BST_DH128 = dict(item_dim=64, cat_dim=64, num_heads=1)
BST_DH128_STEPS = 30
# gradient accumulation (phase accum): cli.train_ctr at bench.py width
ACCUM = 4
ACCUM_STEPS = 20
ACCUM_LOSS_TOL = 2e-3  # 20 steps of SR-Adam over 4 microbatches vs 1 batch
ACCUM_GRAD_REL_TOL = 1e-6  # of each tensor's max |grad|, where not bit for bit
# core.profiling (phase profiling)
PROFILE_STEPS = 5
PROFILE_MARKS = ("smoke_put_batch", "smoke_train_step")
BST_LONG_T = 1000
BST_LONG_BATCH = 128
BST_LONG_STEPS = 5

# DIEN and DIN at bench_models.py::bench_dien width (dien_amazon_b1024_T100):
# BST's tables, history and batch; K1 launches per step: one per table and
# id set (target, positive history, and for DIEN the negative history)
DIEN_K1_PER_STEP = 6
DIN_K1_PER_STEP = 4
DIEN_BF16_STEPS = 10
# shared_gather: one lookup per table for the three id sets, so K1 launches
# twice a step; the forward is the same, and the tables' gradients are summed
# in another order, which Adam carries into the later steps' losses
DIEN_SHARED_K1_PER_STEP = 2
DIEN_SHARED_STEPS = 10
DIEN_SHARED_LOSS_TOL = 1e-4
DIN_STEPS = 20
# DIEN at history 1,000, batch 128 (the long-history row of
# benchmarks/RESULTS.md): rematerialized recurrences against stored ones
# from one init. Both compute the same forward; their gradients differ by
# f32 roundoff, which Adam carries into the next step's loss.
DIEN_LONG_STEPS = 3
DIEN_REMAT_LOSS_TOL = 1e-5
# cli.train_dien on the card: DIEN on the default SyntheticSequence (1,000
# items, history 20), batch 128, lr 3e-3 (tests/test_dien.py's learning
# set-up, at the entry point's default widths).
DIEN_CLI_STEPS = 160
DIEN_CLI_ARGS = ("--synthetic", "--model_type", "DIEN", "--history_max_length", "20",
                 "--train_batch_size", "128", "--learning_rate", "3e-3",
                 "--log_every", "40", "--eval_every", "0")
# The final exact eval AUC of that run must clear 0.5 by this margin.
DIEN_CLI_AUC_MARGIN = 0.2

# The CTR family through cli.train_ctr at bench.py width: --synthetic,
# vocab 1M, D 16, b8192, the table in bf16 with stochastic rounding, a log
# point (a sync) at every step, 20 held-out batches for the final exact eval.
CTR_ARGS = ("--synthetic", "--vocab_size", str(VOCAB), "--embedding_size", str(DIM),
            "--train_batch_size", str(BATCH), "--test_batch_size", str(BATCH),
            "--eval_batches", str(EVAL_BATCHES), "--embed_dtype", "bf16",
            "--log_every", "1", "--eval_every", "0")
CTR_DLRM_STEPS = 100  # with dedup plans off, on, on, off (the host's speed drifts)
CTR_OTHER_STEPS = 50  # DeepFM, DCN
CTR_SHARD_STEPS = 20  # the .npz shard stream, two workers
CTR_SHARDS, CTR_SHARD_ROWS = 4, 5 * BATCH
CTR_RESUME_STEPS = 80  # straight, against half + --resume half
CTR_RESUME_ARGS = ("--dedup_lookup", "on", "--lr_schedule", "dlrm", "--warmup_steps", "20",
                   "--decay_steps", "100", "--log_every", "40")
# Dedup on against off, per-step losses: tests/test_torch_dedup.py finds
# the two backwards' gradients equal bit for bit (each id's rows are summed
# in the same stable sorted order, then each unique row is moved once), so
# the two runs must take the same steps.
CTR_DEDUP_LOSS_TOL = 0.0
# Final exact eval AUC over 0.5: DLRM's as the train phase's; DeepFM's and
# DCN's after 50 steps set from the first measured run on an H100 80GB
# HBM3 (700 W): 0.653 and 0.788 (deterministic up to GEMM rounding), so
# 0.1 and 0.2 leave room without letting a model that learned nothing
# through.
CTR_AUC_MARGIN = {"DLRM": 0.2, "DeepFM": 0.1, "DCN": 0.2}
# cli.predict's scores against the restored model's eval forward on the
# same batches (the same GEMM shapes, so the same roundings)
PREDICT_TOL = 1e-6
PREDICT_ROWS = EVAL_BATCHES * BATCH + 1000  # the last batch padded

# MMOE and ESMM at bench_models.py::bench_mmoe_large width (mmoe_aliccp_b8192):
# 18 per-feature tables of 100,000 x 18, 8 experts of 324→200→80, 2 softmax
# gates, towers 80→40→1; ESMM's towers 324→360→200→80→1; batch 8192 of
# SyntheticMultiTask rows. K1 launches per step: one per table, or one for
# the stacked [1.8M, 18] table.
MT_VOCAB, MT_FEATS, MT_DIM, MT_BATCH = 100_000, 18, 18, 8192
MT_STEPS = 50  # per-table f32, per-table bf16 + SR, stacked f32
ESMM_STEPS = 20
MT_K1_PER_STEP, MT_STACKED_K1_PER_STEP = MT_FEATS, 1
# stacked against per-table tables from one init: the same function; K1
# sums each row's contributions in other chunks (f32 roundoff), which Adam
# carries into the later steps' losses
MT_STACKED_LOSS_TOL = 1e-4
# cli.train_esmm on the card, on its synthetic set (18 columns of vocab 50);
# MMOE also 40 steps + --resume 40 against the straight run
ESMM_CLI_STEPS = 80
ESMM_CLI_ARGS = ("--synthetic", "--train_batch_size", "1024", "--test_batch_size", "4096",
                 "--learning_rate", "3e-3", "--log_every", "20", "--eval_every", "0")
# Final AUCs over 0.5 (cvr, ctcvr; BASE reports ctcvr only), set from the
# first run on an H100 80GB HBM3 (700 W): ESMM 0.741 / 0.803, MMOE 0.691 /
# 0.795, BASE 0.827 (deterministic up to GEMM rounding); each margin leaves
# ~0.09 of room without letting a model that learned nothing through.
ESMM_CLI_AUC_MARGIN = {"ESMM": (0.15, 0.2), "MMOE": (0.1, 0.2), "BASE": (None, 0.2)}
# EGES at bench_models.py::bench_eges width (eges_device_b4096): a random
# graph of 100,000 nodes and 2,000,000 weighted edges, D 128, cat vocab 200,
# brand vocab 2,000, walks of 10, window 5, 5 negatives, batch 4096; K1
# launches per step: the id, cat, brand, weight and output tables
EGES_V, EGES_EDGES, EGES_DIM, EGES_CATS, EGES_BRANDS = 100_000, 2_000_000, 128, 200, 2000
EGES_BATCH, EGES_STEPS, EGES_K1_PER_STEP = 4096, 50, 5
EGES_SAMPLER_BATCHES = 20  # the host sampler alone
# cli.train_eges on the card, on its synthetic community graph (2,000
# nodes); link-prediction AUC on intra-community pairs against uniform
# negatives over 0.5, margins set from the first run on that card: BGE
# 0.622 (ids alone, 200 steps), GES 0.970, EGES 0.962, EGES with the shared
# tables' updates halved 0.961 (the cat is the community)
EGES_CLI_STEPS = 200
EGES_CLI_ARGS = ("--synthetic", "--learning_rate", "5e-3", "--log_every", "50")
EGES_CLI_RUNS = {"BGE": ("BGE",), "GES": ("GES",), "EGES": ("EGES",),
                 "EGES_shared_0.5": ("EGES", "--shared_lr_scale", "0.5")}
EGES_CLI_K1_PER_STEP = {"BGE": 2, "GES": 4, "EGES": 5}
EGES_CLI_AUC_MARGIN = {"BGE": 0.05, "GES": 0.4, "EGES": 0.4, "EGES_shared_0.5": 0.4}

# PinSage at bench_models.py::bench_pinsage width (pinsage_ml1m): a random
# MovieLens-1M-scale graph (6,040 users, 3,706 items, 900,000 edges, year
# vocab 81, 18 genres), embed 8, conv 64 / 32, 3 neighbours from 4 walks of
# length 2. b512: 30 steps on one resident batch (bench's devicestep),
# then 50 with the native sampler in 3 prefetch threads; b32 (the
# reference batch) 50 steps. K1 launches per step: the year and the id
# table, each looked up for flat1 and for nbr2.
PS_USERS, PS_ITEMS, PS_EDGES, PS_YEARS, PS_GENRES = 6040, 3706, 900_000, 81, 18
PS_BATCH, PS_REF_BATCH, PS_DEVICE_STEPS, PS_STEPS = 512, 32, 30, 50
PS_SAMPLER_WORKERS, PS_SAMPLER_BATCHES, PS_K1_PER_STEP = 3, 20, 4
# cli.train_pinsage on its synthetic set (400 users, 200 items in 8
# communities), b32 at the default lr: f32, int8 and int8 + IVF exports,
# each served by cli.serve; 150 + --resume 150 against the straight run
PS_CLI_STEPS = 300
PS_CLI_ARGS = ("--synthetic", "--log_every", "100")
PS_CLI_IVF_CLUSTERS = 8
PS_CLI_COMMUNITIES = 8
# The final hit rate must clear random retrieval (10 of the ~190 unseen
# items, 0.05) by this margin, set from the first run on an H100 80GB HBM3
# (700 W): 0.1675, as on the CPU; 0.07 leaves 0.05 of room
PS_CLI_HIT_MARGIN = 0.07
# int8 against f32 serving of one corpus (tests/test_export.py's floors)
INT8_OVERLAP_MIN, INT8_TOP1_MIN = 0.9, 0.9
# two-tower at the RESULTS protocol's width (benchmarks/quality_runs.py::
# run_twotower: 6,000 users x 3,700 items in 32 communities, 20 interactions
# a user, 85% in-community), written as MovieLens files and read by
# cli.train_twotower --data_dir: b1024, embed 32, repr 32, tower (64,), lr
# 3e-3; K1 launches per step: the user and item tables
TT_USERS, TT_ITEMS, TT_COMMS, TT_PER_USER, TT_IN_COMM = 6000, 3700, 32, 20, 0.85
TT_CLI_STEPS = 600
TT_CLI_ARGS = ("--train_batch_size", "1024", "--learning_rate", "3e-3", "--log_every", "100")
TT_K1_PER_STEP = 2
# its final hit rate must clear this floor (random retrieval: 10 of ~3,680
# unseen items, 0.003), set from the first run on that card: 0.0705
TT_CLI_HIT_MIN = 0.04
# tests/test_two_tower.py's learning set-up (embed 16, repr 16, tower (32,),
# b256, lr 3e-3, 800 steps on the entry point's synthetic set) and its floor
TT_TEST_STEPS, TT_TEST_HIT_MIN = 800, 0.25
# serving at the TPU probes' width (benchmarks/exp_int8_retrieval.py,
# exp_serving_latency.py): a clustered corpus of 2M x 128 (4,096 centres x 3
# plus unit noise) made on the card from seed 0, queries of 1 to 1,024
# corpus items, top-10 with the query item excluded; 200 requests per case
SERVE_V, SERVE_D, SERVE_CENTRES, SERVE_K = 2_000_000, 128, 4096, 10
SERVE_QS, SERVE_REQUESTS, SERVE_POOLS = (1, 16, 256, 1024), 200, 8
# IVF at benchmarks/exp_ivf.py --quick width: 2^20 x 128 around 512 planted
# centres (x 2, noise 0.5), 1,024 clusters, 8 Lloyd iterations, cap 1.5x;
# 128 queries (a corpus row + noise 0.1) against int8 brute force
IVF_V, IVF_CLUSTERS, IVF_TRUE_C, IVF_ITERS, IVF_Q, IVF_PROBES = 1 << 20, 1024, 512, 8, 128, (8, 32)
# small PinSage and two-tower, card against CPU: PinSage is f32 throughout;
# the two-tower's towers compute in bf16 (CARD_CPU_LOSS_TOL)
PS_CARD_CPU_LOSS_TOL = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense), for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # f32 outside the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
INT8_OPS = 1979e12  # int8 on the tensor cores

K1_SOURCE = "recommender_tpu_torch/ops/csrc/sorted_scatter_add.cu"
K1_REPLACES = "recommender_tpu/ops/embedding_kernels.py:213"
K2_SOURCE = "recommender_tpu_torch/ops/csrc/flash_attention.cu"
K2_BWD_SOURCE = "recommender_tpu_torch/ops/csrc/flash_attention_bwd.cu"
K2_REPLACES = "recommender_tpu/nn/transformer.py:43"
# the Pallas kernels _flash_mha reaches, in jax 0.9.0's
# jax/experimental/pallas/ops/tpu/flash_attention.py
K2_TPU_KERNELS = {
    "fwd": "flash_attention.py:589 _flash_attention_impl",
    "bwd": "flash_attention.py:941 _flash_attention_bwd_dkv and :1287 _flash_attention_bwd_dq",
    "bwd_dkv": "flash_attention.py:941 _flash_attention_bwd_dkv",
    "bwd_dq": "flash_attention.py:1287 _flash_attention_bwd_dq",
}


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms, one CUDA-event pair per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_report() -> dict:
    """Registers, spill bytes and stack of every kernel of the K2 sources,
    as ``nvcc -Xptxas -v`` reports them when it compiles them with the
    port's flags (into a scratch library under the build directory), by
    demangled kernel name."""
    out = {}
    for name in ("flash_attention", "flash_attention_bwd"):
        so = _build.BUILD_DIR / f"ptxas-{name}.so"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               str(so), str(_build.CSRC_DIR / f"{name}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        kernel = None
        for line in proc.stderr.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif kernel and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                            r"(\d+) bytes spill loads", line)):
                out.setdefault(kernel, {}).update(
                    stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
            elif kernel and (m := re.search(r"Used (\d+) registers", line)):
                out.setdefault(kernel, {})["registers"] = int(m[1])
        so.unlink(missing_ok=True)
    filt = Path(_build.nvcc_path()).with_name("cu++filt")
    names = (subprocess.run([str(filt)], input="\n".join(out), capture_output=True,
                            text=True).stdout.split("\n") if filt.exists() else list(out))
    return {demangled or k: v for k, demangled, v in zip(out, names, out.values())}


# ------------------------------------------------------------------ phases
def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit(
        "device",
        nvidia_smi=smi,
        name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(),
        torch=torch.__version__,
        cuda=torch.version.cuda,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )
    return smi


def phase_build():
    names = ("sorted_scatter_add", "flash_attention", "flash_attention_bwd")
    cached = {n: _build.library_path(n).exists() for n in names}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names) + 1) as pool:  # one nvcc per source, together
        # and the host's dedup-plan library (make -C native) beside them
        native = pool.submit(dedup.is_available)
        libs = dict(zip(names, pool.map(_build.build, names)))
    for name in names:
        _build.load(name)
    root = _build.BUILD_DIR.parents[1]
    emit("build", libraries={n: str(so.relative_to(root)) for n, so in libs.items()},
         cached=cached, dedup_plan_native=native.result(), seconds=time.perf_counter() - t0)


def k1_inputs(device):
    """DLRM-shape K1 inputs: the 212,992 ids of one SyntheticCTR batch, of
    which 1,024 are moved past the vocabulary (dropped by K1)."""
    cat = SyntheticCTR(vocab_size=VOCAB, seed=SEED).sample(BATCH, seed=1)["cat_features"]
    raw = cat.reshape(-1).astype(np.int64)
    raw[::208] = VOCAB + np.arange(raw[::208].size)  # 1,024 ids >= V
    raw = torch.from_numpy(raw.astype(np.int32)).to(device)
    sorted_ids, order = torch.sort(raw, stable=True)
    g = torch.Generator(device=device).manual_seed(SEED)
    upd = torch.randn((raw.numel(), DIM), generator=g, device=device)
    return sorted_ids, order.to(torch.int32), upd


def _k1_case(results, name, sorted_ids, u, o, kd, u_sorted, vocab, **info):
    got = ek.sorted_scatter_add(sorted_ids, u, vocab, order=o, kernel_dtype=kd)
    again = ek.sorted_scatter_add(sorted_ids, u, vocab, order=o, kernel_dtype=kd)
    want = ek.sorted_scatter_add_ref(sorted_ids, u, vocab, order=o, kernel_dtype=kd)
    abs_sum = ek.sorted_scatter_add_ref(sorted_ids, u_sorted.abs().contiguous(), vocab)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / (abs_sum + 1e-30)).max())
    within = bool((err <= K1_REL_TOL * abs_sum + K1_ABS_FLOOR).all())
    bitwise = bool(torch.equal(got, again))
    ms = cuda_ms(lambda: ek.sorted_scatter_add(sorted_ids, u, vocab, order=o, kernel_dtype=kd))
    plain_ms = cuda_ms(lambda: ek.sorted_scatter_add_ref(sorted_ids, u, vocab, order=o, kernel_dtype=kd))
    # the yardstick: index_add_ into a fresh zero table, on the updates already
    # permuted, rounded and cut to the ids below vocab
    keep = (sorted_ids >= 0) & (sorted_ids < vocab)  # K1 drops the rest
    lib_ids = sorted_ids[keep].long()
    lib_upd = (u if o is None else u.index_select(0, o.long())).to(kd).float()[keep]
    library_ms = cuda_ms(lambda: torch.zeros((vocab, u.shape[1]), device=u.device).index_add_(
        0, lib_ids, lib_upd))
    # bytes: ids, order, updates read once; the f32 table written once
    n_bytes = (sorted_ids.numel() * 4 * (1 if o is None else 2) + u.numel() * u.element_size()
               + vocab * u.shape[1] * 4)
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    _, counts = torch.unique_consecutive(sorted_ids, return_counts=True)
    emit("k1", case=name, n=int(sorted_ids.numel()), vocab=vocab, dim=int(u.shape[1]),
         unique_ids=int(torch.unique(sorted_ids[keep]).numel()), dropped_ids=int((~keep).sum()),
         longest_run=int(counts.max()), **info,
         max_abs_err=max_abs, max_rel_err=max_rel,
         tolerance=f"|err| <= {K1_REL_TOL} * row abs-sum + {K1_ABS_FLOOR}",
         within_tolerance=within, bitwise_repeatable=bitwise,
         ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes")
    check(within, f"K1 {name} disagrees with its plain version (max abs {max_abs})")
    check(bitwise, f"K1 {name}: two launches differ")
    results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms)


def _k1_ids_case(results, device, name, ids: np.ndarray, dim: int, vocab: int,
                 dtype=torch.float32, **info):
    """K1 on one lookup's ids (sorted stably, with ``order``) and random
    cotangent rows of ``dim`` in ``dtype``, as the lookup's backward calls it."""
    raw = torch.from_numpy(np.ascontiguousarray(ids, np.int32).reshape(-1)).to(device)
    sorted_ids, order = torch.sort(raw, stable=True)
    order = order.to(torch.int32)
    g = torch.Generator(device=device).manual_seed(SEED)
    upd = torch.randn((raw.numel(), dim), generator=g, device=device).to(dtype)
    _k1_case(results, name, sorted_ids, upd, order, torch.float32,
             upd.index_select(0, order.long()).float(), vocab, **info)


def phase_k1(device, seq_batch: dict, mt_batch: dict, eges_batch: dict, ps_batch: dict,
             ps_year: np.ndarray, tt_batch: dict) -> dict:
    sorted_ids, order, upd = k1_inputs(device)
    upd_sorted = upd.index_select(0, order.long()).contiguous()
    upd_bf16 = upd.to(torch.bfloat16)
    cases = [
        # name, updates, order, kernel_dtype, updates in sorted order for the abs-sum
        ("f32_sorted", upd_sorted, None, torch.float32, upd_sorted),
        ("f32_order", upd, order, torch.float32, upd_sorted),
        ("f32_order_kernel_bf16", upd, order, torch.bfloat16,
         upd_sorted.to(torch.bfloat16).float()),
        ("bf16_order", upd_bf16, order, torch.float32,
         upd_bf16.index_select(0, order.long()).float()),
    ]
    results = {}
    for name, u, o, kd, u_sorted in cases:
        _k1_case(results, name, sorted_ids, u, o, kd, u_sorted, VOCAB)
    # BST's history lookup backwards: one real batch's ids, pad id 0 included
    for name, key, vocab in (("bst_item_history_f32_order", "pos_his_item", BST_ITEMS),
                             ("bst_cat_history_f32_order", "pos_his_cat", BST_CATS)):
        raw = torch.from_numpy(seq_batch[key].reshape(-1).astype(np.int32)).to(device)
        sorted_ids, order = torch.sort(raw, stable=True)
        order = order.to(torch.int32)
        g = torch.Generator(device=device).manual_seed(SEED)
        upd = torch.randn((raw.numel(), 18), generator=g, device=device)
        _k1_case(results, name, sorted_ids, upd, order, torch.float32,
                 upd.index_select(0, order.long()), vocab, pad_rows=int((raw == 0).sum()))
    # DIEN's item-table backwards: the negative history (ids uniform over the
    # table at real steps), with an f32 and a bf16 cotangent, and the
    # shared_gather lookup (target, positive and negative history in one)
    neg = seq_batch["neg_his_item"].reshape(-1)
    shared = np.concatenate([seq_batch["target_item"].reshape(-1),
                             seq_batch["pos_his_item"].reshape(-1), neg])
    for name, ids, dtype in (("dien_neg_history_f32_order", neg, torch.float32),
                             ("dien_neg_history_bf16_order", neg, torch.bfloat16),
                             ("dien_shared_gather_f32_order", shared, torch.float32)):
        raw = torch.from_numpy(ids.astype(np.int32)).to(device)
        sorted_ids, order = torch.sort(raw, stable=True)
        order = order.to(torch.int32)
        g = torch.Generator(device=device).manual_seed(SEED)
        upd = torch.randn((raw.numel(), 18), generator=g, device=device).to(dtype)
        _k1_case(results, name, sorted_ids, upd, order, torch.float32,
                 upd.index_select(0, order.long()).float(), BST_ITEMS,
                 pad_rows=int((raw == 0).sum()))
    # skew: every id equal, against ids uniform over the table (bf16 + order)
    n = BATCH * 26
    g = torch.Generator(device=device).manual_seed(SEED)
    upd_bf16 = torch.randn((n, DIM), generator=g, device=device).to(torch.bfloat16)
    for name, raw in (
        ("skew_one_id_bf16_order", torch.full((n,), 12345, dtype=torch.int32, device=device)),
        ("skew_uniform_bf16_order",
         torch.randint(0, VOCAB, (n,), generator=g, device=device, dtype=torch.int32)),
    ):
        sorted_ids, order = torch.sort(raw, stable=True)
        order = order.to(torch.int32)
        _k1_case(results, name, sorted_ids, upd_bf16, order, torch.float32,
                 upd_bf16.index_select(0, order.long()).float(), VOCAB)
    ratio = results["skew_one_id_bf16_order"]["ms"] / results["skew_uniform_bf16_order"]["ms"]
    emit("k1_skew", one_id_over_uniform=ratio, limit=K1_SKEW_RATIO)
    check(ratio <= K1_SKEW_RATIO, f"K1 with one id takes {ratio:.2f}x its uniform-id time")
    # the dedup'd lookup's backward at DLRM b8192 with a bf16 cotangent, on
    # the plan of a real batch: the segment sum of the 212,992 rows into
    # the U_cap unique slots, then the unique rows into the table
    cat = SyntheticCTR(vocab_size=VOCAB, seed=SEED).sample(BATCH, seed=1)["cat_features"]
    (planned,) = with_dedup_plans(iter([{"cat_features": cat}]))
    plan = {k: torch.from_numpy(v).to(device) for k, v in planned["cat_dedup"].items()}
    u_cap = plan["uniq"].numel()
    g = torch.Generator(device=device).manual_seed(SEED)
    cot = torch.randn((cat.size, DIM), generator=g, device=device).to(torch.bfloat16)
    _k1_case(results, "dedup_segment_sum_bf16_order", plan["slot"], cot, plan["perm"],
             torch.float32, cot.index_select(0, plan["perm"].long()).float(), u_cap,
             u_cap=u_cap)
    d_uniq = ek.sorted_scatter_add_ref(plan["slot"], cot, u_cap, order=plan["perm"]).to(torch.bfloat16)
    _k1_case(results, "dedup_uniq_scatter_bf16", plan["uniq"], d_uniq, None, torch.float32,
             d_uniq.float(), VOCAB, u_cap=u_cap,
             pad_ids=int((plan["uniq"] >= VOCAB).sum()))
    # MMOE at b8192: one per-table lookup's backward (f32 table; a bf16
    # table's cotangent is bf16), and the stacked table's, each feature's ids
    # shifted to its segment
    feats = mt_batch["features"]
    _k1_ids_case(results, device, "mmoe_table_f32_order", feats[:, 0], MT_DIM, MT_VOCAB)
    _k1_ids_case(results, device, "mmoe_table_bf16_order", feats[:, 0], MT_DIM, MT_VOCAB,
                 torch.bfloat16)
    stacked = feats + (np.arange(MT_FEATS, dtype=np.int32) * MT_VOCAB)[None, :]
    _k1_ids_case(results, device, "mmoe_stacked_f32_order", stacked, MT_DIM,
                 MT_VOCAB * MT_FEATS)
    # EGES at b4096: the output table (the positive and 5 negative contexts),
    # the cat table (runs of ~20 equal ids in 200 rows) and the weight table (D 3)
    for name, key, dim, vocab in (("eges_output_f32_order", "context", EGES_DIM, EGES_V),
                                  ("eges_cat_f32_order", "target_cat", EGES_DIM, EGES_CATS),
                                  ("eges_weight_f32_order", "target", 3, EGES_V)):
        _k1_ids_case(results, device, name, eges_batch[key], dim, vocab)
    # PinSage b512: the nbr2 lookups' backwards (18,432 ids) into the year
    # table [81, 8] (runs of ~230 equal ids) and the id table [3,706, 8];
    # two-tower b1024: the user [6,000, 32] and item [3,700, 32] tables
    for name, ids, dim, vocab in (
        ("pinsage_year_f32_order", ps_year[ps_batch["nbr2"]], 8, int(ps_year.max()) + 1),
        ("pinsage_id_f32_order", ps_batch["nbr2"], 8, PS_ITEMS),
        ("twotower_user_f32_order", tt_batch["user_id"], 32, TT_USERS),
        ("twotower_item_f32_order", tt_batch["item_id"], 32, TT_ITEMS),
    ):
        _k1_ids_case(results, device, name, ids, dim, vocab)
    # the row-sharded table's backwards at DLRM b8192, model 2, on shard 0
    # ([500,000, 16], the hot rows of SyntheticCTR's Zipf ids) with a bf16
    # cotangent: the psum exchange hands K1 all 212,992 ids shifted by the
    # shard's first row (other shards' ids fall outside and are dropped);
    # the a2a exchange at capacity 2.0 the ids both ranks routed to it
    from recommender_tpu_torch.embedding import sharded

    cat = SyntheticCTR(vocab_size=VOCAB, seed=SEED).sample(BATCH, seed=1)["cat_features"]
    rows = VOCAB // DIST_RANKS
    _k1_ids_case(results, device, "dist_psum_shard_bf16_order", cat, DIM, rows, torch.bfloat16,
                 shard=0, model=DIST_RANKS)
    flat = torch.from_numpy(cat.reshape(-1)).to(device)
    cap = sharded.a2a_capacity(flat.numel(), DIST_RANKS, DIST_A2A_CAPACITY)
    send, _ = sharded._route(flat, DIST_RANKS, rows, cap)
    served = torch.cat([send[:cap]] * DIST_RANKS)  # shard 0's bucket from each rank
    _k1_ids_case(results, device, "dist_a2a_shard_bf16_order", served.cpu().numpy(), DIM, rows,
                 torch.bfloat16, shard=0, model=DIST_RANKS, capacity_factor=DIST_A2A_CAPACITY)
    return results


def k2_valid(history: np.ndarray, device) -> torch.Tensor:
    """BST's key mask for a batch: history positions (id != 0), then the
    target position, always valid."""
    mask = history != 0
    valid = np.concatenate([mask, np.ones((len(history), 1), bool)], axis=1)
    return torch.from_numpy(valid.astype(np.float32)).to(device)


def k2_shapes(device, bst_train: dict) -> dict:
    """Phase k2's shapes, key: (case name, valid, heads, head dim, the
    forward's route, the backward's). Above Dh 64 the kernels work in
    chunks of 64 columns: BST's L 101 with one head of Dh 128 (item_dim =
    cat_dim = 64) and of the odd Dh 72, the probe's L 1001 at Dh 128, and
    the wide Dh 256. The backward is fused at every L <= 128; the forward
    at Dh <= 128 where H * Dh is not a multiple of 32 (``fa.fwd_route``)."""
    def history_valid(max_len, batch):
        gen = SyntheticSequence(num_items=BST_ITEMS, num_cats=BST_CATS, max_len=max_len, seed=SEED)
        return k2_valid(gen.sample(batch, seed=1)["pos_his_item"], device)

    r5_valid = history_valid(1000, 128)
    bst_valid = k2_valid(bst_train["pos_his_item"][:BST_BATCH], device)
    return {
        "bst": ("bst_b1024_L101_Dh9", bst_valid, 4, 9, "fused", "fused"),
        "l128": ("b256_L128_Dh9", history_valid(127, 256), 4, 9, "fused", "fused"),
        "l129": ("b256_L129_Dh9", history_valid(128, 256), 4, 9, "long", "long"),
        "r5_dh9": ("probe_b128_L1001_Dh9", r5_valid, 4, 9, "long", "long"),
        "r5_dh64": ("probe_b128_L1001_Dh64", r5_valid, 4, 64, "long", "long"),
        "r5_dh128": ("probe_b128_L1001_Dh128", r5_valid, 4, 128, "long", "long"),
        "bst_dh128": ("b1024_L101_Dh128", bst_valid, 1, 128, "long", "fused"),
        "bst_dh72": ("b1024_L101_Dh72", bst_valid, 1, 72, "fused", "fused"),
        "dh256": ("b256_L101_Dh256", bst_valid[:256], 2, 256, "long", "fused"),
    }


# phase k2's cases at Dh > 64 (the wide kernels), beside the kernels line
K2_WIDE_CASES = ("r5_dh128", "bst_dh128", "bst_dh72", "dh256")


def k2_work(valid: torch.Tensor, heads: int, head_dim: int) -> dict:
    """What K2's function needs at this shape and mask: the (query, key)
    pairs the segment mask keeps (per head, summed), the bytes of one f32
    [B, L, H, Dh] tensor, of one f32 [B, H, L] row vector and of seg."""
    B, L = valid.shape
    nv = valid.sum(1).double()
    return dict(pairs=float((nv ** 2 + (L - nv) ** 2).sum()) * heads,
                tensor=B * L * heads * head_dim * 4, rows=B * heads * L * 4, seg=B * L * 4)


def k2_bounds(w: dict, head_dim: int) -> dict:
    """Each K2 kernel's least time on the card (ms) and what sets it: each
    input read once and each output written once at HBM_BYTES_PER_S, against
    the products the kept pairs need at the rate of the kernels' arithmetic
    (TF32 tensor-core products, three per f32 product). ``fwd_f32_fma``
    prices the forward as the kernel before the tensor cores ran it: f32
    FMAs, one product per f32 product."""
    pd = w["pairs"] * head_dim
    fwd_bytes = 4 * w["tensor"] + w["rows"] + w["seg"]
    work = {  # bytes, FLOPs, rate
        "fwd": (fwd_bytes, 3 * 4 * pd, TF32_FLOPS),
        "fwd_f32_fma": (fwd_bytes, 4 * pd, F32_FLOPS),
        "bwd": (8 * w["tensor"] + w["rows"] + w["seg"], 3 * 10 * pd, TF32_FLOPS),
        "bwd_dkv": (6 * w["tensor"] + 2 * w["rows"] + w["seg"], 3 * 8 * pd, TF32_FLOPS),
        "bwd_dq": (5 * w["tensor"] + 2 * w["rows"] + w["seg"], 3 * 6 * pd, TF32_FLOPS),
    }
    out = {}
    for name, (nbytes, flops, rate) in work.items():
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
        out[name] = dict(bytes=nbytes, flops=flops, bytes_ms=t_bytes, ops_ms=t_ops,
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def k2_long_info(kernel: str, head_dim: int) -> dict:
    """Registers, local memory bytes a thread (spills and stack) and blocks an
    SM of the long backward's ``"bwd_dkv"`` or ``"bwd_dq"`` kernel at this
    head dim, as its launch configures it (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = _build.load("flash_attention_bwd").rtt_flash_attention_bwd_long_info
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 3)()
    check(fn(int(kernel == "bwd_dkv"), head_dim, ctypes.addressof(out)) == 0,
          f"K2 {kernel} info at Dh {head_dim}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), out))


def k2_fused_bwd_info(L: int, heads: int, head_dim: int) -> dict:
    """Registers, local memory bytes a thread (spills and stack) and blocks an
    SM of the wide fused backward (Dh > 64) at [., L, heads, head_dim], as
    its launch configures it (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = _build.load("flash_attention_bwd").rtt_flash_attention_bwd_fused_wide_info
    fn.argtypes, fn.restype = [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 3)()
    check(fn(L, heads, head_dim, ctypes.addressof(out)) == 0,
          f"K2 fused backward info at L {L}, Dh {head_dim}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), out))


def k2_fwd_wide_info(route: str, L: int, heads: int, head_dim: int) -> dict:
    """Registers, local memory bytes a thread (spills and stack) and blocks an
    SM of the wide forward kernel (Dh > 64) of ``route`` at [., L, heads,
    head_dim], as its launch configures it (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    fn = _build.load("flash_attention").rtt_flash_attention_fwd_wide_info
    fn.argtypes, fn.restype = [ctypes.c_int] * 4 + [ctypes.c_void_p], ctypes.c_int
    out = (ctypes.c_int * 3)()
    check(fn(int(route == "fused"), L, heads, head_dim, ctypes.addressof(out)) == 0,
          f"K2 {route} forward info at Dh {head_dim}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"), out))


def sdpa_backend(q, k, v, mask) -> str:
    """The backend torch's scaled_dot_product_attention picks for these inputs."""
    from torch.nn.attention import SDPBackend

    names = {b.value: name for name, b in SDPBackend.__members__.items()}
    return names.get(int(torch._fused_sdp_choice(q, k, v, attn_mask=mask)), "unknown")


def phase_k2(device, name: str, valid: torch.Tensor, heads: int, head_dim: int) -> dict:
    """K2 against flash_mha_ref at [B, L, heads, head_dim] with ``valid``;
    each kernel alone on the routes ``fwd_route`` and ``bwd_route`` pick;
    SDPA as the yardstick."""
    B, L = valid.shape
    g = torch.Generator(device=device).manual_seed(SEED)
    q, k, v, cot = (torch.randn((B, L, heads, head_dim), generator=g, device=device)
                    for _ in range(4))
    qkv = [t.requires_grad_() for t in (q, k, v)]
    fwd_route = fa.fwd_route(L, heads, head_dim)
    route = fa.bwd_route(L, heads, head_dim)

    def fwd_bwd(fn):
        o = fn(*qkv, valid)
        return (o.detach(), *torch.autograd.grad(o, qkv, cot))

    got, again, want = fwd_bwd(fa.flash_mha), fwd_bwd(fa.flash_mha), fwd_bwd(fa.flash_mha_ref)
    torch.cuda.synchronize()
    names = ("o", "dq", "dk", "dv")
    scale = {n: max(1.0, float(w.abs().max())) for n, w in zip(names, want)}
    abs_err = {n: float((a - w).abs().max()) for n, a, w in zip(names, got, want)}
    rel_err = {n: abs_err[n] / scale[n] for n in names}
    tol = {n: K2_FWD_REL_TOL if n == "o" else K2_BWD_REL_TOL for n in names}
    bitwise = all(torch.equal(a, b) for a, b in zip(got, again))

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: fa.flash_mha(q, k, v, valid))
        plain_fwd_ms = cuda_ms(lambda: fa.flash_mha_ref(q, k, v, valid))
    fwd_bwd_ms = cuda_ms(lambda: fwd_bwd(fa.flash_mha))
    plain_fwd_bwd_ms = cuda_ms(lambda: fwd_bwd(fa.flash_mha_ref))
    # the backward as autograd runs it, then each kernel alone on every route
    o = fa.flash_mha(*qkv, valid)
    saved = o.grad_fn.saved_tensors
    bwd_ms = cuda_ms(lambda: fa._backward(*saved, cot))
    routes = k2_route_kernels(device, saved, cot, want, scale)
    kernel_ms = {"fwd": routes[f"fwd_{fwd_route}"]["ms"]}
    kernel_info = {"fwd": routes[f"fwd_{fwd_route}"]["info"]} if head_dim > 64 else {}
    if route == "fused":
        kernel_ms["bwd"] = routes["bwd_fused"]["ms"]
        if head_dim > 64:
            kernel_info["bwd"] = routes["bwd_fused"]["info"]
    else:
        kernel_ms["bwd_dkv"] = routes["bwd_long"]["dkv_ms"]
        kernel_ms["bwd_dq"] = routes["bwd_long"]["dq_ms"]
        kernel_info.update(routes["bwd_long"]["info"])
    # the other route of each direction on the same inputs, where it takes the shape
    other = {f"{d}_{r}_route": routes.get(f"{d}_{r}", {}) if picked != r else {}
             for d, picked in (("fwd", fwd_route), ("bwd", route)) for r in ("fused", "long")}
    o_ref = fa.flash_mha_ref(*qkv, valid)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(o_ref, qkv, cot, retain_graph=True))
    del o, o_ref, saved

    # the yardstick: one scaled_dot_product_attention call, [B, H, L, Dh] with
    # the segment-equality mask (True = may attend)
    lib_qkv = [t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)]
    seg_ids = valid.to(torch.int32)
    mask = seg_ids[:, None, :, None] == seg_ids[:, None, None, :]
    lib_cot = cot.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(*lib_qkv, attn_mask=mask)  # noqa: E731
    backend = sdpa_backend(*lib_qkv, mask)
    lib_o = sdpa()
    lib_err = float((lib_o.detach().transpose(1, 2) - want[0]).abs().max()) / scale["o"]
    with torch.no_grad():
        library_fwd_ms = cuda_ms(sdpa)
    library_fwd_bwd_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), lib_qkv, lib_cot))
    library_bwd_ms = cuda_ms(lambda: torch.autograd.grad(lib_o, lib_qkv, lib_cot, retain_graph=True))
    del lib_o, lib_qkv, mask

    bounds = k2_bounds(k2_work(valid, heads, head_dim), head_dim)
    emit("k2", case=name, shape=[B, L, heads, head_dim], fwd_route=fwd_route, route=route,
         valid_share=float(valid.mean()), max_abs_err=abs_err, max_rel_err=rel_err,
         tolerance=f"|err| <= tol * max(1, max|plain|), tol {tol}",
         bitwise_repeatable=bitwise, fwd_ms=fwd_ms, plain_fwd_ms=plain_fwd_ms,
         fwd_bwd_ms=fwd_bwd_ms, plain_fwd_bwd_ms=plain_fwd_bwd_ms,
         bwd_ms=bwd_ms, kernel_ms=kernel_ms, kernel_info=kernel_info, **other,
         plain_bwd_ms=plain_bwd_ms, library_backend=backend, library_fwd_rel_err=lib_err,
         library_fwd_ms=library_fwd_ms, library_bwd_ms=library_bwd_ms,
         library_fwd_bwd_ms=library_fwd_bwd_ms,
         bounds=bounds,
         share_of_bound={kn: bounds[kn]["bound_ms"] / t for kn, t in kernel_ms.items()})
    for n in names:
        check(rel_err[n] <= tol[n], f"K2 {name}: {n} off by {rel_err[n]} of max|plain|")
    check(bitwise, f"K2 {name}: two launches differ")
    k2_check_routes(name, routes, head_dim)
    return dict(abs_err=abs_err, fwd_route=fwd_route, route=route, fwd_ms=fwd_ms,
                plain_fwd_ms=plain_fwd_ms, kernel_info=kernel_info, other_routes=other,
                kernel_ms=kernel_ms, plain_bwd_ms=plain_bwd_ms, bounds=bounds,
                library_fwd_ms=library_fwd_ms, library_bwd_ms=library_bwd_ms)


def k2_check_routes(name: str, routes: dict, head_dim: int):
    """Every route's kernels within the tolerance of the plain version and,
    above Dh 64, without local memory (no spills, no stack)."""
    for kn, r in routes.items():
        errs = r["rel_err"] if isinstance(r["rel_err"], dict) else {"o": r["rel_err"]}
        for n, e in errs.items():
            tol = K2_FWD_REL_TOL if n == "o" else K2_BWD_REL_TOL
            check(e <= tol, f"K2 {name}: {kn} {n} off by {e} of max|plain|")
        if head_dim > 64:
            infos = r["info"].values() if kn == "bwd_long" else [r["info"]]
            for info in infos:
                check(info["local_bytes"] == 0, f"K2 {name}: {kn} uses local memory: {info}")


def k2_route_kernels(device, saved, cot, want, scale) -> dict:
    """Each K2 kernel alone on every route that takes the shape, on the same
    inputs (``saved``: q, k, v, seg, o and lse of the forward): the forward's
    ``fwd_fused`` and ``fwd_long`` (o against the plain version's), the fused
    backward ``bwd_fused`` and the long one, ``bwd_long``: di as the wrapper
    computes it, then the dK/dV and dQ kernels (dq, dk, dv against the plain
    version's). Each with its ms (CUDA events, median of 25; ``bwd_long``:
    the three summed, each beside it), its error as a share of max(1,
    max|plain|), and its kernels' registers, local bytes and blocks an SM
    (``info``; the forward's above Dh 64 only)."""
    sq, sk, sv, seg, out, lse = saved
    B, L, heads, head_dim = sq.shape
    fns = fa._kernel_fns()
    dims = (B, L, heads, head_dim, 1.0 / head_dim ** 0.5)
    dq_, dk_, dv_, o_ = (torch.empty_like(sq) for _ in range(4))
    lse_ = torch.empty_like(lse)
    res = {}

    def bwd_err():
        return {n: float((t - w).abs().max()) / scale[n]
                for n, t, w in (("dq", dq_, want[1]), ("dk", dk_, want[2]), ("dv", dv_, want[3]))}

    fused_fits = L <= fa.FUSED_MAX_L
    fwd_ptrs = [t.data_ptr() for t in (sq, sk, sv, seg, o_, lse_)]
    for r in ("fused", "long"):
        if r == "fused" and not (fused_fits and fa.fwd_smem_bytes(*sq.shape[1:]) <= fa.MAX_BLOCK_SMEM):
            continue
        ms = cuda_ms(lambda: fa._launch(f"{r} forward", fns[f"fwd_{r}"], device, *fwd_ptrs, *dims))
        res[f"fwd_{r}"] = dict(ms=ms, rel_err=float((o_ - want[0]).abs().max()) / scale["o"])
        if head_dim > 64:
            res[f"fwd_{r}"]["info"] = k2_fwd_wide_info(r, L, heads, head_dim)
    if fused_fits and fa.fused_smem_bytes(*sq.shape[1:]) <= fa.MAX_BLOCK_SMEM:
        ptrs = [t.data_ptr() for t in (sq, sk, sv, seg, out, cot, lse, dq_, dk_, dv_)]
        ms = cuda_ms(lambda: fa._launch("fused backward", fns["bwd_fused"], device, *ptrs, *dims))
        res["bwd_fused"] = dict(ms=ms, rel_err=bwd_err())
        if head_dim > 64:
            res["bwd_fused"]["info"] = k2_fused_bwd_info(L, heads, head_dim)
    di_of = lambda: (cot * out).sum(-1).transpose(1, 2).contiguous()  # noqa: E731
    di = di_of()
    di_ms = cuda_ms(di_of)
    common = [t.data_ptr() for t in (sq, sk, sv, seg, cot, lse, di)]
    dkv_ms = cuda_ms(lambda: fa._launch(
        "dK/dV", fns["bwd_dkv"], device, *common, dk_.data_ptr(), dv_.data_ptr(), *dims))
    dq_ms = cuda_ms(lambda: fa._launch("dQ", fns["bwd_dq"], device, *common, dq_.data_ptr(), *dims))
    res["bwd_long"] = dict(ms=di_ms + dkv_ms + dq_ms, di_ms=di_ms, dkv_ms=dkv_ms, dq_ms=dq_ms,
                           rel_err=bwd_err(),
                           info={kn: k2_long_info(kn, head_dim) for kn in ("bwd_dkv", "bwd_dq")})
    return res


# phase k2_routes: (B, L, heads, head dim) above Dh 64 where the wide
# routes' rules decide, on BST's rows (their first L positions); B * heads
# * Dh near BST's rows with one head of Dh 128
K2_ROUTE_SWEEP = (
    *((1024, 101, 1, dh) for dh in (65, 72, 80, 96, 100, 112, 128, 144, 160)),
    (512, 101, 2, 65), (512, 101, 2, 72), (512, 101, 2, 128), (512, 101, 1, 192),
    (256, 101, 2, 256), (1024, 64, 1, 128), (1024, 33, 1, 128), (1024, 64, 2, 96),
)


def phase_k2_routes(device, bst_valid: torch.Tensor) -> list:
    """Both routes of the forward and of the backward, alone, at the wide
    shapes of ``K2_ROUTE_SWEEP`` with BST's masks, each against the plain
    version (``k2_route_kernels``): which route each rule picks and which
    one was faster. The rules are set from these times."""
    out = []
    for B, L, heads, head_dim in K2_ROUTE_SWEEP:
        valid = bst_valid[:B, :L].contiguous()
        g = torch.Generator(device=device).manual_seed(SEED)
        q, k, v, cot = (torch.randn((B, L, heads, head_dim), generator=g, device=device)
                        for _ in range(4))
        qkv = [t.requires_grad_() for t in (q, k, v)]
        o = fa.flash_mha_ref(*qkv, valid)
        want = (o.detach(), *torch.autograd.grad(o, qkv, cot))
        scale = {n: max(1.0, float(w.abs().max())) for n, w in zip(("o", "dq", "dk", "dv"), want)}
        o = fa.flash_mha(*qkv, valid)
        routes = k2_route_kernels(device, o.grad_fn.saved_tensors, cot, want, scale)
        name = f"b{B}_L{L}_H{heads}_Dh{head_dim}"
        k2_check_routes(name, routes, head_dim)
        row = dict(case=name, fwd_smem_bytes=fa.fwd_smem_bytes(L, heads, head_dim),
                   **{kn: dict(ms=r["ms"], rel_err=r["rel_err"]) for kn, r in routes.items()})
        for d, rule in (("fwd", fa.fwd_route), ("bwd", fa.bwd_route)):
            times = {r: routes[f"{d}_{r}"]["ms"] for r in ("fused", "long") if f"{d}_{r}" in routes}
            row[f"{d}_picked"] = rule(L, heads, head_dim)
            row[f"{d}_faster"] = min(times, key=times.get)
        out.append(row)
        del o, q, k, v, cot, qkv, want
    emit("k2_routes", cases=out)
    return out


def phase_train(device) -> int:
    gen = SyntheticCTR(vocab_size=VOCAB, seed=SEED)
    train = gen.sample(STEPS * BATCH, seed=1)
    test = gen.sample(EVAL_BATCHES * BATCH, seed=2)
    model = DLRM(VOCAB, DIM, embed_param_dtype=torch.bfloat16, device=device)
    init_model(model, seed=SEED)
    loss_fn, eval_fn = make_ctr_task(model)
    cfg = TrainConfig(learning_rate=LR, log_every=1, eval_every=0, seed=SEED)
    trainer = Trainer(loss_fn, cfg, eval_fn, device=device)
    state = trainer.init_state(lambda: model)

    stamps = []  # host clock at each step's log point; float(loss) syncs
    losses = []

    def log_fn(m):
        stamps.append(time.perf_counter())
        losses.append(m["loss"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state, _ = trainer.fit(state, batch_iterator(train, BATCH, seed=SEED), STEPS, log_fn=log_fn)
    ev = trainer.evaluate(state, batch_iterator(test, BATCH, shuffle=False), exact=True)
    torch.cuda.synchronize()
    launches = ek.sorted_scatter_add.launches
    wall = time.perf_counter() - t0

    step_ms = np.diff(np.array(stamps))[-TIMED_STEPS:] * 1e3
    emit("train", steps=state.step, batch=BATCH, vocab=VOCAB, dim=DIM,
         table_dtype="bfloat16",
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         ms_per_step_median=float(np.median(step_ms)),
         ms_per_step_min=float(step_ms.min()), ms_per_step_max=float(step_ms.max()),
         examples_per_s=BATCH / (float(np.median(step_ms)) / 1e3),
         eval=ev, peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
         k1_launches=launches, seconds=wall, auc_margin=AUC_MARGIN)
    check(state.step == STEPS, f"took {state.step} steps, wanted {STEPS}")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    check(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")
    check(ev["eval_batches"] == EVAL_BATCHES, "eval batch count")
    check(ev["eval_auc"] > 0.5 + AUC_MARGIN, f"eval_auc {ev['eval_auc']} <= 0.5 + {AUC_MARGIN}")
    check(ev["eval_auc_exact"] > 0.5 + AUC_MARGIN, f"eval_auc_exact {ev['eval_auc_exact']}")
    check(launches == STEPS, f"K1 launched {launches} times in {STEPS} steps")
    return launches


def _small_losses(device, state_dict, data) -> list[float]:
    model = DLRM(1000, 8, bottom_units=(32, 16, 8), top_units=(32, 16, 1), device=device)
    model.load_state_dict(state_dict)
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=1), eval_fn, device=device)
    state = trainer.init_state(lambda: model)
    losses = []
    trainer.fit(state, batch_iterator(data, 256, seed=SEED), 3,
                log_fn=lambda m: losses.append(m["loss"]))
    return losses


def phase_card_cpu(device):
    data = SyntheticCTR(vocab_size=1000, seed=SEED).sample(3 * 256, seed=1)
    init = init_model(
        DLRM(1000, 8, bottom_units=(32, 16, 8), top_units=(32, 16, 1)), seed=SEED
    ).state_dict()
    launches = ek.sorted_scatter_add.launches
    card = _small_losses(device, init, data)
    cpu = _small_losses(torch.device("cpu"), init, data)
    diff = max(abs(a - b) for a, b in zip(card, cpu))
    emit("card_cpu", card_losses=card, cpu_losses=cpu, max_abs_diff=diff,
         tolerance=CARD_CPU_LOSS_TOL)
    check(len(card) == len(cpu) == 3, "card/CPU step count")
    check(ek.sorted_scatter_add.launches == launches + 3, "card run did not launch K1")
    check(diff <= CARD_CPU_LOSS_TOL, f"card vs CPU losses differ by {diff}")


def sequence_data() -> tuple[dict, dict]:
    """Train and held-out ``SyntheticSequence`` batches at the shape of
    bench_bst and bench_dien (sampled once, before any timed window)."""
    gen = SyntheticSequence(num_items=BST_ITEMS, num_cats=BST_CATS, max_len=BST_T, seed=SEED)
    return gen.sample(STEPS * BST_BATCH, seed=1), gen.sample(EVAL_BATCHES * BST_BATCH, seed=2)


def without_negatives(batches: dict) -> dict:
    """Drop the negative histories, which only DIEN reads."""
    return {k: v for k, v in batches.items() if not k.startswith("neg_")}


def bst_data() -> tuple[dict, dict]:
    train, test = sequence_data()
    return without_negatives(train), without_negatives(test)


K2_COUNTERS = ("fwd", "fwd_fused", "fwd_long", "bwd", "bwd_dkv", "bwd_dq")


def k2_counts() -> dict:
    return {n: getattr(fa.flash_mha, f"launches_{n}") for n in K2_COUNTERS}


def reset_counts():
    ek.sorted_scatter_add.launches = 0
    for n in K2_COUNTERS:
        setattr(fa.flash_mha, f"launches_{n}", 0)


def _set_flash(model, on: bool):
    for blk in model.blocks():
        blk.use_flash = on


def _bst_fit(model, device, train, log_fn, steps: int = STEPS):
    loss_fn, eval_fn = make_ctr_task(model)
    cfg = TrainConfig(learning_rate=LR, log_every=1, eval_every=0, seed=SEED)
    trainer = Trainer(loss_fn, cfg, eval_fn, device=device)
    state = trainer.init_state(lambda: model)
    state, _ = trainer.fit(state, batch_iterator(train, BST_BATCH, seed=SEED), steps, log_fn=log_fn)
    return trainer, state


def phase_bst_train(device, train, test) -> dict:
    model = BST(item_vocab=BST_ITEMS, cat_vocab=BST_CATS, device=device)
    init_model(model, seed=SEED)
    plain_model = copy.deepcopy(model)
    _set_flash(model, True)
    stamps, losses = [], []

    def log_fn(m):
        stamps.append(time.perf_counter())  # float(loss) at each step syncs
        losses.append(m["loss"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trainer, state = _bst_fit(model, device, train, log_fn)
    ev = trainer.evaluate(state, batch_iterator(test, BST_BATCH, shuffle=False), exact=True)
    torch.cuda.synchronize()
    launches = dict(k1=ek.sorted_scatter_add.launches, **k2_counts())
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = np.diff(np.array(stamps))[-TIMED_STEPS:] * 1e3

    plain_losses = []
    plain_trainer, plain_state = _bst_fit(
        plain_model, device, train, lambda m: plain_losses.append(m["loss"])
    )
    plain_ev = plain_trainer.evaluate(
        plain_state, batch_iterator(test, BST_BATCH, shuffle=False), exact=True
    )
    path_diff = max(abs(a - b) for a, b in zip(losses, plain_losses))
    auc_diff = abs(ev["eval_auc_exact"] - plain_ev["eval_auc_exact"])
    # L 101 takes the fused routes: one launch per block and step, no long-route launch
    fwd = 2 * (STEPS + EVAL_BATCHES)
    want = dict(k1=4 * STEPS, fwd=fwd, fwd_fused=fwd, fwd_long=0, bwd=2 * STEPS, bwd_dkv=0,
                bwd_dq=0)
    emit("bst_train", steps=state.step, batch=BST_BATCH, item_vocab=BST_ITEMS,
         cat_vocab=BST_CATS, history=BST_T, table_dtype="float32", attention="flash (K2)",
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         ms_per_step_median=float(np.median(step_ms)),
         ms_per_step_min=float(step_ms.min()), ms_per_step_max=float(step_ms.max()),
         examples_per_s=BST_BATCH / (float(np.median(step_ms)) / 1e3),
         eval=ev, peak_memory_gib=peak, seconds=wall, auc_margin=BST_AUC_MARGIN,
         launches=launches, expected_launches=want,
         plain_attention_losses=plain_losses, plain_attention_eval=plain_ev,
         flash_vs_plain_max_loss_diff=path_diff, flash_vs_plain_auc_diff=auc_diff,
         flash_vs_plain_tolerance=dict(loss=BST_PATHS_LOSS_TOL, auc=BST_PATHS_AUC_TOL))
    check(state.step == STEPS, f"BST took {state.step} steps, wanted {STEPS}")
    check(all(math.isfinite(x) for x in losses), "non-finite BST training loss")
    check(losses[-1] < losses[0], f"BST loss did not fall: {losses[0]} -> {losses[-1]}")
    check(ev["eval_batches"] == EVAL_BATCHES, "BST eval batch count")
    check(ev["eval_auc"] > 0.5 + BST_AUC_MARGIN, f"BST eval_auc {ev['eval_auc']}")
    check(ev["eval_auc_exact"] > 0.5 + BST_AUC_MARGIN, f"BST eval_auc_exact {ev['eval_auc_exact']}")
    check(launches == want, f"BST launches {launches}, wanted {want}")
    check(len(plain_losses) == STEPS, "plain-attention BST step count")
    check(path_diff <= BST_PATHS_LOSS_TOL, f"flash vs plain BST losses differ by {path_diff}")
    check(auc_diff <= BST_PATHS_AUC_TOL, f"flash vs plain BST eval AUC differ by {auc_diff}")
    return launches


def phase_bst_dh128(device, train) -> dict:
    """BST on ``bst_amazon_b1024_T100``'s data with item_dim = cat_dim = 64
    and one head, so Dh 128: BST_DH128_STEPS Trainer steps with flash
    attention (K2's Dh > 64 kernels: at L 101 the long forward, whose block
    beats the fused one's there, and the fused backward), then as many from
    the same init with plain attention; the losses must agree."""
    L = BST_T + 1
    check(fa.fwd_route(L, 1, 128) == "long" and fa.bwd_route(L, 1, 128) == "fused",
          "BST at Dh 128: unexpected K2 routes")
    model = BST(item_vocab=BST_ITEMS, cat_vocab=BST_CATS, **BST_DH128, device=device)
    init_model(model, seed=SEED)
    plain_model = copy.deepcopy(model)
    _set_flash(model, True)
    runs = {}
    for name, m in (("flash", model), ("plain", plain_model)):
        stamps, losses = [], []

        def log_fn(x, stamps=stamps, losses=losses):
            stamps.append(time.perf_counter())  # float(loss) at each step syncs
            losses.append(x["loss"])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        _, state = _bst_fit(m, device, train, log_fn, BST_DH128_STEPS)
        torch.cuda.synchronize()
        step_ms = np.diff(np.array(stamps))[-(BST_DH128_STEPS // 2):] * 1e3
        runs[name] = dict(steps=state.step, losses=losses,
                          launches=dict(k1=ek.sorted_scatter_add.launches, **k2_counts()),
                          ms_per_step_median=float(np.median(step_ms)),
                          peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
    flash, plain = runs["flash"], runs["plain"]
    diff = max(abs(a - b) for a, b in zip(flash["losses"], plain["losses"]))
    fwd = 2 * BST_DH128_STEPS  # two blocks
    want = dict(k1=4 * BST_DH128_STEPS, fwd=fwd, fwd_fused=0, fwd_long=fwd, bwd=fwd,
                bwd_dkv=0, bwd_dq=0)
    emit("bst_dh128", batch=BST_BATCH, history=BST_T, heads=1, head_dim=128, **BST_DH128,
         flash=flash, plain=plain, flash_vs_plain_max_loss_diff=diff,
         loss_tolerance=BST_PATHS_LOSS_TOL, expected_launches=want)
    check(flash["steps"] == plain["steps"] == BST_DH128_STEPS, "BST Dh 128 step counts")
    check(all(math.isfinite(x) for x in flash["losses"]), "non-finite BST Dh 128 loss")
    check(flash["launches"] == want, f"BST Dh 128 launches {flash['launches']}, wanted {want}")
    check(diff <= BST_PATHS_LOSS_TOL, f"BST Dh 128: flash vs plain losses differ by {diff}")
    return flash["launches"]


def phase_bst_long(device) -> dict:
    """BST at history 1,000 (L 1,001, the long backward route): a few
    Trainer steps with flash, then with plain attention from the same init."""
    data = SyntheticSequence(num_items=BST_ITEMS, num_cats=BST_CATS, max_len=BST_LONG_T,
                             seed=SEED).sample(BST_LONG_STEPS * BST_LONG_BATCH, seed=1)
    data = {k: v for k, v in data.items() if not k.startswith("neg_")}
    model = BST(item_vocab=BST_ITEMS, cat_vocab=BST_CATS, max_len=BST_LONG_T + 1, device=device)
    init_model(model, seed=SEED)
    plain_model = copy.deepcopy(model)
    _set_flash(model, True)

    def fit(m, log):
        loss_fn, eval_fn = make_ctr_task(m)
        cfg = TrainConfig(learning_rate=LR, log_every=1, eval_every=0, seed=SEED)
        trainer = Trainer(loss_fn, cfg, eval_fn, device=device)
        state = trainer.init_state(lambda: m)
        trainer.fit(state, batch_iterator(data, BST_LONG_BATCH, seed=SEED), BST_LONG_STEPS,
                    log_fn=lambda x: log.append((time.perf_counter(), x["loss"])))

    torch.cuda.synchronize()
    reset_counts()
    flash = []
    fit(model, flash)
    torch.cuda.synchronize()
    launches = dict(k1=ek.sorted_scatter_add.launches, **k2_counts())
    plain = []
    fit(plain_model, plain)
    losses, plain_losses = [x for _, x in flash], [x for _, x in plain]
    diff = max(abs(a - b) for a, b in zip(losses, plain_losses))
    step_ms = np.diff([t for t, _ in flash]) * 1e3
    plain_step_ms = np.diff([t for t, _ in plain]) * 1e3
    n = 2 * BST_LONG_STEPS
    want = dict(k1=4 * BST_LONG_STEPS, fwd=n, fwd_fused=0, fwd_long=n, bwd=0, bwd_dkv=n, bwd_dq=n)
    emit("bst_long", steps=BST_LONG_STEPS, batch=BST_LONG_BATCH, history=BST_LONG_T,
         losses=losses, plain_attention_losses=plain_losses, flash_vs_plain_max_loss_diff=diff,
         tolerance=BST_PATHS_LOSS_TOL, ms_per_step_median=float(np.median(step_ms)),
         plain_ms_per_step_median=float(np.median(plain_step_ms)),
         launches=launches, expected_launches=want)
    check(len(losses) == len(plain_losses) == BST_LONG_STEPS, "BST long step count")
    check(all(math.isfinite(x) for x in losses), "non-finite BST long loss")
    check(launches == want, f"BST long launches {launches}, wanted {want}")
    check(diff <= BST_PATHS_LOSS_TOL, f"flash vs plain BST long losses differ by {diff}")
    return launches


def _small_bst(device, state_dict, data, flash: bool) -> list[float]:
    model = BST(300, 20, item_dim=8, cat_dim=8, mlp_units=(32, 16, 1), num_blocks=1,
                device=device)
    model.load_state_dict(state_dict)
    _set_flash(model, flash)
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=1), eval_fn, device=device)
    state = trainer.init_state(lambda: model)
    losses = []
    trainer.fit(state, batch_iterator(data, 256, seed=SEED), 3,
                log_fn=lambda m: losses.append(m["loss"]))
    return losses


def phase_bst_card_cpu(device):
    data = SyntheticSequence(num_items=300, num_cats=20, max_len=20, seed=SEED).sample(3 * 256, seed=1)
    init = init_model(
        BST(300, 20, item_dim=8, cat_dim=8, mlp_units=(32, 16, 1), num_blocks=1), seed=SEED
    ).state_dict()
    before = k2_counts()
    card = _small_bst(device, init, data, flash=True)
    launched = {n: c - before[n] for n, c in k2_counts().items()}
    cpu = _small_bst(torch.device("cpu"), init, data, flash=True)  # flash_mha_ref
    diff = max(abs(a - b) for a, b in zip(card, cpu))
    emit("bst_card_cpu", card_losses=card, cpu_losses=cpu, max_abs_diff=diff,
         tolerance=CARD_CPU_LOSS_TOL, k2_launches_on_card=launched)
    check(len(card) == len(cpu) == 3, "BST card/CPU step count")
    want = dict(fwd=3, fwd_fused=3, fwd_long=0, bwd=3, bwd_dkv=0, bwd_dq=0)  # L 21: fused routes
    check(launched == want, f"card run launched K2 {launched}, wanted {want}")
    check(diff <= CARD_CPU_LOSS_TOL, f"BST card vs CPU losses differ by {diff}")


def _sequence_model(cls, device, table_dtype=torch.float32, **kw):
    model = cls(item_vocab=BST_ITEMS, cat_vocab=BST_CATS, embed_param_dtype=table_dtype,
                device=device, **kw)
    return init_model(model, seed=SEED)


def _task_of(model):
    if isinstance(model, (ESMM, MMOE)):
        return make_multitask_task(model)
    return make_aux_loss_task(model) if isinstance(model, DIEN) else make_ctr_task(model)


def _timed_fit(model, device, train, batch: int, steps: int):
    """``steps`` Trainer steps with a log point (a sync) at each: the
    trainer, the state, each step's metrics, the host clock at each log point
    and the K1 launches of the fit."""
    loss_fn, eval_fn = _task_of(model)
    cfg = TrainConfig(learning_rate=LR, log_every=1, eval_every=0, seed=SEED)
    trainer = Trainer(loss_fn, cfg, eval_fn, device=device)
    state = trainer.init_state(lambda: model)
    logs, stamps = [], []

    def log_fn(m):
        stamps.append(time.perf_counter())  # float(loss) at each step syncs
        logs.append(m)

    torch.cuda.synchronize()
    reset_counts()
    state, _ = trainer.fit(state, batch_iterator(train, batch, seed=SEED), steps, log_fn=log_fn)
    torch.cuda.synchronize()
    return trainer, state, logs, stamps, ek.sorted_scatter_add.launches


def _check_fit(name, state, logs, steps, launches, per_step):
    losses = [m["loss"] for m in logs]
    check(state.step == steps == len(logs), f"{name} took {state.step} steps, wanted {steps}")
    check(all(math.isfinite(x) for x in losses), f"non-finite {name} training loss")
    check(launches == per_step * steps,
          f"{name}: K1 launched {launches} times in {steps} steps, wanted {per_step} a step")


def phase_dien_train(device, train, test) -> int:
    """DIEN at bench_dien width with f32 tables, then a few steps of the
    bf16-table variant (stochastic rounding on both tables) and of the
    ``shared_gather`` variant (K1 twice a step) from the f32 run's init."""
    model = _sequence_model(DIEN, device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, state, logs, stamps, launches = _timed_fit(model, device, train, BST_BATCH, STEPS)
    ev = trainer.evaluate(state, batch_iterator(test, BST_BATCH, shuffle=False), exact=True)
    torch.cuda.synchronize()
    eval_launches = ek.sorted_scatter_add.launches - launches
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [m["loss"] for m in logs]
    step_ms = np.diff(np.array(stamps))[-TIMED_STEPS:] * 1e3

    bf16 = _sequence_model(DIEN, device, torch.bfloat16)
    _, bf16_state, bf16_logs, bf16_stamps, bf16_launches = _timed_fit(
        bf16, device, train, BST_BATCH, DIEN_BF16_STEPS)
    bf16_ms = np.diff(np.array(bf16_stamps)) * 1e3
    shared = _sequence_model(DIEN, device, shared_gather=True)
    _, shared_state, shared_logs, shared_stamps, shared_launches = _timed_fit(
        shared, device, train, BST_BATCH, DIEN_SHARED_STEPS)
    shared_losses = [m["loss"] for m in shared_logs]
    shared_diff = max(abs(a - b) for a, b in zip(shared_losses, losses))
    emit("dien_train", steps=state.step, batch=BST_BATCH, item_vocab=BST_ITEMS,
         cat_vocab=BST_CATS, history=BST_T, table_dtype="float32",
         first_loss=losses[0], last_loss=losses[-1], losses=losses,
         first_aux_loss=logs[0]["aux_loss"], last_aux_loss=logs[-1]["aux_loss"],
         ms_per_step_median=float(np.median(step_ms)),
         ms_per_step_min=float(step_ms.min()), ms_per_step_max=float(step_ms.max()),
         examples_per_s=BST_BATCH / (float(np.median(step_ms)) / 1e3),
         eval=ev, peak_memory_gib=peak, seconds=wall,
         k1_launches=launches, k1_per_step=DIEN_K1_PER_STEP,
         bf16sr=dict(steps=bf16_state.step, losses=[m["loss"] for m in bf16_logs],
                     first_aux_loss=bf16_logs[0]["aux_loss"],
                     last_aux_loss=bf16_logs[-1]["aux_loss"],
                     ms_per_step_median=float(np.median(bf16_ms)), k1_launches=bf16_launches),
         shared_gather=dict(steps=shared_state.step, losses=shared_losses,
                            ms_per_step_median=float(np.median(np.diff(shared_stamps)) * 1e3),
                            k1_launches=shared_launches, k1_per_step=DIEN_SHARED_K1_PER_STEP,
                            max_loss_diff_to_separate_lookups=shared_diff,
                            tolerance=DIEN_SHARED_LOSS_TOL))
    _check_fit("DIEN", state, logs, STEPS, launches, DIEN_K1_PER_STEP)
    check(np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"DIEN loss did not fall: {losses[:5]} -> {losses[-5:]}")
    check(eval_launches == 0, f"evaluate launched K1 {eval_launches} times")
    check(ev["eval_batches"] == EVAL_BATCHES, "DIEN eval batch count")
    check(math.isfinite(ev["eval_loss"]) and 0.0 <= ev["eval_auc_exact"] <= 1.0, "DIEN eval")
    _check_fit("DIEN bf16", bf16_state, bf16_logs, DIEN_BF16_STEPS, bf16_launches,
               DIEN_K1_PER_STEP)
    check(bf16.item_embedding.embedding.dtype == torch.bfloat16, "bf16 table dtype")
    _check_fit("DIEN shared_gather", shared_state, shared_logs, DIEN_SHARED_STEPS,
               shared_launches, DIEN_SHARED_K1_PER_STEP)
    check(shared_diff <= DIEN_SHARED_LOSS_TOL,
          f"shared_gather losses differ from separate lookups' by {shared_diff}")
    return launches + bf16_launches + shared_launches


def phase_din_train(device, train) -> int:
    model = _sequence_model(DIN, device)
    torch.cuda.reset_peak_memory_stats()
    _, state, logs, stamps, launches = _timed_fit(
        model, device, without_negatives(train), BST_BATCH, DIN_STEPS)
    losses = [m["loss"] for m in logs]
    step_ms = np.diff(np.array(stamps))[-10:] * 1e3
    emit("din_train", steps=state.step, batch=BST_BATCH, history=BST_T, table_dtype="float32",
         losses=losses, ms_per_step_median=float(np.median(step_ms)),
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
         k1_launches=launches, k1_per_step=DIN_K1_PER_STEP)
    _check_fit("DIN", state, logs, DIN_STEPS, launches, DIN_K1_PER_STEP)
    return launches


def phase_dien_long(device) -> int:
    """DIEN at history 1,000: ``remat=None`` turns rematerialization on
    (T > 256); the same steps from the same init with ``remat=False``."""
    data = SyntheticSequence(num_items=BST_ITEMS, num_cats=BST_CATS, max_len=BST_LONG_T,
                             seed=SEED).sample(DIEN_LONG_STEPS * BST_LONG_BATCH, seed=1)
    model = _sequence_model(DIEN, device)
    stored = copy.deepcopy(model)
    stored.extract_gru.remat = stored.evolve.remat = False
    runs, total = {}, 0
    for name, m in (("remat", model), ("stored", stored)):
        torch.cuda.reset_peak_memory_stats()
        _, state, logs, stamps, launches = _timed_fit(
            m, device, data, BST_LONG_BATCH, DIEN_LONG_STEPS)
        _check_fit(f"DIEN long ({name})", state, logs, DIEN_LONG_STEPS, launches,
                   DIEN_K1_PER_STEP)
        runs[name] = dict(losses=[x["loss"] for x in logs],
                          ms_per_step=(np.diff(np.array(stamps)) * 1e3).tolist(),
                          peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                          k1_launches=launches)
        total += launches
    diff = max(abs(a - b) for a, b in zip(runs["remat"]["losses"], runs["stored"]["losses"]))
    emit("dien_long", steps=DIEN_LONG_STEPS, batch=BST_LONG_BATCH, history=BST_LONG_T,
         **runs, remat_vs_stored_max_loss_diff=diff, tolerance=DIEN_REMAT_LOSS_TOL)
    check(model.extract_gru.remat is None and model.evolve.remat is None, "remat is not auto")
    check(diff <= DIEN_REMAT_LOSS_TOL, f"remat vs stored DIEN losses differ by {diff}")
    return total


SMALL_DIEN = dict(item_vocab=300, cat_vocab=20, item_dim=8, cat_dim=8, mlp_units=(32, 16, 1),
                  extract_hidden=12, evolve_hidden=10)


def _small_dien(device, state_dict, data) -> list[float]:
    model = DIEN(**SMALL_DIEN, device=device)
    model.load_state_dict(state_dict)
    loss_fn, eval_fn = make_aux_loss_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=1), eval_fn, device=device)
    state = trainer.init_state(lambda: model)
    losses = []
    trainer.fit(state, batch_iterator(data, 256, seed=SEED), 3,
                log_fn=lambda m: losses.append(m["loss"]))
    return losses


def phase_dien_card_cpu(device):
    data = SyntheticSequence(num_items=300, num_cats=20, max_len=20, seed=SEED).sample(3 * 256, seed=1)
    init = init_model(DIEN(**SMALL_DIEN), seed=SEED).state_dict()
    launches = ek.sorted_scatter_add.launches
    card = _small_dien(device, init, data)
    launched = ek.sorted_scatter_add.launches - launches
    cpu = _small_dien(torch.device("cpu"), init, data)
    diff = max(abs(a - b) for a, b in zip(card, cpu))
    emit("dien_card_cpu", card_losses=card, cpu_losses=cpu, max_abs_diff=diff,
         tolerance=CARD_CPU_LOSS_TOL, k1_launches_on_card=launched)
    check(len(card) == len(cpu) == 3, "DIEN card/CPU step count")
    check(launched == 3 * DIEN_K1_PER_STEP, f"card run launched K1 {launched} times")
    check(diff <= CARD_CPU_LOSS_TOL, f"DIEN card vs CPU losses differ by {diff}")


def _cli_run(args: list[str], entry=train_dien.main):
    """``entry(args)`` (``train_dien.main`` by default) with its JSON lines
    captured: what it returns and the lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state = entry(args)
    return state, [json.loads(line) for line in out.getvalue().splitlines()]


def phase_dien_cli() -> int:
    """The entry point as a user calls it (``--device`` at its default, the
    card): a straight run, then half the steps and ``--resume`` for the rest."""
    root = _build.BUILD_DIR / "dien_cli_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    half = DIEN_CLI_STEPS // 2
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    straight, lines = _cli_run([*DIEN_CLI_ARGS, "--steps", str(DIEN_CLI_STEPS),
                                "--checkpoint_dir", str(root / "straight")])
    seconds = time.perf_counter() - t0
    launches = ek.sorted_scatter_add.launches
    _cli_run([*DIEN_CLI_ARGS, "--steps", str(half), "--checkpoint_dir", str(root / "resumed")])
    resumed, resumed_lines = _cli_run([*DIEN_CLI_ARGS, "--steps", str(DIEN_CLI_STEPS - half),
                                       "--resume", "--checkpoint_dir", str(root / "resumed")])
    final, resumed_final = lines[-1], resumed_lines[-1]
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    differing = [k for k in want if not torch.equal(want[k], got[k])]
    moments = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    differing += [f"{w}[{i}]" for w in ("mu", "nu")
                  for i, (a, b) in enumerate(zip(moments[0][w], moments[1][w]))
                  if not torch.equal(a, b)]
    files = sorted(f.name for f in (root / "resumed").iterdir())
    emit("dien_cli", args=list(DIEN_CLI_ARGS), steps=DIEN_CLI_STEPS, device=str(
        next(straight.model.parameters()).device), log=lines[:-1], final=final,
         resumed_final=resumed_final, auc_margin=DIEN_CLI_AUC_MARGIN, seconds=seconds,
         k1_launches=launches, resumed_step=resumed.step, checkpoints=files,
         tensors_differing_after_resume=differing)
    shutil.rmtree(root, ignore_errors=True)
    check(next(straight.model.parameters()).device.type == "cuda", "the CLI did not run on the card")
    check(straight.step == DIEN_CLI_STEPS == resumed.step, "CLI step counts")
    check(final.get("final") == 1 and math.isfinite(final["eval_loss"]), "CLI final eval line")
    check(final["eval_auc_exact"] > 0.5 + DIEN_CLI_AUC_MARGIN,
          f"CLI eval_auc_exact {final['eval_auc_exact']} <= 0.5 + {DIEN_CLI_AUC_MARGIN}")
    check(launches == DIEN_K1_PER_STEP * DIEN_CLI_STEPS, f"CLI run launched K1 {launches} times")
    check(files == [f"step_{DIEN_CLI_STEPS}.pt", f"step_{half}.pt"], f"checkpoints {files}")
    check(not differing, f"resumed run differs from the straight run in {differing}")
    check(final == resumed_final, "resumed run's final eval differs")
    return launches


@contextlib.contextmanager
def host_times():
    """Host clock around each ``Trainer.put_batch`` (the copy to the card)
    and ``Trainer.train_step`` (forward, backward and optimizer enqueued;
    with a sync at every log point the queue is empty when a step starts,
    so this is the host's enqueue time), in ms, while the block runs."""
    times = {"put": [], "enqueue": []}
    real = {"put": Trainer.put_batch, "enqueue": Trainer.train_step}

    def timed(key):
        def fn(self, *args):
            t0 = time.perf_counter()
            out = real[key](self, *args)
            times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return fn

    Trainer.put_batch, Trainer.train_step = timed("put"), timed("enqueue")
    try:
        yield times
    finally:
        Trainer.put_batch, Trainer.train_step = real["put"], real["enqueue"]


def _ctr_run(name: str, args: list[str], steps: int, per_step: int) -> dict:
    """One ``cli.train_ctr.main`` run on the card with a log point at every
    step: its per-step losses, synced step time (the log lines' window),
    host put and enqueue times, final eval and K1 launches; checked."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with host_times() as host:
        state, lines = _cli_run([*args, "--steps", str(steps)], train_ctr.main)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ek.sorted_scatter_add.launches
    logs = [m for m in lines if "loss" in m]
    final = lines[-1]
    timed = slice(-min(TIMED_STEPS, steps - 1), None)
    step_ms = np.array([BATCH / m["examples_per_s"] * 1e3 for m in logs])[timed]
    enqueue = np.array(host["enqueue"][:steps])[timed]
    put = np.array(host["put"][:steps])[timed]
    out = dict(steps=state.step, losses=[m["loss"] for m in logs],
               ms_per_step_median=float(np.median(step_ms)),
               ms_per_step_min=float(step_ms.min()), ms_per_step_max=float(step_ms.max()),
               examples_per_s=BATCH / (float(np.median(step_ms)) / 1e3),
               host_enqueue_ms_median=float(np.median(enqueue)),
               host_put_ms_median=float(np.median(put)),
               final=final, k1_launches=launches, seconds=seconds,
               device=str(next(state.model.parameters()).device))
    emit("ctr_cli", run=name, **out)
    check(out["device"].startswith("cuda"), f"{name}: the CLI did not run on the card")
    check(state.step == steps == len(logs), f"{name} took {state.step} steps, wanted {steps}")
    check(all(math.isfinite(x) for x in out["losses"]), f"non-finite {name} training loss")
    check(final.get("final") == 1 and final["eval_batches"] == EVAL_BATCHES,
          f"{name}: final eval line {final}")
    check(launches == per_step * steps,
          f"{name}: K1 launched {launches} times in {steps} steps, wanted {per_step} a step")
    out["state"] = state
    return out


def write_ctr_shards(root) -> None:
    """``train/`` with CTR_SHARDS .npz shards of CTR_SHARD_ROWS
    ``SyntheticCTR`` rows in the Criteo shard schema, ``test/`` with one of
    EVAL_BATCHES batches, and a vocab file (its size only has to fit the
    table: the rows' ids are already encoded)."""
    gen = SyntheticCTR(vocab_size=VOCAB, seed=SEED)
    for part, n, count in (("train", CTR_SHARD_ROWS, CTR_SHARDS), ("test", EVAL_BATCHES * BATCH, 1)):
        (root / part).mkdir(parents=True)
        for i in range(count):
            np.savez(root / part / f"shard_{i:05d}.npz", **gen.sample(n, seed=10 + i + 100 * (part == "test")))
    criteo.save_vocab({"__miss_0__": 1}, str(root / "vocab.pkl"))


def phase_ctr_cli() -> dict:
    """``cli.train_ctr.main`` as a user calls it (``--device`` at its
    default, the card) at bench.py width: DLRM with dedup plans off and on,
    DeepFM, DCN, the .npz shard stream with two workers, and a resume."""
    root = _build.BUILD_DIR / "ctr_cli"
    shutil.rmtree(root, ignore_errors=True)
    runs = {}
    for name in ("dlrm", "dlrm_dedup", "dlrm_dedup_again", "dlrm_again"):
        dedup_on = "dedup" in name
        runs[name] = _ctr_run(name, [*CTR_ARGS, "--model_type", "DLRM",
                                     "--dedup_lookup", "on" if dedup_on else "off"],
                              CTR_DLRM_STEPS, 2 if dedup_on else 1)
    for kind in ("DeepFM", "DCN"):
        runs[kind.lower()] = _ctr_run(kind.lower(), [*CTR_ARGS, "--model_type", kind],
                                      CTR_OTHER_STEPS, 1)
    write_ctr_shards(root / "shards")
    shard_args = [a for a in CTR_ARGS if a != "--synthetic"]
    runs["shards"] = _ctr_run("shards", [*shard_args, "--data_dir", str(root / "shards"),
                                         "--vocab", str(root / "shards" / "vocab.pkl"),
                                         "--prefetch_workers", "2"], CTR_SHARD_STEPS, 1)
    dedup_diff = max(abs(a - b) for on, off in (("dlrm_dedup", "dlrm"),
                                                ("dlrm_dedup_again", "dlrm_again"))
                     for a, b in zip(runs[on]["losses"], runs[off]["losses"]))
    aucs = {k: runs[k]["final"]["eval_auc_exact"] for k in ("dlrm", "dlrm_dedup", "deepfm", "dcn")}
    # dedup on minus off, per pair: the synced step and the host's enqueue
    dedup_minus_off_ms = {
        key: [runs[on][key] - runs[off][key] for on, off in
              (("dlrm_dedup", "dlrm"), ("dlrm_dedup_again", "dlrm_again"))]
        for key in ("ms_per_step_median", "host_enqueue_ms_median", "host_put_ms_median")}
    emit("ctr_cli_summary", dedup_on_vs_off_max_loss_diff=dedup_diff,
         dedup_loss_tolerance=CTR_DEDUP_LOSS_TOL, dedup_minus_off_ms=dedup_minus_off_ms,
         eval_auc_exact=aucs, auc_margins=CTR_AUC_MARGIN)
    check(dedup_diff <= CTR_DEDUP_LOSS_TOL, f"dedup on vs off: losses differ by {dedup_diff}")
    for key, kind in (("dlrm", "DLRM"), ("dlrm_dedup", "DLRM"), ("deepfm", "DeepFM"),
                      ("dcn", "DCN")):
        check(aucs[key] > 0.5 + CTR_AUC_MARGIN[kind],
              f"{key}: eval_auc_exact {aucs[key]} <= 0.5 + {CTR_AUC_MARGIN[kind]}")

    # resume: half the steps, then --resume, against the straight run (dedup
    # plans on, the warmup + cosine schedule)
    args = [*CTR_ARGS, "--model_type", "DLRM", *CTR_RESUME_ARGS]
    half = CTR_RESUME_STEPS // 2
    reset_counts()
    straight, lines = _cli_run([*args, "--steps", str(CTR_RESUME_STEPS), "--checkpoint_dir",
                                str(root / "straight")], train_ctr.main)
    ckpt = ["--checkpoint_dir", str(root / "resumed")]
    _cli_run([*args, "--steps", str(half), *ckpt], train_ctr.main)
    resumed, resumed_lines = _cli_run([*args, "--steps", str(CTR_RESUME_STEPS - half),
                                       "--resume", *ckpt], train_ctr.main)
    launches = ek.sorted_scatter_add.launches
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    differing = [k for k in want if not torch.equal(want[k], got[k])]
    moments = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    differing += [f"{w}[{i}]" for w in ("mu", "nu")
                  for i, (a, b) in enumerate(zip(moments[0][w], moments[1][w]))
                  if not torch.equal(a, b)]
    files = sorted(f.name for f in (root / "resumed").iterdir())
    emit("ctr_cli", run="resume", args=args, steps=CTR_RESUME_STEPS, final=lines[-1],
         resumed_final=resumed_lines[-1], resumed_step=resumed.step, checkpoints=files,
         k1_launches=launches, tensors_differing_after_resume=differing)
    check(straight.step == CTR_RESUME_STEPS == resumed.step, "resume step counts")
    check(files == sorted([f"step_{half}.pt", f"step_{CTR_RESUME_STEPS}.pt"]),
          f"checkpoints {files}")
    check(not differing, f"resumed run differs from the straight run in {differing}")
    check(lines[-1] == resumed_lines[-1], "resumed run's final eval differs")
    check(launches == 2 * 2 * CTR_RESUME_STEPS, f"resume runs launched K1 {launches} times")
    runs["resume"] = dict(k1_launches=launches, state=resumed)
    return runs


def phase_accum(device) -> dict:
    """Gradient accumulation at bench.py's DLRM width (1M x 16 bf16 table,
    SR-Adam, b8192). First the Trainer's f32 gradients of one batch at
    accum_steps 4 against the average of the same four quarter batches run
    one by one (the ranks' shapes, as ``_dist_dp`` takes the halves): the
    sums are in the same order, so they must agree bit for bit or, where a
    library product rounds otherwise, within ACCUM_GRAD_REL_TOL of each
    tensor's largest entry. Then ``cli.train_ctr`` with ``--accum_steps 4``
    and 1 for ACCUM_STEPS steps: the losses within ACCUM_LOSS_TOL, the step
    time and the peak device memory of each."""
    batch = SyntheticCTR(vocab_size=VOCAB, seed=SEED).sample(BATCH, seed=1)
    model = DLRM(VOCAB, DIM, embed_param_dtype=torch.bfloat16, device=device)
    init_model(model, seed=SEED)
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, accum_steps=ACCUM, seed=SEED),
                      eval_fn, device=device)
    state = trainer.init_state(lambda: model)
    params = state.optimizer.param_groups[0]["params"]
    names = {id(p): n for n, p in model.named_parameters()}
    local = trainer.put_batch(batch)
    reset_counts()
    got, _ = trainer._accumulate(state, local, ACCUM, params)
    grad_k1 = ek.sorted_scatter_add.launches
    quarter = BATCH // ACCUM
    want = [torch.zeros(p.shape, dtype=torch.float32, device=device) for p in params]
    for i in range(ACCUM):
        model.zero_grad(set_to_none=True)
        per_ex, _ = loss_fn({k: v[i * quarter:(i + 1) * quarter] for k, v in local.items()}, True)
        torch.mean(per_ex).backward()
        for w, p in zip(want, params):
            w += p.grad.float()
    model.zero_grad(set_to_none=True)
    want = [w / ACCUM for w in want]
    torch.cuda.synchronize()
    rel = {names[id(p)]: float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
           for p, g, w in zip(params, got, want)}
    bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
    dtypes = sorted({str(g.dtype) for g in got})
    del model, trainer, state, params, got, want, local

    runs = {}
    for a in (1, ACCUM):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = _ctr_run(f"accum_{a}", [*CTR_ARGS, "--model_type", "DLRM", "--dedup_lookup", "off",
                                      "--accum_steps", str(a)], ACCUM_STEPS, a)
        run.pop("state")
        run["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        runs[a] = run
    diff = max(abs(x - y) for x, y in zip(runs[ACCUM]["losses"], runs[1]["losses"]))
    emit("accum", accum_steps=ACCUM, batch=BATCH, microbatch=quarter,
         grad_dtypes=dtypes, grad_bitwise_equal=bitwise, grad_max_rel_err=rel,
         grad_rel_tolerance=ACCUM_GRAD_REL_TOL, grad_k1_launches=grad_k1,
         losses={a: runs[a]["losses"] for a in runs}, max_loss_diff=diff,
         loss_tolerance=ACCUM_LOSS_TOL,
         ms_per_step_median={a: runs[a]["ms_per_step_median"] for a in runs},
         peak_memory_gib={a: runs[a]["peak_memory_gib"] for a in runs})
    check(dtypes == ["torch.float32"], f"accumulated gradients are {dtypes}, not f32")
    check(grad_k1 == ACCUM, f"K1 launched {grad_k1} times for {ACCUM} microbatches")
    check(bitwise or max(rel.values()) <= ACCUM_GRAD_REL_TOL,
          f"accumulated gradients off the quarters' average by {max(rel.values())}")
    check(diff <= ACCUM_LOSS_TOL, f"--accum_steps {ACCUM} vs 1: losses differ by {diff}")
    return {f"accum_cli_{a}": runs[a]["k1_launches"] for a in runs} | {"accum_grads": grad_k1}


def phase_profiling(device) -> int:
    """``core.profiling.trace`` around PROFILE_STEPS DLRM Trainer steps at
    bench.py width, each step's batch copy and step inside an ``annotate``
    mark: the trace file must exist and name both marks and K1's kernels."""
    train = SyntheticCTR(vocab_size=VOCAB, seed=SEED).sample(PROFILE_STEPS * BATCH, seed=1)
    model = DLRM(VOCAB, DIM, embed_param_dtype=torch.bfloat16, device=device)
    init_model(model, seed=SEED)
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, seed=SEED), eval_fn, device=device)
    state = trainer.init_state(lambda: model)
    batches = list(batch_iterator(train, BATCH, seed=SEED))
    root = _build.BUILD_DIR / "profiling"
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with profiling.trace(str(root)) as prof:
        for b in batches:
            with profiling.annotate(PROFILE_MARKS[0]):
                local = trainer.put_batch(b)
            with profiling.annotate(PROFILE_MARKS[1]):
                state, _ = trainer.train_step(state, local)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ek.sorted_scatter_add.launches
    files = sorted(root.glob("*.pt.trace.json"))
    events = json.loads(files[0].read_text())["traceEvents"] if files else []
    names = {e.get("name", "") for e in events}
    k1_kernels = sorted(n for n in names if any(f in n for f in dict(PROFILE_PARTS)["k1"]))
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / PROFILE_STEPS
    emit("profiling", steps=PROFILE_STEPS, trace_files=[f.name for f in files],
         trace_mib=files[0].stat().st_size / 2**20 if files else 0, events=len(events),
         marks={m: m in names for m in PROFILE_MARKS}, k1_kernels=k1_kernels,
         k1_launches=launches, seconds=seconds, device_busy_ms_per_step=device_ms,
         launches_per_step=len(kernels) / PROFILE_STEPS)
    check(len(files) == 1, f"trace wrote {len(files)} files")
    check(all(m in names for m in PROFILE_MARKS), "the trace lacks an annotate mark")
    check(all(any(f in n for n in k1_kernels) for f in dict(PROFILE_PARTS)["k1"]),
          f"the trace names K1's kernels {k1_kernels}")
    check(launches == PROFILE_STEPS, f"K1 launched {launches} times in {PROFILE_STEPS} steps")
    return launches


def phase_ctr_predict(state) -> dict:
    """``cli.predict.main`` on the card from the resumed run's checkpoint
    (DLRM, bf16 table) at b8192, against the restored model's eval forward
    on the same batches, the last one padded as ``score_batches`` pads it."""
    root = _build.BUILD_DIR / "ctr_cli"
    rows = SyntheticCTR(vocab_size=VOCAB, seed=SEED).sample(PREDICT_ROWS, seed=3)
    np.savez(root / "predict_in.npz", **rows)
    torch.cuda.synchronize()
    reset_counts()
    scores, lines = _cli_run(["--family", "ctr", "--model_type", "DLRM",
                              "--checkpoint_dir", str(root / "resumed"),
                              "--vocab_size", str(VOCAB), "--embedding_size", str(DIM),
                              "--batch_size", str(BATCH), "--input", str(root / "predict_in.npz"),
                              "--output", str(root / "predict_out.npz")], predict.main)
    launches = ek.sorted_scatter_add.launches
    (line,) = lines
    model = state.model.eval()  # the restored run's model: the checkpoint's weights
    want = []
    with torch.no_grad():
        for s in range(0, PREDICT_ROWS, BATCH):
            batch = {k: v[s:s + BATCH] for k, v in rows.items()}
            n = len(batch["label"])
            batch = {k: np.concatenate([v, np.repeat(v[-1:], BATCH - n, axis=0)])
                     for k, v in batch.items()}
            prob = model({k: torch.from_numpy(v).to(state.model.embedding.embedding.device)
                          for k, v in batch.items()})
            want.append(prob.cpu().numpy()[:n])
    want = np.concatenate(want)
    got = np.load(root / "predict_out.npz")["score"]
    err = float(np.abs(got - want).max())
    emit("ctr_predict", rows=PREDICT_ROWS, batch=BATCH, line=line, max_abs_err=err,
         tolerance=PREDICT_TOL, table_dtype=str(state.model.embedding.embedding.dtype),
         k1_launches=launches)
    shutil.rmtree(root, ignore_errors=True)
    check(got.shape == (PREDICT_ROWS,) and np.isfinite(got).all(), "predict scores' shape")
    check(np.array_equal(got, scores["score"]), "predict's saved scores differ from its return")
    check(err <= PREDICT_TOL, f"predict scores off the eval forward by {err}")
    check(line["step"] == CTR_RESUME_STEPS, f"predict restored step {line['step']}")
    return dict(line=line, k1_launches=launches)


# ------------------------------------------------- multi-task and graph
def multitask_data() -> tuple[dict, dict]:
    """``SyntheticMultiTask`` rows at bench_mmoe_large's vocabularies:
    MT_STEPS batches to train on and EVAL_BATCHES held out."""
    gen = SyntheticMultiTask(vocab_sizes=(MT_VOCAB,) * MT_FEATS, seed=SEED)
    return gen.sample(MT_STEPS * MT_BATCH, seed=1), gen.sample(EVAL_BATCHES * MT_BATCH, seed=2)


def _mt_model(cls, device, table_dtype=torch.float32, stack=False, **kw):
    model = cls(vocab_sizes=(MT_VOCAB,) * MT_FEATS, embed_dim=MT_DIM, stack_tables=stack,
                embed_param_dtype=table_dtype, device=device, **kw)
    return init_model(model, seed=SEED)


def _host_timed_fit(model, device, train, batch: int, steps: int) -> dict:
    """``_timed_fit`` with the host's put and enqueue times: the synced step
    (median of the last TIMED_STEPS), the enqueue, the losses, K1 launches
    and peak memory of the run."""
    torch.cuda.reset_peak_memory_stats()
    with host_times() as host:
        trainer, state, logs, stamps, launches = _timed_fit(model, device, train, batch, steps)
    timed = slice(-min(TIMED_STEPS, steps - 1), None)
    step_ms = (np.diff(np.array(stamps)) * 1e3)[timed]
    return dict(trainer=trainer, state=state, logs=logs, launches=launches,
                summary=dict(steps=state.step, losses=[m["loss"] for m in logs],
                             ms_per_step_median=float(np.median(step_ms)),
                             ms_per_step_min=float(step_ms.min()),
                             ms_per_step_max=float(step_ms.max()),
                             examples_per_s=batch / (float(np.median(step_ms)) / 1e3),
                             host_enqueue_ms_median=float(np.median(
                                 np.array(host["enqueue"][:steps])[timed])),
                             host_put_ms_median=float(np.median(
                                 np.array(host["put"][:steps])[timed])),
                             peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                             k1_launches=launches))


def phase_mmoe_train(device, train, test) -> int:
    """MMOE at bench_mmoe_large width: per-table f32 tables, per-table bf16
    tables with stochastic rounding, and one stacked f32 table started from
    the per-table run's init (the same function: the losses must agree);
    then ESMM at the same width. K1 launches exactly once per table and
    step, or once a step for the stacked table."""
    per_table = _mt_model(MMOE, device)
    stacked = _mt_model(MMOE, device, stack=True)
    with torch.no_grad():  # the per-table init, stacked
        init = per_table.state_dict()
        stacked.embedder.stacked_embedding.copy_(torch.cat(
            [init[f"embedder.feat_{j}.embedding"] for j in range(MT_FEATS)]))
        stacked.load_state_dict({k: v for k, v in init.items() if not k.startswith("embedder.")},
                                strict=False)
    runs = {}
    for name, model, per_step in (
        ("per_table_f32", per_table, MT_K1_PER_STEP),
        ("per_table_bf16_sr", _mt_model(MMOE, device, torch.bfloat16), MT_K1_PER_STEP),
        ("stacked_f32", stacked, MT_STACKED_K1_PER_STEP),
    ):
        runs[name] = _host_timed_fit(model, device, train, MT_BATCH, MT_STEPS)
        _check_fit(f"MMOE {name}", runs[name]["state"], runs[name]["logs"], MT_STEPS,
                   runs[name]["launches"], per_step)
        runs[name]["summary"]["k1_per_step"] = per_step
    esmm = _host_timed_fit(_mt_model(ESMM, device), device, train, MT_BATCH, ESMM_STEPS)
    _check_fit("ESMM", esmm["state"], esmm["logs"], ESMM_STEPS, esmm["launches"],
               MT_K1_PER_STEP)
    first = runs["per_table_f32"]
    ctcvr_auc = evaluate_head(first["trainer"], first["state"],
                              batch_iterator(test, MT_BATCH, shuffle=False),
                              make_head_eval(per_table, "ctcvr", "purchase"), exact=True)
    stacked_diff = max(abs(a - b) for a, b in zip(runs["stacked_f32"]["summary"]["losses"],
                                                  first["summary"]["losses"]))
    emit("mmoe_train", batch=MT_BATCH, tables=f"{MT_FEATS} x [{MT_VOCAB}, {MT_DIM}]",
         **{name: r["summary"] for name, r in runs.items()}, esmm=esmm["summary"],
         per_table_f32_eval_ctcvr_auc_exact=ctcvr_auc,
         stacked_vs_per_table_max_loss_diff=stacked_diff, tolerance=MT_STACKED_LOSS_TOL)
    for name, r in [*runs.items(), ("esmm", esmm)]:
        losses = r["summary"]["losses"]
        check(np.mean(losses[-5:]) < np.mean(losses[:5]),
              f"{name} loss did not fall: {losses[:5]} -> {losses[-5:]}")
    check(runs["per_table_bf16_sr"]["state"].model.embedder.feat_0.embedding.dtype
          == torch.bfloat16, "bf16 table dtype")
    check(stacked_diff <= MT_STACKED_LOSS_TOL,
          f"stacked vs per-table MMOE losses differ by {stacked_diff}")
    # 50 steps at 100,000 rows a table see each id a few times: the quality
    # guards are esmm_cli's
    check(0.0 <= ctcvr_auc <= 1.0, f"MMOE ctcvr AUC {ctcvr_auc}")
    return sum(r["launches"] for r in runs.values()) + esmm["launches"]


SMALL_MT = dict(vocab_sizes=(50,) * 4, embed_dim=8, num_experts=4, expert_units=(16, 8),
                tower_units=(8, 1))


def _small_fit_losses(make_model, state_dict, task, batches, device) -> list[float]:
    model = make_model(device)
    model.load_state_dict(state_dict)
    loss_fn, eval_fn = task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=1), eval_fn, device=device)
    losses = []
    trainer.fit(trainer.init_state(lambda: model), iter(batches), 3,
                log_fn=lambda m: losses.append(m["loss"]))
    return losses


def phase_mt_graph_card_cpu(device, eges_graph: tuple):
    """A small MMOE and a small EGES, 3 steps each from one init on the card
    and on the CPU; the losses must agree."""
    mt = SyntheticMultiTask(num_feats=4, seed=SEED).sample(3 * 256, seed=1)
    mt_batches = list(batch_iterator(mt, 256, seed=SEED))
    g, side = eges_graph
    it = skipgram_batches(g, batch_size=256, walks_per_round=64, side_info=side, seed=SEED)
    eges_batches = [next(it) for _ in range(3)]
    out = {}
    for name, make, task, batches, per_step in (
        ("mmoe", lambda d: MMOE(**SMALL_MT, device=d), make_multitask_task, mt_batches, 4),
        ("eges", lambda d: EGES(EGES_V, EGES_CATS, EGES_BRANDS, 16, device=d),
         make_skipgram_task, eges_batches, EGES_K1_PER_STEP),
    ):
        init = init_model(make(torch.device("cpu")), seed=SEED).state_dict()
        before = ek.sorted_scatter_add.launches
        card = _small_fit_losses(make, init, task, batches, device)
        launched = ek.sorted_scatter_add.launches - before
        cpu = _small_fit_losses(make, init, task, batches, torch.device("cpu"))
        diff = max(abs(a - b) for a, b in zip(card, cpu))
        out[name] = dict(card_losses=card, cpu_losses=cpu, max_abs_diff=diff,
                         k1_launches_on_card=launched)
        check(len(card) == len(cpu) == 3, f"{name} card/CPU step count")
        check(launched == 3 * per_step, f"{name} card run launched K1 {launched} times")
        check(diff <= CARD_CPU_LOSS_TOL, f"{name} card vs CPU losses differ by {diff}")
    emit("mt_graph_card_cpu", **out, tolerance=CARD_CPU_LOSS_TOL)


def phase_esmm_cli() -> int:
    """``cli.train_esmm.main`` as a user calls it (``--device`` at its
    default, the card): ESMM, MMOE and BASE with AUC guards; MMOE's 80
    steps straight against 40 + ``--resume`` 40, bit for bit; then
    ``cli.predict --family esmm`` from the resumed checkpoint on the CLI's
    test split: the heads must equal the restored model's eval forward."""
    root = _build.BUILD_DIR / "esmm_cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    runs, launches = {}, 0
    for kind in ("ESMM", "MMOE", "BASE"):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ckpt = [] if kind == "BASE" else ["--checkpoint_dir", str(root / kind.lower())]
        out, lines = _cli_run([*ESMM_CLI_ARGS, "--model_type", kind,
                               "--steps", str(ESMM_CLI_STEPS), *ckpt], train_esmm.main)
        torch.cuda.synchronize()
        n = ek.sorted_scatter_add.launches
        launches += n
        models = 2 if kind == "BASE" else 1
        runs[kind] = dict(final=lines[-1], seconds=time.perf_counter() - t0, k1_launches=n,
                          losses=[m["loss"] for m in lines if "loss" in m])
        device = next((out["ctr"][0] if kind == "BASE" else out.model).parameters()).device
        check(device.type == "cuda", f"{kind}: the CLI did not run on the card")
        check(n == MT_K1_PER_STEP * ESMM_CLI_STEPS * models, f"{kind}: K1 launched {n} times")
        cvr_margin, ctcvr_margin = ESMM_CLI_AUC_MARGIN[kind]
        final = lines[-1]
        check(final["ctcvr_auc"] > 0.5 + ctcvr_margin,
              f"{kind} ctcvr_auc {final['ctcvr_auc']} <= 0.5 + {ctcvr_margin}")
        if cvr_margin is not None:
            check(final["cvr_auc"] > 0.5 + cvr_margin,
                  f"{kind} cvr_auc {final['cvr_auc']} <= 0.5 + {cvr_margin}")
        if kind == "MMOE":
            straight = out
    half = ESMM_CLI_STEPS // 2
    ckpt = ["--checkpoint_dir", str(root / "resumed")]
    args = [*ESMM_CLI_ARGS, "--model_type", "MMOE"]
    reset_counts()
    _cli_run([*args, "--steps", str(half), *ckpt], train_esmm.main)
    resumed, resumed_lines = _cli_run([*args, "--steps", str(ESMM_CLI_STEPS - half),
                                       "--resume", *ckpt], train_esmm.main)
    launches += ek.sorted_scatter_add.launches
    want, got = straight.model.state_dict(), resumed.model.state_dict()
    differing = [k for k in want if not torch.equal(want[k], got[k])]
    moments = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    differing += [f"{w}[{i}]" for w in ("mu", "nu")
                  for i, (a, b) in enumerate(zip(moments[0][w], moments[1][w]))
                  if not torch.equal(a, b)]
    files = sorted(f.name for f in (root / "resumed").iterdir())
    # predict from the resumed checkpoint, on the CLI's test split
    test = SyntheticMultiTask(seed=SEED).sample(20_000, seed=2)
    np.savez(root / "predict_in.npz", **test)
    reset_counts()
    t0 = time.perf_counter()
    scores, (line,) = _cli_run(["--family", "esmm", "--model_type", "MMOE",
                                "--checkpoint_dir", str(root / "resumed"), "--batch_size", "4096",
                                "--input", str(root / "predict_in.npz"),
                                "--output", str(root / "predict_out.npz")], predict.main)
    predict_seconds = time.perf_counter() - t0
    predict_launches = ek.sorted_scatter_add.launches
    model = resumed.model.eval()
    with torch.no_grad():
        heads = model({"features": torch.from_numpy(test["features"]).to(
            next(model.parameters()).device)})
    saved = dict(np.load(root / "predict_out.npz"))
    errs = {k: float(np.abs(saved[k] - heads[k].cpu().numpy()).max()) for k in heads}
    emit("esmm_cli", args=list(ESMM_CLI_ARGS), steps=ESMM_CLI_STEPS, runs=runs,
         auc_margins={k: list(v) for k, v in ESMM_CLI_AUC_MARGIN.items()},
         resumed_final=resumed_lines[-1], resumed_step=resumed.step, checkpoints=files,
         tensors_differing_after_resume=differing, predict=line,
         predict_seconds=predict_seconds, predict_max_abs_err=errs,
         predict_tolerance=PREDICT_TOL, predict_k1_launches=predict_launches)
    shutil.rmtree(root, ignore_errors=True)
    check(straight.step == ESMM_CLI_STEPS == resumed.step, "resume step counts")
    check(files == sorted([f"step_{half}.pt", f"step_{ESMM_CLI_STEPS}.pt"]),
          f"checkpoints {files}")
    check(not differing, f"resumed MMOE differs from the straight run in {differing}")
    check(runs["MMOE"]["final"] == resumed_lines[-1], "resumed run's final AUCs differ")
    check(sorted(scores) == ["ctcvr", "ctr", "cvr"] and line["predicted"] == 20_000,
          f"predict heads {sorted(scores)}")
    check(all(np.isfinite(v).all() for v in saved.values()), "non-finite predict scores")
    check(max(errs.values()) <= PREDICT_TOL, f"predict heads off the eval forward by {errs}")
    check(predict_launches == 0, f"predict launched K1 {predict_launches} times")
    return launches


def eges_graph() -> tuple:
    """bench_eges's graph: 2,000,000 random weighted edges over 100,000
    nodes, with cat and brand side info (built with the native sampler)."""
    rng = np.random.default_rng(SEED)
    src = rng.integers(1, EGES_V, EGES_EDGES)
    dst = rng.integers(1, EGES_V, EGES_EDGES)
    w = rng.random(EGES_EDGES).astype(np.float32)
    g = WeightedGraph.from_edges(src, dst, w, num_nodes=EGES_V)
    side = {"cat": rng.integers(1, EGES_CATS, EGES_V).astype(np.int32),
            "brand": rng.integers(1, EGES_BRANDS, EGES_V).astype(np.int32)}
    return g, side


def eges_stream(g, side, seed=SEED):
    return skipgram_batches(g, batch_size=EGES_BATCH, walks_per_round=512, side_info=side,
                            seed=seed)


def phase_eges_train(device, graph: tuple) -> int:
    """EGES at bench_eges width, 50 steps through ``Trainer.fit`` (the
    sampler in its prefetch thread), a sync at each step; then the host
    sampler alone."""
    g, side = graph
    check(native.is_available() and g.native, "the native graph sampler did not load")
    model = init_model(EGES(EGES_V, EGES_CATS, EGES_BRANDS, EGES_DIM, device=device), seed=SEED)
    loss_fn, eval_fn = make_skipgram_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=1, eval_every=0,
                                           seed=SEED), eval_fn, device=device)
    it = eges_stream(g, side)
    next(it)  # the init example, as cli.train_eges takes it
    state = trainer.init_state(lambda: model)
    stamps, losses = [], []

    def log_fn(m):
        stamps.append(time.perf_counter())
        losses.append(m["loss"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with host_times() as host:
        state, _ = trainer.fit(state, it, EGES_STEPS, log_fn=log_fn)
    torch.cuda.synchronize()
    launches = ek.sorted_scatter_add.launches
    step_ms = (np.diff(np.array(stamps)) * 1e3)[-TIMED_STEPS:]
    sampler = eges_stream(g, side, seed=SEED + 1)
    next(sampler)
    t0 = time.perf_counter()
    for _ in range(EGES_SAMPLER_BATCHES):
        next(sampler)
    sampler_s = (time.perf_counter() - t0) / EGES_SAMPLER_BATCHES
    emit("eges_train", steps=state.step, batch=EGES_BATCH, nodes=EGES_V, edges=EGES_EDGES,
         dim=EGES_DIM, losses=losses, ms_per_step_median=float(np.median(step_ms)),
         ms_per_step_min=float(step_ms.min()), ms_per_step_max=float(step_ms.max()),
         pairs_per_s=EGES_BATCH / (float(np.median(step_ms)) / 1e3),
         host_enqueue_ms_median=float(np.median(host["enqueue"][-TIMED_STEPS:])),
         host_put_ms_median=float(np.median(host["put"][-TIMED_STEPS:])),
         sampler_ms_per_batch=sampler_s * 1e3, sampler_batches_per_s=1.0 / sampler_s,
         native_sampler=native.is_available(),
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
         k1_launches=launches, k1_per_step=EGES_K1_PER_STEP)
    check(state.step == EGES_STEPS == len(losses), f"EGES took {state.step} steps")
    check(all(math.isfinite(x) for x in losses), "non-finite EGES loss")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]), f"EGES loss did not fall: {losses}")
    check(launches == EGES_K1_PER_STEP * EGES_STEPS, f"EGES: K1 launched {launches} times")
    return launches


def _community_triples(comm: np.ndarray, side: dict, num_nodes: int, n: int = 4000) -> dict:
    """Held-out pairs from one community against uniform negatives
    (tests/test_eges.py's link-prediction set), with side info."""
    rng = np.random.default_rng(1)
    qs, ps, ns = [], [], []
    for _ in range(n):
        pool = np.where(comm == rng.integers(0, comm.max() + 1))[0]
        pool = pool[pool > 0]
        if len(pool) < 2:
            continue
        a, b = rng.choice(pool, 2, replace=False)
        qs.append(a)
        ps.append(b)
        ns.append(rng.integers(1, num_nodes))
    out = {"query": np.array(qs, np.int32), "pos": np.array(ps, np.int32),
           "neg": np.array(ns, np.int32)}
    for role in ("query", "pos", "neg"):
        for name, arr in side.items():
            out[f"{role}_{name}"] = arr[out[role]]
    return out


def phase_eges_cli() -> int:
    """``cli.train_eges.main`` on the card (its synthetic community graph):
    BGE, GES, EGES, and EGES with ``--shared_lr_scale 0.5``, each scored by
    link prediction on intra-community pairs."""
    g, side, comm = train_eges._synthetic_graph(seed=SEED)
    triples = _community_triples(comm, side, g.num_nodes)
    ids_only = {k: triples[k] for k in ("query", "pos", "neg")}
    runs, launches = {}, 0
    for name, flags in EGES_CLI_RUNS.items():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, lines = _cli_run([*EGES_CLI_ARGS, "--model_type", *flags,
                                 "--steps", str(EGES_CLI_STEPS)], train_eges.main)
        torch.cuda.synchronize()
        n = ek.sorted_scatter_add.launches
        launches += n
        auc = link_prediction_auc(state.model, ids_only if flags[0] == "BGE" else triples)
        runs[name] = dict(losses=[m["loss"] for m in lines], link_prediction_auc=auc,
                          k1_launches=n, seconds=time.perf_counter() - t0,
                          lr_scales=state.optimizer.scales is not None,
                          device=str(next(state.model.parameters()).device))
        check(runs[name]["device"].startswith("cuda"), f"{name}: the CLI did not run on the card")
        check(n == EGES_CLI_K1_PER_STEP[flags[0]] * EGES_CLI_STEPS,
              f"{name}: K1 launched {n} times")
        check(auc > 0.5 + EGES_CLI_AUC_MARGIN[name],
              f"{name} link_prediction_auc {auc} <= 0.5 + {EGES_CLI_AUC_MARGIN[name]}")
        check(runs[name]["lr_scales"] == ("--shared_lr_scale" in flags),
              f"{name}: lr_scales {runs[name]['lr_scales']}")
    emit("eges_cli", args=list(EGES_CLI_ARGS), steps=EGES_CLI_STEPS, triples=len(ids_only["query"]),
         runs=runs, auc_margins=EGES_CLI_AUC_MARGIN)
    return launches


def phase_eges_export(device) -> int:
    """``cli.train_eges --export --export_int8`` on the card: EGES, every
    node's ``get_hidden`` as an int8 bundle, served once by ``cli.serve``."""
    root = _build.BUILD_DIR / "eges_export"
    shutil.rmtree(root, ignore_errors=True)
    bundle = root / "eges_int8.npz"
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, lines = _cli_run([*EGES_CLI_ARGS, "--model_type", "EGES", "--steps",
                             str(EGES_CLI_STEPS), "--export", str(bundle), "--export_int8"],
                            train_eges.main)
    torch.cuda.synchronize()
    launches = ek.sorted_scatter_add.launches
    seconds = time.perf_counter() - t0
    b = load_serving_bundle(str(bundle))
    g, side, _ = train_eges._synthetic_graph(seed=SEED)
    with torch.no_grad():
        hidden = state.model.get_hidden({k: torch.as_tensor(v, device=device) for k, v in {
            "target": np.arange(g.num_nodes), "target_cat": side["cat"],
            "target_brand": side["brand"]}.items()}).cpu().numpy()
    q, scale = quantize_reprs(hidden)
    recs, served = _cli_run(["--bundle", str(bundle), "--items", "1,2,3"], serve.main)
    emit("eges_export", steps=EGES_CLI_STEPS, k1_launches=launches, seconds=seconds,
         bundle_keys=sorted(b), corpus=list(b["item_reprs_int8"].shape), served=served,
         int8_rows_equal_the_model=bool(np.array_equal(b["item_reprs_int8"], q)))
    shutil.rmtree(root, ignore_errors=True)
    check(lines[-1] == {"exported": str(bundle)}, "EGES export line")
    check(launches == EGES_CLI_K1_PER_STEP["EGES"] * EGES_CLI_STEPS,
          f"EGES export run launched K1 {launches} times")
    check(np.array_equal(b["item_reprs_int8"], q) and np.array_equal(b["item_scale"], scale),
          "the int8 bundle is not the trained model's corpus")
    check(recs.shape == (3, 10) and all(i not in r for i, r in zip((1, 2, 3), recs.tolist())),
          f"cli.serve on the EGES bundle: {recs.tolist()}")
    return launches


# ------------------------------------------------------------ retrieval
def pinsage_graph() -> tuple:
    """bench_pinsage's graph and item features, draw for draw."""
    rng = np.random.default_rng(SEED)
    us = rng.integers(0, PS_USERS, PS_EDGES)
    its = rng.integers(0, PS_ITEMS, PS_EDGES)
    g = BipartiteGraph(us, its, PS_USERS, PS_ITEMS)
    feats = ItemFeatures(year=rng.integers(0, PS_YEARS, PS_ITEMS).astype(np.int32),
                         genre=(rng.random((PS_ITEMS, PS_GENRES)) < 0.2).astype(np.float32))
    return g, feats


def twotower_interactions() -> tuple:
    """quality_runs.py::run_twotower's interactions, draw for draw: per
    user, ``TT_PER_USER`` items, each from the user's community's block
    with probability 0.85, else uniform."""
    rng = np.random.default_rng(SEED)
    u_comm = rng.integers(0, TT_COMMS, TT_USERS)
    blocks = np.array_split(np.arange(TT_ITEMS), TT_COMMS)
    us, its = [], []
    for u in range(TT_USERS):
        pool = blocks[u_comm[u]]
        for _ in range(TT_PER_USER):
            it = int(rng.choice(pool)) if rng.random() < TT_IN_COMM else int(rng.integers(TT_ITEMS))
            us.append(u)
            its.append(it)
    return np.asarray(us), np.asarray(its)


def write_movielens(root, us: np.ndarray, its: np.ndarray):
    """The interactions as MovieLens-1M files: ratings.dat in draw order
    (the timestamp is the draw's index, so a user's last draw is the
    held-out test item) and movies.dat (one title with a year, one genre)."""
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "ratings.dat", "w", encoding="latin-1") as f:
        f.writelines(f"{u + 1}::{i + 1}::5::{t}\n" for t, (u, i) in enumerate(zip(us, its)))
    with open(root / "movies.dat", "w", encoding="latin-1") as f:
        f.writelines(f"{m + 1}::Movie {m + 1} ({1919 + m % 81})::Drama\n"
                     for m in range(TT_ITEMS))


def phase_pinsage_train(device, graph: tuple) -> int:
    """PinSage at bench_pinsage width: b512 on one resident batch (a sync
    at the end), then b512 with the sampler in prefetch threads and b32
    with it in ``Trainer.fit``'s own (a sync at every step); the sampler
    alone."""
    g, feats = graph
    check(native.is_available() and g.native, "the native graph sampler did not load")
    out, launches = {}, 0

    def make(batch):
        model = init_model(PinSage(feats, device=device), seed=SEED)
        trainer = Trainer(make_pinsage_task(model), TrainConfig(
            learning_rate=LR, log_every=1, eval_every=0, seed=SEED), device=device)
        it = pinsage_train_batches(g, batch, seed=SEED)
        example = next(it)  # the init example, as cli.train_pinsage takes it
        return trainer, trainer.init_state(lambda: model), it, example

    # b512 on one resident batch: the device step alone (bench's devicestep)
    trainer, state, _, example = make(PS_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    resident = trainer.put_batch(example)
    state, m = trainer.train_step(state, resident)
    float(m["loss"])
    t0 = time.perf_counter()
    device_losses = []
    for _ in range(PS_DEVICE_STEPS):
        state, m = trainer.train_step(state, resident)
        device_losses.append(m["loss"])
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) / PS_DEVICE_STEPS * 1e3
    device_losses = [float(x) for x in device_losses]
    resident_launches = ek.sorted_scatter_add.launches
    check(resident_launches == PS_K1_PER_STEP * (1 + PS_DEVICE_STEPS),
          f"PinSage resident steps launched K1 {resident_launches} times")
    check(all(math.isfinite(x) for x in device_losses), "non-finite PinSage loss")
    check(device_losses[-1] < device_losses[0],
          f"PinSage loss on one batch did not fall: {device_losses}")
    out["b512_devicestep"] = dict(steps=PS_DEVICE_STEPS, ms_per_step=device_ms,
                                  examples_per_s=PS_BATCH / device_ms * 1e3,
                                  losses=device_losses, k1_launches=resident_launches)
    launches += resident_launches

    for name, batch, workers in (("b512_endtoend", PS_BATCH, PS_SAMPLER_WORKERS),
                                 ("b32_endtoend", PS_REF_BATCH, 1)):
        if name.startswith("b32"):
            trainer, state, it, _ = make(batch)
        stamps, losses = [], []

        def log_fn(m):
            stamps.append(time.perf_counter())
            losses.append(m["loss"])

        if workers > 1:  # iid sampler streams, one thread each (bench_pinsage's)
            stream = prefetch_to_device(
                workers=[pinsage_train_batches(g, batch, seed=s) for s in range(1, 1 + workers)],
                size=4)
            prefetch = 0
        else:
            stream, prefetch = it, 2
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            with host_times() as host:
                state, _ = trainer.fit(state, stream, PS_STEPS, log_fn=log_fn, prefetch=prefetch)
        finally:
            if workers > 1:
                stream.close()
        torch.cuda.synchronize()
        n = ek.sorted_scatter_add.launches
        step_ms = (np.diff(np.array(stamps)) * 1e3)[-TIMED_STEPS:]
        med = float(np.median(step_ms))
        sampler = pinsage_train_batches(g, batch, seed=SEED + 7)
        next(sampler)
        t0 = time.perf_counter()
        for _ in range(PS_SAMPLER_BATCHES):
            next(sampler)
        sampler_ms = (time.perf_counter() - t0) / PS_SAMPLER_BATCHES * 1e3
        out[name] = dict(steps=PS_STEPS, sampler_threads=workers, losses=losses,
                         ms_per_step_median=med, ms_per_step_min=float(step_ms.min()),
                         ms_per_step_max=float(step_ms.max()),
                         examples_per_s=batch / med * 1e3,
                         host_enqueue_ms_median=float(np.median(host["enqueue"][-TIMED_STEPS:])),
                         host_put_ms_median=float(np.median(host["put"][-TIMED_STEPS:])),
                         sampler_ms_per_batch=sampler_ms,
                         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
                         k1_launches=n)
        check(len(losses) == PS_STEPS and all(math.isfinite(x) for x in losses),
              f"PinSage {name} losses: {losses}")
        check(n == PS_K1_PER_STEP * PS_STEPS, f"PinSage {name} launched K1 {n} times")
        launches += n
    emit("pinsage_train", users=PS_USERS, items=PS_ITEMS, edges=PS_EDGES, years=PS_YEARS,
         genres=PS_GENRES, embed=8, conv=(64, 32), neighbours=3, walks=4, walk_length=2,
         native_sampler=g.native, k1_per_step=PS_K1_PER_STEP, runs=out)
    return launches


def _overlap(a: np.ndarray, b: np.ndarray) -> float:
    k = a.shape[1]
    return float(np.mean([len(set(x.tolist()) & set(y.tolist())) / k for x, y in zip(a, b)]))


def _same_up_to_ties(got: np.ndarray, want: np.ndarray, scores: np.ndarray) -> int:
    """Rows where ``got`` and ``want`` differ other than by ids of equal
    score (``scores`` [Q, V])."""
    bad = 0
    for row, a, b in zip(scores, got, want):
        if not np.array_equal(a, b) and not np.array_equal(row[a], row[b]):
            bad += 1
    return bad


def _int8_item_scores(bundle: dict, ids: np.ndarray) -> np.ndarray:
    q = torch.from_numpy(bundle["item_reprs_int8"])
    scale = torch.from_numpy(bundle["item_scale"])
    return rq.scores_int8(q[torch.from_numpy(ids)], q, scale).numpy()


def phase_pinsage_cli() -> int:
    """``cli.train_pinsage.main`` on the card (its synthetic set): the f32,
    int8 and int8 + IVF exports, each served by ``cli.serve.main``
    (``--items``, ``--all --out``, ``--probes``); community similarity
    and hit-rate guards; 150 steps + ``--resume`` 150 against the straight
    run, bit for bit."""
    root = _build.BUILD_DIR / "pinsage_cli"
    shutil.rmtree(root, ignore_errors=True)
    runs, served, launches = {}, {}, 0
    states = {}
    for name, flags in (("f32", ()), ("int8", ("--export_int8",)),
                        ("ivf", ("--export_int8", "--export_ivf_clusters",
                                 str(PS_CLI_IVF_CLUSTERS)))):
        bundle = root / f"{name}.npz"
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, lines = _cli_run([*PS_CLI_ARGS, "--steps", str(PS_CLI_STEPS), "--export",
                                 str(bundle), *flags], train_pinsage.main)
        torch.cuda.synchronize()
        n = ek.sorted_scatter_add.launches
        launches += n
        states[name] = state
        final = next(m for m in lines if m.get("final"))
        runs[name] = dict(losses=[m["loss"] for m in lines if "loss" in m],
                          hit_rate=final["hit_rate"], k1_launches=n,
                          seconds=time.perf_counter() - t0,
                          device=str(next(state.model.parameters()).device))
        check(runs[name]["device"].startswith("cuda"), f"{name}: the CLI did not run on the card")
        check(n == PS_K1_PER_STEP * PS_CLI_STEPS, f"pinsage_cli {name}: K1 launched {n} times")
        check(lines[-1] == {"exported": str(bundle)}, f"pinsage_cli {name}: no export line")
        check(final["hit_rate"] > 0.05 + PS_CLI_HIT_MARGIN,
              f"pinsage_cli {name}: hit_rate {final['hit_rate']} <= 0.05 + {PS_CLI_HIT_MARGIN}")
        recs, items = _cli_run(["--bundle", str(bundle), "--items", "0,1,2"], serve.main)
        every, done = _cli_run(["--bundle", str(bundle), "--all", "--out",
                                str(root / f"{name}_recs.npz")], serve.main)
        saved = np.load(root / f"{name}_recs.npz")["recommendations"]
        check(recs.shape == (3, 10) and every.shape == (200, 10), f"{name}: served shapes")
        check(np.array_equal(saved, every) and np.array_equal(every[:3], recs),
              f"{name}: --all --out and --items disagree")
        check(not (every == np.arange(200)[:, None]).any(), f"{name}: an item recommends itself")
        served[name] = dict(items=items, all=done, recs=every)
    f32 = load_serving_bundle(str(root / "f32.npz"))
    int8 = load_serving_bundle(str(root / "int8.npz"))
    reprs = f32["item_reprs"]
    comm = np.repeat(np.arange(PS_CLI_COMMUNITIES), 200 // PS_CLI_COMMUNITIES)
    sims = reprs @ reprs.T
    intra = float(sims[comm[:, None] == comm[None, :]].mean())
    inter = float(sims[comm[:, None] != comm[None, :]].mean())
    q, scale = quantize_reprs(reprs)
    same_corpus = bool(np.array_equal(int8["item_reprs_int8"], q)
                       and np.array_equal(int8["item_scale"], scale))
    overlap = _overlap(served["int8"]["recs"], served["f32"]["recs"])
    top1 = float(np.mean(served["int8"]["recs"][:, 0] == served["f32"]["recs"][:, 0]))
    ivf_bundle = root / "ivf.npz"
    ivf_recs, ivf_lines = _cli_run(["--bundle", str(ivf_bundle), "--all", "--probes",
                                    str(PS_CLI_IVF_CLUSTERS)], serve.main)
    ivf_b = load_serving_bundle(str(ivf_bundle))
    ivf_rows_apart = _same_up_to_ties(ivf_recs, served["ivf"]["recs"],
                                      _int8_item_scores(ivf_b, np.arange(200)))
    ivf_rows_differing = int((ivf_recs != served["ivf"]["recs"]).any(1).sum())
    # resume: half the steps, then --resume for the rest, against the f32 run
    ckpt = ["--checkpoint_dir", str(root / "ckpt")]
    half = PS_CLI_STEPS // 2
    reset_counts()
    _cli_run([*PS_CLI_ARGS, "--steps", str(half), *ckpt], train_pinsage.main)
    resumed, _ = _cli_run([*PS_CLI_ARGS, "--steps", str(PS_CLI_STEPS - half), "--resume", *ckpt],
                          train_pinsage.main)
    torch.cuda.synchronize()
    resume_launches = ek.sorted_scatter_add.launches
    launches += resume_launches
    want, got = states["f32"].model.state_dict(), resumed.model.state_dict()
    differing = [k for k in want if not torch.equal(want[k], got[k])]
    moments = states["f32"].optimizer.state_dict(), resumed.optimizer.state_dict()
    differing += [f"{w}[{i}]" for w in ("mu", "nu")
                  for i, (a, b) in enumerate(zip(moments[0][w], moments[1][w]))
                  if not torch.equal(a, b)]
    emit("pinsage_cli", args=list(PS_CLI_ARGS), steps=PS_CLI_STEPS, runs=runs,
         hit_margin=PS_CLI_HIT_MARGIN, intra_community_sim=intra, inter_community_sim=inter,
         int8_bundle_is_the_f32_corpus=same_corpus, int8_f32_top10_overlap=overlap,
         int8_f32_top1_agree=top1, ivf_full_probes_rows_differing=ivf_rows_differing,
         ivf_full_probes_rows_apart_beyond_ties=ivf_rows_apart, ivf_serve_lines=ivf_lines,
         served={k: {"items": v["items"], "all": v["all"]} for k, v in served.items()},
         resume_k1_launches=resume_launches, resumed_step=resumed.step,
         tensors_differing_after_resume=differing)
    shutil.rmtree(root, ignore_errors=True)
    check(intra > inter, f"PinSage reprs: intra-community {intra} <= inter {inter}")
    check(same_corpus, "the int8 run trained another corpus than the f32 run")
    check(overlap >= INT8_OVERLAP_MIN, f"int8 vs f32 top-10 overlap {overlap}")
    check(top1 >= INT8_TOP1_MIN, f"int8 vs f32 top-1 agreement {top1}")
    check(ivf_rows_apart == 0, f"IVF at full probes differs from int8 brute force in "
                               f"{ivf_rows_apart} rows beyond ties")
    check(resume_launches == PS_K1_PER_STEP * PS_CLI_STEPS,
          f"pinsage_cli resume runs launched K1 {resume_launches} times")
    check(resumed.step == PS_CLI_STEPS and not differing,
          f"resumed PinSage differs from the straight run in {differing}")
    return launches


def phase_twotower_cli(device) -> int:
    """``cli.train_twotower.main --data_dir`` on the card at the RESULTS
    protocol's width (MovieLens files written from its interactions),
    exported int8 and served once; then tests/test_two_tower.py's set-up
    through the Trainer, against its hit-rate floor."""
    root = _build.BUILD_DIR / "twotower_cli"
    shutil.rmtree(root, ignore_errors=True)
    write_movielens(root / "data", *twotower_interactions())
    bundle = root / "tt_int8.npz"
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, lines = _cli_run(["--data_dir", str(root / "data"), *TT_CLI_ARGS, "--steps",
                             str(TT_CLI_STEPS), "--export", str(bundle), "--export_int8"],
                            train_twotower.main)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    cli_launches = ek.sorted_scatter_add.launches
    final = next(m for m in lines if m.get("final"))
    b = load_serving_bundle(str(bundle))
    recs, served = _cli_run(["--bundle", str(bundle), "--items", "0,1,2,3"], serve.main)
    check(next(state.model.parameters()).device.type == "cuda", "two-tower CLI not on the card")
    check(cli_launches == TT_K1_PER_STEP * TT_CLI_STEPS,
          f"two-tower CLI launched K1 {cli_launches} times")
    check(final["hit_rate"] > TT_CLI_HIT_MIN,
          f"two-tower CLI hit rate {final['hit_rate']} <= {TT_CLI_HIT_MIN}")
    check(b["item_reprs_int8"].shape == (TT_ITEMS, 32) and recs.shape == (4, 10),
          "two-tower bundle or serving shapes")
    # tests/test_two_tower.py's learning set-up, through the Trainer
    g, test_item, seen = train_twotower._synthetic(seed=SEED)
    model = init_model(TwoTower(user_vocab=g.num_users, item_vocab=g.num_items, embed_dim=16,
                                repr_dim=16, tower_units=(32,), device=device), seed=SEED)
    loss_fn, eval_fn = make_two_tower_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=3e-3, log_every=100, seed=SEED),
                      eval_fn, device=device)
    it = interaction_batches(g, 256, seed=SEED)
    next(it)
    reset_counts()
    t1 = time.perf_counter()
    test_state, hist = trainer.fit(trainer.init_state(lambda: model), it, TT_TEST_STEPS)
    test_launches = ek.sorted_scatter_add.launches
    reprs = corpus_item_reprs(model, g.num_items)
    test_recs = recommend_topk_from_queries(train_twotower.user_reprs(model, g.num_users), reprs,
                                            seen, k=10, device=device)
    test_hr = hit_rate(test_recs, ground_truth_matrix(test_item, g.num_items))
    emit("twotower_cli", users=TT_USERS, items=TT_ITEMS, communities=TT_COMMS,
         args=list(TT_CLI_ARGS), steps=TT_CLI_STEPS, log=[m for m in lines if "loss" in m],
         hit_rate=final["hit_rate"], seconds=seconds, k1_launches=cli_launches, served=served,
         test_setup=dict(steps=TT_TEST_STEPS, losses=[h["loss"] for h in hist],
                         hit_rate=test_hr, floor=TT_TEST_HIT_MIN, k1_launches=test_launches,
                         seconds=time.perf_counter() - t1))
    shutil.rmtree(root, ignore_errors=True)
    check(test_launches == TT_K1_PER_STEP * TT_TEST_STEPS,
          f"two-tower test set-up launched K1 {test_launches} times")
    check(test_hr > TT_TEST_HIT_MIN, f"two-tower hit rate {test_hr} <= {TT_TEST_HIT_MIN}")
    check(not any(seen[u][test_recs[u]].any() for u in range(g.num_users)),
          "two-tower recommended a seen item")
    return cli_launches + test_launches


def quantize_on_card(r: torch.Tensor) -> tuple:
    """``quantize_reprs`` on the card (the same formula), for a corpus that
    never leaves it."""
    amax = torch.amax(torch.abs(r), dim=1)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds some quotients apart from numpy's
    scale = amax / amax.new_tensor(127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(r / safe[:, None]), -127, 127).to(torch.int8)
    q[scale == 0] = 0
    return q, scale


def _percentiles(ms: list) -> dict:
    a = np.asarray(ms)
    return {"p50_ms": float(np.percentile(a, 50)), "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean())}


def phase_serve_corpus(device) -> dict:
    """``serve_topk`` at the TPU probes' width: an in-memory f32 and int8
    bundle of a 2M x 128 clustered corpus on the card, by query batch;
    then IVF at exp_ivf.py --quick width."""
    g = torch.Generator(device=device).manual_seed(SEED)
    centres = torch.randn((SERVE_CENTRES, SERVE_D), generator=g, device=device) * 3
    assign = torch.randint(0, SERVE_CENTRES, (SERVE_V,), generator=g, device=device)
    corpus = centres[assign] + torch.randn((SERVE_V, SERVE_D), generator=g, device=device)
    del centres, assign
    q8, scale = quantize_on_card(corpus)
    head = corpus[:20_000].cpu().numpy()
    want_q, want_scale = quantize_reprs(head)
    check(np.array_equal(q8[:20_000].cpu().numpy(), want_q)
          and np.array_equal(scale[:20_000].cpu().numpy(), want_scale),
          "the card's quantization differs from quantize_reprs")
    bundles = {"f32": {"item_reprs": corpus}, "int8": {"item_reprs_int8": q8, "item_scale": scale}}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    rng = np.random.default_rng(SEED)
    cases = {}
    for Q in SERVE_QS:
        pools = [rng.integers(0, SERVE_V, Q) for _ in range(SERVE_POOLS)]
        outs = {}
        for kind, bundle in bundles.items():
            for i in range(3):
                serve_topk(bundle, pools[i], SERVE_K)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, last = [], {}
            for i in range(SERVE_REQUESTS):
                t0 = time.perf_counter()
                ids = serve_topk(bundle, pools[i % SERVE_POOLS], SERVE_K)
                ms.append((time.perf_counter() - t0) * 1e3)
                last[i % SERVE_POOLS] = ids
            peak = torch.cuda.max_memory_allocated()
            corpus_bytes = sum(t.numel() * t.element_size() for t in bundle.values())
            ops = 2.0 * Q * SERVE_V * SERVE_D
            rate = F32_FLOPS if kind == "f32" else INT8_OPS
            n_bytes = corpus_bytes + Q * (SERVE_D * 4 + SERVE_K * 4)
            bound_ms = max(n_bytes / HBM_BYTES_PER_S, ops / rate) * 1e3
            p = _percentiles(ms)
            outs[kind] = last
            cases[f"{kind}_q{Q}"] = dict(
                **p, requests=SERVE_REQUESTS, requests_per_s_at_p50=1e3 / p["p50_ms"],
                queries_per_s_at_p50=Q * 1e3 / p["p50_ms"], bound_ms=bound_ms,
                bound_by="bytes" if n_bytes / HBM_BYTES_PER_S >= ops / rate else "operations",
                peak_memory_gib=peak / 2**30, above_resident_gib=(peak - resident) / 2**30,
                corpus_gib=corpus_bytes / 2**30)
            check(all(o.shape == (Q, SERVE_K) for o in last.values()), f"{kind} Q{Q} shapes")
            check(all(not (o == p_[:, None]).any() for o, p_ in zip(
                (last[i] for i in range(SERVE_POOLS)), pools)), f"{kind} Q{Q}: self retrieved")
        cases[f"int8_q{Q}"]["int8_f32_top10_overlap"] = float(np.mean(
            [_overlap(outs["int8"][i], outs["f32"][i]) for i in range(SERVE_POOLS)]))
    # where a request's time goes at the largest Q: one block of rows, its
    # product (int8: with the int32 → f32 scaling) and its top-k alone
    Q = SERVE_QS[-1]
    rows = rq.block_rows(Q, SERVE_V)
    ids = torch.from_numpy(rng.integers(0, SERVE_V, Q)).to(device)
    qf, qq = corpus[ids], q8[ids]
    block_scores = qf @ corpus[:rows].T
    breakdown = dict(
        Q=Q, block_rows=rows, blocks=-(-SERVE_V // rows),
        f32_product_ms=cuda_ms(lambda: qf @ corpus[:rows].T, iters=10),
        int8_product_ms=cuda_ms(lambda: rq.scores_int8(qq, q8[:rows], scale[:rows]), iters=10),
        topk_ms=cuda_ms(lambda: torch.topk(block_scores, SERVE_K + 1, dim=1), iters=10))
    del block_scores
    # the plain reference on one pool of 16 queries: the whole [Q, V] product
    ids = torch.from_numpy(rng.integers(0, SERVE_V, 16)).to(device)
    rows = torch.arange(16, device=device)
    plain = {}
    sim = corpus[ids] @ corpus.T
    sim[rows, ids] = float("-inf")
    plain["f32"] = torch.topk(sim, SERVE_K, dim=1).indices.cpu().numpy()
    sim = (q8[ids].float() @ q8.float().T) * scale[None, :]
    sim[rows, ids] = float("-inf")
    plain["int8"] = torch.topk(sim, SERVE_K, dim=1).indices.cpu().numpy()
    del sim
    agree = {k: bool(np.array_equal(serve_topk(bundles[k], ids.cpu().numpy(), SERVE_K), v))
             for k, v in plain.items()}
    del bundles, corpus, q8, scale
    torch.cuda.empty_cache()

    # IVF at exp_ivf.py --quick width (numpy data from seed 0, as there)
    rng = np.random.default_rng(SEED)
    centres = (rng.normal(size=(IVF_TRUE_C, SERVE_D)) * 2.0).astype(np.float32)
    reprs = (centres[rng.integers(0, IVF_TRUE_C, IVF_V)]
             + rng.normal(size=(IVF_V, SERVE_D)).astype(np.float32) * 0.5).astype(np.float32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_ivf(reprs, IVF_CLUSTERS, capacity_factor=1.5, iters=IVF_ITERS, seed=1,
                      device=device)
    build_s = time.perf_counter() - t0
    spilled = int((index.spill_ids >= 0).sum())
    on_card = index.to(device)
    q8i, sci = (torch.from_numpy(x).to(device) for x in quantize_reprs(reprs))
    queries = torch.from_numpy(reprs[rng.integers(0, IVF_V, IVF_Q)]
                               + rng.normal(size=(IVF_Q, SERVE_D)).astype(np.float32) * 0.1
                               ).to(device)
    qq = rq.quantize_queries(queries)

    def brute():
        return rq.topk_ids(lambda a, b: rq.scores_int8(qq, q8i[a:b], sci[a:b]), IVF_V, IVF_Q,
                           SERVE_K)

    brute_ids = brute().cpu().numpy()
    ivf = dict(V=IVF_V, clusters=IVF_CLUSTERS, iters=IVF_ITERS, build_s=build_s, cap=index.cap,
               spilled=spilled, spill_share=spilled / IVF_V,
               index_mib=index.nbytes() / 2**20, queries=IVF_Q,
               brute_int8_ms=cuda_ms(brute, iters=10, warmup=2))
    for probes in IVF_PROBES:
        got = search_ivf(on_card, queries, k=SERVE_K, probes=probes)[0].cpu().numpy()
        ivf[f"probes_{probes}"] = dict(
            recall_vs_int8_brute=_overlap(got, brute_ids),
            ms=cuda_ms(lambda: search_ivf(on_card, queries, k=SERVE_K, probes=probes),
                       iters=10, warmup=2),
            candidates=probes * index.cap + len(index.spill_ids))
    emit("serve_corpus", V=SERVE_V, D=SERVE_D, centres=SERVE_CENTRES, k=SERVE_K,
         resident_gib=resident / 2**30, cases=cases, breakdown=breakdown, plain_agrees=agree,
         ivf=ivf)
    check(all(agree.values()), f"serve_topk disagrees with the plain top-k: {agree}")
    check(ivf[f"probes_{IVF_PROBES[-1]}"]["recall_vs_int8_brute"]
          >= ivf[f"probes_{IVF_PROBES[0]}"]["recall_vs_int8_brute"] - 0.02,
          "IVF recall fell with more probes")
    return cases


def phase_retrieval_card_cpu(device):
    """A small PinSage and a small two-tower, 3 steps each from one init on
    the card and on the CPU, then served: the largest differences."""
    g, feats, _, _, _ = train_pinsage._synthetic(SEED)
    it = pinsage_train_batches(g, 32, seed=SEED)
    ps_batches = [next(it) for _ in range(3)]
    tg, _, _ = train_twotower._synthetic(SEED)
    it = interaction_batches(tg, 128, seed=SEED)
    tt_batches = [next(it) for _ in range(3)]
    out = {}
    for name, make, task, batches, tol in (
        ("pinsage", lambda d: PinSage(feats, embed_dim=8, conv_hidden=16, conv_out=16, device=d),
         lambda m: (make_pinsage_task(m), None), ps_batches, PS_CARD_CPU_LOSS_TOL),
        ("two_tower", lambda d: TwoTower(tg.num_users, tg.num_items, embed_dim=16, repr_dim=16,
                                         device=d),
         make_two_tower_task, tt_batches, CARD_CPU_LOSS_TOL),
    ):
        init = init_model(make(torch.device("cpu")), seed=SEED).state_dict()
        result = {}
        for where in ("card", "cpu"):
            dev = device if where == "card" else torch.device("cpu")
            model = make(dev)
            model.load_state_dict(init)
            losses = _small_fit_losses(lambda d, m=model: m, model.state_dict(), task, batches,
                                       dev)
            if name == "pinsage":
                reprs = full_corpus_reprs(model, g, np.random.default_rng(1), batch_size=64)
            else:
                reprs = corpus_item_reprs(model, tg.num_items)
            q, sc = quantize_reprs(reprs)
            bundle = {"item_reprs_int8": torch.from_numpy(q).to(dev),
                      "item_scale": torch.from_numpy(sc).to(dev)}
            result[where] = dict(losses=losses, reprs=reprs,
                                 recs=serve_topk(bundle, np.arange(len(reprs)), 10))
        loss_diff = max(abs(a - b) for a, b in zip(result["card"]["losses"],
                                                   result["cpu"]["losses"]))
        repr_diff = float(np.abs(result["card"]["reprs"] - result["cpu"]["reprs"]).max())
        overlap = _overlap(result["card"]["recs"], result["cpu"]["recs"])
        out[name] = dict(card_losses=result["card"]["losses"], cpu_losses=result["cpu"]["losses"],
                         max_abs_loss_diff=loss_diff, max_abs_repr_diff=repr_diff,
                         served_top10_overlap=overlap, loss_tolerance=tol)
        check(loss_diff <= tol, f"{name} card vs CPU losses differ by {loss_diff}")
    emit("retrieval_card_cpu", **out)


# kernel-name fragments for the profile's parts, matched in this order
PROFILE_PARTS = (
    ("k2_fwd", ("flash_fwd_",)),
    ("k2_bwd", ("flash_bwd_",)),
    ("k1", ("chunk_sum_kernel", "join_kernel")),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "sm90_", "sm80_")),
    ("copies", ("memcpy", "Memcpy", "memset", "Memset")),
)


def _step_times(model, task, batches, device) -> tuple:
    """Synced step time (``float(loss)`` each step, median of the last 10 of
    20), then the unsynced step time and the host's enqueue time over 20
    steps with no log point; returns them and a quiet trainer and state to
    profile with."""
    loss_fn, eval_fn = task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=1, eval_every=0, seed=SEED),
                      eval_fn, device=device)
    state = trainer.init_state(lambda: model)
    stamps = []
    state, _ = trainer.fit(state, batches, 20, log_fn=lambda m: stamps.append(time.perf_counter()))
    synced = float(np.median(np.diff(stamps)[-10:]) * 1e3)
    quiet = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=10**9, eval_every=0, seed=SEED),
                    eval_fn, device=device)
    qstate = quiet.init_state(lambda: model)
    qstate, _ = quiet.fit(qstate, batches, 5)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qstate, _ = quiet.fit(qstate, batches, 20)
    enqueue = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    unsynced = (time.perf_counter() - t0) / 20 * 1e3
    return dict(synced_ms_per_step=synced, unsynced_ms_per_step=unsynced,
                host_enqueue_ms_per_step=enqueue), quiet, qstate


def _device_profile(trainer, state, batches, steps: int) -> dict:
    """``torch.profiler`` over ``steps`` steps: device time by part (kernel
    times summed by name), device busy time, span and idle share, and kernel
    launches per step."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = trainer.fit(state, batches, steps)
        torch.cuda.synchronize()
    # device activity only: kernels, copies and fills; not the GPU spans of
    # record_function annotations (Optimizer.step), which hold idle time
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    parts = {name: 0.0 for name, _ in PROFILE_PARTS}
    parts["other"] = 0.0
    by_name = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        part = next((n for n, frags in PROFILE_PARTS if any(f in e.name for f in frags)), "other")
        parts[part] += us
    first = min(e.time_range.start for e in kernels)
    last = max(e.time_range.end for e in kernels)
    busy = sum(parts.values()) / steps / 1e3
    span = (last - first) / steps / 1e3
    top = sorted(by_name.items(), key=lambda x: -x[1])[:12]
    return dict(steps=steps, device_busy_ms_per_step=busy, device_span_ms_per_step=span,
                device_idle_share=1.0 - busy / span, launches_per_step=len(kernels) / steps,
                parts_ms_per_step={n: t / steps / 1e3 for n, t in parts.items()},
                top_kernels_ms_per_step={n: t / steps / 1e3 for n, t in top})


def profile_bst(device, steps: int = 10) -> dict:
    """The BST step at bench_bst width with flash attention: synced and
    unsynced step times and the host's enqueue time, then the device
    profile over ``steps`` steps. Uses only the package's public entry
    points, so it profiles any tree of the port it is run in."""
    train, _ = bst_data()
    model = BST(item_vocab=BST_ITEMS, cat_vocab=BST_CATS, device=device)
    init_model(model, seed=SEED)
    _set_flash(model, True)
    batches = batch_iterator(train, BST_BATCH, seed=SEED, epochs=None)
    times, trainer, state = _step_times(model, make_ctr_task, batches, device)
    return dict(**times, **_device_profile(trainer, state, batches, steps))


def profile_mt_graph(device, steps: int = 10) -> dict:
    """The MMOE step at bench_mmoe_large width (per-table f32, per-table
    bf16 + SR, stacked f32) and the EGES step at bench_eges width: each
    one's step times first, then each one's device profile (profiling
    slows every later launch of the process)."""
    train, _ = multitask_data()
    g, side = eges_graph()
    runs = {
        "mmoe_per_table_f32": (_mt_model(MMOE, device), make_multitask_task,
                               batch_iterator(train, MT_BATCH, seed=SEED, epochs=None)),
        "mmoe_per_table_bf16_sr": (_mt_model(MMOE, device, torch.bfloat16), make_multitask_task,
                                   batch_iterator(train, MT_BATCH, seed=SEED, epochs=None)),
        "mmoe_stacked_f32": (_mt_model(MMOE, device, stack=True), make_multitask_task,
                             batch_iterator(train, MT_BATCH, seed=SEED, epochs=None)),
        "eges": (init_model(EGES(EGES_V, EGES_CATS, EGES_BRANDS, EGES_DIM, device=device),
                            seed=SEED), make_skipgram_task, eges_stream(g, side)),
    }
    timed = {name: _step_times(model, task, batches, device)
             for name, (model, task, batches) in runs.items()}
    return {name: dict(**times, **_device_profile(trainer, state, runs[name][2], steps))
            for name, (times, trainer, state) in timed.items()}


# DIEN's parts for the profile: a part is the submodules whose forward (and,
# through autograd's sequence numbers, backward) work it collects
DIEN_PARTS = {
    "embeddings": ("item_embedding", "cat_embedding"),
    "extract_gru": ("extract_gru",),
    "aux_net": ("auxiliary_net",),
    "attention": ("attention",),
    "evolve_augru": ("evolve",),
    "head": ("mlp",),
}


def _mark(name: str):
    """A zero-length profiler event: work that starts after it, on the
    forward thread, belongs to ``name`` until the next mark."""
    with torch.profiler.record_function(f"mark:{name}"):
        pass


def _install_marks(model, optimizer) -> list:
    """Hooks that mark where each part's forward begins and ends, and the
    optimizer step. Returns the hook handles."""
    handles = []
    for part, names in DIEN_PARTS.items():
        for name in names:
            module = getattr(model, name)
            handles.append(module.register_forward_pre_hook(
                lambda m, a, part=part: _mark(part)))
            handles.append(module.register_forward_hook(lambda m, a, o: _mark("glue")))
    handles.append(optimizer.register_step_pre_hook(lambda o, a, k: _mark("optimizer")))
    handles.append(optimizer.register_step_post_hook(lambda o, a, k: _mark("glue")))
    return handles


def _busy_by_part(events) -> tuple[dict, dict]:
    """Device time (us) and launches by part. A forward op belongs to the
    part whose mark came last before it; a backward node (an
    ``evaluate_function`` event of the autograd engine) to the part of the
    forward op with its sequence number; the optimizer's work to
    ``optimizer``; what neither rule places to ``other``."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    marks = sorted((e.time_range.start, e.name[len("mark:"):]) for e in cpu
                   if e.name.startswith("mark:"))
    starts = [t for t, _ in marks]

    def marked(e):
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        return marks[i][1] if i >= 0 else "other"

    def top(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
        return e

    is_backward = lambda e: e.name.startswith("autograd::engine::evaluate_function")  # noqa: E731
    seq_part = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not is_backward(top(e)) and not e.name.startswith("mark:"):
            seq_part.setdefault(e.sequence_nr, marked(e))
    us, launches = {}, {}
    for e in cpu:
        if not e.kernels:
            continue
        root = top(e)
        if is_backward(root):
            part = "bwd:" + seq_part.get(root.sequence_nr, "other")
        else:
            part = marked(e)
            part = part if part in ("optimizer", "other") else "fwd:" + part
        us[part] = us.get(part, 0.0) + sum(k.duration for k in e.kernels)
        launches[part] = launches.get(part, 0) + len(e.kernels)
    return us, launches


def profile_dien(device, steps: int = 5) -> dict:
    """The DIEN step at bench_dien width (f32 tables): synced step time
    (``float(loss)`` each step), unsynced step time and the host's enqueue
    time, then ``torch.profiler`` over ``steps`` steps: kernel launches per
    step, device busy time by part of the model and by kernel name."""
    train, _ = sequence_data()
    model = _sequence_model(DIEN, device)
    loss_fn, eval_fn = make_aux_loss_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=1, eval_every=0, seed=SEED),
                      eval_fn, device=device)
    state = trainer.init_state(lambda: model)
    batches = batch_iterator(train, BST_BATCH, seed=SEED, epochs=None)
    stamps = []
    state, _ = trainer.fit(state, batches, 20, log_fn=lambda m: stamps.append(time.perf_counter()))
    synced = float(np.median(np.diff(stamps)[-10:]) * 1e3)
    quiet = Trainer(loss_fn, TrainConfig(learning_rate=LR, log_every=10**9, eval_every=0, seed=SEED),
                    eval_fn, device=device)
    qstate = state  # the same model and optimizer, on from step 20
    qstate, _ = quiet.fit(qstate, batches, 3)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qstate, _ = quiet.fit(qstate, batches, 10)
    enqueue = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    unsynced = (time.perf_counter() - t0) / 10 * 1e3
    handles = _install_marks(model, qstate.optimizer)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _mark("glue")
        qstate, _ = quiet.fit(qstate, batches, steps)
        torch.cuda.synchronize()
    for h in handles:
        h.remove()
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    first = min(e.time_range.start for e in kernels)
    last = max(e.time_range.end for e in kernels)
    part_us, part_launches = _busy_by_part(events)
    top_kernels = sorted(by_name.items(), key=lambda x: -x[1])[:12]
    per_step = lambda d: {n: v / steps for n, v in sorted(d.items())}  # noqa: E731
    return dict(steps=steps, batch=BST_BATCH, history=BST_T,
                synced_ms_per_step=synced, unsynced_ms_per_step=unsynced,
                host_enqueue_ms_per_step=enqueue,
                device_busy_ms_per_step=busy_us / steps / 1e3,
                device_span_ms_per_step=(last - first) / steps / 1e3,
                device_idle_share=1.0 - busy_us / max(last - first, 1e-9),
                launches_per_step=len(kernels) / steps,
                parts_ms_per_step={n: v / 1e3 for n, v in per_step(part_us).items()},
                parts_launches_per_step=per_step(part_launches),
                parts_attributed_share=sum(part_us.values()) / max(busy_us, 1e-9),
                top_kernels_ms_per_step={n: t / steps / 1e3 for n, t in top_kernels})


# The forward's register limits (csrc/flash_attention.cu), each with its
# entry and the phase k2 shape of a main path that the limit governs
FWD_OCCUPANCY = (
    ("RTT_FWD_LONG_MIN_BLOCKS_NARROW", "fwd_long", "r5_dh9"),
    ("RTT_FWD_LONG_MIN_BLOCKS_WIDE", "fwd_long", "r5_dh64"),
)


def fwd_occupancy(device, rounds: int = 6) -> dict:
    """The forward as shipped against the same source built with each
    register limit at 1 (the compiler's own choice): each entry alone at the
    shape its limit governs, the two builds alternated over ``rounds``
    (CUDA events, median of 25 a round); both held to ``flash_mha_ref``."""
    variants = {"shipped": (), "min_blocks_1": tuple(f"-D{m}=1" for m, _, _ in FWD_OCCUPANCY)}
    with ThreadPoolExecutor(len(variants)) as pool:
        sos = dict(zip(variants, pool.map(lambda d: _build.build("flash_attention", d),
                                          variants.values())))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fns = {}
    for variant, so in sos.items():
        lib = ctypes.CDLL(str(so))
        for entry in {e for _, e, _ in FWD_OCCUPANCY}:
            fn = getattr(lib, f"rtt_flash_attention_{entry}")
            fn.argtypes, fn.restype = [vp] * 6 + [i32, i32, i32, i32, f32, vp], i32
            fns[variant, entry] = fn
    shapes = k2_shapes(device, bst_data()[0])
    out = {}
    for macro, entry, key in FWD_OCCUPANCY:
        case, valid, head_dim, _ = shapes[key]
        B, L = valid.shape
        g = torch.Generator(device=device).manual_seed(SEED)
        q, k, v = (torch.randn((B, L, 4, head_dim), generator=g, device=device) for _ in range(3))
        seg = valid.to(torch.int32)
        want = fa.flash_mha_ref(q, k, v, valid)
        dims = (B, L, 4, head_dim, 1.0 / head_dim ** 0.5)
        launches, errs, times = {}, {}, {variant: [] for variant in variants}
        outs = {}  # each build's o and lse, alive while it is timed
        for variant in variants:
            o, lse = outs[variant] = torch.empty_like(q), torch.empty((B, 4, L), device=device)
            ptrs = [t.data_ptr() for t in (q, k, v, seg, o, lse)]
            launches[variant] = functools.partial(
                fa._launch, entry, fns[variant, entry], device, *ptrs, *dims)
            launches[variant]()
            errs[variant] = float((o - want).abs().max()) / max(1.0, float(want.abs().max()))
            check(errs[variant] <= K2_FWD_REL_TOL, f"{variant} {entry} at {case}: off by {errs[variant]}")
        for r in range(rounds):
            for variant in (variants if r % 2 == 0 else reversed(list(variants))):
                times[variant].append(cuda_ms(launches[variant]))
        out[macro] = dict(entry=entry, case=case, shape=[B, L, 4, head_dim], max_rel_err=errs,
                          ms=times, median_ms={n: statistics.median(t) for n, t in times.items()})
    return out


# --------------------------------------------------------- distribution
# Multi-process phases. The card is one H100, and NCCL refuses two
# ranks on one device, so the two-rank phases run both ranks on cuda:0 over
# gloo, the port's one-card transport (core/distributed.py: gloo copies the
# CUDA tensors through host memory); the times they give are not NCCL's.
# NCCL runs at world size 1 (dist_nccl1). Each rank is a process of its own
# (multiprocessing, spawn), rendezvous over TCP on 127.0.0.1.
DIST_STEPS = 20
DIST_RANKS = 2
DIST_CKPT_STEPS = 10  # at mesh (1, 2), then resumed at (1, 1) for the rest
DIST_ARGS = (*CTR_ARGS, "--model_type", "DLRM", "--dedup_lookup", "off")
DIST_A2A_CAPACITY = 2.0  # lossless at model 2 (each owner's bucket holds every id)
DIST_SKEW_CAPACITY = 1.0  # the fair share: SyntheticCTR's Zipf ids overflow shard 0
# a2a against the single-process run: the same forward, and K1 sums each
# row's served cotangents (each sent by both ranks at half weight) in other
# positions, so f32 roundoff, which bf16 + SR can carry into later steps
DIST_A2A_LOSS_TOL = 1e-6
# (2, 1) against one process, from one init on the same global batches.
# The check of the average: the first step's loss and gradients against the
# same process's two half batches (each rank's rows, the same shapes, so
# the same kernels), their losses and gradients averaged in f32 as the
# Trainer averages two ranks': the loss within DIST_HALVES_LOSS_TOL, the
# dense gradients within DIST_HALVES_RTOL of each one's largest entry
# (equal bit for bit is expected), the table's, which K1 sums over both
# halves at once, within DIST_HALVES_RTOL (f32, as shipped's bf16 one
# within DIST_BF16_TABLE_RTOL: each half's rounded to bf16 is up to twice
# the average's largest entry, half a bf16 ulp each, and the average
# rounded once). DLRM as shipped (bf16 + SR table, bf16 MLPs) and with an
# f32 table and MLPs. Against the b8192 run (other GEMM shapes, so ReLU
# inputs near 0 take the other side and Adam's first step moves every
# parameter by +-lr on its gradient's sign) the first loss within
# DIST_DP_LOSS_TOL and the 20 within DIST_TRAJECTORY_TOL. The two-tower
# against one rank of 1,024: the first loss within DIST_TT_LOSS_TOL, its
# gradients within DIST_BF16_NOISE_FACTOR times the one-rank bf16 run's
# distance from its f32 run (plus DIST_HALVES_RTOL), as a share of the
# largest entry (two runs that round apart differ by about 1.4 times one
# run's rounding; a missing or partial average, by about the gradient
# itself), and the 20 losses within DIST_TRAJECTORY_TOL
DIST_DP_LOSS_TOL = 1e-5
DIST_HALVES_LOSS_TOL = 1e-6
DIST_HALVES_RTOL = 1e-5
DIST_BF16_TABLE_RTOL = 3 * 2.0 ** -8
DIST_BF16_NOISE_FACTOR = 3.0
DIST_TRAJECTORY_TOL = 2e-3
DIST_TT_STEPS = 20
DIST_TT_LOSS_TOL = 1e-6
DIST_WORKER_TIMEOUT = 600  # seconds, each spawned phase
TRANSPORT_CALLS = ("all_reduce", "all_to_all_single", "all_gather_into_tensor",
                   "reduce_scatter_tensor")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def step_records(instrumented: int):
    """Per ``Trainer.train_step`` while the block runs: the exact loss (a
    sync) and the host clock after it. The first ``instrumented`` steps
    also time the one-card transport's host time inside them, each
    collective from a ``synchronize`` before it (so that it holds no queued
    compute) to one after it; those syncs serialize the step, so the step
    time is read from the later, plain steps (``_step_summary``)."""
    from recommender_tpu_torch.core import distributed as dd

    rec = {"loss": [], "t": [], "transport_ms": [], "instrumented": instrumented}
    spent = [0.0]
    on = [False]
    real_calls = {n: getattr(dd, n) for n in TRANSPORT_CALLS}
    real_step = Trainer.train_step

    def timed(fn):
        def call(*args, **kw):
            if not on[0]:
                return fn(*args, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            return out
        return call

    def step(self, state, batch):
        before = spent[0]
        on[0] = len(rec["loss"]) < instrumented
        state, metrics = real_step(self, state, batch)
        rec["loss"].append(float(metrics["loss"]))
        on[0] = False
        rec["t"].append(time.perf_counter())
        rec["transport_ms"].append((spent[0] - before) * 1e3)
        if "a2a_overflow" in metrics:
            rec.setdefault("a2a_overflow", []).append(int(metrics["a2a_overflow"]))
        return state, metrics

    for n, fn in real_calls.items():
        setattr(dd, n, timed(fn))
    Trainer.train_step = step
    try:
        yield rec
    finally:
        Trainer.train_step = real_step
        for n, fn in real_calls.items():
            setattr(dd, n, fn)


def _tensor_sha(t: torch.Tensor) -> str:
    import hashlib

    t = t.detach().contiguous().cpu()
    bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return hashlib.sha256(bits.numpy().tobytes()).hexdigest()


def _param_shas(model, rows: tuple | None = None) -> dict:
    """sha256 of each parameter's bits; ``rows`` (lo, hi) cuts the table."""
    out = {}
    for name, p in model.named_parameters():
        out[name] = _tensor_sha(p[rows[0]:rows[1]] if rows and name == "embedding.embedding" else p)
    return out


def _step_summary(rec: dict) -> dict:
    """Step times (synced: each step ends in its loss's fetch) of the plain
    steps after the instrumented ones, and the transport's ms and share of
    the instrumented steps but the first."""
    k = rec["instrumented"]
    dt = np.diff(rec["t"]) * 1e3  # dt[i] is step i + 1
    plain, synced = dt[k - 1:], dt[:k - 1]
    transport = np.asarray(rec["transport_ms"][1:k])
    out = dict(ms_per_step_median=float(np.median(plain)), ms_per_step_min=float(plain.min()),
               ms_per_step_max=float(plain.max()), plain_steps=len(plain),
               instrumented_ms_per_step_median=float(np.median(synced)),
               transport_ms_per_step_median=float(np.median(transport)),
               transport_share_of_instrumented_step=float(np.median(transport)
                                                          / np.median(synced)))
    if "a2a_overflow" in rec:
        out["a2a_overflow"] = rec["a2a_overflow"]
    return out


def _dist_ctr(rank, world, address, backend, extra=(), steps=DIST_STEPS) -> dict:
    """``cli.train_ctr.main`` as one rank of a ``world``-rank job."""
    argv = [*DIST_ARGS, "--steps", str(steps), *extra, "--coordinator_address", address,
            "--num_processes", str(world), "--process_id", str(rank), "--dist_backend", backend]
    reset_counts()
    with step_records(steps // 2) as rec:
        state, lines = _cli_run(argv, train_ctr.main)
    torch.cuda.synchronize()
    table = state.model.embedding
    return dict(argv=argv, losses=rec["loss"], k1_launches=ek.sorted_scatter_add.launches,
                shard_shape=list(table.embedding.shape), row_offset=table.row_offset,
                lookup_mode=table.lookup_mode, sharded=table.sharded,
                backend=torch.distributed.get_backend(), shas=_param_shas(state.model),
                device=str(table.embedding.device), final=lines[-1] if lines else None,
                plan=[m for m in lines if "shard_plan" in m], **_step_summary(rec))


def _dist_skew(rank, world, address, backend) -> dict:
    """The a2a exchange at the fair-share capacity on one b8192 batch of
    Zipf ids, against the whole table on this card."""
    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh
    from recommender_tpu_torch.embedding import sharded

    device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(MeshSpec(1, world))
    g = torch.Generator(device=device).manual_seed(SEED)
    whole = torch.randn((VOCAB, DIM), generator=g, device=device).to(torch.bfloat16)
    shard = sharded.shard_table(whole, mesh)
    ids = SyntheticCTR(vocab_size=VOCAB, seed=SEED).sample(BATCH, seed=1)["cat_features"]
    fraction = sharded.a2a_overflow_fraction(ids, world, VOCAB, DIST_SKEW_CAPACITY)
    ids_t = torch.from_numpy(ids).to(device)
    out, dropped = sharded.all_to_all_lookup(shard, ids_t, mesh, DIST_SKEW_CAPACITY,
                                             return_overflow=True)
    want = whole[ids_t.long()]
    zero = (out == 0).all(dim=-1)
    t0 = time.perf_counter()
    for _ in range(5):
        sharded.all_to_all_lookup(shard, ids_t, mesh, DIST_SKEW_CAPACITY, return_overflow=True)
    torch.cuda.synchronize()
    return dict(ids=int(ids.size), fraction=fraction, dropped=int(dropped),
                dropped_rows=int(zero.sum()), dropped_rows_max_abs=float(out[zero].abs().max())
                if bool(zero.any()) else 0.0,
                served_equal=bool(torch.equal(out[~zero], want[~zero])),
                lookup_ms=(time.perf_counter() - t0) / 5 * 1e3)


def _dp_batches(steps: int):
    train = SyntheticCTR(vocab_size=VOCAB, seed=SEED).sample(steps * BATCH, seed=1)
    it = batch_iterator(train, BATCH, seed=SEED, epochs=None)
    return [next(it) for _ in range(steps)]


def _f32_mlps(model) -> None:
    """Every MLP of ``model`` computing in f32 instead of bf16."""
    for m in model.modules():
        if isinstance(m, MLP):
            m.compute_dtype = torch.float32


def _dp_losses(device, mesh=None, f32=False) -> dict:
    """``DIST_STEPS`` Trainer steps of the CTR entry point's DLRM on global
    b8192 batches, each rank taking its contiguous share of every batch;
    ``f32``: an f32 table and f32 MLPs instead of bf16 + SR and bf16."""
    from recommender_tpu_torch.cli.train_ctr import build_model

    model = build_model("DLRM", VOCAB, DIM, torch.float32 if f32 else torch.bfloat16, device,
                        mesh=mesh)
    init_model(model, seed=SEED)
    if f32:
        _f32_mlps(model)
    loss_fn, eval_fn = make_ctr_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=LR, seed=SEED), eval_fn,
                      device=device, mesh=mesh)
    state = trainer.init_state(lambda: model)
    n = trainer.mesh.data
    share = BATCH // n
    lo = trainer.mesh.data_index * share
    batches = _dp_batches(DIST_STEPS)
    if n == 1:
        halves = _half_batch_step(model, loss_fn, trainer, batches[0])
    reset_counts()
    with step_records(DIST_STEPS // 2) as rec:
        for i, batch in enumerate(batches):
            local = {k: v[lo:lo + share] for k, v in batch.items()}
            state, _ = trainer.train_step(state, trainer.put_batch(local))
            if i == 0:
                grads = _grads_of(model)
    out = dict(losses=rec["loss"], rows_per_rank=share, k1_launches=ek.sorted_scatter_add.launches,
               grads=grads, **_step_summary(rec))
    if n == 1:
        out["halves"] = halves
    else:  # the table's gradient takes no all-reduce; what one would cost
        out["table_grad_all_reduce_ms"] = _all_reduce_ms((VOCAB, DIM), trainer.mesh.data_group)
    return out


def _half_batch_step(model, loss_fn, trainer, batch) -> dict:
    """The first step's loss and gradients as ``DIST_RANKS`` data ranks take
    them, in this process: each rank's contiguous rows, their mean loss and
    its gradients, averaged in f32 in rank order; no update."""
    share = BATCH // DIST_RANKS
    losses, grads = [], []
    for r in range(DIST_RANKS):
        part = trainer.put_batch({k: v[r * share:(r + 1) * share] for k, v in batch.items()})
        model.zero_grad(set_to_none=True)
        per_ex, _ = loss_fn(part, True)
        loss = torch.mean(per_ex)
        loss.backward()
        losses.append(loss.detach().float())
        grads.append({n: p.grad.detach().float().clone() for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    total = grads[0]
    for g in grads[1:]:
        total = {n: total[n] + g[n] for n in total}
    loss = losses[0]
    for x in losses[1:]:
        loss = loss + x
    return dict(loss=float(loss / DIST_RANKS),
                grads={n: (t / DIST_RANKS).cpu() for n, t in total.items()})


def _all_reduce_ms(shape, group) -> float:
    """Median host ms of an f32 all-reduce of ``shape`` over ``group``, from
    a sync to a sync (4 of 5 calls, after one to warm up)."""
    from recommender_tpu_torch.core import distributed as dd

    buf = torch.zeros(shape, dtype=torch.float32, device=torch.cuda.current_device())
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dd.all_reduce(buf, group=group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def _grads_of(model) -> dict:
    """Each parameter's gradient of the step just taken, on the host."""
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()}


def _grad_rel_err(got: dict, want: dict) -> dict:
    """Per parameter: max |got - want| over max |want|."""
    return {n: float((got[n] - want[n]).abs().max() / want[n].abs().max().clamp(min=1e-30))
            for n in want}


def _dist_dp(rank, world, address, backend, f32=False) -> dict:
    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh

    return _dp_losses(torch.device("cuda", torch.cuda.current_device()),
                      make_mesh(MeshSpec(world, 1)), f32)


def _tt_losses(device, mesh=None, f32=False) -> dict:
    """``DIST_TT_STEPS`` two-tower Trainer steps at the RESULTS width on
    global b1024 batches, each rank taking its contiguous share; ``f32``:
    the towers compute in f32 instead of bf16."""
    us, its = twotower_interactions()
    g = BipartiteGraph(us, its, TT_USERS, TT_ITEMS)
    model = init_model(TwoTower(user_vocab=TT_USERS, item_vocab=TT_ITEMS, embed_dim=32,
                                repr_dim=32, tower_units=(64,), device=device, mesh=mesh),
                       seed=SEED)
    if f32:
        _f32_mlps(model)
    loss_fn, eval_fn = make_two_tower_task(model)
    trainer = Trainer(loss_fn, TrainConfig(learning_rate=3e-3, seed=SEED), eval_fn,
                      device=device, mesh=mesh)
    state = trainer.init_state(lambda: model)
    share = 1024 // trainer.mesh.data
    lo = trainer.mesh.data_index * share
    it = interaction_batches(g, 1024, seed=SEED)
    reset_counts()
    with step_records(DIST_TT_STEPS // 2) as rec:
        for i in range(DIST_TT_STEPS):
            batch = {k: v[lo:lo + share] for k, v in next(it).items()}
            state, _ = trainer.train_step(state, trainer.put_batch(batch))
            if i == 0:
                grads = _grads_of(model)
    return dict(losses=rec["loss"], rows_per_rank=share, grads=grads,
                k1_launches=ek.sorted_scatter_add.launches, **_step_summary(rec))


def _dist_twotower(rank, world, address, backend) -> dict:
    from recommender_tpu_torch.core.mesh import MeshSpec, make_mesh

    return _tt_losses(torch.device("cuda", torch.cuda.current_device()),
                      make_mesh(MeshSpec(world, 1)))


def _dist_dryrun(rank, world, address, backend) -> dict:
    """The dry run's entry point (``python -m recommender_tpu_torch.dryrun
    --device cuda``) in this rank's group: one DLRM and one PinSage step on
    this card, the tables row-sharded over every rank."""
    from recommender_tpu_torch import dryrun

    reset_counts()
    losses = dryrun.main(["--device", "cuda"])
    torch.cuda.synchronize()
    return dict(losses=losses, k1_launches=ek.sorted_scatter_add.launches,
                backend=torch.distributed.get_backend())


DIST_JOBS = {"ctr": _dist_ctr, "skew": _dist_skew, "dp": _dist_dp, "twotower": _dist_twotower,
             "dryrun": _dist_dryrun}


def _dist_rank(rank: int, world: int, address: str, backend: str, jobs: list, out: str):
    """One rank, in a process of its own: join the group, run ``jobs``
    (``(key, job name, kwargs)``) in order, save the results for the parent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from recommender_tpu_torch.core.distributed import initialize_from_flags

    initialize_from_flags(address, world, rank, device="cuda", backend=backend)
    results = {}
    for key, name, kw in jobs:
        results[key] = DIST_JOBS[name](rank, world, address, backend, **kw)
    torch.save(results, f"{out}/rank_{rank}.pt")
    torch.distributed.destroy_process_group()


def run_ranks(world: int, backend: str, jobs: list) -> list[dict]:
    """``world`` spawned ranks on this card running ``jobs``; each rank's
    results. Fails if a rank fails or outlives ``DIST_WORKER_TIMEOUT``;
    every process is stopped on the way out."""
    import multiprocessing

    out = _build.BUILD_DIR / "dist_ranks"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    address = f"127.0.0.1:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(r, world, address, backend, jobs, str(out)))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + DIST_WORKER_TIMEOUT
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1))
        codes = [p.exitcode for p in procs]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check(codes == [0] * world, f"ranks exited with {codes} ({backend}, jobs {[j[0] for j in jobs]})")
    results = [torch.load(out / f"rank_{r}.pt", weights_only=False) for r in range(world)]
    shutil.rmtree(out, ignore_errors=True)
    return results


def _max_diff(a, b) -> float:
    check(len(a) == len(b), f"{len(a)} against {len(b)} losses")
    return float(max(abs(x - y) for x, y in zip(a, b)))


def phase_dist(device) -> dict:
    """The distribution phases (module docstring, 28-33): single-process
    references in this process, then one NCCL rank, then two gloo ranks on
    this card; returns K1's launches by path."""
    root = _build.BUILD_DIR / "dist"
    shutil.rmtree(root, ignore_errors=True)
    t_all = time.perf_counter()
    # the unlaunched single-process run: the reference of dist_nccl1,
    # dist_sharded and dist_checkpoint
    reset_counts()
    with step_records(DIST_STEPS // 2) as rec:
        ref_state, ref_lines = _cli_run([*DIST_ARGS, "--steps", str(DIST_STEPS)], train_ctr.main)
    ref = dict(losses=rec["loss"], k1_launches=ek.sorted_scatter_add.launches,
               **_step_summary(rec))
    dp_ref, tt_ref = _dp_losses(device), _tt_losses(device)
    dp32_ref, tt32_ref = _dp_losses(device, f32=True), _tt_losses(device, f32=True)
    emit("dist_reference", steps=DIST_STEPS, ctr=ref,
         **{k: {f: v for f, v in r.items() if f not in ("grads", "halves")} for k, r in
            (("dp", dp_ref), ("twotower", tt_ref), ("dp_f32", dp32_ref),
             ("twotower_f32", tt32_ref))})

    # dist_nccl1: the entry point launched as a one-rank NCCL job
    t0 = time.perf_counter()
    [nccl] = run_ranks(1, "nccl", [("ctr", "ctr", {}), ("dryrun", "dryrun", {})])
    dryruns = {"nccl1": [nccl["dryrun"]]}
    nccl = nccl["ctr"]
    emit("dist_nccl1", backend=nccl["backend"], losses=nccl["losses"],
         k1_launches=nccl["k1_launches"], ms_per_step_median=nccl["ms_per_step_median"],
         reference_ms_per_step_median=ref["ms_per_step_median"],
         equal_bit_for_bit=nccl["losses"] == ref["losses"], seconds=time.perf_counter() - t0)
    check(nccl["backend"] == "nccl", f"dist_nccl1 ran over {nccl['backend']}")
    check(nccl["losses"] == ref["losses"], "dist_nccl1: losses differ from the unlaunched run")
    check(nccl["k1_launches"] == DIST_STEPS, f"dist_nccl1 launched K1 {nccl['k1_launches']} times")

    # two gloo ranks on this card: psum, a2a, the skewed a2a, (2, 1), the
    # two-tower, and a (1, 2) run that writes a checkpoint
    ckpt = root / "checkpoint"
    t0 = time.perf_counter()
    ranks = run_ranks(DIST_RANKS, "gloo", [
        ("psum", "ctr", {"extra": ("--mesh_model", "2", "--lookup_mode", "psum")}),
        ("a2a", "ctr", {"extra": ("--mesh_model", "2", "--lookup_mode", "a2a",
                                  "--a2a_capacity_factor", str(DIST_A2A_CAPACITY))}),
        ("skew", "skew", {}),
        ("dp", "dp", {}),
        ("dp_f32", "dp", {"f32": True}),
        ("twotower", "twotower", {}),
        ("dryrun", "dryrun", {}),
        ("checkpoint", "ctr", {"extra": ("--mesh_model", "2", "--lookup_mode", "psum",
                                         "--checkpoint_dir", str(ckpt)),
                               "steps": DIST_CKPT_STEPS}),
    ])
    gloo_seconds = time.perf_counter() - t0
    rows = VOCAB // DIST_RANKS
    ref_shas = _param_shas(ref_state.model)
    sharded_out = {}
    for mode, tol in (("psum", 0.0), ("a2a", DIST_A2A_LOSS_TOL)):
        runs = [r[mode] for r in ranks]
        diff = _max_diff(runs[0]["losses"], ref["losses"])
        same_ranks = all(r["losses"] == runs[0]["losses"] for r in runs)
        dense = [n for n in runs[0]["shas"] if n != "embedding.embedding"]
        dense_equal_across_ranks = all(r["shas"][n] == runs[0]["shas"][n] for r in runs for n in dense)
        shards_equal_ref = all(
            r["shas"]["embedding.embedding"] == _param_shas(
                ref_state.model, (r["row_offset"], r["row_offset"] + rows))["embedding.embedding"]
            for r in runs)
        dense_equal_ref = all(runs[0]["shas"][n] == ref_shas[n] for n in dense)
        sharded_out[mode] = dict(
            losses=runs[0]["losses"], max_abs_loss_diff=diff, tolerance=tol,
            bit_for_bit=runs[0]["losses"] == ref["losses"], shards_equal_reference=shards_equal_ref,
            dense_equal_reference=dense_equal_ref, dense_equal_across_ranks=dense_equal_across_ranks,
            shard_shapes=[r["shard_shape"] for r in runs], k1_launches=[r["k1_launches"] for r in runs],
            lookup_mode=runs[0]["lookup_mode"], final=runs[0]["final"],
            ms_per_step_median=[r["ms_per_step_median"] for r in runs],
            transport_ms_per_step_median=[r["transport_ms_per_step_median"] for r in runs],
            transport_share_of_instrumented_step=[
                r["transport_share_of_instrumented_step"] for r in runs],
            instrumented_ms_per_step_median=[r["instrumented_ms_per_step_median"] for r in runs],
            a2a_overflow=runs[0].get("a2a_overflow"))
        check(all(r["backend"] == "gloo" and r["device"].startswith("cuda") for r in runs),
              f"dist_sharded {mode}: not gloo ranks on the card")
        check(all(r["sharded"] for r in runs), f"dist_sharded {mode}: the table is not sharded")
        check(same_ranks, f"dist_sharded {mode}: the ranks' losses differ")
        check(dense_equal_across_ranks, f"dist_sharded {mode}: dense params differ across ranks")
        check(diff <= tol, f"dist_sharded {mode}: losses differ by {diff} > {tol}")
        check(all(r["shard_shape"] == [rows, DIM] for r in runs),
              f"dist_sharded {mode}: shards {[r['shard_shape'] for r in runs]}")
        check(all(r["k1_launches"] == DIST_STEPS for r in runs),
              f"dist_sharded {mode}: K1 launches {[r['k1_launches'] for r in runs]}")
    check(sharded_out["psum"]["shards_equal_reference"] and sharded_out["psum"]["dense_equal_reference"],
          "dist_sharded psum: the trained params differ from the single-process run's")
    emit("dist_sharded", ranks=DIST_RANKS, backend="gloo (one-card transport)",
         a2a_capacity_factor=DIST_A2A_CAPACITY, reference_ms_per_step_median=ref["ms_per_step_median"],
         seconds_all_gloo_jobs=gloo_seconds, **sharded_out)

    skew = [r["skew"] for r in ranks]
    want_per_rank = round(skew[0]["fraction"] * skew[0]["ids"])
    emit("dist_skew", capacity_factor=DIST_SKEW_CAPACITY, **skew[0],
         dropped_rows_by_rank=[s["dropped_rows"] for s in skew],
         expected_dropped=want_per_rank * DIST_RANKS,
         note="a2a_overflow sums every rank's own drops over the model group, each rank "
              "routing its copy of the replicated ids, as JAX counts them")
    check(skew[0]["dropped"] > 0, "dist_skew: no id overflowed at capacity 1.0")
    check(all(s["dropped"] == want_per_rank * DIST_RANKS for s in skew),
          f"dist_skew: a2a_overflow {skew[0]['dropped']} != {want_per_rank} x {DIST_RANKS}")
    check(all(s["dropped_rows"] == want_per_rank and s["dropped_rows_max_abs"] == 0.0
              and s["served_equal"] for s in skew), "dist_skew: dropped or served rows wrong")

    for key, ref_run in (("dp", dp_ref), ("dp_f32", dp32_ref)):
        runs = [r[key] for r in ranks]
        halves = ref_run["halves"]
        table_tol = DIST_HALVES_RTOL if key.endswith("_f32") else DIST_BF16_TABLE_RTOL
        first = abs(runs[0]["losses"][0] - ref_run["losses"][0])
        diff = _max_diff(runs[0]["losses"], ref_run["losses"])
        half_loss = abs(runs[0]["losses"][0] - halves["loss"])
        half_err = _grad_rel_err(runs[0]["grads"], halves["grads"])
        tol = {n: table_tol if n == "embedding.embedding" else DIST_HALVES_RTOL for n in half_err}
        dense_bitwise = all(torch.equal(runs[0]["grads"][n], halves["grads"][n])
                            for n in half_err if n != "embedding.embedding")
        name = f"dist_{key}"
        emit(name, mesh=[DIST_RANKS, 1], rows_per_rank=runs[0]["rows_per_rank"],
             dtypes="f32 table and MLPs" if key.endswith("_f32")
             else "as shipped: bf16 + SR table, bf16 MLPs",
             losses=runs[0]["losses"], reference_losses=ref_run["losses"],
             first_step_loss_against_halves=half_loss, halves_loss_tolerance=DIST_HALVES_LOSS_TOL,
             first_step_grad_rel_err_against_halves=half_err, halves_grad_rtol=tol,
             dense_grads_equal_halves_bit_for_bit=dense_bitwise,
             first_step_loss_diff=first, first_step_loss_tolerance=DIST_DP_LOSS_TOL,
             first_step_grad_rel_err=_grad_rel_err(runs[0]["grads"], ref_run["grads"]),
             max_abs_loss_diff=diff, trajectory_tolerance=DIST_TRAJECTORY_TOL,
             k1_launches=[d["k1_launches"] for d in runs],
             ms_per_step_median=[d["ms_per_step_median"] for d in runs],
             reference_ms_per_step_median=ref_run["ms_per_step_median"],
             instrumented_ms_per_step_median=[d["instrumented_ms_per_step_median"] for d in runs],
             transport_ms_per_step_median=[d["transport_ms_per_step_median"] for d in runs],
             transport_share_of_instrumented_step=[
                 d["transport_share_of_instrumented_step"] for d in runs],
             table_grad_all_reduce_ms=[d["table_grad_all_reduce_ms"] for d in runs])
        check(all(d["losses"] == runs[0]["losses"] for d in runs), f"{name}: the ranks' losses differ")
        check(half_loss <= DIST_HALVES_LOSS_TOL, f"{name}: first loss {half_loss} off the halves'")
        check(all(half_err[n] <= tol[n] for n in half_err), f"{name}: first gradients {half_err}")
        check(first <= DIST_DP_LOSS_TOL, f"{name}: first losses differ by {first}")
        check(diff <= DIST_TRAJECTORY_TOL, f"{name}: losses differ by {diff}")
        check(all(d["k1_launches"] == DIST_STEPS for d in runs),
              f"{name}: K1 launches {[d['k1_launches'] for d in runs]}")

    tt = [r["twotower"] for r in ranks]
    tt_first = abs(tt[0]["losses"][0] - tt_ref["losses"][0])
    tt_diff = _max_diff(tt[0]["losses"], tt_ref["losses"])
    tt_grads = _grad_rel_err(tt[0]["grads"], tt_ref["grads"])
    noise = _grad_rel_err(tt_ref["grads"], tt32_ref["grads"])  # one rank's own bf16 rounding
    tt_tol = {n: DIST_BF16_NOISE_FACTOR * noise[n] + DIST_HALVES_RTOL for n in tt_grads}
    emit("dist_twotower", mesh=[DIST_RANKS, 1], rows_per_rank=tt[0]["rows_per_rank"],
         losses=tt[0]["losses"], reference_losses=tt_ref["losses"], first_step_loss_diff=tt_first,
         first_step_loss_tolerance=DIST_TT_LOSS_TOL, first_step_grad_rel_err=tt_grads,
         grad_rtol=tt_tol, one_rank_bf16_against_f32_grad_rel_err=noise,
         max_abs_loss_diff=tt_diff, trajectory_tolerance=DIST_TRAJECTORY_TOL,
         k1_launches=[t["k1_launches"] for t in tt],
         ms_per_step_median=[t["ms_per_step_median"] for t in tt],
         reference_ms_per_step_median=tt_ref["ms_per_step_median"],
         instrumented_ms_per_step_median=[t["instrumented_ms_per_step_median"] for t in tt],
         transport_ms_per_step_median=[t["transport_ms_per_step_median"] for t in tt],
         transport_share_of_instrumented_step=[
             t["transport_share_of_instrumented_step"] for t in tt])
    check(all(t["losses"] == tt[0]["losses"] for t in tt), "dist_twotower: the ranks' losses differ")
    check(tt_first <= DIST_TT_LOSS_TOL, f"dist_twotower: first losses differ by {tt_first}")
    check(all(tt_grads[n] <= tt_tol[n] for n in tt_grads), f"dist_twotower: first gradients {tt_grads}")
    check(tt_diff <= DIST_TRAJECTORY_TOL, f"dist_twotower: losses differ by {tt_diff}")
    check(all(t["k1_launches"] == TT_K1_PER_STEP * DIST_TT_STEPS for t in tt),
          "dist_twotower: K1 launches")

    # the dry run's entry point: one NCCL rank on a 1 x 1 mesh, two gloo
    # ranks on a (1, 2) mesh; K1 once a DLRM step, 4 times a PinSage step
    dryruns["gloo2"] = [r["dryrun"] for r in ranks]
    emit("dist_dryrun", **{k: [dict(d) for d in v] for k, v in dryruns.items()})
    for k, runs in dryruns.items():
        check(all(d["losses"] == runs[0]["losses"] and set(d["losses"]) == {"dlrm", "pinsage"}
                  and all(np.isfinite(x) for x in d["losses"].values()) for d in runs),
              f"dist_dryrun {k}: losses {[d['losses'] for d in runs]}")
        check(all(d["k1_launches"] == 5 for d in runs),
              f"dist_dryrun {k}: K1 launches {[d['k1_launches'] for d in runs]}")
    check([d["backend"] for d in dryruns["nccl1"]] == ["nccl"], "dist_dryrun: not NCCL")

    # dist_checkpoint: the (1, 2) run's checkpoint resumed here at (1, 1)
    saved = [r["checkpoint"] for r in ranks]
    reset_counts()
    resumed, _ = _cli_run([*DIST_ARGS, "--steps", str(DIST_STEPS - DIST_CKPT_STEPS), "--resume",
                           "--checkpoint_dir", str(ckpt)], train_ctr.main)
    resumed_k1 = ek.sorted_scatter_add.launches
    want, got = ref_state.model.state_dict(), resumed.model.state_dict()
    differing = [k for k in want if not torch.equal(want[k], got[k])]
    moments = ref_state.optimizer.state_dict(), resumed.optimizer.state_dict()
    differing += [f"{w}[{i}]" for w in ("mu", "nu")
                  for i, (a, b) in enumerate(zip(moments[0][w], moments[1][w]))
                  if not torch.equal(a, b)]
    files = sorted(f.name for f in ckpt.iterdir())
    emit("dist_checkpoint", saved_at=[1, DIST_RANKS], restored_at=[1, 1],
         saved_steps=DIST_CKPT_STEPS, resumed_step=resumed.step, checkpoints=files,
         tensors_differing_from_uninterrupted=differing,
         k1_launches=[s["k1_launches"] for s in saved] + [resumed_k1])
    check(resumed.step == DIST_STEPS, f"dist_checkpoint resumed to step {resumed.step}")
    check(not differing, f"dist_checkpoint: the resumed state differs in {differing}")
    shutil.rmtree(root, ignore_errors=True)
    emit("dist_phases", seconds=time.perf_counter() - t_all)
    return dict(dist_reference=ref["k1_launches"] + dp_ref["k1_launches"] + tt_ref["k1_launches"],
                dist_nccl1=nccl["k1_launches"],
                dist_psum=sum(r["psum"]["k1_launches"] for r in ranks),
                dist_a2a=sum(r["a2a"]["k1_launches"] for r in ranks),
                **{f"dist_{k}": sum(r[k]["k1_launches"] for r in ranks)
                   for k in ("dp", "dp_f32", "twotower")},
                dist_dryrun=sum(d["k1_launches"] for v in dryruns.values() for d in v),
                dist_checkpoint=sum(s["k1_launches"] for s in saved) + resumed_k1)


def _gloo_probe_rank(rank: int, world: int, address: str, out: str):
    """Each collective the port uses, called by plain ``torch.distributed``
    on CUDA tensors of a gloo group: accepted, or the error it raised."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=world, rank=rank)
    torch.cuda.set_device(0)
    res = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        x = (torch.arange(4 * world, device="cuda") + rank).to(dtype)
        calls = {
            "all_reduce": lambda: dist.all_reduce(x.clone()),
            "all_to_all_single": lambda: dist.all_to_all_single(torch.empty_like(x), x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(4 * world * world, dtype=dtype, device="cuda"), x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(4, dtype=dtype, device="cuda"), x),
        }
        for name, call in calls.items():
            try:
                call()
                torch.cuda.synchronize()
                res[f"{name}/{dtype}"] = "accepted"
            except (RuntimeError, ValueError, TypeError) as e:  # a probe: what gloo refuses
                res[f"{name}/{dtype}"] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    with open(f"{out}/probe_{rank}.json", "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def probe_gloo_cuda() -> dict:
    """Which of the port's four collectives gloo takes on CUDA tensors, as
    two ranks on this card find it (``--probe-gloo-cuda``)."""
    import multiprocessing

    out = _build.BUILD_DIR / "gloo_probe"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    address = f"127.0.0.1:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_gloo_probe_rank, args=(r, 2, address, str(out)))
             for r in range(2)]
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    check([p.exitcode for p in procs] == [0, 0], "gloo probe ranks failed")
    with open(out / "probe_0.json") as f:
        return json.load(f)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if sys.argv[1:] in (["--profile-bst"], ["--profile-dien"], ["--profile-mt-graph"],
                        ["--fwd-occupancy"]):
        smi = phase_device()
        if sys.argv[1] == "--profile-bst":
            emit("profile_bst", **profile_bst(device))
        elif sys.argv[1] == "--profile-mt-graph":
            phase_build()
            emit("profile_mt_graph", **profile_mt_graph(device))
        elif sys.argv[1] == "--profile-dien":
            phase_build()
            emit("profile_dien", **profile_dien(device))
        else:
            emit("fwd_occupancy", **fwd_occupancy(device))
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return 0
    if sys.argv[1:] == ["--ptxas"]:
        smi = phase_device()
        emit("ptxas", kernels=ptxas_report())
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--probe-gloo-cuda"]:
        smi = phase_device()
        emit("gloo_cuda_probe", torch=torch.__version__, calls=probe_gloo_cuda())
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--k2"]:
        smi = phase_device()
        phase_build()
        shapes = k2_shapes(device, without_negatives(sequence_data()[0]))
        for case, valid, heads, head_dim, _, _ in shapes.values():
            phase_k2(device, case, valid, heads, head_dim)
        phase_k2_routes(device, shapes["bst"][1])
        print(smi, flush=True)
        return 0
    if sys.argv[1:] == ["--dist"]:
        smi = phase_device()
        phase_build()
        emit("dist_only", launches_by_path=phase_dist(device))
        print(smi, flush=True)
        return 0
    if sys.argv[1:]:
        print(f"usage: {sys.argv[0]} [--profile-bst | --profile-dien | --profile-mt-graph | "
              "--fwd-occupancy | --probe-gloo-cuda | --dist | --k2 | --ptxas]",
              file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    seq_train, seq_test = sequence_data()
    bst_train, bst_test = without_negatives(seq_train), without_negatives(seq_test)
    mt_train, mt_test = multitask_data()
    graph = eges_graph()
    ps_graph = pinsage_graph()
    tt_us, tt_its = twotower_interactions()
    tt_graph = BipartiteGraph(tt_us, tt_its, TT_USERS, TT_ITEMS)
    k1 = phase_k1(device, {k: v[:BST_BATCH] for k, v in seq_train.items()},
                  {k: v[:MT_BATCH] for k, v in mt_train.items()}, next(eges_stream(*graph)),
                  next(pinsage_train_batches(ps_graph[0], PS_BATCH, seed=SEED)),
                  ps_graph[1].year, next(interaction_batches(tt_graph, 1024, seed=SEED)))
    k2_cases = k2_shapes(device, bst_train)
    k2 = {}
    for key, (case, valid, heads, head_dim, fwd_route, bwd_route) in k2_cases.items():
        k2[key] = phase_k2(device, case, valid, heads, head_dim)
        took = (k2[key]["fwd_route"], k2[key]["route"])
        check(took == (fwd_route, bwd_route), f"K2 {case} took the {took} routes")
    phase_k2_routes(device, k2_cases["bst"][1])
    dlrm_k1 = phase_train(device)
    phase_card_cpu(device)
    bst_launches = phase_bst_train(device, bst_train, bst_test)
    long_launches = phase_bst_long(device)
    phase_bst_card_cpu(device)
    dh128_launches = phase_bst_dh128(device, bst_train)
    dien_k1 = phase_dien_train(device, seq_train, seq_test)
    din_k1 = phase_din_train(device, seq_train)
    dien_long_k1 = phase_dien_long(device)
    phase_dien_card_cpu(device)
    cli_k1 = phase_dien_cli()
    t0 = time.perf_counter()
    ctr = phase_ctr_cli()
    ctr_predict = phase_ctr_predict(ctr["resume"]["state"])
    emit("ctr_phases", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    accum_k1 = phase_accum(device)
    profiling_k1 = phase_profiling(device)
    emit("accum_profiling_phases", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    mmoe_k1 = phase_mmoe_train(device, mt_train, mt_test)
    phase_mt_graph_card_cpu(device, graph)
    esmm_cli_k1 = phase_esmm_cli()
    eges_k1 = phase_eges_train(device, graph)
    eges_cli_k1 = phase_eges_cli()
    eges_export_k1 = phase_eges_export(device)
    emit("multitask_graph_phases", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    retrieval_k1 = {"pinsage": phase_pinsage_train(device, ps_graph),
                    "pinsage_cli": phase_pinsage_cli(),
                    "twotower": phase_twotower_cli(device),
                    "eges_export": eges_export_k1}
    phase_serve_corpus(device)
    phase_retrieval_card_cpu(device)
    emit("retrieval_phases", seconds=time.perf_counter() - t0)
    dist_k1 = phase_dist(device)
    ctr_k1 = {"ctr_cli": ctr["dlrm"]["k1_launches"] + ctr["dlrm_again"]["k1_launches"],
              "ctr_cli_dedup": (ctr["dlrm_dedup"]["k1_launches"]
                                + ctr["dlrm_dedup_again"]["k1_launches"]),
              "deepfm": ctr["deepfm"]["k1_launches"], "dcn": ctr["dcn"]["k1_launches"],
              "ctr_shards": ctr["shards"]["k1_launches"],
              "ctr_resume": ctr["resume"]["k1_launches"], "ctr_predict": ctr_predict["k1_launches"],
              **accum_k1, "profiling": profiling_k1, "bst_dh128": dh128_launches["k1"]}
    graph_k1 = {"mmoe_esmm": mmoe_k1, "esmm_cli": esmm_cli_k1, "eges": eges_k1,
                "eges_cli": eges_cli_k1}
    print(smi, flush=True)
    main_case = k1["bf16_order"]  # the bf16 table's backward: bf16 cotangent + order
    kernels = [{
        "name": "sorted_scatter_add",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        # DLRM run + the two BST runs + the DIEN, DIN, long-DIEN and CLI runs
        # + the CTR, multi-task, graph and retrieval runs and entry points
        "launches": (dlrm_k1 + bst_launches["k1"] + long_launches["k1"] + dien_k1 + din_k1
                     + dien_long_k1 + cli_k1 + sum(ctr_k1.values()) + sum(graph_k1.values())
                     + sum(retrieval_k1.values()) + sum(dist_k1.values())),
        "launches_by_path": dict(dlrm=dlrm_k1, bst=bst_launches["k1"], bst_long=long_launches["k1"],
                                 dien=dien_k1, din=din_k1, dien_long=dien_long_k1,
                                 dien_cli=cli_k1, **ctr_k1, **graph_k1, **retrieval_k1,
                                 **dist_k1),
        "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        # index_add_ into a fresh zero table
        "library_ms": main_case["library_ms"],
        # BST's item-history backward (f32 + order, 102,400 ids into [400,000, 18])
        "bst_item_history_ms": k1["bst_item_history_f32_order"]["ms"],
        "bst_item_history_plain_ms": k1["bst_item_history_f32_order"]["plain_ms"],
        # DIEN's negative-history and shared_gather backwards into [400,000, 18]
        **{f"{case}_{key}": k1[f"{case}_order"][key]
           for case in ("dien_neg_history_f32", "dien_neg_history_bf16", "dien_shared_gather_f32")
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        # the dedup'd lookup's backward at DLRM b8192 (bf16 cotangent): the
        # segment sum into [U_cap, 16], then the unique rows into [1M, 16]
        **{f"{case}_{key}": k1[case][key]
           for case in ("dedup_segment_sum_bf16_order", "dedup_uniq_scatter_bf16")
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        # MMOE b8192: a per-table lookup's backward into [100,000, 18] (f32,
        # bf16 cotangent) and the stacked table's into [1.8M, 18]; EGES
        # b4096: the output table [100,000, 128], the cat table [200, 128],
        # the weight table [100,000, 3]
        **{f"{case}_{key}": k1[f"{case}_order"][key]
           for case in ("mmoe_table_f32", "mmoe_table_bf16", "mmoe_stacked_f32",
                        "eges_output_f32", "eges_cat_f32", "eges_weight_f32")
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        # PinSage b512's nbr2 lookups into the year [81, 8] and id [3,706, 8]
        # tables; two-tower b1024's user [6,000, 32] and item [3,700, 32]
        **{f"{case}_{key}": k1[f"{case}_order"][key]
           for case in ("pinsage_year_f32", "pinsage_id_f32", "twotower_user_f32",
                        "twotower_item_f32")
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
        # the row-sharded DLRM table's backward on shard 0 [500,000, 16] at
        # model 2 (bf16 cotangent): the psum exchange's ids and the a2a's
        **{f"{case}_{key}": k1[f"{case}_order"][key]
           for case in ("dist_psum_shard_bf16", "dist_a2a_shard_bf16")
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")},
    }]
    # each K2 kernel at the shape of its main path: the fused forward and
    # backward at BST's, the long routes' at the BST run with history 1,000;
    # beside them, each at the Dh > 64 cases of its route (the wide kernels,
    # with the long backward's registers, local bytes and blocks an SM)
    for name, kernel, route_key, route, case, errs in (
        ("fwd_fused", "fwd", "fwd_route", "fused", "bst", ("o",)),
        ("fwd_long", "fwd", "fwd_route", "long", "r5_dh9", ("o",)),
        ("bwd", "bwd", "route", "fused", "bst", ("dq", "dk", "dv")),
        ("bwd_dkv", "bwd_dkv", "route", "long", "r5_dh9", ("dk", "dv")),
        ("bwd_dq", "bwd_dq", "route", "long", "r5_dh9", ("dq",)),
    ):
        r = k2[case]
        fwd = kernel == "fwd"
        same_route = [x for x in k2.values() if x[route_key] == route]
        kernels.append({
            "name": f"flash_attention_{name}",
            "route": "cuda",
            "source": K2_SOURCE if fwd else K2_BWD_SOURCE,
            "replaces": K2_REPLACES,
            "tpu_kernel": K2_TPU_KERNELS[kernel],
            "launches": bst_launches[name] + long_launches[name] + dh128_launches[name],
            "launches_by_path": dict(bst=bst_launches[name], bst_long=long_launches[name],
                                     bst_dh128=dh128_launches[name]),
            "max_abs_err": max(x["abs_err"][n] for x in same_route for n in errs),
            "shape": k2_cases[case][0],
            # the forward through flash_mha, the backward's kernels alone
            "ms": r["fwd_ms"] if fwd else r["kernel_ms"][kernel],
            "kernel_ms": r["kernel_ms"][kernel],  # the kernel alone
            # the plain forward; for the backward kernels the whole plain backward
            "plain_ms": r["plain_fwd_ms"] if fwd else r["plain_bwd_ms"],
            "bound_ms": r["bounds"][kernel]["bound_ms"],
            "bound_by": r["bounds"][kernel]["bound_by"],
            # scaled_dot_product_attention's forward; its whole backward for the others
            "library_ms": r["library_fwd_ms"] if fwd else r["library_bwd_ms"],
            "wide_head_dims": {
                k2_cases[key][0]: {
                    "max_abs_err": max(k2[key]["abs_err"][n] for n in errs),
                    "ms": k2[key]["fwd_ms"] if fwd else k2[key]["kernel_ms"][kernel],
                    "kernel_ms": k2[key]["kernel_ms"][kernel],
                    "plain_ms": k2[key]["plain_fwd_ms"] if fwd else k2[key]["plain_bwd_ms"],
                    "bound_ms": k2[key]["bounds"][kernel]["bound_ms"],
                    "bound_by": k2[key]["bounds"][kernel]["bound_by"],
                    "library_ms": (k2[key]["library_fwd_ms"] if fwd
                                   else k2[key]["library_bwd_ms"]),
                    **k2[key]["kernel_info"].get(kernel, {}),
                    # the other route of the same direction on the same inputs
                    **{rk: r for rk, r in k2[key]["other_routes"].items()
                       if r and rk.startswith("fwd" if fwd else "bwd")},
                } for key in K2_WIDE_CASES if k2[key][route_key] == route},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
