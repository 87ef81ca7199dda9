#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

The main path is DLRM training at ``bench.py`` width: a 1,000,000 x 16
embedding table stored in bf16 with stochastic-rounding Adam, bottom MLP
13→512→256→64→16, top MLP (729+16)→512→256→1, batch 8192 (212,992 ids a
step), lr 1e-3, on ``SyntheticCTR`` batches. Weights are random, drawn from
seed 0.

Run from the repository root (it builds the CUDA kernels from the sources
in this checkout at first use, into build/recommender_tpu_torch/):

    python3 chip_smoke.py

Phases, one JSON line each:

1. device   — the card, its power limit, torch and CUDA versions; TF32 off.
2. build    — build and load the sorted scatter-add kernel (K1).
3. k1       — K1 against its plain PyTorch version at the DLRM shape
              (212,992 ids into [1M, 16]): f32 and bf16 rounding, with and
              without ``order``, with ids >= V; bitwise repeatability;
              kernel and plain times (CUDA events, median of 25).
4. train    — 50 Trainer steps at full width, then ``evaluate`` on 20
              held-out batches; K1's launch count must equal the steps.
5. card_cpu — a small f32-table DLRM for 3 steps from one init on the card
              and on the CPU; the losses must agree.

Then it prints the card line from nvidia-smi, a JSON line of the kernels,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero without that line. It exits non-zero
at once where no CUDA device is available.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from recommender_tpu_torch.core.train import TrainConfig, Trainer
from recommender_tpu_torch.data import SyntheticCTR, batch_iterator
from recommender_tpu_torch.models import DLRM, init_model, make_ctr_task
from recommender_tpu_torch.ops import _build
from recommender_tpu_torch.ops import embedding_kernels as ek

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
# Eval AUC after 50 steps must clear 0.5 by this margin. Measured on an
# H100 80GB HBM3 (700 W limit): 0.7769 for these seeds; the run is
# deterministic up to GEMM rounding, so 0.2 leaves room without letting a
# model that learned nothing through.
AUC_MARGIN = 0.2
# Card vs CPU losses: the MLPs compute in bf16, and cuBLAS and the CPU's
# bf16 GEMMs round some products to a different bf16 neighbour.
CARD_CPU_LOSS_TOL = 2e-3

K1_SOURCE = "recommender_tpu_torch/ops/csrc/sorted_scatter_add.cu"
K1_REPLACES = "recommender_tpu/ops/embedding_kernels.py:213"


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
    cached = _build.library_path("sorted_scatter_add").exists()
    t0 = time.perf_counter()
    so = _build.build("sorted_scatter_add")
    _build.load("sorted_scatter_add")
    emit("build", kernel="sorted_scatter_add", library=str(so.relative_to(_build.BUILD_DIR.parents[1])),
         cached=cached, seconds=time.perf_counter() - t0)


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


def phase_k1(device) -> dict:
    sorted_ids, order, upd = k1_inputs(device)
    n_unique = int(torch.unique(sorted_ids[sorted_ids < VOCAB]).numel())
    _, counts = torch.unique_consecutive(sorted_ids, return_counts=True)
    longest_run = int(counts.max())
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
        got = ek.sorted_scatter_add(sorted_ids, u, VOCAB, order=o, kernel_dtype=kd)
        again = ek.sorted_scatter_add(sorted_ids, u, VOCAB, order=o, kernel_dtype=kd)
        want = ek.sorted_scatter_add_ref(sorted_ids, u, VOCAB, order=o, kernel_dtype=kd)
        abs_sum = ek.sorted_scatter_add_ref(sorted_ids, u_sorted.abs().contiguous(), VOCAB)
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_abs = float(err.max())
        max_rel = float((err / (abs_sum + 1e-30)).max())
        within = bool((err <= K1_REL_TOL * abs_sum + K1_ABS_FLOOR).all())
        bitwise = bool(torch.equal(got, again))
        ms = cuda_ms(lambda: ek.sorted_scatter_add(sorted_ids, u, VOCAB, order=o, kernel_dtype=kd))
        plain_ms = cuda_ms(lambda: ek.sorted_scatter_add_ref(sorted_ids, u, VOCAB, order=o, kernel_dtype=kd))
        emit("k1", case=name, n=int(sorted_ids.numel()), vocab=VOCAB, dim=DIM,
             unique_ids=n_unique, longest_run=longest_run,
             max_abs_err=max_abs, max_rel_err=max_rel,
             tolerance=f"|err| <= {K1_REL_TOL} * row abs-sum + {K1_ABS_FLOOR}",
             within_tolerance=within, bitwise_repeatable=bitwise,
             ms=ms, plain_ms=plain_ms)
        check(within, f"K1 {name} disagrees with its plain version (max abs {max_abs})")
        check(bitwise, f"K1 {name}: two launches differ")
        results[name] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    return results


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
    ek.sorted_scatter_add.launches = 0
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = phase_device()
    phase_build()
    k1 = phase_k1(device)
    launches = phase_train(device)
    phase_card_cpu(device)
    print(smi, flush=True)
    main_case = k1["bf16_order"]  # the bf16 table's backward: bf16 cotangent + order
    print(json.dumps({"kernels": [{
        "name": "sorted_scatter_add",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
