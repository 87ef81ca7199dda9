"""recommender_tpu_torch — the PyTorch + CUDA port of ``recommender_tpu``.

Module paths and public names mirror the JAX package, so each counterpart
sits at the same relative path (``recommender_tpu/ops/rounding.py`` ↔
``recommender_tpu_torch/ops/rounding.py``). The JAX package is the
reference; the port never imports it (nor jax, flax or optax).

Slice 1 covers DLRM training at ``bench.py`` width, slice 2 BST training
at ``benchmarks/bench_models.py::bench_bst`` width, later slices the
DIN/DIEN family through the ``cli.train_dien`` entry point with checkpoint
and resume, the CTR family (DLRM, DeepFM, DCN) through ``cli.train_ctr``
and ``cli.predict``, the multi-task family (BASE, ESMM, MMOE) through
``cli.train_esmm`` and ``cli.predict --family esmm``, the
graph-embedding family (BGE, GES, EGES) through ``cli.train_eges``,
retrieval and serving, and distribution: one process per GPU on a
(data, model) mesh of ranks, row-sharded tables, data-parallel training
and checkpoints across meshes; the last, gradient accumulation, the
optimizer and rounding switches, Criteo preparation, profiling and the
remaining public names:

* ``cli``       — ``train_dien`` (BASE / DIN / DIEN / BST), ``train_ctr``
                  (DLRM / DeepFM / DCN), ``train_esmm`` (BASE / ESMM /
                  MMOE), ``train_eges`` (BGE / GES / EGES), ``predict``
                  (scores a checkpoint), ``prepare_aliccp`` (raw Ali-CCP
                  → npz splits), ``prepare_criteo`` (raw Criteo → vocab
                  and npz shards) and the shared flags, logger and
                  trainer bootstrap (``common``).
* ``data``      — ``SyntheticCTR``, ``SyntheticSequence``,
                  ``SyntheticInterestDrift``, ``SyntheticMultiInterest``,
                  ``SyntheticMultiTask``, ``batch_iterator``, the
                  prefetcher, the ordered interleave, dedup plans, the
                  Criteo shards, the Amazon Books pipeline, Ali-CCP and
                  the Amazon metadata graph prep (numpy copies).
* ``graph``     — the weighted graph store with alias tables, random
                  walks and skip-gram batches (numpy copies, and the
                  native sampler through ctypes).
* ``ops``       — stochastic rounding; the embedding lookups whose
                  backward is the hand-written CUDA sorted scatter-add
                  (K1), once, or twice with a dedup plan; flash attention,
                  hand-written in CUDA (K2), at any head dim.
* ``embedding`` — the ``Embedding`` table, replicated or row-sharded over
                  the mesh's model axis with the psum and all-to-all
                  exchanges (``sharded``, whose backward is K1 on each
                  shard), and the sharding planner (a numpy copy).
* ``parallel``  — which parameters are row-sharded, and which gradients
                  their lookups average over the data axis.
* ``nn``        — ``MLP`` (with flax's input ``BatchNorm``),
                  ``DotInteraction``, ``fm_cross``, ``CrossNetwork``, the
                  BCE and masked auxiliary losses, ``masked_mean_pool``,
                  ``LocalActivationUnit``, ``AuxiliaryNet``,
                  ``DIENAttention``, the masked ``GRU`` and ``AUGRU``,
                  ``TransformerBlock``, the LR schedule, ``ExpertBank``
                  and ``MMOEGate``.
* ``models``    — ``DLRM``, ``DeepFM``, ``DCN``, ``SequenceBase``,
                  ``BaseModel``, ``DIN``, ``DIEN``, ``BST``,
                  ``MultiTaskBase``, ``ESMM``, ``MMOE``, ``DeepWalk``,
                  ``GES``, ``EGES`` and the task wrappers.
* ``retrieval`` — batch scoring for ``cli.predict``.
* ``core``      — SR-Adam, Adam, Adagrad and SGD (with per-path update
                  scales), streaming metrics, profiling hooks, the
                  ``Trainer`` of one rank (gradient accumulation, gradients averaged
                  over the data axis, collective checkpoints of whole
                  tables), early stopping and a prefetcher, the TensorBoard
                  event writer, the rank mesh (``mesh``) and the launch and
                  collectives (``distributed``).
* ``dryrun``    — one DLRM and one PinSage step on a (data, model) mesh.
* ``convert``   — flax params and ``batch_stats`` → the port's ``state_dict``.

Divergences from the JAX package are listed in ``PARITY.md`` beside this
file.
"""

__version__ = "0.1.0"
