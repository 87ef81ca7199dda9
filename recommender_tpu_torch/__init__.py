"""recommender_tpu_torch — the PyTorch + CUDA port of ``recommender_tpu``.

Module paths and public names mirror the JAX package, so each counterpart
sits at the same relative path (``recommender_tpu/ops/rounding.py`` ↔
``recommender_tpu_torch/ops/rounding.py``). The JAX package is the
reference; the port never imports it (nor jax, flax or optax).

Slice 1 covers DLRM training at ``bench.py`` width, slice 2 BST training
at ``benchmarks/bench_models.py::bench_bst`` width, a later slice the DIN/DIEN
family through the ``cli.train_dien`` entry point with checkpoint and
resume:

* ``cli``       — ``train_dien`` (BASE / DIN / DIEN / BST) and the shared
                  flags, logger and trainer bootstrap (``common``).
* ``data``      — ``SyntheticCTR``, ``SyntheticSequence``,
                  ``batch_iterator`` and the Amazon Books pipeline
                  (numpy copies).
* ``ops``       — stochastic rounding; the embedding lookup whose backward
                  is the hand-written CUDA sorted scatter-add (K1); flash
                  attention, hand-written in CUDA (K2).
* ``embedding`` — the replicated ``Embedding`` table.
* ``nn``        — ``MLP`` (with flax's input ``BatchNorm``),
                  ``DotInteraction``, ``fm_cross``, the BCE and masked
                  auxiliary losses, ``masked_mean_pool``,
                  ``LocalActivationUnit``, ``AuxiliaryNet``,
                  ``DIENAttention``, the masked ``GRU`` and ``AUGRU``,
                  ``TransformerBlock``.
* ``models``    — ``DLRM``, ``SequenceBase``, ``BaseModel``, ``DIN``,
                  ``DIEN``, ``BST`` and the task wrappers.
* ``core``      — SR-Adam, streaming metrics, the single-device ``Trainer``
                  with checkpoints, the TensorBoard event writer.
* ``convert``   — flax params and ``batch_stats`` → the port's ``state_dict``.

Divergences from the JAX package are listed in ``PARITY.md`` beside this
file.
"""

__version__ = "0.1.0"
