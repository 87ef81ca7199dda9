"""recommender_tpu_torch — the PyTorch + CUDA port of ``recommender_tpu``.

Module paths and public names mirror the JAX package, so each counterpart
sits at the same relative path (``recommender_tpu/ops/rounding.py`` ↔
``recommender_tpu_torch/ops/rounding.py``). The JAX package is the
reference; the port never imports it (nor jax, flax or optax).

Slice 1 covers DLRM training at ``bench.py`` width, slice 2 BST training
at ``benchmarks/bench_models.py::bench_bst`` width:

* ``data``      — ``SyntheticCTR``, ``SyntheticSequence`` and
                  ``batch_iterator`` (numpy copies).
* ``ops``       — stochastic rounding; the embedding lookup whose backward
                  is the hand-written CUDA sorted scatter-add (K1); flash
                  attention, hand-written in CUDA (K2).
* ``embedding`` — the replicated ``Embedding`` table.
* ``nn``        — ``MLP`` (with flax's input ``BatchNorm``),
                  ``DotInteraction``, ``fm_cross``, BCE losses,
                  ``masked_mean_pool``, ``TransformerBlock``.
* ``models``    — ``DLRM``, ``SequenceBase``, ``BST`` and the CTR task
                  wrappers.
* ``core``      — SR-Adam, streaming metrics, the single-device ``Trainer``.
* ``convert``   — flax params and ``batch_stats`` → the port's ``state_dict``.

Divergences from the JAX package are listed in ``PARITY.md`` beside this
file.
"""

__version__ = "0.1.0"
