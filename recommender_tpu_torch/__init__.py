"""recommender_tpu_torch — the PyTorch + CUDA port of ``recommender_tpu``.

Module paths and public names mirror the JAX package, so each counterpart
sits at the same relative path (``recommender_tpu/ops/rounding.py`` ↔
``recommender_tpu_torch/ops/rounding.py``). The JAX package is the
reference; the port never imports it (nor jax, flax or optax).

Slice 1 covers DLRM training at ``bench.py`` width:

* ``data``      — ``SyntheticCTR`` and ``batch_iterator`` (numpy copies).
* ``ops``       — stochastic rounding; the embedding lookup whose backward
                  is the hand-written CUDA sorted scatter-add (K1).
* ``embedding`` — the replicated ``Embedding`` table.
* ``nn``        — ``MLP``, ``DotInteraction``, ``fm_cross``, BCE losses.
* ``models``    — ``DLRM`` and the CTR task wrappers.
* ``core``      — SR-Adam, streaming metrics, the single-device ``Trainer``.
* ``convert``   — flax param tree → the port's ``state_dict``.

Divergences from the JAX package are listed in ``PARITY.md`` beside this
file.
"""

__version__ = "0.1.0"
