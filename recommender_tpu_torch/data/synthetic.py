"""Synthetic Criteo-schema CTR data with planted structure.

A copy of ``recommender_tpu/data/synthetic.py::SyntheticCTR``: the JAX
package's ``data`` namespace imports jax on load, and the port must run
where jax is not installed. For the same seeds the arrays are bit-identical
to the original's (``tests/test_torch_synthetic.py``).

Each categorical value carries a latent logistic weight, dense features add
a linear term, and labels are Bernoulli of the sigmoid, so a CTR model with
embeddings can push AUC toward the planted ceiling while a bias-only model
stays at 0.5.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticCTR:
    num_int: int = 13
    num_cat: int = 26
    vocab_size: int = 100_000
    seed: int = 0
    zipf_a: float = 1.2  # power-law id popularity like real CTR traffic
    signal: float = 2.0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._cat_weights = rng.normal(0.0, self.signal / np.sqrt(self.num_cat), size=(self.vocab_size,)).astype(np.float32)
        self._int_weights = rng.normal(0.0, self.signal / np.sqrt(self.num_int), size=(self.num_int,)).astype(np.float32)
        self._bias = -0.5

    def sample(self, n: int, seed: int = 1) -> dict:
        rng = np.random.default_rng(seed)
        # Zipf-ish ids clipped to vocab (mimics log-uniform popularity)
        cat = rng.zipf(self.zipf_a, size=(n, self.num_cat)) % self.vocab_size
        cat = cat.astype(np.int32)
        ints = rng.normal(0.0, 1.0, size=(n, self.num_int)).astype(np.float32)
        logits = (
            self._cat_weights[cat].sum(axis=1)
            + ints @ self._int_weights
            + self._bias
        )
        p = 1.0 / (1.0 + np.exp(-logits))
        label = (rng.random(n) < p).astype(np.float32)
        return {"int_features": ints, "cat_features": cat, "label": label}
