"""CTR batches in the Criteo schema: 13 dense features, ``num_cat`` Zipf
ids into one table, a Bernoulli label.

``SyntheticCTR`` is a frozen copy of the port's
``recommender_tpu_torch/data/synthetic.py::SyntheticCTR``: for the same
seeds the arrays are the same (``portbench/tests``).

Traffic keys: ``batch`` (rows a step), ``pool_batches`` (distinct batches
made, cycled through by the window), ``zipf_a`` and ``signal``. The
vocabulary and feature counts are the model's (``vocab_size``,
``num_int``, ``num_cat``). Where the model gives ``cardinalities``, one
count a feature summing to ``vocab_size``, feature ``f``'s ids are drawn
modulo its count and laid into its own range of rows, after the ranges of
the features before it (26 tables as one); without them every feature
draws from the whole table, as ``SyntheticCTR`` does.
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
    cardinalities: tuple | None = None  # the benchmark's: a range of rows a feature

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._cat_weights = rng.normal(0.0, self.signal / np.sqrt(self.num_cat), size=(self.vocab_size,)).astype(np.float32)
        self._int_weights = rng.normal(0.0, self.signal / np.sqrt(self.num_int), size=(self.num_int,)).astype(np.float32)
        self._bias = -0.5

    def sample(self, n: int, seed: int = 1) -> dict:
        rng = np.random.default_rng(seed)
        # Zipf-ish ids clipped to vocab (mimics log-uniform popularity)
        cat = rng.zipf(self.zipf_a, size=(n, self.num_cat))
        if self.cardinalities is None:
            cat = cat % self.vocab_size
        else:
            counts = np.asarray(self.cardinalities, np.int64)
            cat = cat % counts + np.concatenate([[0], np.cumsum(counts)[:-1]])
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


def pool(traffic: dict, model: dict, seed: int, count: int | None = None) -> list[dict]:
    """The first ``count`` (all where None) of the traffic's pool of batches."""
    world, *batch_seeds = np.random.SeedSequence(seed).generate_state(1 + traffic["pool_batches"])
    gen = SyntheticCTR(num_int=model["num_int"], num_cat=model["num_cat"],
                       vocab_size=model["vocab_size"], seed=int(world),
                       zipf_a=traffic["zipf_a"], signal=traffic["signal"],
                       cardinalities=_cardinalities(model))
    return [gen.sample(traffic["batch"], seed=int(s)) for s in batch_seeds[:count]]


def _cardinalities(model: dict):
    counts = model.get("cardinalities")
    if counts is None:
        return None
    if len(counts) != model["num_cat"] or sum(counts) != model["vocab_size"]:
        raise ValueError(f"{len(counts)} cardinalities summing to {sum(counts)} for "
                         f"{model['num_cat']} features and {model['vocab_size']} rows")
    return tuple(counts)
