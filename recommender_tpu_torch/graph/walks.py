"""A copy of ``recommender_tpu/graph/walks.py`` (the JAX package's
``graph`` and ``data`` namespaces import jax on load); for the same seed it
returns the same arrays, bit for bit (``tests/test_torch_graph_data.py``).

Vectorized random walks, skip-gram pair generation, Zipf negatives.

Replaces ``eges/data_loader.py:28-62`` (one DGL walk + keras ``skipgrams`` +
one-candidate-sampler call *per generated example*, the throughput limiter
flagged in SURVEY.md §7) with batched numpy over thousands of walkers.

* ``random_walk`` — weighted walks via the graph's alias tables; dead ends
  propagate -1 (DGL semantics) and are masked downstream.
* ``skipgram_pairs`` — all (target, context) pairs within ``window``,
  precomputed static index geometry (keras ``skipgrams`` with
  ``negative_samples=0`` parity, minus its pair shuffle — order doesn't
  matter because the trainer shuffles batches).
* ``LogUniformSampler`` — ``tf.random.log_uniform_candidate_sampler``
  parity: P(k) = log((k+2)/(k+1)) / log(range_max+1); inverse-CDF sampling
  k = floor(exp(u·log(range_max+1))) - 1. The reference draws 5 *unique*
  candidates per pair; we draw independently (collision odds over a
  Zipf tail of a 10^5+ vocab are negligible; documented divergence).
"""
from __future__ import annotations

import numpy as np

from recommender_tpu_torch.graph.store import WeightedGraph


def random_walk(
    graph: WeightedGraph, seeds: np.ndarray, length: int, rng: np.random.Generator
) -> np.ndarray:
    """[S] seeds → [S, length+1] node sequences (weighted; -1 after dead end).

    Uses the native C++ walker when the graph was built with it (whole walk
    in one call); otherwise the vectorized numpy stepper."""
    seeds = np.asarray(seeds, np.int32)
    if getattr(graph, "native", False):
        from recommender_tpu_torch.graph import native

        return native.weighted_random_walks(
            graph.indptr, graph.indices, graph.alias_prob, graph.alias_idx,
            seeds, length, int(rng.integers(1 << 62)),
        )
    out = np.full((len(seeds), length + 1), -1, np.int32)
    out[:, 0] = seeds
    cur = seeds
    for t in range(1, length + 1):
        alive = cur >= 0
        nxt = np.full_like(cur, -1)
        if alive.any():
            nxt[alive] = graph.sample_neighbors(cur[alive], rng)
        out[:, t] = nxt
        cur = nxt
    return out


def skipgram_pairs(walks: np.ndarray, window: int) -> tuple[np.ndarray, np.ndarray]:
    """[S, L] walks → (targets [P], contexts [P]) over all in-window pairs.

    Pairs whose endpoint is -1 (dead-end padding) or 0 (OOV row) are dropped.
    """
    S, L = walks.shape
    t_idx, c_idx = [], []
    for i in range(L):
        for j in range(max(0, i - window), min(L, i + window + 1)):
            if i != j:
                t_idx.append(i)
                c_idx.append(j)
    t_idx = np.asarray(t_idx)
    c_idx = np.asarray(c_idx)
    targets = walks[:, t_idx].reshape(-1)
    contexts = walks[:, c_idx].reshape(-1)
    valid = (targets > 0) & (contexts > 0)
    return targets[valid], contexts[valid]


class LogUniformSampler:
    """Zipf (log-uniform) negative sampler over [0, range_max)."""

    def __init__(self, range_max: int):
        self.range_max = range_max
        self._log_range = np.log(range_max + 1.0)

    def sample(self, shape, rng: np.random.Generator) -> np.ndarray:
        u = rng.random(shape)
        k = np.exp(u * self._log_range) - 1.0
        return np.minimum(k.astype(np.int64), self.range_max - 1).astype(np.int32)

    def expected_prob(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, np.float64)
        return np.log((ids + 2.0) / (ids + 1.0)) / self._log_range


def skipgram_batches(
    graph: WeightedGraph,
    *,
    walk_length: int = 10,
    window: int = 5,
    num_negatives: int = 5,
    batch_size: int = 1024,
    walks_per_round: int = 256,
    side_info: dict[str, np.ndarray] | None = None,
    seed: int = 0,
):
    """Endless stream of fixed-shape EGES training batches.

    Yields {target [B], context [B, 1+k], label [B, 1+k]} (+ ``target_<name>``
    columns for each side-info array). Seeds are uniform over [1, V) —
    node 0 is the OOV row (``eges/data_loader.py:30``).
    """
    rng = np.random.default_rng(seed)
    sampler = LogUniformSampler(graph.num_nodes)
    buf_t, buf_c = [], []
    n_buf = 0
    while True:
        seeds = rng.integers(1, graph.num_nodes, size=walks_per_round)
        walks = random_walk(graph, seeds, walk_length, rng)
        t, c = skipgram_pairs(walks, window)
        if len(t):
            buf_t.append(t)
            buf_c.append(c)
            n_buf += len(t)
        while n_buf >= batch_size:
            t_all = np.concatenate(buf_t)
            c_all = np.concatenate(buf_c)
            take_t, t_all = t_all[:batch_size], t_all[batch_size:]
            take_c, c_all = c_all[:batch_size], c_all[batch_size:]
            buf_t, buf_c = [t_all], [c_all]
            n_buf = len(t_all)
            negs = sampler.sample((batch_size, num_negatives), rng)
            context = np.concatenate([take_c[:, None], negs], axis=1).astype(np.int32)
            label = np.zeros((batch_size, 1 + num_negatives), np.float32)
            label[:, 0] = 1.0
            batch = {"target": take_t.astype(np.int32), "context": context, "label": label}
            if side_info:
                for name, arr in side_info.items():
                    batch[f"target_{name}"] = arr[take_t]
            yield batch
