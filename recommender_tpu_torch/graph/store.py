"""A copy of ``recommender_tpu/graph/store.py`` (the JAX package's
``graph`` and ``data`` namespaces import jax on load); for the same seed it
returns the same arrays, bit for bit (``tests/test_torch_graph_data.py``).

Host-side weighted graph store (CSR) with O(1) alias sampling.

TPU-native replacement for the DGL C++ graph kernels the reference leans on
(``eges/util.py:116-132`` graph build, ``eges/data_loader.py:31-32`` weighted
``random_walk``, ``pinsage/train/data_loader.py`` samplers — SURVEY.md §2.7
item 3). The store is plain numpy arrays:

* ``indptr``/``indices``/``weights`` — standard CSR over directed edges;
* ``alias_prob``/``alias_idx`` — per-node Walker alias tables aligned with
  the CSR neighbor lists, built once in O(E), giving O(1) *vectorized*
  weighted neighbor draws for thousands of walkers at a time (the
  reference samples one walk per Python generator step).

Device code never sees the graph — samplers emit fixed-shape int batches.
"""
from __future__ import annotations

import numpy as np


class WeightedGraph:
    def __init__(self, indptr, indices, weights, num_nodes, use_native=None):
        self.indptr = indptr
        self.indices = indices
        self.weights = weights
        self.num_nodes = num_nodes
        self.degrees = np.diff(indptr)
        from recommender_tpu_torch.graph import native

        if use_native is None:
            use_native = native.is_available()
        self.native = use_native and native.is_available()
        if self.native:
            self.alias_prob, self.alias_idx = native.build_alias_tables(
                indptr, weights
            )
        else:
            self.alias_prob, self.alias_idx = _build_alias_tables(
                indptr, weights.astype(np.float64)
            )

    @staticmethod
    def from_edges(src, dst, weight=None, num_nodes=None) -> "WeightedGraph":
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        weight = (
            np.ones(len(src), np.float32)
            if weight is None
            else np.asarray(weight, np.float32)
        )
        if num_nodes is None:
            num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        order = np.argsort(src, kind="stable")
        src, dst, weight = src[order], dst[order], weight[order]
        counts = np.bincount(src, minlength=num_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return WeightedGraph(indptr, dst.astype(np.int32), weight, num_nodes)

    def neighbors(self, v: int):
        s, e = self.indptr[v], self.indptr[v + 1]
        return self.indices[s:e], self.weights[s:e]

    def sample_neighbors(self, nodes: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """One weighted neighbor per node, vectorized. Dead ends return -1."""
        nodes = np.asarray(nodes, np.int64)
        deg = self.degrees[nodes]
        u1 = rng.random(len(nodes))
        u2 = rng.random(len(nodes))
        j = np.minimum((u1 * np.maximum(deg, 1)).astype(np.int64), np.maximum(deg - 1, 0))
        # dead-end nodes (deg 0) can index past the edge arrays; clamp — their
        # result is discarded by the deg>0 mask below
        pos = np.minimum(self.indptr[nodes] + j, len(self.indices) - 1)
        take_alias = u2 >= self.alias_prob[pos]
        alias_pos = np.minimum(
            self.indptr[nodes] + self.alias_idx[pos], len(self.indices) - 1
        )
        chosen = np.where(take_alias, self.indices[alias_pos], self.indices[pos])
        return np.where(deg > 0, chosen, -1).astype(np.int32)


def _build_alias_tables(indptr, weights):
    """Walker alias method per CSR segment (positions local to each node)."""
    n_edges = len(weights)
    prob = np.ones(n_edges, np.float32)
    alias = np.zeros(n_edges, np.int32)
    for v in range(len(indptr) - 1):
        s, e = indptr[v], indptr[v + 1]
        d = e - s
        if d == 0:
            continue
        w = weights[s:e]
        total = w.sum()
        if total <= 0:
            continue
        p = w * d / total  # mean 1
        small = [i for i in range(d) if p[i] < 1.0]
        large = [i for i in range(d) if p[i] >= 1.0]
        p = p.copy()
        while small and large:
            sm = small.pop()
            lg = large.pop()
            prob[s + sm] = p[sm]
            alias[s + sm] = lg
            p[lg] = p[lg] - (1.0 - p[sm])
            (small if p[lg] < 1.0 else large).append(lg)
        for i in large + small:
            prob[s + i] = 1.0
            alias[s + i] = i
    return prob, alias
