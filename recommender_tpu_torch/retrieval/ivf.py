"""IVF (clustered) retrieval — the serving lever past brute force.

Port of ``recommender_tpu/retrieval/ivf.py``. Brute-force scoring streams
the whole corpus per query batch; an inverted-file index reads only the
probed clusters: Q × probes × cap rows.

* **k-means on the device** — Lloyd iterations, each a sweep over row
  chunks: one [chunk, D]×[D, C] product per chunk (argmax of
  q·c − ‖c‖²/2 ≡ L2-nearest), sums and counts accumulated with
  ``index_add_`` (JAX: ``segment_sum`` under ``lax.scan``). Empty clusters
  reseed to a perturbed copy of the heaviest cluster's centroid. The
  initial centroids are ``num_clusters`` distinct rows drawn by
  ``torch.randperm`` from a ``torch.Generator`` seeded with ``seed``
  (JAX: ``jax.random.choice``; the draws differ, ``PARITY.md``).
* **Fixed-shape padded buckets + spill**: clusters stored as a dense
  [C, cap, D] int8 block (pad rows carry id −1 and score −inf); rows past
  a bucket's ``cap`` go to a flat spill block that every query scans.
  ``build_ivf``'s packing is the original's numpy, bit for bit.
* **Query**: queries × centroids → top-P probe ids; gather the P padded
  buckets; score the [Q, P, cap] candidates and the spill; one top-k over
  the concatenation. The candidates' int8 products are taken as an f32
  batched product of the int8 values, exact in int32 terms while
  127² · D < 2²⁴ (D ≤ 1,040; wider rows take f64), so the scores equal an
  int32 accumulation bit for bit.
* **k clamp**: a search asks the top-k of P·cap + S candidates; where k is
  larger (``probes=1`` on a small index), the top-k takes them all and
  the row is padded to k with the −1 / −inf sentinels. (JAX's ``_search``
  raises there.)

Quantization follows ``retrieval/quantize.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from recommender_tpu_torch.retrieval.quantize import (
    _device_of,
    _tensor,
    order_by_score,
    quantize_queries,
    quantize_reprs,
)

_EXACT_F32_DIM = 1040  # 127² · D < 2²⁴: an f32 sum of int8 products is exact


@dataclasses.dataclass
class IVFIndex:
    """Array fields: numpy as built, or tensors on the serving device."""

    centroids: np.ndarray    # [C, D] f32 (unit-normed not required)
    bucket_ids: np.ndarray   # [C, cap] int32 item ids, pad = -1
    bucket_q: np.ndarray     # [C, cap, D] int8 quantized rows, pad = 0
    bucket_scale: np.ndarray  # [C, cap] f32 per-row scales, pad = 0
    spill_ids: np.ndarray    # [S] int32
    spill_q: np.ndarray      # [S, D] int8
    spill_scale: np.ndarray  # [S] f32

    @property
    def num_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.bucket_ids.shape[1]

    def nbytes(self) -> int:
        return sum(_nbytes(getattr(self, f.name)) for f in dataclasses.fields(self))

    def to(self, device) -> "IVFIndex":
        """The index with every array a tensor on ``device``."""
        return IVFIndex(**{f.name: _tensor(getattr(self, f.name), device)
                           for f in dataclasses.fields(self)})


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if torch.is_tensor(x) else x.nbytes


def _chunk_rows_for(V: int, num_clusters: int) -> int:
    """Row-chunk size keeping the [chunk, C] similarity block ≤128 MB."""
    return max(1024, min(V, (128 << 20) // max(4 * num_clusters, 1)))


def init_centroids(reprs: torch.Tensor, num_clusters: int, seed: int = 0) -> torch.Tensor:
    """``num_clusters`` distinct rows of ``reprs``, drawn on the CPU by a
    ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    pick = torch.randperm(reprs.shape[0], generator=g)[:num_clusters]
    return reprs[pick.to(reprs.device)]


def lloyd_sweep(cent: torch.Tensor, reprs: torch.Tensor, chunk: int) -> torch.Tensor:
    """One Lloyd iteration over all rows in chunks → the new [C, D]
    centroids; an empty cluster takes the heaviest cluster's centroid plus
    a deterministic offset per cluster id."""
    C, D = cent.shape
    cnorm = 0.5 * torch.sum(cent * cent, dim=1)
    sums = torch.zeros((C, D), dtype=torch.float32, device=reprs.device)
    counts = torch.zeros((C,), dtype=torch.float32, device=reprs.device)
    for s in range(0, reprs.shape[0], chunk):
        rc = reprs[s:s + chunk]
        a = torch.argmax(rc @ cent.T - cnorm[None, :], dim=1)
        sums.index_add_(0, a, rc)
        counts.index_add_(0, a, torch.ones_like(a, dtype=torch.float32))
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    big = new[torch.argmax(counts)]
    jitter = (torch.arange(C, dtype=torch.float32, device=reprs.device)[:, None] % 97.0) * 1e-4
    return torch.where((counts > 0)[:, None], new, big[None, :] + jitter)


def kmeans(reprs, num_clusters: int, iters: int = 10, seed: int = 0,
           chunk_rows: int | None = None, device=None):
    """Lloyd's k-means on ``device`` (default: the tensor's, or the CPU):
    returns ([C, D] f32 centroids, [V] int32 assignments), both numpy. Peak
    memory is one chunk's similarity block, never [V, C]."""
    r = _tensor(reprs, device if device is not None else _device_of(reprs), torch.float32)
    V = r.shape[0]
    chunk = chunk_rows or _chunk_rows_for(V, num_clusters)
    cent = init_centroids(r, num_clusters, seed)
    for _ in range(iters):
        cent = lloyd_sweep(cent, r, chunk)
    assign = assign_clusters(cent, r, chunk_rows=chunk)
    return cent.cpu().numpy(), assign


@torch.no_grad()
def assign_clusters(centroids, reprs, chunk_rows: int | None = None) -> np.ndarray:
    """[V] int32 nearest-centroid assignment on the device of ``reprs`` (the
    CPU for numpy), chunked like ``kmeans``."""
    r = _tensor(reprs, _device_of(reprs), torch.float32)
    cent = _tensor(centroids, r.device, torch.float32)
    chunk = chunk_rows or _chunk_rows_for(r.shape[0], cent.shape[0])
    cnorm = 0.5 * torch.sum(cent * cent, dim=1)
    out = [torch.argmax(r[s:s + chunk] @ cent.T - cnorm[None, :], dim=1)
           for s in range(0, r.shape[0], chunk)]
    return torch.cat(out).to(torch.int32).cpu().numpy()


def build_ivf(
    reprs: np.ndarray,
    num_clusters: int,
    capacity_factor: float = 1.5,
    iters: int = 10,
    seed: int = 0,
    device=None,
) -> IVFIndex:
    """Cluster ``reprs`` [V, D] f32 (k-means on ``device``) and pack the
    int8 index (numpy arrays).

    ``capacity_factor``: bucket cap = factor × mean cluster size (rounded
    up to 8). Items past a bucket's cap spill to the always-scanned flat
    block — memory stays bounded at ~factor × V rows while skewed clusters
    lose nothing."""
    reprs = np.asarray(reprs, np.float32)
    V, D = reprs.shape
    with torch.no_grad():
        cent, assign = kmeans(reprs, num_clusters, iters=iters, seed=seed, device=device)
    cap = int(np.ceil(capacity_factor * V / num_clusters / 8.0) * 8)

    q, scale = quantize_reprs(reprs)
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    start = np.searchsorted(sorted_assign, np.arange(num_clusters))
    end = np.searchsorted(sorted_assign, np.arange(num_clusters) + 1)

    bucket_ids = np.full((num_clusters, cap), -1, np.int32)
    bucket_q = np.zeros((num_clusters, cap, D), np.int8)
    bucket_scale = np.zeros((num_clusters, cap), np.float32)
    spill: list[np.ndarray] = []
    for c in range(num_clusters):
        members = order[start[c]:end[c]]
        take, rest = members[:cap], members[cap:]
        n = len(take)
        bucket_ids[c, :n] = take
        bucket_q[c, :n] = q[take]
        bucket_scale[c, :n] = scale[take]
        if len(rest):
            spill.append(rest)
    spill_idx = (np.concatenate(spill) if spill
                 else np.empty((0,), np.int64))
    # pad the spill to a multiple of 8 rows
    S = int(np.ceil(max(len(spill_idx), 1) / 8.0) * 8)
    spill_ids = np.full((S,), -1, np.int32)
    spill_q = np.zeros((S, D), np.int8)
    spill_scale = np.zeros((S,), np.float32)
    spill_ids[: len(spill_idx)] = spill_idx
    spill_q[: len(spill_idx)] = q[spill_idx]
    spill_scale[: len(spill_idx)] = scale[spill_idx]
    return IVFIndex(cent, bucket_ids, bucket_q, bucket_scale,
                    spill_ids, spill_q, spill_scale)


def _int8_scores(qq: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int8 queries [Q, D] · int8 rows ([N, D] shared, or [Q, N, D] per
    query) → [Q, N] f32 sums, exact (module docstring)."""
    dt = torch.float32 if qq.shape[1] <= _EXACT_F32_DIM else torch.float64
    if rows.dim() == 2:
        acc = qq.to(dt) @ rows.to(dt).T
    else:
        acc = torch.matmul(rows.to(dt), qq.to(dt)[:, :, None])[:, :, 0]
    return acc.to(torch.float32)


@torch.no_grad()
def search_ivf(index: IVFIndex, queries, k: int = 10, probes: int = 8,
               exact_reduce: bool = True):
    """[Q, D] f32 queries → ([Q, k] int32 item ids, [Q, k] f32 scores),
    tensors on the index's device (``IVFIndex.to``; numpy fields search on
    the CPU).

    ``probes`` is the recall/traffic dial: candidates = probes × cap +
    spill; values above the cluster count clamp to it (probes == C is
    exhaustive — the int8 brute-force ranking). ``exact_reduce`` is
    accepted for the JAX signature: the final top-k is always exact.

    When the probed buckets + spill hold fewer than ``k`` real items, the
    tail of a row is the ``-1`` no-candidate sentinel with a -inf score.
    Equal scores come out by the lower id."""
    if not torch.is_tensor(index.centroids):
        index = index.to("cpu")
    device = index.centroids.device
    probes = min(probes, index.num_clusters)
    qf = _tensor(queries, device, torch.float32)
    Q = qf.shape[0]
    cent = index.centroids
    # pass 1: probe selection (tiny [Q, C] product)
    csim = qf @ cent.T - 0.5 * torch.sum(cent * cent, dim=1)[None, :]
    probe = torch.topk(csim, probes, dim=1).indices  # [Q, P]

    # pass 2: score the probed buckets and the spill with the query
    # quantized per row (its scale dropped: rank-invariant per query)
    qq = quantize_queries(qf)
    cand_q = index.bucket_q[probe].reshape(Q, -1, qf.shape[1])  # [Q, P*cap, D] int8
    scores = _int8_scores(qq, cand_q) * index.bucket_scale[probe].reshape(Q, -1)
    ids = index.bucket_ids[probe].reshape(Q, -1)
    spill = _int8_scores(qq, index.spill_q)
    scores = torch.cat([scores, spill * index.spill_scale[None, :]], dim=1)
    ids = torch.cat([ids, index.spill_ids[None, :].expand(Q, -1)], dim=1)
    scores = scores.masked_fill(ids < 0, float("-inf"))  # mask pads

    kk = min(k, scores.shape[1])  # the k clamp: at most P*cap + S candidates
    top, idx = torch.topk(scores, kk, dim=1)
    top, out_ids = order_by_score(top, torch.gather(ids, 1, idx))
    if kk < k:
        out_ids = torch.cat([out_ids, torch.full((Q, k - kk), -1, dtype=out_ids.dtype,
                                                 device=device)], dim=1)
        top = torch.cat([top, torch.full((Q, k - kk), float("-inf"), device=device)], dim=1)
    return out_ids, top
