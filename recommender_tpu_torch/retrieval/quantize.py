"""Int8-quantized corpus scoring, and the blocked top-k that every scoring
path of the port shares.

Port of ``recommender_tpu/retrieval/quantize.py``. Scheme: symmetric
per-row max-abs quantization,

    q_v = round(127 · r_v / s_v),   s_v = max|r_v| / 127

Scores factor as ``(q_u · q_v) · s_u · s_v``; the query scale is a positive
constant per query row and cannot change its top-k order, so serving
computes the int8 product in int32, applies the per-ITEM scale column-wise
in f32, and never dequantizes the corpus.

* ``quantize_reprs`` — a numpy copy of the original (bit for bit).
* ``int8_product`` — the int8 × int8 → int32 product through the library
  call ``torch._int_mm``. On CUDA that call refuses a first dimension of
  16 or less and a contraction or output dimension that is not a multiple
  of 8, so the wrapper pads the queries to at least 17 rows and the
  contraction and the corpus to multiples of 8 with zeros, and cuts the
  padding off the result: padded corpus rows never reach a top-k. The
  int32 sums are exact, so ``scores_int8`` equals JAX's ``_scores_int8``
  bit for bit.
* ``topk_ids`` — exact top-k over a corpus scored in blocks of rows: each
  block's scores (at most ``SCORE_BLOCK_BYTES`` of f32) are reduced to
  their top-k, merged with the running top-k, and freed, so a [Q, V]
  score matrix never exists (XLA fuses the product into the reduction;
  eager PyTorch would materialize it: 8 GiB of f32 at Q 1,024 × V 2M).
  Rows come out by score, ties by the lower id, as ``lax.top_k`` orders
  them. ``approx_max_k``, the JAX serving default, is a TPU reduction;
  here ``exact=False`` takes the exact one (``PARITY.md``), as JAX does
  off the TPU.
* ``_drop_excluded`` — the over-fetch exclusion filter (scatter-free).

Inputs may be numpy arrays or tensors; the work runs on the device of the
corpus tensor (the CPU for numpy), and the ids come back as int32 numpy.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.nn import functional as F

# f32 scores one block of corpus rows may hold ([Q, rows] f32)
SCORE_BLOCK_BYTES = 1 << 30


def quantize_reprs(reprs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """[V, D] f32 → ([V, D] int8, [V] f32 per-row scales).

    Zero rows get scale 0 (their scores are exactly 0 — same as f32)."""
    r = np.asarray(reprs, np.float32)
    amax = np.abs(r).max(axis=1)
    scale = amax / 127.0
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint(r / safe[:, None]), -127, 127).astype(np.int8)
    q[scale == 0] = 0
    return q, scale.astype(np.float32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[Q, D] int8 · ([V, D] int8)ᵀ → [Q, V] int32, exact
    (``torch._int_mm`` on zero-padded operands; module docstring)."""
    q, d = a.shape
    v = b.shape[0]
    qp, dp, vp = max(q, 17), _round_up(d, 8), _round_up(v, 8)
    if (qp, dp) != (q, d):
        a = F.pad(a, (0, dp - d, 0, qp - q))
    if (vp, dp) != (v, d):
        b = F.pad(b, (0, dp - d, 0, vp - v))
    out = torch._int_mm(a.contiguous(), b.contiguous().t())
    return out[:q, :v]


def scores_int8(q_queries: torch.Tensor, q_items: torch.Tensor,
                item_scale: torch.Tensor) -> torch.Tensor:
    """[Q, D] int8 × [V, D] int8 → [Q, V] f32 item-scaled scores (JAX's
    ``_scores_int8``): the query scale is dropped (rank-invariant per
    query), ``item_scale`` re-weights columns."""
    return int8_product(q_queries, q_items).to(torch.float32) * item_scale[None, :]


def quantize_queries(qf: torch.Tensor) -> torch.Tensor:
    """[Q, D] f32 → [Q, D] int8, per row, the scale dropped (the query
    side of ``ivf._search``)."""
    qmax = torch.amax(torch.abs(qf), dim=1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, which rounds some quotients apart from the CPU's
    step = torch.clamp(qmax / qmax.new_tensor(127.0), min=1e-30)
    return torch.clamp(torch.round(qf / step), -127, 127).to(torch.int8)


def block_rows(num_queries: int, num_items: int) -> int:
    """Corpus rows a scoring block takes: ``SCORE_BLOCK_BYTES`` of f32
    scores, a multiple of 8 (``int8_product``'s alignment), at least 8."""
    rows = SCORE_BLOCK_BYTES // (4 * max(num_queries, 1))
    return max(8, min(_round_up(num_items, 8), rows // 8 * 8))


def order_by_score(vals: torch.Tensor, ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reorder each row's candidates by ``vals`` descending, equal values
    by the lower id (``lax.top_k``'s order over corpus positions)."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    vals, ids = torch.gather(vals, 1, by_id), torch.gather(ids, 1, by_id)
    by_val = torch.argsort(vals, dim=1, descending=True, stable=True)
    return torch.gather(vals, 1, by_val), torch.gather(ids, 1, by_val)


def topk_ids(score_block: Callable[[int, int], torch.Tensor], num_items: int,
             num_queries: int, kk: int, rows: int | None = None) -> torch.Tensor:
    """[Q, kk] int64 ids of the ``kk`` best of ``num_items`` columns, where
    ``score_block(start, stop)`` gives the [Q, stop - start] f32 scores of
    corpus rows ``start:stop``; blocks of ``rows`` (``block_rows``)."""
    rows = rows or block_rows(num_queries, num_items)
    best_vals = best_ids = None
    for start in range(0, num_items, rows):
        stop = min(start + rows, num_items)
        sim = score_block(start, stop)
        vals, idx = torch.topk(sim, min(kk, stop - start), dim=1)
        idx = idx + start
        del sim
        if best_vals is not None:
            vals = torch.cat([best_vals, vals], dim=1)
            idx = torch.cat([best_ids, idx], dim=1)
            vals, pick = torch.topk(vals, min(kk, vals.shape[1]), dim=1)
            idx = torch.gather(idx, 1, pick)
        best_vals, best_ids = vals, idx
    return order_by_score(best_vals, best_ids)[1]


def _drop_excluded(idx: torch.Tensor, excluded: torch.Tensor, k: int) -> torch.Tensor:
    """[Q, k+pad] candidate ids → first ``k`` per row not in ``excluded``
    ([Q, E]). Always returns width ``k``: a candidate list narrower than
    ``k`` (over-fetch clamped to a corpus smaller than k) is padded with
    the ``-1`` no-candidate sentinel, which sorts after real kept ids but
    before excluded ones. Score order is preserved (stable argsort on the
    keep flag). Filtering the candidate list, never writing -inf into
    the score matrix, keeps the exclusion off the scoring path."""
    if idx.shape[1] < k:
        idx = torch.cat([idx, torch.full((idx.shape[0], k - idx.shape[1]), -1,
                                         dtype=idx.dtype, device=idx.device)], dim=1)
    excluded = excluded.to(idx.dtype)
    keep = ~(idx[:, :, None] == excluded[:, None, :]).any(-1)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    return torch.gather(idx, 1, order[:, :k])


def topk_unseen(score_block: Callable[[int, int], torch.Tensor], num_items: int,
                num_queries: int, seen: torch.Tensor, k: int, id_lists: bool) -> torch.Tensor:
    """[Q, k] ids of the best unseen columns. ``seen``: [Q, S] padded id
    lists (pad -1), excluded by over-fetching k + S candidates (clamped to
    the corpus) and ``_drop_excluded``; or a [Q, V] bool mask, whose
    columns score -inf in each block."""
    if id_lists:
        kk = min(k + seen.shape[1], num_items)
        return _drop_excluded(topk_ids(score_block, num_items, num_queries, kk), seen, k)
    return topk_ids(lambda a, b: score_block(a, b).masked_fill(seen[:, a:b], float("-inf")),
                    num_items, num_queries, k)


def _tensor(x, device, dtype=None) -> torch.Tensor:
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype)


def _device_of(x) -> torch.device:
    return x.device if torch.is_tensor(x) else torch.device("cpu")


def seen_tensor(seen_block, id_lists: bool, device) -> torch.Tensor:
    """A block of ``seen`` rows on ``device``: int id lists, or a bool mask
    (dense or scipy sparse)."""
    if id_lists:
        return _tensor(np.asarray(seen_block), device)
    if hasattr(seen_block, "toarray"):
        seen_block = seen_block.toarray()
    return _tensor(np.asarray(seen_block, bool), device)


def _int8_corpus(q_items, item_scale):
    device = _device_of(q_items)
    return _tensor(q_items, device, torch.int8), _tensor(item_scale, device, torch.float32)


def recommend_topk_quantized(
    q_items,
    item_scale,
    latest_items: np.ndarray,
    seen,
    k: int = 10,
    batch_size: int = 1024,
    exact: bool = False,
    recall_target: float = 0.95,
    seen_format: str = "auto",
) -> np.ndarray:
    """Int8 counterpart of ``retrieval.eval.recommend_topk``: [U] users'
    latest item ids → [U, k] recommendations, seen items excluded, scored
    from the quantized corpus.

    ``seen``: [U, V] bool (dense or scipy sparse) or padded [U, S] seen-id
    lists (pad -1); ``seen_format``: 'mask' | 'ids' | 'auto'
    (``retrieval.eval.resolve_seen_format``). ``exact`` and
    ``recall_target`` are accepted for the JAX signature; the reduction is
    always exact."""
    from recommender_tpu_torch.retrieval.eval import resolve_seen_format

    qi, sc = _int8_corpus(q_items, item_scale)
    device, V = qi.device, qi.shape[0]
    id_lists = resolve_seen_format(seen, V, seen_format)
    out = []
    U = len(latest_items)
    for s in range(0, U, batch_size):
        users = slice(s, min(s + batch_size, U))
        qq = qi[_tensor(np.asarray(latest_items[users]), device, torch.int64)]
        idx = topk_unseen(lambda a, b: scores_int8(qq, qi[a:b], sc[a:b]), V, len(qq),
                          seen_tensor(seen[users], id_lists, device), k, id_lists)
        out.append(idx.to(torch.int32).cpu().numpy())
    return np.concatenate(out, axis=0)


def topk_quantized(
    q_items,
    item_scale,
    query_ids: np.ndarray,
    k: int = 10,
    mask_self: bool = True,
    exact: bool = False,
    recall_target: float = 0.95,
) -> np.ndarray:
    """Item-to-item top-k over an int8 corpus: [Q] ids → [Q, k] ids, each
    query item excluded from its own row (``mask_self``) by over-fetching
    one candidate. ``exact`` / ``recall_target``: as in
    ``recommend_topk_quantized``."""
    qi, sc = _int8_corpus(q_items, item_scale)
    V = qi.shape[0]
    ids = _tensor(query_ids, qi.device, torch.int64)
    qq = qi[ids]

    def score(a, b):
        return scores_int8(qq, qi[a:b], sc[a:b])

    if mask_self:
        idx = topk_unseen(score, V, len(ids), ids[:, None], k, id_lists=True)
    else:
        idx = topk_ids(score, V, len(ids), min(k, V))
    return idx.to(torch.int32).cpu().numpy()
