"""Retrieval: full-corpus inference, top-k recommendation, hit-rate.

Port of ``recommender_tpu/retrieval/eval.py``:

* ``full_corpus_reprs``  — every item id through sampled blocks → reprs
  (the model's eval forward under ``torch.no_grad``, on its device);
* ``recommend_topk``     — each user's latest item repr vs all items,
  seen items excluded, exact top-k (``quantize.topk_ids``: the corpus
  scored in blocks with a running top-k, so no [U, V] score matrix is
  held);
* ``recommend_topk_from_queries`` — the same for arbitrary query vectors
  (the two-tower user reprs);
* ``hit_rate``           — any-hit mean over users.

``mesh=`` is data-parallel serving, as in JAX: each data rank computes its
share of every batch's rows (the corpus blocks' nodes, or the scoring
batch's users) and the shares are all-gathered over the data group, so
every rank returns the whole result. ``exact=False`` takes the exact
reduction (``PARITY.md``). Array inputs may be numpy or tensors: the scoring runs on
the device of ``item_reprs`` when it is a tensor, else on ``device``
(the CPU by default).
"""
from __future__ import annotations

import numpy as np
import torch

from recommender_tpu_torch.core import distributed
from recommender_tpu_torch.retrieval.quantize import _tensor, seen_tensor, topk_unseen


def _gather_data(part: torch.Tensor, mesh) -> torch.Tensor:
    """Every data rank's ``part`` (equal shapes), concatenated in data order."""
    whole = torch.empty((part.shape[0] * mesh.data, *part.shape[1:]), dtype=part.dtype,
                        device=part.device)
    return distributed.all_gather_into_tensor(whole, part.contiguous(), group=mesh.data_group)


def _data_rows(n: int, mesh) -> slice:
    """This data rank's share of ``n`` rows (``n`` divisible by the axis)."""
    share = n // mesh.data
    return slice(mesh.data_index * share, (mesh.data_index + 1) * share)


def full_corpus_reprs(
    model, graph, rng: np.random.Generator, batch_size: int = 512, mesh=None, **sampler_kw
) -> np.ndarray:
    """Compute reprs for every item (PinSage: fresh sampled blocks per
    batch; the last batch padded with item 0 to ``batch_size``, as in JAX,
    so the same ``rng`` draws the same blocks). ``mesh``: each data rank
    takes its share of each batch's nodes (``batch_size`` divisible by the
    data axis); every rank draws the same blocks from the same ``rng``."""
    from recommender_tpu_torch.graph.bipartite import sample_block_batch

    sharded = mesh is not None and mesh.data > 1
    if sharded and batch_size % mesh.data:
        raise ValueError(
            f"batch_size {batch_size} must divide by the data axis ({mesh.data}) for "
            "sharded corpus inference"
        )
    device = next(model.parameters()).device
    model.eval()
    out = []
    n = graph.num_items
    with torch.no_grad():
        for s in range(0, n, batch_size):
            ids = np.arange(s, min(s + batch_size, n), dtype=np.int32)
            pad = batch_size - len(ids)
            if pad:
                ids = np.concatenate([ids, np.zeros(pad, np.int32)])
            block = sample_block_batch(graph, ids, rng, **sampler_kw).as_dict()
            if sharded:  # every leaf's leading dim is a multiple of the nodes
                block = {k: v[_data_rows(len(v), mesh)] for k, v in block.items()}
            block = {k: torch.as_tensor(v, device=device) for k, v in block.items()}
            reprs = model.get_repr(block)
            if sharded:
                reprs = _gather_data(reprs, mesh)
            out.append(reprs.cpu().numpy()[: batch_size - pad])
    return np.concatenate(out, axis=0)


def resolve_seen_format(seen, num_items: int, seen_format: str = "auto") -> bool:
    """True ⇔ ``seen`` is padded per-user id lists, False ⇔ a [U, V] mask.

    ``seen_format='auto'`` sniffs by dtype/ndim attributes: bool / sparse
    (``toarray``) → mask; 2-D integer → id lists. A 2-D integer array whose
    width equals the corpus size is ambiguous (a 0/1 int mask or S == V id
    lists) and is rejected: pass ``seen_format`` explicitly."""
    if seen_format in ("mask", "ids"):
        return seen_format == "ids"
    if seen_format != "auto":
        raise ValueError(f"seen_format must be 'auto'|'mask'|'ids', got {seen_format!r}")
    if hasattr(seen, "toarray"):  # scipy sparse: always a mask
        return False
    dtype = getattr(seen, "dtype", None)
    ndim = getattr(seen, "ndim", None)
    if dtype is None or ndim is None:
        a = np.asarray(seen)
        dtype, ndim = a.dtype, a.ndim
        seen = a
    id_lists = bool(np.issubdtype(dtype, np.integer) and ndim == 2)
    if id_lists and seen.shape[1] == num_items:
        raise ValueError(
            f"ambiguous integer [U, {num_items}] `seen` with width == corpus "
            "size: could be a 0/1 mask or S==V padded id lists — pass "
            "seen_format='mask' or seen_format='ids' explicitly"
        )
    return id_lists


def recommend_topk(
    item_reprs,
    latest_items: np.ndarray,
    seen,
    k: int = 10,
    batch_size: int = 1024,
    mesh=None,
    exact: bool = True,
    seen_format: str = "auto",
    device=None,
) -> np.ndarray:
    """[U] users' latest item ids → [U, k] recommended items (the PinSage
    protocol: the query vector is the user's latest item's repr).

    ``seen``: items already interacted, excluded — either a [U, V] bool
    matrix (dense or scipy sparse) or a [U, S] int array of padded
    per-user seen-id lists (pad = -1). ``seen_format``: 'mask' | 'ids' |
    'auto' (``resolve_seen_format``)."""
    if torch.is_tensor(item_reprs):
        queries = item_reprs[_tensor(latest_items, item_reprs.device, torch.int64)]
    else:
        queries = np.asarray(item_reprs)[np.asarray(latest_items)]
    return recommend_topk_from_queries(
        queries, item_reprs, seen, k=k, batch_size=batch_size, mesh=mesh,
        exact=exact, seen_format=seen_format, device=device,
    )


def recommend_topk_from_queries(
    query_reprs,
    item_reprs,
    seen,
    k: int = 10,
    batch_size: int = 1024,
    mesh=None,
    exact: bool = True,
    seen_format: str = "auto",
    device=None,
) -> np.ndarray:
    """[U, D] arbitrary query vectors → [U, k] recommended items — the
    general form behind ``recommend_topk``, used directly by dual-encoder
    retrieval (the two-tower user reprs). Same ``seen`` contract; with id
    lists, when fewer than k unseen candidates exist the tail degrades to
    seen ids. ``mesh``: each data rank scores its share of each batch's
    users (the tail batch padded with its last user to divide evenly)."""
    sharded = mesh is not None and mesh.data > 1
    if torch.is_tensor(item_reprs):
        device = item_reprs.device
    device = torch.device(device or "cpu")
    items = _tensor(item_reprs, device, torch.float32)
    id_lists = resolve_seen_format(seen, items.shape[0], seen_format)
    out = []
    U = len(query_reprs)
    for s in range(0, U, batch_size):
        users = np.arange(s, min(s + batch_size, U))
        n_real = len(users)
        if sharded:
            users = np.concatenate([users, np.full(-n_real % mesh.data, users[-1])])
            users = users[_data_rows(len(users), mesh)]
        q = _tensor(query_reprs[users], device, torch.float32)
        idx = topk_unseen(lambda a, b: q @ items[a:b].T, items.shape[0], len(q),
                          seen_tensor(seen[users], id_lists, device), k, id_lists)
        if sharded:
            idx = _gather_data(idx, mesh)[:n_real]
        out.append(idx.to(torch.int32).cpu().numpy())
    return np.concatenate(out, axis=0)


def hit_rate(recommendations: np.ndarray, ground_truth) -> float:
    """[U, k] recs vs [U, V] 0/1 ground truth → mean any-hit."""
    U, K = recommendations.shape
    user_idx = np.repeat(np.arange(U), K)
    item_idx = recommendations.reshape(-1)
    rel = np.asarray(ground_truth[user_idx, item_idx]).reshape(U, K)
    return float(rel.any(axis=1).mean())
