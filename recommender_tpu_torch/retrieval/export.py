"""Offline serving export: bundles of trained item reprs, and top-k from them.

Port of ``recommender_tpu/retrieval/export.py``. The bundle is the same npz
with the same keys (``item_reprs`` or ``item_reprs_int8`` + ``item_scale``,
the ``ivf_*`` index arrays, ``neighbor_ids`` / ``neighbor_weights``,
``metadata_json``), so a bundle written by either package is served by the
other.

* ``export_serving_bundle`` — write a bundle (f32, int8 with per-row
  scales, and/or with an IVF index whose k-means runs on ``device``);
* ``load_serving_bundle`` — read one (numpy arrays);
* ``device_bundle`` — the arrays that serving reads, as tensors on a
  device, so that a serving loop copies the corpus once;
* ``serve_topk`` — item-to-item top-k: [Q] ids → [Q, k] ids, each query
  item excluded from its own row by over-fetching one candidate, on the
  device the bundle's corpus is on (the CPU for numpy). An int8 bundle
  scores through the int8 product without dequantizing; ``probes > 0``
  serves through the IVF path. The reduction is exact (``exact`` and
  ``recall_target`` are accepted, as off-TPU JAX ignores them).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from recommender_tpu_torch.retrieval.ivf import IVFIndex, build_ivf, search_ivf
from recommender_tpu_torch.retrieval.quantize import (
    _device_of,
    _drop_excluded,
    _tensor,
    quantize_reprs,
    topk_quantized,
    topk_unseen,
)

# the bundle arrays that serving reads (the rest, e.g. neighbor tables, stay on the host)
SERVING_KEYS = ("item_reprs", "item_reprs_int8", "item_scale")


def export_serving_bundle(
    path: str,
    item_reprs: np.ndarray,
    neighbor_ids: np.ndarray | None = None,
    neighbor_weights: np.ndarray | None = None,
    metadata: dict | None = None,
    quantize: bool = False,
    ivf_clusters: int = 0,
    ivf_capacity_factor: float = 1.5,
    device=None,
):
    """``quantize=True`` stores the corpus int8 + per-row f32 scales
    (``retrieval.quantize``) instead of f32 reprs: a ~4x smaller bundle
    and the int8 serving path in ``serve_topk``.

    ``ivf_clusters > 0`` additionally packs an IVF index (``retrieval.ivf``:
    k-means on ``device``, padded capacity buckets + spill) into the
    bundle; ``serve_topk(..., probes=N)`` then serves through it."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    if quantize:
        q, scale = quantize_reprs(item_reprs)
        arrays = {"item_reprs_int8": q, "item_scale": scale}
    else:
        arrays = {"item_reprs": np.asarray(item_reprs, np.float32)}
    if ivf_clusters > 0:
        index = build_ivf(np.asarray(item_reprs, np.float32), ivf_clusters,
                          capacity_factor=ivf_capacity_factor, device=device)
        for f in dataclasses.fields(index):
            arrays[f"ivf_{f.name}"] = getattr(index, f.name)
    if neighbor_ids is not None:
        arrays["neighbor_ids"] = np.asarray(neighbor_ids, np.int32)
        arrays["neighbor_weights"] = np.asarray(neighbor_weights, np.float32)
    arrays["metadata_json"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8
    )
    np.savez_compressed(p, **arrays)


def load_serving_bundle(path: str) -> dict:
    data = np.load(path, allow_pickle=False)
    out = {k: data[k] for k in data.files if k != "metadata_json"}
    out["metadata"] = json.loads(bytes(data["metadata_json"]).decode() or "{}")
    return out


def device_bundle(bundle: dict, device) -> dict:
    """``bundle`` with the arrays that serving reads (the corpus, its
    scales, the IVF index) as tensors on ``device``; the rest as they are."""
    return {
        k: _tensor(v, device) if k in SERVING_KEYS or k.startswith("ivf_") else v
        for k, v in bundle.items()
    }


def serve_topk(bundle: dict, query_item_ids, k: int = 10, exact: bool = False,
               recall_target: float = 0.95, probes: int = 0) -> np.ndarray:
    """Item-to-item retrieval from a bundle: [Q] ids → [Q, k] int32 ids.

    ``probes > 0`` (bundle exported with ``ivf_clusters``): score only the
    probed buckets + spill (the recall dial is ``probes``)."""
    if probes > 0:
        if "ivf_centroids" not in bundle:
            raise ValueError(
                "probes > 0 needs an IVF bundle — export with "
                "export_serving_bundle(..., ivf_clusters=N)"
            )
        return _serve_ivf(bundle, query_item_ids, k, probes)
    if "item_reprs_int8" in bundle:
        return topk_quantized(bundle["item_reprs_int8"], bundle["item_scale"],
                              query_item_ids, k=k)
    reprs = _tensor(bundle["item_reprs"], _device_of(bundle["item_reprs"]), torch.float32)
    ids = _tensor(query_item_ids, reprs.device, torch.int64)
    q = reprs[ids]
    # each query item excluded from its own row by over-fetching one candidate
    idx = topk_unseen(lambda a, b: q @ reprs[a:b].T, reprs.shape[0], len(ids), ids[:, None], k,
                      id_lists=True)
    return idx.to(torch.int32).cpu().numpy()


def _serve_ivf(bundle: dict, query_item_ids, k: int, probes: int) -> np.ndarray:
    """IVF serving path: query reprs looked up from the flat corpus
    (dequantized if int8), self excluded by over-fetch."""
    index = IVFIndex(**{f.name: bundle[f"ivf_{f.name}"] for f in dataclasses.fields(IVFIndex)})
    if not torch.is_tensor(index.centroids):
        index = index.to("cpu")
    device = index.centroids.device
    ids = _tensor(query_item_ids, device, torch.int64)
    if "item_reprs" in bundle:
        q = _tensor(bundle["item_reprs"], device, torch.float32)[ids]
    else:
        rows = _tensor(bundle["item_reprs_int8"], device)[ids]
        q = rows.to(torch.float32) * _tensor(bundle["item_scale"], device)[ids][:, None]
    cand, _ = search_ivf(index, q, k=k + 1, probes=probes)
    return _drop_excluded(cand, ids[:, None], k).to(torch.int32).cpu().numpy()
