"""DLRM through the port's ``models.dlrm.DLRM`` and ``models.tasks``'
CTR loss."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.weights import Leaf

KERNELS = ("sorted_scatter_add",)
FAULTS = ("frozen_state", "half_batch", "k1_altered")
TINY = (dict(vocab_size=26 * 40, cardinalities=[40] * 26),
        dict(batch=64, pool_batches=4, warmup_steps=2, profile_steps=2))
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _towers(model: dict):
    n_feat = model["num_cat"] + 1
    yield "bottom_mlp", model["num_int"], model["bottom_units"]
    yield "top_mlp", n_feat * n_feat + model["embed_dim"], model["top_units"]


def leaves(model: dict) -> list[Leaf]:
    dim = model["embed_dim"]
    out = [Leaf("embedding.embedding", (model["vocab_size"], dim),
                _DTYPES[model["embed_param_dtype"]], "uniform", math.sqrt(3.0 / dim))]
    for prefix, fan_in, units in _towers(model):
        for i, unit in enumerate(units):
            out.append(Leaf(f"{prefix}.Dense_{i}.weight", (unit, fan_in), torch.float32,
                            "normal", 1.0 / math.sqrt(fan_in)))
            out.append(Leaf(f"{prefix}.Dense_{i}.bias", (unit,), torch.float32, "const", 0.0))
            fan_in = unit
    return out


def build(model: dict, device):
    from recommender_tpu_torch.models.dlrm import DLRM
    from recommender_tpu_torch.models.tasks import make_ctr_task

    net = DLRM(vocab_size=model["vocab_size"], embed_dim=model["embed_dim"],
               num_int=model["num_int"], num_cat=model["num_cat"],
               bottom_units=tuple(model["bottom_units"]), top_units=tuple(model["top_units"]),
               embed_param_dtype=_DTYPES[model["embed_param_dtype"]], device=device)
    loss_fn, _ = make_ctr_task(net)
    return net, loss_fn


def forward_macs(model: dict, batch: dict) -> dict:
    """Model work, in the source's layout: the towers' products are bf16,
    the top tower's first layer reading the ``F (F - 1) / 2`` pairs of the
    ``F = num_cat + 1`` features and the bottom output; the pairs' dot
    products of ``embed_dim`` are f32. The port's [F, F] grid computes all
    ``F^2`` products and its top layer reads them all (zeros on and below
    the diagonal): what it does beyond the source's is overhead, not model
    work."""
    n_feat = model["num_cat"] + 1
    pairs = n_feat * (n_feat - 1) // 2
    towers = 0
    for fan_in, units in ((model["num_int"], model["bottom_units"]),
                          (pairs + model["embed_dim"], model["top_units"])):
        for unit in units:
            towers += fan_in * unit
            fan_in = unit
    return {"bf16": towers, "f32": pairs * model["embed_dim"]}


def k1_calls(model: dict, batch: dict) -> list[dict]:
    """One lookup of every id of the batch: its bf16 cotangent rows (a
    bf16 table's) or f32 rows, sorted with ``order``, into the rows of
    the batch's distinct ids."""
    ids = np.asarray(batch["cat_features"])
    update_bytes = 2 if model["embed_param_dtype"] == "bfloat16" else 4
    return [dict(n=ids.size, unique=len(np.unique(ids)), dim=model["embed_dim"],
                 update_bytes=update_bytes, order=True)]


def k2_calls(model: dict, batch: dict) -> list:
    return []
