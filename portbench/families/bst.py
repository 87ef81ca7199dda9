"""BST through the port's ``models.bst.BST`` with K2 (``use_flash``) on
every block, and ``models.tasks``' CTR loss."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.weights import Leaf

KERNELS = ("sorted_scatter_add", "flash_attention", "flash_attention_bwd")
FAULTS = ("frozen_state", "half_batch", "k1_altered", "k2_altered")
TINY = (dict(item_vocab=500, cat_vocab=20, max_len=32),
        dict(batch=32, pool_batches=4, history=20, warmup_steps=2, profile_steps=2))
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dims(model: dict):
    dim = model["item_dim"] + model["cat_dim"]
    heads = model["num_heads"]
    return dim, heads, dim // heads, dim * model["ffn_mult"]


def leaves(model: dict) -> list[Leaf]:
    dim, heads, head_dim, hidden = _dims(model)
    table = _DTYPES[model["embed_param_dtype"]]
    f32 = torch.float32
    out = [
        Leaf("item_embedding.embedding", (model["item_vocab"], model["item_dim"]), table,
             "uniform", math.sqrt(3.0 / model["item_dim"])),
        Leaf("cat_embedding.embedding", (model["cat_vocab"], model["cat_dim"]), table,
             "uniform", math.sqrt(3.0 / model["cat_dim"])),
        Leaf("positions.embedding", (model["max_len"], dim), f32, "normal", 1.0 / math.sqrt(dim)),
    ]
    for b in range(model["num_blocks"]):
        p = f"block_{b}."
        out += [
            Leaf(p + "qkv.kernel", (dim, 3, heads, head_dim), f32, "normal", 1.0 / math.sqrt(dim)),
            Leaf(p + "qkv.bias", (3, heads, head_dim), f32, "const", 0.0),
            Leaf(p + "out.kernel", (heads, head_dim, dim), f32, "normal",
                 1.0 / math.sqrt(heads * head_dim)),
            Leaf(p + "out.bias", (dim,), f32, "const", 0.0),
            Leaf(p + "Dense_0.weight", (hidden, dim), f32, "normal", 1.0 / math.sqrt(dim)),
            Leaf(p + "Dense_0.bias", (hidden,), f32, "const", 0.0),
            Leaf(p + "Dense_1.weight", (dim, hidden), f32, "normal", 1.0 / math.sqrt(hidden)),
            Leaf(p + "Dense_1.bias", (dim,), f32, "const", 0.0),
        ]
        for ln in ("LayerNorm_0", "LayerNorm_1"):
            out += [Leaf(p + ln + ".weight", (dim,), f32, "const", 1.0),
                    Leaf(p + ln + ".bias", (dim,), f32, "const", 0.0)]
    fan_in = 2 * dim
    out += [Leaf("mlp.BatchNorm_0.weight", (fan_in,), f32, "const", 1.0),
            Leaf("mlp.BatchNorm_0.bias", (fan_in,), f32, "const", 0.0)]
    for i, unit in enumerate(model["mlp_units"]):
        out += [Leaf(f"mlp.Dense_{i}.weight", (unit, fan_in), f32, "normal", 1.0 / math.sqrt(fan_in)),
                Leaf(f"mlp.Dense_{i}.bias", (unit,), f32, "const", 0.0)]
        fan_in = unit
    return out


def build(model: dict, device):
    from recommender_tpu_torch.models.bst import BST
    from recommender_tpu_torch.models.tasks import make_ctr_task

    net = BST(item_vocab=model["item_vocab"], cat_vocab=model["cat_vocab"],
              item_dim=model["item_dim"], cat_dim=model["cat_dim"],
              mlp_units=tuple(model["mlp_units"]),
              embed_param_dtype=_DTYPES[model["embed_param_dtype"]],
              num_heads=model["num_heads"], num_blocks=model["num_blocks"],
              ffn_mult=model["ffn_mult"], max_len=model["max_len"], device=device)
    for blk in net.blocks():
        blk.use_flash = model["use_flash"]
    loss_fn, _ = make_ctr_task(net)
    return net, loss_fn


def forward_macs(model: dict, batch: dict) -> dict:
    """Model work a row of ``batch``, averaged over its rows: a row's valid
    positions (its history's non-pad steps and the target) through the
    blocks, each with its qkv, out and feed-forward products and per head
    the valid x valid scores and their weighted sum of values, all f32
    (TF32 off; K2 at f32 accuracy); then the head's bf16 tower. The pads'
    positions and pairs the port computes are overhead, not model work."""
    dim, heads, head_dim, hidden = _dims(model)
    valid = (np.asarray(batch["pos_his_item"]) != 0).sum(axis=1).astype(np.float64) + 1
    per_position = dim * 3 * dim + dim * dim + 2 * dim * hidden
    blocks = model["num_blocks"] * (valid * per_position + 2 * heads * valid ** 2 * head_dim)
    head, fan_in = 0, 2 * dim
    for unit in model["mlp_units"]:
        head += fan_in * unit
        fan_in = unit
    return {"f32": float(blocks.mean()), "bf16": head}


def k1_calls(model: dict, batch: dict) -> list[dict]:
    """One lookup per table and id set: the target's and the history's
    item and category ids (the pad id 0 included; f32 tables: f32
    cotangent rows)."""
    update_bytes = 2 if model["embed_param_dtype"] == "bfloat16" else 4
    out = []
    for key, dim in (("target_item", "item_dim"), ("target_cat", "cat_dim"),
                     ("pos_his_item", "item_dim"), ("pos_his_cat", "cat_dim")):
        ids = np.asarray(batch[key])
        out.append(dict(n=ids.size, unique=len(np.unique(ids)), dim=model[dim],
                        update_bytes=update_bytes, order=True))
    return out


def k2_calls(model: dict, batch: dict) -> list:
    """Every block attends over [history ∥ target], the target always valid."""
    his = np.asarray(batch["pos_his_item"])
    valid = np.concatenate([his != 0, np.ones((his.shape[0], 1), bool)], axis=1)
    _, heads, head_dim, _ = _dims(model)
    return [(valid, heads, head_dim)] * model["num_blocks"]
