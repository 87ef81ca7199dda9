"""BST (Chen et al., 2019, arXiv:1905.06874) as the configuration states
it: item and category embeddings of the history and the target, summed
with learned positions; post-LN transformer blocks (multi-head attention
in which padded history steps are masked out as keys, a ReLU feed-forward
network, each with a residual and a LayerNorm of epsilon 1e-6), computed
in f32 with TF32 off; the head takes [the target position's output ∥ the
mean of the valid history outputs] through an input BatchNorm and a bf16
tower with a sigmoid.

The attention scores of a whole batch at a history of 1,000 would take
16 GB a block, so ``loss_and_grads`` runs the blocks over the batch in
groups of rows: a first pass without gradients gives the head's input,
the head's loss and its gradient are taken over the whole batch (the
BatchNorm couples rows), and a second pass takes each group's gradient
from the head input's cotangent.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from portbench.reference.common import Precision, bce, gather, tower

SCORE_BYTES = 2 << 30  # the f32 scores of one group of rows, per block


def _block(P: dict, name: str, x: torch.Tensor, valid: torch.Tensor, heads: int) -> torch.Tensor:
    p = lambda k: P[f"{name}.{k}"]  # noqa: E731
    q, k, v = (torch.tensordot(x, p("qkv.kernel"), dims=1) + p("qkv.bias")).unbind(dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    s = torch.where(valid[:, None, None, :] > 0, s, -1e30)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    dim = x.shape[-1]
    x = F.layer_norm(x + torch.tensordot(o, p("out.kernel"), dims=2) + p("out.bias"), (dim,),
                     p("LayerNorm_0.weight"), p("LayerNorm_0.bias"), eps=1e-6)
    f = F.linear(F.relu(F.linear(x, p("Dense_0.weight"), p("Dense_0.bias"))),
                 p("Dense_1.weight"), p("Dense_1.bias"))
    return F.layer_norm(x + f, (dim,), p("LayerNorm_1.weight"), p("LayerNorm_1.bias"), eps=1e-6)


def features(P: dict, store: dict, batch: dict, rows: slice, model: dict,
             prec: Precision) -> torch.Tensor:
    """The head's input [rows, 2 D] for a group of rows."""
    his_item, his_cat = batch["pos_his_item"][rows], batch["pos_his_cat"][rows]
    mask = (his_item != 0).to(torch.float32)
    item, cat = "item_embedding.embedding", "cat_embedding.embedding"

    def embed(i, c):
        return torch.cat([gather(P[item], i, store[item], prec),
                          gather(P[cat], c, store[cat], prec)], dim=-1)

    target = embed(batch["target_item"][rows], batch["target_cat"][rows])
    his = embed(his_item, his_cat)
    b, t = mask.shape
    valid = torch.cat([mask, mask.new_ones((b, 1))], dim=1)
    x = torch.cat([his, target[:, None, :]], dim=1) + P["positions.embedding"][: t + 1][None]
    with prec.products():
        for i in range(model["num_blocks"]):
            x = _block(P, f"block_{i}", x, valid, model["num_heads"])
    m = mask[..., None]
    pooled = torch.sum(x[:, :-1] * m, dim=1) / torch.clamp(torch.sum(m, dim=1), min=1.0)
    return torch.cat([x[:, -1], pooled], dim=-1)


def head_loss(P: dict, h: torch.Tensor, label: torch.Tensor, model: dict,
              prec: Precision) -> torch.Tensor:
    prob = tower(P, "mlp", h, len(model["mlp_units"]), prec, final=torch.sigmoid,
                 batch_norm=True)
    return torch.mean(bce(prob.squeeze(-1), label))


def groups(batch: dict, model: dict) -> list[slice]:
    b, t = batch["pos_his_item"].shape
    n = max(1, SCORE_BYTES // (model["num_heads"] * (t + 1) ** 2 * 4))
    return [slice(a, min(a + n, b)) for a in range(0, b, n)]


def loss_and_grads(P: dict, store: dict, batch: dict, model: dict,
                   prec: Precision) -> tuple[torch.Tensor, dict]:
    for t in P.values():
        t.grad = None
    parts = groups(batch, model)
    with torch.no_grad():
        h = torch.cat([features(P, store, batch, rows, model, prec) for rows in parts])
    h.requires_grad_(True)
    value = head_loss(P, h, batch["label"], model, prec)
    value.backward()
    for rows in parts:
        features(P, store, batch, rows, model, prec).backward(h.grad[rows])
    return value.detach(), {n: t.grad for n, t in P.items()}
