"""DLRM (Naumov et al., 2019, arXiv:1906.00091) as the configuration
states it: one shared table looked up for ``num_cat`` categorical
features, a bottom tower on the ``num_int`` dense features whose output
is one more feature, the pairwise dot products of the ``num_cat + 1``
features (the upper triangle without the diagonal, laid out as a [F, F]
grid with zeros below it), a top tower on [products ∥ bottom output] and a
sigmoid. Towers compute in bf16 with f32 parameters; the products take
bf16-rounded features and sum in f32.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from portbench.reference.common import Precision, bce, gather, tower


def loss(P: dict, store: dict, batch: dict, model: dict, prec: Precision) -> torch.Tensor:
    """The batch's mean loss, differentiable in ``P``."""
    num_int, num_cat = model["num_int"], model["num_cat"]
    ints = batch["int_features"].reshape(-1, num_int)
    cats = batch["cat_features"].reshape(-1, num_cat)
    table = "embedding.embedding"
    with prec.products():
        emb = gather(P[table], cats, store[table], prec)  # [B, F, D]
        bottom = tower(P, "bottom_mlp", ints, len(model["bottom_units"]), prec, final=F.relu)
        feats = torch.cat([emb, bottom[:, None, :]], dim=1)  # [B, F + 1, D]
        b, f, _ = feats.shape
        xc = prec.low(feats).to(torch.float32)
        grid = torch.bmm(xc, xc.transpose(1, 2))
        upper = torch.ones((f, f), dtype=torch.bool, device=grid.device).triu(1)
        inter = torch.where(upper, grid, 0.0).reshape(b, f * f)
        prob = tower(P, "top_mlp", torch.cat([inter, bottom], dim=1),
                     len(model["top_units"]), prec, final=torch.sigmoid)
    return torch.mean(bce(prob.squeeze(-1), batch["label"]))


def loss_and_grads(P: dict, store: dict, batch: dict, model: dict,
                   prec: Precision) -> tuple[torch.Tensor, dict]:
    for t in P.values():
        t.grad = None
    value = loss(P, store, batch, model, prec)
    value.backward()
    return value.detach(), {n: t.grad for n, t in P.items()}
