"""Pieces the family references share: the table gather, the rounding
points of the configuration's precision, a dense tower and the loss.

Every parameter is held as an f32 tensor whose values are exact in its
storage dtype (``store``), so that gradients sum in f32 and are rounded to
the storage dtype once, where the optimizer reads them.
"""
from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

BF16 = torch.bfloat16
FP8 = torch.float8_e4m3fn
EPS = 1e-7  # BCE's clamp of probabilities


class Precision:
    """The rounding points of the configuration (``"stated"``) or of the
    control (``"lower"``): where the configuration rounds a value to bf16
    (a product's operands in a bf16 tower, a bf16 table's rows) the control
    rounds it to float8 e4m3 (its gradient passes unrounded), and where the
    configuration multiplies in f32 with TF32 off the control lets the
    matrix products run in TF32."""

    def __init__(self, name: str = "stated"):
        if name not in ("stated", "lower"):
            raise ValueError(name)
        self.lower = name == "lower"

    def low(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` in the tower's compute dtype (bf16)."""
        y = x.to(BF16)
        if not self.lower:
            return y
        return y + (y.to(FP8).to(BF16) - y).detach()

    def rows(self, x: torch.Tensor, store: torch.dtype) -> torch.Tensor:
        """Gathered rows of a table stored in ``store``."""
        if not self.lower or store != BF16:
            return x
        return x + (x.to(FP8).to(x.dtype) - x).detach()

    @contextlib.contextmanager
    def products(self):
        """f32 matrix products: TF32 off, or on for the control."""
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.lower
        torch.backends.cudnn.allow_tf32 = self.lower
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class _Gather(torch.autograd.Function):
    """``table[ids]``; the gradient is the cotangent rows rounded to the
    table's storage dtype (a bf16 table is looked up as bf16 rows, whose
    cotangent is bf16), summed in f32 into a fresh [V, D] table."""

    @staticmethod
    def forward(ctx, table, ids, store):
        ctx.save_for_backward(ids)
        ctx.shape, ctx.store = table.shape, store
        return table.index_select(0, ids.reshape(-1)).reshape(*ids.shape, table.shape[1])

    @staticmethod
    def backward(ctx, cot):
        (ids,) = ctx.saved_tensors
        rows = cot.reshape(-1, ctx.shape[1]).to(ctx.store).to(torch.float32)
        grad = torch.zeros(ctx.shape, dtype=torch.float32, device=cot.device)
        return grad.index_add_(0, ids.reshape(-1).long(), rows), None, None


def gather(table: torch.Tensor, ids: torch.Tensor, store: torch.dtype,
           prec: Precision) -> torch.Tensor:
    return prec.rows(_Gather.apply(table, ids, store), store)


def tower(P: dict, prefix: str, x: torch.Tensor, layers: int, prec: Precision,
          final=None, batch_norm: bool = False) -> torch.Tensor:
    """A dense tower in bf16: ``Dense_0 .. Dense_{layers-1}`` (weights
    [out, in]) on bf16 operands with a ReLU between layers, ``final`` in
    f32 on the last layer's output; with ``batch_norm`` an input BatchNorm
    over the batch (biased variance, epsilon 1e-5) in f32 first. Returns
    f32."""
    if batch_norm:
        x = x.to(torch.float32)
        mean, mean_sq = x.mean(dim=0), (x * x).mean(dim=0)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        x = (x - mean) * (torch.rsqrt(var + 1e-5) * P[f"{prefix}.BatchNorm_0.weight"]) \
            + P[f"{prefix}.BatchNorm_0.bias"]
    x = prec.low(x)
    for i in range(layers):
        w, b = P[f"{prefix}.Dense_{i}.weight"], P[f"{prefix}.Dense_{i}.bias"]
        x = torch.matmul(x, prec.low(w).t()) + prec.low(b)
        if i < layers - 1:
            x = F.relu(x)
        elif final is not None:
            x = final(x.to(torch.float32))
    return x.to(torch.float32)


def bce(prob: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-example binary cross-entropy of probabilities."""
    p = torch.clamp(prob, EPS, 1.0 - EPS)
    label = label.to(p.dtype)
    return -(label * torch.log(p) + (1.0 - label) * torch.log1p(-p))
