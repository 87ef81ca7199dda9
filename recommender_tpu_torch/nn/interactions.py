"""Feature-interaction layers: FM second-order cross and DLRM dot interaction.

Port of ``recommender_tpu/nn/interactions.py``.
"""
from __future__ import annotations

import torch
from torch import nn


def fm_cross(embeddings: torch.Tensor) -> torch.Tensor:
    """FM 2nd-order term. ``embeddings``: [B, F, D] → [B], in their dtype.

    0.5 * sum_d ((sum_f e)^2 - sum_f e^2): O(B·F·D), no pairwise matmul.

    Computed in f32 and rounded to a bf16 input's dtype where the compiled
    JAX function rounds: after each sum over an axis and after the square of
    the sum. The square that feeds a sum and the difference stay f32, as
    they do inside XLA's fusions. For f32 inputs every rounding is a no-op.
    """
    dt = embeddings.dtype

    def rounded(x):
        return x.to(dt).to(torch.float32)

    x = embeddings.to(torch.float32)
    sum_sq = rounded(torch.square(rounded(torch.sum(x, dim=1))))  # [B, D]
    sq_sum = rounded(torch.sum(torch.square(x), dim=1))  # [B, D]
    return (0.5 * torch.sum(sum_sq - sq_sum, dim=1)).to(dt)  # [B]


class DotInteraction(nn.Module):
    """Pairwise dot products between feature embeddings.

    Input [B, F, D] → output:
      * ``skip_gather=True``:  [B, F*F] (upper triangle kept, rest zeros)
      * ``skip_gather=False``: [B, F*(F±1)/2] (compact, gathered)

    Like the JAX layer, the inputs are rounded to bf16 and the products
    accumulate in f32: here as an f32 ``bmm`` of the bf16-rounded values,
    since a bf16 ``bmm`` would also round its output.
    """

    def __init__(self, self_interaction: bool = False, skip_gather: bool = True):
        super().__init__()
        self.self_interaction = self_interaction
        self.skip_gather = skip_gather

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, _ = x.shape
        xc = x.to(torch.bfloat16).to(torch.float32)
        grid = torch.bmm(xc, xc.transpose(1, 2))  # [B, F, F]
        k = 0 if self.self_interaction else 1
        tri = torch.ones((f, f), dtype=torch.bool, device=x.device).triu(k)
        if self.skip_gather:
            return torch.where(tri, grid, 0.0).reshape(b, f * f)
        idx = tri.reshape(-1).nonzero().squeeze(1)
        return grid.reshape(b, f * f)[:, idx]
