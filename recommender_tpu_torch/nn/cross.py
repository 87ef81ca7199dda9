"""DCNv2 cross network — explicit bounded-degree feature crosses.

Port of ``recommender_tpu/nn/cross.py::CrossNetwork`` (Wang et al. 2021,
"DCN V2", full-rank form):

    x_{l+1} = x_0 ⊙ (W_l x_l + b_l) + x_l

Each layer is an f32 ``nn.Linear(d, d)`` named ``cross_<l>`` like the flax
``Dense`` submodules, so ``convert.py`` maps ``cross_<l>/kernel`` onto
``cross_<l>.weight`` unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from recommender_tpu_torch.nn.mlp import lecun_normal_


class CrossNetwork(nn.Module):
    """Stack of DCNv2 cross layers over a fixed-width input [B, d]."""

    def __init__(
        self,
        in_features: int,
        num_layers: int = 3,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.num_layers = num_layers
        device = torch.device("cpu") if device is None else device
        for i in range(num_layers):
            layer = nn.utils.skip_init(
                nn.Linear, in_features, in_features, device=device, dtype=torch.float32
            )
            self.add_module(f"cross_{i}", layer)
        self.reset_parameters(generator)

    def layers(self) -> list[nn.Linear]:
        return [getattr(self, f"cross_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense`` init: lecun-normal kernel, zero bias."""
        for layer in self.layers():
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for layer in self.layers():
            # W_l x + b_l; the residual keeps the lower-degree crosses
            x = x0 * F.linear(x, layer.weight, layer.bias) + x
        return x
