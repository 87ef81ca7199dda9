"""Dense towers.

Port of ``recommender_tpu/nn/mlp.py::MLP`` with the same dtype policy:
params are f32 masters; each layer casts its input, weight and bias to
``compute_dtype`` (bf16 by default), multiplies, then adds the bias, as
flax ``Dense(dtype=bf16, param_dtype=f32)`` does; the final activation runs
in f32 and a result whose dtype differs from the input's comes back as f32.
Layers are named ``Dense_0 … Dense_{n-1}`` like the flax submodules, so
``convert.py`` maps names one to one. The input BatchNorm option belongs to
a later slice.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

_TRUNC_NORMAL_STD = 0.87962566103423978  # std of N(0,1) truncated to [-2, 2]


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``lecun_normal()`` for a torch ``[out, in]`` weight: a normal
    truncated at ±2σ, scaled to variance 1/fan_in."""
    fan_in = weight.shape[1]
    nn.init.trunc_normal_(weight, std=1.0, a=-2.0, b=2.0, generator=generator)
    return weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD)


class MLP(nn.Module):
    """Stack of dense layers: ``units[:-1]`` use ``activation``, the last
    uses ``final_activation`` (None = linear)."""

    def __init__(
        self,
        in_features: int,
        units: Sequence[int],
        activation: Callable = F.relu,
        final_activation: Optional[Callable] = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.units = tuple(units)
        self.activation = activation
        self.final_activation = final_activation
        self.compute_dtype = compute_dtype
        prev = in_features
        device = torch.device("cpu") if device is None else device
        for i, unit in enumerate(self.units):
            # allocated uninitialized; reset_parameters draws the flax init
            layer = nn.utils.skip_init(
                nn.Linear, prev, unit, device=device, dtype=torch.float32
            )
            self.add_module(f"Dense_{i}", layer)
            prev = unit
        self.reset_parameters(generator)

    def layers(self) -> list[nn.Linear]:
        return [getattr(self, f"Dense_{i}") for i in range(len(self.units))]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense`` init: lecun-normal kernel, zero bias."""
        for layer in self.layers():
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig_dtype = x.dtype
        cd = self.compute_dtype
        x = x.to(cd)
        layers = self.layers()
        for i, layer in enumerate(layers):
            x = torch.matmul(x, layer.weight.to(cd).t()) + layer.bias.to(cd)
            if i < len(layers) - 1:
                x = self.activation(x)
            elif self.final_activation is not None:
                # final activation in f32 for numerically clean sigmoids
                x = self.final_activation(x.to(torch.float32))
        return x.to(torch.float32) if x.dtype != orig_dtype else x
