"""Dense towers.

Port of ``recommender_tpu/nn/mlp.py::MLP`` with the same dtype policy:
params are f32 masters; each layer casts its input, weight and bias to
``compute_dtype`` (bf16 by default), multiplies, then adds the bias, as
flax ``Dense(dtype=bf16, param_dtype=f32)`` does; the final activation runs
in f32 and a result whose dtype differs from the input's comes back as f32.
Layers are named ``Dense_0 … Dense_{n-1}`` like the flax submodules, so
``convert.py`` maps names one to one.

``input_batch_norm=True`` puts ``BatchNorm_0`` before the first layer: flax
``nn.BatchNorm(use_running_average=not train, dtype=float32)`` semantics,
which differ from ``torch.nn.BatchNorm1d``'s defaults (see ``BatchNorm``).
On a ``mesh`` with a data axis wider than 1 its batch statistics are the
global batch's, summed over the data group, as JAX's are over a
data-sharded batch.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from recommender_tpu_torch.core.distributed import sum_over_group

_TRUNC_NORMAL_STD = 0.87962566103423978  # std of N(0,1) truncated to [-2, 2]


def lecun_normal_(weight: torch.Tensor, generator=None, fan_in: Optional[int] = None) -> torch.Tensor:
    """flax ``lecun_normal()`` for a torch ``[out, in]`` weight (or any shape
    with ``fan_in`` given): a normal truncated at ±2σ, scaled to variance
    1/fan_in."""
    fan_in = weight.shape[1] if fan_in is None else fan_in
    nn.init.trunc_normal_(weight, std=1.0, a=-2.0, b=2.0, generator=generator)
    return weight.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis, computed in f32.

    * Train mode normalizes by the batch statistics, with the variance as
      flax's fast form ``max(E[x²] − E[x]², 0)`` (biased), and moves the
      running stats by ``momentum * old + (1 − momentum) * batch`` — the
      biased variance goes into ``var`` too, where torch's BatchNorm1d uses
      the unbiased one. ``momentum`` 0.99 is torch's ``momentum=0.01``.
    * Eval mode normalizes by the running stats.

    ``weight``/``bias`` are flax's ``scale``/``bias`` params; the running
    stats are the buffers ``mean`` and ``var``, flax's ``batch_stats``
    entries of the same names (``convert.py`` loads them).

    ``mesh`` with a data axis wider than 1: the batch statistics are the
    global batch's, the sums of ``x`` and ``x²`` summed over the data group
    (a differentiable all-reduce); every rank feeds equal rows."""

    def __init__(
        self, num_features: int, momentum: float = 0.99, epsilon: float = 1e-5, *,
        mesh=None, device=None
    ):
        super().__init__()
        self.mesh = mesh
        self.momentum = momentum
        self.epsilon = epsilon
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("mean", torch.zeros(num_features, **f32))
        self.register_buffer("var", torch.ones(num_features, **f32))

    @torch.no_grad()
    def reset_parameters(self):
        """flax init: scale 1, bias 0; running mean 0, var 1."""
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.mesh is not None and self.mesh.data > 1:
                sums = torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes)])
                sums = sum_over_group(sums, self.mesh.data_group)
                mean, mean_sq = (sums / (x[..., 0].numel() * self.mesh.data)).chunk(2)
            else:
                mean, mean_sq = x.mean(dim=axes), (x * x).mean(dim=axes)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        return (x - mean) * mul + self.bias


class MLP(nn.Module):
    """Stack of dense layers: ``units[:-1]`` use ``activation``, the last
    uses ``final_activation`` (None = linear). ``input_batch_norm`` applies
    ``BatchNorm_0`` to the input first, in train mode while the module is
    in ``train()`` mode."""

    def __init__(
        self,
        in_features: int,
        units: Sequence[int],
        activation: Callable = F.relu,
        final_activation: Optional[Callable] = None,
        input_batch_norm: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
        *,
        mesh=None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.units = tuple(units)
        self.activation = activation
        self.final_activation = final_activation
        self.input_batch_norm = input_batch_norm
        self.compute_dtype = compute_dtype
        prev = in_features
        device = torch.device("cpu") if device is None else device
        if input_batch_norm:
            self.BatchNorm_0 = BatchNorm(in_features, mesh=mesh, device=device)
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
        """flax ``Dense`` init: lecun-normal kernel, zero bias (and the
        BatchNorm's own init)."""
        if self.input_batch_norm:
            self.BatchNorm_0.reset_parameters()
        for layer in self.layers():
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig_dtype = x.dtype
        cd = self.compute_dtype
        if self.input_batch_norm:
            x = self.BatchNorm_0(x)
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
