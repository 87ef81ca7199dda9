"""Mixture-of-experts gating (MMOE).

Port of ``recommender_tpu/nn/moe.py``. The JAX ``ExpertBank`` is an
``nn.vmap`` of ``MLP`` over the experts, so each layer holds ONE param per
kind with a leading expert axis: ``experts/Dense_i/kernel`` [E, in, out]
and ``experts/Dense_i/bias`` [E, out]. The port keeps those params, names
and shapes (``convert.py`` keeps a kernel that is not 2-D as it is) and runs
each layer as one batched product over the experts, in the MLP's bf16
compute dtype, as the vmapped flax ``Dense`` does. Splitting the bank into E
``nn.Linear``s would change the leaf count, and so every later leaf's
stochastic-rounding keys.

``MMOEGate`` is an f32 ``Dense(E)`` (flax's ``nn.Dense`` computes in its
input's dtype here, unlike the MLP's bf16), a softmax over the experts, and
the weighted sum of the experts' outputs.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from recommender_tpu_torch.nn.mlp import lecun_normal_


class _StackedDense(nn.Module):
    """One layer of E experts: ``kernel`` [E, in, out], ``bias`` [E, out]."""

    def __init__(self, num_experts: int, in_features: int, out_features: int, *, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.kernel = nn.Parameter(torch.empty((num_experts, in_features, out_features), **f32))
        self.bias = nn.Parameter(torch.zeros((num_experts, out_features), **f32))


class _ExpertMLPs(nn.Module):
    """The vmapped ``MLP``: ``[B, in]`` → ``[B, E, units[-1]]``, ReLU after
    every layer (the bank's ``final_activation`` is ReLU too)."""

    def __init__(self, num_experts: int, in_features: int, units: Sequence[int],
                 compute_dtype: torch.dtype = torch.bfloat16, *, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_layers = len(units)
        prev = in_features
        for i, unit in enumerate(units):
            self.add_module(f"Dense_{i}", _StackedDense(num_experts, prev, unit, device=device))
            prev = unit

    def layers(self) -> list[_StackedDense]:
        return [getattr(self, f"Dense_{i}") for i in range(self.num_layers)]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax ``Dense`` init per expert: lecun-normal (fan_in = ``in``),
        zero bias."""
        for layer in self.layers():
            lecun_normal_(layer.kernel, generator, fan_in=layer.kernel.shape[1])
            layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        h = x.to(cd)  # [B, in], shared by every expert
        layers = self.layers()
        for i, layer in enumerate(layers):
            # [B, in] @ [E, in, out] → [E, B, out]; then [E, B, h] @ [E, h, out]
            h = torch.matmul(h, layer.kernel.to(cd)) + layer.bias.to(cd)[:, None, :]
            if i < len(layers) - 1:
                h = F.relu(h)
        h = F.relu(h.to(torch.float32))  # final activation in f32, as MLP
        return h.transpose(0, 1)  # [B, E, out] (vmap's out_axes=1)


class ExpertBank(nn.Module):
    """``num_experts`` parallel MLPs: ``[B, D]`` → ``[B, E, units[-1]]``."""

    def __init__(self, num_experts: int, in_features: int, units: Sequence[int], *,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.experts = _ExpertMLPs(num_experts, in_features, units, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.experts.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.experts(x)


class MMOEGate(nn.Module):
    """Per-task softmax gate over experts: ``[B, D]``, ``[B, E, H]`` →
    ``[B, H]``. ``Dense_0`` is the flax ``nn.Dense(E)``, in f32."""

    def __init__(self, in_features: int, num_experts: int, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = torch.device("cpu") if device is None else device
        self.Dense_0 = nn.utils.skip_init(
            nn.Linear, in_features, num_experts, device=device, dtype=torch.float32
        )
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.Dense_0.weight, generator)
        self.Dense_0.bias.zero_()

    def forward(self, x: torch.Tensor, expert_out: torch.Tensor) -> torch.Tensor:
        w = torch.softmax(self.Dense_0(x.to(torch.float32)), dim=-1)  # [B, E]
        return torch.einsum("be,beh->bh", w, expert_out)
