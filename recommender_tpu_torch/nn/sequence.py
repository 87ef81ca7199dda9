"""Behavior-sequence layers: masked pooling, DIN attention, DIEN attention.

Port of ``recommender_tpu/nn/sequence.py``. All layers take an explicit
``mask`` [B, T] (nonzero = real step), computed upstream from
``item_id != 0``, and compute in f32 as the flax layers do. Dense layers are
named ``Dense_0 …`` like the flax submodules, so ``convert.py`` maps a JAX
tree one to one. torch layers are not lazily shaped, so each module takes
its input width.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from recommender_tpu_torch.nn.mlp import lecun_normal_


def masked_mean_pool(his: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, T, D], [B, T] → [B, D]: average over real (unmasked) steps; an
    all-pad history pools to zeros (the count is clamped to at least 1)."""
    m = mask.to(his.dtype)[..., None]  # [B, T, 1]
    s = torch.sum(his * m, dim=1)
    n = torch.clamp(torch.sum(m, dim=1), min=1.0)
    return s / n


class _SigmoidTower(nn.Module):
    """f32 dense layers ``Dense_0 … Dense_{n-1}`` (flax ``nn.Dense`` init:
    lecun-normal kernel, zero bias) with a sigmoid after all but the last."""

    def __init__(self, in_features: int, units: Sequence[int], *, device=None, generator=None):
        super().__init__()
        self.units = tuple(units)
        prev = in_features
        device = torch.device("cpu") if device is None else device
        for i, unit in enumerate(self.units):
            # allocated uninitialized; reset_parameters draws the flax init
            layer = nn.utils.skip_init(nn.Linear, prev, unit, device=device, dtype=torch.float32)
            self.add_module(f"Dense_{i}", layer)
            prev = unit
        self.reset_parameters(generator)

    def layers(self) -> list[nn.Linear]:
        return [getattr(self, f"Dense_{i}") for i in range(len(self.units))]

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for layer in self.layers():
            lecun_normal_(layer.weight, generator)
            layer.bias.zero_()

    def tower(self, x: torch.Tensor) -> torch.Tensor:
        layers = self.layers()
        for layer in layers[:-1]:
            x = torch.sigmoid(layer(x))
        return layers[-1](x)


class AuxiliaryNet(_SigmoidTower):
    """Sigmoid-activated MLP head producing one logit per step:
    [..., in_features] → [...]."""

    def __init__(self, in_features: int, units: Sequence[int] = (80, 40, 1), *,
                 device=None, generator=None):
        super().__init__(in_features, units, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.squeeze(self.tower(x), dim=-1)


class LocalActivationUnit(_SigmoidTower):
    """DIN attention: returns the weighted history representation [B, D].

    Weights are raw MLP outputs (not softmaxed), zeroed at padded steps.
    ``Dense_0`` and ``Dense_1`` are the sigmoid layers, ``Dense_2`` the
    1-unit output, as in the flax module."""

    def __init__(self, dim: int, hidden: Sequence[int] = (80, 40), *, device=None, generator=None):
        super().__init__(4 * dim, (*hidden, 1), device=device, generator=generator)

    def forward(self, target: torch.Tensor, history: torch.Tensor, mask: torch.Tensor):
        # target [B, D] (or [B, 1, D]), history [B, T, D], mask [B, T]
        if target.dim() == 2:
            target = target[:, None, :]
        t = target.expand_as(history)
        x = torch.cat([t, history, t - history, t * history], dim=-1)
        w = self.tower(x)  # [B, T, 1]
        w = w * mask.to(w.dtype)[..., None]
        return torch.einsum("btd,bto->bd", history, w)


class DIENAttention(nn.Module):
    """Bilinear attention scores softmaxed over time. Returns [B, T, 1].

    The flax parameter is ``kernel`` [H, D_t]; ``convert.py`` transposes every
    2-D ``kernel`` into ``weight``, so this module holds ``weight`` [D_t, H],
    a bias-free linear map of the hidden states. An all-pad row scores
    uniformly (every step carries the same additive ``-1e9``)."""

    def __init__(self, hidden: int, target_dim: int, *, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((target_dim, hidden), dtype=torch.float32, device=device)
        )
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.weight, generator)  # fan_in = H, as for the flax [H, D_t] kernel

    def forward(self, target: torch.Tensor, hidden: torch.Tensor, mask: torch.Tensor):
        # target [B, D_t] or [B, 1, D_t]; hidden [B, T, H]; mask [B, T]
        if target.dim() == 3:
            target = torch.squeeze(target, dim=1)
        trans = torch.matmul(hidden, self.weight.t())  # [B, T, D_t]
        score = torch.einsum("btd,bd->bt", trans, target)
        score = score + (1.0 - mask.to(score.dtype)) * -1e9
        score = torch.softmax(score, dim=1)
        return score[..., None]
