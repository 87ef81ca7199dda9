"""Initial parameters, made by the benchmark from the seed on the device.

A family lists its parameters as ``Leaf``s, named as the port's
``named_parameters()`` names them, each with its initialisation; ``make``
draws all of them with one ``torch.Generator`` in two large calls (one
normal, one uniform draw), in the leaves' storage dtypes, and ``load``
copies them into the port's model. The reference starts from the same
tensors, drawn again the same way: it takes nothing that the port made.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    dtype: torch.dtype
    init: str  # "normal" (scale = std), "uniform" (scale = bound) or "const" (scale = value)
    scale: float

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def make(leaves: list[Leaf], seed: int, device) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    counts = {kind: sum(l.numel for l in leaves if l.init == kind) for kind in ("normal", "uniform")}
    draws = {
        "normal": torch.randn(counts["normal"], generator=gen, device=device),
        "uniform": torch.rand(counts["uniform"], generator=gen, device=device).mul_(2).sub_(1),
    }
    used = {"normal": 0, "uniform": 0}
    out = {}
    for leaf in leaves:
        if leaf.init == "const":
            out[leaf.name] = torch.full(leaf.shape, leaf.scale, dtype=leaf.dtype, device=device)
            continue
        start = used[leaf.init]
        used[leaf.init] = start + leaf.numel
        flat = draws[leaf.init][start:start + leaf.numel]
        out[leaf.name] = (flat * leaf.scale).reshape(leaf.shape).to(leaf.dtype)
    return out


@torch.no_grad()
def load(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into the model's parameters, which must match them
    one to one by name, shape and dtype."""
    own = dict(model.named_parameters())
    if set(own) != set(weights):
        raise ValueError(f"parameters differ: model only {sorted(set(own) - set(weights))}, "
                         f"weights only {sorted(set(weights) - set(own))}")
    for name, p in own.items():
        w = weights[name]
        if p.shape != w.shape or p.dtype != w.dtype:
            raise ValueError(f"{name}: model {tuple(p.shape)} {p.dtype}, weights "
                             f"{tuple(w.shape)} {w.dtype}")
        p.copy_(w)
