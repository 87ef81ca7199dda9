"""The reference's first steps of training, and what a check compares.

``follow`` takes the initial parameters, the first batches and the
configuration's training settings, and runs its optimizer step by step on
the family's reference loss: Adam (b1 0.9, b2 0.999, eps 1e-8, moments in
f32 math) or SGD (``p - lr g`` in f32).
A parameter stored in bf16 takes its gradient rounded to bf16, keeps its
moments in bf16 and is written back in bf16, each write stochastically
rounded (``reference.rounding``) with the keys the configuration's
rounding derives from its seed: leaf ``i`` of the parameters in sorted
order of their dotted names rounds its moments with
``fold_in(fold_in(key(seed), count), 2i)`` and ``2i + 1`` and its write
with ``fold_in(fold_in(fold_in(key(seed), 0x5EED), step), i)``.

The readings (``Readings``) are those a check compares: each step's loss,
each parameter's first gradient as the optimizer's state holds it after
one step (Adam's first moment over 1 - b1; SGD's parameters' change over
the learning rate), and each parameter's change after the steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import rounding
from portbench.reference.common import Precision

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass
class Readings:
    loss: list          # each step's loss
    grad: dict          # leaf -> norm of the first gradient, from the optimizer's state
    change: dict        # leaf -> norm of the parameter's change after the steps


def _bias_corrections(count: int) -> tuple[float, float]:
    t = np.float32(count + 1)
    return (float(np.float32(1.0) - np.float32(B1) ** t),
            float(np.float32(1.0) - np.float32(B2) ** t))


def _change(p: torch.Tensor, p0: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(p.detach() - p0.to(torch.float32)))


def follow(family, P0: dict, batches: list, model: dict, train: dict, seed: int,
           precision: str = "stated") -> Readings:
    """``family``: a reference module (``loss_and_grads``); ``P0``: name ->
    initial tensor in its storage dtype; ``batches``: the steps' batches on
    the device; ``train``: the configuration's ``train`` dict
    (``learning_rate``); ``seed``: the rounding seed."""
    prec = Precision(precision)
    store = {n: t.dtype for n, t in P0.items()}
    P = {n: t.to(torch.float32).clone().requires_grad_(True) for n, t in P0.items()}
    order = sorted(P, key=lambda n: tuple(n.split(".")))
    low = [n for n in order if store[n] == torch.bfloat16]
    if any(store[n] not in (torch.float32, torch.bfloat16) for n in order):
        raise ValueError(f"storage dtypes {set(store.values())}")
    lr = float(train["learning_rate"])
    adam = {"adam": True, "sgd": False}[train["optimizer"]]
    mu = {n: torch.zeros_like(P[n]) for n in order} if adam else {}
    nu = {n: torch.zeros_like(P[n]) for n in order} if adam else {}
    root = rounding.prng_key(seed)
    write_root = rounding.fold_in(root, 0x5EED)
    losses, first = [], {}
    for step, batch in enumerate(batches):
        value, grads = family.loss_and_grads(P, store, batch, model, prec)
        losses.append(float(value))
        c1, c2 = _bias_corrections(step)
        moment_key = rounding.fold_in(root, step)
        write_key = rounding.fold_in(write_root, step)
        with torch.no_grad():
            for i, n in enumerate(order):
                g = grads[n] if grads[n] is not None else torch.zeros_like(P[n])
                if n in low:
                    g = g.to(torch.bfloat16).to(torch.float32)
                if adam:
                    m = B1 * mu[n] + (1.0 - B1) * g
                    v = B2 * nu[n] + (1.0 - B2) * g * g
                    u = -lr * ((m / c1) / (torch.sqrt(v / c2) + EPS))
                    if n in low:
                        m = rounding.round_bf16(m, rounding.fold_in(moment_key, 2 * i))
                        v = rounding.round_bf16(v, rounding.fold_in(moment_key, 2 * i + 1))
                    mu[n], nu[n] = m, v
                else:
                    u = -lr * g
                new = P[n] + u
                if n in low:
                    new = rounding.round_bf16(new, rounding.fold_in(write_key, i))
                P[n].copy_(new)
        if step == 0:
            first = {n: (float(torch.linalg.vector_norm(mu[n])) / (1.0 - B1) if adam
                         else _change(P[n], P0[n]) / lr) for n in order}
    change = {n: _change(P[n], P0[n]) for n in order}
    return Readings(loss=losses, grad=first, change=change)
