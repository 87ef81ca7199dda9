"""Low-precision-aware Adam (bf16 embedding tables).

Port of ``recommender_tpu/core/optim.py`` (``scale_by_adam_sr``,
``adam_sr``, ``apply_updates_sr``) as one ``torch.optim.Optimizer``,
``AdamSR``, over the plain functions below:

* moment math runs in f32 whatever the storage dtype;
* moments are stored in the param's dtype (or ``moment_dtype``) and written
  back with stochastic rounding, so the expected trajectory stays exact;
* updates stay f32, and the param write is an f32 add with a
  stochastic-rounded store for low-precision params.

Stochastic rounding applies exactly to the low-precision leaves, which is
what the JAX Trainer's automatic mode resolves to: for an all-f32 param
list every rounding is an identity cast and the step is plain Adam
(``optax.adam``) to f32 roundoff.

Keys: leaf ``i`` (a param's index in the list, which the Trainer orders as
JAX flattens the flax tree) rounds its moments with
``fold_in(fold_in(prng_key(seed), count), 2i)`` and ``2i + 1`` and its
param write with ``fold_in(write_key, i)`` — the JAX package's
derivations, reproduced word for word by ``ops.rounding``. So for the same
seed, step and leaf both packages draw the same rounding noise.

Per-path update scales (``TrainConfig.lr_scales``, the JAX package's
``_scale_updates_by_path``): ``AdamSR(scales=...)`` multiplies leaf ``i``'s
update by ``scales[i]`` after ``-lr * u`` and before the param write, where
``optax.chain(base, scale)`` applies it; ``path_scales`` computes that list
from the params' names and the ``{pattern: multiplier}`` dict.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from recommender_tpu_torch.ops.rounding import (
    Key,
    fold_in,
    is_low_precision,
    prng_key,
    stochastic_round_to,
)


def scale_by_adam_sr(
    grads: Sequence[torch.Tensor],
    mu: Sequence[torch.Tensor],
    nu: Sequence[torch.Tensor],
    count: int,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    seed: int = 0,
    offsets: Optional[Sequence[int]] = None,
) -> tuple[list, list, list]:
    """One Adam moment step. ``count`` is the number of steps taken before
    this one. Returns ``(f32 updates, new mu, new nu)``; each new moment
    keeps its old storage dtype, written with stochastic rounding when that
    dtype is low-precision. ``offsets[i]`` is leaf ``i``'s first element's
    index in its whole table (a row shard's; 0 for everything else)."""
    # bias corrections in f32 on the host, as JAX computes them in f32
    t = np.float32(count + 1)
    c1 = float(np.float32(1.0) - np.float32(b1) ** t)
    c2 = float(np.float32(1.0) - np.float32(b2) ** t)
    base_key = fold_in(prng_key(seed), count)
    out, new_mu, new_nu = [], [], []
    for i, (g, m, n) in enumerate(zip(grads, mu, nu)):
        gf = g.to(torch.float32)
        mf = b1 * m.to(torch.float32) + (1.0 - b1) * gf
        nf = b2 * n.to(torch.float32) + (1.0 - b2) * gf * gf
        out.append((mf / c1) / (torch.sqrt(nf / c2) + eps))
        if is_low_precision(m.dtype):
            off = offsets[i] if offsets else 0
            new_mu.append(stochastic_round_to(mf, m.dtype, fold_in(base_key, 2 * i), off))
            new_nu.append(stochastic_round_to(nf, n.dtype, fold_in(base_key, 2 * i + 1), off))
        else:
            new_mu.append(mf.to(m.dtype))
            new_nu.append(nf.to(n.dtype))
    return out, new_mu, new_nu


def path_scales(names: Sequence[str], scales: Optional[dict]) -> list[float]:
    """Each param's update multiplier under ``{pattern: multiplier}``.

    A name is the port's dotted param name, whose ``.``-separated
    components are the flax path's (``cat_embedding.embedding``). A pattern
    is one or more ``/``-separated components and matches a name that holds
    that exact run of components: ``cat_embedding`` matches
    ``cat_embedding.embedding`` and not ``concat_embedding.embedding``. The
    multipliers of every matching pattern multiply; no match is 1."""
    out = []
    for name in names:
        segs = name.split(".")
        m = 1.0
        for pat, s in (scales or {}).items():
            want = [p for p in str(pat).split("/") if p]
            n = len(want)
            if n and any(segs[i:i + n] == want for i in range(len(segs) - n + 1)):
                m *= float(s)
        out.append(m)
    return out


def apply_updates_sr(
    params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor], key: Key,
    offsets: Optional[Sequence[int]] = None,
) -> list:
    """``p + u`` with an f32 add and a stochastic-rounded write for
    low-precision leaves (unbiased: sub-ulp Adam updates land in
    expectation instead of rounding away); ``offsets`` as in
    ``scale_by_adam_sr``."""
    out = []
    for i, (p, u) in enumerate(zip(params, updates)):
        if is_low_precision(p.dtype):
            summed = p.to(torch.float32) + u.to(torch.float32)
            off = offsets[i] if offsets else 0
            out.append(stochastic_round_to(summed, p.dtype, fold_in(key, i), off))
        else:
            out.append(p + u.to(p.dtype))
    return out


class AdamSR(torch.optim.Optimizer):
    """Adam with f32 moment math, moment storage in the param dtype (or
    ``moment_dtype``), and stochastic-rounded moment and param writes for
    low-precision leaves; f32 leaves take plain Adam. ``step(write_key)``
    takes the param-write key, which the Trainer derives from its step
    counter. The order of ``params`` fixes each leaf's rounding keys.

    ``lr`` is a float or a schedule, a callable of the update count that
    returns a float (``nn.schedules``): as optax's
    ``scale_by_learning_rate(schedule)``, it is evaluated at the count
    before this update, from 0. ``scales`` (one float per param, in param
    order) multiplies each update after the learning rate, as
    ``TrainConfig.lr_scales`` asks; None scales nothing.

    ``state_dict()`` is ``{"count", "mu", "nu"}``: the step count, which the
    moment-rounding keys and a schedule read, and the moments in param
    order, each in its storage dtype; ``load_state_dict`` copies them back
    in place."""

    def __init__(
        self,
        params,
        lr: float | Callable[[int], float] = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        seed: int = 0,
        moment_dtype: Optional[torch.dtype] = None,
        scales: Optional[Sequence[float]] = None,
        offsets: Optional[Sequence[int]] = None,
    ):
        super().__init__(list(params), dict(lr=lr, b1=b1, b2=b2, eps=eps))
        if len(self.param_groups) != 1:
            raise ValueError("AdamSR takes one parameter group")
        n = len(self.param_groups[0]["params"])
        if scales is not None and len(scales) != n:
            raise ValueError(f"{len(scales)} scales for {n} params")
        self.scales = None if scales is None else [float(s) for s in scales]
        if offsets is not None and len(offsets) != n:
            raise ValueError(f"{len(offsets)} offsets for {n} params")
        self.offsets = None if offsets is None else [int(o) for o in offsets]
        self.seed = seed
        self.count = 0  # Adam steps taken (optax ScaleByAdamState.count)
        for p in self.param_groups[0]["params"]:
            store = moment_dtype if moment_dtype is not None else p.dtype
            self.state[p] = {
                "mu": torch.zeros(p.shape, dtype=store, device=p.device),
                "nu": torch.zeros(p.shape, dtype=store, device=p.device),
            }

    @torch.no_grad()
    def step(self, write_key: Key):
        group = self.param_groups[0]
        params = group["params"]
        # a param that took no part in the loss has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        upd, new_mu, new_nu = scale_by_adam_sr(
            grads, mu, nu, self.count, group["b1"], group["b2"], group["eps"], self.seed,
            self.offsets,
        )
        lr = group["lr"](self.count) if callable(group["lr"]) else group["lr"]
        upd = [-lr * u for u in upd]  # optax.scale_by_learning_rate
        if self.scales is not None:  # optax.chain(base, _scale_updates_by_path)
            upd = [u * s for u, s in zip(upd, self.scales)]
        new_params = apply_updates_sr(params, upd, write_key, self.offsets)
        for p, m, n, m_new, n_new, p_new in zip(params, mu, nu, new_mu, new_nu, new_params):
            m.copy_(m_new)
            n.copy_(n_new)
            p.copy_(p_new)
        self.count += 1

    def _moments(self, which: str) -> list[torch.Tensor]:
        return [self.state[p][which] for p in self.param_groups[0]["params"]]

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self._moments("mu"), "nu": self._moments("nu")}

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict):
        for which in ("mu", "nu"):
            own, new = self._moments(which), state_dict[which]
            if len(own) != len(new):
                raise ValueError(f"{which}: {len(new)} moments for {len(own)} params")
            for i, (m, m_new) in enumerate(zip(own, new)):
                if m.shape != m_new.shape or m.dtype != m_new.dtype:
                    raise ValueError(
                        f"{which}[{i}]: {tuple(m_new.shape)} {m_new.dtype} does not fit "
                        f"{tuple(m.shape)} {m.dtype}"
                    )
                m.copy_(m_new)
        self.count = int(state_dict["count"])
