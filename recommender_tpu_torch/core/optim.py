"""The optimizers: low-precision-aware Adam (bf16 embedding tables), and
plain Adam, Adagrad and SGD.

Port of ``recommender_tpu/core/optim.py`` (``scale_by_adam_sr``,
``adam_sr``, ``apply_updates_sr``, ``has_low_precision_leaf``) as one
``torch.optim.Optimizer``, ``AdamSR``, over the plain functions below:

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

``make_optimizer`` is the JAX Trainer's ``make_optimizer``
(``recommender_tpu/core/train.py``): ``TrainConfig.optimizer`` "adam"
gives ``AdamSR`` where stochastic rounding is on and ``Adam``
(``optax.adam``) where it is off; "adagrad" and "sgd" give ``Adagrad``
(``optax.adagrad``) and ``SGD`` (``optax.sgd``), with optax's defaults.
Each applies ``lr_scales`` after its base update, and writes low-precision
params with stochastic rounding where it is on, as the JAX Trainer's
``_apply`` does for every optimizer. Plain Adam and Adagrad do their math
in f32 and store their state in the param's dtype, as optax keeps it; the
update is f32 and the plain param write is an f32 add rounded to the
param's dtype (``optax.apply_updates``).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from recommender_tpu_torch.core.profiling import annotate
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


def has_low_precision_leaf(params: Iterable[torch.Tensor]) -> bool:
    """Whether any param is stored in a low-precision float dtype: the JAX
    Trainer's rule for ``stochastic_round=None``."""
    return any(is_low_precision(p.dtype) for p in params)


class Optimizer(torch.optim.Optimizer):
    """What the optimizers share: one parameter group, in the order that
    fixes each leaf's rounding keys; ``lr`` a float or a schedule, a
    callable of the update count that returns a float (``nn.schedules``),
    evaluated as optax's ``scale_by_learning_rate(schedule)`` does at the
    count before this update, from 0; ``scales`` (one float per param, in
    param order) multiplying each update after the learning rate, as
    ``TrainConfig.lr_scales`` asks (None scales nothing); the param write,
    stochastic-rounded for low-precision leaves where ``stochastic``
    (``apply_updates_sr``; ``offsets`` as there), else an f32 add rounded
    to the param's dtype.

    ``step(write_key=None, grads=None)`` takes the param-write key, which
    the Trainer derives from its step counter, and the gradients: each
    param's ``.grad`` unless ``grads`` gives them (f32 sums for
    low-precision params, which a bf16 ``.grad`` cannot hold). A param
    without a gradient took no part in the loss, and its gradient is zero,
    as in JAX.

    ``state_dict()`` is ``{"count", slot: [tensor per param], ...}``: the
    update count, and each state ``slot`` in param order, in its storage
    dtype; ``load_state_dict`` copies them back in place. Under a profiler
    a step is an ``optimizer.step`` span (``core.profiling.annotate``)."""

    slots: tuple[str, ...] = ()

    def __init__(self, params, defaults: dict, scales=None, offsets=None, stochastic=False):
        super().__init__(list(params), defaults)
        if len(self.param_groups) != 1:
            raise ValueError(f"{type(self).__name__} takes one parameter group")
        n = len(self.param_groups[0]["params"])
        if scales is not None and len(scales) != n:
            raise ValueError(f"{len(scales)} scales for {n} params")
        self.scales = None if scales is None else [float(s) for s in scales]
        if offsets is not None and len(offsets) != n:
            raise ValueError(f"{len(offsets)} offsets for {n} params")
        self.offsets = None if offsets is None else [int(o) for o in offsets]
        self.stochastic = stochastic
        self.count = 0  # updates taken (optax's count)

    def _updates(self, params, grads) -> list[torch.Tensor]:
        """The base transformation's f32 updates, before the learning rate;
        advances the state."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self, write_key: Optional[Key] = None,
             grads: Optional[Sequence[torch.Tensor]] = None):
        group = self.param_groups[0]
        params = group["params"]
        with annotate("optimizer.step"):
            if grads is None:
                grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            elif len(grads) != len(params):
                raise ValueError(f"{len(grads)} gradients for {len(params)} params")
            upd = self._updates(params, grads)
            lr = group["lr"](self.count) if callable(group["lr"]) else group["lr"]
            upd = [-lr * u for u in upd]  # optax.scale_by_learning_rate
            if self.scales is not None:  # optax.chain(base, _scale_updates_by_path)
                upd = [u * s for u, s in zip(upd, self.scales)]
            if self.stochastic:
                if write_key is None:
                    raise ValueError("a stochastic-rounding param write needs write_key")
                new_params = apply_updates_sr(params, upd, write_key, self.offsets)
            else:  # optax.apply_updates
                new_params = [(p.to(torch.float32) + u).to(p.dtype) for p, u in zip(params, upd)]
            for p, p_new in zip(params, new_params):
                p.copy_(p_new)
            self.count += 1

    def _init_slot(self, name: str, fill: float = 0.0, dtype: Optional[torch.dtype] = None):
        for p in self.param_groups[0]["params"]:
            self.state[p][name] = torch.full(p.shape, fill, dtype=dtype or p.dtype,
                                             device=p.device)

    def _moments(self, which: str) -> list[torch.Tensor]:
        return [self.state[p][which] for p in self.param_groups[0]["params"]]

    def state_dict(self) -> dict:
        return {"count": self.count, **{s: self._moments(s) for s in self.slots}}

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict):
        for which in self.slots:
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


class AdamSR(Optimizer):
    """Adam with f32 moment math, moment storage in the param dtype (or
    ``moment_dtype``), and stochastic-rounded moment and param writes for
    low-precision leaves; f32 leaves take plain Adam (``adam_sr`` and
    ``apply_updates_sr``). ``state_dict()`` holds ``count`` (which the
    moment-rounding keys and a schedule read), ``mu`` and ``nu``."""

    slots = ("mu", "nu")

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
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps), scales, offsets,
                         stochastic=True)
        self.seed = seed
        for slot in self.slots:
            self._init_slot(slot, dtype=moment_dtype)

    def _updates(self, params, grads):
        group = self.param_groups[0]
        mu, nu = self._moments("mu"), self._moments("nu")
        upd, new_mu, new_nu = scale_by_adam_sr(
            grads, mu, nu, self.count, group["b1"], group["b2"], group["eps"], self.seed,
            self.offsets,
        )
        for m, n, m_new, n_new in zip(mu, nu, new_mu, new_nu):
            m.copy_(m_new)
            n.copy_(n_new)
        return upd


def _bias_corrections(count: int, b1: float, b2: float) -> tuple[float, float]:
    """Adam's ``1 - b ** (count + 1)`` in f32, as JAX computes them."""
    t = np.float32(count + 1)
    return (float(np.float32(1.0) - np.float32(b1) ** t),
            float(np.float32(1.0) - np.float32(b2) ** t))


class Adam(Optimizer):
    """``optax.adam(lr)``: moments stored in the param's dtype, the math in
    f32 on the stored moments."""

    slots = ("mu", "nu")

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, scales=None,
                 stochastic=False, offsets=None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps), scales, offsets, stochastic)
        for slot in self.slots:
            self._init_slot(slot)

    def _updates(self, params, grads):
        group = self.param_groups[0]
        b1, b2 = group["b1"], group["b2"]
        c1, c2 = _bias_corrections(self.count, b1, b2)
        out = []
        for g, m, n in zip(grads, self._moments("mu"), self._moments("nu")):
            gf = g.to(torch.float32)
            m.copy_((1.0 - b1) * gf + b1 * m.to(torch.float32))
            n.copy_((1.0 - b2) * gf * gf + b2 * n.to(torch.float32))
            mf, nf = m.to(torch.float32), n.to(torch.float32)
            out.append((mf / c1) / (torch.sqrt(nf / c2) + group["eps"]))
        return out


class Adagrad(Optimizer):
    """``optax.adagrad(lr)``: the sum of squared gradients from
    ``initial_accumulator_value`` 0.1, stored in the param's dtype;
    ``g / sqrt(sum + eps)`` with eps 1e-7 (0 where the sum is 0)."""

    slots = ("sum_of_squares",)

    def __init__(self, params, lr=1e-3, initial_accumulator_value=0.1, eps=1e-7, scales=None,
                 stochastic=False, offsets=None):
        super().__init__(params, dict(lr=lr, eps=eps), scales, offsets, stochastic)
        self._init_slot("sum_of_squares", initial_accumulator_value)

    def _updates(self, params, grads):
        eps = self.param_groups[0]["eps"]
        out = []
        for g, acc in zip(grads, self._moments("sum_of_squares")):
            gf = g.to(torch.float32)
            acc.copy_(gf * gf + acc.to(torch.float32))
            af = acc.to(torch.float32)
            out.append(torch.where(af > 0, torch.rsqrt(af + eps), 0.0) * gf)
        return out


class SGD(Optimizer):
    """``optax.sgd(lr)``: the gradient itself, no state."""

    def __init__(self, params, lr=1e-3, scales=None, stochastic=False, offsets=None):
        super().__init__(params, dict(lr=lr), scales, offsets, stochastic)

    def _updates(self, params, grads):
        return [g.to(torch.float32) for g in grads]


OPTIMIZERS = ("adam", "adagrad", "sgd")


def make_optimizer(cfg, params: Sequence[tuple[str, torch.Tensor]], stochastic: bool = False,
                   offsets: Optional[Sequence[int]] = None) -> Optimizer:
    """The optimizer ``cfg`` (a ``TrainConfig``) names over ``params``, the
    ``(name, param)`` pairs in JAX's flatten order: ``cfg.optimizer`` "adam"
    (``AdamSR`` where ``stochastic``, else ``Adam``), "adagrad" or "sgd"
    at ``cfg.learning_rate``, each with ``cfg.lr_scales`` after its base
    update and, where ``stochastic``, a stochastic-rounded write of the
    low-precision params. ``offsets`` as in ``scale_by_adam_sr``."""
    names = [n for n, _ in params]
    tensors = [p for _, p in params]
    lr = cfg.learning_rate
    scales = path_scales(names, cfg.lr_scales) if cfg.lr_scales else None
    if cfg.optimizer == "adam":
        if stochastic:
            mdt = cfg.moment_dtype
            return AdamSR(tensors, lr=lr, seed=cfg.seed,
                          moment_dtype=None if mdt is None else getattr(torch, mdt),
                          scales=scales, offsets=offsets)
        return Adam(tensors, lr=lr, scales=scales)
    if cfg.optimizer == "adagrad":
        return Adagrad(tensors, lr=lr, scales=scales, stochastic=stochastic, offsets=offsets)
    if cfg.optimizer == "sgd":
        return SGD(tensors, lr=lr, scales=scales, stochastic=stochastic, offsets=offsets)
    raise ValueError(cfg.optimizer)
