"""Learning-rate schedules: plain functions of the step.

Port of ``recommender_tpu/nn/schedules.py``. ``dlrm_warmup_cosine`` warms
up linearly to ``init_lr`` over ``warmup_steps``, then decays along a
cosine over ``decay_steps`` to ``alpha * init_lr``, constant afterwards.
It computes in float32 with numpy, as ``jnp`` computes the JAX schedule,
and returns a Python float (the float32 value): the two agree to an ulp
(numpy's float32 cosine against XLA's).
"""
from __future__ import annotations

from typing import Callable

import numpy as np


def dlrm_warmup_cosine(
    init_lr: float, warmup_steps: int, decay_steps: int, alpha: float
) -> Callable[[int], float]:
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        warm = step / f32(max(warmup_steps, 1)) * f32(init_lr)
        capped = np.minimum(step, f32(warmup_steps + decay_steps))
        frac = (capped - f32(warmup_steps)) / f32(decay_steps)
        cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
        # (1.0 - alpha) is a Python float in JAX too, rounded to f32 once
        decayed = f32(init_lr) * (f32(1.0 - alpha) * cos + f32(alpha))
        return float(warm if step <= warmup_steps else decayed)

    return schedule
