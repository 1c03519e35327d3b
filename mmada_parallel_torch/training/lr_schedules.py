"""Learning-rate schedules of both variants.

Counterpart of :mod:`mmada_parallel_tpu.training.lr_schedules`: the A
half-cosine with warmup, and the M HF-style factory (constant,
constant_with_warmup, linear, cosine with ``num_cycles``,
cosine_with_min_lr, polynomial).  Each returns a plain ``step -> lr``
function of the 0-based update index (optax passes its update count, which
starts at 0), in Python floats.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

__all__ = ["half_cosine_with_warmup", "get_scheduler"]

Schedule = Callable[[int], float]


def half_cosine_with_warmup(base_lr: float, warmup_steps: int,
                            total_steps: int, min_lr: float = 0.0
                            ) -> Schedule:
    """Variant A: linear warmup, then half a cosine down to ``min_lr``."""

    def fn(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(warmup_steps, 1)
        prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return min_lr + (base_lr - min_lr) * 0.5 * (1 + math.cos(math.pi
                                                                 * prog))

    return fn


def get_scheduler(name: str, base_lr: float, warmup_steps: int = 0,
                  total_steps: Optional[int] = None, num_cycles: float = 0.5,
                  min_lr_scale: float = 0.0, power: float = 1.0) -> Schedule:
    """The HF-style schedule factory of variant M."""

    def warmup(step) -> float:
        return min(float(step) / max(warmup_steps, 1), 1.0)

    if name == "constant":
        return lambda step: float(base_lr)
    if name == "constant_with_warmup":
        return lambda step: base_lr * warmup(step)
    if total_steps is None:
        raise ValueError(f"schedule {name} needs total_steps")

    def progress(step) -> float:
        denom = max(total_steps - warmup_steps, 1)
        return min(max((float(step) - warmup_steps) / denom, 0.0), 1.0)

    def cosine(step) -> float:
        return 0.5 * (1.0 + math.cos(math.pi * 2.0 * num_cycles
                                     * progress(step)))

    if name == "linear":
        return lambda step: base_lr * warmup(step) * (1.0 - progress(step))
    if name == "cosine":
        return lambda step: base_lr * warmup(step) * max(0.0, cosine(step))
    if name == "cosine_with_min_lr":
        return lambda step: base_lr * warmup(step) * (
            min_lr_scale + (1.0 - min_lr_scale) * max(0.0, cosine(step)))
    if name == "polynomial":
        return lambda step: base_lr * warmup(step) * (
            (1.0 - progress(step)) ** power)
    raise ValueError(f"unknown schedule: {name}")
