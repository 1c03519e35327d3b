"""EMA shadow parameters.

Counterpart of :mod:`mmada_parallel_tpu.training.ema`: shadow parameters
updated with the warmup-ramped decay ``1 - (1 + s / inv_gamma) ** -power``
clipped to ``[min_decay, decay]`` (0 until ``update_after_step + 1``).
:func:`ema_update` returns a new tree, as the JAX function does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mmada_parallel_torch.training.trainer import tree_map

__all__ = ["EMAConfig", "ema_init", "get_decay", "ema_update"]


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    decay: float = 0.9999
    min_decay: float = 0.0
    update_after_step: int = 0
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


def ema_init(params: Any) -> Any:
    return tree_map(lambda p: p.detach().clone(), params)


def get_decay(cfg: EMAConfig, step: int) -> float:
    """The warmup-ramped decay at ``step``."""
    s = float(max(int(step) - cfg.update_after_step - 1, 0))
    if s <= 0:
        return 0.0
    value = 1.0 - (1.0 + s / cfg.inv_gamma) ** (-cfg.power)
    return min(max(value, cfg.min_decay), cfg.decay)


@torch.no_grad()
def ema_update(cfg: EMAConfig, ema_params: Any, params: Any,
               step: int) -> Any:
    d = get_decay(cfg, step)
    return tree_map(lambda e, p: d * e + (1.0 - d) * p.to(e.dtype),
                    ema_params, params)
