"""The variant-A edit's schedule and the readings of what a step served,
written from MMaDA-Parallel-A's sampler: per step a conditional forward
commits the text slots of highest confidence (``budget`` of them, greedy
tokens at text temperature 0); on the scheduled image steps the
image-unconditional forward gives ``cond + cfg_img * (cond - uncond)``
codebook logits, every unknown image position draws a code and all but
``mask_len`` of them (the least confident) are kept.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def image_steps(text_steps: int, timesteps: int) -> set:
    """The steps that refresh the image: ``timesteps`` points spaced evenly
    from ``text_steps // 4`` to the last step, rounded."""
    pts = np.round(np.linspace(text_steps // 4, text_steps - 1, timesteps))
    return {int(s) for s in pts}


def text_budget(masked0: int, steps: int, s: int) -> int:
    """Text slots committed at step ``s``: after it ``floor(masked0 *
    (steps - 1 - s) / steps)`` stay masked."""
    return (masked0 * (steps - s) // steps) - (masked0 * (steps - 1 - s)
                                               // steps)


def kept_counts(n_vq: int, unknown: int, s: int, steps: int) -> set:
    """Image codes kept at step ``s`` of ``unknown`` drawn: ``unknown -
    mask_len``, ``mask_len = clamp(min(unknown - 1, floor(n_vq *
    cos(pi/2 (s+1)/steps))), 1)``.  The ratio is taken in float64 and in
    float32 (how the program may round it), so a product that lands on an
    integer gives both counts."""
    r = (s + 1) / steps
    out = set()
    for c in (math.cos(r * math.pi / 2),
              float(np.cos(np.float32(np.float32(r) * np.float32(math.pi)
                                      * np.float32(0.5))))):
        mask_len = max(min(unknown - 1, math.floor(n_vq * c)), 1)
        out.add(unknown - mask_len)
    return out


def token_gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """The gap by which each served token's logit lies below the best
    logit of its position (``logits`` ``[N, V]``, ``served`` ``[N]``)."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, served[:, None].long())[:, 0]


def cfg_logits(cond: torch.Tensor, uncond_image: torch.Tensor,
               cfg_img: float) -> torch.Tensor:
    return cond + cfg_img * (cond - uncond_image)
