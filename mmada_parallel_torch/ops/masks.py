"""Padding masks and ragged RoPE positions.

Counterpart of the inference part of :mod:`mmada_parallel_tpu.ops.masks`:
the pairwise padding mask, ragged positions and the bool -> additive-bias
conversion that the samplers use.  The dense task masks and the prefix
bounds belong to training and are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["pairwise_padding_mask", "ragged_positions", "to_bias"]


def pairwise_padding_mask(attn_mask: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` bool -> ``[B, 1, L, L]`` (True where both are real)."""
    m = attn_mask.bool()
    return (m[:, :, None] & m[:, None, :])[:, None]


def ragged_positions(attn_mask: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` bool -> RoPE positions ``cumsum(mask) - 1`` (clamped at 0):
    each real token's rank among its row's real tokens, i.e. its position in
    the unpadded single-row sequence."""
    return (torch.cumsum(attn_mask.long(), dim=-1) - 1).clamp_min(0)


def to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool mask (True = attend) -> additive bias (0 / -1e30)."""
    return torch.where(mask, 0.0, -1e30).to(dtype)
