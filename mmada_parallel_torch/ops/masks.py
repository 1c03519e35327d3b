"""Padding masks, ragged RoPE positions and the training task masks.

Counterpart of :mod:`mmada_parallel_tpu.ops.masks`.  The inference part is
the pairwise padding mask, ragged positions and the bool -> additive-bias
conversion.  The training part is the omni task-mask family (t2i: causal
with bidirectional image spans; mmu: causal with a full prefix; causal; the
mixed ``[t2i | lm | mmu]`` batch) in two forms from one spec:

* **dense** -- ``[B, 1, L, L]`` bool masks (True = attend);
* **prefix bounds** -- every task mask here is a per-row prefix,
  ``allowed(q, kv) == kv < bound(q)``, so :func:`prefix_bounds` /
  :func:`mixed_prefix_bounds` give an integer ``[L]`` / ``[B, L]`` array that
  ``ops.attention.rope_attention_prefix`` consumes, launching the prefix
  kernel (K4), which skips key tiles past each q tile's highest bound.

Masks are made on ``device`` (default CPU), or on ``pad_ends``' device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

__all__ = ["pairwise_padding_mask", "ragged_positions", "to_bias",
           "causal_mask", "t2i_mask", "mmu_mask", "mixed_mask",
           "prefix_bounds", "mixed_prefix_bounds"]


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


def causal_mask(L: int, device=None) -> torch.Tensor:
    """``q >= kv``; ``[1, 1, L, L]`` bool."""
    i = torch.arange(L, device=device)
    return (i[:, None] >= i[None, :])[None, None]


def t2i_mask(L: int, image_spans: Sequence[Tuple[int, int]],
             pad_ends: Optional[torch.Tensor] = None,
             device=None) -> torch.Tensor:
    """Causal with bidirectional image spans ``[(begin, end), ...)``.

    ``pad_ends``: optional ``[B, L]`` per-key left-pad boundary; keys left
    of it are masked except the diagonal.  Returns ``[B or 1, 1, L, L]``
    bool."""
    if pad_ends is not None:
        device = pad_ends.device
    idx = torch.arange(L, device=device)
    q, kv = idx[:, None], idx[None, :]
    full_begin, full_end = idx.clone(), idx.clone()
    for b, e in image_spans:
        inside = (idx >= b) & (idx < e)
        full_begin = torch.where(inside, b, full_begin)
        full_end = torch.where(inside, e, full_end)
    full = (kv < full_end[:, None]) & (kv >= full_begin[:, None])
    if pad_ends is None:
        return ((q >= kv) | full)[None, None]
    not_pad = ~(kv[None] < pad_ends[:, None, :])
    causal = (not_pad & (q >= kv)[None]) | (q == kv)[None]
    return (causal | full[None])[:, None]


def mmu_mask(L: int, prefix_end: int, device=None) -> torch.Tensor:
    """Causal OR full prefix; ``[1, 1, L, L]`` bool."""
    i = torch.arange(L, device=device)
    q, kv = i[:, None], i[None, :]
    return ((q >= kv) | (kv < prefix_end))[None, None]


def prefix_bounds(L: int, prefix_end: int = 0,
                  image_spans: Sequence[Tuple[int, int]] = (),
                  device=None) -> torch.Tensor:
    """Per-row exclusive key bound ``[L]`` int32 of a prefix-family task
    mask: ``dense[q, kv] == kv < bounds[q]``.  ``prefix_end=0`` and no spans
    is causal; ``prefix_end=p`` is mmu; ``image_spans`` is t2i."""
    q = torch.arange(L, dtype=torch.int32, device=device)
    hi = q + 1                                   # causal base
    if prefix_end:
        hi = hi.clamp_min(prefix_end)
    for b, e in image_spans:
        inside = (q >= b) & (q < e)
        hi = torch.where(inside, hi.clamp_min(e), hi)
    return hi


def mixed_prefix_bounds(L: int, batch_size_t2i: int, batch_size_lm: int,
                        batch_size_mmu: int,
                        image_spans: Sequence[Tuple[int, int]],
                        mmu_prefix_end: int, device=None) -> torch.Tensor:
    """``[B, L]`` bounds for the concat ``[t2i | lm | mmu]`` batch: the
    prefix form of :func:`mixed_mask` (unpadded)."""
    rows = ([prefix_bounds(L, 0, image_spans, device)] * batch_size_t2i
            + [prefix_bounds(L, device=device)] * batch_size_lm
            + [prefix_bounds(L, mmu_prefix_end, device=device)]
            * batch_size_mmu)
    return torch.stack(rows, dim=0)


def mixed_mask(L: int, batch_size_t2i: int, batch_size_lm: int,
               batch_size_mmu: int, image_spans: Sequence[Tuple[int, int]],
               mmu_prefix_end: int,
               pad_ends: Optional[torch.Tensor] = None,
               device=None) -> torch.Tensor:
    """Per-row task mask for a concat ``[t2i | lm | mmu]`` batch;
    ``[B, 1, L, L]`` bool."""
    if pad_ends is not None:
        device = pad_ends.device
    t2i = t2i_mask(L, image_spans,
                   pad_ends[:batch_size_t2i] if pad_ends is not None else None,
                   device)
    t2i = t2i.expand(batch_size_t2i, 1, L, L)
    lm = causal_mask(L, device).expand(batch_size_lm, 1, L, L)
    mmu = mmu_mask(L, mmu_prefix_end, device).expand(batch_size_mmu, 1, L, L)
    return torch.cat([t2i, lm, mmu], dim=0)
