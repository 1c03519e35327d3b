"""Masking-bucket diagnostics.

Mirrors ``MMaDA-Parallel-M/models/training_utils.py:299-430``: per-batch
entropy and cross-entropy bucketed by the fraction of masked tokens, a
training-health view for masked-diffusion models (high-mask buckets should
show higher CE early in training; divergence localizes to buckets).

Counterpart of :mod:`mmada_parallel_tpu.utils.diagnostics`.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

__all__ = ["masking_bucket_metrics", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)


def masking_bucket_metrics(
    logits: torch.Tensor,          # [B, L, V]
    labels: torch.Tensor,          # [B, L] (-100 ignored)
    mask_fraction: torch.Tensor,   # [B] fraction of tokens masked per row
    buckets: Sequence[float] = DEFAULT_BUCKETS,
) -> Dict[str, torch.Tensor]:
    """Per-bucket mean CE and prediction entropy.

    Returns ``{"ce_bucket_<hi>": ..., "entropy_bucket_<hi>": ...,
    "count_bucket_<hi>": ...}``; empty buckets report 0.
    """
    from mmada_parallel_torch.training.losses import token_cross_entropy

    ce = token_cross_entropy(logits, labels)         # [B, L]
    valid = labels != -100
    n_valid = valid.sum(1).clamp_min(1)
    row_ce = (ce * valid).sum(1) / n_valid            # [B]

    logp = torch.log_softmax(logits.float(), dim=-1)
    ent = -(logp.exp() * logp).sum(-1)               # [B, L]
    row_ent = (ent * valid).sum(1) / n_valid

    out: Dict[str, torch.Tensor] = {}
    lo = 0.0
    for hi in buckets:
        in_b = (mask_fraction > lo) & (mask_fraction <= hi)
        n = in_b.sum()
        denom = n.clamp_min(1)
        tag = f"{hi:.1f}"
        out[f"ce_bucket_{tag}"] = torch.where(
            n > 0, (row_ce * in_b).sum() / denom, 0.0)
        out[f"entropy_bucket_{tag}"] = torch.where(
            n > 0, (row_ent * in_b).sum() / denom, 0.0)
        out[f"count_bucket_{tag}"] = n
        lo = hi
    return out
