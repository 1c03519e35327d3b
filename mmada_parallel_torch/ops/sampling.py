"""Masked-diffusion sampling math on tensors.

Counterpart of :mod:`mmada_parallel_tpu.ops.sampling`.  Every random op is a
deterministic core that takes its noise as a tensor argument (``None`` = no
noise, the temperature-0 path); the noise is drawn from a
:class:`torch.Generator` by the small ``*_noise`` helpers below, so a test can
hand both packages the same numbers.  The two frameworks' generators give
different numbers from one seed: exact parity exists at temperature 0 or
with injected noise.

Ties in every ranking go to the lower index (stable sorts), on any device.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
    "cosine_schedule", "linear_schedule", "pow_schedule", "sigmoid_schedule",
    "get_mask_schedule", "RowSplitGenerator", "uniform_noise",
    "normal_noise", "randint_noise", "gumbel_noise",
    "add_gumbel_noise", "gumbel_argmax", "token_confidence",
    "get_num_transfer_tokens", "get_num_transfer_tokens_frontloaded",
    "topk_transfer_mask", "remask_lowest_exact", "remask_below_cutoff",
    "categorical_sample", "top_k_top_p_filtering", "image_step_mask",
]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Mask-ratio schedules
# ---------------------------------------------------------------------------


def cosine_schedule(t: torch.Tensor) -> torch.Tensor:
    return torch.cos(t * math.pi * 0.5)


def linear_schedule(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - t, 1e-6, 1.0)


def pow_schedule(t: torch.Tensor, exponent: float) -> torch.Tensor:
    return torch.clamp(1.0 - t ** exponent, 1e-6, 1.0)


def sigmoid_schedule(t: torch.Tensor, start: float = -3.0, end: float = 3.0,
                     tau: float = 1.0, clip_min: float = 1e-6) -> torch.Tensor:
    v_start = torch.sigmoid(torch.tensor(start / tau, dtype=t.dtype))
    v_end = torch.sigmoid(torch.tensor(end / tau, dtype=t.dtype))
    out = torch.sigmoid((t * (end - start) + start) / tau)
    out = (v_end.to(t.device) - out) / (v_end - v_start).to(t.device)
    return torch.clamp(out, clip_min, 1.0)


def get_mask_schedule(method: str, **kwargs) -> Callable[[torch.Tensor],
                                                         torch.Tensor]:
    if method == "cosine":
        return cosine_schedule
    if method == "linear":
        return linear_schedule
    if method.startswith("pow"):
        return partial(pow_schedule, exponent=float(method[3:]))
    if method == "sigmoid":
        return partial(sigmoid_schedule, **kwargs)
    raise ValueError(f"Unknown schedule method: {method}")


# ---------------------------------------------------------------------------
# Noise, drawn from a generator (the only place randomness enters)
# ---------------------------------------------------------------------------


class RowSplitGenerator:
    """A generator for a rank that holds rows ``mine`` (a slice) of a
    ``rows``-row batch: each draw is made for all the rows and cut to this
    rank's, so the noise a row gets does not depend on how the batch is
    split over ranks (JAX draws one key over the global batch).  The
    ``*_noise`` helpers take it where they take a generator."""

    def __init__(self, generator: torch.Generator, rows: int, mine: slice):
        self.generator, self.rows, self.mine = generator, rows, mine


def _draw(fn, like: torch.Tensor, generator, **kw) -> torch.Tensor:
    """``fn(shape, generator=...)`` of ``like``'s shape on its device; a
    :class:`RowSplitGenerator` draws every row and keeps this rank's."""
    if isinstance(generator, RowSplitGenerator):
        shape = (generator.rows,) + tuple(like.shape[1:])
        return fn(shape, generator=generator.generator, device=like.device,
                  **kw)[generator.mine]
    return fn(like.shape, generator=generator, device=like.device, **kw)


def uniform_noise(like: torch.Tensor, generator: torch.Generator,
                  dtype=None) -> torch.Tensor:
    """``U[0, 1)`` of ``like``'s shape on its device."""
    return _draw(torch.rand, like, generator, dtype=dtype or like.dtype)


def normal_noise(like: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """``N(0, 1)`` of ``like``'s shape on its device."""
    return _draw(torch.randn, like, generator, dtype=like.dtype)


def randint_noise(like: torch.Tensor, high: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Integers uniform in ``[0, high)`` of ``like``'s shape on its
    device."""
    return _draw(partial(torch.randint, 0, high), like, generator)


def gumbel_noise(like: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """Standard Gumbel ``-log(-log(u))`` with ``u`` kept off 0."""
    u = uniform_noise(like, generator).clamp_min(
        torch.finfo(like.dtype).tiny)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Gumbel sampling and confidence
# ---------------------------------------------------------------------------


def add_gumbel_noise(logits: torch.Tensor, temperature: float,
                     u: Optional[torch.Tensor]) -> torch.Tensor:
    """``logits + temperature * Gumbel(u)`` with the reference's explicit
    ``-log(-log(u + eps) + eps)``; ``u`` is uniform noise of logits' shape.
    ``temperature == 0`` or ``u is None`` returns logits unchanged."""
    if u is None or temperature == 0:
        return logits
    g = -torch.log(-torch.log(u + 1e-10) + 1e-10)
    return logits + temperature * g


def gumbel_argmax(logits: torch.Tensor, temperature: float,
                  u: Optional[torch.Tensor]) -> torch.Tensor:
    """Gumbel-max sample (argmax at temperature 0; first index on ties)."""
    return torch.argmax(add_gumbel_noise(logits, temperature, u), dim=-1)


def token_confidence(logits: torch.Tensor, chosen: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """Softmax probability of each chosen token ``[B, L]``, as
    ``exp(logit[chosen] - logsumexp(logits))`` in ``dtype``."""
    logits = logits.to(dtype)
    lse = torch.logsumexp(logits, dim=-1)
    sel = torch.gather(logits, -1, chosen[..., None].long())[..., 0]
    return torch.exp(sel - lse)


# ---------------------------------------------------------------------------
# Transfer budgets and top-k unmasking
# ---------------------------------------------------------------------------


def get_num_transfer_tokens(masked_counts: torch.Tensor,
                            steps: int) -> torch.Tensor:
    """Variant-A per-step unmask budget ``[B, steps]`` (target-based: after
    step ``s`` ``floor(T * (steps-1-s) / steps)`` masks remain)."""
    t = masked_counts.long()[:, None]
    s = torch.arange(steps, device=t.device)[None, :]
    target_after = torch.div(t * (steps - 1 - s), steps, rounding_mode="floor")
    target_before = torch.cat([t, target_after[:, :-1]], dim=1)
    return target_before - target_after


def get_num_transfer_tokens_frontloaded(masked_counts: torch.Tensor,
                                        steps: int) -> torch.Tensor:
    """Variant-M per-step budget ``[B, steps]``: ``base + 1`` for the first
    ``remainder`` steps."""
    t = masked_counts.long()[:, None]
    base = torch.div(t, steps, rounding_mode="floor")
    rem = t % steps
    s = torch.arange(steps, device=t.device)[None, :]
    return base + (s < rem).long()


def _rank_desc(values: torch.Tensor) -> torch.Tensor:
    """Rank of each element sorted descending (0 = largest), ties to the
    lower index first."""
    order = torch.sort(-values, dim=-1, stable=True).indices
    put = torch.arange(values.shape[-1], device=values.device)
    ranks = torch.empty_like(order)
    return ranks.scatter_(-1, order, put.expand_as(order).contiguous())


def topk_transfer_mask(confidence: torch.Tensor,
                       k: torch.Tensor) -> torch.Tensor:
    """Bool ``[B, L]`` selecting exactly the per-row top-``k[b]``."""
    return _rank_desc(confidence) < k[:, None]


def remask_lowest_exact(mask_len: torch.Tensor, probs: torch.Tensor,
                        temperature, z: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Variant-A ``mask_by_random_topk``: ``log(probs + 1e-10) + temperature
    * z`` (``z`` standard normal noise, or ``None``); True for exactly the
    ``mask_len[b]`` lowest-confidence positions."""
    conf = torch.log(probs + 1e-10)
    if z is not None:
        conf = conf + temperature * z
    mask_len = mask_len.long().clamp(0, probs.shape[-1] - 1)
    return _rank_desc(-conf) < mask_len[:, None]


def remask_below_cutoff(mask_len: torch.Tensor, probs: torch.Tensor,
                        temperature, u: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Variant-M ``mask_by_random_topk``: ``log(clamp(probs, 1e-20)) +
    temperature * Gumbel(u)``; True where confidence is strictly below the
    ``mask_len``-th smallest."""
    conf = torch.log(probs.clamp_min(1e-20))
    if u is not None:
        g = -torch.log(-torch.log(u.clamp_min(1e-20)))
        conf = conf + temperature * g
    sorted_conf = torch.sort(conf, dim=-1).values
    k = mask_len.long().clamp(0, probs.shape[-1] - 1)
    cutoff = torch.gather(sorted_conf, -1, k[:, None])
    return conf < cutoff


def categorical_sample(logits: torch.Tensor, temperature_is_zero: bool = False,
                       g: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multinomial over ``softmax(logits)`` by Gumbel-max with standard
    Gumbel noise ``g``; argmax when the temperature is 0 or ``g`` is None."""
    if temperature_is_zero or g is None:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(logits + g, dim=-1)


def top_k_top_p_filtering(logits: torch.Tensor, top_k: int = 0,
                          top_p: float = 1.0,
                          min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Top-k / nucleus filtering; filtered entries become ``NEG_INF``."""
    V = logits.shape[-1]
    out = logits
    if top_k > 0:
        k = min(max(top_k, min_tokens_to_keep), V)
        kth = torch.sort(out, dim=-1).values[..., V - k][..., None]
        out = torch.where(out < kth, NEG_INF, out)
    if top_p < 1.0:
        sort_idx = torch.sort(-out, dim=-1, stable=True).indices
        sorted_logits = torch.gather(out, -1, sort_idx)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove = cum > top_p
        if min_tokens_to_keep > 1:
            remove[..., :min_tokens_to_keep] = False
        # shift right so the first token above the threshold survives
        remove = torch.cat([torch.zeros_like(remove[..., :1]),
                            remove[..., :-1]], dim=-1)
        scatter = torch.zeros_like(remove).scatter_(-1, sort_idx, remove)
        out = torch.where(scatter, NEG_INF, out)
    return out


# ---------------------------------------------------------------------------
# Step scheduling
# ---------------------------------------------------------------------------


def image_step_mask(text_steps: int, timesteps: int) -> np.ndarray:
    """Host bool ``[text_steps]`` mask of the scheduled image-refresh steps
    (``linspace(text_steps//4, text_steps-1, timesteps)``, rounded; rounding
    can merge steps, so count the True entries)."""
    steps = np.linspace(text_steps // 4, text_steps - 1, timesteps)
    steps = np.round(steps).astype(np.int64)
    mask = np.zeros(text_steps, dtype=bool)
    mask[steps] = True
    return mask
