"""Forward-process (noising) masking for training, batched.

Counterpart of :mod:`mmada_parallel_tpu.training.masking`:

* variant A ``mask_codes``: cosine/linear per-row mask ratio, a uniform
  random subset of positions, labels at the masked positions only;
* variant M t2i ``mask_tokens_schedule``: per-row timestep -> schedule ->
  rounded mask count, a random-permutation subset (or an approximate
  rectangle of the token grid), MASK or random codebook tokens;
* M interleave ``interleave_noising``, with the "double cosine"
  ``mask_prob = cos(clip(schedule(t), eps) * pi/2)``: the image masked by a
  random subset of ``round(N * p)`` (at least 1) positions, the text by
  per-position Bernoulli(p) with the first token kept.

Each public function draws its uniforms (and random tokens) from an explicit
``torch.Generator`` and hands them to a private ``_apply`` step.  Given the
same draws the masks are exactly JAX's: the subset rule is
``argsort(u)[j] < num`` with a stable sort, as ``jnp.argsort`` is stable.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from mmada_parallel_torch.ops import sampling as S

__all__ = ["mask_codes", "mask_tokens_schedule", "interleave_noising"]


def _uniform(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def _subset(order_u: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """Position ``j`` of a row is chosen iff ``argsort(u)[j] < num``: a
    uniform random subset of ``num`` positions."""
    return torch.argsort(order_u, dim=-1, stable=True) < num[:, None]


# ---------------------------------------------------------------------------
# Variant A
# ---------------------------------------------------------------------------


def _mask_codes_apply(codes: torch.Tensor, u: torch.Tensor,
                      order_u: torch.Tensor, schedule: str,
                      force_full_below: int, mask_token: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, L = codes.shape
    if schedule == "cosine":
        ratio = torch.cos(u * math.pi / 2)
    elif schedule == "linear":
        ratio = torch.where(u < 0.05, u + 0.05, u)
    else:
        raise ValueError(schedule)
    if force_full_below > 0 and L <= force_full_below:
        ratio = torch.ones_like(ratio)
    num = (L * ratio).to(torch.int32).clamp_min(1)
    mask = _subset(order_u, num)
    masked = torch.where(mask, mask_token, codes)
    labels = torch.where(mask, codes, -100)
    return masked, labels


def mask_codes(generator: torch.Generator, codes: torch.Tensor,
               schedule: str = "cosine", force_full_below: int = 0,
               mask_token: int = 126336
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Variant-A per-sequence masking: ``(masked_codes, labels)``.

    ``codes``: ``[B, L]``.  Ratio ``cos(u * pi/2)`` (or linear with the
    ``u < 0.05 -> u + 0.05`` bump); at least one position is masked.
    Sequences no longer than ``force_full_below`` are masked whole."""
    B, L = codes.shape
    u = _uniform(generator, (B,), codes.device)
    order_u = _uniform(generator, (B, L), codes.device)
    return _mask_codes_apply(codes, u, order_u, schedule, force_full_below,
                             mask_token)


# ---------------------------------------------------------------------------
# Variant M, t2i
# ---------------------------------------------------------------------------


def _mask_tokens_schedule_apply(
        image_tokens: torch.Tensor, t: torch.Tensor,
        order_u: Optional[torch.Tensor], rect_u: Optional[Tuple[torch.Tensor,
                                                                ...]],
        rnd: Optional[torch.Tensor], schedule: Callable,
        min_masking_rate: float, mask_token: int, noise_type: str,
        mask_contiguous_region: bool, predict_all_tokens: bool):
    B, L = image_tokens.shape
    mask_prob = schedule(t).clamp_min(min_masking_rate)
    num = torch.round(L * mask_prob).to(torch.int32).clamp_min(1)

    if mask_contiguous_region:
        # an approximate rectangle on the sqrt(L) grid: height uniform in
        # the valid range, width ceil(num / height), random top-left corner
        res = int(round(L ** 0.5))
        u, uy, ux = rect_u
        hmin = torch.ceil(num / res).to(torch.int32)
        hmax = num.clamp_max(res)
        h = (hmin + (u * (hmax - hmin + 1)).to(torch.int32)).clamp(1, res)
        w = torch.ceil(num / h).to(torch.int32).clamp_max(res)
        ty = (uy * (res - h + 1)).to(torch.int32)
        tx = (ux * (res - w + 1)).to(torch.int32)
        rows = torch.arange(res, device=t.device)[None, :, None]
        cols = torch.arange(res, device=t.device)[None, None, :]
        grid = ((rows >= ty[:, None, None])
                & (rows < (ty + h)[:, None, None])
                & (cols >= tx[:, None, None])
                & (cols < (tx + w)[:, None, None]))
        mask = grid.reshape(B, res * res)[:, :L]
    else:
        mask = _subset(order_u, num)

    if noise_type == "mask":
        input_ids = torch.where(mask, mask_token, image_tokens)
    elif noise_type == "random_replace":
        input_ids = torch.where(mask, rnd.to(image_tokens.dtype),
                                image_tokens)
    else:
        raise ValueError(noise_type)

    if predict_all_tokens or noise_type == "random_replace":
        labels = image_tokens
    else:
        labels = torch.where(mask, image_tokens, -100)
    return input_ids, labels, mask_prob


def mask_tokens_schedule(
        generator: torch.Generator, image_tokens: torch.Tensor,
        schedule: Callable[[torch.Tensor], torch.Tensor] = S.cosine_schedule,
        min_masking_rate: float = 0.0, mask_token: int = 126336,
        noise_type: str = "mask", codebook_size: int = 8192,
        mask_contiguous_region: bool = False,
        predict_all_tokens: bool = False
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Variant-M t2i masking: ``(input_ids, labels, mask_prob)``.

    ``noise_type="random_replace"`` puts random codebook tokens in place of
    MASK; ``mask_contiguous_region`` masks an approximate rectangle of the
    square token grid; ``predict_all_tokens`` labels every position (the
    caller weights the loss with ``mask_prob``)."""
    B, L = image_tokens.shape
    dev = image_tokens.device
    t = _uniform(generator, (B,), dev)
    order_u = rect_u = rnd = None
    if mask_contiguous_region:
        rect_u = tuple(_uniform(generator, (B,), dev) for _ in range(3))
    else:
        order_u = _uniform(generator, (B, L), dev)
    if noise_type == "random_replace":
        rnd = torch.randint(0, codebook_size, (B, L), generator=generator,
                            device=dev)
    return _mask_tokens_schedule_apply(
        image_tokens, t, order_u, rect_u, rnd, schedule, min_masking_rate,
        mask_token, noise_type, mask_contiguous_region, predict_all_tokens)


# ---------------------------------------------------------------------------
# Variant M, interleave
# ---------------------------------------------------------------------------


def _interleave_noising_apply(output_image_tokens: torch.Tensor,
                              output_text_ids: torch.Tensor,
                              t_u: torch.Tensor, img_u: torch.Tensor,
                              text_u: torch.Tensor, eps: float,
                              schedule: Callable, mask_token: int):
    N = output_image_tokens.shape[1]
    t = t_u * (1 - eps) + eps
    mask_prob = torch.cos(schedule(t).clamp_min(eps) * math.pi * 0.5)
    num = torch.round(N * mask_prob).to(torch.int32).clamp_min(1)
    img_mask = _subset(img_u, num)
    noisy_img = torch.where(img_mask, mask_token, output_image_tokens)
    img_labels = torch.where(img_mask, output_image_tokens, -100)

    text_mask = text_u < mask_prob[:, None]
    text_mask[:, 0] = False                  # first token kept
    noisy_text = torch.where(text_mask, mask_token, output_text_ids)
    text_labels = torch.where(text_mask, output_text_ids, -100)
    return noisy_img, img_labels, noisy_text, text_labels, t


def interleave_noising(
        generator: torch.Generator, output_image_tokens: torch.Tensor,
        output_text_ids: torch.Tensor, eps: float = 1e-3,
        schedule: Callable[[torch.Tensor], torch.Tensor] = S.cosine_schedule,
        mask_token: int = 126336):
    """M interleave noising: ``(noisy_img, img_labels, noisy_text,
    text_labels, t)`` for ``[B, N_vq]`` image tokens (already vocab-offset)
    and ``[B, T]`` text ids."""
    B, N = output_image_tokens.shape
    T = output_text_ids.shape[1]
    dev = output_image_tokens.device
    t_u = _uniform(generator, (B,), dev)
    img_u = _uniform(generator, (B, N), dev)
    text_u = _uniform(generator, (B, T), dev)
    return _interleave_noising_apply(output_image_tokens, output_text_ids,
                                     t_u, img_u, text_u, eps, schedule,
                                     mask_token)
