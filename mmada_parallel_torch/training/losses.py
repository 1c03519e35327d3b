"""Training losses for both variants, vectorised.

Counterpart of :mod:`mmada_parallel_tpu.training.losses`:

* variant A: masked CE over every labelled position ("interleave loss") plus
  text and image diagnostics, whose regions come from the first
  ``<answer_start>``/``<image_start>``/``<image_end>`` of each row, found by
  first-index arithmetic on ``[B, L]`` masks;
* M interleave: ``text_coeff * sum(CE_text / t) / max_seq_len + image_coeff *
  mean(CE_image)`` over fixed tail slices;
* M ``forward_process``: t2i CE on the image tail, lm/mmu CE at masked
  positions weighted ``1 / p_mask`` and ``1 / answer_length``.

Every CE is computed in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = ["token_cross_entropy", "masked_mean", "a_variant_losses",
           "m_interleave_loss", "m_forward_process_losses",
           "soft_target_cross_entropy", "masking_loss_weight"]


def soft_target_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                              soft_targets: torch.Tensor) -> torch.Tensor:
    """Soft-target CE over the class-conditional t2i head: drops the leading
    class-id token, truncates the logits to the soft-target width, zeroes
    ``-100`` positions and divides by the active count."""
    logits = logits[:, 1:, :soft_targets.shape[-1]].float()
    targets = targets[:, 1:]
    loss = -(soft_targets * torch.log_softmax(logits, dim=-1)).sum(-1)
    padding = targets == -100
    loss = torch.where(padding, 0.0, loss)
    num_active = padding.numel() - padding.sum()
    return loss.sum() / num_active.clamp_min(1)


def masking_loss_weight(t: torch.Tensor, mask: torch.Tensor,
                        min_val: float = 0.3) -> torch.Tensor:
    """Per-position weight for ``predict_all_tokens`` training: masked
    positions weigh 1, unmasked decay toward ``min_val`` as the mask
    probability ``t`` falls."""
    return 1.0 - (1.0 - mask) * ((1.0 - t) * (1.0 - min_val))[:, None]


def token_cross_entropy(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Per-token CE ``[B, L]`` in f32 with ``-100`` ignored (0 there).

    The label logit is gathered (the JAX version reduces a one-hot mask over
    the vocab so that a sharded vocab axis stays sharded; on one device the
    gather moves less memory and gives the same value).  A label outside
    the vocab selects nothing, as the one-hot reduction selects nothing, so
    its CE is the log-sum-exp."""
    valid = labels != -100
    logits = logits.float()
    V = logits.shape[-1]
    safe = torch.where(valid, labels, 0).long()
    in_vocab = (safe >= 0) & (safe < V)
    lse = torch.logsumexp(logits, dim=-1)
    sel = logits.gather(-1, safe.clamp(0, V - 1)[..., None])[..., 0]
    sel = torch.where(in_vocab, sel, 0.0)
    return torch.where(valid, lse - sel, 0.0)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum()
    return torch.where(n > 0, (values * mask).sum() / n.clamp_min(1),
                       torch.zeros((), device=values.device))


def _first_index(cond: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(first_true_index, found)`` for ``[B, L]`` bool (index 0
    where nothing is found, as ``jnp.argmax`` gives)."""
    return cond.to(torch.uint8).argmax(dim=1), cond.any(dim=1)


def a_variant_losses(logits: torch.Tensor, input_ids: torch.Tensor,
                     labels: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None,
                     t: Optional[torch.Tensor] = None,
                     answer_start_token: int = 126354,
                     answer_end_token: int = 126355,
                     image_start_token: int = 126349,
                     image_end_token: int = 126350,
                     newline_token: int = 126084,
                     debug_stats: bool = False) -> Dict[str, torch.Tensor]:
    """``{loss, interleave_loss, text_loss, image_loss}``.

    ``lengths``: true (unpadded) lengths, the fallback end of an answer with
    no ``<answer_end>``.  ``debug_stats`` adds per-region token counts and
    CE min/max."""
    B, L = input_ids.shape
    dev = input_ids.device
    ce = token_cross_entropy(logits, labels)
    valid = labels != -100
    interleave = masked_mean(ce, valid)

    pos = torch.arange(L, device=dev)[None, :]
    if lengths is None:
        lengths = torch.full((B,), L, device=dev)
    lengths = lengths.to(dev)

    ans_start, has_ans = _first_index(input_ids == answer_start_token)
    after_ans = pos >= ans_start[:, None]
    ans_end_idx, has_ans_end = _first_index(
        (input_ids == answer_end_token) & after_ans)
    ans_end = torch.where(has_ans_end, ans_end_idx, lengths)

    in_answer = after_ans & (pos < ans_end[:, None]) & has_ans[:, None]
    img_start, has_img_start = _first_index(
        (input_ids == image_start_token) & in_answer)
    after_img = pos >= img_start[:, None]
    img_end_idx, has_img_end = _first_index(
        (input_ids == image_end_token) & after_img)
    has_img = has_img_start & has_img_end

    # image positions: (img_start, img_end) exclusive, skipping newlines
    # (label -100 positions included; their CE is 0)
    img_region = (has_img[:, None]
                  & (pos > img_start[:, None]) & (pos < img_end_idx[:, None])
                  & (input_ids != newline_token))
    # text positions: after the image up to the answer end, or the whole
    # answer when no image started; a row with <image_start> and no
    # <image_end> contributes nothing
    text_with_img = (has_img[:, None]
                     & (pos > img_end_idx[:, None]) & (pos < ans_end[:, None]))
    text_no_img = ((~has_img_start)[:, None] & has_ans[:, None]
                   & (pos > ans_start[:, None]) & (pos < ans_end[:, None]))
    text_region = (text_with_img | text_no_img) & valid

    text_loss = masked_mean(ce, text_region)
    image_loss = masked_mean(ce, img_region)
    if t is not None:
        text_loss = torch.where(text_region.sum() > 0,
                                text_loss / t.mean().clamp_min(0.01),
                                text_loss)

    out = {"loss": interleave, "interleave_loss": interleave,
           "text_loss": text_loss, "image_loss": image_loss}
    if debug_stats:
        big = torch.finfo(ce.dtype).max
        for name, region in (("text", text_region), ("image", img_region)):
            n = region.sum()
            out[f"{name}_n_tokens"] = n
            out[f"{name}_loss_min"] = torch.where(
                n > 0, torch.where(region, ce, big).min(), 0.0)
            out[f"{name}_loss_max"] = torch.where(region, ce, 0.0).max()
    return out


def m_interleave_loss(logits: torch.Tensor, labels: torch.Tensor,
                      t: torch.Tensor, max_seq_length: int,
                      num_vq_tokens: int, text_coeff: float = 1.0,
                      image_coeff: float = 1.0) -> Dict[str, torch.Tensor]:
    """The M interleave loss over fixed tail slices: the last
    ``max_seq_length`` positions are text (CE / t), the ``num_vq_tokens + 2``
    before them the image span."""
    ce = token_cross_entropy(logits, labels)
    text_ce = ce[:, -max_seq_length:] / t[:, None]
    text_loss = text_ce.sum() / max_seq_length
    image_loss = ce[:, -max_seq_length - num_vq_tokens - 2:
                    -max_seq_length].mean()
    loss = text_coeff * text_loss + image_coeff * image_loss
    return {"loss": loss, "text_loss": text_loss, "image_loss": image_loss}


def m_forward_process_losses(
        logits: torch.Tensor, input_ids: torch.Tensor, labels: torch.Tensor,
        batch_size_t2i: int, batch_size_lm: int, batch_size_mmu: int,
        max_seq_length: int, p_mask_lm: Optional[torch.Tensor] = None,
        p_mask_mmu: Optional[torch.Tensor] = None,
        answer_lengths_mmu: Optional[torch.Tensor] = None,
        answer_lengths_lm: Optional[torch.Tensor] = None,
        mask_token: int = 126336) -> Dict[str, torch.Tensor]:
    """The three-task loss of M's ``forward_process`` on the concat
    ``[t2i | lm | mmu]`` batch: t2i CE over the image tail (positions
    ``max_seq_length + 1:``), lm/mmu CE at masked positions weighted
    ``1 / p_mask`` (mmu also ``1 / answer_length``)."""
    dev = logits.device
    ce = token_cross_entropy(logits, labels)
    masked = input_ids == mask_token
    valid = labels != -100
    zero = torch.zeros((), device=dev)
    one = torch.ones((), device=dev)
    out: Dict[str, torch.Tensor] = {}

    if batch_size_t2i > 0:
        out["loss_t2i"] = masked_mean(
            ce[:batch_size_t2i, max_seq_length + 1:],
            valid[:batch_size_t2i, max_seq_length + 1:])
    else:
        out["loss_t2i"] = zero

    lm_lo, lm_hi = batch_size_t2i, batch_size_t2i + batch_size_lm
    if batch_size_lm > 0:
        p = one if p_mask_lm is None else p_mask_lm
        m = masked[lm_lo:lm_hi] & valid[lm_lo:lm_hi]
        w = ce[lm_lo:lm_hi] / p.clamp_min(1e-9)
        if answer_lengths_lm is not None:
            w = w / answer_lengths_lm.clamp_min(1)
            out["loss_lm"] = (w * m).sum() / batch_size_lm
        else:
            out["loss_lm"] = (w * m).sum() / (batch_size_lm
                                              * logits.shape[1])
    else:
        out["loss_lm"] = zero

    if batch_size_mmu > 0:
        p = one if p_mask_mmu is None else p_mask_mmu
        n = one if answer_lengths_mmu is None else answer_lengths_mmu
        m = masked[-batch_size_mmu:] & valid[-batch_size_mmu:]
        w = ce[-batch_size_mmu:] / p.clamp_min(1e-9) / n.clamp_min(1)
        out["loss_mmu"] = (w * m).sum() / batch_size_mmu
    else:
        out["loss_mmu"] = zero
    return out
