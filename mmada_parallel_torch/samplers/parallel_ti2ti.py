"""The joint parallel text+image denoiser (variant A): the exact sampler and
the feature-cached one.

Counterpart of :mod:`mmada_parallel_tpu.samplers.parallel_ti2ti`.
``generate_ti2ti``: per step one conditional full-sequence forward and a
text update; on the scheduled image steps, the uncond CFG forwards (one
batched forward when both prefixes are used), dual CFG, a categorical sample
and the MaskGit-style re-mask.  ``generate_ti2ti_cached``: the same step
(``_step``, whose argument is the cond forward), that forward replaced
between refreshes by a partial recompute of a
few text slots against a per-layer k/v cache (an opt-in approximation).  The
``lax.scan``/``lax.cond`` of the JAX samplers are a Python loop and host
booleans: the step schedules are precomputed, so the loop needs no
device-to-host sync.

``generator=None`` is fully deterministic (argmax everywhere), the parity
configuration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmada_parallel_torch.tokens import SequenceLayout
from mmada_parallel_torch.models.llada import (LLaDAConfig, llada_head,
                                               llada_hidden,
                                               llada_hidden_partial,
                                               llada_hidden_with_cache)
from mmada_parallel_torch.ops import sampling as S
from mmada_parallel_torch.ops.masks import ragged_positions
from mmada_parallel_torch.utils.spans import span

__all__ = ["TI2TIOptions", "generate_ti2ti", "generate_ti2ti_cached",
           "cached_refresh_schedule", "make_ti2ti_step", "decode_text"]


@dataclasses.dataclass(frozen=True)
class TI2TIOptions:
    """Sampler knobs (defaults = the README 512x512 edit config)."""

    text_steps: int = 128
    timesteps: int = 64                   # image refresh steps
    temperature: float = 1.0              # image sampling temperature
    text_temperature: float = 0.0
    cfg_scale: float = 0.0                # text-uncond guidance
    cfg_img: float = 4.0                  # image-uncond guidance
    remasking: str = "low_confidence"     # or "random"
    schedule: str = "cosine"
    text_vocab_size: int = 126356
    codebook_size: int = 8192
    mask_token: int = 126336


def _text_update(ids: torch.Tensor, text_logits: torch.Tensor,
                 budget: torch.Tensor, opts: TI2TIOptions,
                 layout: SequenceLayout,
                 generator: Optional[torch.Generator],
                 return_transfer: bool = False):
    """One text-transfer update; returns new ids, or ``(ids, transfer)``
    when ``return_transfer`` (the cached sampler tracks committed slots)."""
    ts, te = layout.text_start, layout.text_end
    cur = ids[:, ts:te]
    masked = cur == opts.mask_token

    u = (S.uniform_noise(text_logits, generator)
         if generator is not None and opts.text_temperature != 0 else None)
    x0 = S.gumbel_argmax(text_logits, opts.text_temperature, u)
    if opts.remasking == "low_confidence":
        conf = S.token_confidence(text_logits, x0)
    else:  # random remasking
        conf = S.uniform_noise(x0, generator, dtype=torch.float32)

    x0 = torch.where(masked, x0, cur)
    conf = torch.where(masked, conf, torch.full_like(conf, S.NEG_INF))
    transfer = S.topk_transfer_mask(conf, budget)
    out = ids.clone()
    out[:, ts:te] = torch.where(transfer, x0, cur)
    return (out, transfer) if return_transfer else out


def _cfg_plan(opts: TI2TIOptions, uncond_text_prefix, uncond_image_prefix,
              device=None):
    """Reference CFG gating: uncond forwards are built only when
    (cfg_scale>0 and a text prefix) or (cfg_img>0 and an image prefix);
    inside that branch a missing prefix stands for the cond ids (its term
    vanishes); outside it the uncond logits are zeros."""
    build_uncond = ((opts.cfg_scale > 0 and uncond_text_prefix is not None)
                    or (opts.cfg_img > 0 and uncond_image_prefix is not None))
    need_ut = build_uncond and uncond_text_prefix is not None
    need_ui = build_uncond and uncond_image_prefix is not None

    def prefix(p, need):
        return (torch.as_tensor(np.asarray(p), dtype=torch.long,
                                device=device) if need else None)

    return {"need_ut": need_ut, "need_ui": need_ui,
            "missing_is_cond": build_uncond,
            "ut_prefix": prefix(uncond_text_prefix, need_ut),
            "ui_prefix": prefix(uncond_image_prefix, need_ui)}


def _uncond_vq(params, cfg, ids, cond_vq, plan, img_pos, tvs, cb,
               attn_mask=None, position_ids=None, hidden_fn=llada_hidden):
    """Uncond CFG forwards, batched into one -> codebook logits at the image
    positions, as ``(text-uncond, image-uncond)``."""
    B = ids.shape[0]
    batch = []
    for key in ("ut", "ui"):
        if plan[f"need_{key}"]:
            p = plan[f"{key}_prefix"]
            row = ids.clone()
            row[:, :p.shape[0]] = p
            batch.append(row)
    if not batch:
        z = torch.zeros_like(cond_vq)
        return z, z
    stacked = torch.cat(batch, dim=0)
    n_rep = len(batch)
    mask2 = (attn_mask.repeat(n_rep, 1) if attn_mask is not None else None)
    pos2 = (position_ids.repeat(n_rep, 1) if position_ids is not None
            else None)
    hidden = hidden_fn(params, cfg, stacked, mask2, pos2)
    vq = llada_head(params, cfg, hidden[:, img_pos], vocab_slice=(tvs, cb))
    if plan["need_ut"] and plan["need_ui"]:
        return vq[:B], vq[B:]
    other = cond_vq if plan["missing_is_cond"] else torch.zeros_like(vq)
    return (vq, other) if plan["need_ut"] else (other, vq)


def _image_update(ids: torch.Tensor, cond_vq: torch.Tensor,
                  ut_vq: torch.Tensor, ui_vq: torch.Tensor,
                  img_pos: torch.Tensor, mask_ratio: torch.Tensor,
                  img_temp: torch.Tensor, opts: TI2TIOptions,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """One scheduled image refresh; ``*_vq`` are ``[B, N_vq, codebook]``
    logits at the image positions.  Returns new ids."""
    tvs, cb = opts.text_vocab_size, opts.codebook_size
    cur = ids[:, img_pos]
    unknown = cur == opts.mask_token
    cur_codes = (cur - tvs).clamp(0, cb - 1)

    logits = cond_vq
    if opts.cfg_scale != 0.0:
        logits = logits + opts.cfg_scale * (cond_vq - ut_vq)
    if opts.cfg_img != 0.0:
        logits = logits + opts.cfg_img * (cond_vq - ui_vq)

    noisy = generator is not None and opts.temperature != 0
    g = S.gumbel_noise(logits, generator) if noisy else None
    sampled = S.categorical_sample(logits, opts.temperature == 0, g)
    sampled = torch.where(unknown, sampled, cur_codes).clamp(0, cb - 1)

    probs = torch.softmax(logits, dim=-1)
    sel = torch.gather(probs, -1, sampled[..., None])[..., 0]
    sel = torch.where(unknown, sel,
                      torch.full_like(sel, torch.finfo(sel.dtype).max))

    n_vq = cur.shape[1]
    unknown_counts = unknown.sum(dim=-1)
    mask_len = torch.floor(n_vq * mask_ratio).long()
    mask_len = torch.clamp(torch.minimum(unknown_counts - 1, mask_len), min=1)

    z = S.normal_noise(sel, generator) if noisy else None
    remask = S.remask_lowest_exact(mask_len, sel, img_temp, z)

    new_vals = torch.where(remask, torch.full_like(sampled, opts.mask_token),
                           sampled + tvs)
    out = ids.clone()
    out[:, img_pos] = new_vals.to(ids.dtype)
    return out


def _heads(params, cfg, hidden, layout: SequenceLayout, img_pos,
           opts: TI2TIOptions):
    """The text span's logits and the image positions' codebook logits."""
    return (llada_head(params, cfg, hidden[:, layout.text_start:
                                           layout.text_end]),
            llada_head(params, cfg, hidden[:, img_pos], vocab_slice=(
                opts.text_vocab_size, opts.codebook_size)))


def _step(params, cfg, layout: SequenceLayout, opts: TI2TIOptions,
          uncond_text_prefix, uncond_image_prefix, img_pos, cond: Callable,
          hidden_fn: Callable, attn_mask=None, pos_ids=None,
          device=None) -> Callable:
    """The step of both samplers, ``step(ids, step_idx, budget, generator)
    -> (ids, transfer)`` (``transfer``: the text slots it committed), around
    the sampler's cond forward and heads ``cond(ids, step_idx) ->
    (text_logits, cond_vq)``; the image steps' uncond forwards run
    ``hidden_fn``.  The image-step schedule is a host bool array."""
    steps = opts.text_steps
    ratios = (torch.arange(steps, dtype=torch.float32, device=device)
              + 1) / steps
    mask_ratios = S.get_mask_schedule(opts.schedule)(ratios)
    img_temps = opts.temperature * (1.0 - ratios)
    img_step = S.image_step_mask(steps, opts.timesteps)
    plan = _cfg_plan(opts, uncond_text_prefix, uncond_image_prefix, device)
    tvs, cb = opts.text_vocab_size, opts.codebook_size

    def step(ids: torch.Tensor, step_idx: int, budget: torch.Tensor,
             generator: Optional[torch.Generator]):
        with span("ti2ti.step"):
            with span("ti2ti.cond"):
                text_logits, cond_vq = cond(ids, step_idx)
            with span("ti2ti.text_update"):
                ids, transfer = _text_update(ids, text_logits, budget, opts,
                                             layout, generator,
                                             return_transfer=True)
            if img_step[step_idx]:
                with span("ti2ti.uncond"):
                    ut_vq, ui_vq = _uncond_vq(
                        params, cfg, ids, cond_vq, plan, img_pos, tvs, cb,
                        attn_mask=attn_mask, position_ids=pos_ids,
                        hidden_fn=hidden_fn)
                with span("ti2ti.image_update"):
                    ids = _image_update(ids, cond_vq, ut_vq, ui_vq, img_pos,
                                        mask_ratios[step_idx],
                                        img_temps[step_idx], opts, generator)
            return ids, transfer

    return step


def make_ti2ti_step(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    layout: SequenceLayout,
    opts: TI2TIOptions,
    uncond_text_prefix: Optional[np.ndarray],
    uncond_image_prefix: Optional[np.ndarray],
    attn_mask: Optional[torch.Tensor] = None,
    device=None,
    hidden_fn: Optional[Callable] = None,
) -> Callable:
    """Build one denoising step ``step(ids, step_idx, budget, generator) ->
    ids``; the image-step schedule inside it is a host bool array.

    ``attn_mask`` (``[B, L]`` bool, True = real) hides pad positions and
    re-ranks RoPE positions so each row reproduces its unpadded run.
    ``hidden_fn`` swaps the backbone (``llada_hidden``'s signature); the
    ring tensor-parallel backbone plugs in through
    :func:`mmada_parallel_torch.parallel.tp_overlap.ring_hidden_fn`."""
    if hidden_fn is None:
        hidden_fn = llada_hidden
    pos_ids = ragged_positions(attn_mask) if attn_mask is not None else None
    img_pos = torch.as_tensor(layout.image_positions(), dtype=torch.long,
                              device=device)

    def cond(ids, step_idx):
        hidden = hidden_fn(params, cfg, ids, attn_mask, pos_ids)
        return _heads(params, cfg, hidden, layout, img_pos, opts)

    step = _step(params, cfg, layout, opts, uncond_text_prefix,
                 uncond_image_prefix, img_pos, cond, hidden_fn, attn_mask,
                 pos_ids, device)
    return lambda ids, step_idx, budget, generator: step(
        ids, step_idx, budget, generator)[0]


@torch.inference_mode()
def generate_ti2ti(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,
    layout: SequenceLayout,
    opts: TI2TIOptions = TI2TIOptions(),
    uncond_text_prefix: Optional[np.ndarray] = None,
    uncond_image_prefix: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    attn_mask: Optional[torch.Tensor] = None,
    hidden_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the full denoising trajectory.

    Args:
        input_ids: ``[B, L]`` assembled sequence
            (:func:`mmada_parallel_tpu.tokens.assemble_ti2ti_sequence`),
            on the device the params live on.
        uncond_text_prefix / uncond_image_prefix: CFG negative prefixes
            (they overwrite ``ids[:, :len(prefix)]``).
        generator: ``None`` -> fully deterministic (argmax everywhere).
        attn_mask: optional ``[B, L]`` bool (True = real) for ragged batches.
        hidden_fn: optional backbone override (``llada_hidden``'s
            signature); pass
            :func:`mmada_parallel_torch.parallel.tp_overlap.ring_hidden_fn`
            to run the trajectory tensor-parallel over a mesh.

    Returns:
        ``(final_ids [B, L], image_codes [B, N_vq])`` as int64 tensors.
    """
    if opts.remasking == "random" and generator is None:
        raise ValueError("remasking='random' requires a generator")
    device = input_ids.device
    step = make_ti2ti_step(params, cfg, layout, opts, uncond_text_prefix,
                           uncond_image_prefix, attn_mask, device, hidden_fn)
    ts, te = layout.text_start, layout.text_end
    ids = input_ids.long()
    masked0 = (ids[:, ts:te] == opts.mask_token).sum(dim=1)
    budgets = S.get_num_transfer_tokens(masked0, opts.text_steps)
    for s in range(opts.text_steps):
        ids = step(ids, s, budgets[:, s], generator)
    return ids, _final_codes(ids, layout, opts, generator)


def _final_codes(ids: torch.Tensor, layout: SequenceLayout,
                 opts: TI2TIOptions,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """Image codes ``[B, N_vq]`` from the final ids.  The per-step re-mask
    keeps >= 1 token masked even on the last step; the reference fills
    still-masked positions with a random code at extraction (deterministic
    mode fills with 0)."""
    img_pos = torch.as_tensor(layout.image_positions(), dtype=torch.long,
                              device=ids.device)
    img_tokens = ids[:, img_pos]
    codes = (img_tokens - opts.text_vocab_size).clamp(
        0, opts.codebook_size - 1)
    still_masked = img_tokens == opts.mask_token
    if generator is not None:
        fill = S.randint_noise(codes, opts.codebook_size, generator)
    else:
        fill = torch.zeros_like(codes)
    return torch.where(still_masked, fill, codes)


def cached_refresh_schedule(steps: int, timesteps: int,
                            refresh_interval: int = 4,
                            warmup_ratio: float = 0.25) -> np.ndarray:
    """Host bool ``[steps]``: the steps of :func:`generate_ti2ti_cached`
    that run a full forward.  Image steps, the step after each image step
    (its writes made the cached k/v at image positions stale, which the
    text-span tracking does not cover), the warmup, and every
    ``refresh_interval``-th step since the last refresh."""
    img_step = S.image_step_mask(steps, timesteps)
    refresh = img_step.copy()
    refresh[1:] |= img_step[:-1]
    refresh[:int(steps * warmup_ratio) + 1] = True
    last = 0
    for s in range(steps):
        if refresh[s]:
            last = s
        elif s - last >= refresh_interval:
            refresh[s] = True
            last = s
    return refresh


@torch.inference_mode()
def generate_ti2ti_cached(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,
    layout: SequenceLayout,
    opts: TI2TIOptions,
    cache_ratio: float = 0.95,
    refresh_interval: int = 4,
    warmup_ratio: float = 0.25,
    uncond_text_prefix: Optional[np.ndarray] = None,
    uncond_image_prefix: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TI2TI with the adaptive feature cache on the cond trajectory.

    Steps of :func:`cached_refresh_schedule` run full forwards, rebuilding
    the per-layer k/v cache; the other (text-only) steps recompute just
    ``n_sel = ceil(text_len/steps) + 1 + ceil((1 - cache_ratio) * text_len)``
    text slots against it: every slot committed on the previous step (its
    cached k/v is stale) plus the lowest-confidence still-masked slots.
    Logits elsewhere are reused, so this is an approximation; with
    ``refresh_interval=1`` every step refreshes and the trajectory equals
    :func:`generate_ti2ti`.  The uncond CFG forwards (image steps only)
    stay exact.  Same arguments and return as :func:`generate_ti2ti`, and
    its step (schedules, CFG plan, spans and updates) with the refresh or
    the partial forward as the cond forward."""
    if opts.remasking == "random" and generator is None:
        raise ValueError("remasking='random' requires a generator")
    device = input_ids.device
    ids = input_ids.long()
    img_pos = torch.as_tensor(layout.image_positions(), dtype=torch.long,
                              device=device)
    ts, te = layout.text_start, layout.text_end
    text_len = te - ts
    steps = opts.text_steps
    refresh = cached_refresh_schedule(steps, opts.timesteps,
                                      refresh_interval, warmup_ratio)
    n_sel = min(math.ceil(text_len / steps) + 1
                + max(math.ceil((1.0 - cache_ratio) * text_len), 1),
                text_len)
    cache = text_logits = vq = None
    changed = torch.zeros((ids.shape[0], text_len), dtype=torch.bool,
                          device=device)

    def cond(ids, s):               # refresh[0] is always True
        nonlocal cache, text_logits, vq
        if refresh[s]:
            cache = None                          # free the old one first
            hidden, cache = llada_hidden_with_cache(params, cfg, ids)
            text_logits, vq = _heads(params, cfg, hidden, layout, img_pos,
                                     opts)
            return text_logits, vq
        masked = ids[:, ts:te] == opts.mask_token
        conf = torch.softmax(text_logits, dim=-1).amax(dim=-1)
        score = changed.float() * 1e6 + masked.float() * (1.0 - conf)
        # stable: unmasked, unchanged slots all score 0
        sel_slot = torch.sort(-score, dim=-1, stable=True).indices[:, :n_sel]
        sel_pos = ts + sel_slot
        h_sel, cache = llada_hidden_partial(
            params, cfg, torch.gather(ids, 1, sel_pos), sel_pos, cache)
        logits_sel = llada_head(params, cfg, h_sel)
        text_logits.scatter_(1, sel_slot[:, :, None].expand_as(logits_sel),
                             logits_sel.to(text_logits.dtype))
        return text_logits, vq

    step = _step(params, cfg, layout, opts, uncond_text_prefix,
                 uncond_image_prefix, img_pos, cond, llada_hidden,
                 device=device)
    budgets = S.get_num_transfer_tokens(
        (ids[:, ts:te] == opts.mask_token).sum(dim=1), steps)
    for s in range(steps):
        # both kinds of step consume the previous step's commits, so the
        # slots that go stale are exactly this step's transfers
        ids, changed = step(ids, s, budgets[:, s], generator)
    return ids, _final_codes(ids, layout, opts, generator)


def decode_text(final_ids, layout: SequenceLayout, opts: TI2TIOptions,
                tokenizer=None):
    """Host-side text extraction; a single row ``[L]`` or a batch
    ``[B, L]`` (first row used)."""
    arr = (final_ids.cpu().numpy() if isinstance(final_ids, torch.Tensor)
           else np.asarray(final_ids))
    if arr.ndim == 2:
        arr = arr[0]
    text = [int(t) for t in arr[layout.text_start:layout.text_end]
            if int(t) != opts.mask_token]
    if tokenizer is None:
        return text
    return tokenizer.decode(text, skip_special_tokens=True)
