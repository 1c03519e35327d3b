"""Variant-M interleave generation: the exact sampler and the feature-cached
one.

Counterpart of :mod:`mmada_parallel_tpu.samplers.interleave`.  Per step ONE
batched forward of ``cat([cond, uncond])``; text guidance
``cond + text_cfg*(uncond - cond)`` (note the sign: it differs from A's and
from the image CFG, and is kept as the reference has it); image guidance
``(1+image_cfg)*cond - image_cfg*uncond`` over the codebook slice; image
refresh on ``linspace(text_steps//4, text_steps-1, image_steps)``; confidence
top-k text transfer with the front-loaded budget, and the MaskGit cosine
re-mask with the M-style strict cutoff.  The uncond row shares the output
region with the cond row as it stands at the top of each step.  The
``lax.scan``/``lax.cond`` of the JAX samplers are a Python loop and host
booleans.

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

__all__ = ["InterleaveOptions", "interleave_generate",
           "interleave_generate_cached", "interleave_refresh_schedule",
           "make_interleave_heads"]


@dataclasses.dataclass(frozen=True)
class InterleaveOptions:
    """Defaults = the reference M inference settings."""

    text_steps: int = 128
    image_steps: int = 30
    text_cfg: float = 2.5
    image_cfg: float = 4.0
    text_temperature: float = 0.0
    image_temperature: float = 1.0
    remasking: str = "low_confidence"
    schedule: str = "cosine"
    text_vocab_size: int = 126464         # len(text_tokenizer)
    codebook_size: int = 8192
    mask_token: int = 126336


def make_interleave_heads(params, cfg, layout, opts, mask2b=None, pos2b=None,
                          hidden_fn: Optional[Callable] = None):
    """Batched cond+uncond forward -> (full-vocab text logits,
    codebook-slice image logits).  ``hidden_fn`` swaps the backbone
    (:func:`~mmada_parallel_torch.models.llada.llada_hidden` signature)."""
    ts, te = layout.text_start, layout.text_end
    ist, ien = layout.image_start, layout.image_end
    tvs, cb = opts.text_vocab_size, opts.codebook_size
    if hidden_fn is None:
        hidden_fn = llada_hidden

    def heads(ids2b):
        hidden = hidden_fn(params, cfg, ids2b, mask2b, pos2b)
        text_logits = llada_head(params, cfg, hidden[:, ts:te])
        vq_logits = llada_head(params, cfg, hidden[:, ist:ien],
                               vocab_slice=(tvs, cb))
        return text_logits, vq_logits

    return heads


def _make_update_core(opts, layout, mask_ratios, img_temps, img_step):
    """The per-step text transfer + scheduled image refresh, shared by the
    exact and cached samplers: they differ only in how the cond/uncond
    logits are computed."""
    ts, te = layout.text_start, layout.text_end
    ist, ien = layout.image_start, layout.image_end
    n_vq = ien - ist
    tvs, cb = opts.text_vocab_size, opts.codebook_size

    def apply_updates(ids, last_sampled, cond_t, uncond_t, cond_v, uncond_v,
                      step_idx: int, budget, generator):
        # --- text update ---
        guided = cond_t + opts.text_cfg * (uncond_t - cond_t)
        cur = ids[:, ts:te]
        masked = cur == opts.mask_token
        u = (S.uniform_noise(guided, generator)
             if generator is not None and opts.text_temperature != 0
             else None)
        x0 = S.gumbel_argmax(guided, opts.text_temperature, u)
        if opts.remasking == "low_confidence":
            conf = S.token_confidence(guided, x0)
        else:
            conf = S.uniform_noise(x0, generator, dtype=torch.float32)
        x0 = torch.where(masked, x0, cur)
        conf = torch.where(masked, conf, torch.full_like(conf, S.NEG_INF))
        transfer = S.topk_transfer_mask(conf, budget)
        ids = ids.clone()
        ids[:, ts:te] = torch.where(transfer, x0, cur)
        if not img_step[step_idx]:
            return ids, last_sampled

        # --- scheduled image refresh ---
        cur_img = ids[:, ist:ien]
        unknown = cur_img == opts.mask_token
        cur_codes = cur_img - tvs            # known tokens are offset codes
        img_logits = (1 + opts.image_cfg) * cond_v - opts.image_cfg * uncond_v
        noisy = generator is not None and opts.image_temperature != 0
        g = S.gumbel_noise(img_logits, generator) if noisy else None
        sampled = S.categorical_sample(img_logits,
                                       opts.image_temperature == 0, g)
        sampled = torch.where(unknown, sampled, cur_codes)

        probs = torch.softmax(img_logits, dim=-1)
        sel = torch.gather(probs, -1,
                           sampled.clamp(0, cb - 1)[..., None])[..., 0]
        sel = torch.where(unknown, sel,
                          torch.full_like(sel, torch.finfo(sel.dtype).max))
        mask_len = torch.floor(n_vq * mask_ratios[step_idx]).long()
        mask_len = torch.clamp(torch.minimum(unknown.sum(dim=-1) - 1,
                                             mask_len), min=1)
        u_img = S.uniform_noise(sel, generator) if noisy else None
        remask = S.remask_below_cutoff(mask_len, sel, img_temps[step_idx],
                                       u_img)
        ids[:, ist:ien] = torch.where(
            remask, torch.full_like(sampled, opts.mask_token),
            sampled + tvs).to(ids.dtype)
        return ids, sampled.to(last_sampled.dtype)

    return apply_updates


def _schedules(opts: InterleaveOptions, device):
    steps = opts.text_steps
    ratios = (torch.arange(steps, dtype=torch.float32, device=device)
              + 1) / steps
    mask_ratios = S.get_mask_schedule(opts.schedule)(ratios)
    img_temps = opts.image_temperature * (1.0 - ratios)
    return mask_ratios, img_temps, S.image_step_mask(steps, opts.image_steps)


def _budgets(input_ids, layout, opts):
    """M's front-loaded per-step budget ``[B, steps]`` (unlike A's
    target-based one)."""
    masked0 = (input_ids[:, layout.text_start:layout.text_end]
               == opts.mask_token).sum(dim=1)
    return S.get_num_transfer_tokens_frontloaded(masked0, opts.text_steps)


@torch.inference_mode()
def interleave_generate(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,
    uncond_input_ids: torch.Tensor,
    layout: SequenceLayout,
    opts: InterleaveOptions = InterleaveOptions(),
    generator: Optional[torch.Generator] = None,
    attn_mask: Optional[torch.Tensor] = None,
    uncond_attn_mask: Optional[torch.Tensor] = None,
    hidden_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(final_ids [B, L], image_codes [B, N_vq])``; the codes are
    the last image step's pre-remask samples, as the reference returns.

    ``input_ids``/``uncond_input_ids`` are full assembled sequences of equal
    length (:func:`mmada_parallel_tpu.tokens.assemble_interleave_sequence`);
    only the uncond prompt region is read, the output region follows the
    cond row.  ``attn_mask`` (``[B, L]`` bool, True = real) hides pads and
    re-ranks RoPE positions; ``uncond_attn_mask`` gives the uncond rows
    their own pad pattern (default: ``attn_mask``)."""
    if opts.remasking == "random" and generator is None:
        raise ValueError("remasking='random' requires a generator")
    ids = input_ids.long()
    B = ids.shape[0]
    prompt_len = layout.code_start
    mask_ratios, img_temps, img_step = _schedules(opts, ids.device)
    budgets = _budgets(ids, layout, opts)
    uncond_prompt = uncond_input_ids.long()[:, :prompt_len]

    mask2b = pos2b = None
    if attn_mask is not None or uncond_attn_mask is not None:
        cm = (attn_mask if attn_mask is not None
              else torch.ones(ids.shape, dtype=torch.bool, device=ids.device))
        um = cm if uncond_attn_mask is None else uncond_attn_mask
        mask2b = torch.cat([cm, um], dim=0)
        pos2b = torch.cat([ragged_positions(cm), ragged_positions(um)], dim=0)
    heads = make_interleave_heads(params, cfg, layout, opts, mask2b, pos2b,
                                  hidden_fn)
    apply_updates = _make_update_core(opts, layout, mask_ratios, img_temps,
                                      img_step)

    last_sampled = torch.zeros((B, layout.image_end - layout.image_start),
                               dtype=ids.dtype, device=ids.device)
    for s in range(opts.text_steps):
        both = torch.cat([ids, torch.cat([uncond_prompt,
                                          ids[:, prompt_len:]], dim=1)])
        text2, vq2 = heads(both)
        ids, last_sampled = apply_updates(ids, last_sampled, text2[:B],
                                          text2[B:], vq2[:B], vq2[B:], s,
                                          budgets[:, s], generator)
    return ids, last_sampled.clamp(0, opts.codebook_size - 1)


def interleave_refresh_schedule(steps: int, image_steps: int,
                                refresh_interval: int = 4,
                                warmup_ratio: float = 0.25,
                                refresh_on_image_steps: bool = True
                                ) -> np.ndarray:
    """Host bool ``[steps]``: the steps of :func:`interleave_generate_cached`
    that run a full forward.  The warmup, every ``refresh_interval``-th step
    after it, and (by default) each image step and the step after it (the
    image step rewrites the image span at its end, so the cached k/v there
    go stale)."""
    warmup = int(steps * warmup_ratio)
    s = np.arange(steps)
    refresh = (s <= warmup) | ((s - warmup) % refresh_interval == 0)
    if refresh_on_image_steps:
        img = S.image_step_mask(steps, image_steps)
        refresh |= img
        refresh[1:] |= img[:-1]
    return refresh


@torch.inference_mode()
def interleave_generate_cached(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,
    uncond_input_ids: torch.Tensor,
    layout: SequenceLayout,
    opts: InterleaveOptions = InterleaveOptions(),
    cache_ratio: float = 0.95,
    refresh_interval: int = 4,
    warmup_ratio: float = 0.25,
    refresh_on_image_steps: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interleave generation with the adaptive feature cache (an opt-in
    approximation; the exact path is :func:`interleave_generate`).

    Steps of :func:`interleave_refresh_schedule` run full cond+uncond
    forwards and rebuild the shared ``[n_layers, 2B, L]`` k/v cache.  In
    between, only the text span (it changes every step) plus the
    ``ceil((1 - cache_ratio) * n_vq)`` lowest-confidence image slots are
    recomputed against the cache; image logits elsewhere are reused.  With
    ``refresh_interval=1`` every step refreshes and the trajectory equals
    the exact sampler's.  No ragged ``attn_mask``: serve cached requests
    unpadded."""
    if opts.remasking == "random" and generator is None:
        raise ValueError("remasking='random' requires a generator")
    ids = input_ids.long()
    B = ids.shape[0]
    dev = ids.device
    ts, te = layout.text_start, layout.text_end
    max_seq = te - ts
    ist, ien = layout.image_start, layout.image_end
    n_vq = ien - ist
    prompt_len = layout.code_start
    tvs, cb = opts.text_vocab_size, opts.codebook_size
    n_compute = max(math.ceil((1.0 - cache_ratio) * n_vq), 1)
    mask_ratios, img_temps, img_step = _schedules(opts, dev)
    budgets = _budgets(ids, layout, opts)
    uncond_prompt = uncond_input_ids.long()[:, :prompt_len]
    apply_updates = _make_update_core(opts, layout, mask_ratios, img_temps,
                                      img_step)
    refresh = interleave_refresh_schedule(
        opts.text_steps, opts.image_steps, refresh_interval, warmup_ratio,
        refresh_on_image_steps)
    text_pos = torch.arange(ts, te, device=dev)[None].expand(2 * B, max_seq)

    cache = vq = None
    last_sampled = torch.zeros((B, n_vq), dtype=ids.dtype, device=dev)
    for s in range(opts.text_steps):      # refresh[0] is always True
        both = torch.cat([ids, torch.cat([uncond_prompt,
                                          ids[:, prompt_len:]], dim=1)])
        if refresh[s]:
            cache = None                  # free the old one first
            hidden, cache = llada_hidden_with_cache(params, cfg, both)
            text2 = llada_head(params, cfg, hidden[:, ts:te])
            vq = llada_head(params, cfg, hidden[:, ist:ien],
                            vocab_slice=(tvs, cb)).float()
            del hidden
        else:
            # stable ascending sort: ties go to the lower slot, as argsort
            sel_slot = torch.sort(vq.amax(dim=-1), dim=-1,
                                  stable=True).indices[:, :n_compute]
            pos = torch.cat([text_pos, ist + sel_slot], dim=1)
            h_sel, cache = llada_hidden_partial(
                params, cfg, torch.gather(both, 1, pos), pos, cache)
            text2 = llada_head(params, cfg, h_sel[:, :max_seq])
            vq_sel = llada_head(params, cfg, h_sel[:, max_seq:],
                                vocab_slice=(tvs, cb))
            vq.scatter_(1, sel_slot[:, :, None].expand_as(vq_sel),
                        vq_sel.float())
        text2 = text2.float()
        ids, last_sampled = apply_updates(ids, last_sampled, text2[:B],
                                          text2[B:], vq[:B], vq[B:], s,
                                          budgets[:, s], generator)
    return ids, last_sampled.clamp(0, cb - 1)
