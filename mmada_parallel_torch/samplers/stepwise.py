"""Streaming stepwise samplers for interactive demos.

Counterpart of :mod:`mmada_parallel_tpu.samplers.stepwise`: Python
generators that run one denoising step per iteration and yield frames for a
UI to render (the partially decoded text with mask placeholders, and a
preview of the image with its still-masked patches grayed out).

* :func:`generate_ti2ti_stepwise` -- the A edit with the demo's image
  schedule ``linspace(0, steps-1, int(steps*0.3))``, yielding ``(step, ids,
  image_codes, still_masked)``;
* :func:`t2i_generate_stepwise` -- variant-M text-to-image, the math of
  :func:`~mmada_parallel_torch.samplers.t2i.t2i_generate`, yielding ``(step,
  codes, still_masked)`` after every step;
* :func:`interleave_generate_stepwise` -- variant-M interleave, the step of
  :func:`~mmada_parallel_torch.samplers.interleave.interleave_generate`, so
  at temperature 0 its last frame equals that sampler's output.

``generator=None`` is fully deterministic.  Each generator runs its steps
under ``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mmada_parallel_torch.models.llada import (LLaDAConfig, llada_head,
                                               llada_hidden)
from mmada_parallel_torch.ops import sampling as S
from mmada_parallel_torch.samplers.interleave import (InterleaveOptions,
                                                      _budgets,
                                                      _make_update_core,
                                                      _schedules,
                                                      make_interleave_heads)
from mmada_parallel_torch.samplers.parallel_ti2ti import (TI2TIOptions,
                                                          _image_update,
                                                          _text_update)
from mmada_parallel_torch.samplers.t2i import T2IOptions, t2i_step
from mmada_parallel_torch.tokens import SequenceLayout

__all__ = ["generate_ti2ti_stepwise", "decode_text_with_masks",
           "t2i_generate_stepwise", "interleave_generate_stepwise"]


def decode_text_with_masks(ids: np.ndarray, layout: SequenceLayout,
                           tokenizer, mask_token: int,
                           mask_char: str = "▓") -> str:
    """Render the text span with mask placeholders: runs of masked tokens
    become ``▓``-blocks, and runs longer than 10 compress to
    ``▓▓▓▓▓[...n-5 more]``, as the reference app renders them."""
    span = ids[layout.text_start:layout.text_end]

    def render_run(n: int) -> str:
        if n <= 10:
            return mask_char * n
        return mask_char * 5 + f"[...{n - 5} more]"

    def decode(buf):
        return (tokenizer.decode(buf, skip_special_tokens=True)
                if hasattr(tokenizer, "decode") else str(buf))

    parts = []
    buf = []
    run = 0
    for t in span:
        if int(t) == mask_token:
            if buf:
                parts.append(decode(buf))
                buf = []
            run += 1
        else:
            if run:
                parts.append(render_run(run))
                run = 0
            buf.append(int(t))
    if run:
        parts.append(render_run(run))
    if buf:
        parts.append(decode(buf))
    return "".join(parts)


def _rows(ids, device=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(ids) if not isinstance(ids, torch.Tensor)
                        else ids, device=device).long()
    return t[None] if t.ndim == 1 else t


@torch.inference_mode()
def generate_ti2ti_stepwise(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids,
    layout: SequenceLayout,
    opts: TI2TIOptions,
    uncond_text_prefix: Optional[np.ndarray] = None,
    uncond_image_prefix: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    image_step_fraction: float = 0.3,
    yield_every: int = 5,
) -> Iterator[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """Yields ``(step, ids, image_codes, still_masked)`` (row 0, host
    arrays) every ``yield_every`` steps, on image steps and at the end.
    ``input_ids`` may be a host array; it runs on the params' device."""
    dev = params["wte"].device
    steps = opts.text_steps
    img_pos_np = layout.image_positions()
    img_pos = torch.as_tensor(img_pos_np, dtype=torch.long, device=dev)
    ts, te = layout.text_start, layout.text_end
    tvs, cb = opts.text_vocab_size, opts.codebook_size
    vocab = (tvs, cb)

    # the demo's schedule: image refreshes from the first to the last step
    n_img = max(int(steps * image_step_fraction), 1)
    sched_steps = set(np.round(np.linspace(0, steps - 1, n_img))
                      .astype(int).tolist())
    sched = S.get_mask_schedule(opts.schedule)
    prefixes = []
    if opts.cfg_scale != 0.0 and uncond_text_prefix is not None:
        prefixes.append(("ut", uncond_text_prefix))
    if opts.cfg_img != 0.0 and uncond_image_prefix is not None:
        prefixes.append(("ui", uncond_image_prefix))
    prefixes = [(k, torch.as_tensor(np.asarray(p), dtype=torch.long,
                                    device=dev)) for k, p in prefixes]

    def uncond_heads(ids, cond_vq):
        """Image-slot logits of the uncond rows; a term not asked for is
        zeros."""
        out = {"ut": torch.zeros_like(cond_vq),
               "ui": torch.zeros_like(cond_vq)}
        if not prefixes:
            return out["ut"], out["ui"]
        rows = []
        for _, p in prefixes:
            row = ids.clone()
            row[:, :p.shape[0]] = p
            rows.append(row)
        hidden = llada_hidden(params, cfg, torch.cat(rows))
        vq = llada_head(params, cfg, hidden[:, img_pos], vocab_slice=vocab)
        for i, (k, _) in enumerate(prefixes):
            out[k] = vq[i * ids.shape[0]:(i + 1) * ids.shape[0]]
        return out["ut"], out["ui"]

    ids = _rows(input_ids, dev)
    budgets = S.get_num_transfer_tokens(
        (ids[:, ts:te] == opts.mask_token).sum(dim=1), steps)
    for step in range(steps):
        hidden = llada_hidden(params, cfg, ids)
        text_logits = llada_head(params, cfg, hidden[:, ts:te])
        cond_vq = llada_head(params, cfg, hidden[:, img_pos],
                             vocab_slice=vocab)
        del hidden
        ids = _text_update(ids, text_logits, budgets[:, step], opts, layout,
                           generator)
        is_img = step in sched_steps
        if is_img:
            ut_vq, ui_vq = uncond_heads(ids, cond_vq)
            ratio = torch.tensor((step + 1) / steps, dtype=torch.float32,
                                 device=dev)
            ids = _image_update(ids, cond_vq, ut_vq, ui_vq, img_pos,
                                sched(ratio), opts.temperature * (1.0 - ratio),
                                opts, generator)
        if is_img or step % yield_every == 0 or step == steps - 1:
            ids_np = ids[0].cpu().numpy()
            img_tokens = ids_np[img_pos_np]
            yield (step + 1, ids_np, np.clip(img_tokens - tvs, 0, cb - 1),
                   img_tokens == opts.mask_token)


@torch.inference_mode()
def t2i_generate_stepwise(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids,
    uncond_input_ids,
    prompt_len: int,
    num_vq_tokens: int,
    opts: T2IOptions,
    generator: Optional[torch.Generator] = None,
) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
    """Yields ``(step, codes, still_masked)`` (row 0) after every step:
    the pre-remask samples the reference decodes for its preview, and the
    post-remask mask state for the overlay."""
    dev = params["wte"].device
    ids = _rows(input_ids, dev)
    B, L = ids.shape
    ist = L - (num_vq_tokens + 1)
    cb = opts.codebook_size
    sched = S.get_mask_schedule(opts.schedule)
    use_cfg = opts.guidance_scale > 0 and uncond_input_ids is not None
    if use_cfg:
        un_prefix = _rows(uncond_input_ids, dev)[:, :prompt_len + 1].expand(
            B, -1)
    for step in range(opts.timesteps):
        ratio = (step + 1) / opts.timesteps
        both = ids
        if use_cfg:
            both = torch.cat([ids, torch.cat([un_prefix,
                                              ids[:, prompt_len + 1:]], 1)])
        hidden = llada_hidden(params, cfg, both)
        vq = llada_head(params, cfg, hidden[:, ist:ist + num_vq_tokens],
                        vocab_slice=(opts.text_vocab_size, cb))
        del hidden
        if use_cfg:
            g = opts.guidance_scale
            vq = (1 + g) * vq[:B] - g * vq[B:]
        ids, sampled = t2i_step(
            ids, vq, ist, sched(torch.tensor(ratio, dtype=torch.float32,
                                             device=dev)),
            torch.tensor(opts.temperature * (1 - ratio), device=dev), opts,
            generator)
        cur = ids[0, ist:ist + num_vq_tokens].cpu().numpy()
        yield (step + 1, sampled[0].clamp(0, cb - 1).cpu().numpy(),
               cur == opts.mask_token)


@torch.inference_mode()
def interleave_generate_stepwise(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids,
    uncond_input_ids,
    layout: SequenceLayout,
    opts: Any = None,
    generator: Optional[torch.Generator] = None,
    yield_every: int = 5,
) -> Iterator[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """Yields ``(step, ids, image_codes, still_masked)`` (row 0) every
    ``yield_every`` steps, on image steps and at the end; the codes are
    the last image step's pre-remask samples."""
    opts = opts if opts is not None else InterleaveOptions()
    if opts.remasking == "random" and generator is None:
        raise ValueError("remasking='random' requires a generator")
    dev = params["wte"].device
    ids = _rows(input_ids, dev)
    B = ids.shape[0]
    ist, ien = layout.image_start, layout.image_end
    prompt_len = layout.code_start
    mask_ratios, img_temps, img_step = _schedules(opts, dev)
    budgets = _budgets(ids, layout, opts)
    uncond_prompt = _rows(uncond_input_ids, dev)[:, :prompt_len]
    heads = make_interleave_heads(params, cfg, layout, opts)
    apply_updates = _make_update_core(opts, layout, mask_ratios, img_temps,
                                      img_step)
    last_sampled = torch.zeros((B, ien - ist), dtype=torch.long, device=dev)
    for step in range(opts.text_steps):
        both = torch.cat([ids, torch.cat([uncond_prompt,
                                          ids[:, prompt_len:]], dim=1)])
        text2, vq2 = heads(both)
        ids, last_sampled = apply_updates(ids, last_sampled, text2[:B],
                                          text2[B:], vq2[:B], vq2[B:], step,
                                          budgets[:, step], generator)
        if img_step[step] or step % yield_every == 0 \
                or step == opts.text_steps - 1:
            ids_np = ids[0].cpu().numpy()
            yield (step + 1, ids_np,
                   last_sampled[0].clamp(0, opts.codebook_size - 1)
                   .cpu().numpy(), ids_np[ist:ien] == opts.mask_token)
