"""Variant-M text-to-image MaskGit sampler.

Counterpart of :mod:`mmada_parallel_tpu.samplers.t2i`: the image region is
``input_ids[:, -(num_vq+1):-1]``; per step one batched ``cat([cond,
uncond])`` forward with the uncond rows rebuilt as ``cat(uncond[:,
:prompt_len+1], cond[:, prompt_len+1:])``; muse-style CFG ``(1+g)*cond -
g*uncond`` over the codebook slice; a categorical sample; the strict-cutoff
re-mask with ``mask_len = clamp(floor(num_vq * schedule(r)), 1, unknown-1)``
and the temperature decay ``temp*(1-r)``.  The ``lax.scan`` is a Python
loop.

``generator=None`` is fully deterministic (argmax everywhere), the parity
configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from mmada_parallel_torch.models.llada import (LLaDAConfig, llada_head,
                                               llada_hidden)
from mmada_parallel_torch.ops import sampling as S

__all__ = ["T2IOptions", "t2i_generate", "t2i_step"]


@dataclasses.dataclass(frozen=True)
class T2IOptions:
    timesteps: int = 18
    temperature: float = 1.0
    guidance_scale: float = 0.0
    schedule: str = "cosine"
    text_vocab_size: int = 126464
    codebook_size: int = 8192
    mask_token: int = 126336


def t2i_step(ids: torch.Tensor, logits: torch.Tensor, ist: int,
             mask_ratio: torch.Tensor, temp: torch.Tensor, opts: T2IOptions,
             generator: Optional[torch.Generator]):
    """One MaskGit update of the image region ``[ist, ist + n)`` from its
    ``[B, n, codebook]`` logits; returns ``(ids, pre-remask samples)``."""
    n = logits.shape[1]
    cb = opts.codebook_size
    cur = ids[:, ist:ist + n]
    unknown = cur == opts.mask_token
    noisy = generator is not None and opts.temperature != 0
    g = S.gumbel_noise(logits, generator) if noisy else None
    sampled = S.categorical_sample(logits, opts.temperature == 0, g)
    sampled = torch.where(unknown, sampled, cur - opts.text_vocab_size)

    probs = torch.softmax(logits, dim=-1)
    sel = torch.gather(probs, -1, sampled.clamp(0, cb - 1)[..., None])[..., 0]
    sel = torch.where(unknown, sel,
                      torch.full_like(sel, torch.finfo(sel.dtype).max))
    mask_len = torch.floor(n * mask_ratio).long()
    mask_len = torch.clamp(torch.minimum(unknown.sum(dim=-1) - 1, mask_len),
                           min=1)
    u = S.uniform_noise(sel, generator) if noisy else None
    remask = S.remask_below_cutoff(mask_len, sel, temp, u)
    ids = ids.clone()
    ids[:, ist:ist + n] = torch.where(
        remask, torch.full_like(sampled, opts.mask_token),
        sampled + opts.text_vocab_size)
    return ids, sampled


@torch.inference_mode()
def t2i_generate(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,
    uncond_input_ids: Optional[torch.Tensor] = None,
    prompt_len: int = 0,
    num_vq_tokens: int = 1024,
    opts: T2IOptions = T2IOptions(),
    attn_mask: Optional[torch.Tensor] = None,
    uncond_attn_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns the sampled image codes ``[B, num_vq_tokens]``: the last
    step's pre-remask samples (every slot filled), clipped to the codebook.

    ``prompt_len`` plays the reference's ``resolution`` role: the uncond row
    is ``cat(uncond[:, :prompt_len+1], cond[:, prompt_len+1:])``.  The
    padding masks hide pads from attention but keep absolute RoPE positions
    (no re-ranking, as in JAX): a left-padded row's real tokens are all
    shifted by the same offset, which RoPE scores see only up to
    rounding."""
    ids = input_ids.long()
    B, L = ids.shape
    ist = L - (num_vq_tokens + 1)
    T = opts.timesteps
    dev = ids.device
    ratios = (torch.arange(T, dtype=torch.float32, device=dev) + 1) / T
    mask_ratios = S.get_mask_schedule(opts.schedule)(ratios)
    temps = opts.temperature * (1.0 - ratios)
    vocab = (opts.text_vocab_size, opts.codebook_size)

    use_cfg = opts.guidance_scale > 0 and uncond_input_ids is not None
    mask = attn_mask
    if use_cfg:
        un_prefix = uncond_input_ids.long()[:, :prompt_len + 1]
        mask = (torch.cat([attn_mask, uncond_attn_mask])
                if attn_mask is not None and uncond_attn_mask is not None
                else None)

    sampled = None
    for step in range(T):
        both = ids
        if use_cfg:
            both = torch.cat([ids, torch.cat([un_prefix,
                                              ids[:, prompt_len + 1:]], 1)])
        hidden = llada_hidden(params, cfg, both, mask)
        vq = llada_head(params, cfg, hidden[:, ist:ist + num_vq_tokens],
                        vocab_slice=vocab)
        del hidden
        if use_cfg:
            g = opts.guidance_scale
            vq = (1 + g) * vq[:B] - g * vq[B:]
        ids, sampled = t2i_step(ids, vq, ist, mask_ratios[step], temps[step],
                                opts, generator)
    return sampled.clamp(0, opts.codebook_size - 1)
