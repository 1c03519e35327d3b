"""Semi-autoregressive block text decoding (multimodal understanding).

Counterpart of :mod:`mmada_parallel_tpu.samplers.mmu`: the answer is decoded
in blocks of ``block_length``; within a block, ``steps_per_block``
confidence top-k transfer steps run with the confidence beyond the current
block forced to ``-inf``, so blocks complete left to right.  Optional CFG
masks the prompt in the uncond row with guidance ``uncond + (cfg+1)*(cond -
uncond)``.  The head runs on the answer span only.  The JAX scans are Python
loops; :func:`mmu_generate_fast` syncs with the host once per block to stop
early.

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
from mmada_parallel_torch.ops.masks import ragged_positions

__all__ = ["MMUOptions", "mmu_generate", "mmu_generate_fast"]


def _extend_prompt_mask(attn_mask, B: int, P: int, L: int):
    """A ``[B, P]`` prompt mask (or a ``[B, L]`` full one) -> a full-sequence
    bool mask and its re-ranked RoPE positions; the answer span is always
    real."""
    if attn_mask is None:
        return None, None
    m = attn_mask.bool()
    if m.shape[1] == P and P != L:
        m = torch.cat([m, torch.ones((B, L - P), dtype=torch.bool,
                                     device=m.device)], dim=1)
    elif m.shape[1] != L:
        raise ValueError(
            f"attn_mask length {m.shape[1]} matches neither the prompt "
            f"({P}) nor the full sequence ({L})")
    return m, ragged_positions(m)


@dataclasses.dataclass(frozen=True)
class MMUOptions:
    max_new_tokens: int = 128
    steps: int = 128
    block_length: int = 128
    temperature: float = 0.0
    cfg_scale: float = 0.0
    remasking: str = "low_confidence"
    mask_token: int = 126336


class _Decoder:
    """The state both samplers share: the initial sequence, the prompt
    mask, the per-block budget and one block step."""

    def __init__(self, params, cfg, prompt_ids, opts: MMUOptions, attn_mask,
                 generator):
        if opts.remasking == "random" and generator is None:
            raise ValueError("remasking='random' requires a generator")
        if opts.max_new_tokens % opts.block_length:
            raise ValueError("max_new_tokens must be a multiple of "
                             "block_length")
        self.num_blocks = opts.max_new_tokens // opts.block_length
        if opts.steps % self.num_blocks:
            raise ValueError("steps must be a multiple of num_blocks")
        self.spb = opts.steps // self.num_blocks       # steps per block
        self.params, self.cfg, self.opts = params, cfg, opts
        self.generator = generator
        prompt_ids = prompt_ids.long()
        B, P = prompt_ids.shape
        self.P, self.N = P, opts.max_new_tokens
        dev = prompt_ids.device
        self.x0 = torch.cat([prompt_ids, torch.full(
            (B, self.N), opts.mask_token, dtype=torch.long, device=dev)], 1)
        self.prompt_index = self.x0 != opts.mask_token
        self.attn_mask, self.pos_ids = _extend_prompt_mask(
            attn_mask, B, P, P + self.N)
        # every block starts fully masked: one static budget per block step
        # (M's front-loaded form)
        self.budgets = S.get_num_transfer_tokens_frontloaded(
            torch.full((1,), opts.block_length, device=dev), self.spb)[0]
        self.ans_pos = P + torch.arange(self.N, device=dev)[None, :]

    def answer_logits(self, x: torch.Tensor) -> torch.Tensor:
        P, N, opts = self.P, self.N, self.opts
        if opts.cfg_scale > 0.0:
            # the batched cond/uncond forward takes no attn_mask, as the
            # reference's does
            B = x.shape[0]
            un_x = torch.where(self.prompt_index,
                               torch.full_like(x, opts.mask_token), x)
            hidden = llada_hidden(self.params, self.cfg,
                                  torch.cat([x, un_x]))
            logits2 = llada_head(self.params, self.cfg, hidden[:, P:P + N])
            cond, uncond = logits2[:B], logits2[B:]
            return uncond + (opts.cfg_scale + 1) * (cond - uncond)
        hidden = llada_hidden(self.params, self.cfg, x, self.attn_mask,
                              self.pos_ids)
        return llada_head(self.params, self.cfg, hidden[:, P:P + N])

    def step(self, x: torch.Tensor, block: int, step_in_block: int
             ) -> torch.Tensor:
        opts, gen = self.opts, self.generator
        P, N = self.P, self.N
        cur = x[:, P:P + N]
        mask_index = cur == opts.mask_token
        logits = self.answer_logits(x)
        u = (S.uniform_noise(logits, gen)
             if gen is not None and opts.temperature != 0 else None)
        x0 = S.gumbel_argmax(logits, opts.temperature, u)
        if opts.remasking == "low_confidence":
            conf = S.token_confidence(logits, x0)
        else:
            conf = S.uniform_noise(x0, gen, dtype=torch.float32)
        neg = torch.full_like(conf, S.NEG_INF)
        # confidence beyond the current block boundary -> -inf
        bend = P + (block + 1) * opts.block_length
        conf = torch.where(self.ans_pos >= bend, neg, conf)
        x0 = torch.where(mask_index, x0, cur)
        conf = torch.where(mask_index, conf, neg)
        k = self.budgets[step_in_block].expand(x.shape[0])
        x = x.clone()
        x[:, P:P + N] = torch.where(S.topk_transfer_mask(conf, k), x0, cur)
        return x


@torch.inference_mode()
def mmu_generate(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    prompt_ids: torch.Tensor,
    opts: MMUOptions = MMUOptions(),
    attn_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns the full ``[B, prompt_len + max_new_tokens]`` sequence.

    ``attn_mask`` (``[B, prompt_len]`` bool, True = real; a full-sequence
    mask is also accepted) enables ragged batched prompts: pads are hidden
    from attention and RoPE positions re-ranked, so each row generates what
    its unpadded single run would.  With ``cfg_scale > 0`` the batched
    cond/uncond forward runs without ``attn_mask``, as the reference's
    does."""
    dec = _Decoder(params, cfg, prompt_ids, opts, attn_mask, generator)
    x = dec.x0
    for block in range(dec.num_blocks):
        for i in range(dec.spb):
            x = dec.step(x, block, i)
    return x


@torch.inference_mode()
def mmu_generate_fast(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    prompt_ids: torch.Tensor,
    opts: MMUOptions = MMUOptions(),
    eot_token: Optional[int] = None,
    attn_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """:func:`mmu_generate` that stops after a block whose final token is
    ``eot_token`` in every row (one host sync per block); the blocks after
    it are not computed and stay masked.  ``eot_token=None`` is
    :func:`mmu_generate`."""
    if eot_token is None:
        return mmu_generate(params, cfg, prompt_ids, opts, attn_mask,
                            generator)
    dec = _Decoder(params, cfg, prompt_ids, opts, attn_mask, generator)
    x = dec.x0
    for block in range(dec.num_blocks):
        for i in range(dec.spb):
            x = dec.step(x, block, i)
        bend = dec.P + (block + 1) * opts.block_length
        if bool((x[:, bend - 1] == eot_token).all()):
            break
    return x
