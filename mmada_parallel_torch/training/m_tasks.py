"""Variant-M multi-task training forwards.

Counterpart of :mod:`mmada_parallel_tpu.training.m_tasks`, as model-free
functions:

* :func:`forward_process` -- ONE concatenated ``[t2i | lm | mmu]`` batch,
  the t2i rows with their pairwise padding bias, one forward, three losses;
* :func:`forward_process_separate` -- one forward per task, each with its
  own padding mask, for tasks whose lengths differ too much to pad together;
* :func:`forward_process_separate_full_attn` -- the same split, every
  forward maskless and the t2i CE over the whole sequence;
* :func:`forward_t2i` -- t2i only.

Over a mesh each takes ``dp_groups`` (the losses' denominators are global,
:mod:`~mmada_parallel_torch.training.losses`) and ``gather`` (the FSDP
parameter hook of ``llada_forward``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch

from mmada_parallel_torch.models.llada import LLaDAConfig, llada_forward
from mmada_parallel_torch.training.losses import (m_forward_process_losses,
                                                  masked_mean,
                                                  token_cross_entropy)

__all__ = ["forward_process", "forward_process_separate",
           "forward_process_separate_full_attn", "forward_t2i"]


def forward_process(params: Any, cfg: LLaDAConfig, input_ids: torch.Tensor,
                    labels: torch.Tensor, batch_size_t2i: int,
                    batch_size_lm: int, batch_size_mmu: int,
                    max_seq_length: int,
                    t2i_masks: Optional[torch.Tensor] = None,
                    p_mask_lm: Optional[torch.Tensor] = None,
                    p_mask_mmu: Optional[torch.Tensor] = None,
                    answer_lengths_mmu: Optional[torch.Tensor] = None,
                    answer_lengths_lm: Optional[torch.Tensor] = None,
                    dp_groups: Sequence = (), gather=None
                    ) -> Dict[str, torch.Tensor]:
    """One forward over the concatenated batch; returns the loss dict.  The
    padding mask is all-True except on the t2i rows, which take
    ``t2i_masks``."""
    B, L = input_ids.shape
    attn_mask = torch.ones((B, L), dtype=torch.bool, device=input_ids.device)
    if t2i_masks is not None and batch_size_t2i > 0:
        attn_mask[:batch_size_t2i] = t2i_masks.bool()
    logits = llada_forward(params, cfg, input_ids, attn_mask, gather=gather)
    return m_forward_process_losses(
        logits, input_ids, labels, batch_size_t2i, batch_size_lm,
        batch_size_mmu, max_seq_length, p_mask_lm, p_mask_mmu,
        answer_lengths_mmu, answer_lengths_lm, mask_token=cfg.mask_token_id,
        dp_groups=dp_groups)


def forward_t2i(params: Any, cfg: LLaDAConfig, input_ids: torch.Tensor,
                labels: torch.Tensor, max_seq_length: int,
                t2i_masks: Optional[torch.Tensor] = None,
                dp_groups: Sequence = (), gather=None) -> torch.Tensor:
    """t2i-only CE on the image tail."""
    logits = llada_forward(params, cfg, input_ids,
                           t2i_masks.bool() if t2i_masks is not None
                           else None, gather=gather)
    tail = labels[:, max_seq_length + 1:]
    ce = token_cross_entropy(logits[:, max_seq_length + 1:], tail)
    return masked_mean(ce, tail != -100, dp_groups)


def _separate_losses(params: Any, cfg: LLaDAConfig, max_seq_length: int,
                     t2i: Optional[Dict[str, torch.Tensor]],
                     lm: Optional[Dict[str, torch.Tensor]],
                     mmu: Optional[Dict[str, torch.Tensor]],
                     use_masks: bool, t2i_whole_sequence: bool,
                     dp_groups: Sequence = (), gather=None
                     ) -> Dict[str, torch.Tensor]:
    """Shared body of the two ``_separate`` flavours."""
    dev = next(d["input_ids"].device for d in (t2i, lm, mmu) if d is not None)
    zero = torch.zeros((), device=dev)
    out = {"loss_t2i": zero, "loss_lm": zero, "loss_mmu": zero}
    if t2i is not None:
        if t2i_whole_sequence:
            logits = llada_forward(params, cfg, t2i["input_ids"],
                                   gather=gather)
            ce = token_cross_entropy(logits, t2i["labels"])
            out["loss_t2i"] = masked_mean(ce, t2i["labels"] != -100,
                                          dp_groups)
        else:
            out["loss_t2i"] = forward_t2i(
                params, cfg, t2i["input_ids"], t2i["labels"], max_seq_length,
                t2i.get("t2i_masks") if use_masks else None, dp_groups,
                gather)
    for name, task in (("lm", lm), ("mmu", mmu)):
        if task is None:
            continue
        attn = task.get("attention_mask") if use_masks else None
        logits = llada_forward(params, cfg, task["input_ids"],
                               attn.bool() if attn is not None else None,
                               gather=gather)
        n = task["input_ids"].shape[0]
        sizes = (0, n, 0) if name == "lm" else (0, 0, n)
        kw = ({"p_mask_lm": task.get("p_mask"),
               "answer_lengths_lm": task.get("answer_lengths")}
              if name == "lm" else
              {"p_mask_mmu": task.get("p_mask"),
               "answer_lengths_mmu": task.get("answer_lengths")})
        d = m_forward_process_losses(logits, task["input_ids"],
                                     task["labels"], *sizes, max_seq_length,
                                     mask_token=cfg.mask_token_id,
                                     dp_groups=dp_groups, **kw)
        out[f"loss_{name}"] = d[f"loss_{name}"]
    return out


def forward_process_separate(params: Any, cfg: LLaDAConfig,
                             max_seq_length: int,
                             t2i: Optional[Dict[str, torch.Tensor]] = None,
                             lm: Optional[Dict[str, torch.Tensor]] = None,
                             mmu: Optional[Dict[str, torch.Tensor]] = None,
                             dp_groups: Sequence = (), gather=None
                             ) -> Dict[str, torch.Tensor]:
    """Per-task forwards.  Each task dict holds ``input_ids`` and ``labels``
    plus ``t2i_masks`` (t2i) or ``attention_mask`` / ``p_mask`` /
    ``answer_lengths`` (lm, mmu); each forward carries its task's padding
    mask, and the t2i CE runs over the image tail."""
    return _separate_losses(params, cfg, max_seq_length, t2i, lm, mmu,
                            use_masks=True, t2i_whole_sequence=False,
                            dp_groups=dp_groups, gather=gather)


def forward_process_separate_full_attn(
        params: Any, cfg: LLaDAConfig, max_seq_length: int,
        t2i: Optional[Dict[str, torch.Tensor]] = None,
        lm: Optional[Dict[str, torch.Tensor]] = None,
        mmu: Optional[Dict[str, torch.Tensor]] = None,
        dp_groups: Sequence = (), gather=None
        ) -> Dict[str, torch.Tensor]:
    """Per-task forwards with full attention: no padding mask anywhere, and
    the t2i CE over the whole sequence (``max_seq_length`` is unused by the
    t2i branch)."""
    return _separate_losses(params, cfg, max_seq_length, t2i, lm, mmu,
                            use_masks=False, t2i_whole_sequence=True,
                            dp_groups=dp_groups, gather=gather)
