"""ParaRL: trajectory-level RL with semantic rewards.

Counterpart of :mod:`mmada_parallel_tpu.training.pararl`.  The paper's
ParaRL stage ships with no training code in the reference, so this follows
the JAX package's design: sample full denoising trajectories from the
policy, score the final (text, image) pair with reward callables, and push
policy gradients through the per-step token-commit log-probabilities along
the whole trajectory.

* :func:`rollout_ti2ti` -- the TI2TI sampler's step, recording per step the
  state before it, the positions it committed and the ids it wrote;
* :func:`trajectory_log_prob` -- the log-probability of the recorded
  commits under (current) ``params``, on a subsample of the steps;
* :func:`pararl_loss` -- REINFORCE against the batch's mean reward:
  ``-(R - b) * sum_t log pi(commit_t | state_t)``;
* :class:`RewardSpec` and the concrete proxy rewards (any ``(final_ids,
  codes, meta) -> [B]`` callable plugs in).

The rollout runs under ``torch.no_grad()``, not ``inference_mode``: its
recorded tensors are then ordinary tensors, which the update's embedding
may save for its backward.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mmada_parallel_torch.models.llada import LLaDAConfig, llada_forward
from mmada_parallel_torch.ops import sampling as S
from mmada_parallel_torch.samplers.parallel_ti2ti import (TI2TIOptions,
                                                          make_ti2ti_step)
from mmada_parallel_torch.tokens import SequenceLayout

__all__ = ["rollout_ti2ti", "trajectory_log_prob", "pararl_loss",
           "RewardSpec", "extract_image_codes", "code_diversity_reward",
           "make_target_match_reward", "make_keyword_reward"]


@dataclasses.dataclass
class RewardSpec:
    """Weighted semantic rewards over the final (text, image) pair."""

    fns: Sequence[Callable[..., torch.Tensor]]
    weights: Sequence[float]

    def __call__(self, final_ids, codes, meta=None) -> torch.Tensor:
        total = 0.0
        for w, fn in zip(self.weights, self.fns):
            total = total + w * fn(final_ids, codes, meta)
        return total


# ---------------------------------------------------------------------------
# Concrete rewards: self-contained proxies of the paper's semantic scorers
# ---------------------------------------------------------------------------


def extract_image_codes(final_ids: torch.Tensor, image_positions,
                        text_vocab_size: int, codebook_size: int,
                        mask_token: int) -> torch.Tensor:
    """``[B, N_vq]`` raw codes with ``-1`` at still-masked cells (a masked
    cell clipped into range would alias a real code and earn unearned
    target-match reward)."""
    img_pos = torch.as_tensor(np.asarray(image_positions), dtype=torch.long,
                              device=final_ids.device)
    raw = final_ids[:, img_pos]
    codes = (raw - text_vocab_size).clamp(0, codebook_size - 1)
    return torch.where(raw == mask_token, torch.full_like(codes, -1), codes)


def code_diversity_reward(final_ids, codes, meta=None) -> torch.Tensor:
    """Fraction of distinct codebook entries per image; ``-1`` cells count
    as neither a code nor a slot."""
    valid = codes >= 0
    s = torch.sort(codes, dim=-1).values
    distinct = 1 + (torch.diff(s, dim=-1) != 0).sum(dim=-1)
    distinct = distinct - (~valid).any(dim=-1).to(distinct.dtype)
    return distinct / valid.sum(dim=-1).clamp_min(1)


def make_target_match_reward(target_codes) -> Callable:
    """Fraction of image codes matching a reference image's codes;
    ``target_codes``: ``[N_vq]`` or ``[B, N_vq]``."""
    target = torch.as_tensor(np.asarray(target_codes))

    def reward(final_ids, codes, meta=None) -> torch.Tensor:
        t = target.to(codes.device)
        t = t if t.ndim == 2 else t[None, :]
        return (codes == t).float().mean(dim=-1)

    return reward


def make_keyword_reward(keyword_ids: Sequence[int],
                        text_start: int, text_end: int) -> Callable:
    """Fraction of required token ids present anywhere in the generated text
    span."""
    kw = torch.as_tensor(list(keyword_ids), dtype=torch.long)

    def reward(final_ids, codes, meta=None) -> torch.Tensor:
        span = final_ids[:, text_start:text_end]                  # [B, T]
        hit = (span[:, :, None] == kw.to(span.device)[None, None, :]).any(
            dim=1)                                                # [B, K]
        return hit.float().mean(dim=-1)

    return reward


@torch.no_grad()
def rollout_ti2ti(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,
    layout: SequenceLayout,
    opts: TI2TIOptions,
    generator: Optional[torch.Generator] = None,
    uncond_text_prefix: Optional[np.ndarray] = None,
    uncond_image_prefix: Optional[np.ndarray] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sample a trajectory, recording per-step states and commits.

    ``generator=None`` is deterministic (argmax everywhere).  Returns
    ``(final_ids, traj)`` with ``traj`` holding::

        states       [steps, B, L]  sequence before each step
        commit_mask  [steps, B, L]  positions committed at that step
        committed    [steps, B, L]  ids after the step
    """
    step = make_ti2ti_step(params, cfg, layout, opts, uncond_text_prefix,
                           uncond_image_prefix, device=input_ids.device)
    ts, te = layout.text_start, layout.text_end
    ids = input_ids.long()
    budgets = S.get_num_transfer_tokens(
        (ids[:, ts:te] == opts.mask_token).sum(dim=1), opts.text_steps)
    states, commits, written = [], [], []
    for s in range(opts.text_steps):
        new_ids = step(ids, s, budgets[:, s], generator)
        states.append(ids)
        commits.append(new_ids != ids)
        written.append(new_ids)
        ids = new_ids
    return ids, {"states": torch.stack(states),
                 "commit_mask": torch.stack(commits),
                 "committed": torch.stack(written)}


def trajectory_log_prob(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    traj: Dict[str, torch.Tensor],
    opts: TI2TIOptions,
    step_indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[B]`` summed log-prob of the recorded commits under ``params``:
    one full forward per (sub)step, the commits scored on the full-vocab
    log-softmax at every position, as the JAX function does.
    ``step_indices`` subsamples trajectory steps (e.g. 8 of 128)."""
    states = traj["states"]
    commit_mask = traj["commit_mask"]
    committed = traj["committed"]
    if step_indices is not None:
        idx = torch.as_tensor(step_indices, dtype=torch.long,
                              device=states.device)
        states = states.index_select(0, idx)
        commit_mask = commit_mask.index_select(0, idx)
        committed = committed.index_select(0, idx)

    total = None
    for state, mask, tokens in zip(states, commit_mask, committed):
        logits = llada_forward(params, cfg, state)
        logp = torch.log_softmax(logits, dim=-1)
        del logits
        tok_logp = torch.gather(
            logp, -1, tokens.long().clamp(0, logp.shape[-1] - 1)[..., None]
        )[..., 0]
        step_lp = torch.where(mask, tok_logp,
                              torch.zeros_like(tok_logp)).sum(dim=1)
        total = step_lp if total is None else total + step_lp
    return total


def pararl_loss(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    traj: Dict[str, torch.Tensor],
    rewards: torch.Tensor,
    opts: TI2TIOptions,
    baseline: Optional[torch.Tensor] = None,
    step_indices: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """REINFORCE over the trajectory: ``-(R - b) * log pi(traj)``, the
    advantage and the default baseline (the mean reward) without gradient."""
    logp = trajectory_log_prob(params, cfg, traj, opts, step_indices)
    rewards = rewards.to(logp.device).float()
    b = baseline if baseline is not None else rewards.mean().detach()
    advantage = (rewards - b).detach()
    loss = -(advantage * logp).mean()
    return loss, {"reward_mean": rewards.mean(),
                  "advantage_std": advantage.std(unbiased=False),
                  "traj_logp": logp.mean()}
