"""Variant-A pure image generation (MaskGit decode): the exact sampler and
the feature-cached one.

Counterpart of :mod:`mmada_parallel_tpu.samplers.image_gen`.  Per step,
sample every still-masked image slot by Gumbel-max, write the samples, then
re-mask the ``keep_n`` lowest-confidence ones, ``keep_n = floor(initial_masks
* cos(pi/2 * (s+1)/T))`` (at least 1, 0 on the last step, at most the masked
count minus 1).  CFG is muse-style ``(1+s)*cond - s*uncond`` with the uncond
sequence ``cat(uncond_ids, x[:, code_start:])``, which has another length
than the cond one, so the two are separate forwards.  The codebook head runs
at every image slot and the updates are masked writes.  The ``lax.scan`` /
``lax.cond`` of the JAX samplers are a Python loop and a host refresh
schedule.

``generator=None`` is fully deterministic (argmax everywhere), the parity
configuration.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from mmada_parallel_torch.models.llada import (LLaDAConfig, llada_head,
                                               llada_hidden,
                                               llada_hidden_partial,
                                               llada_hidden_with_cache)
from mmada_parallel_torch.ops import sampling as S
from mmada_parallel_torch.tokens import SequenceLayout

__all__ = ["ImageGenOptions", "generate_image", "generate_image_cached",
           "dump_trajectory", "image_refresh_schedule"]


@dataclasses.dataclass(frozen=True)
class ImageGenOptions:
    timesteps: int = 18
    temperature: float = 1.0
    cfg_scale: float = 0.0
    schedule: str = "cosine"
    text_vocab_size: int = 126356
    codebook_size: int = 8192
    mask_token: int = 126336
    # adaptive feature cache: full forwards during the warmup and every
    # refresh_interval-th step after it; in between, only the
    # (1 - cache_ratio) lowest-confidence image slots are recomputed
    use_cache: bool = False
    cache_ratio: float = 0.9
    refresh_interval: int = 5
    warmup_ratio: float = 0.3


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    """This sampler's Gumbel form, ``-log(-log(u + 1e-20) + 1e-20)``."""
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


class _Plan:
    """What every step of both samplers shares: image positions, the mask
    schedule, the initial mask counts and the uncond sequence."""

    def __init__(self, input_ids: torch.Tensor, layout: SequenceLayout,
                 opts: ImageGenOptions, uncond_ids):
        dev = input_ids.device
        self.opts = opts
        self.img_pos = torch.as_tensor(layout.image_positions(),
                                       dtype=torch.long, device=dev)
        T = opts.timesteps
        self.fracs = S.get_mask_schedule(opts.schedule)(
            (torch.arange(T, dtype=torch.float32, device=dev) + 1) / T)
        self.vq_len0 = (input_ids[:, self.img_pos]
                        == opts.mask_token).sum(dim=1)
        self.use_cfg = opts.cfg_scale > 0 and uncond_ids is not None
        if self.use_cfg:
            self.un_prefix = torch.as_tensor(np.asarray(uncond_ids),
                                             dtype=torch.long, device=dev)
            self.tail_start = layout.code_start
            self.un_img_pos = (self.img_pos + self.un_prefix.shape[0]
                               - self.tail_start)

    def uncond_seq(self, ids: torch.Tensor) -> torch.Tensor:
        B = ids.shape[0]
        return torch.cat([self.un_prefix.expand(B, -1),
                          ids[:, self.tail_start:]], dim=1)

    def cfg(self, cond: torch.Tensor, uncond: torch.Tensor) -> torch.Tensor:
        s = self.opts.cfg_scale
        return (1 + s) * cond - s * uncond

    def update(self, ids: torch.Tensor, logits: torch.Tensor, step: int,
               generator: Optional[torch.Generator]):
        """One MaskGit step on ``[B, n_vq, codebook]`` logits; returns
        ``(ids, sampled)``."""
        opts = self.opts
        cur = ids[:, self.img_pos]
        masked = cur == opts.mask_token
        unknown_cnt = masked.sum(dim=1)
        noisy = generator is not None and opts.temperature != 0
        if noisy:
            u = S.uniform_noise(logits, generator)
            sampled = torch.argmax(logits / opts.temperature + _gumbel(u),
                                   dim=-1)
        else:
            sampled = torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits, dim=-1)
        conf = torch.gather(probs, -1, sampled[..., None])[..., 0]

        keep_n = torch.floor(self.vq_len0.float()
                             * self.fracs[step]).long().clamp_min(1)
        if step == opts.timesteps - 1:
            keep_n = torch.zeros_like(keep_n)
        keep_n = torch.minimum(keep_n, (unknown_cnt - 1).clamp_min(0))

        # only the masked slots take part; the others get +inf confidence
        conf = torch.where(masked, conf, torch.full_like(conf, math.inf))
        u2 = S.uniform_noise(conf, generator) if noisy else None
        remask = S.remask_below_cutoff(keep_n, conf, opts.temperature,
                                       u2) & masked
        new_vals = torch.where(masked, sampled + opts.text_vocab_size, cur)
        new_vals = torch.where(remask, torch.full_like(new_vals,
                                                       opts.mask_token),
                               new_vals)
        ids = ids.clone()
        ids[:, self.img_pos] = new_vals
        return ids, sampled

    def codes(self, ids: torch.Tensor) -> torch.Tensor:
        return (ids[:, self.img_pos] - self.opts.text_vocab_size).clamp(
            0, self.opts.codebook_size - 1)


@torch.inference_mode()
def generate_image(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,
    layout: SequenceLayout,
    opts: ImageGenOptions = ImageGenOptions(),
    uncond_ids: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
    record_trajectory: bool = False,
    record_logits: bool = False,
):
    """Returns ``(final_ids [B, L], image_codes [B, N_vq])``.

    ``layout.code_start`` marks ``<answer_start>`` as in the TI2TI layout;
    the image span (with newlines) sits at ``[image_start, image_end)``.
    ``opts.use_cache`` dispatches to :func:`generate_image_cached`.

    ``record_trajectory=True`` also returns a per-step dict of stacked
    tensors ``[T, ...]``, the reference sampler's debug dumps: ``x`` (the
    full sequence after write-back and re-mask), ``vq_mask`` (``x ==
    mask_token``), ``sampled_full`` (the samples in full token space, every
    image slot), and ``logits`` when ``record_logits``.
    :func:`dump_trajectory` writes them as the reference names them."""
    if opts.use_cache:
        if record_trajectory or record_logits:
            raise ValueError(
                "record_trajectory/record_logits require the exact sampler; "
                "the cached path (use_cache=True) does not record — run "
                "with use_cache=False to dump a trajectory")
        return generate_image_cached(params, cfg, input_ids, layout, opts,
                                     uncond_ids=uncond_ids,
                                     generator=generator)
    plan = _Plan(input_ids, layout, opts, uncond_ids)
    vocab = (opts.text_vocab_size, opts.codebook_size)

    def vq_logits_at(ids, positions):
        hidden = llada_hidden(params, cfg, ids)
        return llada_head(params, cfg, hidden[:, positions], vocab_slice=vocab)

    ids = input_ids.long()
    traj = {}
    for step in range(opts.timesteps):
        logits = vq_logits_at(ids, plan.img_pos)
        if plan.use_cfg:
            logits = plan.cfg(logits, vq_logits_at(plan.uncond_seq(ids),
                                                   plan.un_img_pos))
        ids, sampled = plan.update(ids, logits, step, generator)
        if record_trajectory:
            rec = {"x": ids, "vq_mask": ids == opts.mask_token,
                   "sampled_full": sampled + opts.text_vocab_size}
            if record_logits:
                rec["logits"] = logits.float()
            for name, t in rec.items():
                traj.setdefault(name, []).append(t)
    if record_trajectory:
        traj = {name: torch.stack(ts) for name, ts in traj.items()}
        return ids, plan.codes(ids), traj
    return ids, plan.codes(ids)


def dump_trajectory(traj, out_dir: str) -> None:
    """Write a recorded trajectory as the reference's per-step npy files
    (``step_{i}_{x,vq_mask,sampled_full[,logits]}.npy``)."""
    os.makedirs(out_dir, exist_ok=True)
    host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in traj.items()}
    T = next(iter(host.values())).shape[0]
    for i in range(T):
        for name, arr in host.items():
            np.save(os.path.join(out_dir, f"step_{i}_{name}.npy"), arr[i])


def image_refresh_schedule(timesteps: int, refresh_interval: int,
                           warmup_ratio: float) -> np.ndarray:
    """Host bool ``[timesteps]``: the steps of :func:`generate_image_cached`
    that run full forwards (the warmup, then every ``refresh_interval``-th
    step)."""
    warmup = int(timesteps * warmup_ratio)
    s = np.arange(timesteps)
    return (s <= warmup) | ((s - warmup) % refresh_interval == 0)


@torch.inference_mode()
def generate_image_cached(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    input_ids: torch.Tensor,
    layout: SequenceLayout,
    opts: ImageGenOptions,
    uncond_ids: Optional[np.ndarray] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MaskGit decode with the adaptive feature cache (an opt-in
    approximation).

    Steps of :func:`image_refresh_schedule` run full forwards through
    :func:`~mmada_parallel_torch.models.llada.llada_hidden_with_cache`; in
    between, the ``n = ceil((1 - cache_ratio) * n_vq)`` image slots with the
    lowest raw-logit maximum are recomputed through
    :func:`~mmada_parallel_torch.models.llada.llada_hidden_partial` against
    the cached per-layer k/v, and the other slots' logits are reused.  With
    CFG the cond and uncond sequences keep their own caches and recompute
    sets.  Same arguments and return as :func:`generate_image`."""
    plan = _Plan(input_ids, layout, opts, uncond_ids)
    vocab = (opts.text_vocab_size, opts.codebook_size)
    n_vq = plan.img_pos.shape[0]
    n_compute = max(math.ceil((1.0 - opts.cache_ratio) * n_vq), 1)
    refresh = image_refresh_schedule(opts.timesteps, opts.refresh_interval,
                                     opts.warmup_ratio)

    def full(seq_ids, positions):
        hidden, cache = llada_hidden_with_cache(params, cfg, seq_ids)
        vq = llada_head(params, cfg, hidden[:, positions], vocab_slice=vocab)
        return {"cache": cache, "vq": vq.float()}

    def partial(seq_ids, positions, state):
        # stable ascending sort: ties go to the lower slot, as argsort
        sel_slot = torch.sort(state["vq"].amax(dim=-1), dim=-1,
                              stable=True).indices[:, :n_compute]
        sel_pos = positions[sel_slot]
        h_sel, cache = llada_hidden_partial(
            params, cfg, torch.gather(seq_ids, 1, sel_pos), sel_pos,
            state["cache"])
        vq_sel = llada_head(params, cfg, h_sel, vocab_slice=vocab)
        state["vq"].scatter_(1, sel_slot[:, :, None].expand_as(vq_sel),
                             vq_sel.float())
        return state

    ids = input_ids.long()
    cond = uncond = None
    for step in range(opts.timesteps):        # refresh[0] is always True
        if refresh[step]:
            cond = uncond = None              # free the old caches first
            cond = full(ids, plan.img_pos)
            if plan.use_cfg:
                uncond = full(plan.uncond_seq(ids), plan.un_img_pos)
        else:
            cond = partial(ids, plan.img_pos, cond)
            if plan.use_cfg:
                uncond = partial(plan.uncond_seq(ids), plan.un_img_pos,
                                 uncond)
        logits = (plan.cfg(cond["vq"], uncond["vq"]) if plan.use_cfg
                  else cond["vq"])
        ids, _ = plan.update(ids, logits, step, generator)
    return ids, plan.codes(ids)
