"""ParaRL training loop (SFT -> RL) on PyTorch/CUDA.

Counterpart of :mod:`mmada_parallel_tpu.cli.train_pararl`, with the same
flags plus ``--device`` (default ``cuda``; a missing card raises, the run
does not move to the CPU): sample trajectories from the current policy with
the TI2TI sampler's step, score the final (text, image) pairs with reward
callables, and apply REINFORCE updates through the per-step commit
log-probabilities (:mod:`mmada_parallel_torch.training.pararl`), with the
port's AdamW, train step and checkpoints.  One device; the JAX loop's mesh
is its one-device default.

``--reward module:fn`` plugs in a reward ``(final_ids, codes, meta) -> [B]``
(tensors); the default is the code-diversity proxy.

    python -m mmada_parallel_torch.cli.train_pararl --output_dir /tmp/rl \
        --steps 100 --rollouts_per_step 2
"""

import argparse
import importlib
import os


def default_reward(final_ids, codes, meta):
    """Default: the code-diversity proxy (``training/pararl.py`` has
    target-match and keyword adherence too)."""
    from mmada_parallel_torch.training.pararl import code_diversity_reward
    return code_diversity_reward(final_ids, codes, meta)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--init_from", default=None,
                   help="SFT checkpoint dir (None = tiny debug model)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--prompts", default=None,
                   help="jsonl of {prompt_ids: [...]} rollout prompts")
    p.add_argument("--reward", default=None, help="module:function")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--rollouts_per_step", type=int, default=2)
    p.add_argument("--traj_subsample", type=int, default=8,
                   help="trajectory steps scored per update")
    p.add_argument("--lr", type=float, default=1e-6)
    p.add_argument("--text_steps", type=int, default=16)
    p.add_argument("--timesteps", type=int, default=8)
    p.add_argument("--grid", type=int, default=4, help="token grid side")
    p.add_argument("--text_gen_length", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cpu for the tests)")
    return p


def tiny_setup(seed: int, device):
    """``(cfg, params, tokens)``: the JAX CLI's tiny debug model (d_model
    64, 2 layers, a 256-id text vocab and a 32-code codebook)."""
    import torch

    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    T = tk.VariantATokens(mask=250, newline=251, answer_start=252,
                          answer_end=253, boi=254, eoi=255,
                          uncondition=249, pad=248,
                          text_vocab_size=256, codebook_size=32)
    cfg = LLaDAConfig.tiny(d_model=64, n_layers=2, vocab_size=288,
                           mask_token_id=T.mask)
    params = init_llada_params(
        cfg, torch.Generator(device=device).manual_seed(seed))
    return cfg, params, T


def rollout_sequences(prompt_sets, tokens, grid: int, text_gen_length: int):
    """``(ids [n, L] numpy, layout)``: the prompts right-padded with the pad
    token to one length, so every rollout shares one layout."""
    import numpy as np

    from mmada_parallel_torch import tokens as tk
    plen = max(len(p) for p in prompt_sets)
    rows, layout = [], None
    for p in prompt_sets:
        ids, layout = tk.assemble_ti2ti_sequence(
            list(p) + [tokens.pad] * (plen - len(p)), text_gen_length, grid,
            grid, [tokens.answer_end], tokens=tokens)
        rows.append(ids)
    return np.stack(rows), layout


def subsample_steps(text_steps: int, traj_subsample: int):
    """The trajectory steps each update scores, spread evenly."""
    import numpy as np
    import torch
    return torch.as_tensor(np.linspace(0, text_steps - 1, traj_subsample)
                           .round().astype(np.int64))


def build_update(cfg, params, opts, lr: float, step_indices):
    """``(state, step)``: AdamW (no weight decay, clip 1.0) and the train
    step of :func:`~mmada_parallel_torch.training.pararl.pararl_loss` on a
    batch ``(traj, rewards)``."""
    from mmada_parallel_torch.training.pararl import pararl_loss
    from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                       TrainState,
                                                       make_optimizer,
                                                       make_train_step)
    opt = make_optimizer(OptimizerConfig(lr=lr, weight_decay=0.0,
                                         grad_clip=1.0), params)

    def loss_fn(p, batch, generator):
        traj, rw = batch
        return pararl_loss(p, cfg, traj, rw, opts, step_indices=step_indices)

    return TrainState.create(params, opt), make_train_step(loss_fn, opt)


def rollout_and_score(params, cfg, ids, layout, opts, rewards, generator):
    """One batch of rollouts and their rewards: ``(traj, rewards [B])``."""
    from mmada_parallel_torch.training.pararl import (extract_image_codes,
                                                      rollout_ti2ti)
    final_ids, traj = rollout_ti2ti(params, cfg, ids, layout, opts,
                                    generator)
    codes = extract_image_codes(final_ids, layout.image_positions(),
                                opts.text_vocab_size, opts.codebook_size,
                                opts.mask_token)
    return traj, rewards(final_ids, codes)


def main(argv=None):
    import json

    import torch

    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    from mmada_parallel_torch.training.pararl import RewardSpec

    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    device = torch.device(args.device)

    if args.init_from:
        from mmada_parallel_torch.models import convert as CV
        cfg, params = CV.load_llada_checkpoint(args.init_from)
        params = {k: ({n: t.to(device) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(device))
                  for k, v in params.items()}
        T = tk.TOKENS_A
    else:
        cfg, params, T = tiny_setup(args.seed, device)

    if args.reward:
        mod, fn = args.reward.split(":")
        reward_fn = getattr(importlib.import_module(mod), fn)
    else:
        reward_fn = default_reward
    rewards = RewardSpec(fns=[reward_fn], weights=[1.0])

    opts = TI2TIOptions(text_steps=args.text_steps, timesteps=args.timesteps,
                        temperature=1.0, text_temperature=0.7,
                        cfg_scale=0.0, cfg_img=0.0,
                        text_vocab_size=T.text_vocab_size,
                        codebook_size=T.codebook_size, mask_token=T.mask)

    if args.prompts:
        with open(args.prompts) as f:
            prompt_sets = [json.loads(line)["prompt_ids"] for line in f
                           if line.strip()]
    else:
        prompt_sets = [[5, 6, 7, 8], [9, 10, 11, 12]]
    seqs, layout = rollout_sequences(prompt_sets, T, args.grid,
                                     args.text_gen_length)
    batch_ids = torch.as_tensor(
        seqs[[j % len(seqs) for j in range(args.rollouts_per_step)]],
        device=device)

    state, step = build_update(cfg, params, opts, args.lr, subsample_steps(
        args.text_steps, args.traj_subsample))
    mngr = CheckpointManager(os.path.join(args.output_dir, "ckpt"))
    generator = torch.Generator(device=device).manual_seed(args.seed)
    for it in range(args.steps):
        batch = rollout_and_score(state.params, cfg, batch_ids, layout, opts,
                                  rewards, generator)
        state, metrics = step(state, batch, generator)
        if it % 10 == 0:
            print(f"iter {it}: reward={float(metrics['reward_mean']):.4f} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"grad_norm={float(metrics['grad_norm']):.3f}")
    mngr.save(args.steps, state, {"iters": args.steps})
    mngr.wait()
    print(f"[done] {args.steps} ParaRL iterations")


if __name__ == "__main__":
    main()
