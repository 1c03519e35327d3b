"""ParaRL demo: REINFORCE improves a partially supervised editing model.

Stage 1 trains the tiny A-variant model of :mod:`.train_edit_demo_a` on the
+1 palette shift for a short run (40 steps by default: an uncertain
policy).  Stage 2 rewards the fraction of generated codes that match the
target shift and runs ParaRL (``training/pararl``: trajectory rollout with
per-step commits, commit log-prob replay, REINFORCE with the batch-mean
reward as baseline).  Reward and temperature-0 accuracy should climb past
where the supervised stage left them: the paper's SFT-then-ParaRL recipe
(``README.md:51``) end to end on real trajectories.

Codes are read with ``extract_image_codes`` (-1 at still-masked cells), so
a cell left masked earns no reward.  A reward for a rule that conflicts
with the supervision (``--target_shift 2``) does not re-steer a converged
policy: its rollouts never match, every reward is 0 and the advantage
vanishes.

Counterpart of the JAX package's ``examples/pararl_resteer_demo.py``.

    python -m mmada_parallel_torch.examples.pararl_resteer_demo \
        --device cuda [--pretrain 40] [--updates 100] \
        [--out results_torch/pararl_resteer]
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from mmada_parallel_torch.examples import resolve_device
from mmada_parallel_torch.examples.train_edit_demo_a import (
    CB, N_VQ, TVS, assemble_eval_sequence, run_demo_a)
from mmada_parallel_torch.samplers.parallel_ti2ti import (TI2TIOptions,
                                                          generate_ti2ti)
from mmada_parallel_torch.training.pararl import (RewardSpec,
                                                  extract_image_codes,
                                                  make_target_match_reward,
                                                  pararl_loss, rollout_ti2ti)
from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                   TrainState, make_optimizer,
                                                   make_train_step)


def resteer_task(tokz, T, seed=0, target_shift=1, rollout_temp=1.5):
    """The fixed evaluation input (codes from ``seed + 7``): its ids, its
    layout, the ``+target_shift`` target, the rollout and temperature-0
    options, and the target-match reward."""
    rng = np.random.default_rng(seed + 7)
    codes_in = rng.integers(0, CB, N_VQ)
    ids, lay, ans_len = assemble_eval_sequence(tokz, T, codes_in)
    target = (codes_in + target_shift) % CB
    ropts = TI2TIOptions(text_steps=ans_len, timesteps=8,
                         temperature=rollout_temp, text_temperature=0.7,
                         cfg_scale=0.0, cfg_img=0.0, text_vocab_size=TVS,
                         codebook_size=CB, mask_token=T.mask)
    eopts = TI2TIOptions(text_steps=ans_len, timesteps=8, temperature=0.0,
                         text_temperature=0.0, cfg_scale=0.0, cfg_img=0.0,
                         text_vocab_size=TVS, codebook_size=CB,
                         mask_token=T.mask)
    reward = RewardSpec(fns=[make_target_match_reward(target)],
                        weights=[1.0])
    return ids, lay, target, ropts, eopts, reward


def resteer_update(params, cfg, ropts, lr=2e-3):
    """The REINFORCE train state on ``params`` and its step,
    ``step(state, (trajectory, rewards)) -> (state, metrics)``."""
    opt = make_optimizer(OptimizerConfig(lr=lr, weight_decay=0.0,
                                         grad_clip=1.0), params)

    def loss_fn(p, batch, generator=None):
        traj, rw = batch
        return pararl_loss(p, cfg, traj, rw, ropts)

    return TrainState.create(params, opt), make_train_step(loss_fn, opt)


def run_resteer(pretrain=40, updates=100, lr=2e-3, rollout_batch=16,
                rollout_temp=1.5, target_shift=1, out_dir=None, seed=0,
                work_dir=None, device="cuda"):
    """Supervised pre-training, then ``updates`` ParaRL updates; returns
    the metrics dict (and writes it, with the reward curve, to
    ``out_dir``)."""
    device = resolve_device(device) if isinstance(device, str) else device
    # stage 1: (partial) supervised +1 shift
    m, params, cfg, T, tokz = run_demo_a(
        steps=pretrain, batch=32, out_dir=None, log_every=max(pretrain, 1),
        return_params=True, seed=seed, work_dir=work_dir, device=device)
    print(f"[stage1] +1 accuracy after {pretrain} steps: "
          f"{m['eval_code_accuracy']}", file=sys.stderr)

    # stage 2: REINFORCE with a +target_shift reward
    ids, lay, target, ropts, eopts, reward = resteer_task(
        tokz, T, seed, target_shift, rollout_temp)
    state, step = resteer_update(params, cfg, ropts, lr)
    ids_t = torch.as_tensor(ids, device=device)[None]

    def eval_acc(p):
        _, codes = generate_ti2ti(p, cfg, ids_t, lay, eopts)
        return float((codes[0].cpu().numpy() == target).mean())

    batch_ids = ids_t.repeat(rollout_batch, 1)
    acc0 = eval_acc(state.params)
    generator = torch.Generator(device=device).manual_seed(seed + 3)
    hist, curve = [], []
    t0 = time.time()
    for i in range(updates):
        fin, traj = rollout_ti2ti(state.params, cfg, batch_ids, lay, ropts,
                                  generator)
        # -1 at still-masked cells: no reward for generating nothing
        codes = extract_image_codes(fin, lay.image_positions(), TVS, CB,
                                    T.mask)
        rw = reward(fin, codes)
        state, metrics = step(state, (traj, rw))
        hist.append(float(metrics["reward_mean"]))
        if i % 10 == 0 or i == updates - 1:
            a = eval_acc(state.params)
            curve.append({"update": i, "reward_mean": round(hist[-1], 4),
                          "eval_acc": round(a, 4)})
            print(f"[stage2] update {i:3d} reward {hist[-1]:.3f} "
                  f"+{target_shift}-accuracy(temp0) {a:.3f}",
                  file=sys.stderr)

    out = {
        "task": (f"ParaRL: {pretrain}-step SFT on +1 shift, then REINFORCE "
                 f"with a +{target_shift}-shift reward"),
        "pretrain_steps": pretrain, "updates": updates,
        "pretrain_plus1_accuracy": m["eval_code_accuracy"],
        "initial_accuracy": round(acc0, 4),
        "final_accuracy": round(eval_acc(state.params), 4),
        "reward_first5": round(float(np.mean(hist[:5])), 4),
        "reward_last5": round(float(np.mean(hist[-5:])), 4),
        "rl_seconds": round(time.time() - t0, 1),
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(out, f, indent=2)
        with open(os.path.join(out_dir, "reward_curve.jsonl"), "w") as f:
            for row in curve:
                f.write(json.dumps(row) + "\n")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pretrain", type=int, default=40)
    ap.add_argument("--updates", type=int, default=100)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--target_shift", type=int, default=1)
    ap.add_argument("--out", default="results_torch/pararl_resteer")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu to run without a card)")
    args = ap.parse_args(argv)
    print(json.dumps(run_resteer(pretrain=args.pretrain,
                                 updates=args.updates, lr=args.lr,
                                 target_shift=args.target_shift,
                                 out_dir=args.out, device=args.device),
                     indent=2))


if __name__ == "__main__":
    main()
