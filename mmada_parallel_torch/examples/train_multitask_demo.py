"""Multitask M-variant capability demo: one tiny model trained jointly on
t2i + mmu through ``forward_process_separate``, then scored end to end
through the batched eval sweeps (``run_t2i_sweep`` / ``run_mmu_sweep``),
which drive the serving stack (``T2IServer``, ``MMUServer``).

The tasks are two views of one synthetic world, 4x4 palette grids whose
top two rows are color ``a`` and bottom two rows color ``b``:

* **t2i**: ``"paint top c<a> bottom c<b>"`` -> the [a*8, b*8] grid, trained
  under the reference t2i recipe: the ``UniversalPrompting.t2i`` template
  (``prompting_utils.py:81-133``; left ipad padding, condition dropout for
  CFG), ``mask_tokens_schedule`` noising (``training/utils.py:77-175``) and
  the image-tail CE of ``forward_process_separate``
  (``modeling_mmada.py:433-516``).
* **mmu**: grid image -> caption ``"top c<a> bottom c<b> done"``, trained
  under ``UniversalPrompting.mmu`` (``prompting_utils.py:250-311``) with
  LLaDA-SFT text noising: per-row ``t``, Bernoulli masks, ``1/p_mask`` and
  ``1/answer_length`` weights (``modeling_mmada.py:492-516``).

``run_t2i_sweep`` scores ``target_match`` against the ground-truth grids
(through the server's CFG path) and ``run_mmu_sweep`` scores
``text_alignment`` against positional keywords (through semi-AR block
decoding).

Counterpart of the JAX package's ``examples/train_multitask_demo.py``: the
same numpy streams build the same rows; the noising draws come from one
``torch.Generator`` on the demo's device.

    python -m mmada_parallel_torch.examples.train_multitask_demo \
        --device cuda [--steps 1000] [--out results_torch/multitask_demo]
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.data.prompting import UniversalPrompting
from mmada_parallel_torch.eval_scorers import (aggregate_scores,
                                               default_edit_scorer)
from mmada_parallel_torch.evaluation import (MMUEvalRequest, T2IEvalRequest,
                                             run_mmu_sweep, run_t2i_sweep)
from mmada_parallel_torch.examples import (checkpoint_round_trip,
                                           resolve_device)
from mmada_parallel_torch.models.llada import LLaDAConfig, init_llada_params
from mmada_parallel_torch.samplers.mmu import MMUOptions
from mmada_parallel_torch.samplers.t2i import T2IOptions
from mmada_parallel_torch.training.lr_schedules import get_scheduler
from mmada_parallel_torch.training.m_tasks import forward_process_separate
from mmada_parallel_torch.training.masking import mask_tokens_schedule
from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                   TrainState, make_optimizer,
                                                   make_train_step)
from mmada_parallel_torch.utils.param_store import load_params, save_params

# ----------------------------------------------------------------- tokens
TVS, CB = 32, 16          # text vocab / codebook
N_VQ = 16                 # 4x4 grid
GRID = 4
N_COLORS = 8              # colors c0..c7 <-> word ids 12..19
T2I_PAD = 8               # t2i text span (ipad-left-padded) length
MMU_SPAN = 8              # mmu caption span length


class WordTok:
    """Minimal word-level tokenizer over the demo vocabulary."""

    bos_token_id, eos_token_id = 1, 2
    _words = {"paint": 3, "what": 4, "color": 5, "is": 6, "the": 7,
              "done": 8, "top": 20, "bottom": 21,
              **{f"c{k}": 12 + k for k in range(N_COLORS)}}

    def __call__(self, texts, **kw):
        if isinstance(texts, str):
            return {"input_ids": [self._words.get(w, 11)
                                  for w in texts.split()]}
        return {"input_ids": [[self._words.get(w, 11) for w in t.split()]
                              for t in texts]}

    def decode(self, ids, **kw):
        inv = {v: k for k, v in self._words.items()}
        return " ".join(inv.get(int(i), "?") for i in ids
                        if int(i) not in (self.bos_token_id,
                                          self.eos_token_id))


def demo_tokens() -> tk.VariantMTokens:
    return tk.VariantMTokens(
        mask=31, soi=30, eoi=29, t2i=28, mmu=25, ipad=24, bos=1, eos=2,
        text_vocab_size=TVS, codebook_size=CB)


def demo_config(T) -> LLaDAConfig:
    return LLaDAConfig.tiny(d_model=128, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=256,
                            vocab_size=T.full_vocab_size,
                            mask_token_id=T.mask,
                            attention_impl="xla")


def world_grid(a, b):
    """Raw codes of the (top=a, bottom=b) world: ``[N_VQ]``."""
    return np.asarray([a] * (N_VQ // 2) + [b] * (N_VQ // 2), np.int64)


def make_t2i_batch(rng, B, T, up, generator):
    """t2i rows through the production prompting and noising path; the
    colors come from ``rng``, the masking draws from ``generator``."""
    ab = rng.integers(0, N_COLORS, (B, 2))
    codes = np.stack([world_grid(a, b) for a, b in ab]) + TVS  # vocab-offset
    texts = [f"paint top c{a} bottom c{b}" for a, b in ab]
    noisy, labels, _ = mask_tokens_schedule(
        generator, torch.as_tensor(codes, device=generator.device),
        mask_token=T.mask, codebook_size=CB)
    seq, masks, lab = up.t2i(texts, noisy.cpu().numpy(),
                             labels.cpu().numpy())
    return {"input_ids": seq.astype(np.int32),
            "labels": lab.astype(np.int32),
            "t2i_masks": masks.astype(np.int32)}


def _mmu_noising_apply(seq, lab, t_u, bern_u, mask_token):
    """LLaDA-SFT noising of the caption tail given the draws: ``t = t_u *
    (1 - 1e-3) + 1e-3`` a row, a position masked where ``bern_u < t``, the
    span's first (bos) token kept.  Numpy in, the mmu task dict out."""
    B, L = seq.shape
    span = MMU_SPAN                      # the caption span is the tail
    t = t_u * (1 - 1e-3) + 1e-3
    bern = bern_u < t[:, None]
    bern[:, 0] = False                   # bos protected
    noisy = seq.copy()
    tail = noisy[:, -span:]
    tail[bern] = mask_token
    noisy[:, -span:] = tail
    p_mask = np.broadcast_to(t[:, None], (B, L)).copy()
    ans_len = np.full((B, L), float(span), np.float32)
    return {"input_ids": noisy.astype(np.int32),
            "labels": lab.astype(np.int32),
            "attention_mask": np.ones((B, L), np.int32),
            "p_mask": p_mask.astype(np.float32),
            "answer_lengths": ans_len}


def make_mmu_batch(rng, B, T, up, generator):
    """mmu rows: a clean image prefix and a noised caption span; the colors
    come from ``rng``, ``t`` and the Bernoulli draws from ``generator``."""
    ab = rng.integers(0, N_COLORS, (B, 2))
    codes = np.stack([world_grid(a, b) for a, b in ab]) + TVS
    texts = [f"top c{a} bottom c{b} done" for a, b in ab]
    seq, _, lab = up.mmu(codes, texts)
    return _mmu_noising_apply(seq, lab, *_mmu_uniforms(generator, B),
                              T.mask)


def _mmu_uniforms(generator, B):
    """The mmu noising's draws, ``t_u [B]`` and ``bern_u [B, MMU_SPAN]``,
    from ``generator`` on its device, as host arrays."""
    dev = generator.device
    t_u = torch.rand((B,), generator=generator, device=dev)
    bern_u = torch.rand((B, MMU_SPAN), generator=generator, device=dev)
    return t_u.cpu().numpy(), bern_u.cpu().numpy()


def make_loss_fn(cfg):
    def loss_fn(p, b, generator=None):
        t2i_b, mmu_b = b
        out = forward_process_separate(p, cfg, max_seq_length=T2I_PAD,
                                       t2i=t2i_b, mmu=mmu_b)
        loss = out["loss_t2i"] + out["loss_mmu"]
        return loss, {"loss_t2i": out["loss_t2i"],
                      "loss_mmu": out["loss_mmu"]}
    return loss_fn


def eval_sweeps(params, cfg, T, tokz, seed=0, n_samples=8):
    """Score the trained model through the batched eval sweeps (the serving
    stack underneath): t2i ``target_match`` and mmu keyword alignment."""
    eval_rng = np.random.default_rng(seed + 1234)
    ab = eval_rng.integers(0, N_COLORS, (n_samples, 2))

    t2i_reqs = [
        T2IEvalRequest(
            text_ids=tokz(f"paint top c{a} bottom c{b}")["input_ids"],
            meta={"target_codes": world_grid(a, b).tolist(),
                  "ab": [int(a), int(b)]})
        for a, b in ab]
    t2i_opts = T2IOptions(timesteps=8, temperature=0.0, guidance_scale=1.5,
                          text_vocab_size=TVS, codebook_size=CB,
                          mask_token=T.mask)
    t2i_sweep = run_t2i_sweep(params, cfg, t2i_reqs, num_vq_tokens=N_VQ,
                              opts=t2i_opts, batch_size=4, bucket_quantum=8,
                              tokens=T, tokenizer=tokz,
                              scorer=default_edit_scorer())

    mmu_reqs = [
        MMUEvalRequest(
            prompt_ids=[T.mmu, T.soi] + (world_grid(a, b) + TVS).tolist()
            + [T.eoi, T.bos],
            meta={"keywords": [f"top c{a}", f"bottom c{b}"],
                  "ab": [int(a), int(b)]})
        for a, b in ab]
    mmu_opts = MMUOptions(max_new_tokens=MMU_SPAN - 1, steps=MMU_SPAN - 1,
                          block_length=MMU_SPAN - 1, temperature=0.0,
                          cfg_scale=0.0, mask_token=T.mask)
    mmu_sweep = run_mmu_sweep(params, cfg, mmu_reqs, opts=mmu_opts,
                              batch_size=4, bucket_quantum=8, tokens=T,
                              tokenizer=tokz, scorer=default_edit_scorer())

    return {
        "t2i": {"agg": aggregate_scores(t2i_sweep["results"]),
                "sweep": t2i_sweep},
        "mmu": {"agg": aggregate_scores(mmu_sweep["results"]),
                "sweep": mmu_sweep},
    }


def run_demo(steps=1000, batch=16, lr=1.5e-3, out_dir=None, seed=0,
             log_every=50, return_params=False, param_store=None,
             device="cuda"):
    """Train jointly, checkpoint, restore, then score through the sweeps;
    returns the metrics dict (and ``(metrics, params, cfg, T, tokz)`` with
    ``return_params``).

    ``param_store``: an ``.npz`` path; when it exists its params are loaded
    and training is skipped (the round trip and the sweeps still run).  The
    checkpoint goes to ``out_dir/ckpt``, or to a temporary directory."""
    device = resolve_device(device) if isinstance(device, str) else device
    T = demo_tokens()
    tokz = WordTok()
    cfg = demo_config(T)
    params = init_llada_params(
        cfg, torch.Generator(device=device).manual_seed(seed))
    restored_from_store = False
    if param_store and os.path.exists(param_store):
        try:
            params = load_params(param_store, params)
            steps, restored_from_store = 0, True
            print(f"[param_store] loaded trained params from "
                  f"{param_store}; skipping training", file=sys.stderr)
        except Exception as e:   # drift -> retrain
            print(f"[param_store] unusable ({e!r}); retraining",
                  file=sys.stderr)

    # two prompting views: t2i pads the text to max_text_len + 1 ==
    # T2I_PAD; the mmu caption span is (max_text_len + 1) - 1 == MMU_SPAN
    up_t2i = UniversalPrompting(tokz, max_text_len=T2I_PAD - 1,
                                cond_dropout_prob=0.1, tokens=T,
                                rng=np.random.default_rng(seed))
    up_mmu = UniversalPrompting(tokz, max_text_len=MMU_SPAN, tokens=T)

    sched = get_scheduler("constant_with_warmup", lr,
                          warmup_steps=min(100, steps // 4))
    opt_cfg = OptimizerConfig(lr=lr, weight_decay=0.0, schedule=sched)
    opt = make_optimizer(opt_cfg, params)
    state = TrainState.create(params, opt)
    step_fn = make_train_step(make_loss_fn(cfg), opt, accum_steps=1)

    def on_device(b):
        return {k: torch.as_tensor(v, device=device) for k, v in b.items()}

    rng = np.random.default_rng(seed)
    noise = torch.Generator(device=device).manual_seed(seed + 1)
    curve = []
    t0 = time.time()
    for i in range(steps):
        t2i_b = make_t2i_batch(rng, batch, T, up_t2i, noise)
        mmu_b = make_mmu_batch(rng, batch, T, up_mmu, noise)
        state, metrics = step_fn(state, (on_device(t2i_b), on_device(mmu_b)))
        if i % log_every == 0 or i == steps - 1:
            row = {"step": i,
                   "loss": round(float(metrics["loss"]), 4),
                   "loss_t2i": round(float(metrics["loss_t2i"]), 4),
                   "loss_mmu": round(float(metrics["loss_mmu"]), 4)}
            curve.append(row)
            print(f"step {i:4d}  loss {row['loss']:8.4f}  "
                  f"t2i {row['loss_t2i']:8.4f}  mmu {row['loss_mmu']:8.4f}",
                  file=sys.stderr)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.time() - t0
    if param_store and not restored_from_store:
        save_params(param_store, state.params)

    # ---- checkpoint round trip into other weights ----
    fresh = TrainState.create(
        init_llada_params(cfg, torch.Generator(device=device).manual_seed(99)),
        make_optimizer(opt_cfg, params))
    restored_params = checkpoint_round_trip(
        state, steps, fresh, {"task": "multitask_demo"},
        os.path.join(out_dir, "ckpt") if out_dir else None)

    # ---- evaluation through the batched sweeps ----
    sweeps = eval_sweeps(restored_params, cfg, T, tokz, seed=seed)
    t2i_agg, mmu_agg = sweeps["t2i"]["agg"], sweeps["mmu"]["agg"]

    metrics = {
        "task": "multitask (t2i paint + mmu caption) via "
                "forward_process_separate",
        "steps": steps, "batch_per_task": batch,
        "train_seconds": round(train_s, 1),
        "final_loss": curve[-1]["loss"] if curve else None,
        "t2i_target_match": round(t2i_agg.get("target_match", 0.0), 4),
        "t2i_code_diversity": round(t2i_agg.get("code_diversity", 0.0), 4),
        "mmu_text_alignment": round(mmu_agg.get("text_alignment", 0.0), 4),
        "mmu_answers": [r["text"] for r in sweeps["mmu"]["sweep"]["results"]],
        "images_per_min": round(sweeps["t2i"]["sweep"]["images_per_min"], 2),
        "answers_per_min": round(sweeps["mmu"]["sweep"]["answers_per_min"],
                                 2),
    }

    if out_dir:
        from mmada_parallel_torch.examples.train_edit_demo import render_codes
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "loss_curve.jsonl"), "w") as f:
            for row in curve:
                f.write(json.dumps(row) + "\n")
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        for r in sweeps["t2i"]["sweep"]["results"][:4]:
            i = r["index"]
            render_codes(np.asarray(r["meta"]["target_codes"]),
                         os.path.join(out_dir, f"t2i{i}_target.png"))
            render_codes(r["codes"],
                         os.path.join(out_dir, f"t2i{i}_generated.png"))
    if return_params:
        return metrics, restored_params, cfg, T, tokz
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--out", default="results_torch/multitask_demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu to run without a card)")
    args = ap.parse_args(argv)
    m = run_demo(steps=args.steps, batch=args.batch, lr=args.lr,
                 out_dir=args.out, device=args.device)
    print(json.dumps(m, indent=2))


if __name__ == "__main__":
    main()
