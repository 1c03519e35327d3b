"""Variant-M capability demo: train a tiny model on a synthetic edit task,
checkpoint it, restore it into other weights and generate, producing image
artifacts from the whole train -> save -> restore -> sample lifecycle.

The task: the output image is the input image with every VQ code shifted
by +1 (mod codebook), a palette rotation, and the output text is a fixed
confirmation sentence.  A model that solves it must (a) copy the input span
through attention, (b) apply the learned code map and (c) denoise the
masked output under the interleave template the reference trains
(``MMaDA-Parallel-M/training/train_interleave.py:640-800``) and samples
(``inference.py:80-130``).

Everything runs through the port's production stack: ``UniversalPrompting``
and ``interleave_noising`` for data, ``make_train_step`` for optimization,
the :class:`CheckpointManager` for the round trip and
``interleave_generate`` for sampling.  Codes are rendered to PNGs through a
fixed palette, so "generated == target" is visible, not just asserted.

Counterpart of the JAX package's ``examples/train_edit_demo.py``: the same
numpy streams build the same batch rows; the noising draws come from one
``torch.Generator`` on the demo's device.

    python -m mmada_parallel_torch.examples.train_edit_demo --device cuda \
        [--steps 1200] [--out results_torch/edit_demo]
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np
import torch

from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.data.prompting import UniversalPrompting
from mmada_parallel_torch.examples import (checkpoint_round_trip,
                                           resolve_device)
from mmada_parallel_torch.models.llada import (LLaDAConfig, init_llada_params,
                                               llada_forward)
from mmada_parallel_torch.samplers.interleave import (
    InterleaveOptions, interleave_generate, interleave_generate_cached)
from mmada_parallel_torch.training.losses import m_interleave_loss
from mmada_parallel_torch.training.lr_schedules import get_scheduler
from mmada_parallel_torch.training.masking import interleave_noising
from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                   TrainState, make_optimizer,
                                                   make_train_step)
from mmada_parallel_torch.utils.param_store import load_params, save_params

# ----------------------------------------------------------------- tokens
TVS, CB = 32, 16          # text vocab / codebook
N_VQ, MSL = 16, 6         # 4x4 image grid, short text span
GRID = 4


class WordTok:
    """Minimal word-level tokenizer over the demo vocabulary."""

    bos_token_id, eos_token_id = 1, 2
    _words = {"shift": 3, "the": 4, "palette": 5, "by": 6, "one": 7,
              "done": 8, "rotated": 9, "colors": 10}

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
        mask=31, soi=30, eoi=29, interleave=27, t2it=26, bos=1, eos=2,
        text_vocab_size=TVS, codebook_size=CB)


def demo_config(T) -> LLaDAConfig:
    return LLaDAConfig.tiny(d_model=128, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=256,
                            vocab_size=T.full_vocab_size,
                            mask_token_id=T.mask,
                            attention_impl="xla")


PALETTE = np.asarray(
    [[31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
     [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
     [188, 189, 34], [23, 190, 207], [174, 199, 232], [255, 187, 120],
     [152, 223, 138], [255, 152, 150], [197, 176, 213], [196, 156, 148]],
    np.uint8)


def render_codes(codes, path, cell=32):
    """Palette-render a ``[N_VQ]`` raw-code vector to a PNG grid."""
    from PIL import Image
    grid = PALETTE[np.asarray(codes, int).reshape(GRID, GRID) % CB]
    img = Image.fromarray(grid, "RGB").resize(
        (GRID * cell, GRID * cell), Image.NEAREST)
    img.save(path)
    return img


def make_batch(rng, B, T, up, generator):
    """Synthetic edit pairs through the production prompting and noising
    path: ``((seq, labels, mask, t), codes_in)`` as numpy arrays.  The codes
    come from ``rng``, the noising draws from ``generator`` (on its
    device)."""
    codes_in = rng.integers(0, CB, (B, N_VQ)) + TVS          # vocab-offset
    codes_out = (codes_in - TVS + 1) % CB + TVS              # +1 palette shift
    instr = ["shift the palette by"] * B
    out_text = np.full((B, MSL), T.eos, np.int64)
    sent = [T.bos, 9, 10, 8, T.eos]                 # bos rotated colors done eos
    out_text[:, :len(sent)] = sent

    dev = generator.device
    noisy_img, img_lab, noisy_txt, txt_lab, t = (
        x.cpu().numpy() for x in interleave_noising(
            generator, torch.as_tensor(codes_out, device=dev),
            torch.as_tensor(out_text, device=dev), mask_token=T.mask))
    seq, labels, mask = up.interleave(
        codes_in, instr, noisy_img, noisy_txt, txt_lab,
        cond_dropout_prob=0.0, output_image_labels=img_lab)
    return (seq.astype(np.int32), labels.astype(np.int32),
            mask.astype(np.int32), np.asarray(t, np.float32)), codes_in


def make_loss_fn(cfg):
    def loss_fn(p, b, generator=None):
        ids, labels, mask, t = b
        logits = llada_forward(p, cfg, ids, mask.bool())
        out = m_interleave_loss(logits, labels, t, MSL, N_VQ)
        return out["loss"], {"text_loss": out["text_loss"],
                             "image_loss": out["image_loss"]}
    return loss_fn


def eval_palette_model(params, cfg, T, tokz, seed=0, n_samples=4,
                       use_cached=False, **cached_kw):
    """Generate on held-out inputs through the reference inference template
    at temperature 0; returns ``(accs, gen_codes, gen_texts, codes_in,
    want)``.  Takes dense or int8 params (``quantize_llada_params``);
    ``use_cached=True`` samples through ``interleave_generate_cached`` (with
    ``cached_kw``) instead of the exact path."""
    gen = (functools.partial(interleave_generate_cached, **cached_kw)
           if use_cached else interleave_generate)
    device = params["wte"].device

    opts = InterleaveOptions(
        text_steps=MSL, image_steps=8, text_cfg=0.0, image_cfg=0.0,
        text_temperature=0.0, image_temperature=0.0,
        text_vocab_size=TVS, codebook_size=CB, mask_token=T.mask)
    eval_rng = np.random.default_rng(seed + 1234)
    codes_in = eval_rng.integers(0, CB, (n_samples, N_VQ))
    want = (codes_in + 1) % CB
    instr = [T.bos] + tokz("shift the palette by")["input_ids"] + [T.eos]

    accs, gen_codes, gen_texts = [], [], []
    for r in range(codes_in.shape[0]):
        prompt = ([T.interleave, T.soi]
                  + [int(c) + TVS for c in codes_in[r]] + [T.eoi] + instr)
        ids, lay = tk.assemble_interleave_sequence(prompt, N_VQ, MSL,
                                                   tokens=T)
        un_prompt = ([T.interleave, T.soi] + [0] * N_VQ + [T.eoi]
                     + [T.bos, T.eos] + [T.eos] * (len(instr) - 2))
        un_ids, _ = tk.assemble_interleave_sequence(un_prompt, N_VQ, MSL,
                                                    tokens=T)
        fin, out_codes = gen(
            params, cfg, torch.as_tensor(ids, device=device)[None],
            torch.as_tensor(un_ids, device=device)[None], lay, opts)
        got = out_codes[0].cpu().numpy()
        accs.append(float((got == want[r]).mean()))
        gen_codes.append(got)
        fin = fin[0].cpu().numpy()
        gen_texts.append(tokz.decode(
            [t for t in fin[lay.text_start:lay.text_end] if int(t) < TVS]))
    return accs, gen_codes, gen_texts, codes_in, want


def run_demo(steps=1200, batch=32, lr=1.5e-3, out_dir=None, seed=0,
             log_every=50, return_params=False, param_store=None,
             device="cuda"):
    """Train, checkpoint, restore, generate; returns the metrics dict (and
    ``(metrics, params, cfg, T, tokz)`` with ``return_params``).

    ``param_store``: an ``.npz`` path (``utils/param_store``); when it
    exists its params are loaded and training is skipped (the checkpoint
    round trip, the eval and the artifacts still run), else the trained
    params are saved there.  The checkpoint goes to ``out_dir/ckpt``, or to
    a temporary directory without ``out_dir``."""
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
    # pads the text to max_text_len + 1 == MSL (prompting_utils.py:78)
    up = UniversalPrompting(tokz, max_text_len=MSL - 1, tokens=T,
                            rng=np.random.default_rng(seed))

    # the linear warmup steadies the hot lr: without it about half of the
    # random streams spike around step 300-400 and plateau
    sched = get_scheduler("constant_with_warmup", lr,
                          warmup_steps=min(100, steps // 4))
    opt_cfg = OptimizerConfig(lr=lr, weight_decay=0.0, schedule=sched)
    opt = make_optimizer(opt_cfg, params)
    state = TrainState.create(params, opt)
    step_fn = make_train_step(make_loss_fn(cfg), opt, accum_steps=1)

    rng = np.random.default_rng(seed)
    noise = torch.Generator(device=device).manual_seed(seed + 1)
    curve = []
    t0 = time.time()
    for i in range(steps):
        b, _ = make_batch(rng, batch, T, up, noise)
        state, metrics = step_fn(
            state, tuple(torch.as_tensor(x, device=device) for x in b))
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            curve.append({"step": i, "loss": round(loss, 4),
                          "image_loss": round(float(metrics["image_loss"]), 4),
                          "text_loss": round(float(metrics["text_loss"]), 4)})
            print(f"step {i:4d}  loss {loss:8.4f}  "
                  f"img {float(metrics['image_loss']):8.4f}  "
                  f"txt {float(metrics['text_loss']):8.4f}", file=sys.stderr)
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
        state, steps, fresh, {"task": "palette_shift_demo"},
        os.path.join(out_dir, "ckpt") if out_dir else None)

    # ---- generation on held-out inputs (reference inference template) ----
    accs, gen_codes, gen_texts, codes_in, want = eval_palette_model(
        restored_params, cfg, T, tokz, seed=seed)

    metrics = {
        "task": "palette_shift (+1 mod codebook) edit",
        "steps": steps, "batch": batch, "train_seconds": round(train_s, 1),
        "final_loss": curve[-1]["loss"] if curve else None,
        "eval_code_accuracy": round(float(np.mean(accs)), 4),
        "per_sample_accuracy": [round(a, 4) for a in accs],
        "generated_text": gen_texts,
    }

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "loss_curve.jsonl"), "w") as f:
            for row in curve:
                f.write(json.dumps(row) + "\n")
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        for r in range(codes_in.shape[0]):
            render_codes(codes_in[r],
                         os.path.join(out_dir, f"sample{r}_input.png"))
            render_codes(want[r],
                         os.path.join(out_dir, f"sample{r}_target.png"))
            render_codes(gen_codes[r],
                         os.path.join(out_dir, f"sample{r}_generated.png"))
    if return_params:
        return metrics, restored_params, cfg, T, tokz
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--out", default="results_torch/edit_demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu to run without a card)")
    args = ap.parse_args(argv)
    m = run_demo(steps=args.steps, batch=args.batch, lr=args.lr,
                 out_dir=args.out, device=args.device)
    print(json.dumps(m, indent=2))


if __name__ == "__main__":
    main()
