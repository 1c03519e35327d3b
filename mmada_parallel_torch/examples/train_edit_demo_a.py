"""Variant-A capability demo: train a tiny model on the synthetic
palette-shift edit through the port's production A training path --
``AItemProcessor`` items (pickled VQ grids, ``<system>/<user>`` template,
cosine ``mask_codes``) optimized with ``a_variant_losses`` -- round-trip the
train state through the :class:`CheckpointManager`, then sample the
restored weights with the reference TI2TI template
(``assemble_ti2ti_sequence`` + ``generate_ti2ti``) and check that the
generated codes and text solve the task.

A layout or region-loss mismatch between the item processor (training
side) and ``assemble_ti2ti_sequence`` + ``samplers/parallel_ti2ti.py``
(inference side) caps code accuracy near chance (1/16).

Expected ceiling: ~15/16 code accuracy.  The A sampler's re-mask keeps at
least one image token masked through the final step, and the deterministic
extraction fills leftovers with code 0, so one grid cell is a structural
coin-flip, not a learning failure.

Counterpart of the JAX package's ``examples/train_edit_demo_a.py``; the
model, data stream and eval protocol are the same, the weights are drawn
from a ``torch.Generator``.

    python -m mmada_parallel_torch.examples.train_edit_demo_a \
        --device cuda [--steps 800] [--out results_torch/edit_demo_a]
"""

import argparse
import atexit
import hashlib
import json
import os
import pickle
import random
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.data.item_processor import AItemProcessor
from mmada_parallel_torch.examples import (checkpoint_round_trip,
                                           resolve_device)
from mmada_parallel_torch.models.llada import (LLaDAConfig, init_llada_params,
                                               llada_forward)
from mmada_parallel_torch.samplers.parallel_ti2ti import (
    TI2TIOptions, generate_ti2ti, generate_ti2ti_cached)
from mmada_parallel_torch.training.losses import a_variant_losses
from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                   TrainState, make_optimizer,
                                                   make_train_step)
from mmada_parallel_torch.utils.param_store import load_params, save_params

TVS, CB = 64, 16
GRID = 4                      # 4x4 codes -> 64x64 px at patch 16
N_VQ = GRID * GRID
# six words: the eval sequence is then 64 tokens long, a multiple of a
# 4-way tensor-parallel ring's width
PROMPT = "shift the palette by one one"

# the sources whose changes invalidate a stored trained model (paths
# relative to the package): this demo and the training stack it runs
DEMO_SOURCES = [
    "examples/train_edit_demo_a.py",
    "models/llada.py",
    "training/losses.py",
    "training/trainer.py",
    "data/item_processor.py",
    "samplers/parallel_ti2ti.py",
    "tokens.py",
]


def demo_param_store(**kwargs) -> str:
    """The trained A model's ``.npz`` store (``utils/param_store``) for
    these run kwargs, keyed by the sha of :data:`DEMO_SOURCES` and the
    kwargs, so a changed training stack retrains instead of scoring stale
    weights: ``~/.cache/mmada_parallel_torch/fixtures/
    torch_edit_demo_a_{sha}.npz``."""
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for rel in DEMO_SOURCES:
        with open(os.path.join(package, rel), "rb") as f:
            h.update(f.read())
    h.update(repr(sorted(kwargs.items())).encode())
    cache = os.path.join(os.path.expanduser("~"), ".cache",
                         "mmada_parallel_torch", "fixtures")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, f"torch_edit_demo_a_{h.hexdigest()[:16]}.npz")


class WordTokA:
    """Word/tag-level tokenizer covering the A prompt template."""

    bos_token_id, eos_token_id = 1, 2
    _words = {"<system>": 3, "</system>": 4, "<user>": 5, "</user>": 6,
              "<uncondition>": 7, "</answer>": 8, "edit": 9, "shift": 10,
              "the": 11, "palette": 12, "by": 13, "rotated": 14,
              "colors": 15, "done": 16}

    def _ids(self, text):
        return [self._words.get(w, 17)
                for w in re.findall(r"<[^>]+>|[a-z]+", text)]

    def __call__(self, text, add_special_tokens=True, **kw):
        ids = self._ids(text)
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return {"input_ids": ids}

    def decode(self, ids, **kw):
        inv = {v: k for k, v in self._words.items()}
        return " ".join(inv.get(int(i), "?") for i in ids
                        if int(i) not in (self.bos_token_id,
                                          self.eos_token_id))


def demo_tokens() -> tk.VariantATokens:
    return tk.VariantATokens(
        mask=60, newline=50, answer_start=51, answer_end=52, boi=53,
        eoi=54, uncondition=55, pad=56, text_vocab_size=TVS,
        codebook_size=CB)


def demo_config(T: tk.VariantATokens) -> LLaDAConfig:
    return LLaDAConfig.tiny(d_model=128, n_heads=4, n_kv_heads=4,
                            mlp_hidden_size=256,
                            vocab_size=T.full_vocab_size,
                            mask_token_id=T.mask,
                            attention_impl="xla")


def write_grid_pickles(out_dir, n_items, rng):
    """Pickled pre-tokenized grids, the ``AItemProcessor`` input format
    (offset ids + pixel dims)."""
    os.makedirs(out_dir, exist_ok=True)
    items = []
    for i in range(n_items):
        codes_in = rng.integers(0, CB, N_VQ)
        codes_out = (codes_in + 1) % CB
        paths = []
        for tag, codes in (("in", codes_in), ("out", codes_out)):
            p = os.path.join(out_dir, f"item{i}_{tag}.pkl")
            with open(p, "wb") as f:
                pickle.dump({"input_ids": (codes + TVS).tolist(),
                             "height": GRID * 16, "width": GRID * 16}, f)
            paths.append(p)
        items.append({"system_prompt": "edit",
                      "user_prompt": PROMPT,
                      "user_image": paths[0], "answer_image": paths[1],
                      "answer_text": "rotated colors done",
                      "_codes_in": codes_in})
    return items


def collate(proc, items, rows):
    """``(ids, labels, lengths)`` int32 arrays of the items ``rows``,
    right-padded with 0 / -100."""
    toks, labs = zip(*(proc.process_item(items[r]) for r in rows))
    L = max(len(t) for t in toks)
    ids = np.zeros((len(toks), L), np.int32)
    labels = np.full((len(toks), L), -100, np.int32)
    for r, (t, l) in enumerate(zip(toks, labs)):
        ids[r, :len(t)] = t
        labels[r, :len(l)] = l
    lengths = np.asarray([len(t) for t in toks], np.int32)
    return ids, labels, lengths


def make_loss_fn(cfg, T):
    def loss_fn(p, b, generator=None):
        ids, labels, lengths = b
        logits = llada_forward(p, cfg, ids)
        out = a_variant_losses(
            logits, ids, labels, lengths,
            answer_start_token=T.answer_start, answer_end_token=T.answer_end,
            image_start_token=T.boi, image_end_token=T.eoi,
            newline_token=T.newline)
        return out["loss"], {"text_loss": out["text_loss"],
                             "image_loss": out["image_loss"]}
    return loss_fn


def assemble_eval_sequence(tokz, T, codes_in):
    """The reference TI2TI inference template for one input grid:
    ``(ids, layout, ans_len)``, shared by the eval loop and
    ``pararl_resteer_demo``."""
    cond, _ = tk.make_ti2ti_prompt(PROMPT, "edit")
    prompt_ids = tokz(cond)["input_ids"]
    end_ids = tokz("</answer>", add_special_tokens=False)["input_ids"]
    ans_len = len(tokz("rotated colors done")["input_ids"])  # bos..eos
    span = tk.add_break_line((np.asarray(codes_in) + TVS).tolist(), GRID,
                             GRID, T.newline)
    con = prompt_ids[:-1] + [T.boi] + span + [T.eoi] + prompt_ids[-1:]
    ids, lay = tk.assemble_ti2ti_sequence(con, ans_len, GRID, GRID, end_ids,
                                          tokens=T)
    return ids, lay, ans_len


def eval_a_model(params, cfg, T, tokz, seed=0, use_cached=False,
                 hidden_fn=None, **cache_kw):
    """The eval protocol of the trained A model: 4 seeded palette edits
    through the reference TI2TI template at temperature 0; returns
    ``(accs, codes, texts, inputs)``.  ``use_cached=True`` samples through
    ``generate_ti2ti_cached`` (with ``cache_kw``): every opt-in
    approximation is judged by its accuracy delta on this task.
    ``hidden_fn`` swaps the backbone (e.g. ``ring_hidden_fn(mesh,
    int8_payload=True)``; the eval sequence is ring-compatible: 64 tokens,
    maskless, B=1)."""
    device = params["wte"].device
    ans_len = len(tokz("rotated colors done")["input_ids"])  # bos..eos
    opts = TI2TIOptions(text_steps=ans_len, timesteps=8, temperature=0.0,
                        text_temperature=0.0, cfg_scale=0.0, cfg_img=0.0,
                        text_vocab_size=TVS, codebook_size=CB,
                        mask_token=T.mask)

    eval_rng = np.random.default_rng(seed + 1234)
    accs, gen_codes, gen_texts, inputs = [], [], [], []
    for _ in range(4):
        codes_in = eval_rng.integers(0, CB, N_VQ)
        ids, lay, _ = assemble_eval_sequence(tokz, T, codes_in)
        ids_t = torch.as_tensor(ids, device=device)[None]
        if use_cached:
            fin, out_codes = generate_ti2ti_cached(params, cfg, ids_t, lay,
                                                   opts, **cache_kw)
        else:
            fin, out_codes = generate_ti2ti(params, cfg, ids_t, lay, opts,
                                            hidden_fn=hidden_fn)
        got = out_codes[0].cpu().numpy()   # raw codes
        want = (codes_in + 1) % CB
        accs.append(float((got == want).mean()))
        inputs.append(codes_in)
        gen_codes.append(got)
        fin = fin[0].cpu().numpy()
        gen_texts.append(tokz.decode(
            [t for t in fin[lay.text_start:lay.text_end] if int(t) < TVS]))
    return accs, gen_codes, gen_texts, inputs


def run_demo_a(steps=600, batch=32, lr=3e-3, out_dir=None, seed=0,
               log_every=50, work_dir=None, return_params=False,
               param_store=None, device="cuda"):
    """Train, checkpoint, restore, generate; returns the metrics dict (and
    ``(metrics, params, cfg, T, tokz)`` with ``return_params``).

    ``param_store``: an ``.npz`` path (``utils/param_store``); when it
    exists its params are loaded and training is skipped (the checkpoint
    round trip and the eval still run), else the trained params are saved
    there.  The checkpoint goes to ``out_dir/ckpt``, or to a temporary
    directory without ``out_dir``."""
    device = resolve_device(device) if isinstance(device, str) else device
    T = demo_tokens()
    tokz = WordTokA()
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

    work = work_dir or (out_dir and os.path.join(out_dir, "grids"))
    if not work:  # per-run scratch, removed at interpreter exit
        work = tempfile.mkdtemp(prefix="edit_demo_a_grids_")
        atexit.register(shutil.rmtree, work, ignore_errors=True)
    rng = np.random.default_rng(seed)
    items = write_grid_pickles(work, 256, rng)
    proc = AItemProcessor(tokenizer=tokz, tokens=T, uncondition_prob=0.0,
                          rng=random.Random(seed))

    opt_cfg = OptimizerConfig(lr=lr, weight_decay=0.0)
    opt = make_optimizer(opt_cfg, params)
    state = TrainState.create(params, opt)
    step_fn = make_train_step(make_loss_fn(cfg, T), opt, accum_steps=1)

    curve = []
    t0 = time.time()
    for i in range(steps):
        rows = rng.integers(0, len(items), batch)
        b = tuple(torch.as_tensor(x, device=device)
                  for x in collate(proc, items, rows))
        state, metrics = step_fn(state, b)
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
        state, steps, fresh, {"task": "palette_shift_demo_a"},
        os.path.join(out_dir, "ckpt") if out_dir else None)

    # ---- generation via the reference TI2TI template ----
    accs, gen_codes, gen_texts, inputs = eval_a_model(
        restored_params, cfg, T, tokz, seed=seed)

    metrics = {
        "task": "palette_shift (+1 mod codebook) edit, variant A",
        "steps": steps, "batch": batch, "train_seconds": round(train_s, 1),
        "final_loss": curve[-1]["loss"] if curve else None,
        "eval_code_accuracy": round(float(np.mean(accs)), 4),
        "per_sample_accuracy": [round(a, 4) for a in accs],
        "generated_text": gen_texts,
    }

    if out_dir:
        from mmada_parallel_torch.examples.train_edit_demo import render_codes
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "loss_curve.jsonl"), "w") as f:
            for row in curve:
                f.write(json.dumps(row) + "\n")
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
        for r in range(len(inputs)):
            render_codes(inputs[r],
                         os.path.join(out_dir, f"sample{r}_input.png"))
            render_codes((inputs[r] + 1) % CB,
                         os.path.join(out_dir, f"sample{r}_target.png"))
            render_codes(gen_codes[r],
                         os.path.join(out_dir, f"sample{r}_generated.png"))
    if return_params:
        return metrics, restored_params, cfg, T, tokz
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--out", default="results_torch/edit_demo_a")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu to run without a card)")
    args = ap.parse_args(argv)
    m = run_demo_a(steps=args.steps, batch=args.batch, lr=args.lr,
                   out_dir=args.out, device=args.device)
    print(json.dumps(m, indent=2))


if __name__ == "__main__":
    main()
