"""The ParaBench-style sweep end to end on the trained A demo model, with
the local default scorers and no external judges; writes
``metrics.json`` to ``--out``.

Trains (or loads from its store) the palette-edit model of
:mod:`.train_edit_demo_a`, builds held-out edit requests, sweeps them
through ``evaluation.run_parabench_sweep`` (bucketed, batched sampler),
scores each output with ``eval_scorers.pixel_edit_scorer(
default_edit_scorer)`` (consistency, target_match, text_alignment,
code_diversity, and PSNR/SSIM of the pixels the demo's deterministic
palette decoder gives) and aggregates.

Counterpart of the JAX package's ``examples/parabench_demo.py``.

    python -m mmada_parallel_torch.examples.parabench_demo --device cuda \
        [--out results_torch/parabench_demo]
"""

import argparse
import json
import os

import numpy as np

from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.eval_scorers import (aggregate_scores,
                                               default_edit_scorer,
                                               pixel_edit_scorer)
from mmada_parallel_torch.evaluation import EvalRequest, run_parabench_sweep
from mmada_parallel_torch.examples.train_edit_demo_a import (
    CB, GRID, N_VQ, PROMPT, TVS, demo_param_store, run_demo_a)
from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions


def build_requests(tokz, T, n_requests=8, seed=0):
    """Held-out palette-edit requests with scoring metadata."""
    rng = np.random.default_rng(seed + 4321)
    cond, _ = tk.make_ti2ti_prompt(PROMPT, "edit")
    prompt_ids = tokz(cond)["input_ids"]
    requests = []
    for _ in range(n_requests):
        codes_in = rng.integers(0, CB, N_VQ)
        span = tk.add_break_line((codes_in + TVS).tolist(), GRID, GRID,
                                 T.newline)
        con = prompt_ids[:-1] + [T.boi] + span + [T.eoi] + prompt_ids[-1:]
        requests.append(EvalRequest(
            prompt_ids=con,
            meta={"input_codes": codes_in.tolist(),
                  "target_codes": ((codes_in + 1) % CB).tolist(),
                  "keywords": ["rotated", "done"]}))
    return requests


def palette_decoder():
    """The demo's deterministic "decoder": each palette code to a fixed RGB
    color, so PSNR/SSIM against the decoded input and target measure the
    edit in pixel space as well as in code space."""
    cvec = np.arange(CB)
    palette = np.stack([(cvec % CB) / CB, (cvec * 7 % CB) / CB,
                        (cvec * 3 % CB) / CB], axis=-1)

    def decode(codes):
        return palette[np.asarray(codes).reshape(GRID, GRID) % CB]
    return decode


def run(out_dir=None, n_requests=8, steps=800, seed=0, device="cuda",
        trained=None):
    """Sweep the trained A model; returns the metrics dict.

    ``trained``: ``(metrics, params, cfg, T, tokz)`` of a
    ``run_demo_a(..., return_params=True)`` run to score; by default the
    model is trained here (800 steps, batch 32, lr 3e-3) or loaded from its
    source-hash-keyed store (``demo_param_store``)."""
    if trained is None:
        store = demo_param_store(steps=steps, batch=32, lr=3e-3,
                                 log_every=400)
        trained = run_demo_a(
            steps=steps, batch=32, lr=3e-3, out_dir=None, log_every=400,
            seed=seed, return_params=True, param_store=store, device=device)
    m, params, cfg, T, tokz = trained

    requests = build_requests(tokz, T, n_requests, seed)
    ans_len = len(tokz("rotated colors done")["input_ids"])
    opts = TI2TIOptions(text_steps=ans_len, timesteps=8, temperature=0.0,
                        text_temperature=0.0, cfg_scale=0.0, cfg_img=0.0,
                        text_vocab_size=TVS, codebook_size=CB,
                        mask_token=T.mask)
    end_ids = tokz("</answer>", add_special_tokens=False)["input_ids"]

    scorer = pixel_edit_scorer(palette_decoder(), base=default_edit_scorer())
    sweep = run_parabench_sweep(
        params, cfg, requests, grid_hw=(GRID, GRID),
        text_gen_length=ans_len, end_token_ids=end_ids, opts=opts,
        batch_size=4, tokenizer=tokz, seed=seed,
        scorer=scorer, tokens=T)

    agg = aggregate_scores(sweep["results"])
    metrics = {
        "task": "palette_shift demo, ParaBench-style local scorers",
        "n_requests": sweep["num_requests"],
        "aggregate": {k: round(v, 4) for k, v in agg.items()},
        "trained_eval_code_accuracy": m["eval_code_accuracy"],
        "edits_per_min": round(sweep["edits_per_min"], 2),
        "per_request": [
            {"index": r["index"], "text": r["text"],
             "scores": {k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in r["scores"].items()}}
            for r in sweep["results"]],
        "scorer": "eval_scorers.pixel_edit_scorer(default_edit_scorer) "
                  "(local proxies incl. decoded-pixel PSNR/SSIM; "
                  "not comparable to published GPT-judged ParaBench "
                  "numbers)",
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results_torch/parabench_demo")
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu to run without a card)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.out, args.n, steps=args.steps,
                         device=args.device), indent=2))


if __name__ == "__main__":
    main()
