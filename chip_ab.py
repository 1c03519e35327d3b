"""Same-run A/B of the forward attention body on one H100.

    python3 chip_ab.py                # design variants of this checkout
    python3 chip_ab.py --against DIR  # this checkout against another one
    python3 chip_ab.py --sweep        # K2's split counts; the planner's fit

``csrc/attention_ws.cuh`` (the bf16 body of K1-K4) fixes a few choices at
compile time.  The first form builds variant copies of
``mmada_parallel_torch/`` that differ from the checkout only in that header
(each variant is a list of text edits, which must all apply), under
``mmada_parallel_torch/_build/variants/``, all at once, then times the same
K3 and K2 calls with each variant in its own process, in the order A B ...
B A, so that each variant is measured twice in the same run of the card.
For each case it prints the device time of one call's kernels (the
profiler), the time per call of 20 calls queued back to back (CUDA events)
and the largest difference from the plain version; for each variant the
forward entries' registers and spill bytes (ptxas), and how many of the
edit shape's outputs differ from the checkout's (every seed is the same).
The output is checked against the plain version in every run, so a
variant that is wrong fails.

The second form compares this checkout's package with the one under
``DIR/mmada_parallel_torch`` (another commit's, e.g. ``git archive
<commit> mmada_parallel_torch | tar -x -C DIR``), each built apart and run
in its own process, in the order other, this, this, other:

* bit for bit: the outputs and row statistics of the same calls (K2
  unsplit at the full refresh, K2 split at the counts the previous planner
  chose, K4 causal and on a mixed batch, K3 at a length whose last q tile
  has under 65 rows), as counts of differing elements, which must be 0;
* the device time of one call (profiler), the CUDA-event time of one call
  (median of 10, the wrapper's host path included), their difference, and
  the host's time a call with 200 calls queued (no wait between them), for
  those calls and for K2 at each checkout's own planner;
* the host wall of the cached A edit and the cached A text-to-image at full
  width (``chip_smoke.py``'s runs, random 8B weights from seed 0; each run
  twice in a process, the second timed).

The third form times K2 at each of SWEEPS' shapes with its split count
forced to each of its counts (``chip_smoke._split_sweep``: the device time
of one call, the pre-pass and the combine included), then fits the
constants of the split planner's model (``ops/rope_attention.split_cost``
plus one free constant) to those times by least squares on the relative
error, and prints them with each shape's fastest count and the counts the
planner picks with the fitted and with the shipped constants.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "mmada_parallel_torch"
HEADER = os.path.join(PKG, "csrc", "attention_ws.cuh")
VARIANT_DIR = os.path.join(REPO, PKG, "_build", "variants")

# name -> text edits of attention_ws.cuh
VARIANTS = {
    "as built": [],
    "128-key tiles without a bias": [("  return kKeys;",
                                      "  return kBias ? 64 : 128;")],
    # K2 at Lq <= 64 runs warpgroup 0 alone; this variant has warpgroup 1
    # take its turns on rows past Lq there
    "both warpgroups at Lq <= 64": [
        ("    const bool solo = a.Lq <= 64;  // warpgroup 1 would hold no row",
         "    const bool solo = false;")],
}

# (name, kernel, B, Lq, Lk, H, KV, D, bias): K3 at the main paths' shapes
# (the exact edit's, the A train step's, the M trainer's and the T2I
# server's with their padding biases), D=64 without and with a bias, one
# key tile a row (a block's fixed cost), B=2 across the batch boundary; K2
# at the cached edit's partial step, the ring's chunk and the cached A
# text-to-image's partial step, split as the planner says
CASES = [("edit", "K3", 1, 2424, 2424, 32, 32, 128, None),
         ("A-train", "K3", 1, 5120, 5120, 32, 32, 128, None),
         ("M-trainer bias", "K3", 1, 2565, 2565, 32, 32, 128, "m-trainer"),
         ("T2I-server bias", "K3", 4, 1090, 1090, 32, 32, 128,
          "t2i-server"),
         ("D64", "K3", 1, 2424, 2424, 32, 32, 64, None),
         ("D64 bias", "K3", 1, 2424, 2424, 32, 32, 64, "pad"),
         ("one key tile", "K3", 1, 2424, 128, 32, 32, 128, None),
         ("B2 boundary bias GQA", "K3", 2, 1000, 1000, 32, 8, 128, "pad"),
         ("K2 partial", "K2", 1, 16, 2424, 32, 32, 128, None),
         ("K2 ring chunk", "K2", 1, 303, 2424, 8, 8, 128, None),
         ("K2 T2I partial", "K2", 1, 103, 1109, 32, 32, 128, None)]


def _parent_splits(B: int, H: int, Lq: int, Lk: int, sms: int) -> int:
    """The split count the block-counting planner (before the byte-aware
    one) chose: the fewest waves of blocks x the longest range among the
    counts that cover the SMs."""
    blocks, n = B * H * -(-Lq // 128), -(-Lk // 64)
    if blocks >= sms or n <= 1:
        return 1
    least = min(-(-sms // blocks), n)
    return min(range(least, n + 1),
               key=lambda S: (-(-blocks * S // sms) * -(-n // S), S))


# (name, kernel, B, Lq, Lk, H, KV, split or bounds): the bit-for-bit cases
# of --against; a K2 split of None is each checkout's own planner (timed,
# not compared)
EQUAL_CASES = [
    ("K2 full refresh", "K2", 1, 2424, 2424, 32, 32, 1),
    ("K2 partial, previous split", "K2", 1, 16, 2424, 32, 32, "parent"),
    ("K2 T2I partial, previous split", "K2", 1, 103, 1109, 32, 32,
     "parent"),
    ("K2 ring chunk, previous split", "K2", 1, 303, 2424, 8, 8, "parent"),
    ("K2 ring training, previous split", "K2", 1, 606, 2424, 16, 16,
     "parent"),
    ("K4 causal", "K4", 1, 5120, 5120, 32, 32, "causal"),
    ("K4 mixed B=3", "K4", 3, 5120, 5120, 32, 32, "mixed"),
    ("K3 L=2565", "K3", 1, 2565, 2565, 32, 32, None),
    ("K2 partial, planned", "K2", 1, 16, 2424, 32, 32, None),
    ("K2 T2I partial, planned", "K2", 1, 103, 1109, 32, 32, None),
    ("K2 ring chunk, planned", "K2", 1, 303, 2424, 8, 8, None),
    ("K2 ring training, planned", "K2", 1, 606, 2424, 16, 16, None),
]


# (B, H, Lq, Lk, split counts) of --sweep: the cached edit's partial step
# (Lq = 16, 22; Lq = 1), the cached A text-to-image's (Lq = 103 against
# the cond and the uncond sequence), the ring's serving chunk (Lq = 303,
# B = 1 and 2, 8 heads) and training chunk (Lq = 606, 16 heads), a tensor
# rank's partial step (16 heads), the M partial step at B = 1
SWEEPS = [(1, 32, 16, 2424, list(range(1, 13)) + [19, 38]),
          (1, 32, 22, 2424, list(range(1, 9)) + [38]),
          (1, 32, 103, 1109, list(range(1, 10)) + [18]),
          (1, 32, 103, 1130, list(range(1, 7))),
          (1, 8, 303, 2424, list(range(1, 9)) + [10, 13, 19, 38]),
          (2, 8, 303, 2424, list(range(1, 7)) + [19]),
          (1, 16, 606, 2424, list(range(1, 9)) + [13, 19]),
          (1, 16, 16, 2424, list(range(1, 9)) + [38]),
          (1, 32, 308, 2360, [1, 2, 3]),
          (1, 32, 1, 2424, [1, 2, 3, 4, 5, 8])]


def _make(name: str, edits) -> str:
    """A copy of the package with ``edits`` applied to the header; returns
    the directory to put first on ``sys.path``."""
    root = os.path.join(VARIANT_DIR, name.replace(" ", "_"))
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(root, HEADER)
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"chip_ab: variant {name!r}: the edit does not "
                             f"apply to {HEADER}:\n{old}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


def _bias(kind: str, B: int, L: int, device):
    """The case's f32 bias: a padding bias (the last row keeps 80 % of the
    keys), or the M trainer's or the T2I server's own (their shapes)."""
    import chip_smoke as C
    if kind == "pad":
        return C._pad_bias([L] * (B - 1) + [L * 8 // 10], L, L,
                           device).contiguous()
    if kind == "m-trainer":
        return C._mask_bias(C._m_cli_mask(device))
    return C._mask_bias(C._t2i_m_mask(device))


def _import(root: str):
    """Put ``root``'s package (and this checkout's scripts) first on
    ``sys.path``; fail if another copy of the package was imported."""
    sys.path[:0] = [root, REPO]
    from mmada_parallel_torch.ops import _cuda
    if not _cuda.__file__.startswith(os.path.join(root, PKG)):
        raise SystemExit(f"chip_ab: imported {_cuda.__file__}, not {root}")
    return _cuda


def _k2_call(B, Lq, Lk, H, KV, D, gen, dev):
    """K2 in bf16 on random inputs (q at positions 0..Lq-1): (call, plain),
    each taking ``with_stats``."""
    import torch
    import chip_smoke as C
    from mmada_parallel_torch.ops.rope_attention import (
        flash_attention_rope_qonly, flash_attention_rope_qonly_reference)
    q = torch.randn(B, Lq, H * D, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(B, Lk, KV * D, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    sin, cos = (t[:Lq].contiguous() for t in C._rope_tables(Lk, D, dev))
    kw = dict(n_heads=H, n_kv_heads=KV)
    return (lambda with_stats=False: flash_attention_rope_qonly(
                q, k, v, sin, cos, **kw, with_stats=with_stats),
            lambda: flash_attention_rope_qonly_reference(q, k, v, sin, cos,
                                                         **kw))


def run_variant(root: str, name: str) -> dict:
    """Build (if needed) and time every case with the variant at ``root``."""
    _cuda = _import(root)
    import torch
    import chip_smoke as C
    from mmada_parallel_torch.ops.attention import _xla_attention
    from mmada_parallel_torch.ops.flash_attention import flash_attention
    path = _cuda.build()
    with open(path[:-3] + ".log") as f:
        entries = C.ptxas_entries(f.read())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"variant": name, "ptxas": {
        f"{p} D={D}{' bias' if b else ''}": v
        for (p, D, b), v in sorted(entries.items())
        if p.startswith("fwd")}, "cases": {}}
    for case, kernel, B, Lq, Lk, H, KV, D, kind in CASES:
        if kernel == "K2":
            call, plain = _k2_call(B, Lq, Lk, H, KV, D, gen, dev)
        else:
            bias = None if kind is None else _bias(kind, B, Lk, dev)
            if bias is not None:
                B, Lq, Lk = bias.shape[0], bias.shape[2], bias.shape[3]
            q = torch.randn(B, Lq, H, D, generator=gen, device=dev).bfloat16()
            k, v = (torch.randn(B, Lk, KV, D, generator=gen,
                                device=dev).bfloat16() for _ in range(2))
            call = (lambda q=q, k=k, v=v, bias=bias:
                    flash_attention(q, k, v, bias))
            plain = (lambda q=q, k=k, v=v, bias=bias:
                     _xla_attention(q, k, v, bias))
        got, want = call(), plain()
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), **C.BF16_TOL):
            raise AssertionError(f"chip_ab: {name} {case}: max |err| {err}")
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            call()
        end.record()
        end.synchronize()
        us = sum(t for n, t in C._device_kernels(call, case).items()
                 if "attention_ws_kernel" in n)
        out["cases"][case] = {"device_us": round(us, 1),
                              "queued_ms": round(start.elapsed_time(end) / 20,
                                                 4),
                              "max_abs_err": err}
        if case in ("edit", "K2 partial"):   # compared across variants
            torch.save(got.cpu(), os.path.join(
                root, f"{case.replace(' ', '_')}_out.pt"))
    return out


def _build_all(roots) -> None:
    """Build every root's library at once (one nvcc per source each)."""
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from mmada_parallel_torch.ops import _cuda; _cuda.build()", root],
        stdout=subprocess.DEVNULL) for root in roots]
    if any([p.wait() for p in builds]):
        raise SystemExit("chip_ab: a build failed")


def _in_turns(mode: str, roots: dict, timeout: int) -> dict:
    """Run ``chip_ab.py <mode> root name`` for each name in the order
    A B ... B A; returns ``{name: [result, result]}``."""
    names = list(roots)
    runs = {name: [] for name in names}
    for name in names + names[::-1]:
        res = subprocess.run([sys.executable, __file__, mode, roots[name],
                              name], capture_output=True, text=True,
                             timeout=timeout)
        line = [x for x in res.stdout.splitlines() if x.startswith("{")]
        if res.returncode != 0 or not line:
            raise SystemExit(f"chip_ab: {mode} {name} failed:\n{res.stdout}"
                             f"\n{res.stderr[-4000:]}")
        runs[name].append(json.loads(line[-1]))
        print(f"[ab] {line[-1]}", flush=True)
    return runs


def main() -> int:
    import chip_smoke as C
    C.phase_device()
    roots = {name: _make(name, edits) for name, edits in VARIANTS.items()}
    _build_all(roots.values())
    names = list(VARIANTS)
    runs = _in_turns("--run", roots, 300)
    import torch
    for name in names:
        for case in ("edit", "K2 partial"):
            f = f"{case.replace(' ', '_')}_out.pt"
            base = torch.load(os.path.join(roots[names[0]], f))
            out = torch.load(os.path.join(roots[name], f))
            print(f"[ab] {name}: at {case} {int((out != base).sum())} of "
                  f"{base.numel()} outputs differ from {names[0]!r}'s")
        print(f"[ab] {name}: ptxas {runs[name][0]['ptxas']}")
        for case in runs[name][0]["cases"]:
            us = [r["cases"][case]["device_us"] for r in runs[name]]
            print(f"[ab]   {case}: device us {us} (median "
                  f"{statistics.median(us):.1f})", flush=True)
    return 0


def run_equal(root: str, name: str) -> dict:
    """Every EQUAL_CASES call with the package at ``root``: its outputs
    (and row statistics) saved under its ``_build/ab_equal/``, and its
    device, event and host times; the forced split counts printed."""
    _cuda = _import(root)
    import torch
    import chip_smoke as C
    from mmada_parallel_torch.ops.flash_attention import flash_attention
    from mmada_parallel_torch.ops.masks import mixed_prefix_bounds
    from mmada_parallel_torch.ops.rope_attention import (
        _sm_count, flash_attention_rope_prefix)
    _cuda.build()
    dev = torch.device("cuda")
    save = os.path.join(root, PKG, "_build", "ab_equal")
    os.makedirs(save, exist_ok=True)
    out = {"checkout": name, "cases": {}}
    for case, kernel, B, Lq, Lk, H, KV, how in EQUAL_CASES:
        gen = torch.Generator(device=dev).manual_seed(len(case))
        D, split = 128, None
        if kernel == "K2":
            call, _ = _k2_call(B, Lq, Lk, H, KV, D, gen, dev)
            split = (_parent_splits(B, H, Lq, Lk, _sm_count(dev))
                     if how == "parent" else how)
        elif kernel == "K4":
            q, k, v = (torch.randn(B, Lq, H * D, generator=gen,
                                   device=dev).bfloat16() for _ in range(3))
            sin, cos = C._rope_tables(Lq, D, dev)
            hi = (C._causal_bounds(B, Lq, dev) if how == "causal" else
                  mixed_prefix_bounds(Lq, 1, 1, 1, ((1024, 2080),), 1056,
                                      device=dev).contiguous())
            call = (lambda q=q, k=k, v=v, sin=sin, cos=cos, hi=hi, **_:
                    flash_attention_rope_prefix(q, k, v, sin, cos, hi,
                                                n_heads=H, n_kv_heads=KV))
        else:
            q, k, v = (torch.randn(B, Lq, H, D, generator=gen,
                                   device=dev).bfloat16() for _ in range(3))
            call = (lambda q=q, k=k, v=v, with_stats=False:
                    flash_attention(q, k, v, with_stats=with_stats))
        with C._forced_splits(split):
            res = call(with_stats=True) if kernel != "K4" else (call(),)
            torch.cuda.synchronize()
            if how is not None or kernel != "K2":
                torch.save([t.cpu() for t in res], os.path.join(
                    save, case.replace(" ", "_").replace(",", "") + ".pt"))
            device_ms = sum(C._device_kernels(call, case).values()) / 1e3
            ms = C.time_ms(call)
            # the host's time a call, 200 calls queued without a wait
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            enqueue_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        out["cases"][case] = {"split": split, "device_ms": device_ms,
                              "ms": ms, "host_ms": ms - device_ms,
                              "enqueue_us": enqueue_us}
    return out


def run_walls(root: str, name: str) -> dict:
    """The cached A edit's and the cached A text-to-image's host walls at
    full width with the package at ``root``: each run twice, the second
    timed (``chip_smoke.py``'s requests and options)."""
    _cuda = _import(root)
    import torch
    import chip_smoke as C
    from mmada_parallel_torch.samplers.image_gen import (
        ImageGenOptions, generate_image_cached)
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    _cuda.library()
    full = C.make_full_width(torch.Generator(device="cuda").manual_seed(0))
    edit_opts = TI2TIOptions(text_steps=32, timesteps=4, temperature=1.0,
                             text_temperature=0.7, cfg_scale=2.5,
                             cfg_img=4.0)
    ids, layout, un = C._t2i_a_request()
    x = torch.as_tensor(ids, device="cuda")[None]
    t2i_opts = ImageGenOptions(timesteps=18, temperature=1.0, cfg_scale=4.0,
                               use_cache=True)
    runs = {
        "cached edit": lambda: C._a_pipe(full)(
            "make the sky purple", C._edit_image(512), 512, 512, edit_opts,
            text_gen_length=256, seed=1, use_cache=True),
        "cached A T2I": lambda: generate_image_cached(
            full["params"], full["cfg"], x, layout, t2i_opts, uncond_ids=un,
            generator=torch.Generator(device="cuda").manual_seed(1)),
    }
    out = {"checkout": name, "walls_s": {}}
    for what, fn in runs.items():
        C._timed_run(fn)
        out["walls_s"][what] = C._timed_run(fn)[1]
    return out


def main_against(other: str) -> int:
    import torch
    import chip_smoke as C
    C.phase_device()
    other = os.path.abspath(other)
    if not os.path.isdir(os.path.join(other, PKG)):
        raise SystemExit(f"chip_ab: no {PKG}/ under {other}")
    roots = {"other": other, "this": REPO}
    _build_all(roots.values())
    runs = _in_turns("--equal", roots, 600)
    saved = {name: os.path.join(root, PKG, "_build", "ab_equal")
             for name, root in roots.items()}
    for f in sorted(os.listdir(saved["this"])):
        a = torch.load(os.path.join(saved["other"], f))
        b = torch.load(os.path.join(saved["this"], f))
        diff = [int((x != y).sum()) for x, y in zip(a, b)]
        print(f"[ab-equal] {f[:-3]}: elements that differ (output"
              f"{', statistics' if len(diff) > 1 else ''}) {diff} of "
              f"{[x.numel() for x in a]}", flush=True)
        if any(diff):
            raise AssertionError(f"chip_ab: {f[:-3]} differs from the other "
                                 f"checkout's")
    for case, *_ in EQUAL_CASES:
        for name in roots:
            rs = [r["cases"][case] for r in runs[name]]
            print(f"[ab-equal] {case} {name}: split "
                  f"{rs[0]['split'] or '-'}; device ms "
                  f"{[round(r['device_ms'], 4) for r in rs]}, event ms "
                  f"{[round(r['ms'], 4) for r in rs]}, events - device ms "
                  f"{[round(r['host_ms'], 4) for r in rs]}, host us a call "
                  f"queued {[round(r['enqueue_us'], 1) for r in rs]}",
                  flush=True)
    walls = _in_turns("--walls", roots, 900)
    for what in walls["this"][0]["walls_s"]:
        print(f"[ab-walls] {what}: " + "; ".join(
            f"{name} {[round(r['walls_s'][what], 3) for r in walls[name]]} s"
            for name in roots), flush=True)
    return 0


def main_sweep() -> int:
    import numpy as np
    from scipy.optimize import least_squares
    import chip_smoke as C
    C.sys.path.insert(0, REPO)
    from mmada_parallel_torch.ops.rope_attention import (
        SPLIT_COSTS, _sm_count, split_cost)
    import torch
    C.phase_device()
    C.phase_build()
    sms = _sm_count(torch.device("cuda"))
    data = {(B, H, Lq, Lk): C._split_sweep(B, Lq, Lk, H, 128, counts)
            for B, H, Lq, Lk, counts in SWEEPS}

    def costs(x):
        return {"tile_us": (x[0], x[1]), "item_us": x[2],
                "combine_us": x[3], "bytes_per_us": x[4] * 1e6}

    def residuals(x):
        return [(x[5] + split_cost(S, *shape, sms, costs=costs(x)) - us)
                / us for shape, by in data.items() for S, us in by.items()]

    fit = least_squares(residuals, [0.7, 1.0, 1.5, 1.5, 3.35, 2.0],
                        bounds=([0.05] * 4 + [0.5, 0.0], [5] * 4 + [20, 20]))
    x = fit.x
    print(f"[sweep] fitted over {sum(map(len, data.values()))} counts at "
          f"{len(data)} shapes: tile_us ({x[0]:.3f}, {x[1]:.3f}), item_us "
          f"{x[2]:.3f}, combine_us {x[3]:.3f}, bytes_per_us {x[4]:.3f}e6, "
          f"constant {x[5]:.3f} us; relative error rms "
          f"{float(np.sqrt(np.mean(np.square(fit.fun)))):.3f}, max "
          f"{float(np.max(np.abs(fit.fun))):.3f}", flush=True)
    for shape, by in data.items():
        n = -(-shape[3] // 64)
        picks = [min(range(1, n + 1), key=lambda S: (
            split_cost(S, *shape, sms, costs=c), S))
            for c in (costs(x), SPLIT_COSTS)]
        best = min(by, key=by.get)
        print(f"[sweep] B={shape[0]} H={shape[1]} Lq={shape[2]} "
              f"Lk={shape[3]}: fastest {best} ({by[best]:.1f} us); fitted "
              f"constants pick {picks[0]} ({by.get(picks[0], float('nan')):.1f}"
              f" us), shipped pick {picks[1]} "
              f"({by.get(picks[1], float('nan')):.1f} us)", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] in ("--run", "--equal",
                                                "--walls"):
        fn = {"--run": run_variant, "--equal": run_equal,
              "--walls": run_walls}[sys.argv[1]]
        print(json.dumps(fn(sys.argv[2], sys.argv[3])), flush=True)
    elif len(sys.argv) == 3 and sys.argv[1] == "--against":
        sys.exit(main_against(sys.argv[2]))
    elif sys.argv[1:] == ["--sweep"]:
        sys.exit(main_sweep())
    else:
        sys.exit(main())
