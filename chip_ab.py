"""Same-run A/B of the forward attention body's design choices on one H100.

    python3 chip_ab.py           # from the repository root, one card

``csrc/attention_ws.cuh`` (the bf16 body of K1 and K3) fixes a few choices
at compile time: the key tile (64 keys), the ring's stages (4), the bias
fragment read a tile ahead, a persistent grid, a stage released by every
consumer thread, O rescaled at every tile, the past-Lk masking of the last
tile apart from the main loop.  This script builds
variant copies of ``mmada_parallel_torch/`` that differ from the checkout
only in that header (each variant is a list of text edits, which must all
apply), under ``mmada_parallel_torch/_build/variants/``, all at once, then
times the same K3 calls with each variant in its own process, in the order
A B ... B A, so that each variant is measured twice in the same run of the
card.  For each case it prints the device time of one call's kernels (the
profiler), the time per call of 20 calls queued back to back (CUDA events)
and the largest difference from the plain version; for each variant the
forward entries' registers and spill bytes (ptxas), and how many of the
edit shape's outputs differ from the checkout's (every seed is the same).
The output is checked against the plain version in every run, so a
variant that is wrong fails.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "mmada_parallel_torch"
HEADER = os.path.join(PKG, "csrc", "attention_ws.cuh")
VARIANT_DIR = os.path.join(REPO, PKG, "_build", "variants")

_PREFETCH = [
    ("""      if constexpr (kBias) {
        load_bias<kNb>(bz, bias_lo, bias_hi, 0, tig, Lk);
        load_bias<kNb>(bzn, bias_lo, bias_hi, kN, tig, Lk);
      }""",
     """      if constexpr (kBias) load_bias<kNb>(bz, bias_lo, bias_hi, 0, tig, Lk);"""),
    ("""        if constexpr (kBias) {
#pragma unroll
          for (int i = 0; i < kNb * 4; ++i) bz[i] = bzn[i];
          load_bias<kNb>(bzn, bias_lo, bias_hi, (t + 1) * kN, tig, Lk);
        }""",
     """        if constexpr (kBias)
          load_bias<kNb>(bz, bias_lo, bias_hi, t * kN, tig, Lk);"""),
]
# name -> text edits of attention_ws.cuh
VARIANTS = {
    "as built": [],
    "128-key tiles without a bias": [("  return kKeys;",
                                      "  return kBias ? 64 : 128;")],
    "6 stages": [("  int s = kMaxStages;", "  int s = 6;")],
    "bias in its own turn": _PREFETCH,
    "one block an item": [("(unsigned)(n_work < sms ? n_work : sms)",
                           "(unsigned)n_work")],
    "an arrival a warp": [
        ("mbar_init(kempty0 + 8 * s, 256);", "mbar_init(kempty0 + 8 * s, 8);"),
        ("mbar_init(vempty0 + 8 * s, 256);", "mbar_init(vempty0 + 8 * s, 8);"),
        ("mbar_init(q_empty, 256);", "mbar_init(q_empty, 8);"),
        ("auto release = [&](uint32_t bar) { mbar_arrive(bar); };",
         "auto release = [&](uint32_t bar) { if (lane == 0) mbar_arrive(bar); };")],
    "unit rescales skipped": [
        ("""#pragma unroll
        for (int i = 0; i < kDn * 4; ++i) o[i] *= alpha[(i >> 1) & 1];""",
         """if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f))
#pragma unroll
          for (int i = 0; i < kDn * 4; ++i) o[i] *= alpha[(i >> 1) & 1];""")],
    "masks in the main loop": [
        ("""          s[i] = __fmul_rn(s[i], scale_log2);
      }""", """          s[i] = __fmul_rn(s[i], scale_log2);
        if (k0 + kN > Lk && k0 + (i >> 2) * 8 + 2 * tig + (i & 1) >= Lk)
          s[i] = -INFINITY;
      }"""),
        ("""      if (k0 + kN > Lk) {  // the last tile
#pragma unroll
        for (int i = 0; i < kNb * 4; ++i)
          if (k0 + (i >> 2) * 8 + 2 * tig + (i & 1) >= Lk) s[i] = -INFINITY;
      }
""", "")],
}

# (name, B, Lq, Lk, H, KV, D, bias): K3 at the main paths' shapes (the
# exact edit's, the A train step's, the M trainer's and the T2I server's
# with their padding biases), D=64 without and with a bias, one key tile a
# row (a block's fixed cost), and B=2 across the batch boundary
CASES = [("edit", 1, 2424, 2424, 32, 32, 128, None),
         ("A-train", 1, 5120, 5120, 32, 32, 128, None),
         ("M-trainer bias", 1, 2565, 2565, 32, 32, 128, "m-trainer"),
         ("T2I-server bias", 4, 1090, 1090, 32, 32, 128, "t2i-server"),
         ("D64", 1, 2424, 2424, 32, 32, 64, None),
         ("D64 bias", 1, 2424, 2424, 32, 32, 64, "pad"),
         ("one key tile", 1, 2424, 128, 32, 32, 128, None),
         ("B2 boundary bias GQA", 2, 1000, 1000, 32, 8, 128, "pad")]


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


def run_variant(root: str, name: str) -> dict:
    """Build (if needed) and time every case with the variant at ``root``."""
    sys.path[:0] = [root, REPO]
    import torch
    import chip_smoke as C
    from mmada_parallel_torch.ops import _cuda
    from mmada_parallel_torch.ops.attention import _xla_attention
    from mmada_parallel_torch.ops.flash_attention import flash_attention
    if not _cuda.__file__.startswith(root):
        raise SystemExit(f"chip_ab: imported {_cuda.__file__}, not {root}")
    path = _cuda.build()
    with open(path[:-3] + ".log") as f:
        entries = C.ptxas_entries(f.read())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"variant": name, "ptxas": {
        f"D={D}{' bias' if b else ''}": v
        for (p, D, b), v in sorted(entries.items()) if p == "fwd"},
        "cases": {}}
    for case, B, Lq, Lk, H, KV, D, kind in CASES:
        bias = None if kind is None else _bias(kind, B, Lk, dev)
        if bias is not None:
            B, Lq, Lk = bias.shape[0], bias.shape[2], bias.shape[3]
        q = torch.randn(B, Lq, H, D, generator=gen, device=dev).bfloat16()
        k, v = (torch.randn(B, Lk, KV, D, generator=gen,
                            device=dev).bfloat16() for _ in range(2))

        def call():
            return flash_attention(q, k, v, bias)

        got, want = call(), _xla_attention(q, k, v, bias)
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
        if case == "edit":           # for the comparison across variants
            torch.save(got.cpu(), os.path.join(root, "edit_out.pt"))
    return out


def main() -> int:
    import chip_smoke as C
    C.phase_device()
    roots = {name: _make(name, edits) for name, edits in VARIANTS.items()}
    # build every variant at once (one nvcc per source each)
    builds = [subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " from mmada_parallel_torch.ops import _cuda; _cuda.build()", root],
        stdout=subprocess.DEVNULL) for root in roots.values()]
    if any([p.wait() for p in builds]):
        raise SystemExit("chip_ab: a variant failed to build")
    names = list(VARIANTS)
    runs = {name: [] for name in names}
    for name in names + names[::-1]:
        res = subprocess.run([sys.executable, __file__, "--run", roots[name],
                              name], capture_output=True, text=True,
                             timeout=300)
        line = [x for x in res.stdout.splitlines() if x.startswith("{")]
        if res.returncode != 0 or not line:
            raise SystemExit(f"chip_ab: {name} failed:\n{res.stdout}\n"
                             f"{res.stderr[-4000:]}")
        runs[name].append(json.loads(line[-1]))
        print(f"[ab] {line[-1]}", flush=True)
    import torch
    base = torch.load(os.path.join(roots[names[0]], "edit_out.pt"))
    for name in names:
        out = torch.load(os.path.join(roots[name], "edit_out.pt"))
        print(f"[ab] {name}: at the edit shape {int((out != base).sum())} of "
              f"{base.numel()} outputs differ from {names[0]!r}'s; ptxas "
              f"{runs[name][0]['ptxas']}")
        for case in runs[name][0]["cases"]:
            us = [r["cases"][case]["device_us"] for r in runs[name]]
            print(f"[ab]   {case}: device us {us} (median "
                  f"{statistics.median(us):.1f})", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        print(json.dumps(run_variant(sys.argv[2], sys.argv[3])), flush=True)
    else:
        sys.exit(main())
