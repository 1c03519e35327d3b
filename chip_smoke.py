"""On-card proof that the PyTorch/CUDA port builds, is right and runs its
paths: the variant-A thinking-aware edit (exact and feature-cached) and the
variant-M interleave generation (exact and feature-cached).

    python3 chip_smoke.py        # from the repository root, one H100

Phases (each prints its own lines; any failure exits non-zero):

0. device: the card's name and power limit, torch/CUDA versions, TF32 off;
1. build: one ``nvcc`` per ``mmada_parallel_torch/csrc/*.cu`` for sm_90a,
   all at once, then one link;
2. the three attention kernels against their plain PyTorch versions on the
   card, timed with CUDA events against them: K1 fused RoPE at the edit's
   shapes, K2 q-only RoPE at the cached samplers' partial and full shapes,
   K3 BLHD at the edit shape, and each at small f32 shapes;
3. small f32 models (head_dim 64): the kernel path gives the same tokens as
   the plain attention at temperature 0 on the exact edit, the cached edit,
   the exact and cached interleave, and the exact edit with bf16-style
   (non-fp32) RoPE, which runs K3;
4. at the full width of the 8B backbone (all 32 layers, one set of random
   bf16 weights from a seed) with the full-size tokenizers: the exact edit
   (K1), the exact edit with non-fp32 RoPE (K3), the cached edit (K2 and
   K1), the exact interleave (K1) and the cached interleave (K2).  Each run
   sets every launch count to 0 just before it and checks them just after;
   codes, pixels, wall time and peak memory are checked and printed.

The second-to-last line of stdout is a JSON object with the kernels'
records; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside the repository, the script fails and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CSRC = "mmada_parallel_torch/csrc/"
KERNELS = {          # name -> (source, TPU kernel it replaces)
    "flash_attention_rope": (
        CSRC + "flash_attention_rope.cu",
        "mmada_parallel_tpu/ops/rope_attention.py:160"),
    "flash_attention_rope_qonly": (
        CSRC + "flash_attention_rope_qonly.cu",
        "mmada_parallel_tpu/ops/rope_attention.py:200"),
    "flash_attention": (
        CSRC + "flash_attention.cu",
        "mmada_parallel_tpu/ops/flash_attention.py:85"),
}

# tolerances of the kernels against their plain versions on the card
# bf16: both sides round the rotated q/k to bf16 identically, but p is
# rounded to bf16 at different points (unnormalised per key tile in the
# kernel, normalised in the plain softmax) and the output is rounded to bf16;
# that is a few bf16 ulps (2^-8 relative) on outputs of magnitude < 1.
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
# f32: the same arithmetic up to summation order (online softmax over key
# tiles against one-pass softmax, FMA order in the dot products) and expf's
# last-bit error.
F32_TOL = dict(atol=1e-4, rtol=1e-4)

EDIT_L, EDIT_H, EDIT_D = 2424, 32, 128


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())             # name, power limit: on a line alone
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from mmada_parallel_torch.ops import _cuda
    t0 = time.time()
    path = _cuda.build()
    _cuda.library()
    log(f"[build] {os.path.relpath(path, REPO)} in "
        f"{time.time() - t0:.1f} s ({len(_cuda._sources())} sources, nvcc "
        f"-gencode arch=compute_90a,code=sm_90a)")
    with open(path[:-3] + ".log") as f:
        for line in f:
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------


def _launch_counters():
    from mmada_parallel_torch.ops.flash_attention import flash_attention
    from mmada_parallel_torch.ops.rope_attention import (
        flash_attention_rope, flash_attention_rope_qonly)
    return {"flash_attention_rope": flash_attention_rope,
            "flash_attention_rope_qonly": flash_attention_rope_qonly,
            "flash_attention": flash_attention}


def reset_launches() -> None:
    for fn in _launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _launch_counters().items()}


def check_launches(phase: str, expected: dict) -> dict:
    """The counts since the last reset must equal ``expected`` (kernels not
    named there must not have launched)."""
    got = read_launches()
    want = {name: expected.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"{phase}: kernel launches {got}, expected "
                             f"{want}")
    return got


def _compare(name: str, desc: str, kernel, plain, tol, timed: bool):
    """Kernel vs plain on one input; returns (max_abs_err, ms, plain_ms)."""
    import torch
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs()
    bound = tol["atol"] + tol["rtol"] * want.float().abs()
    max_err = float(err.max())
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version, max |err| {max_err:.3e} ({tol})")
    ms = plain_ms = None
    if timed:
        ms = time_ms(kernel)
        plain_ms = time_ms(plain)
    times = (f" kernel {ms:.3f} ms plain {plain_ms:.3f} ms" if timed else "")
    log(f"[kernel] {name}: {desc} max|err| {max_err:.3e} tol {tol}{times}")
    return max_err, ms, plain_ms


def _rope_tables(L: int, D: int, device):
    from mmada_parallel_torch.models.llada import _rope_sin_cos
    return _rope_sin_cos(L, D, 500000.0, device)


def _pad_bias(lengths, Lq: int, Lk: int, device):
    """f32 [B, 1, Lq, Lk] padding bias: row b's first lengths[b] keys (and
    queries) are real, the rest -1e30."""
    import torch
    mq = torch.arange(Lq, device=device)[None] < torch.tensor(
        lengths, device=device)[:, None]
    mk = torch.arange(Lk, device=device)[None] < torch.tensor(
        lengths, device=device)[:, None]
    pair = mq[:, :, None] & mk[:, None, :]
    return torch.where(pair[:, None], 0.0, -1e30).to(torch.float32)


def _kernel_case(name, B, Lq, Lk, H, KV, D, dtype, tol, gen, *,
                 bias=None, per_row_pos=None, timed=False):
    """K1 vs plain on one shape; returns (max_abs_err, ms, plain_ms)."""
    import torch
    from mmada_parallel_torch.ops.rope_attention import (
        flash_attention_rope, flash_attention_rope_reference)
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, H * D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Lk, KV * D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Lk, KV * D, generator=gen, device=dev).to(dtype)
    sin, cos = _rope_tables(max(Lq, Lk), D, dev)
    if per_row_pos is not None:
        sin, cos = sin[per_row_pos].contiguous(), cos[per_row_pos].contiguous()
    kw = dict(n_heads=H, n_kv_heads=KV)
    desc = (f"B={B} Lq={Lq} Lk={Lk} H={H} KV={KV} D={D} "
            f"{str(dtype).split('.')[-1]}")
    return _compare(
        f"K1 {name}", desc,
        lambda: flash_attention_rope(q, k, v, sin, cos, bias, **kw),
        lambda: flash_attention_rope_reference(q, k, v, sin, cos, bias,
                                               **kw), tol, timed)


def phase_kernel() -> dict:
    """K1 against its plain version at the edit shapes; returns the
    record's measured fields (B=1 edit shape timings: the cond forward)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    L, H, D = EDIT_L, EDIT_H, EDIT_D
    errs = []
    # (a) the solo edit: shared tables, no bias, B=1 (cond) and B=2 (uncond)
    e, ms, plain_ms = _kernel_case("a/B1", 1, L, L, H, H, D, bf16, BF16_TOL,
                                   gen, timed=True)
    errs.append(e)
    e, ms2, plain_ms2 = _kernel_case("a/B2", 2, L, L, H, H, D, bf16,
                                     BF16_TOL, gen, timed=True)
    errs.append(e)
    # (b) ragged batch: rows padded from 2000 and 1500, per-row positions
    # cumsum(mask)-1, and one real row fully masked
    dev = torch.device("cuda")
    mask = torch.zeros(2, L, dtype=torch.bool, device=dev)
    mask[0, :2000] = True
    mask[1, :1500] = True
    pos = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
    pair = mask[:, :, None] & mask[:, None, :]
    bias = torch.where(pair[:, None], 0.0, -1e30).to(f32)
    bias[1, 0, 100, :] = -1e30
    e, _, _ = _kernel_case("b/bias", 2, L, L, H, H, D, bf16, BF16_TOL, gen,
                           bias=bias.contiguous(), per_row_pos=pos)
    errs.append(e)
    # (c) GQA 32/8
    e, _, _ = _kernel_case("c/gqa", 1, L, L, H, 8, D, bf16, BF16_TOL, gen)
    errs.append(e)
    # (d) f32 at small shapes: GQA + bias + per-row tables at D=128, and
    # Lq != Lk from one shared table at D=64
    m2 = torch.ones(2, 300, dtype=torch.bool, device=dev)
    m2[1, 250:] = False
    pos2 = (torch.cumsum(m2.long(), dim=1) - 1).clamp_min(0)
    b2 = torch.where((m2[:, :, None] & m2[:, None, :])[:, None], 0.0,
                     -1e30).to(f32).contiguous()
    _kernel_case("d/f32", 2, 300, 300, 4, 2, 128, f32, F32_TOL, gen,
                 bias=b2, per_row_pos=pos2)
    _kernel_case("d/f32-D64", 1, 100, 260, 4, 4, 64, f32, F32_TOL, gen)
    log(f"[kernel] K1 edit shape B=1: kernel {ms:.3f} ms plain "
        f"{plain_ms:.3f} ms; B=2: kernel {ms2:.3f} ms plain "
        f"{plain_ms2:.3f} ms")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def _qonly_case(name, B, Lq, Lk, H, KV, D, dtype, tol, gen, *,
                per_row=True, bias=None, timed=False):
    """K2 vs plain: q at Lq sorted distinct positions of an Lk sequence
    (per-row tables) or at positions 0..Lq-1 (shared), pre-rotated k."""
    import torch
    from mmada_parallel_torch.ops.rope_attention import (
        flash_attention_rope_qonly, flash_attention_rope_qonly_reference)
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, H * D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Lk, KV * D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Lk, KV * D, generator=gen, device=dev).to(dtype)
    sin, cos = _rope_tables(Lk, D, dev)
    if per_row:
        pos = torch.stack([torch.randperm(Lk, generator=gen, device=dev)[:Lq]
                           for _ in range(B)]).sort(dim=1).values
        sin, cos = sin[pos].contiguous(), cos[pos].contiguous()
    else:
        sin, cos = sin[:Lq].contiguous(), cos[:Lq].contiguous()
    kw = dict(n_heads=H, n_kv_heads=KV)
    desc = (f"B={B} Lq={Lq} Lk={Lk} H={H} KV={KV} D={D} "
            f"{str(dtype).split('.')[-1]} "
            f"{'per-row' if per_row else 'shared'} tables"
            f"{' bias' if bias is not None else ''}")
    return _compare(
        f"K2 {name}", desc,
        lambda: flash_attention_rope_qonly(q, k, v, sin, cos, bias, **kw),
        lambda: flash_attention_rope_qonly_reference(q, k, v, sin, cos,
                                                     bias, **kw), tol, timed)


def _m_sequence_length() -> int:
    """Length of the M sequence the full-width interleave builds (1024 image
    tokens, 256 text slots, a 51-id instruction)."""
    from mmada_parallel_tpu import tokens as tk
    T = tk.TOKENS_M
    instr = tk.normalize_text_ids(StandInTokenizer()("x")["input_ids"],
                                  T.bos, T.eos)
    prompt = [T.interleave, T.soi] + [T.vq_offset] * 1024 + [T.eoi] + instr
    return tk.assemble_interleave_sequence(prompt, 1024, 256, T)[1].total_len


def phase_kernel_qonly() -> dict:
    """K2 against its plain version at the cached samplers' shapes."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    L, H, D = EDIT_L, EDIT_H, EDIT_D
    Lm = _m_sequence_length()
    errs = []
    # (a) the A partial step at the reference settings: 3 + 13 = 16 slots
    e, ms_a, plain_a = _qonly_case("a/A-partial", 1, 16, L, H, H, D, bf16,
                                   BF16_TOL, gen, timed=True)
    errs.append(e)
    # (b) the A full step with the cache: Lq = Lk, shared tables
    e, ms_b, plain_b = _qonly_case("b/A-full", 1, L, L, H, H, D, bf16,
                                   BF16_TOL, gen, per_row=False, timed=True)
    errs.append(e)
    # (c) the M partial step: 256 text + 52 image slots, cond + uncond rows
    e, ms_c, plain_c = _qonly_case("c/M-partial", 2, 256 + 52, Lm, H, H, D,
                                   bf16, BF16_TOL, gen, timed=True)
    errs.append(e)
    # (d) GQA 32/8 with a padding bias (rows keep 2360 and 1800 keys)
    dev = torch.device("cuda")
    bias = _pad_bias([Lm, 1800], 308, Lm, dev)
    e, _, _ = _qonly_case("d/gqa-bias", 2, 308, Lm, H, 8, D, bf16, BF16_TOL,
                          gen, bias=bias.contiguous())
    errs.append(e)
    # (e) f32 at small shapes, D=128 and D=64
    _qonly_case("e/f32", 2, 40, 300, 4, 2, 128, f32, F32_TOL, gen,
                bias=_pad_bias([300, 250], 40, 300, dev).contiguous())
    _qonly_case("e/f32-D64", 1, 100, 260, 4, 4, 64, f32, F32_TOL, gen)
    return {"max_abs_err": max(errs), "ms": ms_b, "plain_ms": plain_b}


def _blhd_case(name, B, Lq, Lk, H, KV, D, dtype, tol, gen, *, bias=None,
               timed=False):
    """K3 vs plain (``_xla_attention``) on BLHD inputs."""
    import torch
    from mmada_parallel_torch.ops.attention import _xla_attention
    from mmada_parallel_torch.ops.flash_attention import flash_attention
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Lk, KV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Lk, KV, D, generator=gen, device=dev).to(dtype)
    desc = (f"B={B} Lq={Lq} Lk={Lk} H={H} KV={KV} D={D} "
            f"{str(dtype).split('.')[-1]}"
            f"{' bias' if bias is not None else ''}")
    return _compare(f"K3 {name}", desc,
                    lambda: flash_attention(q, k, v, bias),
                    lambda: _xla_attention(q, k, v, bias), tol, timed)


def phase_kernel_blhd() -> dict:
    """K3 against its plain version at the BLHD edit shape."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    L, H, D = EDIT_L, EDIT_H, EDIT_D
    dev = torch.device("cuda")
    errs = []
    e, ms, plain_ms = _blhd_case("a/B1", 1, L, L, H, H, D, bf16, BF16_TOL,
                                 gen, timed=True)
    errs.append(e)
    e, _, _ = _blhd_case("a/B2", 2, L, L, H, H, D, bf16, BF16_TOL, gen,
                         timed=True)
    errs.append(e)
    # padding bias (rows of 2000 and 1500) and one real row fully masked
    bias = _pad_bias([2000, 1500], L, L, dev)
    bias[1, 0, 100, :] = -1e30
    e, _, _ = _blhd_case("b/bias", 2, L, L, H, H, D, bf16, BF16_TOL, gen,
                         bias=bias.contiguous())
    errs.append(e)
    e, _, _ = _blhd_case("c/gqa", 1, L, L, H, 8, D, bf16, BF16_TOL, gen)
    errs.append(e)
    _blhd_case("d/f32", 2, 300, 300, 4, 2, 128, f32, F32_TOL, gen,
               bias=_pad_bias([300, 250], 300, 300, dev).contiguous())
    _blhd_case("d/f32-D64", 1, 100, 260, 4, 4, 64, f32, F32_TOL, gen)
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# Small models: kernel path == plain attention, token for token
# ---------------------------------------------------------------------------


class StandInTokenizer:
    """Fixed-length ids from the characters of the text: every prompt comes
    out at 50 ids, so the 512x512 edit's sequence is 2424 tokens long, the
    length of the TPU bench's edit sequence.  ``</answer>`` is one id."""

    def __call__(self, text, add_special_tokens=True):
        from mmada_parallel_tpu import tokens as tk
        if not add_special_tokens:
            return {"input_ids": [tk.TOKENS_A.answer_end]}
        body = [1000 + ord(c) % 1000 for c in text][:48]
        body += [1000] * (48 - len(body))
        return {"input_ids": [126080] + body + [126081]}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))


def _edit_image(size: int):
    """A seeded uint8 RGB test image (gradient plus noise), no PIL."""
    import numpy as np
    rng = np.random.default_rng(0)
    ramp = np.linspace(0, 255, size)
    img = np.stack([ramp[None, :].repeat(size, 0),
                    ramp[:, None].repeat(size, 1),
                    np.full((size, size), 128.0)], axis=-1)
    img = img + rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _small_llada(gen, vocab_size: int, **overrides):
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    cfg = LLaDAConfig.tiny(d_model=128, n_heads=2, n_kv_heads=1,
                           vocab_size=vocab_size, **overrides)
    return cfg, init_llada_params(cfg, gen)


def _token_exact(name: str, run, kernels) -> None:
    """``run(impl) -> (text, info)`` under ``auto`` (kernels) and ``xla``
    (plain): the ids, codes and text must be equal, and the named kernels
    must have launched under ``auto`` only."""
    import numpy as np
    outs = []
    for impl in ("auto", "xla"):
        reset_launches()
        outs.append(run(impl))
        counts = read_launches()
        if impl == "auto" and not all(counts[k] > 0 for k in kernels):
            raise AssertionError(f"{name}: kernels {kernels} did not launch "
                                 f"({counts})")
        if impl == "xla" and any(counts.values()):
            raise AssertionError(f"{name}: the plain path launched kernels "
                                 f"({counts})")
    (text_k, info_k), (text_p, info_p) = outs
    if not (np.array_equal(info_k["ids"], info_p["ids"])
            and np.array_equal(info_k["codes"], info_p["codes"])
            and text_k == text_p):
        raise AssertionError(f"{name}: kernel path and plain attention gave "
                             f"different tokens at temperature 0")
    log(f"[slice-small] {name}, {info_k['ids'].shape[1]} tokens: kernel "
        f"path ({', '.join(kernels)}) == plain attention, token-exact at "
        f"temperature 0")


def phase_small_slice() -> None:
    """The slice on small f32 models (head_dim 64): the kernel paths must
    give the same tokens as the plain attention at temperature 0."""
    import dataclasses
    import torch
    from mmada_parallel_tpu import tokens as tk
    from mmada_parallel_torch.models import amused_vq as AVQ
    from mmada_parallel_torch.models import magvit2 as MVQ
    from mmada_parallel_torch.pipeline import (InterleavePipeline,
                                               TI2TIPipeline)
    from mmada_parallel_torch.samplers.interleave import InterleaveOptions
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg, params = _small_llada(gen, tk.TOKENS_A.full_vocab_size)
    vcfg = AVQ.AmusedVQConfig.tiny()
    vparams = AVQ.init_amused_vq_params(vcfg, gen)
    opts = TI2TIOptions(text_steps=8, timesteps=4, temperature=0.0,
                        text_temperature=0.0, cfg_scale=2.5, cfg_img=4.0,
                        codebook_size=vcfg.num_vq_embeddings)

    def edit(c, use_cache=False, text_steps=8):
        pipe = TI2TIPipeline(c, params, vcfg, vparams, StandInTokenizer())
        o = dataclasses.replace(opts, text_steps=text_steps)
        return pipe("make the sky purple", _edit_image(32), 32, 32, o,
                    text_gen_length=16, seed=3, use_cache=use_cache)[1:]

    def impl_cfg(c, impl):
        return dataclasses.replace(c, attention_impl=impl)

    _token_exact("exact edit f32 head_dim 64",
                 lambda impl: edit(impl_cfg(cfg, impl)),
                 ["flash_attention_rope"])
    # (i) the cached edit: 16 steps, of which 6, 7, 10, 13, 14 are partial
    _token_exact("cached edit",
                 lambda impl: edit(impl_cfg(cfg, impl), True, 16),
                 ["flash_attention_rope_qonly", "flash_attention_rope"])
    # (iv) the exact edit with non-fp32 RoPE: K3 behind dot_product_attention
    lo = dataclasses.replace(cfg, rope_full_precision=False)
    _token_exact("exact edit, rope_full_precision=False",
                 lambda impl: edit(impl_cfg(lo, impl)), ["flash_attention"])

    mcfg, mparams = _small_llada(gen, tk.TOKENS_M.full_vocab_size)
    mvcfg = MVQ.MagvitConfig.tiny()
    mvparams = MVQ.init_magvit_params(mvcfg, gen)
    mopts = InterleaveOptions(text_steps=16, image_steps=4,
                              image_temperature=0.0,
                              codebook_size=mvcfg.codebook_size)

    def interleave(c, use_cache):
        pipe = InterleavePipeline(c, mparams, mvcfg, mvparams,
                                  StandInTokenizer(), num_vq_tokens=256,
                                  max_seq_length=16, resolution=32)
        return pipe("make the sky purple", _edit_image(32), mopts, seed=3,
                    use_cache=use_cache)[1:]

    # (ii) exact and (iii) cached interleave (partial steps 6, 7, 10, 13, 14)
    _token_exact("exact interleave",
                 lambda impl: interleave(impl_cfg(mcfg, impl), False),
                 ["flash_attention_rope"])
    _token_exact("cached interleave",
                 lambda impl: interleave(impl_cfg(mcfg, impl), True),
                 ["flash_attention_rope_qonly"])


# ---------------------------------------------------------------------------
# Full width
# ---------------------------------------------------------------------------


def make_full_width(gen) -> dict:
    """One set of random bf16 8B weights (all 32 layers; A and M share the
    backbone shape) and the full-size tokenizers (f32)."""
    import torch
    from mmada_parallel_torch.models import amused_vq as AVQ
    from mmada_parallel_torch.models import magvit2 as MVQ
    from mmada_parallel_torch.models.llada import (LLaDAConfig, count_params,
                                                   init_llada_params)
    cfg = LLaDAConfig.llada_8b(param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    t0 = time.time()
    params = init_llada_params(cfg, gen)
    vcfg, mcfg = AVQ.AmusedVQConfig(), MVQ.MagvitConfig()
    vparams = AVQ.init_amused_vq_params(vcfg, gen)
    mparams = MVQ.init_magvit_params(mcfg, gen)
    torch.cuda.synchronize()
    log(f"[full] LLaDA-8B width, {cfg.n_layers} layers, "
        f"{count_params(params) / 1e9:.3f} B params bf16 + Amused-VQ "
        f"{count_params(vparams) / 1e6:.1f} M f32 + MagViT-v2 "
        f"{count_params(mparams) / 1e6:.1f} M f32, random from seed 0, "
        f"made on the card in {time.time() - t0:.1f} s")
    return {"cfg": cfg, "params": params, "vcfg": vcfg, "vparams": vparams,
            "mcfg": mcfg, "mparams": mparams}


def _check_image(phase, codes, px, n_codes=1024):
    import numpy as np
    if codes.shape != (1, n_codes) or codes.min() < 0 or codes.max() >= 8192:
        raise AssertionError(f"{phase}: codes out of range or shape "
                             f"{codes.shape}")
    if px.shape != (512, 512, 3) or not np.isfinite(px).all() \
            or px.min() < 0 or px.max() > 1:
        raise AssertionError(f"{phase}: pixels not finite [512,512,3] in "
                             f"[0,1]")


def _timed_run(fn):
    """``fn()`` with every launch count at 0 before it, timed on the host
    clock up to a synchronize; returns (result, wall s, peak bytes)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0, torch.cuda.max_memory_allocated()


def _a_pipe(full, cfg=None):
    from mmada_parallel_torch.pipeline import TI2TIPipeline
    return TI2TIPipeline(cfg or full["cfg"], full["params"], full["vcfg"],
                         full["vparams"], StandInTokenizer())


def phase_edit(full) -> int:
    """One 512x512 exact edit at the full width of the 8B backbone; returns
    K1's launch count during the edit."""
    from mmada_parallel_torch.ops import sampling as S
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    cfg = full["cfg"]
    opts = TI2TIOptions(text_steps=16, timesteps=8, temperature=1.0,
                        text_temperature=0.7, cfg_scale=2.5, cfg_img=4.0)
    n_img = int(S.image_step_mask(opts.text_steps, opts.timesteps).sum())
    (_, text, info), wall, peak = _timed_run(lambda: _a_pipe(full)(
        "make the sky purple", _edit_image(512), 512, 512, opts,
        text_gen_length=256, seed=1))
    expected = cfg.n_layers * (opts.text_steps + n_img)
    launches = check_launches("edit", {"flash_attention_rope": expected})
    _check_image("edit", info["codes"], info["pixels"])
    forwards = opts.text_steps + n_img
    codes = info["codes"]
    log(f"[edit] 512x512, seq {info['layout'].total_len}, text_steps "
        f"{opts.text_steps}, image steps {n_img}, cfg_scale {opts.cfg_scale} "
        f"cfg_img {opts.cfg_img}: {len(text.split())} text tokens, codes in "
        f"[{codes.min()}, {codes.max()}]")
    log(f"[edit] wall {wall:.2f} s (sampler {info['elapsed']:.2f} s), "
        f"{forwards} forwards ({opts.text_steps} cond B=1 + {n_img} uncond "
        f"B=2) = {forwards / info['elapsed']:.2f} forwards/s, kernel "
        f"launches {launches}, peak memory {peak / 2 ** 30:.2f} GiB")
    return launches["flash_attention_rope"]


def phase_edit_lowprec_rope(full) -> int:
    """The exact edit with ``rope_full_precision=False``: RoPE in bf16, then
    the BLHD kernel K3 in every layer; returns K3's launch count."""
    import dataclasses
    from mmada_parallel_torch.ops import sampling as S
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    cfg = dataclasses.replace(full["cfg"], rope_full_precision=False)
    opts = TI2TIOptions(text_steps=8, timesteps=4, temperature=1.0,
                        text_temperature=0.7, cfg_scale=2.5, cfg_img=4.0)
    n_img = int(S.image_step_mask(opts.text_steps, opts.timesteps).sum())
    (_, text, info), wall, peak = _timed_run(lambda: _a_pipe(full, cfg)(
        "make the sky purple", _edit_image(512), 512, 512, opts,
        text_gen_length=256, seed=1))
    expected = cfg.n_layers * (opts.text_steps + n_img)
    launches = check_launches("edit-bf16-rope", {"flash_attention": expected})
    _check_image("edit-bf16-rope", info["codes"], info["pixels"])
    log(f"[edit-bf16-rope] 512x512, rope_full_precision=False, text_steps "
        f"{opts.text_steps}, image steps {n_img}: wall {wall:.2f} s (sampler "
        f"{info['elapsed']:.2f} s), {opts.text_steps + n_img} forwards, "
        f"kernel launches {launches}, peak memory {peak / 2 ** 30:.2f} GiB")
    return launches["flash_attention"]


def phase_cached_edit(full) -> int:
    """One 512x512 edit through the cached sampler at full width; returns
    K2's launch count."""
    from mmada_parallel_torch.ops import sampling as S
    from mmada_parallel_torch.samplers.parallel_ti2ti import (
        TI2TIOptions, cached_refresh_schedule)
    cfg = full["cfg"]
    opts = TI2TIOptions(text_steps=32, timesteps=4, temperature=1.0,
                        text_temperature=0.7, cfg_scale=2.5, cfg_img=4.0)
    n_img = int(S.image_step_mask(opts.text_steps, opts.timesteps).sum())
    n_partial = int((~cached_refresh_schedule(opts.text_steps,
                                              opts.timesteps)).sum())
    if n_partial < 1:
        raise AssertionError("cached edit: the schedule has no partial step")
    (_, text, info), wall, peak = _timed_run(lambda: _a_pipe(full)(
        "make the sky purple", _edit_image(512), 512, 512, opts,
        text_gen_length=256, seed=1, use_cache=True))
    launches = check_launches("cached-edit", {
        "flash_attention_rope_qonly": cfg.n_layers * opts.text_steps,
        "flash_attention_rope": cfg.n_layers * n_img})
    _check_image("cached-edit", info["codes"], info["pixels"])
    forwards = opts.text_steps + n_img
    log(f"[cached-edit] 512x512, seq {info['layout'].total_len}, text_steps "
        f"{opts.text_steps} ({opts.text_steps - n_partial} full + "
        f"{n_partial} partial), image steps {n_img}: "
        f"{len(text.split())} text tokens")
    log(f"[cached-edit] wall {wall:.2f} s (sampler {info['elapsed']:.2f} s),"
        f" {forwards} forwards ({opts.text_steps} cond B=1 of which "
        f"{n_partial} partial + {n_img} uncond B=2) = "
        f"{forwards / info['elapsed']:.2f} forwards/s, kernel launches "
        f"{launches}, peak memory {peak / 2 ** 30:.2f} GiB")
    return launches["flash_attention_rope_qonly"]


def _interleave(full, use_cache: bool):
    from mmada_parallel_torch.pipeline import InterleavePipeline
    from mmada_parallel_torch.samplers.interleave import InterleaveOptions
    opts = InterleaveOptions(text_steps=16, image_steps=4)
    pipe = InterleavePipeline(full["cfg"], full["params"], full["mcfg"],
                              full["mparams"], StandInTokenizer(),
                              num_vq_tokens=1024, max_seq_length=256,
                              resolution=512)
    out, wall, peak = _timed_run(lambda: pipe(
        "make the sky purple", _edit_image(512), opts, seed=1,
        use_cache=use_cache))
    return opts, out, wall, peak


def phase_interleave(full) -> int:
    """The exact M interleave at full width; returns K1's launch count."""
    cfg = full["cfg"]
    opts, (_, text, info), wall, peak = _interleave(full, False)
    launches = check_launches("interleave", {
        "flash_attention_rope": cfg.n_layers * opts.text_steps})
    _check_image("interleave", info["codes"], info["pixels"])
    log(f"[interleave] 512x512, seq {info['layout'].total_len}, text_steps "
        f"{opts.text_steps}, image steps {opts.image_steps}, B=2 (cond + "
        f"uncond) per step: {len(text.split())} text tokens, codes in "
        f"[{info['codes'].min()}, {info['codes'].max()}]; wall {wall:.2f} s "
        f"(sampler {info['elapsed']:.2f} s), "
        f"{opts.text_steps / info['elapsed']:.2f} forwards/s, kernel "
        f"launches {launches}, peak memory {peak / 2 ** 30:.2f} GiB")
    return launches["flash_attention_rope"]


def phase_cached_interleave(full) -> int:
    """The cached M interleave at full width; returns K2's launch count."""
    from mmada_parallel_torch.samplers.interleave import (
        interleave_refresh_schedule)
    cfg = full["cfg"]
    opts, (_, text, info), wall, peak = _interleave(full, True)
    n_partial = int((~interleave_refresh_schedule(
        opts.text_steps, opts.image_steps)).sum())
    if n_partial < 1:
        raise AssertionError("cached interleave: no partial step")
    launches = check_launches("cached-interleave", {
        "flash_attention_rope_qonly": cfg.n_layers * opts.text_steps})
    _check_image("cached-interleave", info["codes"], info["pixels"])
    log(f"[cached-interleave] 512x512, seq {info['layout'].total_len}, "
        f"text_steps {opts.text_steps} ({opts.text_steps - n_partial} full "
        f"+ {n_partial} partial), image steps {opts.image_steps}: "
        f"{len(text.split())} text tokens; wall {wall:.2f} s (sampler "
        f"{info['elapsed']:.2f} s), "
        f"{opts.text_steps / info['elapsed']:.2f} forwards/s, kernel "
        f"launches {launches}, peak memory {peak / 2 ** 30:.2f} GiB")
    return launches["flash_attention_rope_qonly"]


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    device = phase_device()
    phase_build()
    records = {"flash_attention_rope": phase_kernel(),
               "flash_attention_rope_qonly": phase_kernel_qonly(),
               "flash_attention": phase_kernel_blhd()}
    phase_small_slice()
    full = make_full_width(torch.Generator(device="cuda").manual_seed(0))
    launches = {"flash_attention_rope": phase_edit(full),
                "flash_attention": phase_edit_lowprec_rope(full),
                "flash_attention_rope_qonly": phase_cached_edit(full)}
    phase_interleave(full)
    phase_cached_interleave(full)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                **records[name]}
               for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
