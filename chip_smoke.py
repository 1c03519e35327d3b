"""On-card proof that the PyTorch/CUDA port builds, is right and runs its
paths: the variant-A thinking-aware edit (exact and feature-cached), the
variant-M interleave generation (exact and feature-cached), text-to-image
(A exact and cached, M), understanding, the streaming demo, the four
servers, the ParaBench evaluation sweeps, the W8A8 int8 edit, the A and M
train steps, the variant-M SFT trainer (``cli/train_m.py``) with its data
layer, and ParaRL, with gradients through the attention kernels.

    python3 chip_smoke.py        # from the repository root, one H100

Phases (each prints its own lines; any failure exits non-zero):

0. device: the card's name and power limit, torch/CUDA versions, TF32 off;
1. build: one ``nvcc`` per ``mmada_parallel_torch/csrc/*.cu`` for sm_90a,
   all at once, then one link;
2. the four attention kernels against their plain PyTorch versions on the
   card, timed with CUDA events against them and against their bound (the
   larger of FLOPs over the 989 TFLOP/s bf16 peak and bytes over 3.35 TB/s):
   K1's bf16 rotation pre-pass bitwise against ``rope_tensor``; K1 fused
   RoPE at the edit's shapes (bf16: pre-pass + the tensor-core body), K2
   q-only RoPE at the cached samplers' partial and full shapes (bf16:
   pre-pass + the tensor-core body, split-K with its combine kernel where
   the planner splits; each case prints its split count), K3 BLHD at the
   edit shape (bf16: the tensor-core body) with one
   ``scaled_dot_product_attention`` call beside it as the library yardstick,
   K4 prefix bounds at the A-train shape and a mixed task batch (bf16:
   pre-pass + the tensor-core body with the bounds; with K1 on the
   equivalent dense bias beside it at 2424 and 5120, the crossover
   ``rope_attention_prefix``'s ``auto`` would want, and ``auto``'s choice at
   both lengths checked by launch counts), each at small f32 shapes, every
   kernel at the tensor-core body's bf16 edges (D=64, ragged Lq/Lk, GQA,
   fully masked rows, per-row tables, odd Lk with a bias, forced splits,
   bounds 0 and past Lk), and K1 at the A and M train steps' shapes and at
   the M trainer's (B=1, L=2565, the key-padding bias of an interleave
   row); SDPA
   on pre-rotated inputs beside K2 and K4 as a yardstick for their
   attention part (not the same function: no rotation); the device kernel
   names of one K2 and one K4 bf16 call (the tensor-core body, not the FMA
   template); then each kernel's autograd Function: q/k/v gradients
   against plain autograd, bf16 and f32;
   K1 and K2 also at the text-to-image and understanding servers' shapes
   (the T2I server's left-padded B=4 batch, the MMU server's right-padded
   B=2 batch with re-ranked positions, the cached A T2I partial step);
3. small f32 models (head_dim 64): the kernel path gives the same tokens as
   the plain attention at temperature 0 on the exact edit, the cached edit,
   the exact and cached interleave, the exact edit with bf16-style
   (non-fp32) RoPE, which runs K3, and the A text-to-image (exact and
   cached); each server's ragged batch (TI2TI, interleave, T2I with its
   padding masks, MMU ragged) gives the plain attention's rows and each row
   its unpadded solo run's tokens; three A train steps through the
   kernel path equal the plain path's; the ParaBench edit sweep (two
   buckets, a short last chunk) and the cached interleave sweep row for
   row, the W8A8 edit token for token, and three ParaRL updates on one
   recorded trajectory (loss and gradient norm) equal the plain path's;
   three steps of the M trainer's loop (``train_m.train_loop``, 2
   microbatches) equal the plain path's (losses and gradient norm), a
   checkpoint saved and restored into other weights gives the straight
   run's next step, and ``_validate_chat`` and ``_validate`` write their
   jsonl and PNG with exact K1 counts; the M trainer's readers: the native
   tar reader (built with ``g++``) against ``tarfile`` on a shard written
   here, both timed, and the token store gathered back bit for bit;
4. at the full width of the 8B backbone (all 32 layers, one set of random
   bf16 weights from a seed) with the full-size tokenizers: the exact edit
   (K1), the exact edit with non-fp32 RoPE (K3), the cached edit (K2 and
   K1), the exact interleave (K1) and the cached interleave (K2); the vocab
   head with bf16 operands and an f32 result against the f32 upcast at the
   MMU and T2I head shapes; the VQ codes of one image with TF32 on and off
   and the pipelines' encoders held to the TF32-off codes; the A
   text-to-image (K1) and its cached sampler (K2), the M text-to-image
   server (K1 with the bias), the MMU server and ``mmu_generate_fast``, the
   streaming demo on the A edit, and the A and M (exact and cached) servers
   with two requests from two threads; ``run_parabench_sweep`` on 4
   synthetic edit requests (two buckets, ``batch_size=2``, PSNR/SSIM
   through the Amused-VQ decode), the cached interleave sweep, and the
   exact edit on bf16, int8 and int8-bf16head params (s/request, the codes
   and text equal to bf16, one int8 run profiled with the int8 GEMMs and
   the activation quantization apart).  Each run sets every launch count to
   0 just before it and checks them just after; codes, pixels, wall time
   and peak memory are checked and printed; the exact and the cached edit
   and the cached A text-to-image run once more under ``torch.profiler``
   (device time by kernel class, idle share);
5. training at full width, 4 of the 32 layers (f32 params, bf16 compute,
   AdamW, clip 4.0), after the inference weights are freed: the A SFT step
   of ``cli/train_a.py`` (B=1, L=5120, 2 accumulation microbatches, remat
   ``whole_layer``: exactly 16 K1 launches, loss and grad norm against the
   plain attention path, 3 finite steps of each, and 3 more with the vocab
   head's old f32 upcast for its before and after) and the M
   ``forward_process`` step on a padded ``[t2i | lm | mmu]`` batch at the
   interleave length, with seconds per step, tokens per second and peak
   memory; one more step of each (A plain, A K1, M) under ``torch.profiler``
   gives the device time by kernel class and the idle share; then the
   variant-M SFT trainer (``cli/train_m.py``'s ``build_train_step``,
   ``assemble_batch`` and ``train_loop``: the full-size MagViT-v2 on seeded
   512x512 images, B=1 x 4 microbatches x L=2565, remat; the plain path's
   first step, 3 steps through K1 at exactly 32 launches a step, loss and
   grad norm against the plain path, s/step, the batch assembly's seconds,
   tokens/s, peak memory, one step profiled, ``_validate_chat`` once); then the
   ``cli/train_pararl.py`` loop on the same 4 layers (2 rollouts of the
   512x512 layout, 16 + 8 steps, 4 scored, 3 updates: rollout and update
   seconds apart, exact K1 launches) and, on its last trajectory, the loss
   and gradient norm through K1 against the plain path.

The second-to-last line of stdout is a JSON object with the kernels'
records; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside the repository, the script fails and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
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
    "flash_attention_rope_prefix": (
        CSRC + "flash_attention_rope_prefix.cu",
        "mmada_parallel_tpu/ops/rope_attention.py:298"),
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
TRAIN_L = 5120            # the A trainer's --max_seq_len


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
        flash_attention_rope, flash_attention_rope_prefix,
        flash_attention_rope_qonly)
    return {"flash_attention_rope": flash_attention_rope,
            "flash_attention_rope_qonly": flash_attention_rope_qonly,
            "flash_attention": flash_attention,
            "flash_attention_rope_prefix": flash_attention_rope_prefix}


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


# The card's published peaks (H100 SXM, dense): bf16 on the tensor cores,
# f32 on the FMA pipes, and HBM3.  A bound is the larger of operations over
# the peak of their type and bytes (each input read once, each output written
# once) over the memory rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def _bound(flops: float, nbytes: float, dtype) -> tuple:
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _work(q, k, v, H: int, *others, keys=None) -> tuple:
    """(FLOPs, bytes) of one attention call: 4 * H * D * (keys scored), the
    scored keys being Lq * Lk per batch row, or ``keys`` (the sum over rows
    of the keys a row's bounds admit); bytes are q, k, v, the output (q's
    size) and ``others`` (bias, tables, bounds)."""
    B, Lq = q.shape[:2]
    D = q[0, 0].numel() // H
    keys = B * Lq * k.shape[1] if keys is None else keys
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q, *others)
                 if t is not None)
    return 4 * H * D * keys, nbytes


def _compare(name: str, desc: str, kernel, plain, tol, timed: bool,
             work=None, dtype=None) -> dict:
    """Kernel vs plain on one input; timed, also the kernel's bound from
    ``work`` (FLOPs, bytes).  Returns the record's measured fields."""
    import torch
    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got.float() - want.float()).abs()
    limit = tol["atol"] + tol["rtol"] * want.float().abs()
    max_err = float(err.max())
    if not bool((err <= limit).all()):
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version, max |err| {max_err:.3e} ({tol})")
    rec = {"max_abs_err": max_err, "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None}
    times = ""
    if timed:
        rec["ms"], rec["plain_ms"] = time_ms(kernel), time_ms(plain)
        rec["bound_ms"], rec["bound_by"] = _bound(*work, dtype)
        times = (f" kernel {rec['ms']:.3f} ms plain {rec['plain_ms']:.3f} ms"
                 f" bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                 f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of bound")
    log(f"[kernel] {name}: {desc} max|err| {max_err:.3e} tol {tol}{times}")
    return rec


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


M_T2I_PAD = 200           # left padding of the M train batch's t2i row


def _m_train_bias(L: int, device):
    """The M train step's attention bias, as ``llada_hidden`` builds it from
    ``forward_process``'s padding mask: ``[t2i | lm | mmu]`` rows, the t2i
    row's first ``M_T2I_PAD`` positions padding."""
    import torch
    from mmada_parallel_torch.ops.masks import pairwise_padding_mask, to_bias
    mask = torch.ones(3, L, dtype=torch.bool, device=device)
    mask[0, :M_T2I_PAD] = False
    return to_bias(pairwise_padding_mask(mask)).contiguous()


def _desc(B, Lq, Lk, H, KV, D, dtype) -> str:
    return (f"B={B} Lq={Lq} Lk={Lk} H={H} KV={KV} D={D} "
            f"{str(dtype).split('.')[-1]}")


def _kernel_case(name, B, Lq, Lk, H, KV, D, dtype, tol, gen, *,
                 bias=None, per_row_pos=None, timed=False) -> dict:
    """K1 vs plain on one shape."""
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
    desc = (_desc(B, Lq, Lk, H, KV, D, dtype)
            + (" per-row tables" if per_row_pos is not None else "")
            + (" bias" if bias is not None else ""))
    return _compare(
        f"K1 {name}", desc,
        lambda: flash_attention_rope(q, k, v, sin, cos, bias, **kw),
        lambda: flash_attention_rope_reference(q, k, v, sin, cos, bias,
                                               **kw), tol, timed,
        _work(q, k, v, H, bias, sin, cos), dtype)


def _ragged(B: int, L: int, lengths, device):
    """Per-row positions ``cumsum(mask) - 1`` of rows padded from
    ``lengths`` and their pairwise padding bias, one real row of batch row
    1 (row 100) fully masked."""
    import torch
    mask = torch.zeros(B, L, dtype=torch.bool, device=device)
    for b, n in enumerate(lengths):
        mask[b, :n] = True
    pos = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
    pair = mask[:, :, None] & mask[:, None, :]
    bias = torch.where(pair[:, None], 0.0, -1e30).to(torch.float32)
    bias[1, 0, 100, :] = -1e30
    return pos, bias.contiguous()


def phase_rope_prepass() -> None:
    """K1's bf16 rotation pre-pass against ``rope_tensor`` on the card:
    bitwise equal (both are two rounded f32 products and a rounded sum,
    rounded to bf16)."""
    import torch
    from mmada_parallel_torch.ops.rope_attention import (rope_rotate,
                                                         rope_tensor)
    gen = torch.Generator(device="cuda").manual_seed(12)
    dev = torch.device("cuda")
    for B, L, NH, D, per_row in ((1, EDIT_L, EDIT_H, EDIT_D, False),
                                 (2, EDIT_L, EDIT_H, EDIT_D, True),
                                 (2, 300, 4, 64, True)):
        x = torch.randn(B, L, NH * D, generator=gen, device=dev).to(
            torch.bfloat16)
        sin, cos = _rope_tables(L, D, dev)
        if per_row:
            pos = torch.randint(0, L, (B, L), generator=gen, device=dev)
            sin, cos = sin[pos].contiguous(), cos[pos].contiguous()
        got = rope_rotate(x, sin, cos, n_heads=NH)
        want = rope_tensor(x.reshape(B, L, NH, D), sin, cos,
                           True).reshape(B, L, NH * D)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(
                f"rope pre-pass B={B} L={L} D={D}: not bitwise equal to "
                f"rope_tensor, max |err| "
                f"{float((got.float() - want.float()).abs().max()):.3e}")
        ms = time_ms(lambda: rope_rotate(x, sin, cos, n_heads=NH))
        log(f"[kernel] K1 rope pre-pass B={B} L={L} heads={NH} D={D} "
            f"{'per-row' if per_row else 'shared'} tables: bitwise equal to "
            f"rope_tensor, {ms:.4f} ms")


def phase_kernel() -> dict:
    """K1 against its plain version at the edit shapes; returns the
    record's measured fields (B=1 edit shape timings: the cond forward)."""
    import torch
    from mmada_parallel_torch.ops.masks import ragged_positions
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    L, H, D = EDIT_L, EDIT_H, EDIT_D
    dev = torch.device("cuda")
    # (a) the solo edit: shared tables, no bias, B=1 (cond) and B=2 (uncond)
    a1 = _kernel_case("a/B1", 1, L, L, H, H, D, bf16, BF16_TOL, gen,
                      timed=True)
    a2 = _kernel_case("a/B2", 2, L, L, H, H, D, bf16, BF16_TOL, gen,
                      timed=True)
    recs = [a1, a2]
    # (b) ragged batch: rows padded from 2000 and 1500, per-row positions
    # cumsum(mask)-1, and one real row fully masked
    pos, bias = _ragged(2, L, (2000, 1500), dev)
    recs.append(_kernel_case("b/bias", 2, L, L, H, H, D, bf16, BF16_TOL,
                             gen, bias=bias, per_row_pos=pos))
    # (c) GQA 32/8
    recs.append(_kernel_case("c/gqa", 1, L, L, H, 8, D, bf16, BF16_TOL, gen))
    # (d) f32 at small shapes: GQA + bias + per-row tables at D=128, and
    # Lq != Lk from one shared table at D=64
    pos2, b2 = _ragged(2, 300, (300, 250), dev)
    recs.append(_kernel_case("d/f32", 2, 300, 300, 4, 2, 128, f32, F32_TOL,
                             gen, bias=b2, per_row_pos=pos2))
    recs.append(_kernel_case("d/f32-D64", 1, 100, 260, 4, 4, 64, f32,
                             F32_TOL, gen))
    # (e) the A train step's attention (phase 5): B=1 at --max_seq_len,
    # shared tables, no bias
    e = _kernel_case("e/A-train", 1, TRAIN_L, TRAIN_L, H, H, D, bf16,
                     BF16_TOL, gen, timed=True)
    # (f) the M train step's: [t2i | lm | mmu] B=3 at the interleave length,
    # shared tables (forward_process passes no positions) and the pairwise
    # padding bias llada_hidden builds, the t2i row left-padded
    Lm = _m_sequence_length()
    f = _kernel_case("f/M-train", 3, Lm, Lm, H, H, D, bf16, BF16_TOL, gen,
                     bias=_m_train_bias(Lm, dev), timed=True)
    recs += [e, f]
    # (g) the tensor-core body's edges in bf16: D=64; Lq and Lk not
    # multiples of the 128-row q tile or the 64-key tile, Lq != Lk; GQA
    # 32/8; per-row tables with a fully masked row; an odd Lk with a bias
    # (scalar bias loads)
    recs.append(_kernel_case("g/D64", 2, 333, 333, 8, 8, 64, bf16,
                             BF16_TOL, gen))
    recs.append(_kernel_case("g/ragged-gqa", 1, 197, 517, H, 8, D, bf16,
                             BF16_TOL, gen))
    pos3, b3 = _ragged(2, 301, (301, 173), dev)
    recs.append(_kernel_case("g/odd-Lk bias D64", 2, 301, 301, 4, 2, 64,
                             bf16, BF16_TOL, gen, bias=b3,
                             per_row_pos=pos3))
    # (h) the [t2i-m] server batch: 2 text prompts left-padded to their
    # bucket, cond and uncond rows (B=4), shared tables, the padding bias;
    # (i) the [mmu] server batch: 2 prompts right-padded to their bucket,
    # per-row re-ranked positions, the padding bias
    t2i_mask = _t2i_m_mask(dev)
    Lt = t2i_mask.shape[1]
    h = _kernel_case("h/t2i-server", 4, Lt, Lt, H, H, D, bf16, BF16_TOL, gen,
                     bias=_mask_bias(t2i_mask), timed=True)
    mmu_mask = _mmu_mask(dev)
    Lu = mmu_mask.shape[1]
    i = _kernel_case("i/mmu-server", 2, Lu, Lu, H, H, D, bf16, BF16_TOL, gen,
                     bias=_mask_bias(mmu_mask), timed=True,
                     per_row_pos=ragged_positions(mmu_mask))
    recs += [h, i]
    # (j) the M trainer's step (cli/train_m.py, phase 5 [train-m-cli]):
    # B=1 at its 2565 tokens, shared tables, the key-padding bias of an
    # interleave row (the instruction's eos fill in the middle, the output
    # text's tail at the end)
    m_mask = _m_cli_mask(dev)
    Lc = m_mask.shape[1]
    j = _kernel_case("j/M-trainer", 1, Lc, Lc, H, H, D, bf16, BF16_TOL, gen,
                     bias=_mask_bias(m_mask), timed=True)
    recs.append(j)
    log(f"[kernel] K1 edit shape B=1: kernel {a1['ms']:.3f} ms plain "
        f"{a1['plain_ms']:.3f} ms; B=2: kernel {a2['ms']:.3f} ms plain "
        f"{a2['plain_ms']:.3f} ms; A-train B=1 L={TRAIN_L}: kernel "
        f"{e['ms']:.3f} ms plain {e['plain_ms']:.3f} ms; M-train B=3 L={Lm}: "
        f"kernel {f['ms']:.3f} ms plain {f['plain_ms']:.3f} ms; t2i-server "
        f"B=4 L={Lt}: kernel {h['ms']:.3f} ms plain {h['plain_ms']:.3f} ms; "
        f"mmu-server B=2 L={Lu}: kernel {i['ms']:.3f} ms plain "
        f"{i['plain_ms']:.3f} ms; M-trainer B=1 L={Lc} + bias "
        f"({int((~m_mask).sum())} padded keys): kernel {j['ms']:.3f} ms "
        f"plain {j['plain_ms']:.3f} ms bound {j['bound_ms']:.4f} ms")
    return dict(a1, max_abs_err=max(r["max_abs_err"] for r in recs),
                library_ms=None)


def _qonly_case(name, B, Lq, Lk, H, KV, D, dtype, tol, gen, *,
                 per_row=True, bias=None, timed=False, n_split=None,
                 sdpa=False) -> dict:
    """K2 vs plain: q at Lq sorted distinct positions of an Lk sequence
    (per-row tables) or at positions 0..Lq-1 (shared), pre-rotated k;
    ``n_split`` forces the split-K count (None: the planner's).  With
    ``sdpa``, one SDPA call on the pre-rotated q beside it."""
    import torch
    from mmada_parallel_torch.ops.rope_attention import (
        _sm_count, flash_attention_rope_qonly,
        flash_attention_rope_qonly_reference, plan_splits)
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
    splits = 1 if dtype == torch.float32 else (
        n_split or plan_splits(B, H, Lq, Lk, _sm_count(dev)))
    desc = (f"{_desc(B, Lq, Lk, H, KV, D, dtype)} "
            f"{'per-row' if per_row else 'shared'} tables"
            f"{' bias' if bias is not None else ''}, split {splits}"
            f"{' (forced)' if n_split else ''}")
    with _forced_splits(n_split):
        rec = _compare(
            f"K2 {name}", desc,
            lambda: flash_attention_rope_qonly(q, k, v, sin, cos, bias,
                                               **kw),
            lambda: flash_attention_rope_qonly_reference(q, k, v, sin, cos,
                                                         bias, **kw),
            tol, timed, _work(q, k, v, H, bias, sin, cos), dtype)
    if sdpa:
        from mmada_parallel_torch.ops.rope_attention import rope_tensor
        q4 = rope_tensor(q.reshape(B, Lq, H, D), sin, cos, True)
        want = flash_attention_rope_qonly_reference(q, k, v, sin, cos, bias,
                                                    **kw)
        _sdpa_ms(f"K2 {name}", q4, k.reshape(B, Lk, KV, D),
                 v.reshape(B, Lk, KV, D), bias,
                 want=want.reshape(B, Lq, H, D),
                 what="on the pre-rotated q: the attention part without the "
                      "q rotation, not the same function")
    rec["splits"] = splits
    return rec


@contextlib.contextmanager
def _forced_splits(n_split):
    """K2's split-K planner replaced by the constant ``n_split`` (None: left
    as it is) for the duration of the block."""
    from mmada_parallel_torch.ops import rope_attention as R
    plan = R.plan_splits
    if n_split is not None:
        R.plan_splits = lambda *args: n_split
    try:
        yield
    finally:
        R.plan_splits = plan


def _device_kernels(fn) -> dict:
    """``{name: device us}`` of the kernels one call of ``fn`` runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us[e.name] = us.get(e.name, 0.0) + (e.time_range.end
                                                - e.time_range.start)
    return us


def _check_tensor_core_body(name: str, fn) -> None:
    """A bf16 call of ``fn`` must run the tensor-core body
    (``attention_mma_kernel``) and no FMA-template ``attention_kernel``;
    prints each device kernel's time in that call (profiler on)."""
    names = _device_kernels(fn)
    body = [n for n in names if "attention_mma_kernel" in n]
    fma = [n for n in names if "::attention_kernel<" in n]
    if not body or fma:
        raise AssertionError(f"{name}: bf16 device kernels {list(names)}, "
                             f"expected the tensor-core body and no FMA "
                             f"template")
    short = [n.replace("(anonymous namespace)::", "").split("(")[0]
             .removeprefix("void ") + f" {us:.1f} us"
             for n, us in names.items()]
    log(f"[kernel] {name} bf16 device kernels: {short}")


def _split_sweep(B, Lq, Lk, H, D, counts) -> None:
    """K2 in bf16 at one shape with its split count forced to each of
    ``counts``: the device time of one call (all its kernels, profiler on),
    beside the planner's choice."""
    import torch
    from mmada_parallel_torch.ops.rope_attention import (
        _sm_count, flash_attention_rope_qonly, plan_splits)
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, H * D, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, Lk, H * D, device=dev).to(torch.bfloat16)
            for _ in range(2))
    sin, cos = (t[:Lq].contiguous() for t in _rope_tables(Lk, D, dev))
    us = {}
    for n in counts:
        with _forced_splits(n):
            def call():
                return flash_attention_rope_qonly(q, k, v, sin, cos,
                                                  n_heads=H)
            call()
            us[n] = sum(_device_kernels(call).values())
    log(f"[kernel] K2 split sweep B={B} Lq={Lq} Lk={Lk}: device us by "
        f"split count {{{', '.join(f'{n}: {t:.1f}' for n, t in us.items())}}}"
        f"; planner {plan_splits(B, H, Lq, Lk, _sm_count(dev))}")


def _m_sequence_length() -> int:
    """Length of the M sequence the full-width interleave builds (1024 image
    tokens, 256 text slots, a 51-id instruction)."""
    from mmada_parallel_torch import tokens as tk
    T = tk.TOKENS_M
    instr = tk.normalize_text_ids(StandInTokenizer()("x")["input_ids"],
                                  T.bos, T.eos)
    prompt = [T.interleave, T.soi] + [T.vq_offset] * 1024 + [T.eoi] + instr
    return tk.assemble_interleave_sequence(prompt, 1024, 256, T)[1].total_len


# The full-width text-to-image and understanding requests (phase 4), whose
# shapes phase 2 also runs the kernels at
T2I_PROMPT = "a red apple on a wooden table"
MMU_QUESTION = "what is in the image?"
T2I_A_PARTIAL = math.ceil((1 - 0.9) * 1024)  # 103 slots at cache_ratio 0.9
MMU_NEW = 128                                # max_new_tokens


def _t2i_a_request():
    """``(ids, layout, uncond prefix)`` of the variant-A text-to-image
    request: the prompt through the stand-in tokenizer, then the 32 x 32
    all-mask image span of a 512x512 image."""
    import numpy as np
    from mmada_parallel_torch import tokens as tk
    tok = StandInTokenizer()
    cond, uncond = tk.make_t2i_prompt(T2I_PROMPT)
    ids, layout = tk.assemble_ti2ti_sequence(tok(cond)["input_ids"], 0, 32,
                                             32, [])
    return ids, layout, np.asarray(tok(uncond)["input_ids"], np.int64)


def _t2i_a_lengths():
    """Lengths of the cond and the uncond sequence of the A T2I request."""
    ids, layout, un = _t2i_a_request()
    return len(ids), len(un) + len(ids) - layout.code_start


def _t2i_m_texts():
    """The two variant-M T2I texts, templated to 52 and 42 tokens: one
    64-token bucket."""
    ids = StandInTokenizer()(T2I_PROMPT)["input_ids"]
    return [ids, ids[:40]]


def _t2i_m_mask(device):
    """The padding mask ``T2IServer`` builds for the two texts: the cond
    rows left-padded to the bucket, then the uncond rows."""
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.serving import _round_bucket
    T = tk.TOKENS_M
    lens = [1 + len(tk.normalize_text_ids(t, T.bos, T.eos))
            for t in _t2i_m_texts()]
    plen = _round_bucket(max(lens), 32, 512)
    mask = torch.zeros(4, plen + 1026, dtype=torch.bool)
    for i, n in enumerate(lens):
        mask[i, plen - n:] = True
    mask[2:, plen - 3:] = True
    return mask.to(device)


def _mmu_prompts():
    """Two understanding prompts, ``[mmu][soi] 1024 seeded codes [eoi]``
    then a 50- or a 21-id question: one 64-token bucket (1088)."""
    import numpy as np
    from mmada_parallel_torch import tokens as tk
    T = tk.TOKENS_M
    rng = np.random.default_rng(0)
    q = tk.normalize_text_ids(StandInTokenizer()(MMU_QUESTION)["input_ids"],
                              T.bos, T.eos, append_eos_always=False)
    return [[T.mmu, T.soi]
            + (rng.integers(0, T.codebook_size, 1024) + T.vq_offset).tolist()
            + [T.eoi] + question for question in (q, q[:20] + [T.eos])]


def _mmu_mask(device):
    """The padding mask ``mmu_generate`` gets from ``MMUServer`` for the two
    prompts, extended over the answer span."""
    import torch
    from mmada_parallel_torch.serving import _round_bucket
    prompts = _mmu_prompts()
    plen = _round_bucket(max(map(len, prompts)), 64, 2048)
    mask = torch.ones(2, plen + MMU_NEW, dtype=torch.bool)
    for i, p in enumerate(prompts):
        mask[i, len(p):plen] = False
    return mask.to(device)


def _mask_bias(mask):
    """The pairwise f32 bias ``llada_hidden`` builds from a padding mask."""
    from mmada_parallel_torch.ops.masks import pairwise_padding_mask, to_bias
    return to_bias(pairwise_padding_mask(mask)).contiguous()


def phase_kernel_qonly() -> dict:
    """K2 against its plain version at the cached samplers' shapes."""
    import torch
    from mmada_parallel_torch.ops.rope_attention import (
        flash_attention_rope_qonly)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    L, H, D = EDIT_L, EDIT_H, EDIT_D
    Lm = _m_sequence_length()
    dev = torch.device("cuda")
    recs = []
    # (a) the A partial step at the reference settings: 3 + 13 = 16 slots
    a = _qonly_case("a/A-partial", 1, 16, L, H, H, D, bf16, BF16_TOL, gen,
                    timed=True, sdpa=True)
    # (b) the A full step with the cache: Lq = Lk, shared tables
    full = _qonly_case("b/A-full", 1, L, L, H, H, D, bf16, BF16_TOL, gen,
                       per_row=False, timed=True, sdpa=True)
    # (c) the M partial step: 256 text + 52 image slots, cond + uncond rows
    c = _qonly_case("c/M-partial", 2, 256 + 52, Lm, H, H, D, bf16, BF16_TOL,
                    gen, timed=True)
    # (f) the M full refresh: cond + uncond rows, Lq = Lk, shared tables
    f = _qonly_case("f/M-full", 2, Lm, Lm, H, H, D, bf16, BF16_TOL, gen,
                    per_row=False, timed=True)
    recs += [a, full, c, f]
    # (d) GQA 32/8 with a padding bias (rows keep 2360 and 1800 keys)
    bias = _pad_bias([Lm, 1800], 308, Lm, dev)
    recs.append(_qonly_case("d/gqa-bias", 2, 308, Lm, H, 8, D, bf16,
                            BF16_TOL, gen, bias=bias.contiguous()))
    # (e) f32 at small shapes, D=128 and D=64
    recs.append(_qonly_case(
        "e/f32", 2, 40, 300, 4, 2, 128, f32, F32_TOL, gen,
        bias=_pad_bias([300, 250], 40, 300, dev).contiguous()))
    recs.append(_qonly_case("e/f32-D64", 1, 100, 260, 4, 4, 64, f32,
                            F32_TOL, gen))
    # (g) the tensor-core body's bf16 edges: one q row; 65 rows (one row
    # into the second warpgroup); a forced split with a padding bias and a
    # row masked on every key (mean(v) across splits, and splits masked for
    # every row of batch row 1); GQA 32/8 split by the planner; D=64 split;
    # a forced split of ragged Lq/Lk with GQA
    recs.append(_qonly_case("g/Lq1", 1, 1, L, H, H, D, bf16, BF16_TOL, gen))
    recs.append(_qonly_case("g/Lq65", 1, 65, L, H, H, D, bf16, BF16_TOL,
                            gen))
    b7 = _pad_bias([300, 170], 40, 300, dev)
    b7[0, 0, 7, :] = -1e30
    recs.append(_qonly_case("g/split-masked", 2, 40, 300, 4, 2, D, bf16,
                            BF16_TOL, gen, bias=b7.contiguous(), n_split=5))
    recs.append(_qonly_case("g/gqa-split", 1, 22, L, H, 8, D, bf16,
                            BF16_TOL, gen))
    recs.append(_qonly_case("g/D64-split", 2, 17, 333, 8, 8, 64, bf16,
                            BF16_TOL, gen, n_split=3))
    recs.append(_qonly_case("g/full-forced-split", 1, 333, 517, 8, 2, D,
                            bf16, BF16_TOL, gen, n_split=4))
    # (h) the cached A text-to-image partial step: ceil(0.1 * 1024) = 103
    # image slots against the cond and the uncond sequence
    t2i = [_qonly_case(f"h/t2i-a-partial Lk={Lk}", 1, T2I_A_PARTIAL, Lk, H,
                       H, D, bf16, BF16_TOL, gen, timed=True)
           for Lk in sorted(set(_t2i_a_lengths()))]
    recs += t2i
    # the device kernels of a split and of an unsplit bf16 call
    q, k = (torch.randn(1, n, H * D, device=dev).to(bf16) for n in (16, L))
    sin, cos = _rope_tables(16, D, dev)
    for n_split in (None, 1):
        with _forced_splits(n_split):
            _check_tensor_core_body(
                f"K2 Lq=16 Lk={L} split "
                f"{'planned' if n_split is None else 1}",
                lambda: flash_attention_rope_qonly(q, k, k, sin, cos,
                                                   n_heads=H))
    # the planner's choice against other split counts, by device time
    for B, Lq, Lk, counts in ((1, 16, L, (1, 2, 4, 5, 8, 12, 19, 38)),
                              (2, 308, Lm, (1, 2, 3, 4)),
                              (1, T2I_A_PARTIAL, max(_t2i_a_lengths()),
                               (1, 2, 3, 5, 9, 18))):
        _split_sweep(B, Lq, Lk, H, D, counts)
    log(f"[kernel] K2 A-partial B=1 Lq=16 (split {a['splits']}): "
        f"{a['ms']:.3f} ms; A-full B=1 L={L}: {full['ms']:.3f} ms; "
        f"M-partial B=2 Lq=308 (split {c['splits']}): {c['ms']:.3f} ms; "
        f"M-full B=2 L={Lm}: {f['ms']:.3f} ms; " + "; ".join(
            f"t2i-a-partial B=1 Lq={T2I_A_PARTIAL} (split {r['splits']}): "
            f"{r['ms']:.3f} ms" for r in t2i))
    return dict(full, max_abs_err=max(r["max_abs_err"] for r in recs),
                library_ms=None)


def _sdpa_ms(label: str, q, k, v, bias=None, *, is_causal=False,
             want=None, what="the library yardstick") -> float:
    """One ``torch.nn.functional.scaled_dot_product_attention`` call on
    BLHD inputs (viewed as BHLD; the bias as ``attn_mask``, or
    ``is_causal``; ``enable_gqa`` when KV < H), timed, its max |err|
    against ``want`` (default: the plain chain on the same inputs), and the
    backend it took read from the profiler's kernel names.  The port never
    calls it."""
    import torch.nn.functional as F
    from mmada_parallel_torch.ops.attention import _xla_attention
    gqa = k.shape[2] < q.shape[2]
    mask = bias.to(q.dtype) if bias is not None else None

    def call():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=is_causal,
            enable_gqa=gqa).transpose(1, 2)

    if want is None:
        want = _xla_attention(q, k, v, bias)
    err = float((call().float() - want.float()).abs().max())
    ms = time_ms(call)
    names = sorted(_device_kernels(call))
    log(f"[kernel] {label} yardstick: scaled_dot_product_attention "
        f"{ms:.3f} ms ({what}), max |err| against the plain version "
        f"{err:.3e}, device kernels {[n[:80] for n in names]}")
    return ms


def _blhd_case(name, B, Lq, Lk, H, KV, D, dtype, tol, gen, *, bias=None,
               timed=False, library=False) -> dict:
    """K3 vs plain (``_xla_attention``) on BLHD inputs; with ``library``,
    also one SDPA call on the same inputs."""
    import torch
    from mmada_parallel_torch.ops.attention import _xla_attention
    from mmada_parallel_torch.ops.flash_attention import flash_attention
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Lk, KV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Lk, KV, D, generator=gen, device=dev).to(dtype)
    desc = (f"{_desc(B, Lq, Lk, H, KV, D, dtype)}"
            f"{' bias' if bias is not None else ''}")
    rec = _compare(f"K3 {name}", desc,
                   lambda: flash_attention(q, k, v, bias),
                   lambda: _xla_attention(q, k, v, bias), tol, timed,
                   _work(q, k, v, H, bias), dtype)
    rec["library_ms"] = _sdpa_ms(f"K3 {name}", q, k, v, bias) \
        if library else None
    return rec


def phase_kernel_blhd() -> dict:
    """K3 against its plain version at the BLHD edit shape, and one SDPA
    call beside it."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    L, H, D = EDIT_L, EDIT_H, EDIT_D
    dev = torch.device("cuda")
    a1 = _blhd_case("a/B1", 1, L, L, H, H, D, bf16, BF16_TOL, gen,
                    timed=True, library=True)
    recs = [a1, _blhd_case("a/B2", 2, L, L, H, H, D, bf16, BF16_TOL, gen,
                           timed=True, library=True)]
    # padding bias (rows of 2000 and 1500) and one real row fully masked
    bias = _pad_bias([2000, 1500], L, L, dev)
    bias[1, 0, 100, :] = -1e30
    recs.append(_blhd_case("b/bias", 2, L, L, H, H, D, bf16, BF16_TOL, gen,
                           bias=bias.contiguous()))
    recs.append(_blhd_case("c/gqa", 1, L, L, H, 8, D, bf16, BF16_TOL, gen))
    recs.append(_blhd_case(
        "d/f32", 2, 300, 300, 4, 2, 128, f32, F32_TOL, gen,
        bias=_pad_bias([300, 250], 300, 300, dev).contiguous()))
    recs.append(_blhd_case("d/f32-D64", 1, 100, 260, 4, 4, 64, f32, F32_TOL,
                           gen))
    # (e) the tensor-core body's edges in bf16: D=64 with Lq != Lk, neither
    # a tile multiple; GQA 32/8 at ragged lengths; an odd Lk with a bias and
    # a fully masked row (scalar bias loads)
    recs.append(_blhd_case("e/D64", 2, 100, 260, 4, 4, 64, bf16, BF16_TOL,
                           gen))
    recs.append(_blhd_case("e/ragged-gqa", 1, 333, 517, H, 8, D, bf16,
                           BF16_TOL, gen))
    b5 = _pad_bias([301, 250], 190, 301, dev)
    b5[0, 0, 7, :] = -1e30
    recs.append(_blhd_case("e/odd-Lk bias", 2, 190, 301, 4, 2, 64, bf16,
                           BF16_TOL, gen, bias=b5.contiguous()))
    return dict(a1, max_abs_err=max(r["max_abs_err"] for r in recs))


def _prefix_case(name, B, Lq, Lk, H, KV, D, dtype, tol, gen, hi, *,
                 timed=False, sdpa=False) -> dict:
    """K4 vs plain on one shape with bounds ``hi`` [B, Lq]; its work counts
    the keys the clamped bounds admit.  With ``sdpa`` (causal bounds), one
    causal SDPA call on the pre-rotated q and k beside it."""
    import torch
    from mmada_parallel_torch.ops.rope_attention import (
        flash_attention_rope_prefix, flash_attention_rope_prefix_reference,
        rope_tensor)
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, H * D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Lk, KV * D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Lk, KV * D, generator=gen, device=dev).to(dtype)
    sin, cos = _rope_tables(max(Lq, Lk), D, dev)
    kw = dict(n_heads=H, n_kv_heads=KV)
    desc = (f"{_desc(B, Lq, Lk, H, KV, D, dtype)} bounds in "
            f"[{int(hi.min())}, {int(hi.max())}]")
    keys = int(hi.clamp(1, Lk).sum())
    rec = _compare(
        f"K4 {name}", desc,
        lambda: flash_attention_rope_prefix(q, k, v, sin, cos, hi, **kw),
        lambda: flash_attention_rope_prefix_reference(q, k, v, sin, cos, hi,
                                                      **kw), tol, timed,
        _work(q, k, v, H, sin, cos, hi, keys=keys), dtype)
    if sdpa:
        want = flash_attention_rope_prefix_reference(q, k, v, sin, cos, hi,
                                                     **kw)
        _sdpa_ms(f"K4 {name}",
                 rope_tensor(q.reshape(B, Lq, H, D), sin, cos, True),
                 rope_tensor(k.reshape(B, Lk, KV, D), sin, cos, True),
                 v.reshape(B, Lk, KV, D), is_causal=True,
                 want=want.reshape(B, Lq, H, D),
                 what="is_causal on the pre-rotated q and k: the attention "
                      "part without the rotation, not the same function")
        _check_tensor_core_body(
            f"K4 {name}",
            lambda: flash_attention_rope_prefix(q, k, v, sin, cos, hi, **kw))
    return rec


def _causal_bounds(B, L, device):
    from mmada_parallel_torch.ops.masks import prefix_bounds
    return prefix_bounds(L, device=device)[None].expand(B, L).contiguous()


def phase_kernel_prefix() -> dict:
    """K4 against its plain version, and against K1 on the equivalent dense
    bias (the crossover for ``rope_attention_prefix``'s ``auto``)."""
    import torch
    from mmada_parallel_torch.ops.masks import mixed_prefix_bounds
    gen = torch.Generator(device="cuda").manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    H, D, L = EDIT_H, EDIT_D, TRAIN_L
    dev = torch.device("cuda")
    # (a) the A-train shape, causal bounds
    a = _prefix_case("a/A-train causal", 1, L, L, H, H, D, bf16, BF16_TOL,
                     gen, _causal_bounds(1, L, dev), timed=True, sdpa=True)
    # (b) a mixed [t2i | lm | mmu] batch: t2i rows see the image span
    # bidirectionally, mmu rows the whole 1056-token image prefix
    hi = mixed_prefix_bounds(L, 1, 1, 1, ((1024, 2080),), 1056,
                             device=dev).contiguous()
    b = _prefix_case("b/mixed B=3", 3, L, L, H, H, D, bf16, BF16_TOL, gen,
                     hi, timed=True)
    recs = [a, b]
    torch.cuda.empty_cache()
    # (c) GQA 32/8, t2i bounds
    hi = mixed_prefix_bounds(700, 1, 0, 0, ((100, 400),), 0, device=dev)
    recs.append(_prefix_case("c/gqa", 1, 700, 700, H, 8, D, bf16, BF16_TOL,
                             gen, hi.contiguous()))
    # (d) f32 at D=64, a mixed batch with GQA
    recs.append(_prefix_case(
        "d/f32-D64", 3, 300, 300, 4, 2, 64, f32, F32_TOL, gen,
        mixed_prefix_bounds(300, 1, 1, 1, ((20, 140),), 60,
                            device=dev).contiguous()))
    # (e) bounds 0 and past Lk, random elsewhere; Lq != Lk from one table
    hi = torch.randint(-3, 300, (2, 200), generator=gen, device=dev)
    hi[0, :7] = 0
    hi[1, :7] = 10_000
    recs.append(_prefix_case("e/edge bounds", 2, 200, 260, 4, 4, 128, f32,
                             F32_TOL, gen, hi.to(torch.int32)))
    # (f) the tensor-core body's bf16 edges: D=64 causal with GQA 8/2 at an
    # Lq that is no multiple of the 128-row q tile; bounds 0, negative and
    # past Lk with Lq != Lk; a mixed batch at D=64
    recs.append(_prefix_case("f/D64-causal-gqa", 2, 333, 333, 8, 2, 64,
                             bf16, BF16_TOL, gen, _causal_bounds(2, 333,
                                                                 dev)))
    recs.append(_prefix_case("f/edge bounds", 2, 200, 260, 4, 4, 128, bf16,
                             BF16_TOL, gen, hi.to(torch.int32)))
    recs.append(_prefix_case(
        "f/mixed-D64", 3, 300, 300, 4, 2, 64, bf16, BF16_TOL, gen,
        mixed_prefix_bounds(300, 1, 1, 1, ((20, 140),), 60,
                            device=dev).contiguous()))
    log(f"[kernel] K4 A-train causal B=1 L={L}: kernel {a['ms']:.3f} ms "
        f"plain {a['plain_ms']:.3f} ms; mixed B=3: kernel {b['ms']:.3f} ms "
        f"plain {b['plain_ms']:.3f} ms")
    return dict(a, max_abs_err=max(r["max_abs_err"] for r in recs),
                library_ms=None)


def phase_prefix_crossover() -> int:
    """K4 against K1 on the equivalent dense bias (causal, B=1) at the edit
    and A-train lengths, then ``rope_attention_prefix(impl="auto")`` with a
    backward at both: K1 below 4096 tokens, K4 from it, and no launch in
    either backward.  Returns K4's launch count."""
    import torch
    from mmada_parallel_torch.ops.attention import (_prefix_dense_bias,
                                                    rope_attention_prefix)
    from mmada_parallel_torch.ops.masks import to_bias
    from mmada_parallel_torch.ops.rope_attention import (
        flash_attention_rope, flash_attention_rope_prefix)
    gen = torch.Generator(device="cuda").manual_seed(5)
    dev = torch.device("cuda")
    H, D = EDIT_H, EDIT_D
    tensors = {}
    for L in (EDIT_L, TRAIN_L):
        q, k, v = (torch.randn(1, L, H * D, generator=gen, device=dev
                               ).to(torch.bfloat16) for _ in range(3))
        sin, cos = _rope_tables(L, D, dev)
        hi = _causal_bounds(1, L, dev)
        bias = to_bias(_prefix_dense_bias(hi, L)).contiguous()
        kw = dict(n_heads=H, n_kv_heads=H)
        k4 = time_ms(lambda: flash_attention_rope_prefix(q, k, v, sin, cos,
                                                         hi, **kw))
        k1 = time_ms(lambda: flash_attention_rope(q, k, v, sin, cos, bias,
                                                  **kw))
        log(f"[crossover] causal B=1 L={L} H={H} D={D} bf16: K4 bounds "
            f"{k4:.3f} ms, K1 dense bias {k1:.3f} ms ({k1 / k4:.2f}x)")
        tensors[L] = (q, k, v, sin, cos, hi)
    launches = {}
    for L, want in ((EDIT_L, {"flash_attention_rope": 1}),
                    (TRAIN_L, {"flash_attention_rope_prefix": 1})):
        q, k, v, sin, cos, hi = tensors[L]
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        reset_launches()
        out = rope_attention_prefix(q, k, v, sin, cos, hi, n_heads=H,
                                    n_kv_heads=H, impl="auto")
        out.float().square().mean().backward()
        torch.cuda.synchronize()
        launches[L] = check_launches(f"auto prefix L={L}", want)
        if not all(torch.isfinite(t.grad).all() for t in (q, k, v)):
            raise AssertionError(f"auto prefix L={L}: gradients not finite")
    log(f"[crossover] rope_attention_prefix(auto) forward + backward: "
        f"L={EDIT_L} launches {launches[EDIT_L]}, L={TRAIN_L} launches "
        f"{launches[TRAIN_L]}")
    return launches[TRAIN_L]["flash_attention_rope_prefix"]


def phase_kernel_grads() -> None:
    """Each kernel's autograd Function (``impl="pallas"``): the forward
    within the kernel's tolerance of plain autograd (``impl="xla"``), and
    q/k/v gradients equal to it, since the backward recomputes the plain
    chain (tolerance: the kernel's, because the gradients flow through the
    same ``w`` either way and only the forward differs)."""
    import torch
    from mmada_parallel_torch.ops import attention as A
    from mmada_parallel_torch.ops.masks import mixed_prefix_bounds
    gen = torch.Generator(device="cuda").manual_seed(6)
    dev = torch.device("cuda")
    for dtype, tol, B, L, H, KV, D in (
            (torch.bfloat16, BF16_TOL, 2, 300, 8, 4, 128),
            (torch.float32, F32_TOL, 2, 200, 4, 2, 64)):
        sin, cos = _rope_tables(L, D, dev)
        bias = _pad_bias([L, L - 50], L, L, dev).contiguous()
        hi = mixed_prefix_bounds(L, 1, 0, 1, ((40, 120),), 80, device=dev)
        sel = torch.sort(torch.randperm(L, generator=gen, device=dev)[:40]
                         ).values
        packed = ((B, L, H * D), (B, L, KV * D), (B, L, KV * D))
        cases = {
            "K1 rope_attention": (packed, lambda q, k, v, impl:
                                  A.rope_attention(
                                      q, k, v, sin, cos, bias, n_heads=H,
                                      n_kv_heads=KV, impl=impl)),
            "K2 rope_attention_qonly": (
                ((B, 40, H * D),) + packed[1:], lambda q, k, v, impl:
                A.rope_attention_qonly(q, k, v, sin[sel], cos[sel],
                                       bias[:, :, sel].contiguous(),
                                       n_heads=H, n_kv_heads=KV, impl=impl)),
            "K3 dot_product_attention": (
                ((B, L, H, D), (B, L, KV, D), (B, L, KV, D)),
                lambda q, k, v, impl: A.dot_product_attention(
                    q, k, v, bias, impl=impl)),
            "K4 rope_attention_prefix": (packed, lambda q, k, v, impl:
                                         A.rope_attention_prefix(
                                             q, k, v, sin, cos, hi,
                                             n_heads=H, n_kv_heads=KV,
                                             impl=impl)),
        }
        for name, (shapes, fn) in cases.items():
            xs = [torch.randn(*sh, generator=gen, device=dev).to(dtype)
                  for sh in shapes]
            w = torch.randn(*shapes[0], generator=gen, device=dev)
            outs, grads = [], []
            for impl in ("pallas", "xla"):
                reset_launches()
                ins = [x.detach().requires_grad_(True) for x in xs]
                out = fn(*ins, impl)
                (out.float() * w).sum().backward()
                torch.cuda.synchronize()
                launched = sum(read_launches().values())
                if launched != (1 if impl == "pallas" else 0):
                    raise AssertionError(f"{name} impl={impl}: {launched} "
                                         f"launches, forward + backward")
                outs.append(out.detach().float())
                grads.append([t.grad.float() for t in ins])
            errs = [(a - b).abs().max() for a, b in zip(
                [outs[0], *grads[0]], [outs[1], *grads[1]])]
            for a, b in zip([outs[0], *grads[0]], [outs[1], *grads[1]]):
                if not torch.allclose(a, b, **tol):
                    raise AssertionError(
                        f"{name} {dtype}: Function and plain autograd "
                        f"differ, max |err| out/dq/dk/dv "
                        f"{[f'{float(e):.3e}' for e in errs]} ({tol})")
            log(f"[grad] {name} {str(dtype).split('.')[-1]} "
                f"{'x'.join(map(str, shapes[0]))}: one launch, max |err| "
                f"out/dq/dk/dv {[f'{float(e):.3e}' for e in errs]} tol "
                f"{tol}")


# ---------------------------------------------------------------------------
# Small models: kernel path == plain attention, token for token
# ---------------------------------------------------------------------------


class StandInTokenizer:
    """Fixed-length ids from the characters of the text: every prompt comes
    out at 50 ids, so the 512x512 edit's sequence is 2424 tokens long, the
    length of the TPU bench's edit sequence.  ``</answer>`` is one id."""

    def __call__(self, text, add_special_tokens=True):
        from mmada_parallel_torch import tokens as tk
        if not add_special_tokens:
            return {"input_ids": [tk.TOKENS_A.answer_end]}
        body = [1000 + ord(c) % 1000 for c in text][:48]
        body += [1000] * (48 - len(body))
        return {"input_ids": [126080] + body + [126081]}

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(map(str, ids))


class StandInTokenizerM(StandInTokenizer):
    """The stand-in with what the M trainer's prompting reads: the M
    bos/eos ids, and batch calls (a list of texts in, a list of id lists
    out)."""
    bos_token_id, eos_token_id = 126080, 126081

    def __call__(self, text, add_special_tokens=True):
        if isinstance(text, list):
            return {"input_ids": [super(StandInTokenizerM, self).__call__(
                t, add_special_tokens)["input_ids"] for t in text]}
        return super().__call__(text, add_special_tokens)


M_CLI_INSTR = "make the sky purple"
M_CLI_ANSWER = "the sky is purple now"


def _m_cli_mask(device):
    """The key-padding mask ``UniversalPrompting.interleave`` gives one row
    of the M trainer (1024 image tokens, 256 text slots, the stand-in's
    50-id instruction and answer): ``[1, 2565]``, with the instruction's
    eos fill and the answer's tail padded."""
    import numpy as np
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.data.prompting import (UniversalPrompting,
                                                     encode_output_texts)
    T = tk.TOKENS_M
    tok = StandInTokenizerM()
    out_ids, out_lens = encode_output_texts(tok, [M_CLI_ANSWER], 256)
    img = np.full((1, 1024), T.vq_offset)
    _, _, mask = UniversalPrompting(tok, max_text_len=256).interleave(
        img, [M_CLI_INSTR], img, out_ids, out_ids,
        output_text_lengths=out_lens)
    return torch.as_tensor(mask, dtype=torch.bool, device=device)


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
    """``run(impl) -> {name: array or text}`` under ``auto`` (kernels) and
    ``xla`` (plain): every output must be equal, and the named kernels must
    have launched under ``auto`` only."""
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
    got, want = outs
    if not all(np.array_equal(np.asarray(got[k]), np.asarray(want[k]))
               for k in want):
        raise AssertionError(f"{name}: kernel path and plain attention gave "
                             f"different tokens at temperature 0")
    shapes = ", ".join(f"{k} {list(np.shape(v))}" for k, v in got.items()
                       if not isinstance(v, str))
    log(f"[slice-small] {name} ({shapes}): kernel path "
        f"({', '.join(kernels)}) == plain attention, token-exact at "
        f"temperature 0")


def _pipe_outputs(out) -> dict:
    """A pipeline's ``(image, text, info)`` as the outputs to compare."""
    _, text, info = out
    return {"ids": info["ids"], "codes": info["codes"], "text": text}


def phase_small_slice() -> None:
    """The slice on small f32 models (head_dim 64): the kernel paths must
    give the same tokens as the plain attention at temperature 0."""
    import dataclasses
    import torch
    from mmada_parallel_torch import tokens as tk
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
        return _pipe_outputs(pipe("make the sky purple", _edit_image(32), 32,
                                  32, o, text_gen_length=16, seed=3,
                                  use_cache=use_cache))

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
        return _pipe_outputs(pipe("make the sky purple", _edit_image(32),
                                  mopts, seed=3, use_cache=use_cache))

    # (ii) exact and (iii) cached interleave (partial steps 6, 7, 10, 13, 14)
    _token_exact("exact interleave",
                 lambda impl: interleave(impl_cfg(mcfg, impl), False),
                 ["flash_attention_rope"])
    _token_exact("cached interleave",
                 lambda impl: interleave(impl_cfg(mcfg, impl), True),
                 ["flash_attention_rope_qonly"])


def _concurrently(server, requests) -> list:
    """Submit each ``(args, kwargs)`` request from its own thread; the
    results in order."""
    import threading
    out = [None] * len(requests)

    def call(i):
        a, kw = requests[i]
        out[i] = server.submit(*a, timeout=900, **kw)

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if any(o is None for o in out):
        raise AssertionError("a request got no result")
    return out


def _server_case(name: str, make_server, requests, solo, keys,
                 kernels) -> None:
    """One ragged batch of ``requests`` from concurrent threads, through
    ``make_server(impl)`` under the kernels (``auto``) and the plain
    attention (``xla``): the rows must agree on ``keys`` at temperature 0,
    and each must equal ``solo(request)``, its unpadded run on the kernel
    path."""
    import numpy as np
    outs, stats = {}, {}
    for impl in ("auto", "xla"):
        server = make_server(impl)
        reset_launches()
        try:
            outs[impl] = _concurrently(server, requests)
            stats[impl] = server.stats()
        finally:
            server.close()
        counts = read_launches()
        if impl == "auto" and not all(counts[k] > 0 for k in kernels):
            raise AssertionError(f"{name}: kernels {kernels} did not launch "
                                 f"({counts})")
        if impl == "xla" and any(counts.values()):
            raise AssertionError(f"{name}: the plain path launched kernels")
    for i, req in enumerate(requests):
        want = solo(req)
        for k in keys:
            if not (np.array_equal(outs["auto"][i][k], outs["xla"][i][k])
                    and np.array_equal(outs["auto"][i][k], want[k])):
                raise AssertionError(f"{name}: row {i} {k} differs between "
                                     f"the kernel batch, the plain batch and "
                                     f"the solo run")
    log(f"[slice-small] {name}: {len(requests)} ragged requests in "
        f"{stats['auto']['batches']} batch(es) of {kernels}: every row == "
        f"the plain attention's and == its solo run, token-exact")


def phase_small_new_paths() -> None:
    """Text-to-image (A exact and cached, M with padding masks),
    understanding (ragged) and the four servers on small f32 models
    (head_dim 64): the kernel path gives the plain attention's tokens at
    temperature 0, and every server row equals its unpadded solo run."""
    import dataclasses
    import numpy as np
    import torch
    from mmada_parallel_torch import serving as SV
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.samplers import image_gen as IG
    from mmada_parallel_torch.samplers import interleave as IL
    from mmada_parallel_torch.samplers import mmu as MU
    from mmada_parallel_torch.samplers import parallel_ti2ti as PT
    from mmada_parallel_torch.samplers import t2i as T2
    gen = torch.Generator(device="cuda").manual_seed(13)
    dev = torch.device("cuda")
    A, M = tk.TOKENS_A, tk.TOKENS_M
    acfg, aparams = _small_llada(gen, A.full_vocab_size)
    mcfg, mparams = _small_llada(gen, M.full_vocab_size)
    tok = StandInTokenizer()
    rng = np.random.default_rng(13)

    def on(c, impl):
        return dataclasses.replace(c, attention_impl=impl)

    def host(*ts):
        return [t.cpu().numpy() for t in ts]

    # variant-A text-to-image on a 4 x 4 grid: exact (K1), and cached with
    # partial steps 2, 3 and 5 of 6 (K2 on every step)
    cond, uncond = tk.make_t2i_prompt(T2I_PROMPT)
    ids, lay = tk.assemble_ti2ti_sequence(tok(cond)["input_ids"], 0, 4, 4,
                                          [])
    un = np.asarray(tok(uncond)["input_ids"], np.int64)
    iopts = IG.ImageGenOptions(timesteps=6, temperature=0.0, cfg_scale=2.0)
    for name, o, kernels in (
            ("t2i-a generate_image", iopts, ["flash_attention_rope"]),
            ("t2i-a generate_image_cached",
             dataclasses.replace(iopts, use_cache=True, cache_ratio=0.5,
                                 refresh_interval=3, warmup_ratio=0.3),
             ["flash_attention_rope_qonly"])):
        _token_exact(name, lambda impl, o=o: dict(zip(("ids", "codes"), host(
            *IG.generate_image(aparams, on(acfg, impl),
                               torch.as_tensor(ids, device=dev)[None], lay,
                               o, uncond_ids=un)))), kernels)

    # the servers: ragged requests in one bucket each
    a_prompts = [tok(T2I_PROMPT)["input_ids"], tok(T2I_PROMPT)["input_ids"][
        :40]]
    a_opts = PT.TI2TIOptions(text_steps=8, timesteps=4, temperature=0.0,
                             cfg_img=2.0)
    ui = np.asarray(a_prompts[0][:10], np.int64)
    serve = SV.ServeConfig(grid_hw=(4, 4), text_gen_length=16,
                           end_token_ids=(A.answer_end,), batch_size=2,
                           max_wait_ms=500.0)

    def a_solo(req):
        ids, lay = tk.assemble_ti2ti_sequence(req[0][0], 16, 4, 4,
                                              [A.answer_end])
        fin, codes = PT.generate_ti2ti(
            aparams, acfg, torch.as_tensor(ids, device=dev)[None], lay,
            a_opts, uncond_image_prefix=ui)
        fin, codes = host(fin[0], codes[0])
        return {"text_ids": fin[lay.text_start:lay.text_end],
                "codes": codes}

    _server_case("TI2TIServer", lambda impl: SV.TI2TIServer(
        aparams, on(acfg, impl), a_opts, serve, uncond_image_prefix=ui),
        [((p,), {}) for p in a_prompts], a_solo, ("text_ids", "codes"),
        ["flash_attention_rope"])

    m_opts = IL.InterleaveOptions(text_steps=8, image_steps=2,
                                  image_temperature=0.0)
    instrs = [tok(T2I_PROMPT)["input_ids"], tok(T2I_PROMPT)["input_ids"][:30]]
    m_codes = [rng.integers(0, M.codebook_size, 16) + M.vq_offset
               for _ in instrs]

    def m_solo(req):
        (instr,), kw = req
        instr = tk.normalize_text_ids(instr, M.bos, M.eos)
        head = [M.interleave, M.soi] + [int(c) for c in kw["codes"]] \
            + [M.eoi]
        un_head = [M.interleave, M.soi] + [0] * 16 + [M.eoi]
        un_tail = [M.bos, M.eos] + [M.eos] * (len(instr) - 2)
        ids, lay = tk.assemble_interleave_sequence(head + instr, 16, 16, M)
        un, _ = tk.assemble_interleave_sequence(un_head + un_tail, 16, 16, M)
        fin, codes = IL.interleave_generate(
            mparams, mcfg, torch.as_tensor(ids, device=dev)[None],
            torch.as_tensor(un, device=dev)[None], lay, m_opts)
        fin, codes = host(fin[0], codes[0])
        return {"text_ids": fin[lay.text_start:lay.text_end],
                "codes": codes}

    _server_case("InterleaveServer", lambda impl: SV.InterleaveServer(
        mparams, on(mcfg, impl), m_opts, num_vq_tokens=16, max_seq_length=16,
        batch_size=2, max_wait_ms=500.0, bucket_quantum=64),
        [((i,), {"codes": c}) for i, c in zip(instrs, m_codes)], m_solo,
        ("text_ids", "codes"), ["flash_attention_rope"])

    t_opts = T2.T2IOptions(timesteps=6, temperature=0.0, guidance_scale=1.5)

    def t2i_solo(req):
        temp = [M.t2i] + tk.normalize_text_ids(req[0][0], M.bos, M.eos)
        tail = [M.soi] + [M.mask] * 16 + [M.eoi]
        ids = torch.tensor([temp + tail], device=dev)
        un = torch.tensor([[M.ipad] * (len(temp) - 3) + [M.t2i, M.bos, M.eos]
                           + tail], device=dev)
        um = torch.ones_like(un, dtype=torch.bool)
        um[0, :len(temp) - 3] = False
        return {"codes": host(T2.t2i_generate(
            mparams, mcfg, ids, un, len(temp), 16, t_opts,
            torch.ones_like(um), um)[0])[0]}

    _server_case("T2IServer (t2i_generate with left-padding masks)",
                 lambda impl: SV.T2IServer(
                     mparams, on(mcfg, impl), t_opts, num_vq_tokens=16,
                     batch_size=2, max_wait_ms=500.0),
                 [((t,), {}) for t in _t2i_m_texts()], t2i_solo, ("codes",),
                 ["flash_attention_rope"])

    u_opts = MU.MMUOptions(max_new_tokens=16, steps=8, block_length=8)
    q = tk.normalize_text_ids(tok(MMU_QUESTION)["input_ids"], M.bos, M.eos,
                              append_eos_always=False)
    u_prompts = [[M.mmu, M.soi] + (rng.integers(0, M.codebook_size, 16)
                                   + M.vq_offset).tolist() + [M.eoi] + qq
                 for qq in (q, q[:20] + [M.eos])]

    def mmu_solo(req):
        p = req[0][0]
        out = MU.mmu_generate(mparams, mcfg,
                              torch.tensor([p], device=dev), u_opts)
        return {"text_ids": host(out[0, len(p):])[0]}

    _server_case("MMUServer (ragged mmu_generate)", lambda impl: SV.MMUServer(
        mparams, on(mcfg, impl), u_opts, batch_size=2, max_wait_ms=500.0,
        bucket_quantum=128), [((p,), {}) for p in u_prompts], mmu_solo,
        ("text_ids",), ["flash_attention_rope"])


def _a_train_batch(gen, rows: int, L: int):
    """``rows`` variant-A SFT rows of length ``L``: instruction text, the user
    image (32 x 32 codes with a newline after each row), then the answer:
    ``<answer_start><boi>``, the answer image masked by ``mask_codes``,
    ``<eoi>``, masked answer text, ``<answer_end>``.  Returns
    ``(ids, labels, lengths)`` on the generator's device."""
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.training.masking import mask_codes
    T = tk.TOKENS_A
    dev = gen.device

    def image(n_rows):
        codes = torch.randint(0, T.codebook_size, (n_rows, 32, 32),
                              generator=gen, device=dev) + T.text_vocab_size
        nl = torch.full((n_rows, 32, 1), T.newline, device=dev)
        return torch.cat([codes, nl], dim=2).reshape(n_rows, -1)

    def text(n_rows, n):
        return torch.randint(1000, 120000, (n_rows, n), generator=gen,
                             device=dev)

    def const(*ids):
        return torch.tensor(ids, device=dev).expand(rows, len(ids))

    ans_img, ans_img_lab = mask_codes(gen, image(rows), mask_token=T.mask)
    ans_txt, ans_txt_lab = mask_codes(gen, text(rows, 256),
                                      mask_token=T.mask)
    tail = [const(T.answer_start, T.boi), ans_img, const(T.eoi), ans_txt,
            const(T.answer_end)]
    head_len = L - sum(t.shape[1] for t in tail) - 1056 - 2
    head = [text(rows, head_len), const(T.boi), image(rows), const(T.eoi)]
    ids = torch.cat(head + tail, dim=1)
    ignore = [torch.full_like(t, -100) for t in head]
    labels = torch.cat(ignore + [torch.full_like(tail[0], -100), ans_img_lab,
                                 torch.full_like(tail[2], -100), ans_txt_lab,
                                 torch.full_like(tail[4], -100)], dim=1)
    assert ids.shape == (rows, L)
    return ids, labels, torch.full((rows,), L, device=dev)


def _train_a_steps(cfg, params, batch, n_steps: int, *, lr=2e-5, clip=4.0,
                   accum=2):
    """``n_steps`` steps of the A trainer's own step function on one batch;
    returns (state, step function, per-step metrics, per-step seconds,
    per-step launches, peak bytes)."""
    import torch
    from mmada_parallel_torch.cli.train_a import build_train_step
    state, step, _ = build_train_step(
        cfg, params, lr=lr, min_lr=0.0, wd=0.1, clip_grad=clip,
        warmup_steps=0, total_steps=100, accum_steps=accum)
    metrics, secs, launches = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(n_steps):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        launches.append(read_launches())
        metrics.append({k: float(v) for k, v in m.items()})
    return (state, step, metrics, secs, launches,
            torch.cuda.max_memory_allocated())


def phase_small_train() -> None:
    """Three A train steps (AdamW, clip, 2 microbatches, remat) on a small
    f32 model (head_dim 64): the kernel path's loss, grad norm and
    parameters equal the plain attention path's.  Tolerance: the kernel's
    f32 forward differs from the plain chain by summation order only
    (~1e-6 relative), so loss and grad norm agree to rtol 1e-4.  AdamW
    divides each gradient element by its own running magnitude, so an
    element whose gradient is near 0 (|g| ~ eps = 1e-8) moves by up to
    lr * g / (|g| + eps), and a 1e-10 change in it moves the parameter by
    ~1 % of lr: parameters are held to 5 % of one lr-sized step (atol 5e-5
    at lr 1e-3), against the ~3e-3 the 3 steps move them."""
    import dataclasses
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7)
    cfg = dataclasses.replace(_small_llada(gen, 2048)[0], remat="whole_layer")
    batch = (torch.randint(0, 2048, (4, 192), generator=gen, device="cuda"),)
    batch += (torch.where(torch.rand(4, 192, generator=gen, device="cuda")
                          < 0.3, batch[0], -100),
              torch.full((4,), 192, device="cuda"))
    runs = {}
    for impl in ("auto", "xla"):
        c = dataclasses.replace(cfg, attention_impl=impl)
        params = _small_llada(torch.Generator(device="cuda").manual_seed(8),
                              2048)[1]
        runs[impl] = _train_a_steps(c, params, batch, 3, lr=1e-3, clip=1.0)
    (sk, _, mk, _, lk, _), (sp, _, mp, _, lp, _) = runs["auto"], runs["xla"]
    # 2 layers x 2 microbatches x (forward + remat recompute)
    want = {n: 0 for n in KERNELS}
    want["flash_attention_rope"] = cfg.n_layers * 2 * 2
    if any(launches != want for launches in lk):
        raise AssertionError(f"small train: launches {lk}, expected {want} "
                             f"per step")
    if any(sum(x.values()) for x in lp):
        raise AssertionError("small train: the plain path launched kernels")
    for a, b in zip(mk, mp):
        for key in ("loss", "grad_norm"):
            if abs(a[key] - b[key]) > 1e-4 * abs(b[key]):
                raise AssertionError(f"small train: {key} {a[key]} (kernel) "
                                     f"vs {b[key]} (plain)")
    from mmada_parallel_torch.training.trainer import tree_leaves
    pk = [t.detach() for t in tree_leaves(sk.params)]
    pp = [t.detach() for t in tree_leaves(sp.params)]
    worst = max(float((x - y).abs().max()) for x, y in zip(pk, pp))
    moved = max(float((x - y).abs().max()) for x, y in zip(
        pk, tree_leaves(_small_llada(
            torch.Generator(device="cuda").manual_seed(8), 2048)[1])))
    if worst > 5e-5:
        raise AssertionError(f"small train: parameters differ after 3 "
                             f"steps, max |err| {worst:.3e} (atol 5e-5)")
    log(f"[train-small] 3 A steps, f32 head_dim 64, remat whole_layer, 2 "
        f"microbatches: losses {[round(m['loss'], 6) for m in mk]} (kernel) "
        f"vs {[round(m['loss'], 6) for m in mp]} (plain), grad norms "
        f"{[round(m['grad_norm'], 6) for m in mk]} vs "
        f"{[round(m['grad_norm'], 6) for m in mp]}, params max |err| "
        f"{worst:.3e} (they moved by up to {moved:.3e}); K1 "
        f"{want['flash_attention_rope']} launches per step")


# ---------------------------------------------------------------------------
# The M trainer (cli/train_m.py) and its data layer
# ---------------------------------------------------------------------------


def _m_samples(n: int, res: int) -> list:
    """``n`` decoded edit pairs as ``InterleavePairShardDataset`` gives
    them after the trainer's transform, without PIL: seeded uint8 images
    (``input_image``) and their [-1, 1] pixels, instructions and answers;
    the last sample text-only when ``n`` > 3."""
    import numpy as np
    rng = np.random.default_rng(15)
    out = []
    for i in range(n):
        img_in, img_out = (rng.integers(0, 256, (res, res, 3), dtype=np.uint8)
                           for _ in range(2))
        out.append({"input_image": img_in,
                    "pixels_in": img_in.astype(np.float32)[None] / 127.5 - 1,
                    "pixels_out": img_out.astype(np.float32)[None] / 127.5
                    - 1,
                    "instruction": f"edit {i}: {M_CLI_INSTR}",
                    "output_text": M_CLI_ANSWER if i % 2 else "done",
                    "is_text_only": n > 3 and i == n - 1})
    return out


def _m_cli_cfg(out_dir: str, steps: int, msl: int, n_vq: int, res: int,
               accum: int, **over):
    """The M trainer's config (``cli/train_m.DEFAULTS`` with the values of
    ``configs/train_m.yaml``: lr 1e-4, weight decay 0.01, clip 1.0, 500
    warmup steps of a cosine schedule, batch 1), cut to ``steps`` steps;
    ``over`` are further dotted overrides."""
    from mmada_parallel_torch.cli.train_m import DEFAULTS
    from mmada_parallel_torch.config import load_config
    args = {"output_dir": out_dir, "device": "cuda",
            "dataset.preprocessing.max_seq_length": msl,
            "dataset.preprocessing.resolution": res,
            "model.mmada.num_vq_tokens": n_vq,
            "training.lr": 1e-4, "training.weight_decay": 0.01,
            "training.max_grad_norm": 1.0, "training.warmup_steps": 500,
            "training.batch_size": 1,
            "training.gradient_accumulation_steps": accum,
            "training.max_train_steps": steps,
            "training.save_every": 1000000, "training.log_every": 1000000,
            **over}
    return load_config(None, [f"{k}={v}" for k, v in args.items()],
                       DEFAULTS)


def _counted_step(step):
    """``step`` with every launch count set to 0 just before each call and
    read just after it, timed up to a synchronize; returns ``(wrapper,
    [(launches, seconds) per call])``."""
    import torch
    records = []

    def counted(state, batch):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        out = step(state, batch)
        torch.cuda.synchronize()
        records.append((read_launches(), time.time() - t0))
        return out

    return counted, records


@contextlib.contextmanager
def _timed_assembly(times: list):
    """``train_m.assemble_batch`` (the loader's device work: two MagViT-v2
    encodes, the noising, the interleave rows) timed up to a synchronize
    while the context is open."""
    import torch
    from mmada_parallel_torch.cli import train_m as TM
    real = TM.assemble_batch

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        return out

    TM.assemble_batch = timed
    try:
        yield
    finally:
        TM.assemble_batch = real


def _small_m_models(impl: str, seed: int = 13):
    """The small f32 backbone (head_dim 64, the full M vocab, remat
    ``whole_layer``) and a narrow 13-bit MagViT-v2 (2 levels: scale 2), as
    ``train_m.Models`` with the stand-in tokenizer."""
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.cli.train_m import Models
    from mmada_parallel_torch.models import magvit2 as MVQ
    T = tk.TOKENS_M
    cfg, params = _small_llada(
        torch.Generator(device="cuda").manual_seed(seed), T.full_vocab_size,
        mask_token_id=T.mask, remat="whole_layer", attention_impl=impl)
    vcfg = MVQ.MagvitConfig(ch=16, enc_ch_mult=(1, 2), enc_blocks=(1, 1),
                            dec_ch_mult=(1, 2), dec_blocks=(1, 1),
                            z_channels=13, groups=4)
    vparams = MVQ.init_magvit_params(
        vcfg, torch.Generator(device="cuda").manual_seed(14))
    return Models(cfg, params, StandInTokenizerM(), vcfg, vparams)


def _train_m_run(cfg, models, samples, seed: int, state=None, mngr=None):
    """``train_m.train_loop`` from ``state`` (default: a fresh one from
    ``build_train_step``) with the noising generator seeded ``seed``;
    returns ``(state, history, [(launches, seconds) per step], step)``."""
    import torch
    from mmada_parallel_torch.cli import train_m as TM
    fresh, step, sched = TM.build_train_step(models.mcfg, models.params, cfg)
    counted, records = _counted_step(step)
    state, hist = TM.train_loop(
        cfg, fresh if state is None else state, counted, samples, models,
        sched, torch.Generator(device="cuda").manual_seed(seed), mngr=mngr)
    return state, hist, records, step


M_KEYS = ("loss", "text_loss", "image_loss", "grad_norm")


def phase_small_train_m() -> None:
    """The M trainer's loop (``cli/train_m.train_loop``) on a small f32
    model: 3 steps of 2 accumulated microbatches through K1 equal the plain
    attention's (loss, text and image losses, grad norm; rtol 1e-4 as the
    A steps of ``phase_small_train``); a checkpoint saved at step 2 and
    restored into other weights gives the straight run's step 3 (the same
    tolerance, and the A steps' 5e-5 on the parameters: the embedding's
    backward accumulates with atomics); then ``_validate_chat`` and
    ``_validate`` write their jsonl and PNG, with exact K1 counts."""
    import dataclasses
    import tempfile
    import torch
    from PIL import Image
    from mmada_parallel_torch.cli import train_m as TM
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    from mmada_parallel_torch.training.trainer import tree_leaves
    res, msl = 16, 16
    n_vq = (res // 2) ** 2
    samples = _m_samples(4, res)
    with tempfile.TemporaryDirectory() as tmp:
        fast = {"training.lr": 1e-3, "training.warmup_steps": 1}
        cfg = _m_cli_cfg(tmp, 3, msl, n_vq, res, accum=2, **fast)
        models = {impl: _small_m_models(impl) for impl in ("auto", "xla")}
        n_layers = models["auto"].mcfg.n_layers
        runs = {impl: _train_m_run(cfg, m, samples, 16)[1:3]
                for impl, m in models.items()}
        del models
        (hk, rk), (hp, rp) = runs["auto"], runs["xla"]
        want = {n: 0 for n in KERNELS}
        want["flash_attention_rope"] = n_layers * 2 * 2
        if [x for x, _ in rk] != [want] * 3 or any(
                sum(x.values()) for x, _ in rp):
            raise AssertionError(f"small train-m: launches {rk} (kernel), "
                                 f"{rp} (plain); expected {want} a step")
        for a, b in zip(hk, hp):
            for key in M_KEYS:
                if not abs(a[key] - b[key]) <= 1e-4 * abs(b[key]):
                    raise AssertionError(f"small train-m: {key} {a[key]} "
                                         f"(kernel) vs {b[key]} (plain)")
        # save at 2 -> restore into other weights -> step 3 == straight
        models = _small_m_models("auto")
        mngr = CheckpointManager(os.path.join(tmp, "ckpt"))
        state = _train_m_run(
            _m_cli_cfg(tmp, 2, msl, n_vq, res, accum=2,
                       **{"training.save_every": 2}, **fast),
            models, samples, 16, mngr=mngr)[0]
        state, hs = _train_m_run(cfg, models, samples, 17, state=state)[:2]
        other = dataclasses.replace(models, params=_small_m_models(
            "auto", seed=99).params)
        fresh, _, _ = TM.build_train_step(other.mcfg, other.params, cfg)
        restored, meta, last = mngr.restore(fresh)
        if last != 2 or meta != {"step": 2} or restored.step != 2:
            raise AssertionError(f"small train-m: restored step {last}, "
                                 f"metadata {meta}")
        restored, hr = _train_m_run(cfg, other, samples, 17,
                                    state=restored)[:2]
        for key in M_KEYS:
            if not abs(hr[0][key] - hs[0][key]) <= 1e-4 * abs(hs[0][key]):
                raise AssertionError(f"small train-m resume: {key} "
                                     f"{hr[0][key]} vs {hs[0][key]}")
        worst = max(float((x - y).detach().abs().max()) for x, y in zip(
            tree_leaves(restored.params), tree_leaves(state.params)))
        if worst > 5e-5:
            raise AssertionError(f"small train-m resume: parameters differ "
                                 f"from the straight run by {worst:.3e}")
        # the chat and interleave validators on the trained state
        jl = os.path.join(tmp, "chat.jsonl")
        with open(jl, "w") as f:
            for q in ("what is in the image?", "describe the sky"):
                f.write(json.dumps({"question": q}) + "\n")
        vcfg = _m_cli_cfg(tmp, 3, msl, n_vq, res, accum=2, **{
            "dataset.params.lm_chat_validation_jsonl": jl})
        tok = models.tokenizer
        reset_launches()
        TM._validate_chat(state.params, models.mcfg, tok, vcfg, 3)
        torch.cuda.synchronize()
        chat = check_launches("small _validate_chat", {
            "flash_attention_rope": n_layers * (msl // 2)})
        reset_launches()
        TM._validate(state.params, models.mcfg, models.vq_params,
                     models.vq_cfg, tok, samples[0], vcfg, 3)
        torch.cuda.synchronize()
        inter = check_launches("small _validate", {
            "flash_attention_rope": n_layers * 32})
        out = os.path.join(tmp, "validation")
        with open(os.path.join(out, "chat_step0000003.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        png = Image.open(os.path.join(out, "step0000003.png"))
        with open(os.path.join(out, "step0000003.txt")) as f:
            text = f.read()
        if [r["question"] for r in rows] != ["what is in the image?",
                                             "describe the sky"] \
                or not all(isinstance(r["response"], str) for r in rows) \
                or png.size != (res, res) or not text:
            raise AssertionError(f"small train-m validators: rows {rows}, "
                                 f"png {png.size}, text {text!r}")
    log(f"[train-m-small] cli/train_m.train_loop, f32 head_dim 64, full M "
        f"vocab, remat whole_layer, 2 microbatches x L="
        f"{2 * n_vq + 2 * msl + 5}: losses "
        f"{[round(h['loss'], 6) for h in hk]} (kernel) vs "
        f"{[round(h['loss'], 6) for h in hp]} (plain), text "
        f"{[round(h['text_loss'], 6) for h in hk]} vs "
        f"{[round(h['text_loss'], 6) for h in hp]}, image "
        f"{[round(h['image_loss'], 6) for h in hk]} vs "
        f"{[round(h['image_loss'], 6) for h in hp]}, grad norms "
        f"{[round(h['grad_norm'], 6) for h in hk]} vs "
        f"{[round(h['grad_norm'], 6) for h in hp]}; K1 "
        f"{want['flash_attention_rope']} a step")
    log(f"[train-m-small] checkpoint at step 2 restored into other weights: "
        f"step 3 loss {hr[0]['loss']:.6f} vs {hs[0]['loss']:.6f} straight, "
        f"params max |err| {worst:.3e}; _validate_chat {len(rows)} rows "
        f"(K1 {chat['flash_attention_rope']}), _validate PNG {png.size} + "
        f"{len(text.split())} text tokens (K1 "
        f"{inter['flash_attention_rope']})")


def phase_shards() -> None:
    """The M trainer's readers on the card's host: a tar shard of 64 edit
    pairs (two 256 KiB raw payloads and two texts each, written here with
    ``tarfile``, no PIL) read by ``ShardReader`` through the native reader
    (``g++`` into ``_build/``) and through ``tarfile``, equal sample for
    sample, each timed (best of 3); a token store of 200 records written and
    gathered back bit for bit."""
    import io
    import tarfile
    import tempfile
    import numpy as np
    from mmada_parallel_torch.data import shards, tarstream, tokenstore
    t0 = time.time()
    if not tarstream.native_available():
        raise AssertionError(f"shards: the native tar reader did not build "
                             f"({tarstream._LIB_ERR})")
    build_s = time.time() - t0
    rng = np.random.default_rng(17)
    n, blob = 64, 256 << 10
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pairs-000.tar")
        with tarfile.open(path, "w") as tf:
            for i in range(n):
                for name, payload in (
                        (f"p{i:03d}.input.jpg", rng.bytes(blob)),
                        (f"p{i:03d}.output.jpg", rng.bytes(blob)),
                        (f"p{i:03d}.input_text.txt", f"edit {i}".encode()),
                        (f"p{i:03d}.output_text.txt", b"done " * i)):
                    info = tarfile.TarInfo(name)
                    info.size = len(payload)
                    tf.addfile(info, io.BytesIO(payload))
        mb = os.path.getsize(path) / 2 ** 20
        secs = {}
        for native in (True, False):
            best = None
            for _ in range(3):
                t0 = time.time()
                got = list(shards.ShardReader([path], use_native=native))
                dt = time.time() - t0
                best = dt if best is None else min(best, dt)
            secs[native] = (best, got)
        if secs[True][1] != secs[False][1] or len(secs[True][1]) != n:
            raise AssertionError("shards: the native reader's samples differ "
                                 "from tarfile's")
        recs = [rng.integers(0, 134656, rng.integers(1, 3000)).tolist()
                for _ in range(200)]
        store = os.path.join(tmp, "train.tokstore")
        tokenstore.write_token_store(store, recs)
        ts = tokenstore.TokenStore(store)
        rows, lens = ts.gather(list(range(200)), max_len=3000, pad=-1)
        ts.close()
        if lens.tolist() != [len(r) for r in recs] or any(
                rows[i, :len(r)].tolist() != r or (rows[i, len(r):] != -1)
                .any() for i, r in enumerate(recs)):
            raise AssertionError("shards: token store gather differs")
    (tn, _), (tp, _) = secs[True], secs[False]
    log(f"[shards] native tar reader built in {build_s:.2f} s; {n} pairs, "
        f"{mb:.1f} MiB: native {n / tn:.0f} samples/s ({mb / tn:.0f} MiB/s),"
        f" tarfile {n / tp:.0f} samples/s ({mb / tp:.0f} MiB/s), equal "
        f"sample for sample; token store: 200 records gathered bit-exact")


@contextlib.contextmanager
def _exact_int8_product():
    """The W8A8 path's int8 GEMM replaced by an exact product of the same
    int8 operands: f64 on the card (every partial sum is an integer below
    2^53), cast to int32."""
    import torch
    from mmada_parallel_torch.ops import quant as Q
    real = Q._int8_mm
    Q._int8_mm = lambda x_q, w_q: (x_q.double() @ w_q.double()).to(
        torch.int32)
    try:
        yield
    finally:
        Q._int8_mm = real


def _rl_close(name: str, a: dict, b: dict, rtol_loss: float,
              rtol_norm: float) -> None:
    """A ParaRL update's metrics, kernel path ``a`` against plain ``b``: the
    loss is a mean of advantage-weighted log-probs that nearly cancel
    against the mean-reward baseline, so it is held to ``rtol_loss`` of its
    terms' size (|advantage| x |trajectory log-prob|); the gradient norm to
    ``rtol_norm``."""
    terms = a["adv_max"] * abs(b["traj_logp"])
    if abs(a["loss"] - b["loss"]) > rtol_loss * terms:
        raise AssertionError(f"{name}: loss {a['loss']} (kernel) vs "
                             f"{b['loss']} (plain), terms {terms:.3e}, rtol "
                             f"{rtol_loss}")
    if abs(a["grad_norm"] - b["grad_norm"]) > rtol_norm * abs(b["grad_norm"]):
        raise AssertionError(f"{name}: grad norm {a['grad_norm']} (kernel) "
                             f"vs {b['grad_norm']} (plain), rtol {rtol_norm}")


def _rl_metrics(m: dict, rewards) -> dict:
    out = {k: float(v) for k, v in m.items()}
    out["adv_max"] = float((rewards - rewards.mean()).abs().max())
    return out


def phase_small_eval() -> None:
    """The evaluation slice on small f32 models (head_dim 64): the ParaBench
    edit sweep (two prompt-length buckets, a short last chunk) and the
    cached interleave sweep give the plain attention's rows, token-exact at
    temperature 0 (K1, K2); the W8A8 edit likewise (K1 with the int8 GEMMs
    on both sides); and three ParaRL updates on one recorded trajectory
    give the plain path's loss and gradient norm (f32: rtol 1e-4 of the
    loss's terms and of the norm), with exactly layers x scored steps K1
    launches an update (the Function's backward launches nothing)."""
    import dataclasses
    import numpy as np
    import torch
    from mmada_parallel_torch import evaluation as EV
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.cli import train_pararl as RL
    from mmada_parallel_torch.models import llada as L
    from mmada_parallel_torch.ops.quant import quantize_llada_params
    from mmada_parallel_torch.samplers import interleave as IL
    from mmada_parallel_torch.samplers import parallel_ti2ti as PT
    from mmada_parallel_torch.training.pararl import rollout_ti2ti
    from mmada_parallel_torch.training.trainer import tree_map
    gen = torch.Generator(device="cuda").manual_seed(17)
    dev = torch.device("cuda")
    A, M = tk.TOKENS_A, tk.TOKENS_M
    acfg, aparams = _small_llada(gen, A.full_vocab_size)
    mcfg, mparams = _small_llada(gen, M.full_vocab_size)
    ids = StandInTokenizer()(T2I_PROMPT)["input_ids"]
    rng = np.random.default_rng(17)

    def on(c, impl):
        return dataclasses.replace(c, attention_impl=impl)

    # prompts of 50, 30 and 89 ids: buckets 64 (a chunk of 2) and 128 (a
    # chunk of 1, padded to 2)
    prompts = [ids, ids[:30], ids + ids[1:40]]
    opts = PT.TI2TIOptions(text_steps=8, timesteps=4, temperature=0.0,
                           text_temperature=0.0, cfg_img=2.0)
    ui = np.asarray(ids[:10], np.int64)

    def sweep(impl):
        out = EV.run_parabench_sweep(
            aparams, on(acfg, impl), [EV.EvalRequest(p) for p in prompts],
            (4, 4), 16, [A.answer_end], opts, batch_size=2,
            uncond_image_prefix=ui, seed=5)
        return {f"{k}{r['index']}": np.asarray(r[k])
                for r in out["results"] for k in ("text", "codes")}

    _token_exact("ParaBench edit sweep", sweep, ["flash_attention_rope"])

    m_opts = IL.InterleaveOptions(text_steps=16, image_steps=4,
                                  image_temperature=0.0)
    reqs = [EV.InterleaveEvalRequest(
        instr, codes=rng.integers(0, M.codebook_size, 16) + M.vq_offset)
        for instr in (ids[:30], ids[10:40])]

    def interleave_sweep(impl):
        out = EV.run_interleave_sweep(
            mparams, on(mcfg, impl), reqs, num_vq_tokens=16, opts=m_opts,
            max_seq_length=16, batch_size=2, use_cache=True)
        return {f"{k}{r['index']}": np.asarray(r[k])
                for r in out["results"] for k in ("text_ids", "codes")}

    _token_exact("cached interleave sweep", interleave_sweep,
                 ["flash_attention_rope_qonly"])

    # W8A8: the card's int8 GEMM inside the whole edit against an exact
    # product of the same int8 operands (f64, exact below 2^53), K1 on both
    # sides: token-exact.  Across the attention paths the edit cannot be:
    # the activation quantization rounds to int8, and a summation-order
    # difference of ~1e-7 that straddles a rounding boundary moves a value
    # by one quantum and the trajectory parts, so there one forward's
    # logits are held to 1e-2 of their largest and the token agreement is
    # printed.
    qparams = quantize_llada_params(aparams)
    seq, lay = tk.assemble_ti2ti_sequence(prompts[0], 16, 4, 4,
                                          [A.answer_end])
    seq_t = torch.as_tensor(seq, device=dev)[None]

    def int8_edit(impl):
        fin, codes = PT.generate_ti2ti(qparams, on(acfg, impl), seq_t, lay,
                                       opts, uncond_image_prefix=ui)
        return fin.cpu().numpy(), codes.cpu().numpy()

    reset_launches()
    fin_k, codes_k = int8_edit("auto")
    if read_launches()["flash_attention_rope"] == 0:
        raise AssertionError("W8A8 edit: K1 did not launch")
    with _exact_int8_product():
        fin_e, codes_e = int8_edit("auto")
    if not (np.array_equal(fin_k, fin_e) and np.array_equal(codes_k,
                                                             codes_e)):
        raise AssertionError("W8A8 edit: torch._int_mm and the exact int8 "
                             "product gave different tokens")
    fin_p, codes_p = int8_edit("xla")
    with torch.inference_mode():
        lk, lp = (L.llada_forward(qparams, on(acfg, impl), seq_t)
                  for impl in ("auto", "xla"))
        dlogit = float((lk - lp).abs().max())
        top = float(lp.abs().max())
    if dlogit > 1e-2 * top:
        raise AssertionError(f"W8A8 forward: K1 vs plain attention max "
                             f"|dlogit| {dlogit:.3e}, max |logit| {top:.3e}")
    gen_pos = np.r_[lay.text_start:lay.text_end, lay.image_positions()]
    log(f"[slice-small] W8A8 edit ({lay.total_len} tokens, int8 GEMMs via "
        f"torch._int_mm): == the exact int8 product, token-exact, K1 on both;"
        f" K1 vs plain attention: one forward's max |dlogit| {dlogit:.3e} "
        f"(max |logit| {top:.3e}, limit 1e-2 of it), generated tokens equal "
        f"{100 * float((fin_k[0, gen_pos] == fin_p[0, gen_pos]).mean()):.1f}"
        f" %, codes equal {100 * float((codes_k == codes_p).mean()):.1f} %")
    del qparams

    rl_opts = PT.TI2TIOptions(text_steps=8, timesteps=4, temperature=1.0,
                              text_temperature=0.7, cfg_img=0.0)
    seqs, rl_lay = RL.rollout_sequences([ids, ids[:30]], A, 4, 16)
    _, traj = rollout_ti2ti(aparams, acfg, torch.as_tensor(seqs, device=dev),
                            rl_lay, rl_opts,
                            torch.Generator(device="cuda").manual_seed(3))
    # fixed rewards: the advantage is +-0.5 whatever the rollout drew
    rewards = torch.tensor([0.0, 1.0], device=dev)
    sub = RL.subsample_steps(rl_opts.text_steps, 4)
    runs = {}
    for impl in ("auto", "xla"):
        state, step = RL.build_update(
            on(acfg, impl), tree_map(lambda t: t.clone(), aparams), rl_opts,
            1e-3, sub)
        runs[impl] = []
        for _ in range(3):
            reset_launches()
            state, m = step(state, (traj, rewards))
            runs[impl].append((_rl_metrics(m, rewards), read_launches()))
    want = {n: 0 for n in KERNELS}
    want["flash_attention_rope"] = acfg.n_layers * len(sub)
    for (a, la), (b, lb) in zip(runs["auto"], runs["xla"]):
        if la != want or any(lb.values()):
            raise AssertionError(f"small ParaRL: launches {la} (kernel), "
                                 f"{lb} (plain), expected {want}")
        _rl_close("small ParaRL", a, b, 1e-4, 1e-4)
    log(f"[slice-small] ParaRL: 3 updates on one recorded trajectory (B=2, "
        f"{len(sub)} of {rl_opts.text_steps} steps scored): losses "
        f"{[round(a['loss'], 6) for a, _ in runs['auto']]} (kernel) vs "
        f"{[round(b['loss'], 6) for b, _ in runs['xla']]} (plain), grad "
        f"norms {[round(a['grad_norm'], 6) for a, _ in runs['auto']]} vs "
        f"{[round(b['grad_norm'], 6) for b, _ in runs['xla']]}; K1 "
        f"{want['flash_attention_rope']} launches per update")


# ---------------------------------------------------------------------------
# Profile: where a step's device time goes
# ---------------------------------------------------------------------------

# kernel classes by (lowercased) kernel name, first match wins.  TF32 is off,
# so an f32 GEMM runs on the FMA pipes (``sgemm``, ``f32f32`` kernels) and a
# tensor-core GEMM (``nvjet``, other ``gemm``) takes bf16 operands.
_KERNEL_CLASSES = (
    ("attention kernels K1-K4", ("attention_kernel", "attention_mma_kernel",
                                 "split_combine_kernel",
                                 "rope_rotate_kernel")),
    ("f32 GEMMs (FMA)", ("sgemm", "f32f32")),
    ("int8 tensor-core GEMMs", ("s8s8", "i8i8", "imma", "int8", "_s8_")),
    ("bf16 tensor-core GEMMs", ("nvjet", "gemm")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("elementwise, copies, other", ("",)),
)


def _profile(phase: str, fn, top: int = 6, ranges=()) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA activity):
    prints its device time by kernel class and its largest kernels, and the
    device's idle share between its first and last kernel; with ``ranges``,
    also the device time of the kernels launched inside each named
    ``record_function`` range.  Returns ``{class: ms}``.  Fails if no kernel
    was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation
               and e.time_range.end > e.time_range.start]
    if not kernels:
        raise AssertionError(f"profile {phase}: no device time recorded")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:                  # union of the kernel intervals
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    first, last = spans[0][0], max(b for _, b in spans)
    per_class = {name: 0.0 for name, _ in _KERNEL_CLASSES}
    per_kernel = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        low = e.name.lower()
        cls = next(name for name, keys in _KERNEL_CLASSES
                   if any(k in low for k in keys))
        per_class[cls] += us / 1e3
        n, t = per_kernel.get(e.name, (0, 0.0))
        per_kernel[e.name] = (n + 1, t + us / 1e3)
    total = sum(per_class.values())
    log(f"[profile {phase}] one step, profiler on: host wall "
        f"{wall * 1e3:.1f} ms; kernels {total:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms of the {(last - first) / 1e3:.1f} ms from the "
        f"first kernel to the last (idle "
        f"{100 * (1 - busy / (last - first)):.2f} %)")
    log(f"[profile {phase}] by class: " + "; ".join(
        f"{name} {ms:.1f} ms ({100 * ms / total:.1f} %)"
        for name, ms in sorted(per_class.items(), key=lambda x: -x[1])
        if ms > 0))
    for name, (n, ms) in sorted(per_kernel.items(),
                                key=lambda x: -x[1][1])[:top]:
        log(f"[profile {phase}]   {ms:9.1f} ms {100 * ms / total:5.1f} % "
            f"x{n:<4d} {name[:110]}")
    if ranges:
        in_range = {r: [e for e in prof.events() if e.name == r
                        and e.device_type != torch.autograd.DeviceType.CUDA]
                    for r in ranges}
        log(f"[profile {phase}] by range (device time of the kernels each "
            f"launched): " + "; ".join(
                f"{r} {sum(e.device_time_total for e in es) / 1e3:.1f} ms "
                f"({100 * sum(e.device_time_total for e in es) / 1e3 / total:.1f}"
                f" %, x{len(es)})" for r, es in in_range.items()))
    return per_class


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
    # the same edit once more under the profiler: where its device time goes
    _profile("edit", lambda: _a_pipe(full)(
        "make the sky purple", _edit_image(512), 512, 512, opts,
        text_gen_length=256, seed=1))
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
    # the same cached edit once more under the profiler
    _profile("cached-edit", lambda: _a_pipe(full)(
        "make the sky purple", _edit_image(512), 512, 512, opts,
        text_gen_length=256, seed=1, use_cache=True))
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


def _m_pipe(full):
    from mmada_parallel_torch.pipeline import InterleavePipeline
    return InterleavePipeline(full["cfg"], full["params"], full["mcfg"],
                              full["mparams"], StandInTokenizer(),
                              num_vq_tokens=1024, max_seq_length=256,
                              resolution=512)


def _m_pixels(full, codes):
    """MagViT decode of ``[n, 1024]`` codes -> ``[n, 512, 512, 3]`` in
    [0, 1], checked like the A pixels."""
    import numpy as np
    codes = np.asarray(codes)
    if codes.min() < 0 or codes.max() >= 8192:
        raise AssertionError(f"codes out of range [{codes.min()}, "
                             f"{codes.max()}]")
    px = _m_pipe(full).decode_codes_to_pixels(codes)
    if not np.isfinite(px).all():
        raise AssertionError("decoded pixels are not finite")
    return px


@contextlib.contextmanager
def _k1_biases():
    """Records, for each K1 launch in the block (on any thread), whether it
    got a bias."""
    from mmada_parallel_torch.ops import attention as A
    real = A.flash_attention_rope
    seen = []

    def recording(q, k, v, sin, cos, bias=None, **kw):
        seen.append(bias is not None)
        return real(q, k, v, sin, cos, bias, **kw)

    A.flash_attention_rope = recording
    try:
        yield seen
    finally:
        A.flash_attention_rope = real


def _served(phase: str, server, requests, expected: dict, biased=False,
            alone=True):
    """``requests`` from concurrent threads as one ragged batch, launch
    counts held to ``expected`` (and every K1 launch to a bias when
    ``biased``); then, with ``alone`` (a deterministic server), each request
    alone, which must give its row of the batch bit for bit: the batch has
    the same shape, and a row's result does not depend on what it was
    batched with.  Returns (results, wall s, peak bytes)."""
    import numpy as np
    try:
        with _k1_biases() as seen:
            out, wall, peak = _timed_run(
                lambda: _concurrently(server, requests))
            launches = check_launches(phase, expected)
        stats = server.stats()
        if stats["batches"] != 1 or stats["requests"] != len(requests):
            raise AssertionError(f"{phase}: {stats}, expected one batch")
        if biased and not (seen and all(seen)):
            raise AssertionError(f"{phase}: a K1 launch had no bias")
        for i, req in enumerate(requests if alone else ()):
            solo = _concurrently(server, [req])[0]
            for k, v in out[i].items():
                if not np.array_equal(np.asarray(v), np.asarray(solo[k])):
                    raise AssertionError(f"{phase}: request {i} alone gave "
                                         f"another {k} than its batch row")
    finally:
        server.close()
    log(f"[{phase}] {len(requests)} requests from {len(requests)} threads "
        f"in one batch"
        + (": each got its own row (== the request served alone)"
           if alone else "")
        + f"; kernel launches {launches}"
        + (", every K1 launch with the padding bias" if biased else ""))
    return out, wall, peak


def phase_t2i_a(full) -> None:
    """Variant-A text-to-image at full width: 512x512 (1024 codes), 18
    MaskGit steps, cfg_scale 4.0 with the uncond prefix, temperature 1.0:
    a B=1 cond and a B=1 uncond forward a step (K1)."""
    import torch
    from mmada_parallel_torch.samplers.image_gen import (ImageGenOptions,
                                                         generate_image)
    cfg = full["cfg"]
    ids, layout, un = _t2i_a_request()
    opts = ImageGenOptions(timesteps=18, temperature=1.0, cfg_scale=4.0)
    x = torch.as_tensor(ids, device="cuda")[None]
    gen = torch.Generator(device="cuda").manual_seed(1)
    (fin, codes), wall, peak = _timed_run(lambda: generate_image(
        full["params"], cfg, x, layout, opts, uncond_ids=un, generator=gen))
    launches = check_launches("t2i-a", {
        "flash_attention_rope": cfg.n_layers * opts.timesteps * 2})
    codes = codes.cpu().numpy()
    _check_image("t2i-a", codes, _a_pipe(full).decode_vq_to_pixels(
        codes, 512, 512))
    if (fin[0, layout.image_positions()] == opts.mask_token).any():
        raise AssertionError("t2i-a: masked image slots left")
    n = 2 * opts.timesteps
    log(f"[t2i-a] generate_image 512x512, cond seq {len(ids)}, uncond seq "
        f"{len(un) + len(ids) - layout.code_start}, {opts.timesteps} steps, "
        f"cfg_scale {opts.cfg_scale}: codes in [{codes.min()}, "
        f"{codes.max()}], pixels finite; wall {wall:.2f} s, {n} forwards "
        f"(B=1) = {n / wall:.2f} forwards/s, kernel launches {launches}, "
        f"peak memory {peak / 2 ** 30:.2f} GiB")


def phase_t2i_a_cached(full) -> None:
    """The same text-to-image through the feature-cached sampler at the
    option defaults (cache_ratio 0.9, refresh 5, warmup 0.3): every forward,
    full or partial, runs K2; profiled once."""
    import torch
    from mmada_parallel_torch.samplers.image_gen import (
        ImageGenOptions, generate_image_cached, image_refresh_schedule)
    cfg = full["cfg"]
    ids, layout, un = _t2i_a_request()
    opts = ImageGenOptions(timesteps=18, temperature=1.0, cfg_scale=4.0,
                           use_cache=True)
    refresh = image_refresh_schedule(opts.timesteps, opts.refresh_interval,
                                     opts.warmup_ratio)
    x = torch.as_tensor(ids, device="cuda")[None]

    def run():
        return generate_image_cached(
            full["params"], cfg, x, layout, opts, uncond_ids=un,
            generator=torch.Generator(device="cuda").manual_seed(1))

    (_, codes), wall, peak = _timed_run(run)
    launches = check_launches("t2i-a-cached", {
        "flash_attention_rope_qonly": cfg.n_layers * opts.timesteps * 2})
    codes = codes.cpu().numpy()
    _check_image("t2i-a-cached", codes, _a_pipe(full).decode_vq_to_pixels(
        codes, 512, 512))
    n_full = int(refresh.sum())
    log(f"[t2i-a-cached] generate_image_cached 512x512, {opts.timesteps} "
        f"steps ({n_full} full + {opts.timesteps - n_full} partial of "
        f"{T2I_A_PARTIAL} slots), cond + uncond: codes in [{codes.min()}, "
        f"{codes.max()}]; wall {wall:.2f} s, {2 * opts.timesteps} forwards = "
        f"{2 * opts.timesteps / wall:.2f} forwards/s, kernel launches "
        f"{launches}, peak memory {peak / 2 ** 30:.2f} GiB")
    _profile("t2i-a-cached", run)


def phase_t2i_m(full) -> None:
    """Variant-M text-to-image through ``T2IServer`` at full width: two
    texts of different lengths in one bucket (B=2 rows, cond + uncond = 4),
    18 steps, guidance 3.5, temperature 1.0; K1 with the padding bias on
    every launch."""
    from mmada_parallel_torch.samplers.t2i import T2IOptions
    from mmada_parallel_torch.serving import T2IServer
    cfg = full["cfg"]
    opts = T2IOptions(timesteps=18, guidance_scale=3.5)
    server = T2IServer(full["params"], cfg, opts, num_vq_tokens=1024,
                       batch_size=2, max_wait_ms=500.0, seed=1)
    texts = _t2i_m_texts()
    out, wall, peak = _served(
        "t2i-m", server, [((t,), {}) for t in texts],
        {"flash_attention_rope": cfg.n_layers * opts.timesteps}, biased=True,
        alone=False)
    codes = [r["codes"] for r in out]
    _m_pixels(full, codes)
    L = _t2i_m_mask("cpu").shape[1]
    log(f"[t2i-m] T2IServer, texts of {[len(t) for t in texts]} ids, bucket "
        f"seq {L}, {opts.timesteps} steps B=4, guidance "
        f"{opts.guidance_scale}: codes {[c.shape for c in codes]} in range, "
        f"pixels finite; wall {wall:.2f} s, {opts.timesteps / wall:.2f} "
        f"forwards/s, peak memory {peak / 2 ** 30:.2f} GiB")


def phase_mmu(full) -> None:
    """Understanding through ``MMUServer`` at full width: two ragged
    prompts of 1024 image codes and a question, 128 new tokens in blocks of
    32, 32 steps (K1 with the padding bias); then ``mmu_generate_fast``
    alone with an ``eot`` (8 K1 forwards per block it runs)."""
    import numpy as np
    import torch
    from mmada_parallel_torch.samplers.mmu import (MMUOptions,
                                                   mmu_generate_fast)
    from mmada_parallel_torch.serving import MMUServer
    cfg = full["cfg"]
    opts = MMUOptions(max_new_tokens=MMU_NEW, steps=32, block_length=32)
    prompts = _mmu_prompts()
    server = MMUServer(full["params"], cfg, opts, batch_size=2,
                       max_wait_ms=500.0)
    out, wall, peak = _served(
        "mmu", server, [((p,), {}) for p in prompts],
        {"flash_attention_rope": cfg.n_layers * opts.steps}, biased=True,
        alone=False)
    answers = [r["text_ids"] for r in out]
    if any((a == opts.mask_token).any() or a.shape != (MMU_NEW,)
           for a in answers):
        raise AssertionError("mmu: an answer kept a mask or has a wrong "
                             "length")
    L = _mmu_mask("cpu").shape[1]
    log(f"[mmu] MMUServer, prompts of {[len(p) for p in prompts]} tokens, "
        f"seq {L}, {opts.steps} steps B=2: wall {wall:.2f} s, "
        f"{opts.steps / wall:.2f} forwards/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    # the token that ends the first block of row 0's answer as eot
    eot = int(answers[0][opts.block_length - 1])
    P = len(prompts[0])
    x, wall, peak = _timed_run(lambda: mmu_generate_fast(
        full["params"], cfg, torch.tensor([prompts[0]], device="cuda"), opts,
        eot_token=eot))
    ans = x[0, P:].reshape(-1, opts.block_length).cpu().numpy()
    blocks = int((ans != opts.mask_token).all(axis=1).sum())
    if not (ans[blocks:] == opts.mask_token).all():
        raise AssertionError("mmu-fast: a block after the exit was written")
    spb = opts.steps // (MMU_NEW // opts.block_length)
    launches = check_launches("mmu-fast", {
        "flash_attention_rope": cfg.n_layers * spb * blocks})
    same = np.array_equal(ans[:blocks].reshape(-1),
                          answers[0][:blocks * opts.block_length])
    log(f"[mmu-fast] mmu_generate_fast alone, eot {eot}: stopped after "
        f"{blocks} of {MMU_NEW // opts.block_length} blocks, kernel launches "
        f"{launches}; wall {wall:.2f} s, {spb * blocks / wall:.2f} "
        f"forwards/s, peak memory {peak / 2 ** 30:.2f} GiB; answer == the "
        f"server's row 0 up to the exit: {same}")


def phase_stepwise(full) -> None:
    """The streaming demo (``cli/demo.run_stream``) on the A edit at 16
    text steps (the demo's knobs: image CFG 4.0 only, 4 image steps), its
    frames written to a temporary directory."""
    import tempfile
    import numpy as np
    from mmada_parallel_torch.cli import demo
    cfg = full["cfg"]
    steps = 16
    opts, _ = demo.knobs_to_options(steps, 0.0, 4.0, 1.0, 0.7,
                                    "low_confidence", None, 0.5, 0.5)
    # generate_ti2ti_stepwise's schedule at image_step_fraction 0.3
    img_steps = set(np.round(np.linspace(0, steps - 1, max(int(steps * 0.3),
                                                           1)))
                    .astype(int).tolist())
    want_frames = [s + 1 for s in range(steps)
                   if s in img_steps or s % 5 == 0 or s == steps - 1]
    seen = []
    with tempfile.TemporaryDirectory() as out_dir:
        (text, preview), wall, peak = _timed_run(lambda: demo.run_stream(
            _a_pipe(full), "make the sky purple", _edit_image(512), 512, 512,
            opts, 256, 1, out_dir, on_frame=lambda s, t, p, r: seen.append(s)))
        files = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
        with open(os.path.join(out_dir, "status.jsonl")) as f:
            records = [json.loads(line) for line in f]
    launches = check_launches("stepwise", {
        "flash_attention_rope": cfg.n_layers * (steps + len(img_steps))})
    if seen != want_frames or len(files) != len(want_frames) \
            or [r["step"] for r in records] != want_frames:
        raise AssertionError(f"stepwise: frames {seen}, files {files}, "
                             f"expected steps {want_frames}")
    if preview.size != (512, 512):
        raise AssertionError("stepwise: preview is not 512x512")
    log(f"[stepwise] run_stream A edit, {steps} text steps + "
        f"{len(img_steps)} image steps: {len(files)} frames at steps "
        f"{seen}, last {records[-1]['image_masked_pct']} % masked; wall "
        f"{wall:.2f} s, {(steps + len(img_steps)) / wall:.2f} forwards/s "
        f"(frames included), kernel launches {launches}, peak memory "
        f"{peak / 2 ** 30:.2f} GiB")


def phase_serve_a(full) -> None:
    """``TI2TIServer`` at full width: two ragged edit requests (the 512x512
    image's span, texts of 50 and 30 ids) from two threads in one bucket,
    8 text and 4 image steps, temperature 0."""
    import numpy as np
    from mmada_parallel_torch.ops import sampling as S
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    from mmada_parallel_torch.serving import ServeConfig, TI2TIServer
    cfg = full["cfg"]
    opts = TI2TIOptions(text_steps=8, timesteps=4, temperature=0.0,
                        text_temperature=0.0, cfg_img=4.0)
    ids = StandInTokenizer()("make the sky purple")["input_ids"]
    span = _a_pipe(full).encode_img_with_breaks(_edit_image(512))
    prompts = [ids[:-1] + span + ids[-1:], ids[:29] + span + ids[-1:]]
    server = TI2TIServer(full["params"], cfg, opts, ServeConfig(
        batch_size=2, max_wait_ms=500.0, bucket_quantum=128,
        max_prompt_len=2048), uncond_image_prefix=np.asarray(ids))
    n_img = int(S.image_step_mask(opts.text_steps, opts.timesteps).sum())
    out, wall, peak = _served(
        "serve-a", server, [((p,), {}) for p in prompts],
        {"flash_attention_rope": cfg.n_layers * (opts.text_steps + n_img)},
        biased=True)
    for r in out:
        _check_image("serve-a", r["codes"][None], _a_pipe(
            full).decode_vq_to_pixels(r["codes"][None], 512, 512))
    log(f"[serve-a] TI2TIServer, prompts of {[len(p) for p in prompts]} "
        f"tokens, {opts.text_steps} text + {n_img} image steps B=2: codes in "
        f"range, pixels finite; wall "
        f"{wall:.2f} s, {(opts.text_steps + n_img) / wall:.2f} forwards/s, "
        f"peak memory {peak / 2 ** 30:.2f} GiB")


def phase_serve_m(full) -> None:
    """``InterleaveServer`` at full width, exact then ``use_cache=True``,
    each with two ragged requests from two threads: the exact server takes
    two 512x512 images (encoded through MagViT on its worker, TF32 off)
    and instructions of 51 and 31 tokens (one bucket, K1 with the bias); the
    cached one takes codes and two instructions of one length (exact-length
    groups, K2)."""
    import numpy as np
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.pipeline import _pixels_pm_one
    from mmada_parallel_torch.samplers.interleave import (
        InterleaveOptions, interleave_refresh_schedule)
    from mmada_parallel_torch.serving import InterleaveServer
    cfg = full["cfg"]
    T = tk.TOKENS_M
    opts = InterleaveOptions(text_steps=8, image_steps=2,
                             image_temperature=0.0)
    tok = StandInTokenizer()
    instr = tok("make the sky purple")["input_ids"]
    images = [_pixels_pm_one(img, 512)[0]
              for img in (_edit_image(512), _edit_image(512)[::-1].copy())]
    pipe = _m_pipe(full)

    def get_code(px):
        # one image at a time: cuDNN may pick another algorithm for another
        # batch size, and the alone check needs the same codes
        return torch.cat([pipe.get_code(p[None]) for p in px])

    server = InterleaveServer(full["params"], cfg, opts, batch_size=2,
                              max_wait_ms=500.0, bucket_quantum=64,
                              get_code=get_code)
    out, wall, peak = _served(
        "serve-m", server,
        [((instr,), {"image": images[0]}), ((instr[:30],),
                                            {"image": images[1]})],
        {"flash_attention_rope": cfg.n_layers * opts.text_steps},
        biased=True)
    _m_pixels(full, [r["codes"] for r in out])
    log(f"[serve-m] InterleaveServer exact, {opts.text_steps} steps B=4 "
        f"(2 rows x cond + uncond): codes in range, pixels finite; wall {wall:.2f} s (MagViT encode "
        f"included), {opts.text_steps / wall:.2f} forwards/s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    rng = np.random.default_rng(1)
    codes = [rng.integers(0, T.codebook_size, 1024) + T.vq_offset
             for _ in range(2)]
    other = tok("add a small red hat")["input_ids"]
    server = InterleaveServer(full["params"], cfg, opts, batch_size=2,
                              max_wait_ms=500.0, use_cache=True)
    n_partial = int((~interleave_refresh_schedule(
        opts.text_steps, opts.image_steps)).sum())
    out, wall, peak = _served(
        "serve-m-cached", server,
        [((instr[:30],), {"codes": codes[0]}),
         ((other[:30],), {"codes": codes[1]})],
        {"flash_attention_rope_qonly": cfg.n_layers * opts.text_steps})
    _m_pixels(full, [r["codes"] for r in out])
    log(f"[serve-m-cached] InterleaveServer use_cache=True, "
        f"{opts.text_steps} steps ({n_partial} partial) B=4: codes in range, "
        f"pixels finite; wall "
        f"{wall:.2f} s, {opts.text_steps / wall:.2f} forwards/s, peak "
        f"memory {peak / 2 ** 30:.2f} GiB")


def phase_head(full) -> None:
    """Fault h: the vocab head with bf16 operands and an f32 result on the
    tensor cores against the f32 upcast it replaced, at the understanding
    shape (B=2 x 128 answer slots x the full vocab) and the variant-M T2I
    shape (B=4 x 1024 image slots x the 8192-code slice), on the 8B head
    and unit-scale bf16 hidden states: max |dlogit| and both times.  The
    products are the same; only the f32 summation order differs."""
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import llada_head
    cfg, params = full["cfg"], full["params"]
    gen = torch.Generator(device="cuda").manual_seed(14)
    T = tk.TOKENS_M
    for name, B, n, vs in (("mmu", 2, 128, None),
                           ("t2i", 4, 1024, (T.text_vocab_size, 8192))):
        h = torch.randn(B, n, cfg.d_model, generator=gen,
                        device="cuda").to(torch.bfloat16)
        w = params["head"] if vs is None else \
            params["head"][:, vs[0]:vs[0] + vs[1]]

        def new():
            return llada_head(params, cfg, h, vocab_slice=vs)

        def old():
            return h.float() @ w.float()

        got, want = new(), old()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if got.dtype != torch.float32 or err > 1e-3 * scale:
            raise AssertionError(f"head {name}: max |dlogit| {err:.3e} "
                                 f"against max |logit| {scale:.3e}")
        t_new, t_old = time_ms(new), time_ms(old)
        log(f"[head] {name} B={B} x {n} x {w.shape[1]} vocab: bf16 operands "
            f"+ f32 result {t_new:.3f} ms, f32 upcast {t_old:.3f} ms "
            f"({t_old / t_new:.1f}x); max |dlogit| {err:.3e} "
            f"(max |logit| {scale:.3f})")


def phase_vq_tf32(full) -> None:
    """Fault i: the same 512x512 image through Amused-VQ and MagViT with
    cuDNN's TF32 on and off, the codes that differ counted; then, with the
    caller's TF32 switched on, the pipelines' encoders must give the
    TF32-off codes and leave the caller's setting as it was."""
    import numpy as np
    import torch
    from mmada_parallel_torch.models import amused_vq as AVQ
    from mmada_parallel_torch.models import magvit2 as MVQ
    from mmada_parallel_torch.pipeline import _pixels01, _pixels_pm_one
    img = _edit_image(512)
    px_a, px_m = _pixels01(img), _pixels_pm_one(img, 512)
    codes = {}
    for tf32 in (True, False):
        with torch.inference_mode(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=tf32):
            lat = AVQ.amused_encode(full["vparams"], full["vcfg"],
                                    torch.as_tensor(px_a, device="cuda"))
            a = AVQ.amused_quantize(full["vparams"], full["vcfg"], lat)[1]
            m = MVQ.magvit_get_code(full["mparams"], full["mcfg"],
                                    torch.as_tensor(px_m, device="cuda"))
            codes[tf32] = (a.cpu().numpy(), m.cpu().numpy())
    diff_a = int((codes[True][0] != codes[False][0]).sum())
    diff_m = int((codes[True][1] != codes[False][1]).sum())
    torch.backends.cudnn.allow_tf32 = True
    try:
        got_a = _a_pipe(full)._encode(px_a)
        got_m = _m_pipe(full).get_code(px_m).cpu().numpy()
        kept = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    if not (np.array_equal(got_a, codes[False][0])
            and np.array_equal(got_m, codes[False][1]) and kept):
        raise AssertionError("vq-tf32: a pipeline encoder did not give the "
                             "TF32-off codes, or did not restore the "
                             "caller's setting")
    log(f"[vq-tf32] 512x512 image, TF32 on vs off: Amused-VQ {diff_a} of "
        f"{codes[False][0].size} codes differ, MagViT {diff_m} of "
        f"{codes[False][1].size}; with the caller's TF32 on, both pipelines "
        f"gave the TF32-off codes and left it on")


# ---------------------------------------------------------------------------
# The evaluation slice at full width: the ParaBench sweeps and W8A8
# ---------------------------------------------------------------------------


def _edit_requests(full):
    """The 4 synthetic 512x512 ParaBench edit requests: two images (the
    test image and its upside-down copy) x two prompt lengths (the 50-id
    prompt and a 30-id cut of it, 1108 and 1088 tokens with the image span:
    buckets 1152 and 1088).  ``meta`` holds the input image's codes and, as
    the target, the other image's.  Returns (prompts, metas, the shared
    image-CFG uncond prefix: the short prompt without its image)."""
    import numpy as np
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.pipeline import SYSTEM_PROMPT_EDIT, _pixels01
    A = tk.TOKENS_A
    pipe = _a_pipe(full)
    cond, _ = tk.make_ti2ti_prompt("make the sky purple", SYSTEM_PROMPT_EDIT)
    ids = StandInTokenizer()(cond)["input_ids"]
    codes = [pipe._encode(_pixels01(img))[0]
             for img in (_edit_image(512), _edit_image(512)[::-1].copy())]
    spans = [[A.boi] + tk.add_break_line([int(c) + A.vq_offset for c in cs],
                                         32, 32, A.newline) + [A.eoi]
             for cs in codes]
    prompts, metas = [], []
    for head in (ids[:-1], ids[:29]):
        for i in (0, 1):
            prompts.append(head + spans[i] + ids[-1:])
            metas.append({"input_codes": codes[i].tolist(),
                          "target_codes": codes[1 - i].tolist()})
    return prompts, metas, np.asarray(ids[:29] + ids[-1:], np.int64)


def phase_eval_edit(full) -> None:
    """``run_parabench_sweep`` at full width: 4 edit requests in two
    prompt-length buckets, ``batch_size=2`` (two chunks of B=2), 16 text and
    8 image steps at temperature 0, ``cfg_img=4.0`` with one shared uncond
    prefix, scored by ``default_edit_scorer`` composed with
    ``pixel_edit_scorer`` over the Amused-VQ decode (TF32 off).  K1 runs
    32 x (16 cond + 8 uncond forwards) per chunk."""
    import numpy as np
    from mmada_parallel_torch import evaluation as EV
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.cli.eval_sweep import amused_decoder
    from mmada_parallel_torch.eval_scorers import (aggregate_scores,
                                                   default_edit_scorer,
                                                   pixel_edit_scorer)
    from mmada_parallel_torch.ops import sampling as S
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    cfg = full["cfg"]
    A = tk.TOKENS_A
    prompts, metas, ui = _edit_requests(full)
    opts = TI2TIOptions(text_steps=16, timesteps=8, temperature=0.0,
                        text_temperature=0.0, cfg_img=4.0)
    n_img = int(S.image_step_mask(opts.text_steps, opts.timesteps).sum())
    scorer = pixel_edit_scorer(
        amused_decoder(full["vcfg"], full["vparams"], (32, 32)),
        base=default_edit_scorer())
    reqs = [EV.EvalRequest(p, m) for p, m in zip(prompts, metas)]
    sweep, wall, peak = _timed_run(lambda: EV.run_parabench_sweep(
        full["params"], cfg, reqs, (32, 32), 256, [A.answer_end], opts,
        batch_size=2, uncond_image_prefix=ui, seed=7, scorer=scorer))
    chunks = 2
    launches = check_launches("eval-edit", {
        "flash_attention_rope": chunks * cfg.n_layers * (opts.text_steps
                                                         + n_img)})
    codes = np.stack([r["codes"] for r in sweep["results"]])
    scores = [r["scores"] for r in sweep["results"]]
    if codes.shape != (4, 1024) or codes.min() < 0 or codes.max() >= 8192:
        raise AssertionError(f"eval-edit: codes {codes.shape} out of range")
    pix = [k for k in scores[0] if k.startswith("pixel_")]
    if len(pix) != 4 or not all(math.isfinite(s[k]) for s in scores
                                for k in pix):
        raise AssertionError(f"eval-edit: pixel scores {scores}")
    agg = aggregate_scores(sweep["results"])
    n = sweep["num_requests"]
    log(f"[eval-edit] run_parabench_sweep, {n} 512x512 edits (prompts of "
        f"{sorted({len(p) for p in prompts})} tokens, 2 buckets, batch_size "
        f"2), {opts.text_steps} text + {n_img} image steps, cfg_img "
        f"{opts.cfg_img} (shared uncond prefix of {len(ui)} ids), "
        f"temperature 0: codes in [{codes.min()}, {codes.max()}], K1 "
        f"launches {launches['flash_attention_rope']}")
    log(f"[eval-edit] edits/min {sweep['edits_per_min']:.3f}, s/request "
        f"{sweep['total_time_s'] / n:.3f} (sampler time {sweep['total_time_s']:.3f}"
        f" s, synchronized), wall with scoring {wall:.2f} s, peak memory "
        f"{peak / 2 ** 30:.2f} GiB")
    log("[eval-edit] aggregate: " + ", ".join(
        f"{k} {v:.4f}" for k, v in agg.items()))


def phase_eval_interleave_cached(full) -> None:
    """``run_interleave_sweep(use_cache=True)`` at full width: 2 requests
    (codes, instructions of one length) through the cached
    ``InterleaveServer``; K2 runs 32 x 16 steps per batch."""
    import numpy as np
    from mmada_parallel_torch import evaluation as EV
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.eval_scorers import default_edit_scorer
    from mmada_parallel_torch.samplers.interleave import (
        InterleaveOptions, interleave_refresh_schedule)
    cfg = full["cfg"]
    T = tk.TOKENS_M
    tok = StandInTokenizer()
    opts = InterleaveOptions(text_steps=16, image_steps=4)
    rng = np.random.default_rng(3)
    reqs = []
    for text in ("make the sky purple", "add a small red hat"):
        codes = rng.integers(0, T.codebook_size, 1024)
        reqs.append(EV.InterleaveEvalRequest(
            tok(text)["input_ids"][:30], codes=codes + T.vq_offset,
            meta={"input_codes": codes.tolist()}))
    sweep, wall, peak = _timed_run(lambda: EV.run_interleave_sweep(
        full["params"], cfg, reqs, num_vq_tokens=1024, opts=opts,
        max_seq_length=256, batch_size=2, scorer=default_edit_scorer(),
        use_cache=True))
    batches = sweep["server_stats"]["batches"]
    launches = check_launches("eval-interleave-cached", {
        "flash_attention_rope_qonly": batches * cfg.n_layers
        * opts.text_steps})
    n_partial = int((~interleave_refresh_schedule(
        opts.text_steps, opts.image_steps)).sum())
    for r in sweep["results"]:
        if r["codes"].shape != (1024,) or r["codes"].min() < 0 \
                or r["codes"].max() >= 8192:
            raise AssertionError("eval-interleave-cached: codes out of range")
    n = sweep["num_requests"]
    log(f"[eval-interleave-cached] run_interleave_sweep use_cache=True, {n} "
        f"requests in {batches} batch(es), {opts.text_steps} steps "
        f"({n_partial} partial): codes in range; gens/min "
        f"{sweep['gens_per_min']:.3f}, s/request "
        f"{sweep['total_time_s'] / n:.3f}, peak memory "
        f"{peak / 2 ** 30:.2f} GiB; kernel launches {launches}")


@contextlib.contextmanager
def _int8_ranges():
    """The W8A8 path's activation quantization and int8 GEMM, each inside a
    ``record_function`` range of that name (the rescale is what remains of
    ``int8_matmul``)."""
    from torch.profiler import record_function
    from mmada_parallel_torch.ops import quant as Q
    real_q, real_mm = Q.quantize_activations, Q._int8_mm

    def quantize(x):
        with record_function("int8 quantize"):
            return real_q(x)

    def mm(x_q, w_q):
        with record_function("int8 GEMM"):
            return real_mm(x_q, w_q)

    Q.quantize_activations, Q._int8_mm = quantize, mm
    try:
        yield
    finally:
        Q.quantize_activations, Q._int8_mm = real_q, real_mm


def phase_int8(full) -> None:
    """The exact 512x512 edit at full width on bf16 params, then on
    ``quantize_llada_params`` (int8) and ``quantize_head=False``
    (int8-bf16head), temperature 0, 8 text and 4 image steps with both
    CFG forwards: s/request against bf16, peak memory, the share of image
    codes and text tokens equal to the bf16 edit, K1 launches; one int8 run
    under the profiler splits its device time between the int8 GEMMs, the
    activation quantization and the rest."""
    import gc
    import torch
    from mmada_parallel_torch.ops import sampling as S
    from mmada_parallel_torch.ops.quant import quantize_llada_params
    from mmada_parallel_torch.pipeline import TI2TIPipeline
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    cfg = full["cfg"]
    opts = TI2TIOptions(text_steps=8, timesteps=4, temperature=0.0,
                        text_temperature=0.0, cfg_scale=2.5, cfg_img=4.0)
    n_img = int(S.image_step_mask(opts.text_steps, opts.timesteps).sum())

    def pipe(params):
        return TI2TIPipeline(cfg, params, full["vcfg"], full["vparams"],
                             StandInTokenizer())

    def edit(params):
        return pipe(params)("make the sky purple", _edit_image(512), 512,
                            512, opts, text_gen_length=256, seed=1)

    runs = {}
    for name, head in (("bf16", None), ("int8", True),
                       ("int8-bf16head", False)):
        t0 = time.time()
        params = (full["params"] if head is None else
                  quantize_llada_params(full["params"], quantize_head=head))
        torch.cuda.synchronize()
        t_quant = time.time() - t0
        (_, text, info), wall, peak = _timed_run(lambda: edit(params))
        launches = check_launches(name, {
            "flash_attention_rope": cfg.n_layers * (opts.text_steps
                                                    + n_img)})
        _check_image(name, info["codes"], info["pixels"])
        runs[name] = (info, wall, peak)
        if name == "bf16":
            log(f"[int8] bf16 edit 512x512, {opts.text_steps} text + {n_img} "
                f"image steps, temperature 0: wall {wall:.2f} s (sampler "
                f"{info['elapsed']:.2f} s), peak {peak / 2 ** 30:.2f} GiB")
            continue
        ref = runs["bf16"][0]
        lay = info["layout"]
        ts, te = lay.text_start, lay.text_end
        same_codes = float((info["codes"] == ref["codes"]).mean())
        same_text = float((info["ids"][0, ts:te] == ref["ids"][0, ts:te])
                          .mean())
        log(f"[{name}] quantize_llada_params(quantize_head={head}) in "
            f"{t_quant:.2f} s; edit wall {wall:.2f} s (sampler "
            f"{info['elapsed']:.2f} s) against bf16 {runs['bf16'][1]:.2f} s "
            f"({100 * (wall / runs['bf16'][1] - 1):+.1f} %), peak "
            f"{peak / 2 ** 30:.2f} GiB; image codes equal to bf16 "
            f"{100 * same_codes:.1f} %, text tokens "
            f"{100 * same_text:.1f} %; K1 launches "
            f"{launches['flash_attention_rope']}")
        if name == "int8":
            with _int8_ranges():
                _profile("int8 edit", lambda: edit(params),
                         ranges=("int8 GEMM", "int8 quantize"))
        del params
        gc.collect()
        torch.cuda.empty_cache()


def _train_cfg(impl: str = "auto", remat: str = "whole_layer"):
    """The 8B widths, cut to 4 of 32 layers: f32 params, bf16 compute."""
    import torch
    from mmada_parallel_torch.models.llada import LLaDAConfig
    return LLaDAConfig.llada_8b(n_layers=4, param_dtype=torch.float32,
                                compute_dtype=torch.bfloat16, remat=remat,
                                attention_impl=impl)


def _train_params(cfg):
    """Random f32 params from seed 9, on the card."""
    import torch
    from mmada_parallel_torch.models.llada import init_llada_params
    return init_llada_params(cfg, torch.Generator(device="cuda").manual_seed(9))


# the A step's first loss and grad norm, kernel path against the plain
# attention path: the end-to-end gate.  K1 itself is held element by element
# against its plain version at this step's shape, and at the M step's, in
# phase 2 (K1 cases e and f): the Function's backward recomputes the plain
# chain, so the q/k/v gradients do not see the kernel's output, and a wrong
# kernel reaches these two numbers only through later activations.  Both
# compute in bf16; K1 rounds p to bf16 per key tile
# before the online rescale, the plain chain after normalising, so an
# attention output element differs by up to a bf16 ulp (2^-8 relative).
# Those differences are independent across elements, and the loss averages
# 2 x 5120 token losses and the grad norm sums 2 B squares, which shrinks
# them by orders of magnitude: the FMA template gave 1.7e-6 (loss) and
# 8e-6 (grad norm) relative on the H100; the tensor-core body (which sums
# the scores in another order and takes p from the SFU's 2^x) gives 9.9e-6
# and 1.7e-4, inside the limits by 10x and 6x.
A_LOSS_RTOL, A_GRAD_NORM_RTOL = 1e-4, 1e-3


def phase_train_a() -> dict:
    """The A SFT step of ``cli/train_a.py`` at full width, 4 layers: the
    plain attention path's first step, then 3 steps through K1."""
    import gc
    import torch
    from mmada_parallel_torch.models.llada import count_params
    gen = torch.Generator(device="cuda").manual_seed(10)
    batch = _a_train_batch(gen, 2, TRAIN_L)       # 2 microbatches of B=1
    tokens = batch[0].numel()

    plain_state, plain_step, mp, sp, lp, peak_p = _train_a_steps(
        _train_cfg("xla"), _train_params(_train_cfg("xla")), batch, 3)
    if any(sum(x.values()) for x in lp):
        raise AssertionError("train-a: the plain path launched kernels")
    _profile("train-a plain", lambda: plain_step(plain_state, batch))
    del plain_state, plain_step
    gc.collect()
    torch.cuda.empty_cache()

    cfg = _train_cfg("auto")
    params = _train_params(cfg)
    n_params = count_params(params)
    state, step, mk, sk, lk, peak = _train_a_steps(cfg, params, batch, 3)
    want = {n: 0 for n in KERNELS}
    # 4 layers x 2 microbatches x (forward + remat recompute); the
    # Function's backward recomputes the plain chain and launches nothing
    want["flash_attention_rope"] = cfg.n_layers * 2 * 2
    if any(x != want for x in lk):
        raise AssertionError(f"train-a: launches per step {lk}, expected "
                             f"{want}")
    if not all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
               and m["nonfinite"] == 0 for m in mk):
        raise AssertionError(f"train-a: non-finite step {mk}")
    for key, rtol in (("loss", A_LOSS_RTOL),
                      ("grad_norm", A_GRAD_NORM_RTOL)):
        a, b = mk[0][key], mp[0][key]
        if abs(a - b) > rtol * abs(b):
            raise AssertionError(f"train-a: first-step {key} {a} (K1) vs {b}"
                                 f" (plain), rtol {rtol}")
    log(f"[train-a] LLaDA-8B widths, 4 of 32 layers ({n_params / 1e9:.3f} B "
        f"params f32, bf16 compute), AdamW + clip 4.0, B=1 x 2 microbatches "
        f"x L={TRAIN_L}, remat whole_layer; first step loss "
        f"{mk[0]['loss']:.6f} (K1) vs {mp[0]['loss']:.6f} (plain), grad norm "
        f"{mk[0]['grad_norm']:.6f} vs {mp[0]['grad_norm']:.6f}; losses "
        f"{[round(m['loss'], 6) for m in mk]} (K1) "
        f"{[round(m['loss'], 6) for m in mp]} (plain); K1 launches per step "
        f"{want['flash_attention_rope']}")
    # steps 2-3 of each: the first pays the allocator's and cuBLAS's warm-up
    best_k, best_p = min(sk[1:]), min(sp[1:])
    log(f"[train-a] s/step {[round(x, 3) for x in sk]} (K1), "
        f"{[round(x, 3) for x in sp]} (plain); tokens/s "
        f"{tokens / best_k:.1f} (K1), {tokens / best_p:.1f} (plain), best of "
        f"steps 2-3: K1 {100 * (best_k / best_p - 1):+.1f} % s/step against "
        f"plain; peak {peak / 2 ** 30:.2f} GiB (K1), "
        f"{peak_p / 2 ** 30:.2f} GiB (plain)")
    _profile("train-a K1", lambda: step(state, batch))
    # the same K1 steps with the vocab head as it was before the bf16 path
    with _upcast_head():
        _, _, mo, so, _, peak_o = _train_a_steps(cfg, _train_params(cfg),
                                                 batch, 3)
    best_o = min(so[1:])
    log(f"[train-a] vocab head: bf16 operands + f32 result {best_k:.3f} "
        f"s/step (best of steps 2-3, K1) against the f32 upcast "
        f"{best_o:.3f} s/step in this run ({100 * (best_k / best_o - 1):+.1f}"
        f" %) and 1.264 s recorded for the upcast (NVIDIA H100 80GB HBM3, "
        f"700 W); peak {peak / 2 ** 30:.2f} GiB against "
        f"{peak_o / 2 ** 30:.2f} GiB; first-step loss {mk[0]['loss']:.6f} "
        f"against {mo[0]['loss']:.6f}, grad norm {mk[0]['grad_norm']:.6f} "
        f"against {mo[0]['grad_norm']:.6f}")
    return {"state": state, "cfg": cfg}


@contextlib.contextmanager
def _upcast_head():
    """The vocab head as it was before its bf16 path: both operands upcast,
    an f32 product on the FMA pipes (for a before/after in one run)."""
    from mmada_parallel_torch.models import llada as L
    real = L._Bf16Head

    class Upcast:
        @staticmethod
        def apply(hidden, head):
            return hidden.float() @ head.to(hidden.dtype).float()

    L._Bf16Head = Upcast
    try:
        yield
    finally:
        L._Bf16Head = real


def _m_train_batch(gen, L: int):
    """A padded ``[t2i | lm | mmu]`` batch at length ``L``: each row is
    text (``L - 1026`` ids) then ``<soi>``, 1024 image tokens, ``<eoi>``.
    ``interleave_noising`` masks the image of the t2i and lm rows and the
    text of every row; the lm/mmu losses are weighted by the mask
    probability it drew; the t2i row is left-padded over its first 200
    positions.  Returns the ``forward_process`` arguments."""
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.ops.sampling import cosine_schedule
    from mmada_parallel_torch.training.masking import interleave_noising
    T = tk.TOKENS_M
    dev = gen.device
    n_text = L - 1026
    img = torch.randint(0, T.codebook_size, (3, 1024), generator=gen,
                        device=dev) + T.vq_offset
    text = torch.randint(1000, 120000, (3, n_text), generator=gen,
                         device=dev)
    nimg, ilab, ntext, tlab, t = interleave_noising(gen, img, text,
                                                    mask_token=T.mask)
    p_mask = torch.cos(cosine_schedule(t).clamp_min(1e-3) * math.pi / 2)
    nimg[2], ilab[2] = img[2], -100                 # mmu: the image is given
    tlab[0] = -100                                   # t2i: no text loss
    ilab[1] = -100                                   # lm: no image loss
    soi = torch.full((3, 1), T.soi, device=dev)
    eoi = torch.full((3, 1), T.eoi, device=dev)
    ids = torch.cat([ntext, soi, nimg, eoi], dim=1)
    ign = torch.full((3, 1), -100, device=dev)
    labels = torch.cat([tlab, ign, ilab, ign], dim=1)
    t2i_masks = torch.ones(1, L, dtype=torch.bool, device=dev)
    t2i_masks[0, :M_T2I_PAD] = False
    ids[0, :M_T2I_PAD] = T.eos
    labels[0, :M_T2I_PAD] = -100
    return dict(input_ids=ids, labels=labels, batch_size_t2i=1,
                batch_size_lm=1, batch_size_mmu=1, max_seq_length=n_text,
                t2i_masks=t2i_masks, p_mask_lm=p_mask[1:2, None],
                p_mask_mmu=p_mask[2:3, None],
                answer_lengths_mmu=torch.full((1, 1), n_text, device=dev))


def phase_train_m(a_run: dict) -> None:
    """One M ``forward_process`` step at full width (4 layers, no remat) on
    the A run's state: K1 runs once per layer with the t2i rows' pairwise
    padding bias."""
    import dataclasses
    import torch
    from mmada_parallel_torch.training.m_tasks import forward_process
    from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                       make_optimizer,
                                                       make_train_step)
    L = _m_sequence_length()
    cfg = dataclasses.replace(a_run["cfg"], remat="none")
    state = a_run["state"]
    gen = torch.Generator(device="cuda").manual_seed(11)
    batch = _m_train_batch(gen, L)

    def loss_fn(params, b, generator):
        out = forward_process(params, cfg, **b)
        loss = out["loss_t2i"] + out["loss_lm"] + out["loss_mmu"]
        return loss, out

    opt = make_optimizer(OptimizerConfig(lr=1e-4, grad_clip=4.0),
                         state.params)
    step = make_train_step(loss_fn, opt)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        check_launches("train-m", {"flash_attention_rope": cfg.n_layers})
        vals = {k: float(v) for k, v in m.items()}
        if not (all(math.isfinite(x) for x in vals.values())
                and vals["nonfinite"] == 0):
            raise AssertionError(f"train-m: non-finite step {vals}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[train-m] forward_process [t2i | lm | mmu] B=3 x L={L} (t2i row "
        f"left-padded by {M_T2I_PAD}, interleave_noising on the card), 4 of "
        f"32 layers, no remat: losses t2i {vals['loss_t2i']:.6f} lm "
        f"{vals['loss_lm']:.6f} mmu {vals['loss_mmu']:.6f}, grad norm "
        f"{vals['grad_norm']:.6f}; K1 launches per step {cfg.n_layers}")
    log(f"[train-m] s/step {[round(x, 3) for x in secs]}, tokens/s "
        f"{3 * L / secs[-1]:.1f} (second step), peak {peak / 2 ** 30:.2f} "
        f"GiB")
    _profile("train-m", lambda: step(state, batch))


# The M trainer's first step, K1 against the plain attention, on one batch.
# In bf16 compute the two paths are each ~1e-2 (of the gradient's norm)
# away from the f32 step's gradient, ~2e-4 in the loss and ~1e-3 in the
# grad norm, on either side of it (measured on an H100): one microbatch's
# t = 0.0097 weights its two text tokens by 1/t, so the A step's
# tolerances (A_LOSS_RTOL, A_GRAD_NORM_RTOL), which hold 10,240 evenly
# weighted token losses, lie below this step's rounding noise.  K1 is held
# instead (a) in f32 compute, where the kernel and the plain chain differ
# only by summation order: loss, text and image losses and grad norm within
# rtol 1e-5, the gradient within 1e-4 of its norm; and (b) in bf16 compute,
# the trainer's path: its gradient no farther from the f32 step's than
# 1.25x the plain bf16 step's.
M_F32_RTOL, M_F32_GRAD_RTOL, M_BF16_GRAD_RATIO = 1e-5, 1e-4, 1.25


def _m_first_step(models, cfg, batch, impl: str, dtype):
    """The M trainer's first step on ``batch`` without the optimizer,
    through ``make_loss_fn`` with attention ``impl`` in compute ``dtype``:
    ``(metrics, gradient leaves, launch counts)``, the metrics (loss, text
    and image losses, grad norm) and the gradient the mean over the
    microbatches, as the train step forms them."""
    import dataclasses
    import torch
    from mmada_parallel_torch.cli.train_m import make_loss_fn
    from mmada_parallel_torch.training.trainer import tree_leaves
    leaves = tree_leaves(models.params)
    loss_fn = make_loss_fn(dataclasses.replace(
        models.mcfg, attention_impl=impl, compute_dtype=dtype), cfg)
    n = cfg.training.gradient_accumulation_steps
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    sums = {}
    torch.cuda.synchronize()
    reset_launches()
    with torch.enable_grad():
        for i in range(n):
            mb = tuple(x.reshape((n, -1) + tuple(x.shape[1:]))[i]
                       for x in batch)
            loss, m = loss_fn(models.params, mb, None)
            loss.backward()
            for k, v in {"loss": loss, **m}.items():
                sums[k] = sums.get(k, 0.0) + float(v.detach()) / n
    torch.cuda.synchronize()
    launches = read_launches()
    grads = [p.grad.div_(n) for p in leaves]
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    sums["grad_norm"] = float(torch.sqrt(sum(g.float().square().sum()
                                             for g in grads)))
    return sums, grads, launches


def phase_train_m_cli() -> None:
    """The variant-M SFT trainer (``cli/train_m.py``: ``build_train_step``,
    ``assemble_batch``, ``train_loop``) at the 8B widths, 4 of 32 layers
    (f32 params, bf16 compute, remat ``whole_layer``), with the full-size
    MagViT-v2 encoding seeded 512x512 images and ``configs/train_m.yaml``'s
    sizes: 256 text slots, batch 1 x 4 accumulation microbatches, one row
    of 2565 tokens each.  First the loop's first batch through the loss
    four ways (plain / K1, f32 / bf16 compute; gates above
    ``M_F32_RTOL``), then 3 steps of the loop through K1 (exactly 4 layers
    x 4 microbatches x (forward + remat recompute) = 32 launches a step),
    one more under the profiler, and ``_validate_chat`` once.  No
    checkpoint: the state is ~32 GB (phase 3 holds the save/restore round
    trip)."""
    import gc
    import tempfile
    import torch
    from mmada_parallel_torch.cli import train_m as TM
    from mmada_parallel_torch.data.prompting import UniversalPrompting
    from mmada_parallel_torch.models import magvit2 as MVQ
    from mmada_parallel_torch.models.llada import count_params
    accum, msl, n_vq, res = 4, 256, 1024, 512
    samples = _m_samples(accum, res)
    tok = StandInTokenizerM()
    vcfg = MVQ.MagvitConfig()
    vparams = MVQ.init_magvit_params(
        vcfg, torch.Generator(device="cuda").manual_seed(18))
    f32, bf16 = torch.float32, torch.bfloat16

    with tempfile.TemporaryDirectory() as tmp:
        cfg = _m_cli_cfg(tmp, 3, msl, n_vq, res, accum)
        mcfg = _train_cfg("auto")
        m = TM.Models(mcfg, _train_params(mcfg), tok, vcfg, vparams)
        n_params = count_params(m.params)
        # the loop's first batch: a fresh prompting rng, the seed-19 noise
        first = TM.assemble_batch(samples, m.get_code, tok,
                                  UniversalPrompting(tok, max_text_len=msl),
                                  torch.Generator(device="cuda").manual_seed(
                                      19), cfg, torch.device("cuda"))
        L = first[0].shape[1]
        if L != 2565:
            raise AssertionError(f"train-m-cli: sequence length {L}, "
                                 f"expected 2565")
        want = {n: 0 for n in KERNELS}
        want["flash_attention_rope"] = mcfg.n_layers * accum * 2
        none = {n: 0 for n in KERNELS}
        ref, g_ref, launches = _m_first_step(m, cfg, first, "xla", f32)
        runs = {}
        for impl, dt in (("auto", f32), ("xla", bf16), ("auto", bf16)):
            met, g, launches_ = _m_first_step(m, cfg, first, impl, dt)
            dist = float(torch.sqrt(sum((x - y).float().square().sum()
                                        for x, y in zip(g, g_ref))))
            runs[impl, dt] = (met, dist)
            if launches_ != (want if impl == "auto" else none):
                raise AssertionError(f"train-m-cli: {impl} {dt} first step "
                                     f"launched {launches_}")
            del g
        del g_ref
        gc.collect()
        torch.cuda.empty_cache()
        if launches != none:
            raise AssertionError(f"train-m-cli: the plain path launched "
                                 f"{launches}")
        (k32, d32), (p16, dp16), (k16, dk16) = (
            runs["auto", f32], runs["xla", bf16], runs["auto", bf16])
        for key in M_KEYS:
            if not abs(k32[key] - ref[key]) <= M_F32_RTOL * abs(ref[key]):
                raise AssertionError(f"train-m-cli: f32 first-step {key} "
                                     f"{k32[key]} (K1) vs {ref[key]} "
                                     f"(plain), rtol {M_F32_RTOL}")
        if not d32 <= M_F32_GRAD_RTOL * ref["grad_norm"]:
            raise AssertionError(f"train-m-cli: f32 gradient {d32} from the "
                                 f"plain path's (norm {ref['grad_norm']})")
        if not dk16 <= M_BF16_GRAD_RATIO * dp16:
            raise AssertionError(f"train-m-cli: bf16 K1 gradient {dk16} "
                                 f"from the f32 step's, the plain bf16 "
                                 f"path's {dp16} (ratio limit "
                                 f"{M_BF16_GRAD_RATIO})")
        ts = [round(x, 4) for x in first[3].tolist()]
        log(f"[train-m-cli] first batch, LLaDA-8B widths, 4 of 32 layers "
            f"({n_params / 1e9:.3f} B params f32), B=1 x {accum} "
            f"microbatches x L={L}, t {ts}: f32 compute loss "
            f"{k32['loss']:.6f} (K1) vs {ref['loss']:.6f} (plain), grad norm {k32['grad_norm']:.6f} vs "
            f"{ref['grad_norm']:.6f}, gradients {d32 / ref['grad_norm']:.3e}"
            f" of the norm apart; bf16 compute loss {k16['loss']:.6f} (K1) "
            f"vs {p16['loss']:.6f} (plain), grad norm {k16['grad_norm']:.6f}"
            f" vs {p16['grad_norm']:.6f}, gradients "
            f"{dk16 / ref['grad_norm']:.3e} (K1) and "
            f"{dp16 / ref['grad_norm']:.3e} (plain) of the norm from the "
            f"f32 step's")

        data_s = []
        torch.cuda.reset_peak_memory_stats()
        with _timed_assembly(data_s):
            state, hist, rec, step = _train_m_run(cfg, m, samples, 19)
        peak = torch.cuda.max_memory_allocated()
        if [x for x, _ in rec] != [want] * 3:
            raise AssertionError(f"train-m-cli: launches per step "
                                 f"{[x for x, _ in rec]}, expected {want}")
        if not all(math.isfinite(h[k]) for h in hist for k in M_KEYS) \
                or any(h["nonfinite"] for h in hist):
            raise AssertionError(f"train-m-cli: non-finite step {hist}")
        # the loop's first step is the bf16 K1 first step above (the
        # embedding's backward accumulates with atomics: 1e-4 on the norm)
        if not (abs(hist[0]["loss"] - k16["loss"]) <= 1e-6 * k16["loss"]
                and abs(hist[0]["grad_norm"] - k16["grad_norm"])
                <= 1e-4 * k16["grad_norm"]):
            raise AssertionError(f"train-m-cli: the loop's first step "
                                 f"{hist[0]} is not the step checked above "
                                 f"{k16}")
        batch = TM.assemble_batch(samples, m.get_code, tok,
                                  UniversalPrompting(tok, max_text_len=msl),
                                  torch.Generator(device="cuda").manual_seed(
                                      20), cfg, torch.device("cuda"))
        secs = [t for _, t in rec]
        log(f"[train-m-cli] cli/train_m.train_loop: AdamW + clip 1.0, "
            f"remat whole_layer, bf16 compute, MagViT-v2 encoding 512x512 on "
            f"the card, key-padding bias: losses "
            f"{[round(h['loss'], 4) for h in hist]}, text "
            f"{[round(h['text_loss'], 4) for h in hist]}, image "
            f"{[round(h['image_loss'], 4) for h in hist]}, grad norms "
            f"{[round(h['grad_norm'], 4) for h in hist]}; K1 launches per "
            f"step {want['flash_attention_rope']}")
        log(f"[train-m-cli] s/step {[round(x, 3) for x in secs]} (the step "
            f"alone, up to a synchronize), batch assembly "
            f"{[round(x, 3) for x in data_s]} s, the loop's batch_time "
            f"{[round(h['batch_time'], 3) for h in hist]} s; tokens/s "
            f"{accum * L / min(secs[1:]):.1f} (best of steps 2-3), "
            f"{accum * L / min(h['batch_time'] for h in hist[1:]):.1f} with "
            f"the assembly; peak {peak / 2 ** 30:.2f} GiB")
        _profile("train-m-cli", lambda: step(state, batch))
        jl = os.path.join(tmp, "chat.jsonl")
        with open(jl, "w") as f:
            for q in ("what is in the image?", "describe the sky"):
                f.write(json.dumps({"question": q}) + "\n")
        vcfg_ = _m_cli_cfg(tmp, 3, msl, n_vq, res, accum, **{
            "dataset.params.lm_chat_validation_jsonl": jl})
        (_, wall, vpeak) = _timed_run(lambda: TM._validate_chat(
            state.params, m.mcfg, tok, vcfg_, 3))
        chat = check_launches("train-m-cli _validate_chat", {
            "flash_attention_rope": m.mcfg.n_layers * (msl // 2)})
        with open(os.path.join(tmp, "validation",
                               "chat_step0000003.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if len(rows) != 2 or not all(isinstance(r["response"], str)
                                     for r in rows):
            raise AssertionError(f"train-m-cli: chat rows {rows}")
    log(f"[train-m-cli] _validate_chat: 2 questions, {msl} new tokens in "
        f"{msl // 2} steps, {wall:.2f} s, K1 {chat['flash_attention_rope']},"
        f" peak {vpeak / 2 ** 30:.2f} GiB")


# the ParaRL update's loss and grad norm, K1 against the plain attention, on
# one trajectory (bf16 compute): as for the A step (A_LOSS_RTOL,
# A_GRAD_NORM_RTOL), an attention output element differs by up to a bf16
# ulp; the loss is held to 1e-4 of its terms' size (it nearly cancels
# against the mean-reward baseline), the gradient norm to 1e-3.
RL_LOSS_RTOL, RL_GRAD_NORM_RTOL = 1e-4, 1e-3


def phase_pararl() -> None:
    """The ``cli/train_pararl.py`` loop at the 8B widths, 4 of 32 layers
    (f32 params, bf16 compute, AdamW, clip 1.0): 2 rollouts a step of the
    512x512 layout (grid 32 x 32, 256 text slots), 16 text and 8 image
    steps at the CLI's temperatures, the code-diversity reward, 4 of 16
    steps scored, 3 updates.  K1 runs 4 layers x 16 steps a rollout and 4
    layers x 4 scored steps an update (the Function's backward launches
    nothing).  Then, on the last trajectory, the loss and gradient norm
    through K1 against the plain attention path."""
    import dataclasses
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.cli import train_pararl as RL
    from mmada_parallel_torch.models.llada import count_params
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    from mmada_parallel_torch.training.pararl import (RewardSpec,
                                                      pararl_loss)
    from mmada_parallel_torch.training.trainer import tree_leaves
    cfg = _train_cfg("auto", remat="none")
    params = _train_params(cfg)
    A = tk.TOKENS_A
    ids = StandInTokenizer()("make the sky purple")["input_ids"]
    seqs, layout = RL.rollout_sequences([ids, ids[:30]], A, 32, 256)
    batch_ids = torch.as_tensor(seqs, device="cuda")
    opts = TI2TIOptions(text_steps=16, timesteps=8, temperature=1.0,
                        text_temperature=0.7, cfg_scale=0.0, cfg_img=0.0)
    sub = RL.subsample_steps(opts.text_steps, 4)
    state, step = RL.build_update(cfg, params, opts, 1e-6, sub)
    rewards = RewardSpec(fns=[RL.default_reward], weights=[1.0])
    gen = torch.Generator(device="cuda").manual_seed(12)
    rolls, updates, losses, rws, peaks = [], [], [], [], []
    for _ in range(3):
        (traj, rw), secs, peak = _timed_run(lambda: RL.rollout_and_score(
            state.params, cfg, batch_ids, layout, opts, rewards, gen))
        check_launches("pararl rollout", {
            "flash_attention_rope": cfg.n_layers * opts.text_steps})
        (state, m), secs_u, peak_u = _timed_run(
            lambda: step(state, (traj, rw), gen))
        peaks += [peak, peak_u]
        check_launches("pararl update", {
            "flash_attention_rope": cfg.n_layers * len(sub)})
        vals = {k: float(v) for k, v in m.items()}
        if not (all(math.isfinite(x) for x in vals.values())
                and vals["nonfinite"] == 0):
            raise AssertionError(f"pararl: non-finite update {vals}")
        rolls.append(secs)
        updates.append(secs_u)
        losses.append(vals["loss"])
        rws.append(vals["reward_mean"])
    log(f"[pararl] cli/train_pararl loop, LLaDA-8B widths, 4 of 32 layers "
        f"({count_params(state.params) / 1e9:.3f} B params f32, bf16 "
        f"compute), 2 rollouts x L={layout.total_len}, {opts.text_steps} "
        f"text + {opts.timesteps} image steps, {len(sub)} scored: rewards "
        f"{[round(x, 4) for x in rws]}, losses "
        f"{[round(x, 4) for x in losses]}; K1 launches "
        f"{cfg.n_layers * opts.text_steps} a rollout, "
        f"{cfg.n_layers * len(sub)} an update")
    log(f"[pararl] rollout s {[round(x, 3) for x in rolls]}, update s "
        f"{[round(x, 3) for x in updates]}, peak memory "
        f"{max(peaks[0::2]) / 2 ** 30:.2f} GiB (rollout), "
        f"{max(peaks[1::2]) / 2 ** 30:.2f} GiB (update)")

    # the last trajectory with fixed rewards (advantages +-0.5), K1 vs plain
    fixed = torch.tensor([0.0, 1.0], device="cuda")
    got = {}
    for impl in ("auto", "xla"):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.grad = None
        reset_launches()
        with torch.enable_grad():
            loss, m = pararl_loss(state.params, dataclasses.replace(
                cfg, attention_impl=impl), traj, fixed, opts,
                step_indices=sub)
            loss.backward()
        norm = torch.sqrt(sum(p.grad.float().square().sum()
                              for p in leaves if p.grad is not None))
        counts = read_launches()
        got[impl] = _rl_metrics({"loss": loss.detach(), "grad_norm": norm,
                                 "traj_logp": m["traj_logp"].detach()},
                                fixed)
        got[impl]["launches"] = counts["flash_attention_rope"]
        for p in leaves:
            p.grad = None
    if got["xla"]["launches"] or got["auto"]["launches"] != \
            cfg.n_layers * len(sub):
        raise AssertionError(f"pararl: launches {got}")
    _rl_close("pararl", got["auto"], got["xla"], RL_LOSS_RTOL,
              RL_GRAD_NORM_RTOL)
    log(f"[pararl] same trajectory, rewards [0, 1]: loss "
        f"{got['auto']['loss']:.6f} (K1) vs {got['xla']['loss']:.6f} "
        f"(plain), grad norm {got['auto']['grad_norm']:.6f} vs "
        f"{got['xla']['grad_norm']:.6f}, trajectory log-prob "
        f"{got['auto']['traj_logp']:.3f} vs {got['xla']['traj_logp']:.3f}")


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    import gc
    t0 = time.time()

    def mark(phase: str) -> None:
        log(f"[time] {phase} done at {time.time() - t0:.1f} s")

    device = phase_device()
    phase_build()
    mark("build")
    phase_rope_prepass()
    records = {"flash_attention_rope": phase_kernel(),
               "flash_attention_rope_qonly": phase_kernel_qonly(),
               "flash_attention": phase_kernel_blhd(),
               "flash_attention_rope_prefix": phase_kernel_prefix()}
    prefix_launches = phase_prefix_crossover()
    phase_kernel_grads()
    mark("phase 2 (kernels)")
    phase_small_slice()
    phase_small_new_paths()
    phase_small_train()
    phase_small_train_m()
    phase_shards()
    mark("phase 3 (small models) up to the train steps")
    phase_small_eval()
    mark("phase 3 (small models)")
    full = make_full_width(torch.Generator(device="cuda").manual_seed(0))
    launches = {"flash_attention_rope": phase_edit(full),
                "flash_attention": phase_edit_lowprec_rope(full),
                "flash_attention_rope_qonly": phase_cached_edit(full),
                "flash_attention_rope_prefix": prefix_launches}
    phase_interleave(full)
    phase_cached_interleave(full)
    phase_head(full)
    phase_vq_tf32(full)
    phase_t2i_a(full)
    phase_t2i_a_cached(full)
    phase_t2i_m(full)
    phase_mmu(full)
    phase_stepwise(full)
    phase_serve_a(full)
    phase_serve_m(full)
    mark("phase 4 up to the servers")
    phase_eval_edit(full)
    phase_eval_interleave_cached(full)
    phase_int8(full)
    mark("phase 4 (full width)")
    del full                      # the training phases need the memory
    gc.collect()
    torch.cuda.empty_cache()
    a_run = phase_train_a()
    phase_train_m(a_run)
    del a_run
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5 (training) up to the M step")
    phase_train_m_cli()
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5 (training) up to ParaRL")
    phase_pararl()
    mark("phase 5 (training)")
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                **{f: records[name][f] for f in fields}}
               for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
