"""On-card proof that the PyTorch/CUDA port builds, is right and runs its
paths: the variant-A thinking-aware edit (exact, feature-cached, served
tensor-parallel over a ring of ranks, and over the mesh's ``tensor`` axis
in Megatron's split, dense and W8A8), the
variant-M interleave generation (exact and feature-cached), text-to-image
(A exact and cached, M), understanding, the streaming demo, the four
servers, the ParaBench evaluation sweeps, the W8A8 int8 edit, the A and M
train steps, the variant-M SFT trainer (``cli/train_m.py``) with its data
layer, and ParaRL, with gradients through the attention kernels; the five
capability demos trained from scratch; and the checkpoint export.

    python3 chip_smoke.py        # from the repository root, one H100

Phases (each prints its own lines; any failure exits non-zero):

0. device: the card's name and power limit, the cards visible and whether
   NCCL is available, torch/CUDA versions, TF32 off;
1. build: one ``nvcc`` per ``mmada_parallel_torch/csrc/*.cu`` for sm_90a,
   all at once, then one link; one line with the registers and spill
   bytes of the warp-specialised kernels, the forward body (plain, split,
   one-warpgroup and prefix instances) and the backward's dK/dV and dQ
   passes, at D=64 and 128 with and without a bias (ptxas; a forward entry
   missing, or any entry spilling, fails);
2. the four attention kernels against their plain PyTorch versions on the
   card, timed with CUDA events against them and against their bound (the
   larger of FLOPs over the 989 TFLOP/s bf16 peak and bytes over 3.35 TB/s),
   each timed case also with its kernels' device time from the profiler:
   K1's bf16 rotation pre-pass bitwise against ``rope_tensor``; K1 fused
   RoPE at the edit's shapes (bf16: pre-pass + the warp-specialised body;
   at B=1 and at the M trainer's shape its device kernels checked to be
   those two; at B=1 two launches bit for bit, and one SDPA call on its pre-rotated q/k
   beside it as the body's yardstick, not the same function), K2
   q-only RoPE at the cached samplers' partial and full shapes (bf16:
   pre-pass + the warp-specialised body, split-K with its combine kernel
   where the planner splits; each case prints its split count, and the
   split sweeps each count's device time beside the planner's choice), K3
   BLHD at the edit shape (bf16: the warp-specialised body, its device
   kernel checked, two launches bit for bit) with
   one
   ``scaled_dot_product_attention`` call beside it as the library yardstick,
   K4 prefix bounds at the A-train shape and a mixed task batch (bf16:
   pre-pass + the warp-specialised body with the bounds; with K1 on the
   equivalent dense bias beside it at 2424 and 5120, the crossover
   ``rope_attention_prefix``'s ``auto`` would want, and ``auto``'s choice at
   both lengths checked by launch counts), each at small f32 shapes, every
   kernel at the tensor-core bodies' bf16 edges (D=64, ragged Lq/Lk, GQA,
   fully masked rows, per-row tables, odd Lk with a bias, forced splits,
   bounds 0 and past Lk; K1 and K3 also B=2 with the last tiles at the
   batch boundary, and their row statistics against the plain softmax's
   there and at an odd Lk with a fully masked row), and K1 at the A and M
   train steps' shapes and at
   the M trainer's (B=1, L=2565, the key-padding bias of an interleave
   row); SDPA
   on pre-rotated inputs beside K2 and K4 as a yardstick for their
   attention part (not the same function: no rotation); the device kernel
   names of K2's split and unsplit and one K4 bf16 call (the
   warp-specialised body, not the FMA template); the backward kernels of K1, K2 and K3
   (``csrc/attention_bwd.cu``) against their plain versions in bf16 at the
   body's edges (forced K2 splits, the bias staged by TMA and by cp.async,
   one q tile, G = 4, B = 2 off the tiles), two launches bit for bit,
   the rotation post-pass bitwise, timed with their bounds and device time
   by pass at the A step's, the M trainer's and the training ring's shapes
   (K3 at 2424 and 5120 beside SDPA's backward, and at the M trainer's
   shape beside SDPA's with the bias as a bf16 mask); then each kernel's
   autograd Function: one
   forward and (bf16 K1-K3) one backward launch, the forward against plain
   autograd, the bf16 gradients gated by the bf16 plain chain's distance
   from the f32 chain, the f32 gradients equal to plain autograd's;
   K1 and K2 also at the text-to-image and understanding servers' shapes
   (the T2I server's left-padded B=4 batch, the MMU server's right-padded
   B=2 batch with re-ranked positions, the cached A T2I partial step); K2
   at the ring block's per-chunk shapes (``ring/...``: a rank's 8 heads,
   Lq = 303 sigma-ordered queries against 2424 keys with sigma-gathered
   tables, B=1 and B=2 bf16, timed with its bound and split count, and a
   small f32 case); K1 and K2 at a ``tensor`` rank's 16 heads (``tp/H16``:
   K1 B=1 L=2424, bound 0.0487 ms; K2 Lq=16 of 2424); the tokenizers'
   fused GroupNorm + swish (``csrc/group_norm.cu``) against its plain
   chain at MagViT-v2's and Amused-VQ's shapes (f32 with and without the
   swish, bf16, ragged groups), contiguous and channels-last, timed
   against its bound, the plain chain and ``F.silu(F.group_norm(...))``
   (its launches are held, and its routes logged, in the exact edit, the
   exact interleave and the M trainer's first batch assembly: one launch a
   fused call of the tokenizers, counted on the meta device); the mixture
   of experts' grouped GEMM (``csrc/moe_grouped_gemm.cu``) at
   SDAR-30B-A3B's widths, at the block sampler's decode shape (64 tokens,
   16-row tiles) and its prefill's (65,536 tokens, 128-row tiles): both
   launches against ``grouped_gemm_reference``, the layer against the f32
   loop over experts, a bitwise repeat, the device kernels, timed against
   the bound, the plain loop and ``torch._grouped_mm``;
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
   ``[ring-small]``: 4 ranks (spawned processes, all on this card, a gloo
   group through a ``file://`` rendezvous) run a small f32 model (8 heads
   of 64, 2 layers) on the ring tensor parallelism: the ring hidden state
   within 2e-4 of the solo forward, the exact edit over the ring
   token-exact against the solo K1 and plain runs, the interleave against
   its solo run, ``TI2TIServer`` over the ring (two requests from two
   threads on rank 0, the other ranks following) each row its solo run,
   every rank's ids rank 0's, the int8 payload at JAX's bars, and exact
   K2 counts (2g x layers x forwards a rank) with no K1; ``[ring-nccl]``
   the same over NCCL, one card a rank, where the machine has two or
   more cards (else it says it did not run); ``[eval-edit-mesh]``:
   ``run_parabench_sweep(mesh=)`` on 2 ranks at ``tensor=2`` (temperature
   0) and at ``data=2`` (temperature 1: a row's noise does not depend on
   the split) equal to the one-rank sweep; ``[pararl-mesh]``: ``cli/train_pararl``'s rollout and
   update under JAX's ``MeshConfig()`` on 2 ranks equal to one rank's;
4. ``[sdar]``: SDAR-30B-A3B at its published widths, 2 of its 48 layers
   (random bf16 weights), through ``mmu_generate_fast`` on the
   block-causal route (16 prompts of 4096, 8 new tokens in blocks of 4):
   a call that captures the decode graphs, then one with every launch
   count at 0 before it (the host launches only the prefill: K4 once a
   layer, the grouped kernel twice; every decode forward a graph replay),
   then one under the profiler that counts the device's launches of the
   attention body and of the grouped kernel at each tile size; the first
   row's step logits against the plain f32 reference's full forwards
   (``benchmark/reference/sdar.py``); then
   at the full width of the 8B backbone (all 32 layers, one set of random
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
   the activation quantization apart); after the inference weights are
   freed, ``[serve-a-ring]``: the same 8B edit served by
   ``TI2TIServer(hidden_fn=ring_hidden_fn(mesh))`` on 4 ranks sharing this
   card over host-staged gloo (each rank draws the full tree from the
   seed in turn and keeps its shards), two requests from two threads, 2
   text and 2 image steps (and the first alone with the int8 payload):
   every rank's
   ids rank 0's, codes in range, exact K2 counts and no K1, one ring
   forward's hidden state against the solo K1 forward within a bf16 bound
   that the int8 payload's hidden state must fail, the bytes each rank sends a forward against (g-1)/g of the activations
   at each of the 4 boundaries, the share of the wall in ``permute``, each
   rank's peak memory; its times are one card's, not multi-GPU times;
   ``[tp-forward]``: the same 8B tree over Megatron's split at g=2 on 2
   ranks sharing the card (``shard_params`` with ``param_shardings``): one
   forward's hidden state against the solo K1 forward (the ring's bf16
   gate), its all-reduced bytes and their share of the forward, the exact
   and the cached edit through the samplers (every rank's ids rank 0's,
   codes in range, exact K1/K2 counts at 16 heads); ``[int8-tp]``: the
   tree quantized and placed by ``quantize_param_shardings`` against the
   unsharded int8 forward (relative L2 ``INT8_TP_REL_L2``: the split sums
   exact int32 products).
   Each run sets every launch count to
   0 just before it and checks them just after; codes, pixels, wall time
   and peak memory are checked and printed; the exact and the cached edit
   and the cached A text-to-image run once more under ``torch.profiler``
   (device time by kernel class, idle share);
5. training at full width, 4 of the 32 layers (f32 params, bf16 compute,
   AdamW, clip 4.0), after the inference weights are freed: the A SFT step
   of ``cli/train_a.py`` (B=1, L=5120, 2 accumulation microbatches, remat
   ``whole_layer``: exactly 16 K1 launches and 8 of its backward, loss and
   grad norm against the plain attention path, 3 finite steps of each, and
   3 more with the vocab head's old f32 upcast for its before and after;
   ``[train-a-k3]``, the same step with bf16 RoPE through K3 and its
   backward against the plain path) and the M
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
   and gradient norm through K1 against the plain path; before ParaRL, the
   mesh training phases (``[train-a-fsdp]``: ``full``, ``zero2`` and
   ``ddp`` on 2 ranks in f32, ``[train-a-ring]``
   with the vocab-parallel ``wte`` and ``head``, ``[train-m-fsdp]``,
   ``[fsdp-nccl]``) and Megatron's split in training: ``[train-a-tp]``
   (``train_a --mesh_tensor 2``, no ring: f32 on ``(1, 1, 2)``, f32 and
   bf16 on ``(1, 2, 2)``, against the solo step, with the bytes
   all-reduced over ``tensor`` and their share of the step) and
   ``[train-m-tp]`` (``train_loop`` at ``mesh.tensor=2`` against one
   rank);
6. the capability demos (``mmada_parallel_torch/examples``), each trained
   from scratch at the JAX capability tests' settings, seed 0, its train
   state round-tripped through a checkpoint into other weights, then
   scored by the JAX tests' bars: M (800 steps; accuracy >= 0.9), A (800
   steps; >= 0.85, the text "rotated colors done"), and on both trained
   models the int8 evals (head quantized and dense) and the two cached
   sampler settings within 0.1 of it; the multitask demo (1000 steps;
   ``T2IServer``/``MMUServer`` sweeps: target_match and text_alignment >=
   0.9, code_diversity in [0.05, 0.2]); the ParaBench demo on the A model
   (target_match >= 0.85, text_alignment >= 0.9); the ParaRL demo at its
   defaults, seed 0 (reward gain >= 0.1; the accuracy half of its bar
   reported), and the trained A model over a 4-rank ring on this card
   (``[demo-a-ring]``: the exact ring's accuracy equal to the solo one, the
   int8 payload's within 0.1, "rotated" in both texts).  Their head_dim is
   32: their configs ask for the plain
   attention, no kernel launches (checked), and ``auto`` at that head_dim
   on the card raises (checked); train seconds, steps/s, peak memory and
   the final loss are printed;
7. the export at the 8B widths, 4 of 32 layers (random bf16 weights):
   ``save_llada_checkpoint`` from the card, ``load_llada_checkpoint`` back,
   every tensor and one ``llada_hidden`` forward (B=1, L=2424, exactly 4
   K1 launches) bit for bit; file size, write and read seconds and GB/s,
   peak host and device memory.

The second-to-last line of stdout is a JSON object with the kernels'
records; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside the repository, the script fails and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import functools
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
    # the backward of K1, K3 and K2: the JAX custom VJPs' backward (the
    # plain chain recomputed, left to XLA)
    "flash_attention_rope_bwd": (
        CSRC + "attention_bwd.cu", "mmada_parallel_tpu/ops/attention.py:134"),
    "flash_attention_rope_qonly_bwd": (
        CSRC + "attention_bwd.cu", "mmada_parallel_tpu/ops/attention.py:334"),
    "flash_attention_bwd": (
        CSRC + "attention_bwd.cu", "mmada_parallel_tpu/ops/attention.py:68"),
    # the mixture of experts' grouped GEMM (SDAR-30B-A3B)
    "moe_grouped_gemm": (
        CSRC + "moe_grouped_gemm.cu",
        "none (the JAX package has no mixture of experts)"),
}
BWD = ("flash_attention_rope_bwd", "flash_attention_rope_qonly_bwd",
       "flash_attention_bwd")

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
    log(f"[device] cards visible {torch.cuda.device_count()}, NCCL "
        f"available {torch.distributed.is_nccl_available()}")
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
        report = f.read()
    for line in report.splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line or "setmaxnreg" in line \
                or "wgmma" in line:
            log(f"[build] ptxas: {line.strip()}")
    passes = ptxas_entries(report)
    missing = [(body, D, bias) for D in (64, 128)
               for body, biases in (("fwd", (False, True)),
                                    ("fwd-split", (False, True)),
                                    ("fwd-solo", (False, True)),
                                    ("fwd-split-solo", (False, True)),
                                    ("fwd-prefix", (False,)))
               for bias in biases if (body, D, bias) not in passes]
    if missing:
        raise AssertionError(f"the forward body attention_ws_kernel was not "
                             f"compiled for (flags, D, bias) {missing}")
    log("[build] warp-specialised passes (ptxas -v): " + "; ".join(
        f"{name} D={D}{' bias' if bias else ''} {regs} registers, "
        f"{stores}/{loads} bytes spill stores/loads"
        for (name, D, bias), (regs, stores, loads) in sorted(passes.items())))
    spilled = [key for key, (_, stores, loads) in passes.items()
               if stores or loads]
    if spilled:
        raise AssertionError(f"warp-specialised entries spill: {spilled}")


def ptxas_entries(report: str) -> dict:
    """``{(pass, D, bias): (registers, spill store bytes, spill load
    bytes)}`` of the warp-specialised kernels (the forward body ``fwd``,
    with ``-split`` (K2's split-K), ``-prefix`` (K4's bounds) or ``-solo``
    (K2 at Lq <= 64 on one consumer warpgroup) for its flags; the
    backward's ``dkdv`` and ``dq`` passes), from the ``-Xptxas -v``
    report ``ops/_cuda.build()`` keeps beside the library.  The registers
    are the launch's (the consumers raise theirs with ``setmaxnreg``)."""
    import re
    entry = re.compile(r"Compiling entry function '\S*?attention_"
                       r"(bwd_dkdv|bwd_dq|ws)_kernelILi(\d+)ELb([01])E"
                       r"(?:Lb([01])ELb([01])E(?:Lb([01])E)?)?")
    spill = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
    used = re.compile(r"Used (\d+) registers")
    names = {"bwd_dkdv": "dkdv", "bwd_dq": "dq", "ws": "fwd"}
    out, key, spills = {}, None, (0, 0)
    for line in report.splitlines():
        m = entry.search(line)
        if m:
            name = names[m.group(1)] + "".join(
                f"-{flag}" for flag, on in zip(("split", "prefix", "solo"),
                                               m.groups()[3:]) if on == "1")
            key = (name, int(m.group(2)), m.group(3) == "1")
            spills = (0, 0)
            continue
        if key is None:
            continue
        m = spill.search(line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = used.search(line)
        if m:
            out[key] = (int(m.group(1)), *spills)
            key = None
    return out


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------


def _launch_counters():
    from mmada_parallel_torch.ops import attention_bwd as B
    from mmada_parallel_torch.ops.moe import grouped_gemm
    from mmada_parallel_torch.ops.flash_attention import flash_attention
    from mmada_parallel_torch.ops.rope_attention import (
        flash_attention_rope, flash_attention_rope_prefix,
        flash_attention_rope_qonly)
    return {"flash_attention_rope": flash_attention_rope,
            "flash_attention_rope_qonly": flash_attention_rope_qonly,
            "flash_attention": flash_attention,
            "flash_attention_rope_prefix": flash_attention_rope_prefix,
            **{name: getattr(B, name) for name in BWD},
            "moe_grouped_gemm": grouped_gemm}


def reset_launches() -> None:
    from mmada_parallel_torch.ops.group_norm import group_norm_swish
    from mmada_parallel_torch.ops.rms_norm import rms_norm
    for fn in (*_launch_counters().values(), group_norm_swish, rms_norm):
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


# The tokenizers' fused norm (csrc/group_norm.cu) is counted apart from the
# attention kernels above, whose counts every phase holds exactly: it is
# held in the main path's phases that encode or decode (the edit, the
# interleave, the M trainer's batch assembly), against the number of fused
# calls an encode or a decode makes, counted on the meta device.
@functools.lru_cache(maxsize=None)
def vq_norm_calls() -> dict:
    """Fused norm calls of one 512x512 encode and one decode of each
    tokenizer: ``{"amused": (encode, decode), "magvit": (encode,
    decode)}``, traced on the meta device."""
    import torch
    from mmada_parallel_torch.models import amused_vq as AVQ
    from mmada_parallel_torch.models import magvit2 as MVQ
    from mmada_parallel_torch.models import vqgan_common as C
    calls = [0]

    def counted(x, *args, **kw):
        calls[0] += 1
        return x

    def n(fn, *args):
        calls[0] = 0
        fn(*args)
        return calls[0]

    real, C.group_norm_swish = C.group_norm_swish, counted
    try:
        g = torch.Generator()
        m = MVQ.MagvitConfig()
        mp = MVQ.init_magvit_params(m, g, device="meta")
        a = AVQ.AmusedVQConfig()
        ap = AVQ.init_amused_vq_params(a, g, device="meta")
        return {"magvit": (
                    n(MVQ._encoder, mp["encoder"], m,
                      torch.empty(1, 3, 512, 512, device="meta")),
                    n(MVQ._decoder, mp["decoder"], m,
                      torch.empty(1, m.z_channels, 32, 32, device="meta"))),
                "amused": (
                    n(AVQ.amused_encode, ap, a,
                      torch.empty(1, 512, 512, 3, device="meta")),
                    n(AVQ.amused_decode_code, ap, a,
                      torch.zeros(1, 1024, dtype=torch.long), (32, 32)))}
    finally:
        C.group_norm_swish = real


@contextlib.contextmanager
def norm_routes(routes: collections.Counter):
    """Counts each fused norm launch's route ("nchw" or "cl") and input
    shape in ``routes`` while the context is open."""
    from mmada_parallel_torch.ops import group_norm as GN
    real = GN._launch_nchw, GN._launch_cl

    def nchw(x, *args):
        routes["nchw", tuple(x.shape)] += 1
        return real[0](x, *args)

    def cl(x, *args):
        routes["cl", tuple(x.shape)] += 1
        return real[1](x, *args)

    GN._launch_nchw, GN._launch_cl = nchw, cl
    try:
        yield routes
    finally:
        GN._launch_nchw, GN._launch_cl = real


# the fused norm's launches and routes in the main path's phases, for the
# kernels line: phase -> (launches, routes)
NORM_RUNS = {}


def check_norm_launches(phase: str, expected: int,
                        routes: collections.Counter) -> int:
    """The fused norm's launches since the last reset must equal
    ``expected`` (one a fused call: no PyTorch chain stands in); logs the
    split of its routes."""
    from mmada_parallel_torch.ops.group_norm import group_norm_swish
    got = group_norm_swish.launches
    if got != expected or sum(routes.values()) != got:
        raise AssertionError(f"{phase}: group_norm_swish launches {got} "
                             f"({sum(routes.values())} by route), expected "
                             f"{expected}")
    split = {r: sum(n for (rr, _), n in routes.items() if rr == r)
             for r in ("nchw", "cl")}
    log(f"[norm] {phase}: group_norm_swish {got} launches, by route "
        f"{split}; by (route, shape) "
        f"{ {f'{r} {list(sh)}': n for (r, sh), n in sorted(routes.items())} }")
    NORM_RUNS[phase] = (got, routes)
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
        # the device time of one call's kernels (profiler on): ms less the
        # host's launch path, which a caller with work queued ahead hides
        rec["device_ms"] = sum(_device_kernels(kernel, name).values()) / 1e3
        times = (f" kernel {rec['ms']:.3f} ms (device {rec['device_ms']:.3f}"
                 f" ms) plain {rec['plain_ms']:.3f} ms bound "
                 f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                 f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of bound "
                 f"({100 * rec['bound_ms'] / rec['device_ms']:.1f} % by device"
                 f" time)")
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


# The row statistics of a bf16 forward against the plain softmax's on the
# same (rotated) inputs, at the tolerance of tests/test_torch_attention_bwd.py
# ::test_stats_are_the_softmax: f32 scores summed in another order and the
# SFU's 2^x.
STATS_TOL = dict(atol=1e-5, rtol=1e-5)


def _check_stats(name: str, got, want) -> None:
    """``got`` (the kernel's ``(m, log2 l)``, f32 ``[B, H, Lq, 2]``) within
    ``STATS_TOL`` of ``want`` (``attention_stats_reference``)."""
    err = (got - want).abs()
    if not bool((err <= STATS_TOL["atol"]
                 + STATS_TOL["rtol"] * want.abs()).all()):
        raise AssertionError(f"{name}: the statistics differ from the plain "
                             f"softmax's, max |err| {float(err.max()):.3e} "
                             f"({STATS_TOL})")
    log(f"[kernel] {name}: statistics (m, log2 l) equal the plain softmax's,"
        f" max |err| m {float(err[..., 0].max()):.3e} log2 l "
        f"{float(err[..., 1].max()):.3e} (tol {STATS_TOL})")


def _repeat_bitwise(name: str, fn) -> None:
    """Two calls of ``fn`` (-> (out, stats)) give the same bits."""
    import torch
    first, second = fn(), fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name}: two launches differ")
    log(f"[kernel] {name}: two launches bit for bit equal (output and "
        f"statistics)")


def _kernel_case(name, B, Lq, Lk, H, KV, D, dtype, tol, gen, *,
                 bias=None, per_row_pos=None, timed=False, body=False,
                 repeat=False, stats=False, sdpa=False) -> dict:
    """K1 vs plain on one shape.  bf16 only: ``body`` checks the device
    kernels are the pre-pass and the warp-specialised body, ``repeat`` that two
    launches are bitwise equal, ``stats`` the row statistics against the
    plain softmax's; ``sdpa`` times one SDPA call on K1's pre-rotated q/k
    (``sdpa_ms``: the body's yardstick, not the same function)."""
    import torch
    from mmada_parallel_torch.ops.attention_bwd import (
        attention_stats_reference)
    from mmada_parallel_torch.ops.rope_attention import (
        _split_tables, flash_attention_rope, flash_attention_rope_reference,
        rope_tensor)
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

    def call(with_stats=False):
        return flash_attention_rope(q, k, v, sin, cos, bias, **kw,
                                    with_stats=with_stats)

    rec = _compare(
        f"K1 {name}", desc, call,
        lambda: flash_attention_rope_reference(q, k, v, sin, cos, bias,
                                               **kw), tol, timed,
        _work(q, k, v, H, bias, sin, cos), dtype)
    if stats or sdpa:
        sq, cq, sk, ck = _split_tables(sin, cos, Lq, Lk)
        q4 = rope_tensor(q.view(B, Lq, H, D), sq, cq, True)
        k4 = rope_tensor(k.view(B, Lk, KV, D), sk, ck, True)
    if body:
        _check_tensor_core_body(f"K1 {name}", call)
    if repeat:
        _repeat_bitwise(f"K1 {name}", lambda: call(with_stats=True))
    if stats:
        _check_stats(f"K1 {name}", call(with_stats=True)[1],
                     attention_stats_reference(q4, k4, bias))
    if sdpa:
        rec["sdpa_ms"] = _sdpa_ms(
            f"K1 {name}", q4, k4, v.view(B, Lk, KV, D), bias,
            what="on K1's pre-rotated q/k: the body's yardstick, not the "
                 "same function (no rotation)")
    return rec


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
    # (a) the solo edit: shared tables, no bias, B=1 (cond) and B=2 (uncond);
    # B=1 also through the warp-specialised body's device kernels, equal to
    # the previous body's bit for bit and on a repeat, and beside SDPA on
    # its pre-rotated q/k
    a1 = _kernel_case("a/B1", 1, L, L, H, H, D, bf16, BF16_TOL, gen,
                      timed=True, body=True, repeat=True, sdpa=True)
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
                             per_row_pos=pos3, stats=True))
    # B=2 with Lq and Lk off the 128-row and 128-key tiles: the last tiles'
    # rows meet the batch boundary (the tensor maps' zero fill)
    recs.append(_kernel_case("g/B2-boundary", 2, 1000, 1000, 8, 8, D, bf16,
                             BF16_TOL, gen, stats=True))
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
                     bias=_mask_bias(m_mask), timed=True, body=True)
    recs.append(j)
    log(f"[kernel] K1 edit shape B=1: kernel {a1['ms']:.3f} ms plain "
        f"{a1['plain_ms']:.3f} ms (SDPA on its pre-rotated q/k "
        f"{a1['sdpa_ms']:.3f} ms, not the same function); B=2: kernel {a2['ms']:.3f} ms plain "
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
                 sdpa=False, positions=None) -> dict:
    """K2 vs plain: q at Lq sorted distinct positions of an Lk sequence
    (per-row tables), at positions 0..Lq-1 (shared), or at the shared
    ``positions`` given; pre-rotated k; ``n_split`` forces the split-K
    count (None: the planner's).  With ``sdpa``, one SDPA call on the
    pre-rotated q beside it."""
    import torch
    from mmada_parallel_torch.ops.rope_attention import (
        _sm_count, flash_attention_rope_qonly,
        flash_attention_rope_qonly_reference, plan_splits)
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, H * D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Lk, KV * D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Lk, KV * D, generator=gen, device=dev).to(dtype)
    sin, cos = _rope_tables(Lk, D, dev)
    if positions is not None:
        pos = positions.to(dev)
        sin, cos = sin[pos].contiguous(), cos[pos].contiguous()
        per_row = False
    elif per_row:
        pos = torch.stack([torch.randperm(Lk, generator=gen, device=dev)[:Lq]
                           for _ in range(B)]).sort(dim=1).values
        sin, cos = sin[pos].contiguous(), cos[pos].contiguous()
    else:
        sin, cos = sin[:Lq].contiguous(), cos[:Lq].contiguous()
    kw = dict(n_heads=H, n_kv_heads=KV)
    splits = 1 if dtype == torch.float32 else (
        n_split or plan_splits(B, H, Lq, Lk, _sm_count(dev), D, KV))
    desc = (f"{_desc(B, Lq, Lk, H, KV, D, dtype)} "
            f"{'per-row' if per_row else 'shared'}"
            f"{' sigma-gathered' if positions is not None else ''} tables"
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


# A ``torch.profiler`` session on the H100 now and then returns no device
# event at all for a call that launched kernels (an SDPA call and a K4 call
# came back empty in two runs of this script; the other sessions of those
# runs did not).  An empty capture observes nothing, so it is taken again;
# ``fn`` then runs once more.
PROFILE_ATTEMPTS = 5


def _captured(what: str, fn, cpu: bool = False):
    """``(events, wall s)`` of one call of ``fn`` under ``torch.profiler``
    (CUDA activity, and CPU with ``cpu``) whose capture holds at least one
    device kernel; a capture with none is taken again, up to
    ``PROFILE_ATTEMPTS`` calls in all, and then fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
        events = prof.events()
        if any(e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation for e in events):
            if attempt > 1:
                log(f"[profile] {what}: the profiler recorded no device "
                    f"kernel in {attempt - 1} capture(s); capture "
                    f"{attempt} did")
            return events, wall
    raise AssertionError(f"{what}: the profiler recorded no device kernel "
                         f"in {PROFILE_ATTEMPTS} calls")


def _device_kernels(fn, what: str = "device kernels") -> dict:
    """``{name: device us}`` of the kernels one call of ``fn`` runs."""
    import torch
    events, _ = _captured(what, fn)
    us = {}
    for e in events:               # kernels, not the spans' device ranges
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            us[e.name] = us.get(e.name, 0.0) + (e.time_range.end
                                                - e.time_range.start)
    return us


def _short_kernel(name: str) -> str:
    """A device kernel's name without its namespaces and arguments."""
    return (name.replace("(anonymous namespace)::", "").split("(")[0]
            .removeprefix("void ").replace("tc::", ""))


def _check_tensor_core_body(name: str, fn) -> None:
    """A bf16 call of ``fn`` (K1-K4) must run the warp-specialised body
    ``attention_ws_kernel`` and no FMA-template ``attention_kernel``; prints
    each device kernel's time in that call (profiler on)."""
    names = _device_kernels(fn, name)
    fma = [n for n in names if "::attention_kernel<" in n]
    if not any("attention_ws_kernel" in n for n in names) or fma:
        raise AssertionError(f"{name}: bf16 device kernels {list(names)}, "
                             f"expected attention_ws_kernel and no FMA "
                             f"template")
    short = [f"{_short_kernel(n)} {us:.1f} us" for n, us in names.items()]
    log(f"[kernel] {name} bf16 device kernels: {short}")


def _split_sweep(B, Lq, Lk, H, D, counts) -> dict:
    """K2 in bf16 at one shape (KV = H, shared tables) with its split count
    forced to each of ``counts`` and to the planner's: the device time of
    one call (all its kernels, profiler on), the planner's choice beside the
    fastest count.  Returns ``{count: device us}``."""
    import torch
    from mmada_parallel_torch.ops.rope_attention import (
        _sm_count, flash_attention_rope_qonly, plan_splits)
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, H * D, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, Lk, H * D, device=dev).to(torch.bfloat16)
            for _ in range(2))
    sin, cos = (t[:Lq].contiguous() for t in _rope_tables(Lk, D, dev))
    plan = plan_splits(B, H, Lq, Lk, _sm_count(dev), D, H)
    us = {}
    for n in sorted({*counts, plan}):
        with _forced_splits(n):
            def call():
                return flash_attention_rope_qonly(q, k, v, sin, cos,
                                                  n_heads=H)
            call()
            us[n] = sum(_device_kernels(
                call, f"K2 split sweep {n}").values())
    best = min(us, key=us.get)
    log(f"[kernel] K2 split sweep B={B} Lq={Lq} Lk={Lk} H=KV={H}: device us "
        f"by split count {{{', '.join(f'{n}: {t:.1f}' for n, t in us.items())}}}"
        f"; planner {plan} ({us[plan]:.1f} us), fastest {best} "
        f"({us[best]:.1f} us)")
    return us


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
    # (g) the bf16 body's edges: one q row; 64 rows (warpgroup 0 alone) and
    # 65 (one row into the second warpgroup); a last q tile of 22 rows
    # (warpgroup 0 alone there, both in the first) in a persistent walk of
    # 384 split items at B=2; a forced split with a padding bias and a
    # row masked on every key (mean(v) across splits, and splits masked for
    # every row of batch row 1); GQA 32/8 split by the planner; D=64 split;
    # a forced split of ragged Lq/Lk with GQA
    recs.append(_qonly_case("g/Lq1", 1, 1, L, H, H, D, bf16, BF16_TOL, gen))
    recs.append(_qonly_case("g/Lq64", 1, 64, L, H, H, D, bf16, BF16_TOL,
                            gen))
    recs.append(_qonly_case("g/Lq65", 1, 65, L, H, H, D, bf16, BF16_TOL,
                            gen))
    recs.append(_qonly_case("g/solo-tail", 2, 150, 517, H, 8, D, bf16,
                            BF16_TOL, gen, n_split=3))
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
    # the device kernels of the planned, an unsplit and a split bf16 call
    q, k = (torch.randn(1, n, H * D, device=dev).to(bf16) for n in (16, L))
    sin, cos = _rope_tables(16, D, dev)
    for n_split in (None, 1, 4):
        with _forced_splits(n_split):
            _check_tensor_core_body(
                f"K2 Lq=16 Lk={L} split "
                f"{'planned' if n_split is None else n_split}",
                lambda: flash_attention_rope_qonly(q, k, k, sin, cos,
                                                   n_heads=H))
    # the planner's choice against other split counts, by device time
    for B, Lq, Lk, counts in ((1, 16, L, (1, 2, 3, 4, 5, 8, 38)),
                              (2, 308, Lm, (1, 2, 3)),
                              (1, T2I_A_PARTIAL, max(_t2i_a_lengths()),
                               (1, 2, 3, 4, 6, 18))):
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
    kernels = _device_kernels(call, f"{label} yardstick")
    log(f"[kernel] {label} yardstick: scaled_dot_product_attention "
        f"{ms:.3f} ms (device {sum(kernels.values()) / 1e3:.3f} ms; {what})"
        f", max |err| against the plain version {err:.3e}, device kernels "
        f"{[n[:80] for n in sorted(kernels)]}")
    return ms


def _blhd_case(name, B, Lq, Lk, H, KV, D, dtype, tol, gen, *, bias=None,
               timed=False, library=False, body=False, repeat=False,
               stats=False) -> dict:
    """K3 vs plain (``_xla_attention``) on BLHD inputs; with ``library``,
    also one SDPA call on the same inputs; ``body``, ``repeat`` and
    ``stats`` as for K1 (``_kernel_case``)."""
    import torch
    from mmada_parallel_torch.ops.attention import _xla_attention
    from mmada_parallel_torch.ops.attention_bwd import (
        attention_stats_reference)
    from mmada_parallel_torch.ops.flash_attention import flash_attention
    dev = torch.device("cuda")
    q = torch.randn(B, Lq, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Lk, KV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Lk, KV, D, generator=gen, device=dev).to(dtype)
    desc = (f"{_desc(B, Lq, Lk, H, KV, D, dtype)}"
            f"{' bias' if bias is not None else ''}")

    def call(with_stats=False):
        return flash_attention(q, k, v, bias, with_stats=with_stats)

    rec = _compare(f"K3 {name}", desc, call,
                   lambda: _xla_attention(q, k, v, bias), tol, timed,
                   _work(q, k, v, H, bias), dtype)
    if body:
        _check_tensor_core_body(f"K3 {name}", call)
    if repeat:
        _repeat_bitwise(f"K3 {name}", lambda: call(with_stats=True))
    if stats:
        _check_stats(f"K3 {name}", call(with_stats=True)[1],
                     attention_stats_reference(q, k, bias))
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
                    timed=True, library=True, body=True, repeat=True)
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
                           BF16_TOL, gen, bias=b5.contiguous(), stats=True))
    # B=2 with Lq and Lk off the 128-row and 128-key tiles: the last tiles'
    # rows meet the batch boundary (the tensor maps' zero fill)
    recs.append(_blhd_case("e/B2-boundary", 2, 1000, 1000, 8, 8, D, bf16,
                           BF16_TOL, gen, stats=True))
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
    # (f) the bf16 body's edges: D=64 causal with GQA 8/2 at an Lq that is
    # no multiple of the 128-row q tile; bounds 0, negative and past Lk
    # with Lq != Lk; a last q tile of 22 rows (warpgroup 0 alone) in a walk
    # of 192 items; a mixed batch at D=64
    recs.append(_prefix_case("f/D64-causal-gqa", 2, 333, 333, 8, 2, 64,
                             bf16, BF16_TOL, gen, _causal_bounds(2, 333,
                                                                 dev)))
    recs.append(_prefix_case("f/edge bounds", 2, 200, 260, 4, 4, 128, bf16,
                             BF16_TOL, gen, hi.to(torch.int32)))
    recs.append(_prefix_case("f/solo-tail causal", 3, 150, 150, H, 8, D,
                             bf16, BF16_TOL, gen,
                             _causal_bounds(3, 150, dev)))
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
    backward at both: K1 below 4096 tokens, with K1's backward kernel, and
    K4 from it, whose backward recomputes the plain chain.  Returns K4's
    launch count."""
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
    for L, want in ((EDIT_L, {"flash_attention_rope": 1,
                              "flash_attention_rope_bwd": 1}),
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


# The backward kernel against its plain version (ops.attention_bwd), both in
# bf16 and both rounding P and dS to bf16 before their products: the scores
# are summed in another order (wgmma against the f32 einsum) and P comes
# from the SFU's 2^x, so a P or dS element can round to the neighbouring
# bf16 value (2^-8 relative), and dq, dk, dv are rounded to bf16.  Each
# gradient is held by its relative L2 from the plain one, ||g - w|| / ||w||,
# and by its largest |g - w| in units
# of w's RMS (one wrong row or tile, which the L2 over millions of elements
# would dilute).  Two controls must fail the L2 gate in every case: the
# kernel's gradient scaled by 1.01 (a 1 % error everywhere) and the plain
# backward with one 128-key tile masked (a kernel that skips a tile).
# Readings and limits: PERF.md section 6.
BWD_REL_L2, BWD_MAX_RMS = 2e-3, 0.25


def _grad_readings(g, w) -> tuple:
    """``(||g - w|| / ||w||, max |g - w| / rms(w))`` in f32."""
    import math
    g, w = g.float(), w.float()
    err, n = g - w, w.norm()
    rms = float(n) / math.sqrt(w.numel())
    if rms == 0:
        return float(err.norm() > 0), float(err.abs().max() > 0)
    return float(err.norm() / n), float(err.abs().max()) / rms


def _bwd_setup(entry: str, B, Lq, Lk, H, KV, D, gen, *, bias=None,
               sin=None, cos=None):
    """bf16 inputs on the card for one backward of ``entry`` (K1, K2, K3)
    and its calls: ``fwd()`` -> (out, stats); ``kernel(out, stats)`` and
    ``plain(out, stats)`` -> (dq, dk, dv); ``chain(q, k, v)`` the plain
    forward chain (whose autograd the Function ran before the kernel);
    ``xs`` (q, k, v), ``dout`` and the other inputs (bias, tables)."""
    import types
    import torch
    from mmada_parallel_torch.ops import attention as A
    from mmada_parallel_torch.ops import attention_bwd as TB
    from mmada_parallel_torch.ops.flash_attention import flash_attention
    from mmada_parallel_torch.ops.rope_attention import (
        _split_tables, flash_attention_rope, flash_attention_rope_qonly)
    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    blhd = entry == "K3"
    shapes = [(B, Lq, H, D), (B, Lk, KV, D), (B, Lk, KV, D)]
    if not blhd:
        shapes = [(b, n, h * d) for b, n, h, d in shapes]
    q, k, v, dout = (torch.randn(*sh, generator=gen, device=dev).to(bf16)
                     for sh in shapes + shapes[:1])
    heads = dict(n_heads=H, n_kv_heads=KV)
    ns = types.SimpleNamespace(xs=(q, k, v), dout=dout,
                               others=[t for t in (bias, sin, cos)
                                       if t is not None])
    if blhd:
        ns.fwd = lambda: flash_attention(q, k, v, bias, with_stats=True)
        ns.kernel = lambda o, st: TB.flash_attention_bwd(q, k, v, bias, o,
                                                         st, dout)
        ns.plain = lambda o, st, b=bias: TB.attention_bwd_reference(
            q, k, v, b, o, st, dout)
        ns.chain = lambda q_, k_, v_: A._xla_attention(q_, k_, v_, bias)
    elif entry == "K1":
        tables = _split_tables(sin, cos, Lq, Lk)
        ns.fwd = lambda: flash_attention_rope(q, k, v, sin, cos, bias,
                                              with_stats=True, **heads)
        ns.kernel = lambda o, st: TB.flash_attention_rope_bwd(
            q, k, v, sin, cos, bias, o, st, dout, **heads)
        ns.plain = lambda o, st, b=bias: TB._rope_bwd_reference(
            q, k, v, *tables, b, o, st, dout, H, KV)
        ns.chain = lambda q_, k_, v_: A._packed_reference(
            q_, k_, v_, sin, cos, bias, H, KV)
    else:
        ns.fwd = lambda: flash_attention_rope_qonly(q, k, v, sin, cos, bias,
                                                    with_stats=True, **heads)
        ns.kernel = lambda o, st: TB.flash_attention_rope_qonly_bwd(
            q, k, v, sin, cos, bias, o, st, dout, **heads)
        ns.plain = lambda o, st, b=bias: TB._rope_bwd_reference(
            q, k, v, sin, cos, None, None, b, o, st, dout, H, KV)
        ns.chain = lambda q_, k_, v_: A._packed_qonly_reference(
            q_, k_, v_, sin, cos, bias, H, KV)
    return ns


def _bwd_bytes(ns, out, stats) -> int:
    """Bytes the backward must move: q, k, v, out, dout, the bias, tables
    and statistics read once; dq, dk, dv (q's, k's, v's sizes) written
    once."""
    ts = [*ns.xs, out, ns.dout, stats, *ns.others, *ns.xs]
    return sum(t.numel() * t.element_size() for t in ts)


def _sdpa_bwd_ms(label: str, ns, bias=None) -> float:
    """The backward of one ``scaled_dot_product_attention`` call on the
    same BLHD inputs, timed: the library yardstick beside K3's backward.
    A bias goes to SDPA as its additive ``attn_mask`` in bf16 (the inputs'
    dtype; -1e30 stays -1e30 to bf16's precision).  The port never calls
    it."""
    import torch
    import torch.nn.functional as F
    q, k, v = (x.transpose(1, 2).detach().requires_grad_(True)
               for x in ns.xs)
    mask = None if bias is None else bias.to(q.dtype)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         enable_gqa=k.shape[1] < q.shape[1])
    g = ns.dout.transpose(1, 2)

    def call():
        return torch.autograd.grad(out, (q, k, v), g, retain_graph=True)

    ms = time_ms(call)
    names = sorted(_device_kernels(call, f"{label} SDPA backward"))
    log(f"[kernel-bwd] {label} yardstick: scaled_dot_product_attention's "
        f"backward{' with the bias as a bf16 attn_mask' if mask is not None else ''}"
        f" {ms:.3f} ms, device kernels {[n[:80] for n in names]}")
    return ms


def _bias_route(bias) -> str:
    """The route by which the backward stages a bias tile: TMA where the
    row stride (Lk * 4 bytes) and the start are 16-byte multiples, the
    producer's cp.async copies elsewhere (attention_mma_bwd.cuh)."""
    return ("TMA" if bias.shape[-1] % 4 == 0 and bias.data_ptr() % 16 == 0
            else "cp.async")


def _bwd_case(name: str, entry: str, B, Lq, Lk, H, KV, D, gen, *, bias=None,
              sin=None, cos=None, timed=False, library=False) -> dict:
    """``entry``'s backward kernel against its plain version on one bf16
    input: every gradient within ``BWD_REL_L2`` and ``BWD_MAX_RMS``, both
    controls outside, two launches bit for bit; timed, also the plain
    backward, the plain chain's autograd (the Function's backward before
    the kernel: the forward recomputed and differentiated) and the bound
    (5 products, 10 B H Lq Lk D FLOPs, on the tensor cores)."""
    import torch
    ns = _bwd_setup(entry, B, Lq, Lk, H, KV, D, gen, bias=bias, sin=sin,
                    cos=cos)
    out, stats = ns.fwd()
    got, again, want = ns.kernel(out, stats), ns.kernel(out, stats), \
        ns.plain(out, stats)
    # control: the plain backward with keys [0, 128) masked
    skip = (torch.zeros(B, 1, Lq, Lk, device=out.device) if bias is None
            else bias.clone())
    skip[..., :128] = -1e30
    dropped = ns.plain(out, stats, skip)
    torch.cuda.synchronize()
    errs, reads, scaled, tile = [], [], [], []
    for what, g, a, w, d in zip(("dq", "dk", "dv"), got, again, want,
                                dropped):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{entry} bwd {name}: {what} not finite")
        if not torch.equal(g, a):
            raise AssertionError(f"{entry} bwd {name}: two launches differ "
                                 f"in {what}")
        errs.append(float((g.float() - w.float()).abs().max()))
        reads.append(_grad_readings(g, w))
        scaled.append(_grad_readings(g.float() * 1.01, w)[0])
        tile.append(_grad_readings(d, w)[0])
    readings = (f"relative L2 dq/dk/dv {[f'{r[0]:.3e}' for r in reads]}, "
                f"max|err|/rms {[f'{r[1]:.3f}' for r in reads]} (limits "
                f"{BWD_REL_L2}, {BWD_MAX_RMS}); controls' relative L2: "
                f"x1.01 {[f'{x:.3e}' for x in scaled]}, one key tile "
                f"dropped {[f'{x:.3e}' for x in tile]}")
    if not all(r <= BWD_REL_L2 and m <= BWD_MAX_RMS for r, m in reads):
        raise AssertionError(f"{entry} bwd {name}: disagrees with the plain "
                             f"backward: {readings}")
    if not (min(scaled) > BWD_REL_L2 and max(tile) > BWD_REL_L2):
        raise AssertionError(f"{entry} bwd {name}: a control passes the "
                             f"gate: {readings}")
    rec = {"max_abs_err": max(errs), "ms": None, "plain_ms": None,
           "bound_ms": None, "bound_by": None, "library_ms": None,
           "rel_l2": max(r[0] for r in reads),
           "max_rms": max(r[1] for r in reads)}
    desc = (f"{_desc(B, Lq, Lk, H, KV, D, torch.bfloat16)}"
            f"{f' bias ({_bias_route(bias)} route)' if bias is not None else ''}"
            f"{' per-row tables' if sin is not None and sin.ndim == 3 else ''}")
    times = ""
    if timed:
        rec["ms"] = time_ms(lambda: ns.kernel(out, stats))
        rec["plain_ms"] = time_ms(lambda: ns.plain(out, stats), reps=3,
                                  warmup=1)
        req = [x.detach().requires_grad_(True) for x in ns.xs]
        rec["chain_ms"] = time_ms(lambda: torch.autograd.grad(
            ns.chain(*req), req, ns.dout), reps=3, warmup=1)
        rec["bound_ms"], rec["bound_by"] = _bound(
            10 * B * H * Lq * Lk * D, _bwd_bytes(ns, out, stats),
            torch.bfloat16)
        parts = _device_kernels(lambda: ns.kernel(out, stats),
                                f"{entry} bwd {name}")
        times = (f" kernel {rec['ms']:.3f} ms, plain backward "
                 f"{rec['plain_ms']:.3f} ms, plain chain's autograd "
                 f"(forward + backward) {rec['chain_ms']:.3f} ms, bound "
                 f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                 f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of bound; "
                 f"device us by kernel (profiler on): " + ", ".join(
                     f"{_short_kernel(n)} {us:.1f}"
                     for n, us in sorted(parts.items())))
    if library:
        rec["library_ms"] = _sdpa_bwd_ms(f"{entry} bwd {name}", ns,
                                         bias=bias)
    log(f"[kernel-bwd] {entry} bwd {name}: {desc} max|err| dq/dk/dv "
        f"{[f'{e:.3e}' for e in errs]}, {readings}, two launches "
        f"bitwise equal{times}")
    return rec


def phase_kernel_bwd() -> dict:
    """The backward kernels (``csrc/attention_bwd.cu``) against their plain
    versions in bf16: the rotation post-pass bit for bit against its plain
    version; K1, K2 and K3 at the tensor-core body's edges (D=64, ragged
    Lq/Lk, GQA, per-row tables with fully masked rows, an odd Lk with a
    bias, K2 split forwards whose statistics come from the combine), each
    twice bit for bit; the redesign's edges: the bias staged by TMA (Lk %
    4 == 0) and by the producer's cp.async (odd Lk, Lk % 4 == 2), one q
    tile (Lq <= 64, fewer tiles than the ring's stages), G = 4 (the dK/dV
    loop crosses heads), B = 2 with Lq and Lk off the 64-row tiles (the
    tensor maps' zero fill at a batch boundary); timed with their bounds at
    the training shapes: K1 at the A step's (B=1, L=5120, H=32) and the M
    trainer's (B=1, L=2565, its key-padding bias), K2 at the training
    ring's (B=1, Lq=606, Lk=2424, H=KV=16, sigma-gathered tables), K3 at
    B=1 L=2424 and 5120 and at the M trainer's shape with its bias, each
    beside SDPA's backward (the bias as a bf16 mask).  Returns each
    backward's record."""
    import torch
    from mmada_parallel_torch.ops import attention_bwd as TB
    from mmada_parallel_torch.parallel.tp_overlap import sigma_positions
    gen = torch.Generator(device="cuda").manual_seed(21)
    dev = torch.device("cuda")
    H, D = EDIT_H, EDIT_D
    # the rotation post-pass alone
    sin, cos = _rope_tables(300, D, dev)
    dy = torch.randn(2, 300, 4 * D, generator=gen, device=dev).to(
        torch.bfloat16)
    got = TB.rope_rotate_backward(dy, sin, cos, n_heads=4)
    want = TB.rope_rotate_backward(dy.cpu(), sin.cpu(), cos.cpu(), n_heads=4)
    if not torch.equal(got.cpu(), want):
        raise AssertionError("rope_rotate_backward: the post-pass differs "
                             "from its plain version")
    log("[kernel-bwd] rotation post-pass (the transposed Neox rotation) "
        "B=2 L=300 NH=4 D=128 bf16: bitwise equal to its plain version")
    recs, cases = {}, []

    def case(*args, **kw):
        cases.append(_bwd_case(*args, **kw))
        return cases[-1]
    # K1: the edges, then the A step's and the M trainer's shapes
    pos, b = _ragged(2, 301, (301, 173), dev)
    s_t, c_t = _rope_tables(301, 64, dev)
    case("D64 ragged GQA per-row bias odd-L", "K1", 2, 301, 301, 4, 2,
         64, gen, bias=b, sin=s_t[pos].contiguous(),
         cos=c_t[pos].contiguous())
    s_t, c_t = _rope_tables(517, D, dev)
    case("GQA 32/8", "K1", 1, 517, 517, H, 8, D, gen, sin=s_t, cos=c_t)
    s_t, c_t = _rope_tables(TRAIN_L, D, dev)
    a = case("A-train", "K1", 1, TRAIN_L, TRAIN_L, H, H, D, gen,
             sin=s_t, cos=c_t, timed=True)
    m_mask = _m_cli_mask(dev)
    Lc = m_mask.shape[1]
    s_t, c_t = _rope_tables(Lc, D, dev)
    m = case("M-trainer", "K1", 1, Lc, Lc, H, H, D, gen,
             bias=_mask_bias(m_mask), sin=s_t, cos=c_t, timed=True)
    s_t, c_t = _rope_tables(196, 64, dev)
    e3 = case("D64 G=4 B=2 off-tile bias", "K1", 2, 196, 196, 8, 2, 64, gen,
              bias=_pad_bias([196, 150], 196, 196, dev), sin=s_t, cos=c_t)
    recs["flash_attention_rope_bwd"] = dict(
        a, max_abs_err=max(x["max_abs_err"] for x in (a, m, e3)))
    # K2: per-row q tables with a bias at an odd Lk; split forwards (their
    # statistics from the combine); the training ring's chunk
    s_t, c_t = _rope_tables(301, 64, dev)
    qpos = torch.stack([torch.randperm(301, generator=gen, device=dev)[:40]
                        for _ in range(2)]).sort(dim=1).values
    e1 = case("D64 per-row bias odd-Lk", "K2", 2, 40, 301, 4, 2, 64,
              gen, bias=_pad_bias([301, 200], 40, 301, dev).contiguous(),
              sin=s_t[qpos].contiguous(), cos=c_t[qpos].contiguous())
    s_t, c_t = _rope_tables(640, D, dev)
    for n_split in (2, 5):
        with _forced_splits(n_split):
            e2 = case(f"split {n_split} (forced) bias", "K2", 1, 16,
                      640, 8, 8, D, gen,
                      bias=_pad_bias([600], 16, 640, dev).contiguous(),
                      sin=s_t[:16].contiguous(),
                      cos=c_t[:16].contiguous())
            e1 = dict(e1, max_abs_err=max(e1["max_abs_err"],
                                          e2["max_abs_err"]))
    g, Hr, L = 2, EDIT_H // 2, EDIT_L
    C = L // g
    rpos = sigma_positions(g, C, 1, dev)[C // 2:C]   # rank 1's second half
    s_t, c_t = _rope_tables(L, D, dev)
    r = case("ring-train", "K2", 1, C // 2, L, Hr, Hr, D, gen,
             sin=s_t[rpos].contiguous(), cos=c_t[rpos].contiguous(),
             timed=True)
    recs["flash_attention_rope_qonly_bwd"] = dict(
        r, max_abs_err=max(r["max_abs_err"], e1["max_abs_err"]))
    # K3: an odd Lk with a bias and a fully masked row; ragged GQA; then
    # B=1 at 2424 (its record) and at 5120, each beside SDPA's backward
    b5 = _pad_bias([301, 250], 190, 301, dev)
    b5[0, 0, 7, :] = -1e30
    x1 = case("D64 odd-Lk bias masked-row", "K3", 2, 190, 301, 4, 2, 64,
              gen, bias=b5.contiguous())
    x2 = case("ragged GQA 32/8", "K3", 1, 333, 517, H, 8, D, gen)
    x3 = case("B=2 off-tile bias Lk%4=0", "K3", 2, 190, 300, 4, 2, D, gen,
              bias=_pad_bias([300, 150], 190, 300, dev))
    x4 = case("one q tile bias", "K3", 1, 40, 256, 4, 4, 64, gen,
              bias=_pad_bias([200], 40, 256, dev))
    x5 = case("G=4 B=2 off-tile bias odd-Lk", "K3", 2, 130, 203, 8, 2, D,
              gen, bias=_pad_bias([203, 120], 130, 203, dev))
    x6 = case("B=2 bias Lk%4=2", "K3", 2, 70, 130, 4, 4, D, gen,
              bias=_pad_bias([130, 60], 70, 130, dev))
    e = case("edit", "K3", 1, EDIT_L, EDIT_L, H, H, D, gen, timed=True,
             library=True)
    t = case("A-train", "K3", 1, TRAIN_L, TRAIN_L, H, H, D, gen,
             timed=True, library=True)
    k3m = case("M-trainer", "K3", 1, Lc, Lc, H, H, D, gen,
               bias=_mask_bias(m_mask), timed=True, library=True)
    # the same padding at Lk % 4 == 0: the bias by TMA, for the route's cost
    k3t = case("M-trainer-like Lk%4=0", "K3", 1, Lc + 3, Lc + 3, H, H, D,
               gen, bias=_mask_bias(torch.cat([m_mask, m_mask[:, :3] & False], 1)),
               timed=True)
    recs["flash_attention_bwd"] = dict(
        e, max_abs_err=max(x["max_abs_err"] for x in (x1, x2, x3, x4, x5,
                                                      x6, e, t, k3m, k3t)))
    log(f"[kernel-bwd] K1 A-train {a['ms']:.3f} ms (bound "
        f"{a['bound_ms']:.4f} ms, plain chain {a['chain_ms']:.3f} ms), "
        f"M-trainer {m['ms']:.3f} ms (bound {m['bound_ms']:.4f}, plain chain"
        f" {m['chain_ms']:.3f}); K2 ring-train {r['ms']:.3f} ms (bound "
        f"{r['bound_ms']:.4f}, plain chain {r['chain_ms']:.3f}); K3 L="
        f"{EDIT_L} {e['ms']:.3f} ms (SDPA backward {e['library_ms']:.3f}), "
        f"L={TRAIN_L} {t['ms']:.3f} ms (SDPA backward "
        f"{t['library_ms']:.3f}), M-trainer with its bias {k3m['ms']:.3f} ms"
        f" (bound {k3m['bound_ms']:.4f}, SDPA backward with the bf16 mask "
        f"{k3m['library_ms']:.3f}), its TMA-route twin at L={Lc + 3} "
        f"{k3t['ms']:.3f} ms); largest readings over the {len(cases)} "
        f"cases: relative L2 {max(c['rel_l2'] for c in cases):.3e} (limit "
        f"{BWD_REL_L2}), max|err|/rms {max(c['max_rms'] for c in cases):.3f}"
        f" (limit {BWD_MAX_RMS})")
    return recs


# The Functions' bf16 gradients: each within GRAD_BF16_RATIO times the bf16
# plain chain's own distance (relative L2) from the f32 plain chain on the
# same inputs (the bf16 inputs upcast): the backward kernel rounds P and dS
# to bf16 where the plain chain rounds dP and the gradients, so it is
# another sample of bf16 noise around the f32 gradient, not the plain
# chain's, and a wrong kernel is far outside it.
GRAD_BF16_RATIO = 1.5
# each entry point's forward and backward launch counters
GRAD_ROUTES = {"K1 rope_attention": ("flash_attention_rope",
                                     "flash_attention_rope_bwd"),
               "K2 rope_attention_qonly": ("flash_attention_rope_qonly",
                                           "flash_attention_rope_qonly_bwd"),
               "K3 dot_product_attention": ("flash_attention",
                                            "flash_attention_bwd"),
               "K4 rope_attention_prefix": ("flash_attention_rope_prefix",
                                            None)}


# GroupNorm + swish (csrc/group_norm.cu) at the tokenizers' shapes: the
# MagViT-v2 encoder's levels 0, 1 (its first block's norm1 and the rest) and
# 3 at the M trainer's batch of 4, and Amused-VQ decode shapes at B=1;
# contiguous and channels-last ("cl": the layout the tokenizers' residual
# stream has after the NHWC pixels' permute, which the norm keeps; the
# main path's phases log which route each shape takes)
GN_CASES = (("magvit/L0", (4, 128, 512, 512), False),
            ("magvit/L0-cl", (4, 128, 512, 512), True),
            ("magvit/L1-norm1-cl", (4, 128, 256, 256), True),
            ("magvit/L1", (4, 256, 256, 256), False),
            ("magvit/L1-cl", (4, 256, 256, 256), True),
            ("magvit/L3", (4, 512, 64, 64), False),
            ("magvit/L3-cl", (4, 512, 64, 64), True),
            ("amused-dec/L0-norm1-cl", (1, 256, 512, 512), True),
            ("amused-dec/L0-norm1", (1, 256, 512, 512), False),
            ("amused-dec/L0", (1, 128, 512, 512), False),
            ("amused-dec/L2-norm1-cl", (1, 512, 128, 128), True),
            ("amused-dec/L2-norm1", (1, 512, 128, 128), False))
GN_F32_TOL = dict(atol=1e-5, rtol=1e-5)
# one bf16 ulp, and the f32 tolerance near 0, where the two f32 values
# before the rounding differ by more than an ulp (the statistics' rounding)
GN_BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)


def _gn_inputs(shape, dtype, gen, offset=0.5, cl=False):
    import torch
    B, C = shape[:2]
    x = torch.randn(*shape, generator=gen, device="cuda") * 2.0 + offset
    fmt = torch.channels_last if cl else torch.contiguous_format
    return (x.to(dtype=dtype, memory_format=fmt),
            torch.rand(C, generator=gen, device="cuda") + 0.5,
            torch.rand(C, generator=gen, device="cuda") - 0.5)


def phase_kernel_group_norm() -> dict:
    """The fused GroupNorm + swish against its plain chain at the
    tokenizers' shapes, contiguous and channels-last (f32 with and without
    the swish, bf16 without it), timed against the plain chain, its bound
    (2 x input bytes at 3.35 TB/s) and ``F.silu(F.group_norm(...))`` as the
    library yardstick; and ragged groups.  Returns the timed records by
    case name."""
    import torch
    import torch.nn.functional as F
    from mmada_parallel_torch.ops import group_norm as GN
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    records = {}
    before = GN.group_norm_swish.launches
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, shape, cl in GN_CASES:
        x, sc, bi = _gn_inputs(shape, f32, gen, cl=cl)
        B, C, H, W = shape
        plan = (GN.channels_last_plan(B, C, H * W, 32, 4, sms) if cl
                else GN.plan_group_norm(B, C, H * W, 32, 4, sms))
        desc = f"B={B} C={C} {H}x{W} f32 swish, {plan}"
        rec = _compare(f"group_norm {name}", desc,
                       lambda: GN.group_norm_swish(x, sc, bi),
                       lambda: GN.group_norm_swish_reference(x, sc, bi, 32,
                                                             1e-6),
                       GN_F32_TOL, True, (8 * x.numel(), 2 * x.numel() * 4),
                       f32)
        lib = lambda: F.silu(F.group_norm(x, 32, sc, bi, 1e-6))
        rec["library_ms"] = time_ms(lib)
        rec["library_device_ms"] = sum(
            _device_kernels(lib, f"library {name}").values()) / 1e3
        rec["kernels_us"] = {_short_kernel(n): us for n, us in
                             _device_kernels(lambda: GN.group_norm_swish(
                                 x, sc, bi), f"group_norm {name}").items()}
        log(f"[kernel] group_norm {name}: device kernels "
            f"{ {k: round(v, 1) for k, v in rec['kernels_us'].items()} }; "
            f"F.silu(F.group_norm) {rec['library_ms']:.3f} ms (device "
            f"{rec['library_device_ms']:.3f} ms)")
        _compare(f"group_norm {name}", "f32 no swish",
                 lambda: GN.group_norm_swish(x, sc, bi, swish=False),
                 lambda: GN.group_norm_swish_reference(x, sc, bi, 32, 1e-6,
                                                       False),
                 GN_F32_TOL, False)
        xb = x.to(bf16)
        _compare(f"group_norm {name}", "bf16 no swish",
                 lambda: GN.group_norm_swish(xb, sc, bi, swish=False),
                 lambda: GN.group_norm_swish_reference(xb, sc, bi, 32, 1e-6,
                                                       False),
                 GN_BF16_TOL, False)
        a = GN.group_norm_swish(x, sc, bi)
        if not torch.equal(a, GN.group_norm_swish(x, sc, bi)):
            raise AssertionError(f"group_norm {name}: not bitwise equal on "
                                 f"a repeat")
        records[name] = rec
        del x, xb, a
    # ragged groups: 3 channels of 601 x 601 (1 083 603 elements), and 3 of
    # 7 x 7, whose channels of 49 elements cross the 16-byte vectors
    for shape, groups in (((1, 96, 601, 601), 32), ((2, 6, 7, 7), 2)):
        x, sc, bi = _gn_inputs(shape, f32, gen)
        _compare("group_norm ragged", f"{list(shape)} G={groups} f32",
                 lambda: GN.group_norm_swish(x, sc, bi, groups),
                 lambda: GN.group_norm_swish_reference(x, sc, bi, groups,
                                                       1e-6),
                 GN_F32_TOL, False)
    calls = GN.group_norm_swish.launches - before
    log(f"[kernel] group_norm: {calls} kernel calls in the checks")
    return records


# The backbone's RMSNorm (csrc/rms_norm.cu) at the main path's shapes: the
# edit's B=1 and B=2 forwards (d 4096, L 2424); SDAR-30B-A3B's decode
# forward (16 rows x a block of 4, d 2048), 64 positions a row, its
# per-head q and k norms (width 128) and its prefill (16 prompts of 4096).
RMS_CASES = (("edit B=1", (1, 2424, 4096)), ("edit B=2", (2, 2424, 4096)),
             ("sdar decode", (16, 4, 2048)), ("sdar 64", (16, 64, 2048)),
             ("sdar decode q", (16, 4, 32, 128)),
             ("sdar 64 q", (16, 64, 32, 128)), ("sdar 64 k", (16, 64, 4, 128)),
             ("sdar prefill", (16, 4096, 2048)),
             ("sdar prefill k", (16, 4096, 4, 128)))
# against the plain chain in bf16: the two round at the same points and sum
# the squares in another order, so at least this share of the elements is
# equal and none is more than RMS_MAX_ULPS bf16 ulps away; in f32 every
# element within RMS_F32_RTOL (a few f32 ulps of the rsqrt's input)
RMS_EQUAL_SHARE, RMS_MAX_ULPS, RMS_F32_RTOL = 0.999, 2, 1e-6
# the edit's shape at other plans than the planner's: (threads a row,
# vectors a thread)
RMS_SWEEP = ((64, 8), (128, 4), (256, 2), (512, 1))
# the rms_norm launches of the main path's phases (phase -> launches)
RMS_RUNS = {}


def bf16_ulps(a, b):
    """Elementwise distance of two bf16 tensors in ulps (+0 and -0 equal)."""
    import torch

    def key(t):
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits + 32768), bits)
    return (key(a) - key(b)).abs()


def check_rms_agreement(name: str, got, want) -> dict:
    """The kernel's output against the plain chain's: the share of equal
    elements and the largest distance (bf16 ulps, or f32 relative), held
    to ``RMS_EQUAL_SHARE`` and ``RMS_MAX_ULPS`` or ``RMS_F32_RTOL``."""
    import torch
    if got.dtype == torch.bfloat16:
        ulps = bf16_ulps(got, want)
        a = {"equal_share": float((ulps == 0).float().mean()),
             "max_ulps": int(ulps.max())}
        ok = (a["equal_share"] >= RMS_EQUAL_SHARE
              and a["max_ulps"] <= RMS_MAX_ULPS)
    else:
        rel = (got - want).abs() / want.abs().clamp_min(1e-30)
        a = {"equal_share": float((got == want).float().mean()),
             "max_rel": float(rel.max())}
        ok = a["max_rel"] <= RMS_F32_RTOL
    if not ok:
        raise AssertionError(f"{name}: the kernel off the plain chain: {a}")
    return a


def phase_kernel_rms_norm() -> dict:
    """The RMSNorm kernel against the plain chain at ``RMS_CASES`` (bf16 x
    and weight; the edit's shape also with an f32 weight and in f32),
    timed against its bound (``ops.rms_norm.norm_bytes`` at 3.35 TB/s),
    the plain chain and ``F.rms_norm`` as the library yardstick (the port
    never calls it); the edit's shape at the plans of ``RMS_SWEEP``; bits
    on a repeat and one row alone against its batch.  Returns the timed
    records by case name."""
    import torch
    import torch.nn.functional as F
    from mmada_parallel_torch.ops import rms_norm as RN
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, eps = torch.bfloat16, 1e-5
    records = {}
    before = RN.rms_norm.launches
    for name, shape in RMS_CASES:
        width = shape[-1]
        x = torch.randn(shape, generator=gen, device="cuda").to(bf16)
        w = (1 + 0.1 * torch.randn(width, generator=gen,
                                   device="cuda")).to(bf16)
        plan = RN.plan_rms_norm(width, 2)
        got = RN.rms_norm(x, w, eps)
        rec = check_rms_agreement(f"rms_norm {name}", got,
                                  RN.rms_norm_reference(x, w, eps))
        if not torch.equal(got, RN.rms_norm(x, w, eps)) or not torch.equal(
                got[:1], RN.rms_norm(x[:1].clone(), w, eps)):
            raise AssertionError(f"rms_norm {name}: not bitwise equal on a "
                                 f"repeat or for its first row alone")
        nbytes = RN.norm_bytes(x, w)
        rec.update(shape=list(shape), plan=list(plan),
                   ms=time_ms(lambda: RN.rms_norm(x, w, eps), reps=20),
                   plain_ms=time_ms(lambda: RN.rms_norm_reference(x, w, eps),
                                    reps=20),
                   library_ms=time_ms(lambda: F.rms_norm(x, (width,), w, eps),
                                      reps=20),
                   bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes")
        kernels = _device_kernels(lambda: RN.rms_norm(x, w, eps),
                                  f"rms_norm {name}")
        if [_short_kernel(n).split("<")[0] for n in kernels] != [
                "rmsn::rms_norm_kernel"]:
            raise AssertionError(f"rms_norm {name}: device kernels "
                                 f"{list(kernels)}")
        rec["device_ms"] = sum(kernels.values()) / 1e3
        rec["plain_device_ms"] = sum(_device_kernels(
            lambda: RN.rms_norm_reference(x, w, eps),
            f"rms_norm plain {name}").values()) / 1e3
        rec["library_device_ms"] = sum(_device_kernels(
            lambda: F.rms_norm(x, (width,), w, eps),
            f"rms_norm library {name}").values()) / 1e3
        log(f"[kernel] rms_norm {name}: {list(shape)} bf16 {plan}; equal "
            f"{rec['equal_share']:.6f}, max {rec['max_ulps']} ulps; kernel "
            f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f} ms), bound "
            f"{rec['bound_ms']:.4f} ms (bytes), "
            f"{100 * rec['bound_ms'] / rec['device_ms']:.1f} % of bound by "
            f"device time; plain chain {rec['plain_ms']:.4f} ms (device "
            f"{rec['plain_device_ms']:.4f}); F.rms_norm {rec['library_ms']:.4f}"
            f" ms (device {rec['library_device_ms']:.4f})")
        records[name] = rec
        if name == "edit B=1":
            sweep = {}
            for threads, vecs in RMS_SWEEP:
                p = RN.Plan(threads, vecs, 1)
                check_rms_agreement(f"rms_norm {name} {p}",
                                    RN._launch(x, w, eps, p), got)
                sweep[f"{threads}x{vecs}"] = sum(_device_kernels(
                    lambda: RN._launch(x, w, eps, p),
                    f"rms_norm {name} {p}").values())
            rec["sweep_device_us"] = sweep
            log(f"[kernel] rms_norm {name}: device us by (threads a row x "
                f"vectors a thread): { {k: round(v, 2) for k, v in sweep.items()} }"
                f"; the planner's {plan.row_threads}x{plan.vecs}")
            wf = w.float()
            check_rms_agreement(f"rms_norm {name} f32 weight",
                                RN.rms_norm(x, wf, eps),
                                RN.rms_norm_reference(x, wf, eps))
            xf = x.float()
            rec["f32"] = check_rms_agreement(
                f"rms_norm {name} f32", RN.rms_norm(xf, wf, eps),
                RN.rms_norm_reference(xf, wf, eps))
        del x, got
    torch.cuda.empty_cache()
    log(f"[kernel] rms_norm: {RN.rms_norm.launches - before} kernel calls "
        f"in the checks")
    return records


def check_rms_launches(phase: str, cfg, forwards: int) -> int:
    """The RMSNorm kernel's launches since the last reset must be the
    backbone's norms of ``forwards`` inference forwards: two a layer and
    ``ln_f`` (four a layer with q/k norms), and none of the plain chain."""
    from mmada_parallel_torch.ops.rms_norm import rms_norm
    per = (4 if cfg.attention_layer_norm else 2) * cfg.n_layers + 1
    if rms_norm.launches != per * forwards:
        raise AssertionError(f"{phase}: rms_norm launches "
                             f"{rms_norm.launches}, expected {per} x "
                             f"{forwards} forwards")
    log(f"[norm] {phase}: rms_norm {rms_norm.launches} launches ({per} x "
        f"{forwards} forwards)")
    RMS_RUNS[phase] = rms_norm.launches
    return rms_norm.launches


# The mixture of experts' grouped GEMM (csrc/moe_grouped_gemm.cu) at
# SDAR-30B-A3B's widths: d 2048, 128 experts of 768, top-8; at the block
# sampler's decode forward (16 rows x a block of 4 = 64 tokens, 16-row
# tiles) and at its prefill (16 prompts of 4096 = 65,536 tokens, 128-row
# tiles)
MOE_D, MOE_M, MOE_E, MOE_K = 2048, 768, 128, 8
MOE_CASES = (("decode", 64), ("prefill", 65536))
# bf16 tolerances, relative to the largest magnitude of the plain result:
# the gate/up launch rounds its SwiGLU rows to bf16 once (2^-8 relative,
# with room for f32 summation order); the down launch writes f32 rows of the
# same bf16 operands, apart only in summation order; the whole layer
# against the f32 loop of the same operands within twice the bf16 loop's
# own distance from it (at least 4e-3: the layer rounds its rows twice)
MOE_GLU_REL, MOE_DOWN_REL, MOE_LAYER_FLOOR = 8e-3, 1e-4, 4e-3


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _moe_case(case: str, T: int, gen) -> dict:
    """Both grouped launches at ``T`` tokens against
    ``grouped_gemm_reference`` (f32 products of the same bf16 operands),
    the layer (``moe_mlp``) against the plain loop over experts in f32, a
    bitwise repeat; timed by CUDA events against their bound, the plain
    loop (``experts_reference`` in bf16) and ``torch._grouped_mm`` on the
    same sorted rows where the build has it."""
    import torch
    import torch.nn.functional as F
    from mmada_parallel_torch.ops import moe as MO
    bf = torch.bfloat16
    D, M, E, K = MOE_D, MOE_M, MOE_E, MOE_K
    gate = torch.randn(E, D, M, device="cuda", generator=gen).mul_(0.02).to(bf)
    up = torch.randn(E, D, M, device="cuda", generator=gen).mul_(0.02).to(bf)
    down = (torch.randn(E, M, D, device="cuda", generator=gen)
            .mul_(0.02 / 96 ** 0.5).to(bf))
    router = torch.randn(D, E, device="cuda", generator=gen).mul_(0.02).to(bf)
    x = torch.randn(T, D, device="cuda", generator=gen).to(bf)
    w, ids = MO.route(x, router, K, True)
    A = T * K
    tile = MO.SMALL_TILE if A <= MO.SMALL_ROWS_MAX * E else MO.LARGE_TILE
    if tile != (MO.SMALL_TILE if case == "decode" else MO.LARGE_TILE):
        raise AssertionError(f"moe {case}: {tile}-row tiles at {T} tokens")
    p = MO.plan(ids, E, tile)
    scale = w.reshape(-1)
    mid = MO.grouped_gemm(x, p, gate, up, top_k=K, glu=True)
    ref_mid = MO.grouped_gemm_reference(x, p, gate, up, top_k=K, glu=True)
    y = MO.grouped_gemm(mid, p, down, scale=scale, top_k=K, glu=False)
    ref_y = MO.grouped_gemm_reference(mid, p, down, scale=scale, top_k=K,
                                      glu=False)
    out = MO.moe_mlp(x, router, gate, up, down, K, True)
    loop = MO.experts_reference(x, w, ids, gate, up, down)
    exact = MO.experts_reference(x.float(), w.float(), ids, gate.float(),
                                 up.float(), down.float())
    rec = {"tokens": T, "tile_rows": tile,
           "glu_rel_err": _rel_err(mid, ref_mid),
           "down_rel_err": _rel_err(y, ref_y),
           "layer_rel_err": _rel_err(out, exact),
           "loop_rel_err": _rel_err(loop, exact),
           "max_abs_err": max(float((mid.float() - ref_mid.float()).abs()
                                    .max()),
                              float((y - ref_y).abs().max()))}
    del exact, loop
    if rec["glu_rel_err"] > MOE_GLU_REL or rec["down_rel_err"] > MOE_DOWN_REL \
            or rec["layer_rel_err"] > 2 * max(rec["loop_rel_err"],
                                              MOE_LAYER_FLOOR):
        raise AssertionError(f"moe {case}: the grouped launches off their "
                             f"plain versions: {rec}")
    if not (torch.equal(mid, MO.grouped_gemm(x, p, gate, up, top_k=K,
                                             glu=True))
            and torch.equal(out, MO.moe_mlp(x, router, gate, up, down, K,
                                            True))):
        raise AssertionError(f"moe {case}: not bitwise equal on a repeat")
    touched = int((p.counts > 0).sum())
    flops = 2 * A * 3 * D * M
    nbytes = touched * 3 * D * M * 2 + T * D * 2 + 2 * A * M * 2 + A * D * 4

    def launches():
        h = MO.grouped_gemm(x, p, gate, up, top_k=K, glu=True)
        return MO.grouped_gemm(h, p, down, scale=scale, top_k=K, glu=False)

    rec.update(experts_touched=touched, flops=flops, bytes=nbytes,
               ms=time_ms(launches),
               plain_ms=time_ms(lambda: MO.experts_reference(
                   x, w, ids, gate, up, down), reps=3, warmup=1),
               layer_ms=time_ms(lambda: MO.moe_mlp(x, router, gate, up,
                                                   down, K, True)))
    rec["bound_ms"], rec["bound_by"] = _bound(flops, nbytes, bf)
    # the two grouped launches, and the down launch's cast of the bf16
    # routing weights to f32 (as ``moe_mlp`` passes them)
    kernels = _device_kernels(launches, f"moe {case}")
    grouped = [n for n in kernels if "grouped_gemm_kernel" in n]
    if len(grouped) != 2:
        raise AssertionError(f"moe {case}: device kernels {list(kernels)}, "
                             f"expected two grouped launches")
    rec["device_ms"] = sum(kernels[n] for n in grouped) / 1e3
    rec["kernels"] = sorted(_short_kernel(n)[:60] for n in kernels)
    gm = getattr(torch, "_grouped_mm", None)
    rec["library_ms"] = None
    if gm is None:
        rec["library"] = "torch._grouped_mm: not in this build"
    else:
        xs = x[p.rows.long() // K]
        ends = p.offsets[1:].contiguous()

        def library():
            h = F.silu(gm(xs, gate, offs=ends)) * gm(xs, up, offs=ends)
            return gm(h, down, offs=ends)
        try:
            lib_h = F.silu(gm(xs, gate, offs=ends)) * gm(xs, up, offs=ends)
            rec["library_rel_err"] = _rel_err(lib_h, ref_mid)
            rec["library_ms"] = time_ms(library)
            rec["library"] = "torch._grouped_mm (gate, up, down)"
        except (RuntimeError, TypeError) as e:
            rec["library"] = f"torch._grouped_mm refused: {e}"[:300]
    log(f"[kernel] moe_grouped_gemm {case}: T={T} ({A} assignments, "
        f"{touched} experts touched, {tile}-row tiles) glu rel err "
        f"{rec['glu_rel_err']:.2e} down {rec['down_rel_err']:.2e} layer "
        f"{rec['layer_rel_err']:.2e} (bf16 loop {rec['loop_rel_err']:.2e}); "
        f"two launches {rec['ms']:.3f} ms (device {rec['device_ms']:.3f} "
        f"ms), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
        f"{100 * rec['bound_ms'] / rec['ms']:.1f} % of bound; layer "
        f"{rec['layer_ms']:.3f} ms; plain loop {rec['plain_ms']:.3f} ms; "
        f"{rec['library']}: {rec['library_ms']} ms; kernels "
        f"{rec['kernels']}")
    del gate, up, down, x
    torch.cuda.empty_cache()
    return rec


def phase_kernel_moe() -> dict:
    """The grouped GEMM at the decode and the prefill shape
    (:func:`_moe_case`).  Returns the records by case."""
    import torch
    from mmada_parallel_torch.ops import moe as MO
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = MO.grouped_gemm.launches
    records = {case: _moe_case(case, T, gen) for case, T in MOE_CASES}
    log(f"[kernel] moe_grouped_gemm: {MO.grouped_gemm.launches - before} "
        f"kernel calls in the checks")
    return records


def _function_grads(fn, xs, w, runs) -> dict:
    """``{(impl, dtype): (out, [dq, dk, dv], launches)}`` of
    ``(fn(q, k, v, impl).float() * w).sum()`` for each ``(impl, dtype)``
    of ``runs``, the inputs cast to ``dtype``."""
    import torch
    res = {}
    for impl, dt in runs:
        reset_launches()
        ins = [x.detach().to(dt).requires_grad_(True) for x in xs]
        out = fn(*ins, impl)
        (out.float() * w).sum().backward()
        torch.cuda.synchronize()
        res[impl, dt] = (out.detach().float(), [t.grad.float() for t in ins],
                         read_launches())
    return res


def _check_function_grads(name: str, res: dict, dtype, tol, route) -> str:
    """The Function (``pallas``) against plain autograd (``xla``): one
    forward launch and, for bf16 K1-K3, one backward launch; the forward
    within the kernel's ``tol``; f32 gradients within ``tol`` (the backward
    recomputes the plain chain); bf16 gradients within ``GRAD_BF16_RATIO``
    of the bf16 plain chain's distance from the f32 chain.  Returns the
    readings for the log."""
    import torch
    fwd, bwd = route
    bf16 = dtype == torch.bfloat16
    want = {fwd: 1, **({bwd: 1} if bf16 and bwd else {})}
    got = {k: v for k, v in res["pallas", dtype][2].items() if v}
    if got != want or any(res["xla", dtype][2].values()):
        raise AssertionError(f"{name} {dtype}: launches {got} (Function), "
                             f"expected {want}; plain "
                             f"{res['xla', dtype][2]}")
    out_k, grads_k, _ = res["pallas", dtype]
    out_p, grads_p, _ = res["xla", dtype]
    err = float((out_k - out_p).abs().max())
    if not torch.allclose(out_k, out_p, **tol):
        raise AssertionError(f"{name} {dtype}: forward max |err| {err:.3e} "
                             f"({tol})")
    if not bf16:
        errs = [float((a - b).abs().max()) for a, b in zip(grads_k, grads_p)]
        if not all(torch.allclose(a, b, **tol)
                   for a, b in zip(grads_k, grads_p)):
            raise AssertionError(f"{name} f32: Function and plain autograd "
                                 f"differ, max |err| dq/dk/dv {errs} "
                                 f"({tol})")
        return (f"launches {want}, forward max |err| {err:.3e}, gradients "
                f"max |err| dq/dk/dv {[f'{e:.3e}' for e in errs]} tol {tol}")
    grads_f = res["xla", torch.float32][1]
    dk = [_rel_l2(a, f) for a, f in zip(grads_k, grads_f)]
    dp = [_rel_l2(a, f) for a, f in zip(grads_p, grads_f)]
    for what, a, b in zip(("dq", "dk", "dv"), dk, dp):
        if not a <= GRAD_BF16_RATIO * b:
            raise AssertionError(
                f"{name} bf16: {what} relative L2 from the f32 chain "
                f"{a:.3e}, above {GRAD_BF16_RATIO} x the bf16 plain chain's "
                f"{b:.3e}")
    return (f"launches {want}, forward max |err| {err:.3e}; relative L2 "
            f"from the f32 plain chain dq/dk/dv "
            f"{[f'{x:.3e}' for x in dk]} (Function) against "
            f"{[f'{x:.3e}' for x in dp]} (bf16 plain chain), bound "
            f"{GRAD_BF16_RATIO}x")


def phase_kernel_grads() -> None:
    """Each kernel's autograd Function (``impl="pallas"``) against plain
    autograd (``impl="xla"``): the forward within the kernel's tolerance;
    in bf16, K1, K2 and K3 launch their backward kernel once a backward and
    K4 recomputes the plain chain, and each gradient is gated against the
    f32 plain chain (``GRAD_BF16_RATIO``); in f32 the backward recomputes
    the plain chain and the gradients equal plain autograd's."""
    import torch
    from mmada_parallel_torch.ops import attention as A
    from mmada_parallel_torch.ops.masks import mixed_prefix_bounds
    gen = torch.Generator(device="cuda").manual_seed(6)
    dev = torch.device("cuda")
    f32 = torch.float32
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
        runs = [("pallas", dtype), ("xla", dtype)] + (
            [("xla", f32)] if dtype != f32 else [])
        for name, (shapes, fn) in cases.items():
            xs = [torch.randn(*sh, generator=gen, device=dev).to(dtype)
                  for sh in shapes]
            w = torch.randn(*shapes[0], generator=gen, device=dev)
            res = _function_grads(fn, xs, w, runs)
            readings = _check_function_grads(name, res, dtype, tol,
                                             GRAD_ROUTES[name])
            log(f"[grad] {name} {str(dtype).split('.')[-1]} "
                f"{'x'.join(map(str, shapes[0]))}: {readings}")
    _ring_train_grad(gen)


def _ring_train_grad(gen) -> None:
    """K2's Function at the shape ``train_a --tp_ring`` gives it at g=2 and
    the 8B widths (``[train-a-ring]``): the queries of one sigma-chunk half
    (B=1, Lq=606) against all 2424 pre-rotated keys, 16 of the 32 heads,
    bf16, no bias; the forward against plain autograd, one forward and one
    backward launch, the gradients gated against the f32 plain chain."""
    import torch
    from mmada_parallel_torch.ops import attention as A
    from mmada_parallel_torch.parallel.tp_overlap import sigma_positions
    dev = torch.device("cuda")
    g, H, D, L = 2, EDIT_H // 2, EDIT_D, EDIT_L
    C = L // g
    pos = sigma_positions(g, C, 1, dev)[C // 2:C]     # rank 1's second half
    sin, cos = _rope_tables(L, D, dev)
    sin, cos = sin[pos].contiguous(), cos[pos].contiguous()
    shapes = ((1, C // 2, H * D), (1, L, H * D), (1, L, H * D))
    xs = [torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)
          for sh in shapes]
    w = torch.randn(*shapes[0], generator=gen, device=dev)
    res = _function_grads(
        lambda q, k, v, impl: A.rope_attention_qonly(
            q, k, v, sin, cos, None, n_heads=H, n_kv_heads=H, impl=impl),
        xs, w, [("pallas", torch.bfloat16), ("xla", torch.bfloat16),
                ("xla", torch.float32)])
    readings = _check_function_grads(
        "K2 ring-train", res, torch.bfloat16, BF16_TOL,
        GRAD_ROUTES["K2 rope_attention_qonly"])
    log(f"[grad] K2 rope_attention_qonly at the ring's training chunk "
        f"(g=2): bf16 B=1 Lq={C // 2} Lk={L} H=KV={H} D={D}, no bias: "
        f"{readings}")


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

    counted.__dict__.update(getattr(step, "__dict__", {}))  # mesh, specs
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
    ("attention kernels K1-K4", ("attention_kernel", "attention_ws_kernel",
                                 "split_combine_kernel",
                                 "rope_rotate_kernel")),
    ("attention backward kernels", ("attention_bwd_", "bwd_delta_kernel",
                                    "rope_rotate_bwd_kernel")),
    ("f32 GEMMs (FMA)", ("sgemm", "f32f32")),
    ("int8 tensor-core GEMMs", ("s8s8", "i8i8", "imma", "int8", "_s8_")),
    ("bf16 tensor-core GEMMs", ("nvjet", "gemm")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("elementwise, copies, other", ("",)),
)


def _kernel_class(name: str) -> str:
    """The class of ``_KERNEL_CLASSES`` a device kernel's name falls in (the
    first whose keys it contains, lower case)."""
    low = name.lower()
    return next(cls for cls, keys in _KERNEL_CLASSES
                if any(k in low for k in keys))


def _profile(phase: str, fn, top: int = 6, ranges=()) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA activity):
    prints its device time by kernel class and its largest kernels, and the
    device's idle share between its first and last kernel; with ``ranges``,
    also the device time of the kernels launched inside each named
    ``record_function`` range.  Returns ``{class: ms}``.  Fails if no kernel
    was recorded (see ``_captured``)."""
    import torch
    events, wall = _captured(f"profile {phase}", fn, cpu=True)
    kernels = [e for e in events
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
        per_class[_kernel_class(e.name)] += us / 1e3
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
        in_range = {r: [e for e in events if e.name == r
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


# SDAR-30B-A3B at full width through the block sampler, cut to SDAR_LAYERS
# of its 48 layers: the sdar-blockgen cell's batch (16 prompts of 4096) and
# SDAR_NEW new tokens in blocks of 4, 4 steps a block
SDAR_LAYERS, SDAR_B, SDAR_P, SDAR_NEW = 2, 16, 4096, 8


def phase_sdar() -> dict:
    """``mmu_generate_fast`` with ``LLaDAConfig.sdar_30b_a3b`` (bf16, random
    weights from a seed) on the block-causal route: K4's prefill, then each
    block's steps and write on the folded K2 and the grouped kernel, the
    decode forwards as CUDA graphs.  A first call captures the graphs into
    a kept ``DecodeGraphs``; the second, timed, runs with every launch
    count at 0 before it: the host launches only the prefill (K4 once a
    layer, the grouped kernel twice) and every decode forward is a replay.
    A third call under the profiler counts the device's launches: K4's and
    K2's bodies once a layer a forward, the grouped kernel twice, the
    prefill's at 128-row tiles, the decode's at 16.  The first row's step
    logits against the plain f32 reference's full block-causal forward
    (``benchmark/reference/sdar.py``) over the ids that entered each step:
    mean error under 2 % of the logits' spread (a near-tie expert that
    bf16 flips moves a few positions further), none beyond half of it.
    Returns the grouped kernel's device launches (decode and prefill) and
    the timed call's wall."""
    import torch
    from benchmark.reference import sdar as RS
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    from mmada_parallel_torch.samplers import mmu as TM
    L, B, P, N = SDAR_LAYERS, SDAR_B, SDAR_P, SDAR_NEW
    bf = torch.bfloat16
    cfg = LLaDAConfig.sdar_30b_a3b(n_layers=L, param_dtype=bf,
                                   compute_dtype=bf)
    bl = cfg.block_length
    with open(os.path.join(REPO, "benchmark/configs/sdar-30b-a3b.json")) as f:
        conf = dict(json.load(f), num_hidden_layers=L)
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = init_llada_params(cfg, gen)
    prompts = torch.randint(0, cfg.pad_token_id, (B, P), device="cuda",
                            generator=gen)
    opts = TM.MMUOptions(max_new_tokens=N, steps=N, block_length=bl,
                         mask_token=cfg.mask_token_id)
    graphs = TM.DecodeGraphs()
    run = lambda: TM.mmu_generate_fast(params, cfg, prompts, opts,  # noqa
                                       eot_token=-1, graphs=graphs)
    first = run()
    seen, real = [], TM._block_step

    def step(dec, g, block, *a):
        cur = block[0].clone()
        new, logits = real(dec, g, block, *a)
        seen.append((cur, logits[0].float().clone()))
        return new, logits

    replays = graphs.replays
    TM._block_step = step
    try:
        out, wall, peak = _timed_run(run)
    finally:
        TM._block_step = real
    decode = N + N // bl                        # steps and writes
    host = check_launches("sdar", {"flash_attention_rope_prefix": L,
                                   "moe_grouped_gemm": 2 * L})
    if graphs.replays - replays != decode or not torch.equal(out, first):
        raise AssertionError(f"sdar: {graphs.replays - replays} replays, "
                             f"expected {decode}; a replay's tokens equal "
                             f"the capturing call's: "
                             f"{torch.equal(out, first)}")
    names = {}
    events, _ = _captured("sdar", run)
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation:
            names[e.name] = names.get(e.name, 0) + 1
    device = {"attention_ws": sum(n for k, n in names.items()
                                  if "attention_ws_kernel" in k),
              "grouped/128": sum(n for k, n in names.items()
                                 if "grouped_gemm_kernel<128," in k),
              "grouped/16": sum(n for k, n in names.items()
                                if "grouped_gemm_kernel<16," in k)}
    want = {"attention_ws": L * (1 + decode), "grouped/128": 2 * L,
            "grouped/16": 2 * L * decode}
    if device != want:
        raise AssertionError(f"sdar: device launches {device}, expected "
                             f"{want}")
    errs, spread, gaps = [], [], []
    with torch.no_grad():
        for j, (ids, logits) in enumerate(seen):
            bs = P + (j // bl) * bl
            x = out[0].clone()
            x[bs:bs + bl] = ids
            h, _ = RS.hidden(params, conf, x[:bs + bl], P, bl)
            ref = RS.head(params, h[bs:])
            errs.append(((logits - ref).abs().mean().item(),
                         (logits - ref).abs().max().item()))
            spread.append(float(ref.std()))
            gaps.append(float((ref.max(-1).values - ref.gather(
                -1, logits.argmax(-1)[:, None])[:, 0]).max()))
    bad = [j for j, ((mean, top), s) in enumerate(zip(errs, spread))
           if mean >= 0.02 * s or top > 0.5 * s]
    if len(seen) != N or bad:
        raise AssertionError(f"sdar: {len(seen)} steps seen of {N}; steps "
                             f"{bad} off the reference: errors {errs}, "
                             f"spreads {spread}")
    log(f"[sdar] mmu_generate_fast, SDAR-30B-A3B widths at {L} of 48 layers, "
        f"B={B} prompts of {P}, {N} new tokens in blocks of {bl}: wall "
        f"{wall:.3f} s (prefill + {decode} decode forwards as graph "
        f"replays), peak {peak / 2 ** 30:.2f} GiB; host launches {host}; "
        f"device launches {device}; step logits against the f32 reference: "
        f"mean |err| <= {max(m for m, _ in errs):.4f}, max "
        f"{max(t for _, t in errs):.4f}, spread {min(spread):.3f}, greedy "
        f"gap <= {max(gaps):.4f}")
    del params, graphs
    torch.cuda.empty_cache()
    return {"launches": device["grouped/16"],
            "prefill_launches": device["grouped/128"], "wall_s": wall}


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
    with norm_routes(collections.Counter()) as routes:
        (_, text, info), wall, peak = _timed_run(lambda: _a_pipe(full)(
            "make the sky purple", _edit_image(512), 512, 512, opts,
            text_gen_length=256, seed=1))
    expected = cfg.n_layers * (opts.text_steps + n_img)
    launches = check_launches("edit", {"flash_attention_rope": expected})
    check_norm_launches("edit", sum(vq_norm_calls()["amused"]), routes)
    _check_image("edit", info["codes"], info["pixels"])
    forwards = opts.text_steps + n_img
    check_rms_launches("edit", cfg, forwards)
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
    check_rms_launches("cached-edit", cfg, forwards)
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
    with norm_routes(collections.Counter()) as routes:
        out, wall, peak = _timed_run(lambda: pipe(
            "make the sky purple", _edit_image(512), opts, seed=1,
            use_cache=use_cache))
    return opts, out, wall, peak, routes


def phase_interleave(full) -> int:
    """The exact M interleave at full width; returns K1's launch count."""
    cfg = full["cfg"]
    opts, (_, text, info), wall, peak, routes = _interleave(full, False)
    launches = check_launches("interleave", {
        "flash_attention_rope": cfg.n_layers * opts.text_steps})
    check_norm_launches("interleave", sum(vq_norm_calls()["magvit"]), routes)
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
    opts, (_, text, info), wall, peak, _ = _interleave(full, True)
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

    def quantize(x, reduce=None):
        with record_function("int8 quantize"):
            return real_q(x, reduce)

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
# attention path: the end-to-end gate.  K1 and its backward are held element
# by element against their plain versions at this step's shape, and at the
# M step's, in phase 2 (K1 cases e and f, the backward's A-train and
# M-trainer cases).  Both compute in bf16; K1 rounds p to bf16 per key tile
# before the online rescale, the plain chain after normalising, so an
# attention output element differs by up to a bf16 ulp (2^-8 relative).
# Those differences are independent across elements, and the loss averages
# 2 x 5120 token losses and the grad norm sums 2 B squares, which shrinks
# them by orders of magnitude: the FMA template gave 1.7e-6 (loss) and
# 8e-6 (grad norm) relative on the H100; the tensor-core body (which sums
# the scores in another order and takes p from the SFU's 2^x) gives 9.9e-6
# and 1.7e-4, inside the limits by 10x and 6x.  The backward kernel rounds
# P and dS to bf16 where the plain chain rounds dP and the gradients: more
# independent bf16 roundings, the same sums.  The same gates hold the
# bf16-RoPE step through K3 and its backward against the plain path with
# bf16 RoPE.
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
    # 4 layers x 2 microbatches x (forward + remat recompute), and the
    # backward kernel once a layer and microbatch
    want["flash_attention_rope"] = cfg.n_layers * 2 * 2
    want["flash_attention_rope_bwd"] = cfg.n_layers * 2
    if any(x != want for x in lk):
        raise AssertionError(f"train-a: launches per step {lk}, expected "
                             f"{want}")
    check_rms_launches("train-a", cfg, 0)    # the norms record gradients
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
        f"{want['flash_attention_rope']}, its backward "
        f"{want['flash_attention_rope_bwd']}")
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
    k3 = _train_a_k3(batch)
    return {"state": state, "cfg": cfg,
            "launches": {"flash_attention_rope_bwd": sum(
                x["flash_attention_rope_bwd"] for x in lk), **k3}}


def _train_a_k3(batch) -> dict:
    """[train-a-k3]: the A step with the rotation in bf16
    (``rope_full_precision=False``), so attention runs K3 and its backward:
    one plain step, then 2 through the kernels (16 K3 and 8 backward
    launches a step), the first held to the plain step by the A step's
    gates.  Returns the backward's launches."""
    import dataclasses
    import gc
    import torch

    def cfg_of(impl):
        return dataclasses.replace(_train_cfg(impl), rope_full_precision=False)

    _, _, mp, _, lp, _ = _train_a_steps(cfg_of("xla"),
                                        _train_params(cfg_of("xla")), batch, 1)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cfg_of("auto")
    _, _, mk, sk, lk, peak = _train_a_steps(cfg, _train_params(cfg), batch, 2)
    want = {n: 0 for n in KERNELS}
    want["flash_attention"] = cfg.n_layers * 2 * 2
    want["flash_attention_bwd"] = cfg.n_layers * 2
    if any(sum(x.values()) for x in lp) or any(x != want for x in lk):
        raise AssertionError(f"train-a-k3: launches {lk} (kernels), {lp} "
                             f"(plain), expected {want} a step")
    for key, rtol in (("loss", A_LOSS_RTOL),
                      ("grad_norm", A_GRAD_NORM_RTOL)):
        a, b = mk[0][key], mp[0][key]
        if not (math.isfinite(a) and abs(a - b) <= rtol * abs(b)):
            raise AssertionError(f"train-a-k3: first-step {key} {a} (K3) vs "
                                 f"{b} (plain), rtol {rtol}")
    log(f"[train-a-k3] the A step with bf16 RoPE (K3 and its backward): "
        f"first step loss {mk[0]['loss']:.6f} (K3) vs {mp[0]['loss']:.6f} "
        f"(plain), grad norm {mk[0]['grad_norm']:.6f} vs "
        f"{mp[0]['grad_norm']:.6f}; s/step {[round(x, 3) for x in sk]}, "
        f"peak {peak / 2 ** 30:.2f} GiB; launches per step "
        f"{ {k: v for k, v in want.items() if v} }")
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_bwd": sum(x["flash_attention_bwd"]
                                       for x in lk)}


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
        check_launches("train-m", {"flash_attention_rope": cfg.n_layers,
                                   "flash_attention_rope_bwd": cfg.n_layers})
        vals = {k: float(v) for k, v in m.items()}
        if not (all(math.isfinite(x) for x in vals.values())
                and vals["nonfinite"] == 0):
            raise AssertionError(f"train-m: non-finite step {vals}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[train-m] forward_process [t2i | lm | mmu] B=3 x L={L} (t2i row "
        f"left-padded by {M_T2I_PAD}, interleave_noising on the card), 4 of "
        f"32 layers, no remat: losses t2i {vals['loss_t2i']:.6f} lm "
        f"{vals['loss_lm']:.6f} mmu {vals['loss_mmu']:.6f}, grad norm "
        f"{vals['grad_norm']:.6f}; K1 launches per step {cfg.n_layers}, "
        f"its backward {cfg.n_layers}")
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
        # the loop's first batch: a fresh prompting rng, the seed-19 noise;
        # two encodes of the step's images
        reset_launches()
        with norm_routes(collections.Counter()) as routes:
            first = TM.assemble_batch(
                samples, m.get_code, tok,
                UniversalPrompting(tok, max_text_len=msl),
                torch.Generator(device="cuda").manual_seed(19), cfg,
                torch.device("cuda"))
        check_norm_launches("train-m-cli assembly",
                            2 * vq_norm_calls()["magvit"][0], routes)
        L = first[0].shape[1]
        if L != 2565:
            raise AssertionError(f"train-m-cli: sequence length {L}, "
                                 f"expected 2565")
        # 4 layers x 4 microbatches x (forward + remat recompute); in bf16
        # one backward launch a layer and microbatch (f32 recomputes the
        # plain chain)
        want32 = {n: 0 for n in KERNELS}
        want32["flash_attention_rope"] = mcfg.n_layers * accum * 2
        want = dict(want32, flash_attention_rope_bwd=mcfg.n_layers * accum)
        none = {n: 0 for n in KERNELS}
        ref, g_ref, launches = _m_first_step(m, cfg, first, "xla", f32)
        runs = {}
        for impl, dt in (("auto", f32), ("xla", bf16), ("auto", bf16)):
            met, g, launches_ = _m_first_step(m, cfg, first, impl, dt)
            dist = float(torch.sqrt(sum((x - y).float().square().sum()
                                        for x, y in zip(g, g_ref))))
            runs[impl, dt] = (met, dist)
            if launches_ != (none if impl == "xla" else
                             want if dt == bf16 else want32):
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
            f"step {want['flash_attention_rope']}, its backward "
            f"{want['flash_attention_rope_bwd']}")
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
    layers x 4 scored steps an update, and its backward kernel once for
    each of the update's forwards.  Then, on the last trajectory, the loss
    and gradient norm through K1 against the plain attention path."""
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
            "flash_attention_rope": cfg.n_layers * len(sub),
            "flash_attention_rope_bwd": cfg.n_layers * len(sub)})
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
        f"{cfg.n_layers * len(sub)} an update and as many of its backward")
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
        got[impl]["launches"] = (counts["flash_attention_rope"],
                                 counts["flash_attention_rope_bwd"])
        for p in leaves:
            p.grad = None
    if got["xla"]["launches"] != (0, 0) or got["auto"]["launches"] != \
            (cfg.n_layers * len(sub),) * 2:
        raise AssertionError(f"pararl: launches {got}")
    _rl_close("pararl", got["auto"], got["xla"], RL_LOSS_RTOL,
              RL_GRAD_NORM_RTOL)
    log(f"[pararl] same trajectory, rewards [0, 1]: loss "
        f"{got['auto']['loss']:.6f} (K1) vs {got['xla']['loss']:.6f} "
        f"(plain), grad norm {got['auto']['grad_norm']:.6f} vs "
        f"{got['xla']['grad_norm']:.6f}, trajectory log-prob "
        f"{got['auto']['traj_logp']:.3f} vs {got['xla']['traj_logp']:.3f}")


# ---------------------------------------------------------------------------
# Phase 6: the capability demos, trained from scratch on the card
# ---------------------------------------------------------------------------

# the bars of the JAX package's capability tests
DEMO_M_BAR, DEMO_A_BAR, DEMO_DELTA = 0.9, 0.85, 0.1
M_CACHED = ({"cache_ratio": 0.5, "refresh_interval": 3, "warmup_ratio": 0.25},
            {"cache_ratio": 0.5, "refresh_interval": 3, "warmup_ratio": 0.25,
             "refresh_on_image_steps": False})
A_CACHED = ({"cache_ratio": 0.5, "refresh_interval": 3, "warmup_ratio": 0.25},
            {"cache_ratio": 0.3, "refresh_interval": 4, "warmup_ratio": 0.25})


def _demo_train(phase: str, run, **kw):
    """``run(**kw, return_params=True, device="cuda")`` with every launch
    count at 0 before it and checked to be 0 after it (the demos' head_dim
    32 is not the kernels'); logs the training's seconds, steps/s, peak
    device memory and final loss.  Returns the run's
    ``(metrics, params, cfg, T, tokz)``."""
    import torch
    out, wall, peak = _timed_run(lambda: run(**kw, return_params=True,
                                             device="cuda"))
    counts = check_launches(phase, {})
    m = out[0]
    log(f"{phase} {m['steps']} steps from scratch (batch {kw['batch']}, lr "
        f"{kw['lr']}, seed 0): train {m['train_seconds']} s, "
        f"{m['steps'] / m['train_seconds']:.1f} steps/s, run with the "
        f"checkpoint round trip and eval {wall:.1f} s, peak memory "
        f"{peak / 2 ** 20:.0f} MiB, final loss {m['final_loss']}, launches "
        f"{counts}")
    torch.cuda.empty_cache()
    return out


def _demo_evals(phase: str, base: float, evaluate, settings) -> dict:
    """Each ``(label, kwargs)`` of ``settings`` through ``evaluate`` (which
    returns ``(accuracy, first text)``) with no kernel launch; each
    accuracy within ``DEMO_DELTA`` of ``base`` and "rotated" in the text."""
    out = {}
    for label, kw in settings:
        reset_launches()
        acc, text = evaluate(**kw)
        check_launches(f"{phase} {label}", {})
        if acc < base - DEMO_DELTA or "rotated" not in text:
            raise AssertionError(f"{phase} {label}: accuracy {acc} against "
                                 f"{base} (bar: within {DEMO_DELTA}), text "
                                 f"{text!r}")
        out[label] = acc
    log(f"{phase} evals on the trained model, accuracy (delta to "
        f"{base}): " + ", ".join(f"{k} {v} ({v - base:+.4f})"
                                 for k, v in out.items()))
    return out


def _demo_head_dim_refused(cfg) -> None:
    """The demos' config asks for the plain attention, and ``auto`` at its
    head_dim (not the kernels') raises on the card, with no launch."""
    import torch
    from mmada_parallel_torch.ops.attention import rope_attention
    D, H = cfg.head_dim, cfg.n_heads
    if cfg.attention_impl != "xla" or D in (64, 128):
        raise AssertionError(f"[demo] config: attention_impl "
                             f"{cfg.attention_impl!r}, head_dim {D}")
    q = torch.zeros(1, 16, H * D, device="cuda")
    sin = cos = torch.zeros(16, D, device="cuda")
    reset_launches()
    try:
        rope_attention(q, q, q, sin, cos, n_heads=H, impl="auto")
    except ValueError as e:
        check_launches("[demo] auto at the demos' head_dim", {})
        log(f"[demo] attention_impl 'xla' in the demos' config; auto at "
            f"head_dim {D} on the card raises: {e}")
        return
    raise AssertionError(f"[demo] auto at head_dim {D} on the card ran "
                         f"without a kernel and without raising")


def phase_demo_m() -> None:
    """``examples/train_edit_demo.py``: 800 steps from scratch, the
    checkpoint round trip into other weights, the eval (>= 0.9, "rotated"
    in the first text); then int8 params (head quantized and dense) and the
    two cached-sampler settings, each within 0.1 of it."""
    import numpy as np
    from mmada_parallel_torch.examples import train_edit_demo as M
    from mmada_parallel_torch.ops.quant import quantize_llada_params
    m, params, cfg, T, tokz = _demo_train(
        "[demo-m]", M.run_demo, steps=800, batch=32, lr=1.5e-3,
        log_every=200)
    _demo_head_dim_refused(cfg)
    base = m["eval_code_accuracy"]
    log(f"[demo-m] eval accuracy {base} {m['per_sample_accuracy']}, texts "
        f"{m['generated_text']}")
    if base < DEMO_M_BAR or "rotated" not in m["generated_text"][0]:
        raise AssertionError(f"[demo-m] below the bar: {m}")

    def evaluate(quantize_head=None, **kw):
        p = (params if quantize_head is None else
             quantize_llada_params(params, quantize_head=quantize_head))
        accs, _, texts, _, _ = M.eval_palette_model(p, cfg, T, tokz, **kw)
        return float(np.mean(accs)), texts[0]

    _demo_evals("[demo-m]", base, evaluate, [
        ("int8", {"quantize_head": True}),
        ("int8-dense-head", {"quantize_head": False}),
        *((f"cached{i}", dict(kw, use_cached=True))
          for i, kw in enumerate(M_CACHED))])


def phase_demo_a():
    """``examples/train_edit_demo_a.py``: 800 steps from scratch, the
    checkpoint round trip, the eval (>= 0.85, the text "rotated colors
    done"), int8 and cached evals within 0.1.  Returns the trained run for
    the ParaBench demo."""
    import numpy as np
    from mmada_parallel_torch.examples import train_edit_demo_a as A
    from mmada_parallel_torch.ops.quant import quantize_llada_params
    run = _demo_train("[demo-a]", A.run_demo_a, steps=800, batch=32,
                      lr=3e-3, log_every=400)
    m, params, cfg, T, tokz = run
    base = m["eval_code_accuracy"]
    log(f"[demo-a] eval accuracy {base} {m['per_sample_accuracy']}, texts "
        f"{m['generated_text']}")
    if base < DEMO_A_BAR or m["generated_text"][0] != "rotated colors done":
        raise AssertionError(f"[demo-a] below the bar: {m}")

    def evaluate(quantize_head=None, **kw):
        p = (params if quantize_head is None else
             quantize_llada_params(params, quantize_head=quantize_head))
        accs, _, texts, _ = A.eval_a_model(p, cfg, T, tokz, **kw)
        return float(np.mean(accs)), texts[0]

    _demo_evals("[demo-a]", base, evaluate, [
        ("int8", {"quantize_head": True}),
        ("int8-dense-head", {"quantize_head": False}),
        *((f"cached{i}", dict(kw, use_cached=True))
          for i, kw in enumerate(A_CACHED))])
    return run


def phase_demo_multitask() -> None:
    """``examples/train_multitask_demo.py``: 1000 steps of joint t2i + mmu
    from scratch, the checkpoint round trip, then the t2i and mmu sweeps
    (``T2IServer``, ``MMUServer``): target_match >= 0.9, text_alignment >=
    0.9, code_diversity in [0.05, 0.2]."""
    from mmada_parallel_torch.examples import train_multitask_demo as MT
    m = _demo_train("[demo-multitask]", MT.run_demo, steps=1000, batch=16,
                    lr=1.5e-3, log_every=250)[0]
    log(f"[demo-multitask] t2i target_match {m['t2i_target_match']}, "
        f"code_diversity {m['t2i_code_diversity']}, mmu text_alignment "
        f"{m['mmu_text_alignment']}, answers {m['mmu_answers'][:2]}, "
        f"{m['images_per_min']} images/min, {m['answers_per_min']} "
        f"answers/min")
    if not (m["t2i_target_match"] >= 0.9 and m["mmu_text_alignment"] >= 0.9
            and 0.05 <= m["t2i_code_diversity"] <= 0.2):
        raise AssertionError(f"[demo-multitask] below the bar: {m}")


def phase_demo_parabench(trained) -> None:
    """``examples/parabench_demo.py`` on the ``[demo-a]`` model: 8 held-out
    requests through ``run_parabench_sweep``, target_match >= 0.85 and
    text_alignment >= 0.9."""
    from mmada_parallel_torch.examples import parabench_demo as PB
    out, wall, _ = _timed_run(lambda: PB.run(None, 8, device="cuda",
                                             trained=trained))
    counts = check_launches("[demo-parabench]", {})
    agg = out["aggregate"]
    log(f"[demo-parabench] {out['n_requests']} requests: aggregate {agg}, "
        f"{out['edits_per_min']} edits/min, {wall:.2f} s, launches {counts}")
    if agg["target_match"] < 0.85 or agg["text_alignment"] < 0.9:
        raise AssertionError(f"[demo-parabench] below the bar: {agg}")


def phase_demo_pararl() -> None:
    """``examples/pararl_resteer_demo.py`` at its defaults (40 SFT steps,
    100 updates, rollout batch 16, temperature 1.5, seed 0), finite, its
    rewards and accuracies in [0, 1], with no kernel launch.  The JAX
    demo's bar has two halves: the mean reward of the last 5 updates at
    least that of the first 5 + 0.1 (raised), and the temperature-0
    accuracy above its start (reported, met or missed)."""
    from mmada_parallel_torch.examples import pararl_resteer_demo as PRL
    out, wall, peak = _timed_run(lambda: PRL.run_resteer(device="cuda"))
    counts = check_launches("[demo-pararl]", {})
    keys = ("pretrain_plus1_accuracy", "initial_accuracy", "final_accuracy",
            "reward_first5", "reward_last5")
    if not all(0.0 <= out[k] <= 1.0 for k in keys):
        raise AssertionError(f"[demo-pararl] {out}")
    gain = out["reward_last5"] - out["reward_first5"]
    acc_met = out["final_accuracy"] > out["initial_accuracy"]
    log(f"[demo-pararl] {out['pretrain_steps']} SFT steps (+1 accuracy "
        f"{out['pretrain_plus1_accuracy']}), {out['updates']} updates in "
        f"{out['rl_seconds']} s ({out['updates'] / out['rl_seconds']:.2f} "
        f"updates/s): reward {out['reward_first5']} -> "
        f"{out['reward_last5']} ({gain:+.4f}, bar +0.1), accuracy "
        f"{out['initial_accuracy']} -> {out['final_accuracy']} (bar: a "
        f"rise, {'met' if acc_met else 'MISSED'}); {wall:.1f} s, peak "
        f"memory {peak / 2 ** 20:.0f} MiB, launches {counts}")
    if gain < 0.1:
        raise AssertionError(f"[demo-pararl] reward gain {gain:+.4f} below "
                             f"the bar of +0.1: {out}")


# ---------------------------------------------------------------------------
# Phase 7: the checkpoint export at the 8B widths
# ---------------------------------------------------------------------------

EXPORT_L = 2424           # the exact edit's sequence length (phase 4)


@contextlib.contextmanager
def _host_peak():
    """Samples this process's resident memory every 5 ms; yields a dict
    with ``"start"``, the resident bytes on entry, and ``"peak"``, the
    largest sample (complete at exit)."""
    import threading
    page = os.sysconf("SC_PAGE_SIZE")

    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * page

    out, stop = {"start": rss(), "peak": 0}, threading.Event()

    def sample():
        while True:
            out["peak"] = max(out["peak"], rss())
            if stop.wait(0.005):
                return

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()


def _bits_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    elif a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def phase_export() -> None:
    """``models/convert.py``'s export at the 8B widths, 4 of the 32 layers
    (random bf16 weights from a seed): ``save_llada_checkpoint`` from the
    card into a temporary directory, ``load_llada_checkpoint`` back; every
    tensor bit for bit, the config's checkpoint fields equal, and one
    ``llada_hidden`` forward of the reloaded weights at the exact edit's
    shape (B=1, L=2424) bit for bit equal to the original's, with exactly 4
    K1 launches.  The directory is deleted afterwards."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from mmada_parallel_torch.models.convert import (load_llada_checkpoint,
                                                     save_llada_checkpoint)
    from mmada_parallel_torch.models.llada import (LLaDAConfig, count_params,
                                                   init_llada_params,
                                                   llada_hidden)
    from mmada_parallel_torch.training.trainer import tree_leaves
    cfg = LLaDAConfig.llada_8b(n_layers=4, param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_llada_params(cfg, gen)
    ids = torch.randint(0, cfg.vocab_size, (1, EXPORT_L), generator=gen,
                        device="cuda")
    n = count_params(params)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _host_peak() as host:
            t0 = time.time()
            save_llada_checkpoint(tmp, params, cfg, dtype=torch.bfloat16)
            write_s = time.time() - t0
            size = os.path.getsize(os.path.join(tmp, "model.safetensors"))
            t0 = time.time()
            lcfg, loaded = load_llada_checkpoint(
                tmp, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                compute_dtype=torch.bfloat16)
            read_s = time.time() - t0
            t0 = time.time()
            loaded = {k: ({n: t.cuda() for n, t in v.items()}
                          if isinstance(v, dict) else v.cuda())
                      for k, v in loaded.items()}
            torch.cuda.synchronize()
            h2d_s = time.time() - t0
        if lcfg != cfg:
            raise AssertionError(f"[export] config {dataclasses.asdict(lcfg)}"
                                 f" != {dataclasses.asdict(cfg)}")
        pairs = list(zip(tree_leaves(loaded), tree_leaves(params)))
        if len(pairs) != len(tree_leaves(params)) or not all(
                _bits_equal(a, b) for a, b in pairs):
            raise AssertionError("[export] reloaded tensors differ")
        with torch.inference_mode():
            want = llada_hidden(params, cfg, ids)
            reset_launches()
            got = llada_hidden(loaded, lcfg, ids)
            torch.cuda.synchronize()
        counts = check_launches("[export]", {"flash_attention_rope": 4})
        same = _bits_equal(got, want)
        if not same:
            raise AssertionError("[export] the reloaded forward differs")
        dev_peak = torch.cuda.max_memory_allocated()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gb = size / 1e9
    log(f"[export] llada_8b widths, {cfg.n_layers} of 32 layers, {n / 1e9:.3f}"
        f" B params bf16: model.safetensors {gb:.3f} GB, write "
        f"{write_s:.2f} s ({gb / write_s:.2f} GB/s, card -> file), read "
        f"{read_s:.2f} s ({gb / read_s:.2f} GB/s, file -> host params), "
        f"host -> card {h2d_s:.2f} s; peak host memory (resident) "
        f"{host['peak'] / 2 ** 30:.2f} GiB from {host['start'] / 2 ** 30:.2f}"
        f" GiB before, peak device memory "
        f"{dev_peak / 2 ** 30:.2f} GiB")
    log(f"[export] {len(pairs)} stacked tensors bit for bit, config equal; "
        f"llada_hidden B=1 L={EXPORT_L} of the reloaded weights bit for bit "
        f"= the original's ({same}), launches {counts}; directory deleted")


# ---------------------------------------------------------------------------
# Ring tensor parallelism: ranks on the card
# ---------------------------------------------------------------------------

RING_G = 4                # the ring's ranks in [ring-small], [serve-a-ring]
RING_TEXT_STEPS = 2       # [serve-a-ring]'s text steps (2 image steps)
RING_LABEL = ("4 ranks sharing one card over host-staged gloo: not a "
              "multi-GPU time")
# the full-width ring forward's bf16 hidden state against the solo K1
# forward of the same ids: relative L2 and largest |diff|, 1.5x and 2.5x the
# readings 1.0126e-02 and 0.1016 (PERF.md); the int8 payload's hidden state
# must fail them, so that a lower-precision transfer cannot pass
RING_BF16_REL_L2, RING_BF16_MAX = 0.015, 0.25


def _tf32_off(fn, rank, world, workdir):
    """A ring rank as every phase of this script runs: TF32 off."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return fn(rank, world, workdir)


def _run_ranks(phase: str, fn, world: int, backend: str = "gloo",
               inputs=None, timeout: float = 900.0) -> list:
    """``world`` spawned processes running ``fn`` as ranks of one process
    group on this card's machine (``parallel/launch.py``: ``cuda:0`` for
    every rank on gloo, ``cuda:rank`` on NCCL); ``inputs`` reach them as
    ``inputs.pt``.  Returns each rank's result; a rank that fails or
    outlives ``timeout`` fails the phase, and every process started here is
    gone when it returns."""
    import functools
    import tempfile
    import torch
    from mmada_parallel_torch.parallel.launch import rank_results, spawn_ranks
    with tempfile.TemporaryDirectory() as workdir:
        if inputs is not None:
            torch.save(inputs, os.path.join(workdir, "inputs.pt"))
        return rank_results(
            spawn_ranks(functools.partial(_tf32_off, fn), world, workdir,
                        backend, "cuda", timeout)(), f"[{phase}]")


def _ring_qonly_case(name, B, L, H, D, dtype, tol, gen, timed=False):
    """K2 at the ring block's per-chunk shape: the queries of one
    sigma-chunk half (``Lq = L / (2g)``, rank 1, the +ring's chunk 2 in
    sigma order) against the full once-rotated K, with the sigma-gathered
    tables, as ``_block_tp`` calls it."""
    from mmada_parallel_torch.parallel.tp_overlap import sigma_positions
    C = L // RING_G
    pos = sigma_positions(RING_G, C, 1)[2 * (C // 2):3 * (C // 2)]
    return _qonly_case(name, B, C // 2, L, H, H, D, dtype, tol, gen,
                       positions=pos, timed=timed)


def phase_kernel_ring() -> tuple:
    """K2 at the ring's per-chunk shapes: at 8B and g=4 a rank has 8 of the
    32 heads and attends Lq = 2424 / 8 = 303 sigma-ordered queries against
    all 2424 keys, B=1 (cond) and B=2 (uncond); and at a small f32 shape;
    and the training ring's chunk (g=2: 16 heads, Lq = 606).  Returns the
    serving B=1 case's record and the training case's."""
    import torch
    from mmada_parallel_torch.parallel.tp_overlap import sigma_positions
    gen = torch.Generator(device="cuda").manual_seed(5)
    H = EDIT_H // RING_G
    one = _ring_qonly_case("ring/B1", 1, EDIT_L, H, EDIT_D, torch.bfloat16,
                           BF16_TOL, gen, timed=True)
    two = _ring_qonly_case("ring/B2", 2, EDIT_L, H, EDIT_D, torch.bfloat16,
                           BF16_TOL, gen, timed=True)
    small = _ring_qonly_case("ring/f32", 2, 96, 2, 64, torch.float32,
                             F32_TOL, gen)
    _split_sweep(1, EDIT_L // (2 * RING_G), EDIT_L, H, EDIT_D,
                 (1, 2, 3, 4, 6, 38))
    log(f"[kernel] K2 at the ring's chunk, g={RING_G}: B=1 Lq="
        f"{EDIT_L // (2 * RING_G)} Lk={EDIT_L} H=KV={H} (split "
        f"{one['splits']}): {one['ms']:.3f} ms, bound {one['bound_ms']:.4f} "
        f"ms, {100 * one['bound_ms'] / one['ms']:.1f} % of bound; B=2 "
        f"(split {two['splits']}): {two['ms']:.3f} ms, "
        f"{100 * two['bound_ms'] / two['ms']:.1f} % of bound; "
        f"{2 * RING_G} calls a layer on each rank")
    train = _qonly_case(
        "ring-train/B1", 1, EDIT_L // 4, EDIT_L, EDIT_H // 2, EDIT_H // 2,
        EDIT_D, torch.bfloat16, BF16_TOL, gen, timed=True,
        positions=sigma_positions(2, EDIT_L // 2, 1)[EDIT_L // 4:
                                                     EDIT_L // 2])
    _split_sweep(1, EDIT_L // 4, EDIT_L, EDIT_H // 2, EDIT_D,
                 (1, 2, 3, 4, 13))
    log(f"[kernel] K2 at the ring's training chunk, g=2: B=1 Lq="
        f"{EDIT_L // 4} Lk={EDIT_L} H=KV={EDIT_H // 2} (split "
        f"{train['splits']}): {train['ms']:.3f} ms, bound "
        f"{train['bound_ms']:.4f} ms, "
        f"{100 * train['bound_ms'] / train['ms']:.1f} % of bound; 4 calls a "
        f"layer on each rank of [train-a-ring]")
    return (dict(one, max_abs_err=max(r["max_abs_err"]
                                      for r in (one, two, small)),
                 library_ms=None), dict(train, library_ms=None))


# -- [ring-small]: a small f32 model (head_dim 64) on the ring -------------

def _ring_small_setup():
    """The small ring configuration: cfg (f32, 8 heads of 64, 2 layers),
    tokens, options, and prompts whose layouts divide by 8."""
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import LLaDAConfig
    from mmada_parallel_torch.samplers.interleave import InterleaveOptions
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    T = tk.VariantATokens(mask=250, newline=251, answer_start=252,
                          answer_end=253, boi=254, eoi=255, uncondition=249,
                          pad=248, text_vocab_size=256, codebook_size=32)
    TM = tk.VariantMTokens(soi=251, eoi=250, bos=249, text_vocab_size=256,
                           codebook_size=32)
    cfg = LLaDAConfig.tiny(d_model=512, n_heads=8, n_kv_heads=8,
                           mlp_hidden_size=1024, n_layers=2, vocab_size=288,
                           mask_token_id=250)
    opts = TI2TIOptions(text_steps=8, timesteps=4, temperature=0.0,
                        text_temperature=0.0, cfg_img=4.0,
                        text_vocab_size=256, codebook_size=32,
                        mask_token=250)
    mopts = InterleaveOptions(text_steps=6, image_steps=3, text_cfg=1.5,
                              image_cfg=2.0, text_temperature=0.0,
                              image_temperature=0.0, text_vocab_size=256,
                              codebook_size=32, mask_token=250)

    def edit_prompt(first):
        p = [first, 6, 7]
        while tk.assemble_ti2ti_sequence(p, 16, 4, 4, [9],
                                         tokens=T)[1].total_len % 8:
            p.append(11)
        return p

    prompts = [edit_prompt(5), edit_prompt(40)]
    instr = [10, 11, 12, 13, 14]
    while tk.assemble_interleave_sequence(instr, 16, 12,
                                          tokens=TM)[1].total_len % 8:
        instr.append(15)
    return dict(cfg=cfg, T=T, TM=TM, opts=opts, mopts=mopts,
                prompts=prompts, instr=instr)


def _ring_small_rank(rank, world, workdir):
    """[ring-small] on one rank: the ring forward (exact and int8), the
    exact edit and the interleave over the ring with their launch counts,
    then the SPMD server (rank 0 submits two requests from two threads)."""
    import threading
    import numpy as np
    import torch
    from mmada_parallel_torch import serving
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.parallel import (MeshConfig, make_mesh,
                                               shard_params)
    from mmada_parallel_torch.parallel import tp_overlap as TP
    from mmada_parallel_torch.models.llada import param_shardings
    from mmada_parallel_torch.samplers.interleave import interleave_generate
    from mmada_parallel_torch.samplers.parallel_ti2ti import generate_ti2ti
    s = _ring_small_setup()
    cfg, T, opts = s["cfg"], s["T"], s["opts"]
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, tensor=world), "cuda")
    # on the card first: the tree shard_params returns carries the mesh
    # the vocab-parallel head reads
    params = shard_params({k: ({n: t.to(dev) for n, t in v.items()}
                               if isinstance(v, dict) else v.to(dev))
                           for k, v in inp["params"].items()},
                          param_shardings(cfg), mesh)
    out = {"backend": torch.distributed.get_backend(mesh.get_group(
        "tensor")), "device": str(dev)}
    ids = inp["fwd_ids"].to(dev)
    out["hidden"] = TP.llada_hidden_tp_overlap(params, cfg, ids,
                                               mesh).cpu()
    exact = TP.llada_forward_tp_overlap(params, cfg, ids, mesh)
    q8 = TP.llada_forward_tp_overlap(params, cfg, ids, mesh,
                                     int8_payload=True)
    out["int8_cos"] = float(torch.nn.functional.cosine_similarity(
        exact.flatten().double(), q8.flatten().double(), dim=0))
    out["int8_argmax"] = float((exact.argmax(-1) == q8.argmax(-1)).float()
                               .mean())

    prompt = s["prompts"][0]
    row, lay = tk.assemble_ti2ti_sequence(prompt, 16, 4, 4, [9], tokens=T)
    reset_launches()
    fin, codes = generate_ti2ti(
        params, cfg, torch.as_tensor(row, device=dev)[None], lay, opts,
        uncond_image_prefix=np.asarray(prompt),
        hidden_fn=TP.ring_hidden_fn(mesh))
    torch.cuda.synchronize()
    out["edit"] = (fin.cpu(), codes.cpu(), read_launches())

    TM = s["TM"]
    mids, mlay = tk.assemble_interleave_sequence(s["instr"], 16, 12,
                                                 tokens=TM)
    un = tk.assemble_interleave_sequence([30] * len(s["instr"]), 16, 12,
                                         tokens=TM)[0]
    reset_launches()
    fin, codes = interleave_generate(
        params, cfg, torch.as_tensor(mids, device=dev)[None],
        torch.as_tensor(un, device=dev)[None], mlay, s["mopts"],
        hidden_fn=TP.ring_hidden_fn(mesh))
    torch.cuda.synchronize()
    out["interleave"] = (fin.cpu(), codes.cpu(), read_launches())

    finals = []
    real = serving.generate_ti2ti

    def recording(*a, **kw):
        fin, codes = real(*a, **kw)
        finals.append(fin.cpu())
        return fin, codes

    serving.generate_ti2ti = recording
    srv = serving.TI2TIServer(
        params, cfg, opts, serving.ServeConfig(
            batch_size=2, max_wait_ms=500.0, grid_hw=(4, 4),
            text_gen_length=16, end_token_ids=(9,)),
        tokens=T, hidden_fn=TP.ring_hidden_fn(mesh))
    if rank == 0:
        out["served"] = _concurrently(srv, [((p,), {})
                                            for p in s["prompts"]])
        out["stats"] = srv.stats()
    srv.close()
    serving.generate_ti2ti = real
    out["server_finals"] = finals
    return out


def _ring_small(phase: str, world: int, backend: str) -> None:
    """[ring-small] (gloo, every rank on this card) or [ring-nccl] (NCCL,
    one card a rank): the ring against the solo runs of this process, at
    temperature 0, with exact K2 counts and no K1 on the ranks."""
    import dataclasses
    import numpy as np
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import (init_llada_params,
                                                   llada_hidden)
    from mmada_parallel_torch.ops import sampling as S
    from mmada_parallel_torch.samplers.interleave import interleave_generate
    from mmada_parallel_torch.samplers.parallel_ti2ti import generate_ti2ti
    s = _ring_small_setup()
    cfg, T, opts, TM, mopts = (s["cfg"], s["T"], s["opts"], s["TM"],
                               s["mopts"])
    gen = torch.Generator(device="cuda").manual_seed(11)
    params = init_llada_params(cfg, gen)
    fwd_ids = torch.randint(0, 288, (2, 96), generator=gen, device="cuda")
    dev = torch.device("cuda")

    def solo_edit(prompt, impl, prefix=True):
        row, lay = tk.assemble_ti2ti_sequence(prompt, 16, 4, 4, [9],
                                              tokens=T)
        fin, codes = generate_ti2ti(
            params, dataclasses.replace(cfg, attention_impl=impl),
            torch.as_tensor(row, device=dev)[None], lay, opts,
            uncond_image_prefix=np.asarray(prompt) if prefix else None)
        return (fin[0, lay.text_start:lay.text_end].cpu().numpy(),
                codes[0].cpu().numpy(), fin.cpu())

    reset_launches()
    solo_hidden = llada_hidden(params, cfg, fwd_ids).cpu()
    edit_k1, edit_plain = (solo_edit(s["prompts"][0], i)
                           for i in ("auto", "xla"))
    mids, mlay = tk.assemble_interleave_sequence(s["instr"], 16, 12,
                                                 tokens=TM)
    un = tk.assemble_interleave_sequence([30] * len(s["instr"]), 16, 12,
                                         tokens=TM)[0]
    m_solo = interleave_generate(
        params, cfg, torch.as_tensor(mids, device=dev)[None],
        torch.as_tensor(un, device=dev)[None], mlay, mopts)
    served_solo = [solo_edit(p, "auto", prefix=False) for p in s["prompts"]]
    if read_launches()["flash_attention_rope"] == 0:
        raise AssertionError(f"{phase}: the solo runs did not launch K1")

    t0 = time.time()
    ranks = _run_ranks(phase, _ring_small_rank, world, backend, inputs={
        "params": {k: ({n: t.cpu() for n, t in v.items()}
                       if isinstance(v, dict) else v.cpu())
                   for k, v in params.items()},
        "fwd_ids": fwd_ids.cpu()})
    wall = time.time() - t0
    r0 = ranks[0]
    err = (r0["hidden"] - solo_hidden).abs()
    if not bool((err <= 2e-4 + 2e-4 * solo_hidden.abs()).all()):
        raise AssertionError(f"{phase}: ring hidden vs solo max |err| "
                             f"{float(err.max()):.3e} (rtol/atol 2e-4)")
    if not (torch.equal(r0["edit"][0], edit_k1[2])
            and torch.equal(r0["edit"][0], edit_plain[2])
            and np.array_equal(r0["edit"][1][0].numpy(), edit_k1[1])):
        raise AssertionError(f"{phase}: the edit over the ring is not "
                             f"token-exact against the solo K1 and plain "
                             f"runs")
    if not all(torch.equal(a, b.cpu()) for a, b in zip(r0["interleave"][:2],
                                                        m_solo)):
        raise AssertionError(f"{phase}: the interleave over the ring is not "
                             f"token-exact against the solo run")
    for i, (res, (text_ids, codes, _)) in enumerate(zip(r0["served"],
                                                        served_solo)):
        if not (np.array_equal(res["codes"], codes)
                and np.array_equal(res["text_ids"], text_ids)):
            raise AssertionError(f"{phase}: served request {i} is not its "
                                 f"solo run")
    if r0["stats"]["batches"] != 1:
        raise AssertionError(f"{phase}: {r0['stats']}, expected one batch")
    if r0["int8_cos"] <= 0.999 or r0["int8_argmax"] <= 0.9:
        raise AssertionError(f"{phase}: int8 payload cosine "
                             f"{r0['int8_cos']}, argmax agreement "
                             f"{r0['int8_argmax']}")
    n_img = int(S.image_step_mask(opts.text_steps, opts.timesteps).sum())
    per_fwd = 2 * world * cfg.n_layers
    want = {"edit": per_fwd * (opts.text_steps + n_img),
            "interleave": per_fwd * mopts.text_steps}
    for r, res in enumerate(ranks):
        for key in ("edit", "interleave"):
            if not all(torch.equal(a, b) for a, b in zip(res[key][:2],
                                                         r0[key][:2])):
                raise AssertionError(f"{phase}: rank {r}'s {key} ids differ "
                                     f"from rank 0's")
            counts = res[key][2]
            if counts != {**{n: 0 for n in counts},
                          "flash_attention_rope_qonly": want[key]}:
                raise AssertionError(f"{phase}: rank {r} {key} launches "
                                     f"{counts}, expected K2 {want[key]} "
                                     f"and nothing else")
        if len(res["server_finals"]) != 1 or not torch.equal(
                res["server_finals"][0], r0["server_finals"][0]):
            raise AssertionError(f"{phase}: rank {r}'s served batch differs "
                                 f"from rank 0's")
    log(f"[{phase}] g={world} ranks ({r0['backend']}, ranks on "
        f"{sorted({res['device'] for res in ranks})}), small f32 model "
        f"(8 heads of 64, 2 layers): ring hidden == solo K1 hidden within "
        f"2e-4 (max |err| {float(err.max()):.2e}); the exact edit over the "
        f"ring token-exact against the solo K1 and plain runs, the "
        f"interleave against its solo run; TI2TIServer over the ring: 2 "
        f"requests from 2 threads in 1 batch, each == its solo run; every "
        f"rank's ids == rank 0's; int8 payload cosine {r0['int8_cos']:.6f}, "
        f"argmax agreement {r0['int8_argmax']:.4f}; K2 a rank: edit "
        f"{want['edit']} (= 2g x {cfg.n_layers} layers x "
        f"{opts.text_steps + n_img} forwards), interleave "
        f"{want['interleave']}, K1 0; {wall:.1f} s with the spawn")


def phase_ring_small() -> None:
    _ring_small("ring-small", RING_G, "gloo")


def phase_ring_nccl() -> None:
    """[ring-small] over NCCL, one card a rank, where the machine has two
    or more cards (g = 4 with four, else 2: the 8 heads must split)."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[ring-nccl] not run: {n} card visible; NCCL needs one card a "
            f"rank (two ranks on one device are refused), so the ring over "
            f"NCCL across cards is not verified by this run")
        return
    _ring_small("ring-nccl", 4 if n >= 4 else 2, "nccl")


# -- [serve-a-ring]: the 8B-width A edit served over the ring --------------

RING_TEXTS = ("make the sky purple", "turn the grass blue")


def _ring_requests():
    """Two A edit prompts of one length (the stand-in's 50 text ids around
    a 32x32 code span with its newlines): 1108 tokens, a 2424-token layout
    (divisible by 4 and 8).  Seeded random codes stand in for the VQ."""
    import numpy as np
    from mmada_parallel_torch import tokens as tk
    T = tk.TOKENS_A
    rng = np.random.default_rng(0)
    prompts = []
    for text in RING_TEXTS:
        ids = StandInTokenizer()(text)["input_ids"]
        span = tk.add_break_line(
            (rng.integers(0, T.codebook_size, 1024)
             + T.text_vocab_size).tolist(), 32, 32, T.newline)
        prompts.append(ids[:-1] + [T.boi] + span + [T.eoi] + ids[-1:])
    row, lay = tk.assemble_ti2ti_sequence(prompts[0], 256, 32, 32,
                                          [T.answer_end], tokens=T)
    if lay.total_len != EDIT_L or len(set(map(len, prompts))) != 1:
        raise AssertionError(f"[serve-a-ring] layout {lay.total_len}, "
                             f"prompts {list(map(len, prompts))}")
    return prompts, row, np.asarray(StandInTokenizer()(RING_TEXTS[0])[
        "input_ids"])


def _timed_permute(tally):
    """A ``permute=`` hook: adds the bytes this rank sends (tally[0]), the
    rounds (tally[1]) and the seconds spent posting and completing rounds
    (tally[2]), then runs the real ring round."""
    from mmada_parallel_torch.parallel.tp_overlap import ring_permute

    def permute(xs, directions, group):
        t0 = time.perf_counter()
        tally[0] += sum(x.numel() * x.element_size() for x in xs)
        tally[1] += 1
        wait = ring_permute(xs, directions, group)
        tally[2] += time.perf_counter() - t0

        def timed_wait():
            t1 = time.perf_counter()
            out = wait()
            tally[2] += time.perf_counter() - t1
            return out
        return timed_wait
    return permute


def _serve_a_ring_rank(rank, world, workdir):
    """[serve-a-ring] on one rank: the 8B tree drawn from seed 0 in turn
    (rank 0 also runs the solo K1 forward of the first request's row), this
    rank's shards kept; one ring forward exact and int8 (bytes and permute
    time counted), then the SPMD server exact and with the int8 payload."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from mmada_parallel_torch import serving
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params,
                                                   llada_hidden)
    from mmada_parallel_torch.ops import sampling as S
    from mmada_parallel_torch.parallel import (MeshConfig, make_mesh,
                                               shard_params)
    from mmada_parallel_torch.parallel import tp_overlap as TP
    from mmada_parallel_torch.models.llada import param_shardings
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = LLaDAConfig.llada_8b(param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, tensor=world), "cuda")
    prompts, row, prefix = _ring_requests()
    ids = torch.as_tensor(row, device=dev)[None]
    out = {"mesh": str(mesh)}
    t0 = time.time()
    for turn in range(world):          # one full tree on the card at a time
        if rank == turn:
            torch.cuda.reset_peak_memory_stats()
            full = init_llada_params(
                cfg, torch.Generator(device=dev).manual_seed(0))
            if rank == 0:
                reset_launches()
                out["solo_hidden"] = llada_hidden(full, cfg, ids).cpu()
                out["solo_launches"] = read_launches()
            params = shard_params(full, param_shardings(cfg), mesh)
            del full
            torch.cuda.synchronize()
            out["draw_peak"] = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
        dist.barrier()
    out["draw_s"] = time.time() - t0
    out["held"] = sum(t.numel() * t.element_size() for v in params.values()
                      for t in (v.values() if isinstance(v, dict) else [v]))
    torch.cuda.reset_peak_memory_stats()

    for name, int8 in (("exact", False), ("int8", True)):
        tally = [0, 0, 0.0]
        fn = TP.ring_hidden_fn(mesh, int8_payload=int8,
                               permute=_timed_permute(tally))
        with torch.inference_mode():
            if not int8:
                fn(params, cfg, ids)                 # warm
            tally[:] = [0, 0, 0.0]
            reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            hidden = fn(params, cfg, ids)
            torch.cuda.synchronize()
        out[f"fwd_{name}"] = {"s": time.perf_counter() - t1,
                              "bytes": tally[0], "rounds": tally[1],
                              "permute_s": tally[2],
                              "launches": read_launches()}
        out[f"hidden_{name}"] = hidden.cpu() if rank == 0 else None

    # 2 text steps (once 4): the depth cut to keep the script inside its
    # time limit
    opts = TI2TIOptions(text_steps=RING_TEXT_STEPS, timesteps=2,
                        temperature=0.0, text_temperature=0.0, cfg_img=4.0)
    out["n_img"] = int(S.image_step_mask(opts.text_steps,
                                         opts.timesteps).sum())
    real = serving.generate_ti2ti
    # the int8 payload serves the first request alone: with both, the
    # phase ran past the ~120 s it is given (PERF.md)
    for name, int8, reqs in (("exact", False, prompts),
                             ("int8", True, prompts[:1])):
        finals = []

        def recording(*a, **kw):
            fin, codes = real(*a, **kw)
            finals.append((fin.cpu(), codes.cpu()))
            return fin, codes

        serving.generate_ti2ti = recording
        tally = [0, 0, 0.0]
        srv = serving.TI2TIServer(
            params, cfg, opts, serving.ServeConfig(
                batch_size=2, max_wait_ms=500.0, bucket_quantum=128,
                max_prompt_len=2048),
            uncond_image_prefix=prefix,
            hidden_fn=TP.ring_hidden_fn(mesh, int8_payload=int8,
                                        permute=_timed_permute(tally)))
        torch.cuda.synchronize()
        reset_launches()
        t1 = time.perf_counter()
        if rank == 0:
            res = _concurrently(srv, [((p,), {}) for p in reqs])
            out[f"served_{name}"] = {"results": res, "stats": srv.stats()}
        srv.close()
        torch.cuda.synchronize()
        serving.generate_ti2ti = real
        out[f"serve_{name}"] = {"s": time.perf_counter() - t1,
                                "launches": read_launches(),
                                "finals": finals, "bytes": tally[0],
                                "permute_s": tally[2]}
    out["serve_peak"] = torch.cuda.max_memory_allocated()
    return out


def phase_serve_a_ring() -> int:
    """[serve-a-ring]: ``TI2TIServer(hidden_fn=ring_hidden_fn(mesh))`` at
    the full 8B width (all 32 layers, random bf16 weights from seed 0, as
    the other full-width phases) on 4 ranks sharing this card over gloo;
    two requests from two threads on rank 0, 2 text and 2 image steps,
    ``cfg_img`` 4.0; then the first request alone with
    ``--tp_ring_int8``'s payload.  Returns
    rank 0's K2 launches in the exact serving run."""
    import torch
    from mmada_parallel_torch.models.llada import LLaDAConfig
    g = RING_G
    cfg = LLaDAConfig.llada_8b()
    t0 = time.time()
    ranks = _run_ranks("serve-a-ring", _serve_a_ring_rank, g, "gloo",
                       timeout=900)
    wall = time.time() - t0
    r0 = ranks[0]
    n_img = r0["n_img"]
    forwards = RING_TEXT_STEPS + n_img
    k2_fwd = 2 * g * cfg.n_layers
    if r0["solo_launches"]["flash_attention_rope"] != cfg.n_layers:
        raise AssertionError(f"[serve-a-ring] solo forward launches "
                             f"{r0['solo_launches']}")
    solo = r0["solo_hidden"].float()
    ring = r0["hidden_exact"].float()
    rel = float((ring - solo).norm() / solo.norm())
    mx = float((ring - solo).abs().max())
    q8 = r0["hidden_int8"].float()
    rel8 = float((q8 - ring).norm() / ring.norm())
    rel8s = float((q8 - solo).norm() / solo.norm())
    mx8s = float((q8 - solo).abs().max())
    cos8 = float(torch.nn.functional.cosine_similarity(
        q8.flatten().double(), ring.flatten().double(), dim=0))
    if not (rel <= RING_BF16_REL_L2 and mx <= RING_BF16_MAX):
        raise AssertionError(f"[serve-a-ring] ring hidden vs solo K1: "
                             f"relative L2 {rel:.4e}, max {mx:.4e} (bounds "
                             f"{RING_BF16_REL_L2}, {RING_BF16_MAX})")
    if rel8s <= RING_BF16_REL_L2 and mx8s <= RING_BF16_MAX:
        raise AssertionError(f"[serve-a-ring] the int8 payload's hidden "
                             f"state passes the exact ring's bound (relative "
                             f"L2 {rel8s:.4e}, max {mx8s:.4e}): the bound "
                             f"would not catch a lower-precision transfer")
    if cos8 <= 0.999:
        raise AssertionError(f"[serve-a-ring] int8 payload hidden cosine "
                             f"{cos8} (bar 0.999)")
    S_bytes = EDIT_L * cfg.d_model * 2                    # B=1, bf16
    want_bytes = cfg.n_layers * 4 * S_bytes * (g - 1) // g
    for r, res in enumerate(ranks):
        for name in ("exact", "int8"):
            f = res[f"fwd_{name}"]
            if f["launches"] != {**{n: 0 for n in f["launches"]},
                                 "flash_attention_rope_qonly": k2_fwd}:
                raise AssertionError(f"[serve-a-ring] rank {r} {name} "
                                     f"forward launches {f['launches']}")
            sv = res[f"serve_{name}"]
            want = {**{n: 0 for n in sv["launches"]},
                    "flash_attention_rope_qonly": k2_fwd * forwards}
            if sv["launches"] != want:
                raise AssertionError(f"[serve-a-ring] rank {r} {name} "
                                     f"serving launches {sv['launches']}, "
                                     f"expected {want}")
            mine, lead = sv["finals"], r0[f"serve_{name}"]["finals"]
            if len(mine) != 1 or not all(torch.equal(a, b) for a, b in
                                         zip(mine[0], lead[0])):
                raise AssertionError(f"[serve-a-ring] rank {r}'s {name} "
                                     f"ids differ from rank 0's")
        if res["fwd_exact"]["bytes"] != want_bytes:
            raise AssertionError(f"[serve-a-ring] rank {r} sent "
                                 f"{res['fwd_exact']['bytes']} bytes a "
                                 f"forward, expected {want_bytes}")
    for name in ("exact", "int8"):
        served = r0[f"served_{name}"]
        if served["stats"]["batches"] != 1:
            raise AssertionError(f"[serve-a-ring] {name}: "
                                 f"{served['stats']}, expected one batch")
        for res in served["results"]:
            c = res["codes"]
            if c.shape != (1024,) or c.min() < 0 or c.max() >= 8192:
                raise AssertionError(f"[serve-a-ring] {name}: codes out "
                                     f"of range or shape {c.shape}")
    same = float((r0["served_exact"]["results"][0]["codes"]
                  == r0["served_int8"]["results"][0]["codes"]).mean())
    fe, f8 = r0["fwd_exact"], r0["fwd_int8"]
    se, s8 = r0["serve_exact"], r0["serve_int8"]
    log(f"[serve-a-ring] {RING_LABEL}. llada_8b, {cfg.n_layers} layers, "
        f"bf16, g={g} ({r0['mesh']}); each rank holds "
        f"{r0['held'] / 1e9:.3f} GB of weights; peaks by rank, drawing the "
        f"tree in turn: {[round(r['draw_peak'] / 2 ** 30, 2) for r in ranks]}"
        f" GiB, serving: {[round(r['serve_peak'] / 2 ** 30, 2) for r in ranks]}"
        f" GiB; the draws {r0['draw_s']:.1f} s")
    log(f"[serve-a-ring] one ring forward B=1 L={EDIT_L} vs the solo K1 "
        f"forward: relative L2 {rel:.4e}, max |diff| {mx:.4e} (bounds "
        f"{RING_BF16_REL_L2}, {RING_BF16_MAX}); the int8 payload's vs the "
        f"same solo forward: relative L2 {rel8s:.4e}, max |diff| "
        f"{mx8s:.4e} (fails the bounds, as it must); int8 payload vs the "
        f"exact ring: relative L2 {rel8:.4e}, cosine {cos8:.6f} (bar 0.999)")
    log(f"[serve-a-ring] bytes sent a rank a forward: exact "
        f"{fe['bytes']} = 32 layers x 4 boundaries x (g-1)/g x "
        f"{S_bytes} (B*L*d bf16), {fe['rounds']} rounds; int8 "
        f"{f8['bytes']} ({f8['bytes'] / fe['bytes']:.3f}x). Forward "
        f"{fe['s']:.3f} s exact, {f8['s']:.3f} s int8; in permute "
        f"{fe['permute_s']:.3f} s ({100 * fe['permute_s'] / fe['s']:.1f} % "
        f"of the forward's wall), int8 {f8['permute_s']:.3f} s "
        f"({100 * f8['permute_s'] / f8['s']:.1f} %)")
    log(f"[serve-a-ring] TI2TIServer over the ring, 2 requests from 2 "
        f"threads in 1 batch (B=2), {RING_TEXT_STEPS} text + {n_img} image "
        f"steps, cfg_img "
        f"4.0: every rank's ids == rank 0's, codes in range; K2 "
        f"{k2_fwd * forwards} a rank (= 2g x 32 layers x {forwards} "
        f"forwards), K1 0; {se['s']:.2f} s for the two requests "
        f"({se['s'] / 2:.2f} s a request), {100 * se['permute_s'] / se['s']:.1f}"
        f" % in permute; int8 payload, the first request alone (B=1): "
        f"{s8['s']:.2f} s, {100 * same:.1f} % of its codes equal to the "
        f"exact ring's; the phase {wall:.1f} s with the spawn")
    return r0["serve_exact"]["launches"]["flash_attention_rope_qonly"]


# -- [demo-a-ring]: the trained A demo over the ring -----------------------

def _demo_ring_rank(rank, world, workdir):
    import torch
    from mmada_parallel_torch.examples import train_edit_demo_a as A
    from mmada_parallel_torch.parallel import (MeshConfig, make_mesh,
                                               shard_params)
    from mmada_parallel_torch.parallel import tp_overlap as TP
    from mmada_parallel_torch.models.llada import param_shardings
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    dev = torch.device("cuda", torch.cuda.current_device())
    T = A.demo_tokens()
    cfg = A.demo_config(T)
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, tensor=world), "cuda")
    local = shard_params({k: ({n: t.to(dev) for n, t in v.items()}
                              if isinstance(v, dict) else v.to(dev))
                          for k, v in inp.items()},
                         param_shardings(cfg), mesh)
    out = {}
    for name, int8 in (("exact", False), ("int8", True)):
        reset_launches()
        accs, _, texts, _ = A.eval_a_model(
            local, cfg, T, A.WordTokA(),
            hidden_fn=TP.ring_hidden_fn(mesh, int8_payload=int8))
        out[name] = (accs, texts, read_launches())
    return out


def phase_demo_a_ring(trained) -> None:
    """The trained A demo model over a g=4 ring on this card, held to JAX's
    bars (``tests/test_capability_demo.py:182-210``): the exact ring's
    accuracy equals the solo one, the int8 payload's is within 0.1 of it,
    "rotated" in both texts; the demo's head_dim is 32, so no kernel
    launches (checked)."""
    import numpy as np
    m, params, cfg, T, tokz = trained
    base = m["eval_code_accuracy"]
    ranks = _run_ranks("demo-a-ring", _demo_ring_rank, RING_G, "gloo",
                       inputs={k: ({n: t.cpu() for n, t in v.items()}
                                   if isinstance(v, dict) else v.cpu())
                               for k, v in params.items()}, timeout=300)
    for r, res in enumerate(ranks):
        for name, (accs, texts, counts) in res.items():
            acc = float(np.mean(accs))
            # the demo's metric is rounded to 4 places
            ok = (round(acc, 4) == base if name == "exact"
                  else acc >= base - 0.1)
            if not ok or "rotated" not in texts[0] or any(counts.values()):
                raise AssertionError(f"[demo-a-ring] rank {r} {name}: "
                                     f"accuracy {acc} against {base}, text "
                                     f"{texts[0]!r}, launches {counts}")
    ex, q8 = ranks[0]["exact"], ranks[0]["int8"]
    log(f"[demo-a-ring] the trained A model over a g={RING_G} ring "
        f"(gloo, one card), eval sequence 64 tokens: exact "
        f"{float(np.mean(ex[0]))} (solo {base}), int8 payload "
        f"{float(np.mean(q8[0]))}, texts {ex[1][0]!r} / {q8[1][0]!r}, no "
        f"kernel launch (head_dim {cfg.head_dim}), every rank alike")


# ---------------------------------------------------------------------------
# Training over the (data, fsdp, tensor) mesh: ranks on the card
# ---------------------------------------------------------------------------

MESH_LAYERS, MESH_STEPS, MESH_SEED = 2, 2, 21
MESH_LABEL = ("ranks sharing one card over host-staged gloo: not multi-GPU "
              "times")
# Gates against the solo step of this process on the same global batch
# (PERF.md section 6, with their basis).  f32: the ranks differ from
# the solo step in GEMM shapes (1 row against the whole batch) and in the
# order of the gradient sums, so the loss and the grad norm agree to f32
# rounding; each leaf's parameters to a relative L2 of 1e-3 of the solo
# step's update of that leaf over the two steps (AdamW's first updates are
# +-lr wherever |grad| >> eps = 1e-8, and an element whose gradient sits
# near eps moves by a part of lr under a reordered f32 sum: on the H100 one
# wte element came 2.0e-6 off a 4.0e-5 update; a wrong gradient sync
# moves whole rows by their update, a relative L2 of 0.1 or more).
# bf16: the loss and grad norm within twice the
# solo bf16 step's own distance from the solo f32 step (at least 1e-5
# relative): the ring's reduce-scatter sums round in bf16 where the solo
# GEMM does not (PERF.md section 6), so its bf16 noise is not the solo's.
MESH_LOSS_RTOL, MESH_NORM_RTOL, MESH_PARAM_REL_L2 = 1e-5, 1e-4, 1e-3
MESH_BF16_FACTOR, MESH_BF16_FLOOR = 2.0, 1e-5
# Megatron's split in bf16 ([train-a-tp], (1, 2, 2)): the row-parallel
# partial products and the column-parallel inputs' gradient partials round
# to bf16 before their all-reduces, so its bf16 step is a different sample
# of bf16 noise from the solo one, as far from f32 (each leaf's gradient
# within 2x the solo's distance from f32, on the CPU:
# tests/test_torch_train_tensor.py::
# test_bf16_gradients_sit_as_far_from_f32_as_solo).  On the H100 its two
# steps' losses sat 3.2e-5 and 9.1e-5 (relative) from the solo bf16 step's,
# its grad norms 2.1e-4 and 3.1e-5 (PERF.md section 6); the bound is 1e-3,
# about 5x the largest.
# The same mesh's f32 run holds the tight gates above leaf by leaf, which a
# wrong sync fails.
TP_BF16_RTOL = 1e-3
# The training ring ([train-a-ring]) also runs bf16 with the backward by the
# plain-chain recompute ("bf16-chain", the attention gradient of PR 12),
# solo and on the ring.  The ring's bf16-chain run keeps PR 12's gate
# against the solo bf16-chain step (twice the solo's distance from f32).
# The ring's bf16 run, whose backward is K2's kernel, is held to the
# ring's own bf16-chain run on the same seed: the loss and grad norm within
# twice that run's distance from the solo f32 step (at least 1e-5
# relative), the ring's own bf16 noise.  The solo bf16 step is not its
# base: with K1's backward kernel it sits closer to f32 (1.2e-4 of the loss
# at step 2, against 3.1e-4 with the plain chain, H100), which says nothing
# of the ring's reduce-scatter sums (PERF.md section 6).  A control run
# ("bf16-control": K2's backward kernel with its gradients scaled by
# BF16_CONTROL_SCALE, a kernel 20 % off everywhere) must fail that gate.
BF16_CHAIN, BF16_CONTROL = "bf16-chain", "bf16-control"
BF16_CONTROL_SCALE = 1.2


@contextlib.contextmanager
def _backward(precision: str):
    """The attention Functions' backward for one run of ``precision``:
    ``bf16-chain`` takes the plain-chain recompute where bf16 would launch
    the backward kernel; ``bf16-control`` launches K2's backward kernel and
    scales its gradients by ``BF16_CONTROL_SCALE``."""
    from mmada_parallel_torch.ops import attention as A
    kept = A._kernel_backward, A.flash_attention_rope_qonly_bwd
    if precision == BF16_CHAIN:
        A._kernel_backward = lambda t: False
    elif precision == BF16_CONTROL:
        def scaled(*args, **kw):
            return [g * BF16_CONTROL_SCALE for g in kept[1](*args, **kw)]
        A.flash_attention_rope_qonly_bwd = scaled
    try:
        yield
    finally:
        A._kernel_backward, A.flash_attention_rope_qonly_bwd = kept


def _compute_dtype(precision: str):
    import torch
    return torch.float32 if precision == "f32" else torch.bfloat16


def _mesh_cfg(dtype):
    """``llada_8b`` widths, 2 of 32 layers: f32 params, ``dtype`` compute,
    remat ``whole_layer``, the kernels."""
    import torch
    from mmada_parallel_torch.models.llada import LLaDAConfig
    return LLaDAConfig.llada_8b(n_layers=MESH_LAYERS,
                                param_dtype=torch.float32,
                                compute_dtype=dtype, remat="whole_layer")


def _mesh_build(cfg, params, **kw):
    """``cli/train_a.build_train_step`` with the A recipe (lr 2e-5, wd 0.1,
    clip 4.0), one microbatch."""
    from mmada_parallel_torch.cli.train_a import build_train_step
    return build_train_step(cfg, params, lr=2e-5, min_lr=0.0, wd=0.1,
                            clip_grad=4.0, warmup_steps=0, total_steps=100,
                            accum_steps=1, **kw)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _mesh_solo(batch, precisions, steps: int = MESH_STEPS) -> dict:
    """The solo A step of this process in each of ``precisions`` (compute
    dtypes, f32 among them), ``steps`` steps on the whole batch, and the
    f32 run's final parameters (CPU)."""
    import gc
    import torch
    from mmada_parallel_torch.models.llada import init_llada_params
    out = {}
    for name in precisions:
        cfg = _mesh_cfg(_compute_dtype(name))
        params = init_llada_params(
            cfg, torch.Generator(device="cuda").manual_seed(MESH_SEED))
        sizes = {k: v.numel() for k, v in _leaves(params).items()}
        state, step, _ = _mesh_build(cfg, params)
        del params
        ms, secs = [], []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with _backward(name):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            ms.append({k: float(v) for k, v in m.items()})
        out[name] = {"metrics": ms, "secs": secs, "sizes": sizes}
        if name == "f32":
            out["final"] = {k: v.detach().cpu().clone()
                            for k, v in _leaves(state.params).items()}
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _mesh_reckon(sizes: dict, mode: str, strategy: str, world: int,
                 n_data: int, g: int = 1) -> dict:
    """Bytes a rank holds (f32: parameter, gradient, mu, nu) and the most it
    gathers at once (``wte``, ``head`` and one layer, with their gradients
    in the backward), from the leaf sizes; the head stays split over fsdp
    under every strategy (JAX's ``drop_axis`` keeps its (fsdp, tensor)
    entry).  ``g``: the ranks of the ``tensor`` axis; the ring and
    Megatron's split hold ``1/g`` of every leaf but the norms, ``wte`` and
    ``head`` vocab-parallel."""
    head, wte = sizes["head"], sizes["wte"]
    layer = sum(v for k, v in sizes.items()
                if k.startswith("blocks.")) // MESH_LAYERS
    total = sum(sizes.values())
    n = world // n_data
    if mode == "ring":
        state = 16 * ((total - sizes["ln_f"]) // n + sizes["ln_f"])
        gathered = 0
    elif mode == "tensor":
        state = 16 * total // n
        gathered = 4 * 2 * (wte + head + layer) // g if n > g else 0
    elif strategy == "full":
        state = 16 * total // n
        gathered = 4 * 2 * (wte + head + layer)
    elif strategy == "zero2":
        state = 8 * (total - head) + 8 * (total - head) // n + 16 * head // n
        gathered = 4 * 2 * head
    else:
        state = 16 * (total - head) + 16 * head // n
        gathered = 4 * 2 * head
    return {"state": state, "gathered": gathered}


def _ring_counted():
    """Patch ``tp_overlap._post_round`` and ``_all_gather_rows`` (every ring
    round, forward and backward, and the row gathers) to add their bytes
    sent and host seconds to a tally; returns the tally."""
    from mmada_parallel_torch.parallel import tp_overlap as TP
    tally = {"sent": 0, "seconds": 0.0}
    post, rows = TP._post_round, TP._all_gather_rows

    def counted_post(xs, directions, group):
        t0 = time.perf_counter()
        wait = post(xs, directions, group)
        tally["sent"] += sum(x.numel() * x.element_size() for x in xs)

        def timed_wait():
            out = wait()
            tally["seconds"] += time.perf_counter() - t0
            return out
        return timed_wait

    def counted_rows(x, group):
        t0 = time.perf_counter()
        out = rows(x, group)
        tally["sent"] += x.numel() * x.element_size()
        tally["seconds"] += time.perf_counter() - t0
        return out

    TP._post_round, TP._all_gather_rows = counted_post, counted_rows
    return tally


def _mesh_train_rank(rank, world, workdir):
    """One spawned rank of ``[train-a-fsdp]`` / ``[train-a-ring]`` /
    ``[train-a-tp]`` / ``[fsdp-nccl]``: for each strategy, f32 then bf16,
    the tree drawn from
    the seed in turn, the sharded A step of ``cli/train_a`` for
    ``MESH_STEPS`` steps on this rank's rows; launches, seconds, transfer
    tallies and the peak by step, and (f32) each leaf's largest difference
    from the solo step's parameters."""
    import gc
    import torch
    import torch.distributed as dist
    from mmada_parallel_torch.models.llada import init_llada_params
    from mmada_parallel_torch.parallel import MeshConfig, make_mesh
    from mmada_parallel_torch.parallel.mesh import _local_view, local_rows
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(MeshConfig(*inp["shape"]), "cuda")
    ring = inp["mode"] == "ring"
    batch = tuple(x.to(dev) for x in inp["batch"])
    if not ring:
        batch = local_rows(batch, mesh)
    ref = (torch.load(inp["ref"], mmap=True, weights_only=True)
           if inp.get("ref") else None)
    ring_tally = _ring_counted() if ring else None
    out = {"coord": tuple(mesh.get_coordinate()), "backend":
           dist.get_backend(), "device": str(dev)}
    for strategy in inp["strategies"]:
        for name in inp["precisions"]:
            cfg = _mesh_cfg(_compute_dtype(name))
            tally = {}
            for turn in range(world):      # one whole tree on the card
                if rank == turn:
                    params = init_llada_params(
                        cfg, torch.Generator(device=dev).manual_seed(
                            MESH_SEED))
                    state, step, _ = _mesh_build(
                        cfg, params, mesh=mesh, shard_strategy=strategy,
                        tp_ring=ring, tally=tally)
                    del params
                    torch.cuda.empty_cache()
                dist.barrier()
            init = ({k: v.detach().to("cpu", copy=True)
                     for k, v in _leaves(state.params).items()}
                    if ref is not None and name == "f32" else None)
            torch.cuda.reset_peak_memory_stats()
            run = {"metrics": [], "secs": [], "launches": [], "moved": []}
            for _ in range(inp["steps"]):
                tally.clear()
                if ring_tally is not None:
                    ring_tally.update(sent=0, seconds=0.0)
                torch.cuda.synchronize()
                reset_launches()
                t0 = time.perf_counter()
                with _backward(name):
                    state, m = step(state, batch)
                torch.cuda.synchronize()
                run["secs"].append(time.perf_counter() - t0)
                run["launches"].append(read_launches())
                run["metrics"].append({k: float(v) for k, v in m.items()})
                run["moved"].append(dict(ring_tally if ring else tally))
            run["peak"] = torch.cuda.max_memory_allocated()
            if init is not None:      # max |diff|, |diff|, |solo update|
                specs = _leaves(step.state_specs.params)
                run["param_err"] = {}
                for k, v in _leaves(state.params).items():
                    want = _local_view(ref[k], specs[k], mesh).to(dev)
                    diff = v.detach() - want
                    run["param_err"][k] = (
                        float(diff.abs().max()), float(diff.norm()),
                        float((want - init[k].to(dev)).norm()))
                    del want, diff
                del init
            run["held"] = sum(t.numel() * t.element_size() for t in
                              _leaves(state.params).values()) + sum(
                t.numel() * t.element_size() for t in
                _leaves(state.opt_state).values()
                if isinstance(t, torch.Tensor))
            out[(strategy, name)] = run
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _mesh_gate(phase: str, strategy: str, what: str, got: list,
               solo: dict, bf16_rtol=None, chain=None) -> None:
    """Each step's loss and grad norm against the solo step's (f32: rtol;
    bf16 and bf16-chain: twice the same solo run's distance from the solo
    f32 step, or ``bf16_rtol`` of the solo bf16 step's value) or, for bf16
    where ``chain`` (this rank's bf16-chain metrics) is given, against
    ``chain`` within twice its distance from the solo f32 step."""
    for i, m in enumerate(got):
        for key, rtol in (("loss", MESH_LOSS_RTOL),
                          ("grad_norm", MESH_NORM_RTOL)):
            f32 = solo["f32"]["metrics"][i][key]
            base = "the solo step's"
            if what == "f32":
                want = f32
                bound = rtol * abs(want)
            elif bf16_rtol is not None:
                want = solo[what]["metrics"][i][key]
                bound = bf16_rtol * abs(want)
            else:
                if what == "bf16" and chain is not None:
                    want, base = chain[i][key], "the ring's bf16-chain"
                else:
                    want = solo[what]["metrics"][i][key]
                bound = max(MESH_BF16_FACTOR * abs(want - f32),
                            MESH_BF16_FLOOR * abs(want))
            if not (math.isfinite(m[key]) and abs(m[key] - want) <= bound):
                raise AssertionError(
                    f"[{phase}] {strategy} {what} step {i + 1} {key} "
                    f"{m[key]} against {base} {want} (bound "
                    f"{bound:.3e})")
        if m["nonfinite"]:
            raise AssertionError(f"[{phase}] {strategy} {what} step {i + 1} "
                                 f"skipped")


def _mesh_control(phase: str, strategy: str, ranks, solo, want) -> None:
    """The ``bf16-control`` run of each rank: its launches as bf16's, and
    the bf16 gate against the rank's bf16-chain run must refuse it."""
    for r, res in enumerate(ranks):
        run = res[(strategy, BF16_CONTROL)]
        if any(x != want for x in run["launches"]):
            raise AssertionError(f"[{phase}] {strategy} {BF16_CONTROL} rank "
                                 f"{r} launches {run['launches']}, expected "
                                 f"{want} a step")
        try:
            _mesh_gate(phase, strategy, "bf16", run["metrics"], solo, None,
                       res[(strategy, BF16_CHAIN)]["metrics"])
        except AssertionError as e:
            if r == 0:
                log(f"[{phase}] {strategy} {BF16_CONTROL} (K2's backward x"
                    f"{BF16_CONTROL_SCALE}): losses "
                    f"{[round(m['loss'], 6) for m in run['metrics']]}, grad "
                    f"norms "
                    f"{[round(m['grad_norm'], 6) for m in run['metrics']]}; "
                    f"refused by the bf16 gate as it must be: {e}")
            continue
        raise AssertionError(f"[{phase}] {strategy} rank {r}: the bf16 gate "
                             f"passes the {BF16_CONTROL} run "
                             f"{run['metrics']}")


def _mesh_phase(phase: str, mode: str, strategies, world: int,
                backend: str = "gloo", precisions=("f32", "bf16"),
                shape=None, steps: int = MESH_STEPS,
                bf16_rtol=None) -> dict:
    """Spawn ``world`` ranks of ``_mesh_train_rank`` (``mode`` "fsdp" on
    the mesh ``(1, world, 1)``, "ring" on ``(1, 1, world)``, "tensor"
    (Megatron's split, no ring) on ``shape``) for each strategy in each of
    ``precisions`` (compute dtypes), ``steps`` steps, gate them against
    the solo step (f32 and the bf16 ones asked for; ``bf16_rtol``: see
    :func:`_mesh_gate`), print and return rank 0's runs."""
    import tempfile
    import torch
    shape = shape or ((1, world, 1) if mode == "fsdp" else (1, 1, world))
    rows = shape[0] * shape[1]
    batch = _a_train_batch(torch.Generator(device="cuda").manual_seed(22),
                           rows, EDIT_L)
    solo = _mesh_solo(batch, ("f32",) + tuple(
        p for p in precisions if p not in ("f32", BF16_CONTROL)), steps)
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    # the ranks share the card: let their allocators return what they free
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            ref = os.path.join(tmp, "solo_f32.pt")
            torch.save(solo["final"], ref)
            t0 = time.time()
            ranks = _run_ranks(phase, _mesh_train_rank, world, backend,
                               inputs={"shape": shape, "mode": mode,
                                       "strategies": list(strategies),
                                       "precisions": list(precisions),
                                       "steps": steps,
                                       "batch": tuple(x.cpu()
                                                      for x in batch),
                                       "ref": ref}, timeout=900)
            wall = time.time() - t0
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    sizes = solo["f32"]["sizes"]
    n_layers = MESH_LAYERS
    wants = {}
    for what in precisions:
        want = wants[what] = {n: 0 for n in KERNELS}
        bwd = what in ("bf16", BF16_CONTROL)   # f32, bf16-chain: the chain
        if mode != "ring":          # forward + remat recompute, one row
            want["flash_attention_rope"] = n_layers * 2
            want["flash_attention_rope_bwd"] = n_layers * bwd
        else:                       # 2g sigma-chunks a layer, no remat
            want["flash_attention_rope_qonly"] = 2 * world * n_layers
            want["flash_attention_rope_qonly_bwd"] = 2 * world * n_layers * bwd
    for strategy in strategies:
        for what in precisions:
            if what == BF16_CONTROL:
                _mesh_control(phase, strategy, ranks, solo, wants[what])
                continue
            want = wants[what]
            runs = [res[(strategy, what)] for res in ranks]
            rk = _mesh_reckon(sizes, mode, strategy, world, shape[0],
                              shape[2])
            act = 3 * 4 * EDIT_L * sizes["head"] // 4096
            r0 = runs[0]
            step_s = r0["secs"][-1]
            moved = r0["moved"][-1]
            xfer = moved.get("seconds", 0.0)
            if mode == "tensor":
                red = moved.get("reduced_seconds", 0.0)
                vol = (f"all-reduces {moved.get('reduced', 0) / 1e9:.3f} GB "
                       f"over tensor a step ({red:.3f} s, "
                       f"{100 * red / step_s:.1f} % of the step), gathers "
                       f"{moved.get('gathered', 0) / 1e9:.3f} GB (the FSDP "
                       f"gathers and the logits over tensor) and "
                       f"reduce-scatters {moved.get('scattered', 0) / 1e9:.3f}"
                       f" GB")
            elif mode == "fsdp":
                vol = (f"gathers {moved.get('gathered', 0) / 1e9:.3f} GB and "
                       f"reduce-scatters {moved.get('scattered', 0) / 1e9:.3f}"
                       f" GB a step through the gather Function")
            else:
                vol = (f"sends {moved['sent'] / 1e9:.3f} GB a step in ring "
                       f"rounds and row gathers")
            rel = {(r, k): (e[1] / e[2] if e[2] else float(e[1] > 0))
                   for r, run in enumerate(runs)
                   for k, e in run.get("param_err", {}).items()}
            log(f"[{phase}] {MESH_LABEL}. {strategy} {what}, {world} ranks "
                f"({ranks[0]['backend']}), mesh {shape}: losses "
                f"{[round(m['loss'], 6) for m in r0['metrics']]} (solo "
                f"{[round(m['loss'], 6) for m in solo[what]['metrics']]}), "
                f"grad norms {[round(m['grad_norm'], 6) for m in r0['metrics']]}"
                f" (solo "
                f"{[round(m['grad_norm'], 6) for m in solo[what]['metrics']]})"
                + (f"; parameters against the solo step, largest relative "
                   f"L2 of a leaf's update {max(rel.values()):.3e} (rank, "
                   f"leaf {max(rel, key=rel.get)}), largest |diff| "
                   f"{max(e[0] for run in runs for e in run['param_err'].values()):.3e}"
                   f"; by leaf (rank 0): " + ", ".join(
                       f"{k} {e[0]:.2e}/{e[1] / max(e[2], 1e-30):.2e}"
                       for k, e in r0["param_err"].items())
                   if what == "f32" else ""))
            log(f"[{phase}] {strategy} {what}: s/step {[round(s, 3) for s in r0['secs']]}"
                f" (solo {[round(s, 3) for s in solo[what]['secs']]}); rank 0 "
                f"{vol}, {xfer:.3f} s in them ({100 * xfer / step_s:.1f} % of "
                f"the step); peaks by rank "
                f"{[round(run['peak'] / 2 ** 30, 2) for run in runs]} GiB, "
                f"sum {sum(run['peak'] for run in runs) / 2 ** 30:.2f} GiB "
                f"against the reckoning {world} x ({rk['state'] / 2 ** 30:.2f}"
                f" state + {rk['gathered'] / 2 ** 30:.2f} gathered + "
                f"~{act / 2 ** 30:.2f} logits) = "
                f"{world * (rk['state'] + rk['gathered'] + act) / 2 ** 30:.2f}"
                f" GiB; state held a rank (parameters and optimizer) "
                f"{[round(run['held'] / 1e9, 2) for run in runs]} GB; "
                f"launches a step a rank {want}")
            for r, run in enumerate(runs):
                if any(x != want for x in run["launches"]):
                    raise AssertionError(
                        f"[{phase}] {strategy} {what} rank {r} launches "
                        f"{run['launches']}, expected {want} a step")
                chain = (ranks[r][(strategy, BF16_CHAIN)]["metrics"]
                         if what == "bf16" and BF16_CHAIN in precisions
                         else None)
                _mesh_gate(phase, strategy, what, run["metrics"], solo,
                           bf16_rtol, chain)
            for (r, k), x in rel.items():
                if not x <= MESH_PARAM_REL_L2:
                    raise AssertionError(
                        f"[{phase}] {strategy} f32 rank {r} parameter {k}: "
                        f"|diff| from the solo step {x:.3e} of the solo "
                        f"update (bound {MESH_PARAM_REL_L2})")
    log(f"[{phase}] {len(strategies)} strategies x {'/'.join(precisions)} in "
        f"{wall:.1f} s with the spawn and the draws")
    return {"ranks": ranks, "solo": solo, "batch": batch}


def phase_train_a_fsdp() -> dict:
    """[train-a-fsdp]: ``cli/train_a``'s sharded A step at the 8B widths (2
    of 32 layers, f32 params, remat, one row of 2424 a data-parallel rank,
    2 steps): ``full``, ``zero2`` and ``ddp`` on 2 ranks (mesh (1, 2, 1))
    in f32, against the solo step, in one spawn.  ``full`` once ran on 4
    ranks in f32 and bf16; it is cut to 2 ranks and f32 to keep the script
    inside its time limit with the tensor-parallel phases (a step of
    ``full`` is as long on 2 ranks as on 4: each gathers the whole
    parameters; one step instead of two fails the leaf gate, the norms'
    updates being too small beside an f32 ulp of their 1.0 weights).
    Returns rank 0's ``full`` run."""
    out = _mesh_phase("train-a-fsdp", "fsdp", ("full", "zero2", "ddp"), 2,
                      precisions=("f32",))
    return out["ranks"][0][("full", "f32")]


def phase_train_a_ring() -> dict:
    """[train-a-ring]: ``train_a --tp_ring`` at g=2 (mesh (1, 1, 2)) on the
    same model, one row of 2424 (each rank's K2 at Lq=606 a sigma-chunk
    half, 16 heads), f32, bf16-chain, bf16 and the bf16 control, against
    the solo step; ``wte`` and ``head`` vocab-parallel
    (``param_shardings``), so a rank holds half of each; bf16 (K2's
    backward kernel) against the ring's own bf16-chain run, which the
    control must fail (see ``BF16_CHAIN``).  Returns rank 0's bf16 run."""
    out = _mesh_phase("train-a-ring", "ring", ("full",), 2,
                      precisions=("f32", BF16_CHAIN, "bf16", BF16_CONTROL))
    return out["ranks"][0][("full", "bf16")]


def phase_fsdp_nccl() -> None:
    """[train-a-fsdp]'s ``full`` case over NCCL, one card a rank, where the
    machine has two or more cards."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        log(f"[fsdp-nccl] not run: {n} card visible; NCCL needs one card a "
            f"rank (two ranks on one device are refused), so FSDP over "
            f"NCCL across cards is not verified by this run")
        return
    _mesh_phase("fsdp-nccl", "fsdp", ("full",), 4 if n >= 4 else 2, "nccl")


def _train_m_mesh_rank(rank, world, workdir):
    """[train-m-fsdp] and [train-m-tp] on one rank: for each mesh shape of
    ``inputs["shapes"]`` (``mesh.fsdp=2``, ``mesh.tensor=2``), the small M
    models from their seeds, ``train_m.build_train_step(..., mesh)`` and
    ``train_loop`` over the same samples and noising seed as the solo
    run."""
    import tempfile
    import torch
    from mmada_parallel_torch.cli import train_m as TM
    from mmada_parallel_torch.parallel import MeshConfig, make_mesh
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    for shape in inp["shapes"]:
        mesh = make_mesh(MeshConfig(*shape), "cuda")
        with tempfile.TemporaryDirectory() as tmp:
            cfg = _m_cli_cfg(tmp, **inp["cfg"])
            models = _small_m_models("auto")
            state, step, sched = TM.build_train_step(
                models.mcfg, models.params, cfg, mesh)
            counted, records = _counted_step(step)
            state, hist = TM.train_loop(
                cfg, state, counted, inp["samples"], models, sched,
                torch.Generator(device="cuda").manual_seed(16))
        out[shape] = {"history": hist, "records": records}
    return out


TRAIN_M_MESHES = (("train-m-fsdp", (1, 2, 1), "mesh.fsdp=2"),
                  ("train-m-tp", (1, 1, 2), "mesh.tensor=2"))


def phase_train_m_mesh() -> None:
    """[train-m-fsdp] and [train-m-tp]: ``cli/train_m.train_loop`` on 2
    ranks at ``mesh.fsdp=2`` and at ``mesh.tensor=2`` (one spawn; the small
    model's one kv head does not split over 2, so its attention gathers
    over ``tensor`` and runs whole while the MLP, ``wte`` and ``head``
    split), the small f32 M model (2 layers, head_dim 64, the full M
    vocab), 2 steps of 2 microbatches of a global batch of 2; every rank
    assembles the global batch and keeps its rows (the ranks of one
    ``tensor`` group the same rows).  Each run's losses equal the one-rank
    run's on the same samples (rtol 1e-5, the grad norm 1e-4)."""
    import tempfile
    res, msl = 16, 16
    kw = dict(steps=2, msl=msl, n_vq=(res // 2) ** 2, res=res, accum=2,
              **{"training.lr": 1e-3, "training.warmup_steps": 1,
                 "training.batch_size": 2})
    samples = _m_samples(8, res)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _m_cli_cfg(tmp, **kw)
        models = _small_m_models("auto")
        _, solo, solo_rec, _ = _train_m_run(cfg, models, samples, 16)
        n_layers = models.mcfg.n_layers
        del models
    t0 = time.time()
    ranks = _run_ranks("train-m-mesh", _train_m_mesh_rank, 2, "gloo",
                       inputs={"cfg": kw, "samples": samples,
                               "shapes": [m[1] for m in TRAIN_M_MESHES]},
                       timeout=300)
    wall = time.time() - t0
    want = {n: 0 for n in KERNELS}
    want["flash_attention_rope"] = n_layers * 2 * 2   # 2 mb, remat
    for phase, shape, setting in TRAIN_M_MESHES:
        rows = 2 // (shape[0] * shape[1])       # a rank's rows a microbatch
        for r, res_r in enumerate(ranks):
            out = res_r[shape]
            if [x for x, _ in out["records"]] != [want] * 2:
                raise AssertionError(f"[{phase}] rank {r} launches "
                                     f"{out['records']}, expected {want} a "
                                     f"step")
            for i, (a, b) in enumerate(zip(out["history"], solo)):
                for key in M_KEYS:
                    rtol = MESH_NORM_RTOL if key == "grad_norm" else \
                        MESH_LOSS_RTOL
                    if not abs(a[key] - b[key]) <= rtol * abs(b[key]):
                        raise AssertionError(
                            f"[{phase}] rank {r} step {i + 1} {key} "
                            f"{a[key]} against the one-rank run's {b[key]} "
                            f"(rtol {rtol})")
        h0 = ranks[0][shape]["history"]
        log(f"[{phase}] {MESH_LABEL}. train_loop at {setting}, 2 ranks, "
            f"small f32 M model ({n_layers} layers), global batch 2 x 2 "
            f"microbatches ({rows} row{'s' if rows > 1 else ''} a rank): "
            f"losses {[round(h['loss'], 6) for h in h0]} (one rank "
            f"{[round(h['loss'], 6) for h in solo]}), grad norms "
            f"{[round(h['grad_norm'], 6) for h in h0]} (one rank "
            f"{[round(h['grad_norm'], 6) for h in solo]}); K1 "
            f"{want['flash_attention_rope']} a step a rank; s/step "
            f"{[round(s, 3) for _, s in ranks[0][shape]['records']]} (one "
            f"rank {[round(s, 3) for _, s in solo_rec]})")
    log(f"[train-m-fsdp] [train-m-tp] {wall:.1f} s with the spawn")


# ---------------------------------------------------------------------------
# Megatron tensor parallelism over the mesh's tensor axis: ranks on the card
# ---------------------------------------------------------------------------

TP_G = 2                  # the tensor ranks of [tp-forward], [int8-tp]
# [int8-tp]: the row-parallel leaves all-reduce their amax (max) and their
# int32 accumulators (sum), both exact, so the split forward is the
# unsharded one; a rank quantizing against its own amax moves each GEMM by
# int8 noise (~1/127), which the ring's bf16 gate (0.015) would not see.
INT8_TP_REL_L2 = 1e-6
TP_H = EDIT_H // TP_G     # a rank's heads at 8B
TP_LABEL = ("2 ranks sharing one card over host-staged gloo: not a "
            "multi-GPU time")


def phase_kernel_tp() -> tuple:
    """K1 and K2 at a ``tensor`` rank's heads at 8B and g=2 (16 of 32):
    K1 at the exact edit's and the train step's B=1 L=2424 (bound 4 B H L^2
    D / 989 TFLOP/s = 0.0487 ms), K2 at the cached edit's partial step
    (Lq=16 of Lk=2424).  Returns their records."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(6)
    k1 = _kernel_case("tp/H16", 1, EDIT_L, EDIT_L, TP_H, TP_H, EDIT_D,
                      torch.bfloat16, BF16_TOL, gen, timed=True)
    k2 = _qonly_case("tp/H16", 1, 16, EDIT_L, TP_H, TP_H, EDIT_D,
                     torch.bfloat16, BF16_TOL, gen, timed=True)
    log(f"[kernel] at a tensor rank's heads, g={TP_G} (H={TP_H}): K1 B=1 "
        f"L={EDIT_L} {k1['ms']:.3f} ms, bound {k1['bound_ms']:.4f} ms "
        f"({k1['bound_by']}), {100 * k1['bound_ms'] / k1['ms']:.1f} % of "
        f"bound; K2 B=1 Lq=16 Lk={EDIT_L} (split {k2['splits']}) "
        f"{k2['ms']:.3f} ms, bound {k2['bound_ms']:.4f} ms, "
        f"{100 * k2['bound_ms'] / k2['ms']:.1f} % of bound")
    return dict(k1, library_ms=None), dict(k2, library_ms=None)


def _tp_forward_rank(rank, world, workdir):
    """[tp-forward] and [int8-tp] on one rank of the ``(1, 1, g)`` mesh:
    the 8B tree drawn from seed 0 in turn (rank 0 also runs the solo
    forward), this rank's ``param_shardings`` slices kept; one forward
    over the mesh (its all-reduce bytes and seconds counted), the exact
    edit and the cached edit through the samplers; then the same tree
    quantized, placed by ``quantize_param_shardings``, one forward."""
    import torch
    import torch.distributed as dist
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params,
                                                   llada_head, llada_hidden,
                                                   param_shardings)
    from mmada_parallel_torch.ops import sampling as S
    from mmada_parallel_torch.ops.quant import (quantize_llada_params,
                                                quantize_param_shardings)
    from mmada_parallel_torch.parallel import (MeshConfig, make_mesh,
                                               shard_params)
    from mmada_parallel_torch.parallel.tensor import MeshGather
    from mmada_parallel_torch.samplers.parallel_ti2ti import (
        TI2TIOptions, cached_refresh_schedule, generate_ti2ti,
        generate_ti2ti_cached)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = LLaDAConfig.llada_8b(param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    T = tk.TOKENS_A
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, tensor=world), "cuda")
    prompts, row, prefix = _ring_requests()
    ids = torch.as_tensor(row, device=dev)[None]
    _, layout = tk.assemble_ti2ti_sequence(prompts[0], 256, 32, 32,
                                           [T.answer_end], tokens=T)
    image = (T.text_vocab_size, T.codebook_size)
    out = {}

    def draw(name, quantized):
        t0 = time.time()
        for turn in range(world):      # one full tree on the card at a time
            if rank == turn:
                torch.cuda.reset_peak_memory_stats()
                full = init_llada_params(
                    cfg, torch.Generator(device=dev).manual_seed(0))
                specs = param_shardings(cfg)
                if quantized:
                    full = quantize_llada_params(full)
                    specs = quantize_param_shardings(specs)
                if rank == 0:
                    with torch.inference_mode():
                        reset_launches()
                        h = llada_hidden(full, cfg, ids)
                        out[f"{name}_solo"] = (
                            h.cpu(), llada_head(full, cfg, h[:, :64],
                                                vocab_slice=image).cpu(),
                            read_launches())
                mine = shard_params(full, specs, mesh)
                del full
                torch.cuda.synchronize()
                out[f"{name}_draw_peak"] = torch.cuda.max_memory_allocated()
                torch.cuda.empty_cache()
            dist.barrier()
        out[f"{name}_draw_s"] = time.time() - t0
        out[f"{name}_held"] = sum(
            t.numel() * t.element_size() for t in _leaves(dict(mine))
            .values())
        return mine

    def forward(name, params):
        tally = {}
        with torch.inference_mode():
            llada_hidden(params, cfg, ids)                  # warm
            tally.clear()
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            h = llada_hidden(params, cfg, ids,
                             gather=MeshGather(mesh, params.specs, cfg,
                                               tally))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            logits = llada_head(params, cfg, h[:, :64], vocab_slice=image)
        out[f"{name}_fwd"] = {"s": dt, "launches": read_launches(),
                              "reduced": tally.get("reduced", 0),
                              "reduced_s": tally.get("reduced_seconds", 0.0)}
        if rank == 0:
            out[f"{name}_tp"] = (h.cpu(), logits.cpu())

    params = draw("bf16", False)
    torch.cuda.reset_peak_memory_stats()
    forward("bf16", params)
    runs = {"exact": (TI2TIOptions(text_steps=4, timesteps=2,
                                   temperature=0.0, text_temperature=0.0,
                                   cfg_img=4.0), generate_ti2ti),
            "cached": (TI2TIOptions(text_steps=8, timesteps=2,
                                    temperature=0.0, text_temperature=0.0,
                                    cfg_img=4.0), generate_ti2ti_cached)}
    for name, (opts, sampler) in runs.items():
        n_img = int(S.image_step_mask(opts.text_steps, opts.timesteps).sum())
        n_partial = int((~cached_refresh_schedule(
            opts.text_steps, opts.timesteps)).sum())
        with torch.inference_mode():
            torch.cuda.synchronize()
            reset_launches()
            t1 = time.perf_counter()
            fin, codes = sampler(params, cfg, ids, layout, opts,
                                 uncond_image_prefix=prefix)
            torch.cuda.synchronize()
        out[f"edit_{name}"] = {"s": time.perf_counter() - t1,
                               "launches": read_launches(),
                               "fin": fin.cpu(), "codes": codes.cpu(),
                               "n_img": n_img, "n_partial": n_partial,
                               "text_steps": opts.text_steps}
    out["bf16_peak"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    dist.barrier()
    params = draw("int8", True)
    forward("int8", params)
    return out


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_tp_forward() -> dict:
    """[tp-forward] and [int8-tp]: ``llada_8b()``, all 32 layers, bf16 from
    seed 0, Megatron tensor parallelism at g=2 on 2 ranks sharing the
    card: one forward's hidden state against the solo K1 forward (relative
    L2 within the ring's bf16 gate, 0.015: the row-parallel all-reduce sums
    in bf16), the exact edit (4 text + 2 image steps, ``cfg_img`` 4.0) and
    the cached edit (8 + 2) through the samplers over the mesh (codes in
    range, every rank rank 0's ids, exact K1/K2 counts at 16 heads); then
    the tree quantized and placed by ``quantize_param_shardings`` against
    the unsharded int8 forward (``INT8_TP_REL_L2``).  Returns rank 0's launches of the exact
    edit (K1) and of the cached edit (K2)."""
    import torch
    from mmada_parallel_torch.models.llada import LLaDAConfig
    n_layers = LLaDAConfig.llada_8b().n_layers
    t0 = time.time()
    ranks = _run_ranks("tp-forward", _tp_forward_rank, TP_G, "gloo",
                       timeout=600)
    wall = time.time() - t0
    r0 = ranks[0]
    for name in ("bf16", "int8"):
        h_solo, l_solo, solo_launches = r0[f"{name}_solo"]
        h_tp, l_tp = r0[f"{name}_tp"]
        rel, mx = _rel_l2(h_tp, h_solo), float(
            (h_tp.float() - h_solo.float()).abs().max())
        rel_l = _rel_l2(l_tp, l_solo)
        phase = "tp-forward" if name == "bf16" else "int8-tp"
        if solo_launches["flash_attention_rope"] != n_layers:
            raise AssertionError(f"[{phase}] solo launches {solo_launches}")
        if name == "bf16":
            bounds = f"{RING_BF16_REL_L2}, {RING_BF16_MAX}"
            ok = (rel <= RING_BF16_REL_L2 and mx <= RING_BF16_MAX
                  and rel_l <= RING_BF16_REL_L2)
        else:
            bounds = f"{INT8_TP_REL_L2}"
            ok = rel <= INT8_TP_REL_L2 and rel_l <= INT8_TP_REL_L2
        if not ok:
            raise AssertionError(
                f"[{phase}] hidden over the mesh vs the solo forward: "
                f"relative L2 {rel:.4e}, max {mx:.4e}, image logits "
                f"relative L2 {rel_l:.4e} (bounds {bounds})")
        for r, res in enumerate(ranks):
            got = res[f"{name}_fwd"]["launches"]
            if got != {**{k: 0 for k in got},
                       "flash_attention_rope": n_layers}:
                raise AssertionError(f"[{phase}] rank {r} forward launches "
                                     f"{got}")
        f = r0[f"{name}_fwd"]
        log(f"[{phase}] {TP_LABEL}. llada_8b, {n_layers} layers, "
            f"{'bf16' if name == 'bf16' else 'W8A8 (quantize_param_shardings)'}"
            f", g={TP_G}: hidden B=1 L={EDIT_L} vs the solo "
            f"{'K1' if name == 'bf16' else 'int8'} forward: relative L2 "
            f"{rel:.4e}, max |diff| {mx:.4e}, image-slice logits relative "
            f"L2 {rel_l:.4e} (bounds {bounds}); "
            f"each rank holds {r0[f'{name}_held'] / 1e9:.3f} GB of weights; "
            f"forward {f['s']:.3f} s, all-reduces {f['reduced'] / 1e9:.3f} "
            f"GB a rank in {f['reduced_s']:.3f} s "
            f"({100 * f['reduced_s'] / f['s']:.1f} % of the forward); K1 "
            f"{n_layers} a rank at {TP_H} heads; draw peaks by rank "
            f"{[round(x[f'{name}_draw_peak'] / 2 ** 30, 2) for x in ranks]} "
            f"GiB, the draws {r0[f'{name}_draw_s']:.1f} s")
    launches = {}
    for name in ("exact", "cached"):
        e = r0[f"edit_{name}"]
        forwards = e["text_steps"] + e["n_img"]
        want = {"flash_attention_rope": n_layers * forwards,
                "flash_attention_rope_qonly": 0}
        if name == "cached":
            want = {"flash_attention_rope": n_layers * e["n_img"],
                    "flash_attention_rope_qonly": n_layers * e["text_steps"]}
            if e["n_partial"] < 1:
                raise AssertionError("[tp-forward] the cached schedule has "
                                     "no partial step")
        for r, res in enumerate(ranks):
            mine = res[f"edit_{name}"]
            got = mine["launches"]
            if got != {**{k: 0 for k in got}, **want}:
                raise AssertionError(f"[tp-forward] rank {r} {name} edit "
                                     f"launches {got}, expected {want}")
            if not (torch.equal(mine["fin"], e["fin"])
                    and torch.equal(mine["codes"], e["codes"])):
                raise AssertionError(f"[tp-forward] rank {r}'s {name} ids "
                                     f"differ from rank 0's")
        c = e["codes"]
        if c.shape != (1, 1024) or c.min() < 0 or c.max() >= 8192:
            raise AssertionError(f"[tp-forward] {name} edit: codes out of "
                                 f"range or shape {tuple(c.shape)}")
        launches[name] = want
        log(f"[tp-forward] {name} edit over the mesh, {e['text_steps']} "
            f"text + {e['n_img']} image steps"
            + (f" ({e['n_partial']} partial)" if name == "cached" else "")
            + f", cfg_img 4.0: {e['s']:.2f} s, every rank's ids == rank "
            f"0's, codes in range; launches a rank {want}")
    log(f"[tp-forward] peaks by rank while serving "
        f"{[round(x['bf16_peak'] / 2 ** 30, 2) for x in ranks]} GiB; the "
        f"phase {wall:.1f} s with the spawn")
    return {"flash_attention_rope":
            launches["exact"]["flash_attention_rope"],
            "flash_attention_rope_qonly":
            launches["cached"]["flash_attention_rope_qonly"]}


def phase_train_a_tp() -> dict:
    """[train-a-tp]: ``train_a --mesh_tensor 2`` with no ring (Megatron's
    split, ``parallel/tensor.py``) at the 8B widths, 2 of 32 layers, f32
    params, remat, one row of 2424, 2 steps in f32 on the mesh (1, 1, 2);
    then (1, 2, 2) on 4 ranks in f32 and bf16, one row a data-parallel
    rank, 2 steps each.  The f32 gates of ``[train-a-fsdp]`` against the
    solo step, each leaf's included; bf16 within ``TP_BF16_RTOL`` of the
    solo bf16 step.  Each
    line prints the bytes a rank all-reduces over ``tensor`` a step and
    their share of the step.  Returns rank 0's f32 run on (1, 1, 2)."""
    out = _mesh_phase("train-a-tp", "tensor", ("full",), 2,
                      precisions=("f32",), shape=(1, 1, 2))
    run = out["ranks"][0][("full", "f32")]
    del out
    _mesh_phase("train-a-tp", "tensor", ("full",), 4, shape=(1, 2, 2),
                bf16_rtol=TP_BF16_RTOL)
    return run


def _tp_small_model():
    """A small f32 A model whose heads split over 2 (2 heads of 64, 2 kv),
    from seed 23."""
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    cfg = LLaDAConfig.tiny(d_model=128, n_heads=2, n_kv_heads=2,
                           vocab_size=tk.TOKENS_A.full_vocab_size)
    return cfg, init_llada_params(
        cfg, torch.Generator(device="cuda").manual_seed(23))


def _eval_mesh_sweep(mesh=None, temperature=0.0):
    """``run_parabench_sweep`` of 3 prompts (buckets 64 and 128,
    ``batch_size`` 2) on the small model at ``temperature`` (text and
    image), over ``mesh`` with its slices or whole; returns ``({text/codes
    by request}, K1 launches)``."""
    import numpy as np
    from mmada_parallel_torch import evaluation as EV
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import param_shardings
    from mmada_parallel_torch.parallel import shard_params
    from mmada_parallel_torch.samplers import parallel_ti2ti as PT
    cfg, params = _tp_small_model()
    if mesh is not None:
        params = shard_params(params, param_shardings(cfg), mesh)
    ids = StandInTokenizer()(T2I_PROMPT)["input_ids"]
    prompts = [ids, ids[:30], ids + ids[1:40]]
    opts = PT.TI2TIOptions(text_steps=8, timesteps=4,
                           temperature=temperature,
                           text_temperature=temperature, cfg_img=2.0)
    reset_launches()
    out = EV.run_parabench_sweep(
        params, cfg, [EV.EvalRequest(p) for p in prompts], (4, 4), 16,
        [tk.TOKENS_A.answer_end], opts, batch_size=2,
        uncond_image_prefix=np.asarray(ids[:10], np.int64), seed=5,
        mesh=mesh)
    return ({f"{k}{r['index']}": np.asarray(r[k]) for r in out["results"]
             for k in ("text", "codes")},
            read_launches()["flash_attention_rope"])


def _check_eval_mesh(ranks, want, launches, how: str) -> None:
    """[eval-edit-mesh]: ``run_parabench_sweep(mesh=)`` on 2 ranks with
    the small f32 model (``how``: the ``(1, 1, 2)`` mesh, its 2 heads split
    over ``tensor``, at temperature 0; the ``(2, 1, 1)`` mesh, a row a rank
    of each chunk, at temperature 1): every rank's texts and codes equal
    the one-rank sweep's, with its K1 count."""
    import numpy as np
    for r, (got, n) in enumerate(ranks):
        if n != launches or set(got) != set(want) or not all(
                np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"[eval-edit-mesh] {how}, rank {r}: K1 {n} "
                                 f"(one rank {launches}) or results differ")
    log(f"[eval-edit-mesh] {TP_LABEL}. run_parabench_sweep(mesh=) {how}, "
        f"3 requests in 2 buckets, small f32 model: every rank's texts and "
        f"codes == the one-rank sweep's; K1 {launches} a rank")


def _pararl_mesh_update(mesh=None) -> dict:
    """One rollout of 2 and one update of ``cli/train_pararl``'s builders
    on the small model (placed by ``param_shardings`` over ``mesh``, JAX's
    ``MeshConfig()``), the update with rewards 0 and 1; metrics, K1 counts
    and the parameters before and after."""
    import torch
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.cli import train_pararl as RL
    from mmada_parallel_torch.models.llada import param_shardings
    from mmada_parallel_torch.parallel import shard_params
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    from mmada_parallel_torch.training.pararl import RewardSpec
    cfg, params = _tp_small_model()
    init = {k: v.detach().cpu().clone() for k, v in _leaves(params).items()}
    if mesh is not None:
        params = shard_params(params, param_shardings(cfg), mesh)
    A = tk.TOKENS_A
    ids = StandInTokenizer()("make the sky purple")["input_ids"]
    seqs, layout = RL.rollout_sequences([ids, ids[:30]], A, 4, 16)
    opts = TI2TIOptions(text_steps=8, timesteps=4, temperature=1.0,
                        text_temperature=0.7, cfg_scale=0.0, cfg_img=0.0)
    sub = RL.subsample_steps(opts.text_steps, 4)
    state, step = RL.build_update(cfg, params, opts, 1e-3, sub)
    gen = torch.Generator(device="cuda").manual_seed(12)
    reset_launches()
    batch = RL.rollout_and_score(state.params, cfg,
                                 torch.as_tensor(seqs, device="cuda"),
                                 layout, opts, RewardSpec(
                                     fns=[RL.default_reward],
                                     weights=[1.0]), gen)
    rollout = read_launches()["flash_attention_rope"]
    reset_launches()
    # fixed rewards (advantages +-0.5): the update is never zero
    state, m = step(state, (batch[0], torch.tensor([0.0, 1.0],
                                                   device="cuda")), gen)
    return {"metrics": {k: float(v) for k, v in m.items()}, "init": init,
            "launches": (rollout, read_launches()["flash_attention_rope"],
                         cfg.n_layers * opts.text_steps,
                         cfg.n_layers * len(sub)),
            "params": {k: v.detach().cpu()
                       for k, v in _leaves(dict(state.params)).items()}}


def _small_mesh_rank(rank, world, workdir):
    """[eval-edit-mesh] and [pararl-mesh] on one rank."""
    from mmada_parallel_torch.parallel import MeshConfig, make_mesh
    return (_eval_mesh_sweep(make_mesh(MeshConfig(1, 1, world), "cuda")),
            _pararl_mesh_update(make_mesh(MeshConfig(), "cuda")),
            _eval_mesh_sweep(make_mesh(MeshConfig(world, 1, 1), "cuda"),
                             temperature=1.0))


def phase_small_mesh() -> None:
    """[eval-edit-mesh] and [pararl-mesh] in one spawn of 2 ranks, each
    against its one-rank run (:func:`_check_eval_mesh`,
    :func:`_check_pararl_mesh`)."""
    want_eval, launches = _eval_mesh_sweep()
    want_rl = _pararl_mesh_update()
    want_hot, launches_hot = _eval_mesh_sweep(temperature=1.0)
    t0 = time.time()
    ranks = _run_ranks("small-mesh", _small_mesh_rank, 2, "gloo",
                       timeout=300)
    _check_eval_mesh([r[0] for r in ranks], want_eval, launches,
                     "at tensor=2, temperature 0")
    _check_pararl_mesh([r[1] for r in ranks], want_rl)
    _check_eval_mesh([r[2] for r in ranks], want_hot, launches_hot,
                     "at data=2, temperature 1")
    log(f"[eval-edit-mesh] [pararl-mesh] {time.time() - t0:.1f} s with the "
        f"spawn")


def _check_pararl_mesh(ranks, want) -> None:
    """[pararl-mesh]: ``cli/train_pararl``'s rollout and update under JAX's
    ``MeshConfig()`` (``data`` = 2 ranks, the parameters placed by
    ``param_shardings``: whole on that mesh) equal the one-rank update:
    loss rtol 1e-5, grad norm 1e-4, each leaf within 1e-3 of the update in
    relative L2; exact K1 counts."""
    worst = 0.0
    for r, got in enumerate(ranks):
        ro, up, want_ro, want_up = got["launches"]
        if (ro, up) != (want_ro, want_up):
            raise AssertionError(f"[pararl-mesh] rank {r} launches "
                                 f"{got['launches']}")
        for key, rtol in (("loss", MESH_LOSS_RTOL),
                          ("grad_norm", MESH_NORM_RTOL)):
            a, b = got["metrics"][key], want["metrics"][key]
            if not abs(a - b) <= rtol * abs(b):
                raise AssertionError(f"[pararl-mesh] rank {r} {key} {a} "
                                     f"against one rank's {b}")
        for k, v in want["params"].items():
            moved = float((v - want["init"][k]).norm())
            rel = float((got["params"][k] - v).norm()) / max(moved, 1e-30)
            worst = max(worst, rel)
            if not rel <= MESH_PARAM_REL_L2:
                raise AssertionError(f"[pararl-mesh] rank {r} {k}: relative "
                                     f"L2 {rel:.3e} of the update")
    log(f"[pararl-mesh] {TP_LABEL}. train_pararl's rollout + update under "
        f"MeshConfig() (data=2): loss {ranks[0]['metrics']['loss']:.6f} "
        f"(one rank {want['metrics']['loss']:.6f}), grad norm "
        f"{ranks[0]['metrics']['grad_norm']:.6f} (one rank "
        f"{want['metrics']['grad_norm']:.6f}), largest relative L2 of a "
        f"leaf's difference to its update {worst:.3e} (bound "
        f"{MESH_PARAM_REL_L2}); K1 {want['launches'][2]} a rollout, "
        f"{want['launches'][3]} an update")


def moe_prefill_entry(moe_records: dict, sdar_run: dict) -> dict:
    """The grouped GEMM's record at the prefill shape, for the kernels line
    (the decode shape's is the KERNELS entry, with the decode forwards'
    launches in ``[sdar]``): the prefill's launches there, from the device
    trace."""
    src, replaces = KERNELS["moe_grouped_gemm"]
    rec = moe_records["prefill"]
    return {"name": "moe_grouped_gemm/prefill", "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": sdar_run["prefill_launches"],
            "case": f"T={rec['tokens']}",
            **{f: rec[f] for f in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}}


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
    ring_record, ring_train_record = phase_kernel_ring()
    tp_record, tp_cached_record = phase_kernel_tp()
    prefix_launches = phase_prefix_crossover()
    records.update(phase_kernel_bwd())
    phase_kernel_grads()
    gn_records = phase_kernel_group_norm()
    rms_records = phase_kernel_rms_norm()
    moe_records = phase_kernel_moe()
    records["moe_grouped_gemm"] = moe_records["decode"]
    mark("phase 2 (kernels)")
    phase_small_slice()
    phase_small_new_paths()
    phase_small_train()
    phase_small_train_m()
    phase_shards()
    mark("phase 3 (small models) up to the train steps")
    phase_small_eval()
    phase_ring_small()
    phase_ring_nccl()
    phase_small_mesh()
    mark("phase 3 (small models)")
    sdar_run = phase_sdar()
    mark("phase 4 (SDAR)")
    full = make_full_width(torch.Generator(device="cuda").manual_seed(0))
    launches = {"flash_attention_rope": phase_edit(full),
                "flash_attention": phase_edit_lowprec_rope(full),
                "flash_attention_rope_qonly": phase_cached_edit(full),
                "flash_attention_rope_prefix": prefix_launches,
                "moe_grouped_gemm": sdar_run["launches"]}
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
    del full                      # the ranks and the training need it
    gc.collect()
    torch.cuda.empty_cache()
    ring_launches = phase_serve_a_ring()
    mark("phase 4 (the ring at full width)")
    tp_launches = phase_tp_forward()
    mark("phase 4 (tensor parallelism at full width)")
    a_run = phase_train_a()
    launches.update(a_run["launches"])
    phase_train_m(a_run)
    del a_run
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5 (training) up to the M step")
    phase_train_m_cli()
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5 (training) up to the mesh")
    fsdp_run = phase_train_a_fsdp()
    ring_train_run = phase_train_a_ring()
    launches["flash_attention_rope_qonly_bwd"] = sum(
        x["flash_attention_rope_qonly_bwd"] for x in ring_train_run["launches"])
    phase_train_m_mesh()
    phase_fsdp_nccl()
    mark("phase 5 (training) up to tensor parallelism")
    tp_train_run = phase_train_a_tp()
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 5 (training) up to ParaRL")
    phase_pararl()
    mark("phase 5 (training)")
    gc.collect()
    torch.cuda.empty_cache()
    phase_demo_m()
    trained_a = phase_demo_a()
    phase_demo_a_ring(trained_a)
    phase_demo_multitask()
    phase_demo_parabench(trained_a)
    del trained_a
    phase_demo_pararl()
    mark("phase 6 (demos)")
    phase_export()
    mark("phase 7 (export)")
    log(f"[time] the whole script: {time.time() - t0:.1f} s (limit 1200 s)")
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                **{f: records[name][f] for f in fields}}
               for name, (src, replaces) in KERNELS.items()]
    src, replaces = KERNELS["flash_attention_rope_qonly"]
    kernels.append({"name": "flash_attention_rope_qonly/ring",
                    "route": "cuda", "source": src, "replaces": replaces,
                    "launches": ring_launches,
                    **{f: ring_record[f] for f in fields}})
    for name, path, run, record in (
            ("flash_attention_rope", "train-a-fsdp", fsdp_run,
             records["flash_attention_rope"]),
            ("flash_attention_rope_qonly", "train-a-ring", ring_train_run,
             ring_train_record),
            ("flash_attention_rope", "train-a-tp", tp_train_run, tp_record)):
        src, replaces = KERNELS[name]
        kernels.append({"name": f"{name}/{path}", "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": sum(x[name] for x in run["launches"]),
                        **{f: record[f] for f in fields}})
    for name, path, record in (
            ("flash_attention_rope", "tp-forward", tp_record),
            ("flash_attention_rope_qonly", "tp-cached", tp_cached_record)):
        src, replaces = KERNELS[name]
        kernels.append({"name": f"{name}/{path}", "route": "cuda",
                        "source": src, "replaces": replaces,
                        "launches": tp_launches[name],
                        **{f: record[f] for f in fields}})
    # the fused norm: its launches in a main-path phase, with the timed
    # case at that phase's largest norm, in the layout that phase gave it
    for name, phase in (("group_norm_swish", "train-m-cli assembly"),
                        ("group_norm_swish/edit", "edit")):
        n, routes = NORM_RUNS[phase]
        route, shape = max(routes, key=lambda k: (math.prod(k[1]),
                                                  routes[k]))
        case = next((c for c, sh, cl in GN_CASES
                     if sh == shape and cl == (route == "cl")), None)
        kernels.append({"name": name, "route": "cuda",
                        "source": CSRC + "group_norm.cu",
                        "replaces": "none (XLA fuses the JAX package's "
                                    "vqgan_common.group_norm and swish)",
                        "launches": n, "case": case or f"{route} {shape}",
                        **{f: gn_records[case][f] if case else None
                           for f in fields}})
    kernels.append(moe_prefill_entry(moe_records, sdar_run))
    kernels.append({"name": "rms_norm", "route": "cuda",
                    "source": CSRC + "rms_norm.cu",
                    "replaces": "none (XLA fuses the JAX package's "
                                "llada._rms_norm)",
                    "launches": RMS_RUNS["edit"], "case": "edit B=1",
                    **{f: rms_records["edit B=1"][f] for f in fields
                       if f != "max_abs_err"}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
