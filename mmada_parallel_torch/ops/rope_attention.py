"""Fused-RoPE packed attention: the CUDA kernel wrappers and their plain
versions.

Counterpart of :mod:`mmada_parallel_tpu.ops.rope_attention`.  Its three TPU
kernels are ported as hand-written CUDA kernels:

* ``flash_attention_rope`` (K1, q and k rotated in f32) as
  ``csrc/flash_attention_rope.cu``; :func:`flash_attention_rope` is its
  wrapper and :func:`flash_attention_rope_reference` its plain PyTorch
  version (reshape -> fp32 RoPE -> eager softmax attention -> reshape).  In
  bf16 it rotates q and k once per call into scratch tensors
  (:func:`rope_rotate` runs that pre-pass alone) and runs the
  warp-specialised tensor-core body ``csrc/attention_ws.cuh``; in f32 it
  rotates on load in the FMA template ``csrc/attention_kernel.cuh``;
* ``flash_attention_rope_qonly`` (K2, q rotated, k a pre-rotated cache) as
  ``csrc/flash_attention_rope_qonly.cu``; :func:`flash_attention_rope_qonly`
  and :func:`flash_attention_rope_qonly_reference`.  In bf16 it rotates q
  once into scratch and runs the warp-specialised body; where the grid
  would leave SMs idle (a cached partial step), :func:`plan_splits` says
  into how many contiguous ranges the kernel cuts each head's key tiles
  (split-K), weighing the idle SMs against the bytes of the partial
  softmax states, which a second kernel combines;
* ``flash_attention_rope_prefix`` (K4, K1 with a per-row prefix mask
  ``kv < kv_hi[b, q]`` in place of a bias, skipping key tiles past a q
  tile's highest bound) as ``csrc/flash_attention_rope_prefix.cu``;
  :func:`flash_attention_rope_prefix` and
  :func:`flash_attention_rope_prefix_reference`.  In bf16 it rotates q and
  k once, as K1, and runs the warp-specialised body with the bounds.

In bf16 all four (K3 in ``ops/flash_attention.py``) run the
warp-specialised body ``csrc/attention_ws.cuh``; in f32 the FMA template
``csrc/attention_kernel.cuh``.

The raw launchers return tensors with no autograd history; they raise when
grad is enabled and an input requires grad, so that gradients go through
the ``torch.autograd.Function`` wrappers in :mod:`.attention`.

The plain versions run for CPU tensors and are the oracles the kernels are
held to.  On CUDA the packed ``[B, L, H*D]`` layout is only a stride, so the
kernels read each head's column slice in place: no reshape, no copy.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from mmada_parallel_torch.ops._cuda import KERNEL_DTYPES as _KERNEL_DTYPES
from mmada_parallel_torch.ops._cuda import sm_count as _sm_count

__all__ = ["rope_tensor", "apply_rope", "rope_rotate", "plan_splits",
           "split_cost",
           "flash_attention_rope",
           "flash_attention_rope_reference", "flash_attention_rope_qonly",
           "flash_attention_rope_qonly_reference",
           "flash_attention_rope_prefix",
           "flash_attention_rope_prefix_reference"]

NEG_INF = -1e30
_KERNEL_HEAD_DIMS = (64, 128)
# the bf16 body's tiles (csrc/attention_mma.cuh kRows, kKeys)
Q_TILE, K_TILE = 128, 64


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def rope_tensor(t: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                full_precision: bool) -> torch.Tensor:
    """Neox RoPE on one ``[B, L, H, hd]`` tensor; ``sin``/``cos`` are
    ``[L, hd]`` (shared positions) or ``[B, L, hd]`` (per-row positions).
    The rotation runs in fp32 when ``full_precision``."""
    og = t.dtype
    tf = t.float() if full_precision else t
    if sin.ndim == 2:
        sin, cos = sin[None], cos[None]
    s = sin[:, :, None, :].to(tf.dtype)
    c = cos[:, :, None, :].to(tf.dtype)
    return (tf * c + _rotate_half(tf) * s).to(og)


def apply_rope(q: torch.Tensor, k: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor, full_precision: bool):
    """:func:`rope_tensor` applied to a q/k pair (same positions)."""
    return (rope_tensor(q, sin, cos, full_precision),
            rope_tensor(k, sin, cos, full_precision))


def _split_tables(sin: torch.Tensor, cos: torch.Tensor, Lq: int, Lk: int
                  ) -> Tuple[torch.Tensor, ...]:
    """f32 ``(sin_q, cos_q, sin_k, cos_k)``.  Distinct lengths from one 2-D
    table: q covers the first ``Lq`` positions, k the first ``Lk``."""
    sin_q, cos_q = sin.float(), cos.float()
    if Lq == Lk:
        return sin_q, cos_q, sin_q, cos_q
    if sin.ndim == 2:
        return sin_q[:Lq], cos_q[:Lq], sin_q[:Lk], cos_q[:Lk]
    raise ValueError("ragged sin/cos require Lq == Lk")


def _reference(q, k, v, sin_q, cos_q, sin_k, cos_k, bias, H: int, KV: int):
    from mmada_parallel_torch.ops.attention import _xla_attention
    B, Lq, HD = q.shape
    D = HD // H
    q4 = rope_tensor(q.reshape(B, Lq, H, D), sin_q, cos_q, True)
    k4 = rope_tensor(k.reshape(B, k.shape[1], KV, D), sin_k, cos_k, True)
    v4 = v.reshape(B, v.shape[1], KV, D)
    return _xla_attention(q4, k4, v4, bias).reshape(B, Lq, HD)


def flash_attention_rope_reference(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, sin: torch.Tensor,
                                   cos: torch.Tensor,
                                   bias: Optional[torch.Tensor] = None, *,
                                   n_heads: int,
                                   n_kv_heads: Optional[int] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_rope`, same
    arguments, any device."""
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    tables = _split_tables(sin, cos, q.shape[1], k.shape[1])
    return _reference(q, k, v, *tables, bias, H, KV)


def _check_table(name, t, B, L, D, device):
    if t.dtype != torch.float32 or t.device != device or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 tensor on "
                         f"{device}")
    if tuple(t.shape) not in ((L, D), (B, L, D)):
        raise ValueError(f"{name} must be [{L}, {D}] or [{B}, {L}, {D}], "
                         f"got {tuple(t.shape)}")
    return t.shape[-2] * D if t.ndim == 3 else 0


def check_packed(q, k, v, bias, H: int, KV: int):
    """Validate packed ``q [B, Lq, H*D]``, ``k``/``v [B, Lk, KV*D]`` and an
    optional f32 ``bias [B, 1, Lq, Lk]`` for the CUDA kernels; returns
    ``(B, Lq, Lk, D)``.  Raises on anything the kernels do not take."""
    B, Lq, HD = q.shape
    Lk = k.shape[1]
    if HD % H or H % KV:
        raise ValueError(f"bad head counts: width {HD}, H={H}, KV={KV}")
    D = HD // H
    if D not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {D}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"the CUDA kernel takes bfloat16 or float32, "
                         f"got {q.dtype}")
    for name, t, shape in (("k", k, (B, Lk, KV * D)), ("v", v, (B, Lk, KV * D)),
                           ("q", q, (B, Lq, HD))):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {q.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {list(shape)}, got "
                             f"{list(t.shape)}")
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.device != q.device
                or tuple(bias.shape) != (B, 1, Lq, Lk)
                or not bias.is_contiguous()):
            raise ValueError(f"bias must be contiguous float32 "
                             f"[{B}, 1, {Lq}, {Lk}] on {q.device}")
    return B, Lq, Lk, D


def check_aligned(name: str, align: int, *tensors) -> None:
    """Raise unless every tensor's data starts on an ``align``-byte boundary:
    the bf16 tensor-core body and the rotation pre-pass load 16 bytes at a
    time (8 for the f32 bias rows)."""
    for t in tensors:
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name}: the bf16 CUDA kernel needs "
                             f"{align}-byte aligned inputs (a fresh or "
                             f".clone()d tensor is)")


def check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a raw kernel launch:
    its output has no history, so the gradient would be silently lost."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the raw CUDA launch returns a tensor with no autograd "
            f"history, and an input requires grad; call it through "
            f"mmada_parallel_torch.ops.attention (whose autograd Functions "
            f"give it a backward) or under torch.no_grad()")


def _stats_buffer(name: str, q, H: int, with_stats: bool):
    """The f32 ``[B, H, Lq, 2]`` row statistics a bf16 forward writes for
    the backward (``ops.attention_bwd``), or None."""
    if not with_stats:
        return None
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: with_stats needs bf16 inputs (the f32 "
                         f"template writes no statistics)")
    return torch.empty(q.shape[0], H, q.shape[1], 2, dtype=torch.float32,
                       device=q.device)


def _launch(q, k, v, sin_q, cos_q, sin_k, cos_k, bias, H: int, KV: int,
            with_stats: bool = False):
    from mmada_parallel_torch.ops import _cuda
    check_no_grad("flash_attention_rope", q, k, v, sin_q, cos_q, bias)
    B, Lq, Lk, D = check_packed(q, k, v, bias, H, KV)
    tq = _check_table("sin_q", sin_q, B, Lq, D, q.device)
    _check_table("cos_q", cos_q, B, Lq, D, q.device)
    tk = _check_table("sin_k", sin_k, B, Lk, D, q.device)
    _check_table("cos_k", cos_k, B, Lk, D, q.device)
    if cos_q.shape != sin_q.shape or cos_k.shape != sin_k.shape:
        raise ValueError("sin and cos tables must have one shape")
    q_rot = k_rot = None
    if q.dtype == torch.bfloat16:
        # the tensor-core body: q and k rotated once into bf16 scratch
        check_aligned("flash_attention_rope", 16, q, k, v, sin_q, cos_q,
                      sin_k, cos_k)
        check_aligned("flash_attention_rope", 8, bias)
        q_rot, k_rot = torch.empty_like(q), torch.empty_like(k)
    lse = _stats_buffer("flash_attention_rope", q, H, with_stats)
    out = torch.empty_like(q)
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        err = lib.mmada_flash_attention_rope(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sin_q.data_ptr(),
            cos_q.data_ptr(), sin_k.data_ptr(), cos_k.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            q_rot.data_ptr() if q_rot is not None else None,
            k_rot.data_ptr() if k_rot is not None else None, out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            B, Lq, Lk, H, KV, D, tq, tk, D ** -0.5, _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_rope CUDA launch failed: "
                           f"cudaError_t {err}")
    flash_attention_rope.launches += 1
    return (out, lse) if with_stats else out


def rope_rotate(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor, *,
                n_heads: int) -> torch.Tensor:
    """K1's bf16 rotation pre-pass on its own: packed ``x [B, L, n_heads*D]``
    rotated with the f32 Neox tables ``sin``/``cos`` (``[L, D]`` or
    ``[B, L, D]``) and rounded to ``x``'s dtype.  A CPU tensor runs
    :func:`rope_tensor` (``full_precision=True``), which the kernel equals bit
    for bit; a CUDA tensor must be bf16 with D in {64, 128}.  K1 runs this
    pass inside its own call, so it counts no launch of its own."""
    from mmada_parallel_torch.ops import _cuda
    B, L, HD = x.shape
    D = HD // n_heads
    sin, cos = sin.float(), cos.float()
    if x.device.type == "cpu":
        return rope_tensor(x.reshape(B, L, n_heads, D), sin, cos,
                           True).reshape(B, L, HD)
    if x.dtype != torch.bfloat16 or D not in _KERNEL_HEAD_DIMS \
            or HD != n_heads * D or not x.is_contiguous():
        raise ValueError(f"rope_rotate on CUDA takes contiguous bf16 "
                         f"[B, L, H*D] with D in {_KERNEL_HEAD_DIMS}, got "
                         f"{x.dtype} {list(x.shape)}, n_heads={n_heads}")
    tb = _check_table("sin", sin, B, L, D, x.device)
    _check_table("cos", cos, B, L, D, x.device)
    check_aligned("rope_rotate", 16, x, sin, cos)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _cuda.library().mmada_rope_rotate(
            x.data_ptr(), sin.data_ptr(), cos.data_ptr(), out.data_ptr(), B,
            L, n_heads, D, tb, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rope_rotate CUDA launch failed: cudaError_t "
                           f"{err}")
    return out


# K2's split planner's constants: a 64-key tile of an item in us, its rows
# in one warpgroup (Lq <= 64) or in two; an item's fixed cost in us; the
# combine's launch in us; bytes a us.  Fitted by ``python3 chip_ab.py
# --sweep`` on an NVIDIA H100 80GB HBM3 at 700 W (see plan_splits).
SPLIT_COSTS = {"tile_us": (0.75, 1.05), "item_us": 1.98, "combine_us": 1.87,
               "bytes_per_us": 5.15e6}


def split_cost(S: int, B: int, H: int, Lq: int, Lk: int, sm_count: int,
               D: int = 128, KV: Optional[int] = None,
               costs: Optional[dict] = None) -> float:
    """The modelled device time (us) of K2's bf16 body and combine with its
    key tiles cut into ``S`` ranges, up to a constant: :func:`plan_splits`'s
    model with the constants ``costs`` (:data:`SPLIT_COSTS` when None)."""
    c = SPLIT_COSTS if costs is None else costs
    KV = H if KV is None else KV
    items = B * H * math.ceil(Lq / Q_TILE)
    n_tiles = math.ceil(Lk / K_TILE)
    active = min(items * S, sm_count)
    # a tile's K and V, each kv head's read once from memory (the q heads of
    # a GQA group share theirs through L2)
    tile_bytes = 2 * K_TILE * D * 2 * KV / H
    tile_us = max(c["tile_us"][Lq > Q_TILE // 2],
                  active * tile_bytes / c["bytes_per_us"])
    waves = math.ceil(items * S / sm_count)
    body = waves * (math.ceil(n_tiles / S) * tile_us + c["item_us"])
    if S == 1:
        return body
    return body + c["combine_us"] + (2 * S * B * Lq * H * D * 4
                                     / c["bytes_per_us"])


@functools.lru_cache(maxsize=None)
def plan_splits(B: int, H: int, Lq: int, Lk: int, sm_count: int,
                D: int = 128, KV: Optional[int] = None) -> int:
    """How many key ranges (split-K) K2's bf16 launch cuts each (head, q
    tile, batch row) into, for a card with ``sm_count`` SMs (head dim
    ``D``, ``KV`` key/value heads, H when None).

    The body walks (head, 128-row q tile, split, batch row) items on one
    block per SM.  With at least ``sm_count`` items unsplit the grid covers
    the card: 1.  Fewer (a cached partial step: B=1, H=32, Lq=16 gives 32)
    leave SMs idle, so the key tiles may be split (split ``s`` of ``S``
    takes tiles ``[s*n//S, (s+1)*n//S)`` of the ``n`` 64-key tiles, so no
    range is empty), at the count of least modelled device time
    (:func:`split_cost`), the smallest on a tie:

    * the body: the waves of items, ``ceil(B*H*ceil(Lq/128)*S / sm_count)``,
      times an item's longest range in tiles plus its fixed cost.  A tile
      takes its compute time (less when warpgroup 1 holds no row, Lq <= 64)
      or, if longer, the time the active items take to read their tiles'
      K and V bytes (``2*64*D*2*KV/H`` a tile) at the memory rate;
    * split, the combine: its launch and its traffic, the f32 partials
      written by the body and read back, ``2*S*B*Lq*H*D*4`` bytes.

    The constants (:data:`SPLIT_COSTS`) are a least-squares fit of the
    model's relative error to K2's device time by forced split count at 10
    shapes, 86 counts (``python3 chip_ab.py --sweep`` on an NVIDIA H100
    80GB HBM3 at 700 W: relative error 0.059 rms; a second run refit them
    within 6 % and its fit picked the same counts).  The sweep reads the
    same K/V on every call, so they sit in the 50 MB L2 and the fitted rate
    (5.15 TB/s) is above the device memory's 3.35.  In both runs the model
    picks the fastest count at the cached edit's partial step (Lq=16: 4),
    the cached A text-to-image's (Lq=103, Lk=1109: 4), the ring's serving
    chunk (Lq=303, H=8: 5) and its training chunk (Lq=606, H=16: 3).
    Cached: a sampler asks for the same few shapes at every step."""
    items = B * H * math.ceil(Lq / Q_TILE)
    n_tiles = math.ceil(Lk / K_TILE)
    if items >= sm_count or n_tiles <= 1:
        return 1
    return min(range(1, n_tiles + 1),
               key=lambda S: (split_cost(S, B, H, Lq, Lk, sm_count, D, KV),
                              S))


def _launch_qonly(q, k, v, sin_q, cos_q, bias, H: int, KV: int,
                  with_stats: bool = False):
    from mmada_parallel_torch.ops import _cuda
    check_no_grad("flash_attention_rope_qonly", q, k, v, sin_q, cos_q, bias)
    B, Lq, Lk, D = check_packed(q, k, v, bias, H, KV)
    tq = _check_table("sin_q", sin_q, B, Lq, D, q.device)
    _check_table("cos_q", cos_q, B, Lq, D, q.device)
    if cos_q.shape != sin_q.shape:
        raise ValueError("sin and cos tables must have one shape")
    q_rot = o_part = ml = None
    n_split = 1                  # the f32 FMA template has no split
    if q.dtype == torch.bfloat16:
        # the tensor-core body: q rotated once into bf16 scratch; split-K's
        # partial o [S*B*Lq*H, D] and (m, l) [S*B*Lq*H, 2] in one f32 block
        check_aligned("flash_attention_rope_qonly", 16, q, k, v, sin_q,
                      cos_q)
        check_aligned("flash_attention_rope_qonly", 8, bias)
        n_split = plan_splits(B, H, Lq, Lk, _sm_count(q.device), D, KV)
        q_rot = torch.empty_like(q)
        if n_split > 1:
            rows = n_split * B * Lq * H
            part = torch.empty(rows * (D + 2), dtype=torch.float32,
                               device=q.device)
            o_part = part.data_ptr()
            ml = o_part + rows * D * part.element_size()
    lse = _stats_buffer("flash_attention_rope_qonly", q, H, with_stats)
    out = torch.empty_like(q)
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        err = lib.mmada_flash_attention_rope_qonly(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sin_q.data_ptr(),
            cos_q.data_ptr(), bias.data_ptr() if bias is not None else None,
            q_rot.data_ptr() if q_rot is not None else None, o_part, ml,
            out.data_ptr(), lse.data_ptr() if lse is not None else None,
            B, Lq, Lk, H, KV, D, n_split, tq, D ** -0.5,
            _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_rope_qonly CUDA launch failed: "
                           f"cudaError_t {err}")
    if not torch.cuda.is_current_stream_capturing():
        flash_attention_rope_qonly.launches += 1
    return (out, lse) if with_stats else out


def flash_attention_rope(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sin: torch.Tensor, cos: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         n_heads: int, n_kv_heads: Optional[int] = None,
                         with_stats: bool = False):
    """``[B, Lq, H*D] x [B, Lk, KV*D] -> [B, Lq, H*D]``: pre-RoPE packed
    q/k/v in, attention out.

    ``sin``/``cos`` are the fp32 Neox tables ``[L, D]`` or ``[B, L, D]``;
    ``bias`` an optional additive f32 ``[B, 1, Lq, Lk]``.  A CUDA tensor
    launches the kernel (bf16: rotation pre-pass + tensor-core body; f32:
    the FMA template; D in {64, 128}, any Lq, Lk and GQA ratio) and raises on
    anything the kernel does not take; a CPU tensor runs
    :func:`flash_attention_rope_reference`.  ``flash_attention_rope.launches``
    counts calls that launched the kernel (one per call, whatever the number
    of CUDA kernels the call starts).  ``with_stats=True`` (bf16 on CUDA)
    also returns the rows' softmax statistics for the backward
    (:mod:`.attention_bwd`): ``(out, stats)``."""
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    tables = _split_tables(sin, cos, q.shape[1], k.shape[1])
    if q.device.type == "cpu":
        out = _reference(q, k, v, *tables, bias, H, KV)
        if not with_stats:
            return out
        from mmada_parallel_torch.ops.attention_bwd import (
            packed_stats_reference)
        return out, packed_stats_reference(q, k, *tables, bias, H, KV)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_rope runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, *tables, bias, H, KV, with_stats)


flash_attention_rope.launches = 0


def flash_attention_rope_qonly_reference(q: torch.Tensor, k: torch.Tensor,
                                         v: torch.Tensor,
                                         sin_q: torch.Tensor,
                                         cos_q: torch.Tensor,
                                         bias: Optional[torch.Tensor] = None,
                                         *, n_heads: int,
                                         n_kv_heads: Optional[int] = None
                                         ) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_rope_qonly`, same
    arguments, any device: ``ops.attention._packed_qonly_reference``."""
    from mmada_parallel_torch.ops.attention import _packed_qonly_reference
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    return _packed_qonly_reference(q, k, v, sin_q.float(), cos_q.float(),
                                   bias, H, KV)


def flash_attention_rope_qonly(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, sin_q: torch.Tensor,
                               cos_q: torch.Tensor,
                               bias: Optional[torch.Tensor] = None, *,
                               n_heads: int, n_kv_heads: Optional[int] = None,
                               with_stats: bool = False):
    """Packed attention with PRE-ROTATED k: ``[B, Lq, H*D] x [B, Lk, KV*D]
    -> [B, Lq, H*D]``, the feature-cache hot path.

    ``q`` is pre-RoPE and gets the fp32 rotation at its true positions:
    ``sin_q``/``cos_q`` are f32 ``[Lq, D]`` or per-row ``[B, Lq, D]``.
    ``k``/``v`` are the packed caches (k already rotated), read as stored;
    ``Lq`` and ``Lk`` are independent.  ``bias`` is an optional f32
    ``[B, 1, Lq, Lk]``.  A CUDA tensor launches the kernel (bf16 or f32,
    D in {64, 128}, any GQA ratio) and raises on anything it does not take;
    a CPU tensor runs :func:`flash_attention_rope_qonly_reference`.  A bf16
    launch splits the key tiles as :func:`plan_splits` says for this card.
    ``flash_attention_rope_qonly.launches`` counts calls that launched the
    kernel (one per call: the pre-pass, the body and the combine); a call
    recorded into a CUDA graph launches nothing, and the graph's replays
    go uncounted.
    ``with_stats=True`` (bf16 on CUDA) also returns the rows' softmax
    statistics for the backward (written by the combine when the call
    splits): ``(out, stats)``."""
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    if q.device.type == "cpu":
        out = flash_attention_rope_qonly_reference(
            q, k, v, sin_q, cos_q, bias, n_heads=H, n_kv_heads=KV)
        if not with_stats:
            return out
        from mmada_parallel_torch.ops.attention_bwd import (
            packed_stats_reference)
        return out, packed_stats_reference(q, k, sin_q, cos_q, None, None,
                                           bias, H, KV)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_rope_qonly runs on cuda or cpu, "
                         f"not {q.device}")
    return _launch_qonly(q, k, v, sin_q.float(), cos_q.float(), bias, H, KV,
                         with_stats)


flash_attention_rope_qonly.launches = 0


def _check_bounds(kv_hi, B: int, Lq: int, device) -> torch.Tensor:
    if tuple(kv_hi.shape) != (B, Lq):
        raise ValueError(f"kv_hi must be [B={B}, Lq={Lq}] per-row bounds, "
                         f"got {tuple(kv_hi.shape)}")
    if kv_hi.dtype.is_floating_point or kv_hi.dtype == torch.bool:
        raise ValueError(f"kv_hi must be an integer tensor, got "
                         f"{kv_hi.dtype}")
    return kv_hi.to(device=device, dtype=torch.int32).contiguous()


def flash_attention_rope_prefix_reference(q: torch.Tensor, k: torch.Tensor,
                                          v: torch.Tensor,
                                          sin: torch.Tensor,
                                          cos: torch.Tensor,
                                          kv_hi: torch.Tensor, *,
                                          n_heads: int,
                                          n_kv_heads: Optional[int] = None
                                          ) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_rope_prefix`, same
    arguments, any device: the dense bias of the clamped bounds
    (``ops.attention._prefix_dense_bias``) into the packed fp32-RoPE chain."""
    from mmada_parallel_torch.ops.attention import _prefix_dense_bias
    from mmada_parallel_torch.ops.masks import to_bias
    _check_bounds(kv_hi, q.shape[0], q.shape[1], kv_hi.device)
    bias = to_bias(_prefix_dense_bias(kv_hi, k.shape[1]))
    return flash_attention_rope_reference(q, k, v, sin, cos, bias,
                                          n_heads=n_heads,
                                          n_kv_heads=n_kv_heads)


def _launch_prefix(q, k, v, sin_q, cos_q, sin_k, cos_k, kv_hi, H: int,
                   KV: int):
    from mmada_parallel_torch.ops import _cuda
    check_no_grad("flash_attention_rope_prefix", q, k, v, sin_q, cos_q)
    B, Lq, Lk, D = check_packed(q, k, v, None, H, KV)
    hi = _check_bounds(kv_hi, B, Lq, q.device)
    tq = _check_table("sin_q", sin_q, B, Lq, D, q.device)
    _check_table("cos_q", cos_q, B, Lq, D, q.device)
    tk = _check_table("sin_k", sin_k, B, Lk, D, q.device)
    _check_table("cos_k", cos_k, B, Lk, D, q.device)
    if cos_q.shape != sin_q.shape or cos_k.shape != sin_k.shape:
        raise ValueError("sin and cos tables must have one shape")
    q_rot = k_rot = None
    if q.dtype == torch.bfloat16:
        # the tensor-core body: q and k rotated once into bf16 scratch
        check_aligned("flash_attention_rope_prefix", 16, q, k, v, sin_q,
                      cos_q, sin_k, cos_k)
        q_rot, k_rot = torch.empty_like(q), torch.empty_like(k)
    out = torch.empty_like(q)
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        err = lib.mmada_flash_attention_rope_prefix(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), sin_q.data_ptr(),
            cos_q.data_ptr(), sin_k.data_ptr(), cos_k.data_ptr(),
            hi.data_ptr(), q_rot.data_ptr() if q_rot is not None else None,
            k_rot.data_ptr() if k_rot is not None else None,
            out.data_ptr(), B, Lq, Lk, H, KV, D, tq, tk,
            D ** -0.5, _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_rope_prefix CUDA launch failed: "
                           f"cudaError_t {err}")
    flash_attention_rope_prefix.launches += 1
    return out


def flash_attention_rope_prefix(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, sin: torch.Tensor,
                                cos: torch.Tensor, kv_hi: torch.Tensor, *,
                                n_heads: int, n_kv_heads: Optional[int] = None
                                ) -> torch.Tensor:
    """Prefix-masked packed attention: :func:`flash_attention_rope` with the
    per-row mask ``kv < clip(kv_hi[b, q], 1, Lk)`` in place of a bias.

    ``kv_hi`` is an integer ``[B, Lq]`` (``masks.prefix_bounds`` /
    ``mixed_prefix_bounds``); the kernel skips every key tile past a q
    tile's highest bound, so a causal mask costs about half of the dense
    one.  ``sin``/``cos`` as for :func:`flash_attention_rope` (per-row
    ``[B, L, D]`` tables only when Lq == Lk).  A CUDA tensor launches the
    kernel (bf16: rotation pre-pass + tensor-core body; f32: the FMA
    template; D in {64, 128}, any Lk and GQA ratio) and raises on anything
    it does not take; a CPU tensor runs
    :func:`flash_attention_rope_prefix_reference`.
    ``flash_attention_rope_prefix.launches`` counts calls that launched the
    kernel (one per call)."""
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    if q.device.type == "cpu":
        return flash_attention_rope_prefix_reference(
            q, k, v, sin, cos, kv_hi, n_heads=H, n_kv_heads=KV)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_rope_prefix runs on cuda or cpu, "
                         f"not {q.device}")
    tables = _split_tables(sin, cos, q.shape[1], k.shape[1])
    return _launch_prefix(q, k, v, *tables, kv_hi, H, KV)


flash_attention_rope_prefix.launches = 0
