"""Bidirectional attention with swappable backends.

Counterpart of :mod:`mmada_parallel_tpu.ops.attention`.  ``attention_impl``
keeps the JAX names:

* ``xla``    -- the plain eager chain (einsum scores in fp32, fp32 softmax),
  on any device;
* ``pallas`` -- the hand-written CUDA kernels; raises for CPU tensors;
* ``auto``   -- the kernels for CUDA tensors, the plain chain for CPU ones.

Which kernel: the packed entry points launch the fused-RoPE kernels
(``flash_attention_rope`` K1, ``flash_attention_rope_qonly`` K2) when the
rotation is fp32 (``full_precision``); otherwise they rotate in the compute
dtype and go through :func:`dot_product_attention`, which launches the BLHD
kernel (``flash_attention`` K3).  :func:`rope_attention_prefix` takes a
task mask as per-row key bounds and launches the prefix kernel
(``flash_attention_rope_prefix`` K4) for long sequences.  There is no silent
fallback: a CUDA tensor under ``auto`` either launches a kernel or raises.

Gradients: a kernel's output comes back through ``ctypes`` with no autograd
history, so every kernel is called through a :class:`torch.autograd.Function`
whose forward launches it and whose backward recomputes the plain chain and
returns its vector-Jacobian product -- the JAX package's custom VJPs
(``_flash_diff_fn``, ``_packed_diff_fn``, ``_packed_qonly_diff_fn``,
``_packed_prefix_diff_fn``).  The backward launches no kernel.  Tables,
biases and bounds get no gradient, as in JAX.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from mmada_parallel_torch.ops.flash_attention import flash_attention
from mmada_parallel_torch.ops.masks import to_bias
from mmada_parallel_torch.ops.rope_attention import (
    _KERNEL_HEAD_DIMS, apply_rope, flash_attention_rope,
    flash_attention_rope_prefix, flash_attention_rope_prefix_reference,
    flash_attention_rope_qonly, flash_attention_rope_qonly_reference,
    flash_attention_rope_reference, rope_tensor)

__all__ = ["dot_product_attention", "rope_attention",
           "rope_attention_prefix", "rope_attention_qonly"]

_IMPLS = ("auto", "xla", "pallas")
# sequence length from which ``auto`` sends a prefix mask to K4 instead of a
# dense bias into K1: the JAX package's threshold, kept as it is
PREFIX_MIN_LEN = 4096


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Eager attention on ``[B, Lq, H, D]`` q and ``[B, Lk, KV, D]`` k/v.
    Scores accumulate in fp32 (the products of bf16 values are exact in
    fp32), the softmax is fp32, and the probabilities are cast to q's dtype
    before ``p @ v``, as the JAX einsum path does."""
    B, L, H, D = q.shape
    KV = k.shape[2]
    if H != KV:
        rep = H // KV
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _use_kernel(impl: str, t: torch.Tensor) -> bool:
    """True where ``impl`` sends a tensor on ``t``'s device to a kernel;
    ``pallas`` on a CPU tensor raises."""
    if impl not in _IMPLS:
        raise ValueError(f"unknown attention impl: {impl}")
    if impl == "xla":
        return False
    if t.device.type == "cpu":
        if impl == "pallas":
            raise ValueError("impl='pallas' launches the CUDA kernels and "
                             "needs CUDA tensors")
        return False
    return True


# ---------------------------------------------------------------------------
# Autograd: kernel forward, plain-chain recompute backward
# ---------------------------------------------------------------------------


class _KernelFn(torch.autograd.Function):
    """``kernel(q, k, v, *consts)`` forward; backward: the VJP of
    ``plain(q, k, v, *consts)``, recomputed under ``enable_grad``, for the
    q/k/v the forward was asked to differentiate, and ``None`` for the
    constants (tables, bias, bounds).  ``kernel`` and ``plain`` carry the
    head counts (``functools.partial``)."""

    @staticmethod
    def forward(ctx, kernel, plain, q, k, v, *consts):
        ctx.plain = plain
        ctx.save_for_backward(q, k, v, *consts)
        return kernel(q, k, v, *consts)

    @staticmethod
    def backward(ctx, g):
        q, k, v, *consts = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:5]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n) for x, n in zip((q, k, v),
                                                                 needs)]
            wrt = [x for x, n in zip(xs, needs) if n]
            grads = iter(torch.autograd.grad(ctx.plain(*xs, *consts), wrt, g)
                         if wrt else ())
        return (None, None, *(next(grads) if n else None for n in needs),
                *(None,) * len(consts))


def _heads(fn: Callable, H: int, KV: int) -> Callable:
    return functools.partial(fn, n_heads=H, n_kv_heads=KV)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Bidirectional scaled dot-product attention, ``[B, Lq, H, hd]`` out.
    CUDA tensors (``auto``/``pallas``) launch the BLHD kernel
    (:func:`~mmada_parallel_torch.ops.flash_attention.flash_attention`);
    CPU tensors and ``xla`` run the plain chain."""
    if _use_kernel(impl, q):
        return _KernelFn.apply(flash_attention, _xla_attention, q, k, v,
                               bias)
    return _xla_attention(q, k, v, bias)


def _packed_reference(q, k, v, sin, cos, bias, H: int, KV: int):
    """The packed chain spelled out: reshape -> fp32 rope -> eager attention
    -> reshape.  Oracle for the fused kernel."""
    B, L, HD = q.shape
    D = HD // H
    q4 = q.reshape(B, L, H, D)
    k4 = k.reshape(B, k.shape[1], KV, D)
    v4 = v.reshape(B, v.shape[1], KV, D)
    q4, k4 = apply_rope(q4, k4, sin, cos, True)
    return _xla_attention(q4, k4, v4, bias).reshape(B, L, HD)


def _packed_qonly_reference(q, k, v, sin_q, cos_q, bias, H: int, KV: int,
                            full_precision: bool = True):
    """The chain for pre-rotated k: reshape -> rope on q only -> eager
    attention -> reshape.  Oracle for the q-only kernel."""
    B, Lq, HD = q.shape
    D = HD // H
    q4 = rope_tensor(q.reshape(B, Lq, H, D), sin_q, cos_q, full_precision)
    k4 = k.reshape(B, k.shape[1], KV, D)
    v4 = v.reshape(B, v.shape[1], KV, D)
    return _xla_attention(q4, k4, v4, bias).reshape(B, Lq, HD)


def rope_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   sin: torch.Tensor, cos: torch.Tensor,
                   bias: Optional[torch.Tensor] = None, *,
                   n_heads: int, n_kv_heads: Optional[int] = None,
                   full_precision: bool = True,
                   impl: str = "auto") -> torch.Tensor:
    """RoPE + bidirectional attention on packed ``[B, L, H*hd]`` q/k/v.

    CUDA tensors (``auto`` or ``pallas``) launch the fused kernel
    (:func:`~mmada_parallel_torch.ops.rope_attention.flash_attention_rope`)
    when the rotation is fp32, at any key length, MHA or GQA; with
    ``full_precision=False`` they rotate in the compute dtype and launch the
    BLHD kernel through :func:`dot_product_attention`.  CPU tensors
    (``auto``) and ``xla`` run the plain chain.  Differentiable on every
    path."""
    B, L, HD = q.shape
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    D = HD // H
    if _use_kernel(impl, q) and full_precision:
        return _KernelFn.apply(_heads(flash_attention_rope, H, KV),
                               _heads(flash_attention_rope_reference, H, KV),
                               q, k, v, sin, cos, bias)
    q4 = q.reshape(B, L, H, D)
    k4 = k.reshape(B, k.shape[1], KV, D)
    v4 = v.reshape(B, v.shape[1], KV, D)
    q4, k4 = apply_rope(q4, k4, sin, cos, full_precision)
    return dot_product_attention(q4, k4, v4, bias,
                                 impl=impl).reshape(B, L, HD)


# ---------------------------------------------------------------------------
# Prefix-masked packed attention (the training task masks)
# ---------------------------------------------------------------------------


def _prefix_dense_bias(kv_hi: torch.Tensor, Lk: int) -> torch.Tensor:
    """``[B, Lq]`` bounds -> the equivalent dense bool mask
    ``[B, 1, Lq, Lk]``.  Bounds are clamped to ``[1, Lk]`` as the kernel
    clamps them, so a bound-0 row attends to token 0 on every path."""
    cols = torch.arange(Lk, device=kv_hi.device)
    hi = kv_hi.long().clamp(1, Lk)
    return (cols[None, None, :] < hi[:, :, None])[:, None]


def rope_attention_prefix(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sin: torch.Tensor, cos: torch.Tensor,
                          kv_hi: torch.Tensor, *, n_heads: int,
                          n_kv_heads: Optional[int] = None,
                          full_precision: bool = True,
                          impl: str = "auto") -> torch.Tensor:
    """Task-masked packed attention from per-row key bounds
    (``masks.prefix_bounds``): row ``q`` of batch ``b`` attends to keys
    ``kv < kv_hi[b, q]``.

    ``pallas`` forces the prefix kernel K4 (and raises on CPU tensors or on
    a shape it does not take: fp32 rotation, head_dim in {64, 128});
    ``auto`` launches it for CUDA tensors when ``L >= PREFIX_MIN_LEN`` and
    the shape is eligible.  Otherwise the bounds become the equivalent dense
    bias for :func:`rope_attention` (K1 on the card under ``auto``, the plain
    chain on CPU or under ``xla``).  The semantics are the same everywhere;
    the threshold is the JAX package's."""
    B, L, HD = q.shape
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    D = HD // H
    eligible = full_precision and D in _KERNEL_HEAD_DIMS
    if impl == "pallas" and not eligible:
        raise ValueError(
            f"impl='pallas' needs full_precision=True and head_dim in "
            f"{_KERNEL_HEAD_DIMS} (got full_precision={full_precision}, "
            f"head_dim={D})")
    if _use_kernel(impl, q) and eligible and (impl == "pallas"
                                              or L >= PREFIX_MIN_LEN):
        return _KernelFn.apply(
            _heads(flash_attention_rope_prefix, H, KV),
            _heads(flash_attention_rope_prefix_reference, H, KV),
            q, k, v, sin, cos, kv_hi)
    bias = to_bias(_prefix_dense_bias(kv_hi, k.shape[1]))
    return rope_attention(q, k, v, sin, cos, bias, n_heads=H, n_kv_heads=KV,
                          full_precision=full_precision, impl=impl)


# ---------------------------------------------------------------------------
# Packed attention with pre-rotated K (the feature-cache hot path)
# ---------------------------------------------------------------------------


def rope_attention_qonly(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sin_q: torch.Tensor, cos_q: torch.Tensor,
                         bias: Optional[torch.Tensor] = None, *,
                         n_heads: int, n_kv_heads: Optional[int] = None,
                         full_precision: bool = True,
                         impl: str = "auto") -> torch.Tensor:
    """Packed attention where k/v arrive PRE-ROTATED (the feature cache
    stores post-RoPE k, ``models/llada.py``): q gets the rotation at its
    true positions (``sin_q``/``cos_q``: ``[Lq, hd]`` or per-row
    ``[B, Lq, hd]``), k/v are the full packed caches ``[B, Lk, KV*hd]``.

    CUDA tensors launch the q-only fused kernel
    (:func:`~mmada_parallel_torch.ops.rope_attention.flash_attention_rope_qonly`)
    when the rotation is fp32; otherwise q is rotated in the compute dtype
    and :func:`dot_product_attention` runs (the BLHD kernel on CUDA, the
    plain chain on CPU or under ``xla``)."""
    B, Lq, HD = q.shape
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    D = HD // H
    if _use_kernel(impl, q) and full_precision:
        return _KernelFn.apply(
            _heads(flash_attention_rope_qonly, H, KV),
            _heads(flash_attention_rope_qonly_reference, H, KV),
            q, k, v, sin_q, cos_q, bias)
    q4 = rope_tensor(q.reshape(B, Lq, H, D), sin_q, cos_q, full_precision)
    k4 = k.reshape(B, k.shape[1], KV, D)
    v4 = v.reshape(B, v.shape[1], KV, D)
    return dot_product_attention(q4, k4, v4, bias,
                                 impl=impl).reshape(B, Lq, HD)
