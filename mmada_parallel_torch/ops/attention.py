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
kernel (``flash_attention`` K3).  There is no silent fallback: a CUDA tensor
under ``auto`` either launches a kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmada_parallel_torch.ops.flash_attention import flash_attention
from mmada_parallel_torch.ops.rope_attention import (apply_rope,
                                                     flash_attention_rope,
                                                     flash_attention_rope_qonly,
                                                     rope_tensor)

__all__ = ["dot_product_attention", "rope_attention", "rope_attention_qonly"]

_IMPLS = ("auto", "xla", "pallas")


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


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          impl: str = "auto") -> torch.Tensor:
    """Bidirectional scaled dot-product attention, ``[B, Lq, H, hd]`` out.
    CUDA tensors (``auto``/``pallas``) launch the BLHD kernel
    (:func:`~mmada_parallel_torch.ops.flash_attention.flash_attention`);
    CPU tensors and ``xla`` run the plain chain."""
    if _use_kernel(impl, q):
        return flash_attention(q, k, v, bias)
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
    (``auto``) and ``xla`` run the plain chain."""
    B, L, HD = q.shape
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    D = HD // H
    if _use_kernel(impl, q) and full_precision:
        return flash_attention_rope(q, k, v, sin, cos, bias, n_heads=H,
                                    n_kv_heads=KV)
    q4 = q.reshape(B, L, H, D)
    k4 = k.reshape(B, k.shape[1], KV, D)
    v4 = v.reshape(B, v.shape[1], KV, D)
    q4, k4 = apply_rope(q4, k4, sin, cos, full_precision)
    return dot_product_attention(q4, k4, v4, bias,
                                 impl=impl).reshape(B, L, HD)


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
        return flash_attention_rope_qonly(q, k, v, sin_q, cos_q, bias,
                                          n_heads=H, n_kv_heads=KV)
    q4 = rope_tensor(q.reshape(B, Lq, H, D), sin_q, cos_q, full_precision)
    k4 = k.reshape(B, k.shape[1], KV, D)
    v4 = v.reshape(B, v.shape[1], KV, D)
    return dot_product_attention(q4, k4, v4, bias,
                                 impl=impl).reshape(B, Lq, HD)
