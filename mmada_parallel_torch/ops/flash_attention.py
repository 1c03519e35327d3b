"""BLHD bidirectional flash attention: the CUDA kernel wrapper (K3).

Counterpart of :mod:`mmada_parallel_tpu.ops.flash_attention`.  The TPU kernel
``flash_attention`` (``_kernel``) is ported as the hand-written CUDA kernel
``csrc/flash_attention.cu``: no RoPE, optional additive f32 bias, GQA.  Its
plain PyTorch version is ``ops.attention._xla_attention``, which CPU tensors
run and which the kernel is held to.

A contiguous ``[B, L, H, D]`` tensor is the same memory as packed
``[B, L, H*D]``, so the kernel reads the heads in place.  bf16 runs the
tensor-core body ``csrc/attention_mma.cuh`` (shared with K1, K2 and K4),
f32 the FMA template ``csrc/attention_kernel.cuh`` with RoPE off.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmada_parallel_torch.ops.rope_attention import (_KERNEL_DTYPES,
                                                     check_aligned,
                                                     check_no_grad,
                                                     check_packed)

__all__ = ["flash_attention"]


def _launch(q, k, v, bias):
    from mmada_parallel_torch.ops import _cuda
    check_no_grad("flash_attention", q, k, v, bias)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, L, heads, D] "
                             f"tensor, got shape {list(t.shape)}")
    B, Lq, H, D = q.shape
    KV = k.shape[2]
    if k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"k/v must be [B, Lk, KV, {D}] of one shape, got "
                         f"{list(k.shape)} and {list(v.shape)}")
    packed = [t.view(t.shape[0], t.shape[1], -1) for t in (q, k, v)]
    B, Lq, Lk, D = check_packed(*packed, bias, H, KV)
    if q.dtype == torch.bfloat16:               # the tensor-core body
        check_aligned("flash_attention", 16, q, k, v)
        check_aligned("flash_attention", 8, bias)
    out = torch.empty_like(q)
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        err = lib.mmada_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            B, Lq, Lk, H, KV, D, D ** -0.5, _KERNEL_DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention CUDA launch failed: "
                           f"cudaError_t {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[B, Lq, H, D] x [B, Lk, KV, D] -> [B, Lq, H, D]``, non-causal.

    ``bias`` is an optional additive f32 ``[B, 1, Lq, Lk]``.  A CUDA tensor
    launches the kernel (bf16 on the tensor cores or f32 on the FMA pipes,
    D in {64, 128}, contiguous inputs, any Lq, Lk and GQA ratio) and raises
    on anything it does not take; a CPU tensor runs the plain
    ``_xla_attention``.  ``flash_attention.launches``
    counts kernel launches."""
    if q.device.type == "cpu":
        from mmada_parallel_torch.ops.attention import _xla_attention
        return _xla_attention(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch(q, k, v, bias)


flash_attention.launches = 0
