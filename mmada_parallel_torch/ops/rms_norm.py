"""RMSNorm over the last dimension: the CUDA kernel wrapper.

The JAX package has no kernel here (XLA fuses ``models/llada._rms_norm``).
The port's backbone calls :func:`rms_norm` from ``models/llada._rms_norm``
wherever autograd records nothing (every inference forward), and the plain
chain, :func:`rms_norm_reference`, where it records (the training steps and
their remat recompute).  A CPU tensor runs that chain; a CUDA tensor
launches the hand-written kernel ``csrc/rms_norm.cu`` or raises, with no
fallback.  One launch reads each row once and writes it once, in place of
the chain's eight launches; it rounds at the chain's two points, so the two
differ only in the order of the f32 sum of squares.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mmada_parallel_torch.ops._cuda import KERNEL_DTYPES
from mmada_parallel_torch.ops.rope_attention import (check_aligned,
                                                     check_no_grad)
from mmada_parallel_torch.utils.spans import count

__all__ = ["rms_norm", "rms_norm_reference", "plan_rms_norm", "norm_bytes"]

# csrc/rms_norm.cu: a block where a row takes less than a warp; a row's
# threads at the widths a block holds one row; 16-byte vectors a thread
# holds at most; a block's threads at most (its kMaxThreads)
SUB_WARP_BLOCK = 256
ROW_THREADS = 128
MAX_VECS = 8
MAX_THREADS = 512


class Plan(NamedTuple):
    row_threads: int    # threads a row
    vecs: int           # 16-byte vectors of the row a thread holds
    rows: int           # rows a block


def plan_rms_norm(width: int, elem_size: int) -> Plan:
    """The kernel's plan for rows of ``width`` elements of ``elem_size``
    bytes, from the width alone: a row of at most 32 vectors takes a
    power-of-two sub-warp of lanes, one vector each, and a block of
    ``SUB_WARP_BLOCK`` threads many rows (the per-head q/k norms, width
    128); a longer row takes a block of its own, its vectors spread over
    ``ROW_THREADS`` threads (whole warps) at up to ``MAX_VECS`` a thread,
    and over more threads, up to ``MAX_THREADS``, beyond that.  Raises on a
    width that is not whole 16-byte vectors or that the registers cannot
    hold."""
    vec = 16 // elem_size
    if width <= 0 or width % vec:
        raise ValueError(f"rms_norm: the kernel loads 16 bytes at a time and "
                         f"needs a width that is a multiple of {vec}, got "
                         f"{width}")
    n = width // vec
    if n <= 32:
        lanes = 1 << (n - 1).bit_length()
        return Plan(lanes, 1, SUB_WARP_BLOCK // lanes)
    vecs = 1
    while vecs < MAX_VECS and n > ROW_THREADS * vecs:
        vecs *= 2
    threads = 32 * math.ceil(math.ceil(n / vecs) / 32)
    if threads > MAX_THREADS:
        raise ValueError(f"rms_norm: a row of {width} elements needs "
                         f"{threads} threads of {MAX_VECS} vectors; the "
                         f"kernel holds at most {MAX_THREADS}")
    return Plan(threads, vecs, 1)


def norm_bytes(x: torch.Tensor, weight: torch.Tensor) -> int:
    """The least bytes one call moves: ``x`` read once, the output (``x``'s
    size and type) written once, the weight read once."""
    return (2 * x.numel() * x.element_size()
            + weight.numel() * weight.element_size())


def rms_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """The plain chain: f32 statistics, ``x * rsqrt(mean(x^2) + eps)``
    rounded to ``x``'s type, times the weight in ``x``'s type."""
    og = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    x = (xf * torch.rsqrt(var + eps)).to(og)
    return x * weight.to(og)


def _launch(x: torch.Tensor, weight: torch.Tensor, eps: float,
            plan: Optional[Plan] = None) -> torch.Tensor:
    from mmada_parallel_torch.ops import _cuda
    check_no_grad("rms_norm", x, weight)
    if x.dtype not in KERNEL_DTYPES or weight.dtype not in KERNEL_DTYPES:
        raise ValueError(f"rms_norm: the CUDA kernel takes bfloat16 or "
                         f"float32, got x {x.dtype}, weight {weight.dtype}")
    width = x.shape[-1]
    if weight.shape != (width,) or weight.device != x.device:
        raise ValueError(f"rms_norm: a weight of [{width}] on {x.device}, "
                         f"got {list(weight.shape)} on {weight.device}")
    if plan is None:
        plan = plan_rms_norm(width, x.element_size())
    x = x.contiguous()
    weight = weight.contiguous()
    check_aligned("rms_norm", 16, x, weight)
    out = torch.empty_like(x)
    rows = x.numel() // width
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        err = _cuda.library().mmada_rms_norm(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, width,
            eps, KERNEL_DTYPES[x.dtype], KERNEL_DTYPES[weight.dtype],
            plan.row_threads, plan.vecs, plan.rows,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rms_norm CUDA launch failed: cudaError_t {err}")
    if not torch.cuda.is_current_stream_capturing():
        rms_norm.launches += 1
        count("backbone.norm_bytes", norm_bytes(x, weight))
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm of ``x`` over its last dimension, times ``weight``, in
    ``x``'s type.  A CUDA tensor (f32 or bf16 ``x`` and weight, a width of
    whole 16-byte vectors, no gradient wanted) launches the kernel and
    raises on anything it does not take; a CPU tensor runs
    :func:`rms_norm_reference`.  ``rms_norm.launches`` counts the launches
    the host made (a call recorded into a CUDA graph is not one); each adds
    its :func:`norm_bytes` to the ``backbone.norm_bytes`` counter while the
    spans record."""
    if x.device.type == "cpu":
        return rms_norm_reference(x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm runs on cuda or cpu, not {x.device}")
    return _launch(x, weight, eps)


rms_norm.launches = 0
