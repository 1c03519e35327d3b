"""W8A8 int8 inference path (opt-in).

Counterpart of :mod:`mmada_parallel_tpu.ops.quant`: symmetric
per-output-channel int8 weights (static, quantized once at load) times
symmetric per-token dynamic int8 activations, without outlier splitting.
Like the cached samplers it is an approximation: the dense path stays the
default, and quantized params are opt-in via :func:`quantize_llada_params`.

A quantized weight is a dict leaf ``{"w_q": int8 [..., K, N], "scale": f32
[..., 1, N]}``; the model's matmul helper and the head dispatch on it, so the
layer loop, the cached forwards and the head take it unchanged.

The int8 product: on CUDA one ``torch._int_mm`` (cuBLASLt's int8 GEMM with
int32 accumulators; the JAX package leaves this product to XLA, not to a
Pallas kernel), the weight kept column-major (``quantize_weight`` stores it
so) and shapes outside the call's rules zero-padded into them;
elsewhere an int32 matmul of the same int8 operands, which is exact, so
both give the same accumulators.  The activation quantization and the
rescale are plain tensor ops in f32, in the JAX order (``(acc * s) *
w_scale``, rounding half to even), so the result matches the JAX function
to the last bit of the rescale.

Over a mesh (:func:`quantize_param_shardings`, JAX's placement of the
quantized tree), a row-parallel product (``attn_out``, ``ff_out``: K split
over ``tensor``) passes ``reduce``, its all-reduce over the ranks that hold
the other K blocks: the per-token amax is all-reduced (max) before
quantizing, as GSPMD takes ``max|x|`` over the logical K, and the int32
accumulators are summed before the rescale, so the result is the unsharded
product's.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

__all__ = ["quantize_weight", "quantize_activations", "int8_matmul",
           "quantize_llada_params", "quantize_param_shardings",
           "is_quantized"]

_GEMM_KEYS = frozenset({"q_proj", "k_proj", "v_proj", "attn_out",
                        "ff_proj", "up_proj", "ff_out", "att_proj"})

# torch._int_mm on CUDA takes more than 16 rows, and K and N multiples of 8
_INT_MM_MIN_ROWS = 17


def _div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as a true division on every device: CUDA divides by a
    Python scalar as a multiply by its reciprocal, which can differ in the
    last bit, so the divisor is a tensor on ``t``'s device."""
    return t / torch.full((), 127.0, dtype=t.dtype, device=t.device)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "w_q" in w


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``[..., K, N] float -> {"w_q" int8, "scale" f32 [..., 1, N]}``
    (symmetric per-output-channel)."""
    # one f32 copy, divided and rounded in place: the 8B stack's largest
    # leaf is 6.4 GB in f32
    wf = w.to(torch.float32, copy=True)
    scale = _div127(wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8))
    w_q = wf.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return {"w_q": _column_major(w_q), "scale": scale}


def _column_major(w: torch.Tensor) -> torch.Tensor:
    """``w [..., K, N]`` with each column contiguous (strides ``(..., 1,
    K)``): the layout cuBLASLt's int8 GEMM takes for the weight, so the
    product needs no per-call copy, a layer's slice ``w[i]`` and a column
    slice (the head's ``vocab_slice``) included."""
    return w.transpose(-1, -2).contiguous().transpose(-1, -2)


def _int8_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``int8 [M, K] x int8 [K, N] -> int32 [M, N]``.  On CUDA,
    ``torch._int_mm`` with x row-major and w column-major (cuBLASLt's int8
    GEMM takes only that "TN" form); shapes outside its rules (more than 16
    rows, K and N multiples of 8) are zero-padded into them: padded rows and
    columns are sliced off, and zeros along K add nothing, so the
    accumulators are the same."""
    if not x_q.is_cuda:
        return x_q.to(torch.int32) @ w_q.to(torch.int32)
    M, K = x_q.shape
    N = w_q.shape[1]
    pm = max(_INT_MM_MIN_ROWS - M, 0)
    pk, pn = -K % 8, -N % 8
    x_q = F.pad(x_q, (0, pk, 0, pm)) if pm or pk else x_q.contiguous()
    if pk or pn:
        w_q = F.pad(w_q, (0, pn, 0, pk))
    return torch._int_mm(x_q, _column_major(w_q))[:M, :N]


def quantize_activations(x: torch.Tensor, reduce=None):
    """Per-token (last-axis) dynamic symmetric int8: ``(x_q int8, s f32
    [..., 1])`` with ``x ~ x_q * s``.  ``reduce(t, op)``: ``x`` is this
    rank's K block, and the amax is all-reduced (``op="max"``) over the
    whole K."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if reduce is not None:
        amax = reduce(amax, "max")
    s = _div127(amax.clamp_min(1e-8))
    return torch.round(xf / s).clamp(-127, 127).to(torch.int8), s


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                out_dtype=None, reduce=None) -> torch.Tensor:
    """``[..., M, K] x int8 [K, N] -> [..., M, N]``: the activations
    quantized per token, the int32 accumulator rescaled by ``act_scale *
    w_scale`` in f32, then cast to ``out_dtype`` (default: x's dtype).
    ``reduce(t, op)``: a row-parallel product, ``x`` and ``w_q`` this
    rank's K block; the amax (``"max"``) and the accumulators (``"sum"``)
    are all-reduced over the ranks of the other blocks."""
    out_dtype = out_dtype or x.dtype
    x_q, s = quantize_activations(x, reduce)
    acc = _int8_mm(x_q.reshape(-1, x_q.shape[-1]), w_q)
    if reduce is not None:
        acc = reduce(acc, "sum")
    acc = acc.reshape(*x.shape[:-1], w_q.shape[-1])
    return (acc.float() * s * w_scale.reshape(-1)).to(out_dtype)


def quantize_llada_params(params: Dict[str, Any],
                          quantize_head: bool = True) -> Dict[str, Any]:
    """Quantize the block GEMMs and (optionally) the united head; the
    embedding, norms and biases stay as they are.  ``quantize_head=False``
    keeps the vocab head dense (the samplers' argmax/top-k/confidence read
    its logits directly).  A tied model (no ``head``) keeps reading the
    dense embedding.  New tensors are made; ``params`` is not changed."""
    with torch.no_grad():
        blocks = {k: (quantize_weight(v) if k in _GEMM_KEYS else v)
                  for k, v in params["blocks"].items()}
        out = dict(params, blocks=blocks)
        if "head" in params and quantize_head:
            out["head"] = quantize_weight(params["head"])
    return out


def quantize_param_shardings(specs: Dict[str, Any],
                             quantize_head: bool = True) -> Dict[str, Any]:
    """The spec tree of :func:`quantize_llada_params`' tree, from the dense
    one (JAX's function): ``w_q`` keeps the dense spec, and ``scale [..., 1,
    N]`` drops the K axis, so a column-parallel leaf's scale splits with N
    and a row-parallel leaf's is whole over ``tensor``."""
    from mmada_parallel_torch.parallel.mesh import PartitionSpec as P

    def scale_spec(s):
        parts = tuple(s)
        if len(parts) < 2:
            return s
        return P(*(parts[:-2] + (None,) + parts[-1:]))

    def conv(s):
        return {"w_q": s, "scale": scale_spec(s)}

    blocks = {k: (conv(v) if k in _GEMM_KEYS else v)
              for k, v in specs["blocks"].items()}
    out = dict(specs, blocks=blocks)
    if "head" in specs and quantize_head:
        out["head"] = conv(specs["head"])
    return out
