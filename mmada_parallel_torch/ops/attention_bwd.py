"""The attention gradient: the CUDA backward kernel's wrappers and their
plain versions.

The JAX package trains through custom VJPs whose backward recomputes the
plain chain and leaves XLA to fuse it (``_flash_diff_fn``,
``_packed_diff_fn``, ``_packed_qonly_diff_fn`` in
:mod:`mmada_parallel_tpu.ops.attention`).  Here the backward of K1, K2 and
K3 in bf16 is the hand-written kernel ``csrc/attention_bwd.cu`` (body
``csrc/attention_mma_bwd.cuh``): FlashAttention-2's backward dataflow on
Hopper's tensor cores, from the forward's row statistics and with no
atomics, so a gradient is bitwise the same from run to run; each of its
two passes is warp-specialised (a producer warpgroup feeding an mbarrier
ring by TMA and cp.async, two consumer warpgroups taking turns on the
tensor cores).

* :func:`flash_attention_bwd` (K3's, BLHD), :func:`flash_attention_rope_bwd`
  (K1's: q and k rotated by the forward's pre-pass, dq and dk sent back
  through the transposed rotation) and :func:`flash_attention_rope_qonly_bwd`
  (K2's: q only).  Each takes the forward's inputs, its output, its
  statistics (the forward wrappers' ``with_stats=True``) and the output's
  gradient, and returns ``(dq, dk, dv)``; ``.launches`` counts its kernel
  launches.  A CUDA tensor launches the kernel (bf16, D in {64, 128}) or
  raises; a CPU tensor runs the plain version.
* :func:`attention_stats_reference` and :func:`attention_bwd_reference`: the
  same arithmetic in plain tensor ops on any device (the row statistics
  ``(m, log2 l)`` of the base-2 scores; ``delta = rowsum(dout * out)``;
  ``P = 2^((x - m) - log2 l)``, ``dS = P * (dout.v^T - delta)`` key tile by
  key tile; the dq, dk, dv sums, P and dS rounded to the inputs' dtype before
  their products as the kernel rounds them).
* :func:`rope_rotate_backward`: the rotation's transpose on its own (the
  kernels' post-pass on CUDA, :func:`rope_rotate_backward_reference` on the
  CPU), the gradient autograd gives ``rope_tensor(full_precision=True)``.

Statistics are ``f32 [B, H, Lq, 2]``: each row's max ``m`` of the base-2
scores ``x`` and ``log2`` of its sum of ``2^(x - m)``, kept apart because a
row masked everywhere (bias -1e30) has ``m ~ -1.44e30``, where one
log-sum-exp would round to ``m`` and lose the row's uniform ``1/Lk``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mmada_parallel_torch.ops.rope_attention import (_check_table,
                                                     _split_tables,
                                                     check_aligned,
                                                     check_packed,
                                                     rope_tensor)

__all__ = ["attention_stats_reference", "attention_bwd_reference",
           "rope_rotate_backward", "rope_rotate_backward_reference",
           "flash_attention_bwd", "flash_attention_rope_bwd",
           "flash_attention_rope_qonly_bwd"]

LOG2E = math.log2(math.e)
# keys a tile of the plain backward scores at once: bounds its [B, H, Lq,
# KEY_BLOCK] f32 intermediates (A train step: 335 MB each)
KEY_BLOCK = 512

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _repeat_kv(t: torch.Tensor, H: int) -> torch.Tensor:
    KV = t.shape[2]
    return t if KV == H else t.repeat_interleave(H // KV, dim=2)


def _scores_log2(q: torch.Tensor, k: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Base-2 scores ``[B, H, Lq, Lk]`` f32 of ``[B, Lq, H, D]`` q against
    ``[B, Lk, H, D]`` k, rounded as the kernels round them: with a bias the
    scaled score plus the bias, then the base change; without, one multiply
    by ``scale * log2 e``."""
    scale = torch.tensor(q.shape[-1] ** -0.5, dtype=torch.float32)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if bias is None:
        return s * (scale * LOG2E)
    return (s * scale + bias.float()) * LOG2E


def attention_stats_reference(q: torch.Tensor, k: torch.Tensor,
                              bias: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """The forward's row statistics, f32 ``[B, H, Lq, 2]`` ``(m, log2 l)``,
    of BLHD ``q [B, Lq, H, D]`` and ``k [B, Lk, KV, D]`` with an optional
    ``[B, 1, Lq, Lk]`` bias."""
    x = _scores_log2(q, _repeat_kv(k, q.shape[2]), bias)
    m = x.amax(-1)
    lg = torch.log2(torch.exp2(x - m[..., None]).sum(-1))
    return torch.stack([m, lg], dim=-1)


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: Optional[torch.Tensor],
                            out: torch.Tensor, stats: torch.Tensor,
                            dout: torch.Tensor,
                            key_block: int = KEY_BLOCK) -> Grads:
    """Plain version of the backward kernel on BLHD tensors, any device:
    ``q [B, Lq, H, D]``, ``k``/``v [B, Lk, KV, D]``, ``out``/``dout``
    shaped as q, ``stats`` from :func:`attention_stats_reference` (or the
    forward kernel).  f32 arithmetic key tile by key tile; P and dS are
    rounded to q's dtype before their products (exact for f32).  Returns
    ``(dq, dk, dv)`` in the inputs' dtypes, dk and dv summed over each kv
    head's group."""
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    scale = D ** -0.5
    qf = q.float()
    kr, vr = _repeat_kv(k, H).float(), _repeat_kv(v, H).float()
    do = dout.float()
    m, lg = stats[..., 0, None], stats[..., 1, None]          # [B, H, Lq, 1]
    delta = (do * out.float()).sum(-1).transpose(1, 2)[..., None]
    dq = torch.zeros_like(qf)
    dk = torch.empty(B, Lk, H, D, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    for k0 in range(0, Lk, key_block):
        sl = slice(k0, min(k0 + key_block, Lk))
        x = _scores_log2(qf, kr[:, sl],
                         None if bias is None else bias[..., sl])
        p = torch.exp2((x - m) - lg)
        ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vr[:, sl]) - delta)
        p = p.to(q.dtype).float()
        ds = ds.to(q.dtype).float()
        dv[:, sl] = torch.einsum("bhqk,bqhd->bkhd", p, do)
        dk[:, sl] = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
        dq += torch.einsum("bhqk,bkhd->bqhd", ds, kr[:, sl])
    G = H // KV
    dk = dk.view(B, Lk, KV, G, D).sum(3) * scale
    dv = dv.view(B, Lk, KV, G, D).sum(3)
    return (dq * scale).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rope_rotate_backward_reference(dy: torch.Tensor, sin: torch.Tensor,
                                   cos: torch.Tensor) -> torch.Tensor:
    """The transposed Neox rotation of ``dy [B, L, NH, D]`` (the gradient of
    a rotated tensor) with the tables ``[L, D]`` or ``[B, L, D]``, in f32,
    rounded to ``dy``'s dtype: ``dx1 = dy1 cos1 + dy2 sin2``, ``dx2 = dy2
    cos2 - dy1 sin1``, in the order autograd sums them for
    ``rope_tensor(full_precision=True)``."""
    if sin.ndim == 2:
        sin, cos = sin[None], cos[None]
    s = sin[:, :, None, :].float()
    c = cos[:, :, None, :].float()
    half = dy.shape[-1] // 2
    g = dy.float()
    g1, g2 = g[..., :half], g[..., half:]
    x1 = g1 * c[..., :half] + g2 * s[..., half:]
    x2 = g2 * c[..., half:] + -(g1 * s[..., :half])
    return torch.cat([x1, x2], dim=-1).to(dy.dtype)


def rope_rotate_backward(dy: torch.Tensor, sin: torch.Tensor,
                         cos: torch.Tensor, *, n_heads: int) -> torch.Tensor:
    """The backward's rotation post-pass on its own: packed ``dy [B, L,
    n_heads*D]`` -> the gradient before the rotation.  A CPU tensor runs
    :func:`rope_rotate_backward_reference`; a CUDA tensor must be bf16 with D
    in {64, 128} and runs the kernel (on a copy).  K1's and K2's backward
    run this pass inside their own call and count no launch of it."""
    from mmada_parallel_torch.ops import _cuda
    B, L, HD = dy.shape
    D = HD // n_heads
    sin, cos = sin.float(), cos.float()
    if dy.device.type == "cpu":
        return rope_rotate_backward_reference(
            dy.reshape(B, L, n_heads, D), sin, cos).reshape(B, L, HD)
    if dy.dtype != torch.bfloat16 or D not in (64, 128) \
            or HD != n_heads * D or not dy.is_contiguous():
        raise ValueError(f"rope_rotate_backward on CUDA takes contiguous bf16 "
                         f"[B, L, H*D] with D in (64, 128), got {dy.dtype} "
                         f"{list(dy.shape)}, n_heads={n_heads}")
    tb = _check_table("sin", sin, B, L, D, dy.device)
    _check_table("cos", cos, B, L, D, dy.device)
    out = dy.clone()
    check_aligned("rope_rotate_backward", 16, out, sin, cos)
    with torch.cuda.device(dy.device):
        err = _cuda.library().mmada_rope_rotate_bwd(
            out.data_ptr(), sin.data_ptr(), cos.data_ptr(), B, L, n_heads, D,
            tb, torch.cuda.current_stream(dy.device).cuda_stream)
    _raise_on(err, "rope_rotate_backward")
    return out


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} CUDA launch failed: cudaError_t {err}")


def _check_bwd(name, q, out, stats, dout, H: int):
    """The tensors the backward adds to the forward's: bf16 ``out`` and
    ``dout`` shaped as q, f32 ``stats [B, H, Lq, 2]``."""
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the backward kernel takes bfloat16 (f32 "
                         f"keeps the plain-chain recompute), got {q.dtype}")
    for nm, t in (("out", out), ("dout", dout)):
        if (t.dtype != q.dtype or t.device != q.device
                or t.shape != q.shape or not t.is_contiguous()):
            raise ValueError(f"{name}: {nm} must be contiguous {q.dtype} "
                             f"{list(q.shape)} on {q.device}")
    want = (q.shape[0], H, q.shape[1], 2)
    if (stats.dtype != torch.float32 or stats.device != q.device
            or tuple(stats.shape) != want or not stats.is_contiguous()):
        raise ValueError(f"{name}: stats must be contiguous float32 "
                         f"{list(want)} on {q.device}")
    check_aligned(name, 16, out, dout)


def _packed(t: torch.Tensor) -> torch.Tensor:
    return t.view(t.shape[0], t.shape[1], -1)


def _bwd_scratch(q, k, v, H: int):
    B, Lq = q.shape[:2]
    return (torch.empty(B, H, Lq, dtype=torch.float32, device=q.device),
            torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K3's backward (BLHD)
# ---------------------------------------------------------------------------


def _launch_bwd(q, k, v, bias, out, stats, dout) -> Grads:
    from mmada_parallel_torch.ops import _cuda
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, L, heads, D] "
                             f"tensor, got shape {list(t.shape)}")
    H, KV = q.shape[2], k.shape[2]
    B, Lq, Lk, D = check_packed(*map(_packed, (q, k, v)), bias, H, KV)
    _check_bwd("flash_attention_bwd", q, out, stats, dout, H)
    check_aligned("flash_attention_bwd", 16, q, k, v)
    check_aligned("flash_attention_bwd", 8, bias)
    delta, dq, dk, dv = _bwd_scratch(q, k, v, H)
    with torch.cuda.device(q.device):
        err = _cuda.library().mmada_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias.data_ptr() if bias is not None else None, out.data_ptr(),
            dout.data_ptr(), stats.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, H, KV, D,
            D ** -0.5, _stream(q))
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor], out: torch.Tensor,
                        stats: torch.Tensor, dout: torch.Tensor) -> Grads:
    """K3's backward: ``(dq, dk, dv)`` of BLHD ``flash_attention(q, k, v,
    bias)`` given its ``out``, its ``stats`` and ``dout`` (shaped as q).  A
    CUDA tensor launches the kernel (bf16, D in {64, 128}, contiguous; any
    Lq, Lk and GQA ratio) and raises on anything it does not take; a CPU
    tensor runs :func:`attention_bwd_reference`.
    ``flash_attention_bwd.launches`` counts calls that launched it."""
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, bias, out, stats, dout)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch_bwd(q, k, v, bias, out, stats, dout)


flash_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# K1's and K2's backward (packed, RoPE)
# ---------------------------------------------------------------------------


def _heads4(t: torch.Tensor, n: int) -> torch.Tensor:
    B, L, HD = t.shape
    return t.reshape(B, L, n, HD // n)


def _rope_bwd_reference(q, k, v, sin_q, cos_q, sin_k, cos_k, bias, out,
                        stats, dout, H: int, KV: int) -> Grads:
    """The plain version of K1's (``sin_k`` given) and K2's backward on
    packed tensors: rotate as the forward does, the plain backward, then the
    transposed rotation of dq (and dk)."""
    q4 = rope_tensor(_heads4(q, H), sin_q, cos_q, True)
    k4 = _heads4(k, KV)
    if sin_k is not None:
        k4 = rope_tensor(k4, sin_k, cos_k, True)
    dq, dk, dv = attention_bwd_reference(q4, k4, _heads4(v, KV), bias,
                                         _heads4(out, H), stats,
                                         _heads4(dout, H))
    dq = rope_rotate_backward_reference(dq, sin_q, cos_q)
    if sin_k is not None:
        dk = rope_rotate_backward_reference(dk, sin_k, cos_k)
    return tuple(t.reshape(s.shape) for t, s in ((dq, q), (dk, k), (dv, v)))


def _launch_rope_bwd(q, k, v, sin_q, cos_q, sin_k, cos_k, bias, out, stats,
                     dout, H: int, KV: int) -> Grads:
    """K1 (``sin_k`` given) or K2 on the card."""
    from mmada_parallel_torch.ops import _cuda
    name = ("flash_attention_rope_bwd" if sin_k is not None
            else "flash_attention_rope_qonly_bwd")
    B, Lq, Lk, D = check_packed(q, k, v, bias, H, KV)
    _check_bwd(name, q, out, stats, dout, H)
    tables = [(sin_q, cos_q, Lq)] + ([(sin_k, cos_k, Lk)] if sin_k is not None
                                     else [])
    strides = []
    for s, c, L in tables:
        strides.append(_check_table("sin", s, B, L, D, q.device))
        _check_table("cos", c, B, L, D, q.device)
        if s.shape != c.shape:
            raise ValueError("sin and cos tables must have one shape")
        check_aligned(name, 16, s, c)
    check_aligned(name, 16, q, k, v)
    check_aligned(name, 8, bias)
    delta, dq, dk, dv = _bwd_scratch(q, k, v, H)
    q_rot = torch.empty_like(q)
    common = (bias.data_ptr() if bias is not None else None, out.data_ptr(),
              dout.data_ptr(), stats.data_ptr(), delta.data_ptr())
    lib = _cuda.library()
    with torch.cuda.device(q.device):
        if sin_k is not None:
            k_rot = torch.empty_like(k)
            err = lib.mmada_flash_attention_rope_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), sin_q.data_ptr(),
                cos_q.data_ptr(), sin_k.data_ptr(), cos_k.data_ptr(), *common,
                q_rot.data_ptr(), k_rot.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, H, KV, D,
                strides[0], strides[1], D ** -0.5, _stream(q))
        else:
            err = lib.mmada_flash_attention_rope_qonly_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), sin_q.data_ptr(),
                cos_q.data_ptr(), *common, q_rot.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, Lq, Lk, H, KV, D,
                strides[0], D ** -0.5, _stream(q))
    _raise_on(err, name)
    return dq, dk, dv


def flash_attention_rope_bwd(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, sin: torch.Tensor,
                             cos: torch.Tensor, bias: Optional[torch.Tensor],
                             out: torch.Tensor, stats: torch.Tensor,
                             dout: torch.Tensor, *, n_heads: int,
                             n_kv_heads: Optional[int] = None) -> Grads:
    """K1's backward: ``(dq, dk, dv)`` of ``flash_attention_rope(q, k, v,
    sin, cos, bias)`` (pre-RoPE packed q/k/v, the same tables) given its
    ``out``, ``stats`` and ``dout``.  A CUDA tensor launches the kernel
    (rotation pre-pass, the backward body, the transposed rotation of dq and
    dk; bf16, D in {64, 128}) or raises; a CPU tensor runs the plain
    version.  ``flash_attention_rope_bwd.launches`` counts calls that
    launched it."""
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    tables = _split_tables(sin, cos, q.shape[1], k.shape[1])
    if q.device.type == "cpu":
        return _rope_bwd_reference(q, k, v, *tables, bias, out, stats, dout,
                                   H, KV)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_rope_bwd runs on cuda or cpu, "
                         f"not {q.device}")
    grads = _launch_rope_bwd(q, k, v, *tables, bias, out, stats, dout, H, KV)
    flash_attention_rope_bwd.launches += 1
    return grads


flash_attention_rope_bwd.launches = 0


def flash_attention_rope_qonly_bwd(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, sin_q: torch.Tensor,
                                   cos_q: torch.Tensor,
                                   bias: Optional[torch.Tensor],
                                   out: torch.Tensor, stats: torch.Tensor,
                                   dout: torch.Tensor, *, n_heads: int,
                                   n_kv_heads: Optional[int] = None) -> Grads:
    """K2's backward: ``(dq, dk, dv)`` of ``flash_attention_rope_qonly(q, k,
    v, sin_q, cos_q, bias)`` (k/v the pre-rotated caches, so dk is their
    gradient as stored) given its ``out``, ``stats`` (from the body or, when
    the forward split, its combine) and ``dout``.  A CUDA tensor launches
    the kernel (q's rotation pre-pass, the backward body, the transposed
    rotation of dq; bf16, D in {64, 128}) or raises; a CPU tensor runs the
    plain version.  ``flash_attention_rope_qonly_bwd.launches`` counts calls
    that launched it."""
    H = n_heads
    KV = n_kv_heads if n_kv_heads is not None else H
    sin_q, cos_q = sin_q.float(), cos_q.float()
    if q.device.type == "cpu":
        return _rope_bwd_reference(q, k, v, sin_q, cos_q, None, None, bias,
                                   out, stats, dout, H, KV)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_rope_qonly_bwd runs on cuda or "
                         f"cpu, not {q.device}")
    grads = _launch_rope_bwd(q, k, v, sin_q, cos_q, None, None, bias, out,
                             stats, dout, H, KV)
    flash_attention_rope_qonly_bwd.launches += 1
    return grads


flash_attention_rope_qonly_bwd.launches = 0


def packed_stats_reference(q, k, sin_q, cos_q, sin_k, cos_k, bias,
                           H: int, KV: int) -> torch.Tensor:
    """:func:`attention_stats_reference` of packed q/k after the forward's
    rotation (k rotated only where ``sin_k`` is given): the statistics the
    K1 and K2 forwards write."""
    q4 = rope_tensor(_heads4(q, H), sin_q.float(), cos_q.float(), True)
    k4 = _heads4(k, KV)
    if sin_k is not None:
        k4 = rope_tensor(k4, sin_k, cos_k, True)
    return attention_stats_reference(q4, k4, bias)
