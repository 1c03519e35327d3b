"""Ring tensor parallelism on ``torch.distributed``: the Megatron boundary
collectives decomposed into explicit point-to-point rounds.

Counterpart of :mod:`mmada_parallel_tpu.parallel.tp_overlap`, with the same
arithmetic.  Each rank of the ``tensor`` axis's process group (``g`` ranks)
holds a contiguous ``1/g`` of the attention heads and of the MLP hidden
dimension (:func:`~mmada_parallel_torch.models.llada.param_shardings`
through :func:`~mmada_parallel_torch.parallel.mesh.shard_params`) and one
sequence chunk ``[B, L/g, d]`` of the residual stream:

* q/k/v and the MLP up/gate projections are ring **all-gather-matmuls**
  (:func:`ring_ag_matmul`): the sequence chunks travel the ring while each
  arriving chunk is multiplied into its slice of the column-sharded output;
* attention runs on the rank's ``H/g`` heads, per sigma-chunk of queries
  against the once-rotated full K, through the q-only fused-RoPE kernel
  (K2, ``rope_attention_qonly``);
* attn-out and MLP-down are ring **matmul-reduce-scatters**
  (:func:`ring_matmul_rs`): partial sums circulate and accumulate, in the
  activation dtype, while the next chunk's product runs.

Each chunk is split into two halves that travel the ring in opposite
directions, and one round's sends and receives of both directions are
posted together in one ``dist.batch_isend_irecv`` (:func:`ring_permute`),
so both directions of a link carry traffic and the round's transfer is in
flight while that round's products run.  Per rank and boundary the bytes
sent are ``(g-1)/g`` of the gathered (or reduced) activation, the volume of
the all-gather or reduce-scatter it replaces.

Rows travel and land in sigma order (:func:`sigma_positions`), never in
natural order: transformer blocks are permutation-equivariant once the
RoPE tables are gathered with the same order.

Transport: NCCL sends CUDA tensors directly; on a gloo group a CUDA tensor
goes through host memory (copied to the host, sent, received into a host
buffer, copied back).  ``dist.get_backend(group)`` decides.

The parameters are placed by ``param_shardings`` as in JAX: ``wte`` and
``head`` split their vocab over ``tensor``.  Each rank embeds the whole
sequence in its vocab range and keeps its chunk of the reduce-scattered sum
(:func:`~mmada_parallel_torch.parallel.tensor.reduce_scatter_rows`).  What
differs from the JAX package: SPMD PyTorch has no GSPMD to gather the
sequence-sharded result for the vocab head, so
:func:`llada_hidden_tp_overlap` returns the full ``[B, L, d]`` hidden state
on every rank (an all-gather over the ``tensor`` group, and over the
``data`` group where ``data > 1``); every rank then runs the same sampler,
and the head projects each rank's vocab blocks of it and gathers the
logits (:class:`~mmada_parallel_torch.parallel.tensor.MeshGather`, read
from the parameters' mesh).  ``ln_f`` is whole on every rank.  JAX's block
calls ``rope_attention_qonly(..., bare=True)`` to skip the GSPMD
partitioning wrapper inside its manual partitioning; the port has no such
wrapper, so its block calls the kernel's entry point as it is.  JAX's
``ring_order_devices`` orders TPU devices by their torus coordinates; CUDA
devices have none, and a rank's ring neighbours are fixed by its rank in
the ``tensor`` group, so the port has no counterpart.

Scope as in JAX: the ``llama`` block, MHA or GQA with head counts dividing
``g``, no padding mask or position ids (the servers' exact-length batching
never pads), ``fsdp == 1``.

Training runs through the same functions: where a gradient is recorded a
ring round is an autograd Function whose backward permutes the other way
(:class:`_RingRound`), and the final gather's backward takes this rank's
slice (:class:`_GatherRows`).  Which gradients are then summed over which
groups is the sharded train step's rule
(``training/trainer.py:_ring_syncs``).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = ["ring_permute", "ring_ag_matmul", "ring_matmul_rs",
           "sigma_positions", "llada_hidden_tp_overlap",
           "llada_forward_tp_overlap", "ring_hidden_fn", "check_ring_input"]

AXIS = "tensor"


def _perms(g: int) -> Tuple[list, list]:
    """``(source, destination)`` pairs of the +ring and the -ring."""
    fwd = [(i, (i + 1) % g) for i in range(g)]
    bwd = [(i, (i - 1) % g) for i in range(g)]
    return fwd, bwd


def _host_staged(group, t: torch.Tensor) -> bool:
    """A CUDA tensor on a gloo group travels through host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _post_round(xs: Sequence[torch.Tensor], directions: Sequence[int],
                group) -> Callable[[], List[torch.Tensor]]:
    """Post one ring round (see :func:`ring_permute`); returns ``wait()``."""
    g, r = dist.get_world_size(group), dist.get_rank(group)
    fwd, bwd = _perms(g)
    ops, bufs = [], []
    for x, d in zip(xs, directions):
        perm = fwd if d == 1 else bwd
        dst = perm[r][1]
        src = next(i for i, j in perm if j == r)
        send = (x.to("cpu", memory_format=torch.contiguous_format)
                if _host_staged(group, x) else x.contiguous())
        buf = torch.empty_like(send)
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, dst), group))
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, src), group))
        bufs.append(buf)
    works = dist.batch_isend_irecv(ops)

    def wait() -> List[torch.Tensor]:
        for w in works:
            w.wait()
        del ops[:]           # the sends are done: their buffers may go
        return [b.to(x.device) for b, x in zip(bufs, xs)]

    return wait


class _RingRound(torch.autograd.Function):
    """One ring round with a gradient: the forward completes the round;
    the backward sends each received tensor's gradient back the way it
    came (the +ring's to the previous rank, the -ring's to the next)."""

    @staticmethod
    def forward(ctx, group, directions, *xs):
        ctx.group, ctx.directions = group, directions
        return tuple(_post_round(xs, directions, group)())

    @staticmethod
    def backward(ctx, *grads):
        back = [-d for d in ctx.directions]
        return (None, None) + tuple(_post_round(grads, back, ctx.group)())


def ring_permute(xs: Sequence[torch.Tensor], directions: Sequence[int],
                 group=None) -> Callable[[], List[torch.Tensor]]:
    """Post one ring round on ``group``: ``xs[i]`` goes to the next rank
    of the +ring (``directions[i] == 1``) or of the -ring (``-1``), and its
    replacement comes from the rank before.  All sends and receives of the
    round go in one ``dist.batch_isend_irecv``, so both directions are in
    flight at once.  Returns ``wait()``, which completes the round and
    gives the received tensors, on ``xs``' devices.

    Where a gradient is recorded (grad mode on and an input that requires
    it) the round is :class:`_RingRound`, completed before this returns:
    training gives up the round's overlap with the products, serving keeps
    it."""
    group = group if group is not None else dist.group.WORLD
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        out = _RingRound.apply(group, tuple(directions), *xs)
        return lambda: list(out)
    return _post_round(xs, directions, group)


def sigma_positions(g: int, C: int, r: int, device=None) -> torch.Tensor:
    """Global sequence positions of the sigma-ordered (received-order) rows
    of rank ``r``: first the +ring half-chunks ``(r-k) % g`` for ``k =
    0..g-1`` (rows ``0:C//2`` of each chunk), then the -ring half-chunks
    ``(r+k) % g`` (rows ``C//2:C``).  Attention is order-free over keys and
    everything else is per token, so the whole layer stack runs in this
    order once the RoPE tables are gathered with it."""
    C1 = C // 2
    ks = torch.arange(g, device=device)
    a = (((r - ks) % g) * C)[:, None] + torch.arange(C1, device=device)[None]
    b = (((r + ks) % g) * C)[:, None] + (
        C1 + torch.arange(C - C1, device=device))[None]
    return torch.cat([a.reshape(-1), b.reshape(-1)])


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: ``x ~ q * scale``, scale ``[B, rows, 1]``
    f32 (absmax / 127).  One quantization at the source rank: the int8
    payload travels the whole ring unchanged, so the error does not
    compound with hops."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                     dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def ring_ag_matmul(h: torch.Tensor, weights: Sequence[torch.Tensor], g: int,
                   group=None, int8_payload: bool = False,
                   permute=None) -> List[torch.Tensor]:
    """All-gather-matmul: this rank's sequence chunk ``h [B, C, Din]``
    against column-sharded ``W [Din, F_local]`` weights -> ``[B, g*C,
    F_local]`` outputs in sigma order (:func:`sigma_positions`).

    The chunk splits into two sequence halves that travel the ring in
    opposite directions; at round ``s`` the +ring holds chunk ``(r-s) % g``'s
    first half and the -ring chunk ``(r+s) % g``'s second half, each
    multiplied while the next round's transfer is in flight.  Outputs stack
    in arrival order.

    ``int8_payload=True`` (an opt-in approximation): the travelling halves
    are per-token symmetric int8 with f32 row scales, quantized once at the
    source and dequantized at each consumer, halving the bytes sent.  The
    local (round 0) product uses the dequantized values too, so every rank
    computes from the same inputs.

    ``permute(xs, directions, group) -> wait`` replaces
    :func:`ring_permute` (the tests count bytes through it)."""
    permute = permute or ring_permute
    half = h.shape[1] // 2
    ha, hb = h[:, :half], h[:, half:]
    ws = [w.to(h.dtype) for w in weights]
    outs_a: List[list] = [[] for _ in ws]
    outs_b: List[list] = [[] for _ in ws]
    if int8_payload:
        qa, sa = _quantize_rows(ha)
        qb, sb = _quantize_rows(hb)
        for s in range(g):
            wait = (permute([qa, sa, qb, sb], [1, 1, -1, -1], group)
                    if s < g - 1 else None)
            da = _dequantize_rows(qa, sa, h.dtype)
            db = _dequantize_rows(qb, sb, h.dtype)
            for i, w in enumerate(ws):
                outs_a[i].append(da @ w)
                outs_b[i].append(db @ w)
            if wait is not None:
                qa, sa, qb, sb = wait()
    else:
        for s in range(g):
            wait = permute([ha, hb], [1, -1], group) if s < g - 1 else None
            for i, w in enumerate(ws):
                outs_a[i].append(ha @ w)
                outs_b[i].append(hb @ w)
            if wait is not None:
                ha, hb = wait()
    return [torch.cat(a + b, dim=1) for a, b in zip(outs_a, outs_b)]


def _ring_reduce_scatter(part_a: Callable, part_b: Callable, g: int,
                         group=None, permute=None) -> torch.Tensor:
    """The sigma-order reduce-scatter protocol shared by
    :func:`ring_matmul_rs` and the attn-out path of the block:
    ``part_a(k)`` / ``part_b(k)`` give this rank's partial for sigma-index
    ``k`` (+ring first halves / -ring second halves); the accumulators hop
    ``g-1`` times, each round adding the partial of the static sigma-index
    ``(1+s) % g``, and land chunk ``r`` in natural row order.  The sums are
    in the partials' dtype (the activation dtype)."""
    permute = permute or ring_permute
    acc_a = part_a(1)
    acc_b = part_b(1)
    for s in range(1, g):
        wait = permute([acc_a, acc_b], [1, -1], group)
        pa, pb = part_a((1 + s) % g), part_b((1 + s) % g)
        acc_a, acc_b = wait()
        acc_a, acc_b = acc_a + pa, acc_b + pb
    return torch.cat([acc_a, acc_b], dim=1)


def ring_matmul_rs(a: torch.Tensor, w: torch.Tensor, g: int, group=None,
                   permute=None) -> torch.Tensor:
    """Matmul-reduce-scatter: a sigma-ordered, row-sharded product input
    ``a [B, L, K_local]`` (the layout :func:`ring_ag_matmul` produces)
    against ``w [K_local, F]`` -> the fully reduced local sequence chunk
    ``[B, L/g, F]`` (chunk ``r`` of the global product, natural order).
    The accumulator of chunk ``j`` starts at rank ``j+1`` and hops the
    +ring adding each rank's partial (mirrored on the -ring for the second
    halves); per rank the bytes sent are ``(g-1)/g`` of the result's."""
    B, L, K = a.shape
    if L % g:
        raise ValueError(f"sequence {L} not divisible by ring size {g}")
    C = L // g
    C1 = C // 2
    C2 = C - C1
    w = w.to(a.dtype)

    def part_a(k):   # +ring: sigma-index k holds chunk (r - k) % g, rows 0:C1
        return a[:, k * C1:(k + 1) * C1, :] @ w

    def part_b(k):   # -ring: chunk (r + k) % g, rows C1:C
        off = g * C1
        return a[:, off + k * C2: off + (k + 1) * C2, :] @ w

    return _ring_reduce_scatter(part_a, part_b, g, group, permute)


# ---------------------------------------------------------------------------
# The LLaDA block and backbone on the ring
# ---------------------------------------------------------------------------


def _block_tp(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg,
              sin_s: torch.Tensor, cos_s: torch.Tensor, g: int, group=None,
              int8_payload: bool = False, permute=None) -> torch.Tensor:
    """One llama block on this rank's ``[B, C, D]`` chunk with its
    tensor-sharded weights; mirrors ``models.llada._block``.  q/k/v and the
    attention run in sigma order with the sigma-gathered RoPE tables, the
    residual stream stays in natural chunk order.

    Attention runs per sigma-chunk of queries against the once-rotated full
    K, in the order the attn-out reduce-scatter consumes the chunks, so each
    piece and its ``@ attn_out`` partial run while that round's transfer is
    in flight."""
    from mmada_parallel_torch.models.llada import _norm, _rope_packed
    from mmada_parallel_torch.ops.attention import rope_attention_qonly

    cdt = x.dtype
    nh_l = cfg.n_heads // g
    nkv_l = cfg.effective_n_kv_heads // g
    B, C, _ = x.shape
    C1 = C // 2
    C2 = C - C1

    h = _norm(x, lp["attn_norm"], cfg)
    q, k, v = ring_ag_matmul(h, [lp["q_proj"], lp["k_proj"], lp["v_proj"]],
                             g, group, int8_payload, permute)
    if "q_bias" in lp:
        q = q + lp["q_bias"].to(cdt)
        k = k + lp["k_bias"].to(cdt)
        v = v + lp["v_bias"].to(cdt)
    k = _rope_packed(k, sin_s, cos_s, nkv_l, cfg.rope_full_precision)

    def att_piece(lo, size):
        return rope_attention_qonly(
            q[:, lo:lo + size].contiguous(), k, v, sin_s[lo:lo + size],
            cos_s[lo:lo + size], bias=None, n_heads=nh_l, n_kv_heads=nkv_l,
            full_precision=cfg.rope_full_precision, impl=cfg.attention_impl)

    wo = lp["attn_out"].to(cdt)

    def part_a(k):          # attention for sigma-chunk k's queries, projected
        return att_piece(k * C1, C1) @ wo

    def part_b(k):
        return att_piece(g * C1 + k * C2, C2) @ wo

    x = x + _ring_reduce_scatter(part_a, part_b, g, group, permute)

    h = _norm(x, lp["ff_norm"], cfg)
    gate_in, up = ring_ag_matmul(h, [lp["ff_proj"], lp["up_proj"]], g, group,
                                 int8_payload, permute)
    return x + ring_matmul_rs(F.silu(gate_in) * up, lp["ff_out"], g, group,
                              permute)


def _stack_tp(x, blocks, sin, cos, cfg, g, group=None, int8_payload=False,
              permute=None):
    """The layer stack on this rank's chunk, the RoPE tables sigma-gathered
    once (rank-dependent, layer-invariant)."""
    from mmada_parallel_torch.models.llada import _layer
    r = dist.get_rank(group)
    pos = sigma_positions(g, x.shape[1], r, x.device)
    sin_s, cos_s = sin[pos], cos[pos]
    for i in range(cfg.n_layers):
        x = _block_tp(x, _layer(blocks, i), cfg, sin_s, cos_s, g, group,
                      int8_payload, permute)
    return x


def _all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    from mmada_parallel_torch.parallel.fsdp import all_gather_dim
    return all_gather_dim(x, 0, group).reshape(dist.get_world_size(group),
                                               *x.shape)


class _GatherRows(torch.autograd.Function):
    """Every rank goes on with the same gathered tensor and computes the
    same head and loss from it, so each rank's gradient of the gathered
    tensor is already the whole gradient: the backward takes this rank's
    own slice (a reduce-scatter with a sum would count it ``g`` times)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = dist.get_rank(group)
        return _all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank], None


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``[n, *rest]`` on each of the group's ``g`` ranks -> ``[g, n,
    *rest]``, rank order, on every rank (:class:`_GatherRows` where a
    gradient is recorded)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherRows.apply(x, group)
    return _all_gather_rows(x, group)


def check_ring_input(cfg, mesh, batch: int, length: int,
                     attn_mask: Optional[torch.Tensor] = None,
                     position_ids: Optional[torch.Tensor] = None) -> None:
    """Raise JAX's ``ValueError`` where :func:`llada_hidden_tp_overlap`
    cannot run a ``[batch, length]`` input of ``cfg`` on ``mesh``; it does
    so before any communication, the same on every rank."""
    if attn_mask is not None or position_ids is not None:
        raise ValueError(
            "ring TP supports exact-length (maskless) batches only; "
            "use the GSPMD path for ragged/padded batches")
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    g = shape[AXIS]
    if g < 2:
        raise ValueError(
            f"ring TP needs tensor >= 2 (got {g}); the ring protocols "
            "start accumulation one hop out and have no single-chip "
            "degenerate form — use the GSPMD path")
    if shape.get("fsdp", 1) != 1:
        raise ValueError("tp_overlap requires fsdp == 1 "
                         f"(got {shape})")
    if cfg.block_type != "llama":
        raise ValueError("tp_overlap supports the llama block flavor only")
    if cfg.n_heads % g:
        raise ValueError(f"n_heads {cfg.n_heads} not divisible by g={g}")
    if cfg.effective_n_kv_heads % g:
        raise ValueError(
            f"n_kv_heads {cfg.effective_n_kv_heads} not divisible by "
            f"g={g} (GQA groups must split evenly over the ring)")
    if length % g:
        raise ValueError(f"sequence {length} not divisible by g={g}")
    n_data = shape["data"]
    if batch % n_data:
        raise ValueError(f"batch {batch} not divisible by data={n_data}")


def llada_hidden_tp_overlap(
    params: Dict[str, Any],
    cfg,
    input_ids: torch.Tensor,
    mesh,
    attn_mask: Optional[torch.Tensor] = None,
    position_ids: Optional[torch.Tensor] = None,
    int8_payload: bool = False,
    permute=None,
) -> torch.Tensor:
    """Backbone (post-``ln_f`` hidden states ``[B, L, d]``) with the layer
    stack on the ring collectives; equal to
    :func:`~mmada_parallel_torch.models.llada.llada_hidden` up to the
    ring's summation order.

    SPMD: every rank of ``mesh`` calls it with the same ``input_ids`` and
    its own shards of ``params`` (``shard_params(params,
    param_shardings(cfg), mesh)``; the vocab-parallel ``wte`` embeds the
    data group's whole rows, and the reduce-scatter of the sum leaves each
    rank its chunk).  The batch splits over the ``data``
    axis and each data group runs its own ring over ``tensor``; the rows
    come back in natural order on every rank.  Requires the llama block,
    ``n_heads % g == 0`` and ``n_kv_heads % g == 0``, ``L % g == 0``,
    ``fsdp == 1`` and no padding mask or position ids.  Its signature is
    ``llada_hidden``'s, so samplers take it as their ``hidden_fn``
    (:func:`ring_hidden_fn`)."""
    from mmada_parallel_torch.models.llada import _norm, _rope_sin_cos
    from mmada_parallel_torch.parallel.tensor import (local_embedding,
                                                      reduce_scatter_rows)

    check_ring_input(cfg, mesh, *input_ids.shape, attn_mask, position_ids)
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    g, n_data = shape[AXIS], shape["data"]
    B, L = input_ids.shape
    group = mesh.get_group(AXIS)
    Bl = B // n_data
    b0 = mesh.get_local_rank("data") * Bl
    cdt = cfg.compute_dtype
    x = reduce_scatter_rows(local_embedding(
        input_ids[b0:b0 + Bl], params["wte"], g, mesh.get_local_rank(AXIS)),
        1, group).to(cdt)
    if cfg.input_emb_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)
    sin, cos = _rope_sin_cos(L, cfg.head_dim, cfg.rope_theta, x.device)
    x = _stack_tp(x, params["blocks"], sin, cos, cfg, g, group, int8_payload,
                  permute)
    x = _norm(x, params["ln_f"], cfg)

    # [g, Bl, C, d] -> [Bl, L, d]: the chunks back in natural row order
    x = _gather_rows(x, group).transpose(0, 1).reshape(Bl, L, -1)
    if n_data > 1:
        x = _gather_rows(x, mesh.get_group("data")).reshape(B, L, -1)
    return x


def ring_hidden_fn(mesh, int8_payload: bool = False, permute=None):
    """A drop-in ``hidden_fn`` for the samplers (``generate_ti2ti``,
    ``interleave_generate``, :class:`~mmada_parallel_torch.serving.
    TI2TIServer`): the ring backbone bound to ``mesh``, with
    ``llada_hidden``'s signature.  Its ``mesh`` attribute tells a server
    that every rank of the mesh must make the same calls.

    ``int8_payload=True`` is the opt-in quantized-collective mode (the
    all-gather halves travel as per-token int8); the exact ring stays the
    parity default."""
    def fn(params, cfg, input_ids, attn_mask=None, position_ids=None):
        return llada_hidden_tp_overlap(params, cfg, input_ids, mesh,
                                       attn_mask, position_ids,
                                       int8_payload=int8_payload,
                                       permute=permute)
    fn.mesh = mesh
    fn.check = lambda cfg, batch, length: check_ring_input(cfg, mesh, batch,
                                                           length)
    return fn


def llada_forward_tp_overlap(
    params: Dict[str, Any],
    cfg,
    input_ids: torch.Tensor,
    mesh,
    vocab_slice: Optional[Tuple[int, int]] = None,
    logits_dtype: Any = torch.float32,
    int8_payload: bool = False,
) -> torch.Tensor:
    """Full forward: the ring backbone, then the vocab-parallel head on the
    gathered hidden states, as JAX's head runs on the vocab-sharded
    ``head``: each rank projects its vocab blocks and the logits are
    gathered over ``tensor`` (the gather's backward keeps this rank's
    block, the hidden state's sums the blocks' gradients)."""
    from mmada_parallel_torch.models.llada import (llada_head,
                                                   param_shardings)
    from mmada_parallel_torch.parallel.tensor import MeshGather

    hidden = llada_hidden_tp_overlap(params, cfg, input_ids, mesh,
                                     int8_payload=int8_payload)
    return llada_head(params, cfg, hidden, vocab_slice, logits_dtype,
                      gather=MeshGather(mesh, param_shardings(cfg), cfg))
