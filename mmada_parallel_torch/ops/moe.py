"""Mixture-of-experts MLP: the router, the sort by expert, the grouped GEMM
(CUDA kernel wrapper) and the combine.

The JAX package has no mixture of experts; this is the layer of Qwen3-MoE's
block as SDAR-30B-A3B runs it (``models/llada.py`` calls :func:`moe_mlp`
where ``LLaDAConfig.n_experts > 0``)::

    p = softmax_f32(h @ router)       # [T, E], the product summed in f32
    w, e = top_k(p)                   # renormalised to sum 1 where
                                      # norm_topk_prob, then cast to h's
                                      # dtype, as Qwen3-MoE's modeling does
    out = sum_j w_j * down[e_j](silu(h @ gate[e_j]) * (h @ up[e_j]))

On a CUDA tensor the experts run as two grouped launches of the
hand-written kernel ``csrc/moe_grouped_gemm.cu`` (:func:`grouped_gemm`):
the ``T * top_k`` assignments are sorted by expert on the device
(:func:`plan`: a stable sort, each expert's first slot and first row tile),
one launch computes gate and up of every expert that has rows with the
SwiGLU product as its epilogue, one the down product scaled by the routing
weight, written at the assignment's own row; the combine sums each token's
``top_k`` rows in f32 in slot order and rounds once.  Nothing syncs with
the host: the grid is sized from the shapes alone.  On a CPU tensor the
layer runs the plain loop over experts (:func:`experts_reference`), which
the tests hold the grouped path to.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from mmada_parallel_torch.utils.spans import count, recording, span

__all__ = ["route", "plan", "grouped_gemm", "grouped_gemm_reference",
           "experts_reference", "moe_mlp", "count_experts"]

# rows of a tile: the kernel's small tiles where the experts average at most
# SMALL_ROWS_MAX rows (decode), its large ones otherwise (prefill)
SMALL_TILE, LARGE_TILE, SMALL_ROWS_MAX = 16, 128, 32
# output columns of a tile (the kernel's BN): small, large glu, large down
_TILE_N = {(True, True): 64, (True, False): 64, (False, True): 64,
           (False, False): 128}
_K_STEP = 64
# a device tally of the experts the layers touch, set by a CUDA graph's
# runner while it captures a forward (``samplers/mmu.DecodeGraphs``): each
# ``moe_mlp`` of the forward adds its count, so every replay counts again
TALLY: Optional[torch.Tensor] = None


class Plan(NamedTuple):
    rows: torch.Tensor       # int32 [A]: sorted slot -> assignment t*k + j
    offsets: torch.Tensor    # int32 [E + 1]: each expert's first slot
    tiles: torch.Tensor      # int32 [E + 1]: each expert's first row tile
    counts: torch.Tensor     # int64 [E]: rows of each expert
    tile_rows: int           # rows of a tile
    tile_bound: int          # row tiles the grid covers, >= tiles[E]


def route(h: torch.Tensor, router: torch.Tensor, top_k: int,
          norm_topk_prob: bool):
    """``h [T, d] -> (weights [T, k] in h's dtype, experts [T, k] int64)``.
    The router product sums in f32 (bf16 operands on a card, as the
    vocab head's ``_Bf16Head``), the softmax is f32; the top ``k``
    probabilities, in descending order, renormalised to sum 1 where
    ``norm_topk_prob``."""
    if h.is_cuda and h.dtype == torch.bfloat16:
        logits = torch.mm(h, router.to(torch.bfloat16),
                          out_dtype=torch.float32)
    else:
        logits = h.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, top_k, dim=-1)
    if norm_topk_prob:
        w = w / w.sum(dim=-1, keepdim=True)
    return w.to(h.dtype), ids


def plan(ids: torch.Tensor, n_experts: int, tile_rows: int) -> Plan:
    """The assignments ``ids [T, k]`` sorted by expert, on their device and
    with no host sync: slot ``s`` of expert ``e`` lies in ``[offsets[e],
    offsets[e + 1])``, its row tiles of ``tile_rows`` in ``[tiles[e],
    tiles[e + 1])``.  The sort is stable, so an expert's rows keep token
    order."""
    flat = ids.reshape(-1)
    A = flat.numel()
    order = torch.argsort(flat, stable=True)
    edges = torch.arange(n_experts + 1, device=flat.device)
    offsets = torch.searchsorted(flat[order], edges)
    counts = offsets[1:] - offsets[:-1]
    tiles = torch.zeros(n_experts + 1, dtype=torch.long, device=flat.device)
    tiles[1:] = torch.cumsum((counts + tile_rows - 1) // tile_rows, 0)
    bound = math.ceil(A / tile_rows) + min(n_experts, A)
    return Plan(order.int(), offsets.int(), tiles.int(), counts, tile_rows,
                bound)


def grouped_gemm_reference(a: torch.Tensor, p: Plan, w0: torch.Tensor,
                           w1: Optional[torch.Tensor] = None,
                           scale: Optional[torch.Tensor] = None, *,
                           top_k: int, glu: bool) -> torch.Tensor:
    """Plain PyTorch version of :func:`grouped_gemm`, same arguments, any
    device: the products of each expert's slots in f32.  ``glu``: ``out[s]
    = silu(a[rows[s] // top_k] @ w0[e]) * (a[...] @ w1[e])`` in ``a``'s
    dtype, in sorted order; else ``out[rows[s]] = scale[rows[s]] * (a[s] @
    w0[e])`` in f32, at the assignment's row."""
    rows = p.rows.long()
    off = p.offsets.tolist()
    A, N = rows.numel(), w0.shape[-1]
    out = (torch.empty(A, N, dtype=a.dtype, device=a.device) if glu
           else torch.zeros(A, N, dtype=torch.float32, device=a.device))
    for e in range(len(off) - 1):
        sl = slice(off[e], off[e + 1])
        if sl.start == sl.stop:
            continue
        r = rows[sl]
        if glu:
            x = a[r // top_k].float()
            out[sl] = (F.silu(x @ w0[e].float())
                       * (x @ w1[e].float())).to(a.dtype)
        else:
            out[r] = scale[r].float()[:, None] * (a[sl].float()
                                                  @ w0[e].float())
    return out


def grouped_gemm(a: torch.Tensor, p: Plan, w0: torch.Tensor,
                 w1: Optional[torch.Tensor] = None,
                 scale: Optional[torch.Tensor] = None, *, top_k: int,
                 glu: bool) -> torch.Tensor:
    """One grouped launch over every expert with rows (``csrc/
    moe_grouped_gemm.cu``).  ``glu``: ``a`` is the tokens ``[T, K]``,
    gathered through the plan's assignments, ``w0``/``w1`` gate and up
    ``[E, K, N]``; returns ``h [A, N]`` bf16 in sorted order.  Else ``a``
    is ``h [A, K]`` in sorted order, ``w0`` down ``[E, K, N]``, ``scale``
    the ``[A]`` routing weights by assignment; returns ``[A, N]`` f32 by
    assignment.  A CPU tensor runs :func:`grouped_gemm_reference`; a CUDA
    one launches the kernel (bf16, K a multiple of 64, N of the tile's 64
    or 128) or raises.  ``grouped_gemm.launches`` counts the launches the
    host made: a call recorded into a CUDA graph launches nothing, and the
    graph's replays go uncounted."""
    if a.device.type == "cpu":
        return grouped_gemm_reference(a, p, w0, w1, scale, top_k=top_k,
                                      glu=glu)
    from mmada_parallel_torch.ops import _cuda
    from mmada_parallel_torch.ops.rope_attention import check_aligned
    E, K, N = w0.shape
    small = p.tile_rows == SMALL_TILE
    if p.tile_rows not in (SMALL_TILE, LARGE_TILE):
        raise ValueError(f"tiles of {p.tile_rows} rows: the kernel takes "
                         f"{SMALL_TILE} or {LARGE_TILE}")
    bn = _TILE_N[(small, glu)]
    ws = (w0, w1) if glu else (w0,)
    if (a.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16
                                         or not w.is_contiguous()
                                         or w.shape != (E, K, N)
                                         for w in ws)
            or a.shape[-1] != K or not a.is_contiguous()):
        raise ValueError(f"grouped_gemm takes contiguous bf16 a [*, {K}] "
                         f"and weights [E, K, N], got {a.dtype} "
                         f"{list(a.shape)}, {[list(w.shape) for w in ws]}")
    if K % _K_STEP or N % bn:
        raise ValueError(f"grouped_gemm needs K % {_K_STEP} == 0 and N % "
                         f"{bn} == 0, got K={K}, N={N}")
    if p.tile_bound > 65535:
        raise ValueError(f"{p.tile_bound} row tiles: more than a grid's "
                         f"65535")
    check_aligned("grouped_gemm", 16, a, *ws)
    A = p.rows.numel()
    if glu:
        out = torch.empty(A, N, dtype=torch.bfloat16, device=a.device)
    else:
        if scale is None or scale.shape != (A,):
            raise ValueError(f"the down launch needs scale [{A}]")
        scale = scale.float().contiguous()
        out = torch.empty(A, N, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _cuda.library().mmada_moe_grouped_gemm(
            a.data_ptr(), p.rows.data_ptr(), p.offsets.data_ptr(),
            p.tiles.data_ptr(), w0.data_ptr(),
            w1.data_ptr() if glu else None,
            scale.data_ptr() if not glu else None, out.data_ptr(), E, K, N,
            top_k, p.tile_bound, int(glu), int(small),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe grouped_gemm CUDA launch failed: "
                           f"cudaError_t {err}")
    if not torch.cuda.is_current_stream_capturing():
        grouped_gemm.launches += 1
    return out


grouped_gemm.launches = 0


def experts_reference(h: torch.Tensor, weights: torch.Tensor,
                      ids: torch.Tensor, gate: torch.Tensor,
                      up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """The plain loop over experts, the spec of the grouped path: each
    expert's tokens through ``down(silu(gate h) * up h)`` in h's dtype,
    scaled by their routing weight and summed into the output in f32;
    returns h's dtype."""
    out = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    for e in range(gate.shape[0]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = (F.silu(x @ gate[e].to(h.dtype)) * (x @ up[e].to(h.dtype))
             ) @ down[e].to(h.dtype)
        out.index_add_(0, tok, y.float() * weights[tok, slot].float()[:, None])
    return out.to(h.dtype)


def moe_mlp(h: torch.Tensor, router: torch.Tensor, gate: torch.Tensor,
            up: torch.Tensor, down: torch.Tensor, top_k: int,
            norm_topk_prob: bool) -> torch.Tensor:
    """The MoE MLP on ``h [..., d]`` with ``router [d, E]``, ``gate``/``up``
    ``[E, d, m]`` and ``down [E, m, d]``; returns ``[..., d]`` in h's
    dtype.  Spans ``moe`` > ``moe.route``, ``moe.experts``, ``moe.combine``;
    while they record, the counters of :func:`count_experts`, the touched
    experts and the bytes summed on the device.  Where ``TALLY`` is set
    (a graph capture), it gets the touched experts too."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    T, d = x.shape
    E, _, m = gate.shape
    A = T * top_k
    with span("moe"):
        with span("moe.route"):
            weights, ids = route(x, router, top_k, norm_topk_prob)
            if x.is_cuda:
                p = plan(ids, E, SMALL_TILE if A <= SMALL_ROWS_MAX * E
                         else LARGE_TILE)
        if not x.is_cuda:
            with span("moe.experts"):
                out = experts_reference(x, weights, ids, gate, up, down)
        else:
            with span("moe.experts"):
                mid = grouped_gemm(x, p, gate, up, top_k=top_k, glu=True)
                y = grouped_gemm(mid, p, down, scale=weights.reshape(-1),
                                 top_k=top_k, glu=False)
            with span("moe.combine"):
                out = y.view(T, top_k, d).sum(dim=1).to(h.dtype)
        if TALLY is not None:
            TALLY.add_((p.counts > 0).sum())
        if recording():
            touched = ((p.counts > 0).sum() if x.is_cuda
                       else int(torch.unique(ids).numel()))
            count_experts(1, T, d, m, A, touched, x.element_size())
    return out.reshape(shape)


def count_experts(layers: int, T: int, d: int, m: int, A: int, touched,
                  elt: int = 2) -> None:
    """Add ``layers`` MoE layers of ``T`` tokens (``A`` assignments,
    ``touched`` experts over them, a number or a device tensor) to the
    counters ``moe.assignments``, ``moe.experts_touched``, ``moe.flops``
    (2 x assignments x 3 d m) and ``moe.bytes`` (the two grouped launches'
    least traffic: the touched experts' weights once, the tokens in, the
    SwiGLU rows out and in, the f32 weighted rows out)."""
    count("moe.assignments", layers * A)
    count("moe.experts_touched", touched)
    count("moe.flops", layers * 2 * A * 3 * d * m)
    count("moe.bytes", touched * (3 * d * m * elt) + layers * (
        T * d * elt + 2 * A * m * elt + A * d * 4))
