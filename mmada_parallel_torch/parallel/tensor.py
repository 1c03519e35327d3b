"""Megatron tensor parallelism over the mesh's ``tensor`` axis: the
collectives GSPMD inserts for the ``tensor`` entries of
:func:`~mmada_parallel_torch.models.llada.param_shardings`, written out.

JAX runs ``llada_forward`` unchanged on parameters placed by their specs and
lets the compiler partition it.  SPMD PyTorch computes on each rank's slices,
so the forwards of :mod:`mmada_parallel_torch.models.llada` take a parameter
hook (their ``gather=``, or the mesh that :func:`~mmada_parallel_torch.
parallel.mesh.shard_params` leaves on the tree) and, through its ``tp``
attribute (a :class:`TensorPlan`), compute on ``g`` ranks:

* column-parallel ``q_proj``, ``k_proj``, ``v_proj``, ``ff_proj``,
  ``up_proj`` (``P(None, fs, tp)``): the rank's ``H/g`` q heads, ``KV/g`` kv
  heads and ``mlp/g`` hidden, its input through :class:`_CopyToTensor`
  (identity forward, all-reduce backward);
* row-parallel ``attn_out`` and ``ff_out`` (``P(None, tp, fs)``): a partial
  product, then :class:`_ReduceFromTensor` (all-reduce forward, identity
  backward).  A W8A8 leaf first takes the per-token amax over the whole K
  (an all-reduce max), as GSPMD's logical ``max|x|`` does, and sums its
  int32 accumulators, so its numbers are the unsharded product's;
* the vocab-parallel embedding (``wte`` ``P(tp, fs)``): ids clamped to the
  global vocab, rows outside the rank's range zeroed, an all-reduce;
* the vocab-parallel head (``head`` ``P(None, (fs, tp))``, or the tied
  ``wte``): logits of the rank's vocab blocks met with ``vocab_slice``,
  gathered over ``tensor`` into whole logits on every rank; the gather's
  backward takes the rank's own slice (every rank computes the same loss
  from them), and the head's input goes through :class:`_CopyToTensor`.

Where the contiguous column split is not a split into heads or gates -- the
``sequential`` block's fused ``att_proj`` (rank 0 of 2 would hold q and
half of k), SwiGLU's ``chunk(2)`` of ``ff_proj``, head counts that ``g``
does not divide -- :class:`MeshGather` gathers that half's leaves over
``tensor`` (:class:`_GatherTensor`, whose backward takes the rank's own
slice) and every rank computes it whole, which gives GSPMD's numbers.

Norms stay whole: their gradients are complete on every ``tensor`` rank,
so the sharded train step sums a leaf over ``data`` x ``fsdp`` only
(``training/trainer.py``).  Collectives go through ``parallel/fsdp.py``'s
``all_reduce_`` / ``all_gather_dim``, so gloo stages CUDA tensors through
host memory.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mmada_parallel_torch.parallel.fsdp import (FsdpGather, _timed,
                                                all_gather_dim, all_reduce_,
                                                reduce_scatter_dim)

__all__ = ["MeshGather", "TensorPlan", "vocab_pieces", "local_embedding",
           "reduce_scatter_rows"]

AXIS = "tensor"

# a block's leaves by half: a half computed whole gathers all of its own
_ATTN = frozenset({"q_proj", "k_proj", "v_proj", "q_bias", "k_bias", "v_bias",
                   "att_proj", "att_proj_bias", "attn_out"})
_MLP = frozenset({"ff_proj", "up_proj", "ff_out"})


def _copy(t: torch.Tensor) -> torch.Tensor:
    return t.clone(memory_format=torch.contiguous_format)


class _CopyToTensor(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``tensor``
    (each rank's column block gives a part of its input's gradient)."""

    @staticmethod
    def forward(ctx, x, group, tally):
        ctx.group, ctx.tally = group, tally
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (_timed(ctx.tally, "reduced", g,
                       lambda: all_reduce_(_copy(g), ctx.group)),
                None, None)


class _ReduceFromTensor(torch.autograd.Function):
    """All-reduce (sum) over ``tensor`` forward; identity backward (the
    sum's gradient is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, group, tally):
        return _timed(tally, "reduced", x,
                      lambda: all_reduce_(_copy(x), group))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherTensor(torch.autograd.Function):
    """All-gather along ``dim`` over ``tensor``.  Every rank goes on with
    the same gathered tensor and the same computation, so its gradient is
    already whole: the backward takes this rank's own block (a
    reduce-scatter would count it ``g`` times)."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, tally):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return _timed(tally, "gathered", x,
                      lambda: all_gather_dim(x, dim, group))

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None,
                None, None)


class _ReduceScatterRows(torch.autograd.Function):
    """Reduce-scatter (sum) along ``dim`` over ``tensor``; the backward
    all-gathers the gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g.contiguous(), ctx.dim, ctx.group), None, None


def reduce_scatter_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's sum of ``x`` (the
    ring's vocab-parallel embedding: each rank embeds the whole sequence
    in its vocab range and keeps its chunk of the sum)."""
    return _ReduceScatterRows.apply(x, dim, group)


def vocab_pieces(vocab: int, g: int, blocks: int,
                 vocab_slice: Optional[Tuple[int, int]] = None
                 ) -> List[List[Tuple[int, int, int]]]:
    """The columns each ``tensor`` rank projects, as ``pieces[t] = [(lo,
    hi, at), ...]``: local head columns ``[lo, hi)`` that are vocab
    ``[at, at + hi - lo)``.  The vocab splits into ``g * blocks`` equal
    blocks; block ``b`` lies on rank ``b % g`` as its local block ``b //
    g`` (``blocks > 1``: the head's ``(fsdp, tensor)`` split gathered over
    ``fsdp``).  Only the part of each block inside ``vocab_slice = (start,
    size)`` is kept."""
    start, size = vocab_slice if vocab_slice is not None else (0, vocab)
    blk = vocab // (g * blocks)
    pieces: List[List[Tuple[int, int, int]]] = [[] for _ in range(g)]
    for b in range(g * blocks):
        lo, hi = max(b * blk, start), min((b + 1) * blk, start + size)
        if lo < hi:
            off = (b // g) * blk - b * blk
            pieces[b % g].append((lo + off, hi + off, lo))
    return pieces


class TensorPlan:
    """How one forward computes on this rank's ``tensor`` slices (the
    ``tp`` of :class:`MeshGather`): the local head counts, which block
    halves run split, and the collectives of the split halves, the
    embedding and the head.  ``tally`` adds each all-reduce's bytes and
    seconds under ``reduced`` and each gather's under ``gathered``."""

    def __init__(self, mesh, cfg, tally: Optional[dict] = None):
        self.group = mesh.get_group(AXIS)
        self.g = dict(zip(mesh.mesh_dim_names, mesh.shape))[AXIS]
        self.rank = mesh.get_local_rank(AXIS)
        self.tally = tally
        # a half runs split where its column blocks are heads or hidden
        # units: separate q/k/v with both head counts divisible by g, and
        # any MLP but SwiGLU's fused ff_proj (its chunk(2) halves)
        self.attn_local = (cfg.block_type == "llama"
                           and cfg.n_heads % self.g == 0
                           and cfg.effective_n_kv_heads % self.g == 0)
        self.mlp_local = not (cfg.block_type == "sequential"
                              and cfg.activation_type == "swiglu")
        self.n_heads = cfg.n_heads // (self.g if self.attn_local else 1)
        self.n_kv_heads = cfg.effective_n_kv_heads // (
            self.g if self.attn_local else 1)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel product."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _CopyToTensor.apply(x, self.group, self.tally)
        return x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ``tensor`` of each rank's partial ``x``."""
        if torch.is_grad_enabled() and x.requires_grad:
            return _ReduceFromTensor.apply(x, self.group, self.tally)
        return self._all_reduce(_copy(x))

    def _all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` all-reduced in place over ``tensor`` (``"sum"`` or
        ``"max"``), counted in the tally; no gradient."""
        o = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        return _timed(self.tally, "reduced", t,
                      lambda: all_reduce_(t, self.group, o))

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` gathered along ``dim``; for a computation every rank runs
        whole (the backward keeps this rank's block)."""
        return _GatherTensor.apply(x, dim, self.group, self.rank,
                                   self.tally)

    def row(self, x: torch.Tensor, w: Any) -> torch.Tensor:
        """Row-parallel ``x @ w``: this rank's K block of the product,
        summed over ``tensor``.  A W8A8 ``w`` quantizes ``x`` per token by
        its amax over the whole K (all-reduced max) and sums the int32
        accumulators before the rescale."""
        if isinstance(w, dict):
            from mmada_parallel_torch.ops.quant import int8_matmul
            return int8_matmul(x, w["w_q"], w["scale"],
                               reduce=self._all_reduce)
        return self.reduce(x @ w.to(x.dtype))

    def embed(self, ids: torch.Tensor, wte: torch.Tensor) -> torch.Tensor:
        """The vocab-parallel embedding of ``ids`` (any shape) against this
        rank's ``[V/g, d]`` rows, summed over ``tensor``: ids clamped to
        the global vocab first (JAX's ``mode="clip"``)."""
        return self.reduce(local_embedding(ids, wte, self.g, self.rank))

    def head(self, hidden: torch.Tensor, head: Any, blocks: int,
             vocab_slice: Optional[Tuple[int, int]],
             project: Callable[[torch.Tensor, Any, int, int], torch.Tensor]
             ) -> torch.Tensor:
        """Whole logits on every rank from this rank's head columns:
        ``project(h, head, lo, hi)`` gives the logits of local columns
        ``[lo, hi)``; the pieces of :func:`vocab_pieces` are padded to one
        width, gathered over ``tensor`` and laid out in vocab order.  Where
        a gradient is recorded ``h`` is ``hidden``'s f32 copy, so the
        vocab blocks' gradients of it sum over ``tensor`` in f32 and round
        to ``hidden``'s dtype once, as the whole head's product does."""
        width = (head["w_q"] if isinstance(head, dict) else head).shape[-1]
        pieces = vocab_pieces(width * self.g, self.g, blocks, vocab_slice)
        h = hidden
        if torch.is_grad_enabled() and hidden.requires_grad:
            h = self.copy(hidden.float())
        mine = [project(h, head, lo, hi) for lo, hi, _ in pieces[self.rank]]
        # no column here: one column's logits cut to width 0 keep h in the
        # graph (its copy's backward, a collective, runs on every rank)
        local = torch.cat(mine or [project(h, head, 0, 1)[..., :0]], dim=-1)
        widths = [sum(hi - lo for lo, hi, _ in p) for p in pieces]
        local = F.pad(local, (0, max(widths) - local.shape[-1]))
        every = self.gather(local.unsqueeze(0), 0)
        placed = []
        for t, own in enumerate(pieces):
            col = 0
            for lo, hi, at in own:
                placed.append((at, t, col, hi - lo))
                col += hi - lo
        return torch.cat([every[t, ..., col:col + n]
                          for _, t, col, n in sorted(placed)], dim=-1)


def local_embedding(ids: torch.Tensor, wte: torch.Tensor, g: int,
                    rank: int) -> torch.Tensor:
    """This rank's part of the vocab-parallel embedding: the rows of
    ``ids`` (clamped to the global ``g * V/g`` vocab) that fall in its
    range, zeros elsewhere."""
    n = wte.shape[0]
    ids = ids.long().clamp(0, g * n - 1) - rank * n
    inside = (ids >= 0) & (ids < n)
    x = F.embedding(ids.clamp(0, n - 1), wte)
    return x * inside.unsqueeze(-1).to(x.dtype)


class MeshGather(FsdpGather):
    """The forwards' parameter hook over ``(data, fsdp, tensor)``: the
    ``fsdp`` gathers of :class:`~mmada_parallel_torch.parallel.fsdp.
    FsdpGather`, and with ``tensor > 1`` its :class:`TensorPlan` as ``tp``.
    A block half that does not run split (``tp.attn_local``,
    ``tp.mlp_local``) gets its leaves gathered over ``tensor`` too;
    every other leaf keeps its ``tensor`` slice.  ``cfg`` is the model's
    config, ``specs`` the tree's spec tree."""

    def __init__(self, mesh, specs: Dict[str, Any], cfg,
                 tally: Optional[dict] = None):
        super().__init__(mesh, specs, tally)
        g = dict(zip(mesh.mesh_dim_names, mesh.shape))[AXIS]
        self.tp = TensorPlan(mesh, cfg, tally) if g > 1 else None
        whole = set()
        if self.tp is not None:
            whole |= set() if self.tp.attn_local else _ATTN
            whole |= set() if self.tp.mlp_local else _MLP
        self._whole = whole

    def head_blocks(self, name: str) -> int:
        """Vocab blocks this rank's head holds once gathered over ``fsdp``
        (:func:`vocab_pieces`' ``blocks``)."""
        spec = self.specs[name]
        spec = spec["w_q"] if isinstance(spec, dict) else spec
        entry = spec[0 if name == "wte" else -1]
        if isinstance(entry, tuple) and entry[0] == "fsdp":
            return self.n
        return 1

    def _over_tensor(self, x: Any, spec: Any, stacked: bool) -> Any:
        if isinstance(x, dict):
            return {k: self._over_tensor(v, spec[k], stacked)
                    for k, v in x.items()}
        for dim, entry in enumerate(spec):
            if entry == AXIS:
                return self.tp.gather(x, dim - stacked)
        return x

    def __call__(self, name: str, x: Any) -> Any:
        out = super().__call__(name, x)
        if name != "blocks" or not self._whole:
            return out
        spec = self.specs["blocks"]
        return {k: (self._over_tensor(t, spec[k], True) if k in self._whole
                    else t) for k, t in out.items()}
