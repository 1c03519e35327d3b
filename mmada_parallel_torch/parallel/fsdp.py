"""FSDP on ``torch.distributed``, written out: the collectives that GSPMD
inserts for the JAX package's ``fsdp`` mesh axis.

JAX places a parameter with its ``PartitionSpec`` and lets the compiler
all-gather it before use and reduce-scatter its gradient.  SPMD PyTorch has
no such compiler, so this module does it by hand:

* :class:`FsdpGather` is the per-layer parameter hook of
  :func:`~mmada_parallel_torch.models.llada.llada_hidden`: it all-gathers a
  leaf's ``fsdp``-sharded dimension (the dimension its spec names: 1 or 2 of
  the stacked blocks, a layer's 0 or 1) through :class:`_AllGather`, whose
  backward reduce-scatters the gradient with a sum.  Under ``remat`` the
  recompute gathers again, as FSDP does.
* :func:`all_reduce_`, :func:`all_gather_dim` and :func:`reduce_scatter_dim`
  are the collectives of the sharded train step
  (:func:`~mmada_parallel_torch.training.trainer.make_sharded_train_step`).

A CUDA tensor on a gloo group travels through host memory
(``tp_overlap._host_staged``), so ranks that share one card can run it.

The parameters stay a functional dict laid out as JAX's ``shard_params``
lays them out, which ``torch.distributed.fsdp.fully_shard`` (dimension 0 of
``nn.Module`` parameters) would not keep.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from mmada_parallel_torch.parallel.tp_overlap import _host_staged

__all__ = ["FsdpGather", "all_reduce_", "all_gather_dim",
           "reduce_scatter_dim", "fsdp_dim", "whole_params"]

AXIS = "fsdp"


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    return (t.to("cpu", memory_format=torch.contiguous_format)
            if _host_staged(group, t) else t.contiguous())


def all_reduce_(t: torch.Tensor, group,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` over ``group`` in place (and return it): a sum, or
    ``op``."""
    src = _staged(t, group)
    dist.all_reduce(src, op=op, group=group)
    if src is not t:
        t.copy_(src)
    return t


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim``, in group-rank order."""
    n = dist.get_world_size(group)
    src = _staged(t.movedim(dim, 0), group)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, dim)


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's sum of ``t``."""
    n = dist.get_world_size(group)
    src = _staged(t.movedim(dim, 0), group)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, dim).contiguous()


def fsdp_dim(spec) -> Optional[int]:
    """The dimension ``spec`` splits over ``fsdp``, or None.  An entry that
    names ``fsdp`` before other axes (the untied head's ``(fsdp, tensor)``)
    is taken too: gathering it over ``fsdp`` gives this rank the blocks of
    its coordinates on the other axes, one per ``fsdp`` rank, in ``fsdp``
    order (:func:`~mmada_parallel_torch.parallel.tensor.vocab_pieces` reads
    the head so)."""
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if AXIS not in names:
            continue
        if names[0] != AXIS:
            raise ValueError(f"{spec}: fsdp must be the major axis of "
                             f"{names}")
        return dim
    return None


class _AllGather(torch.autograd.Function):
    """Forward: all-gather ``shard`` along ``dim`` over ``group``.
    Backward: reduce-scatter the gradient with a sum, so each rank's shard
    receives the whole group's gradient of its block."""

    @staticmethod
    def forward(ctx, shard, dim, group, tally):
        ctx.dim, ctx.group, ctx.tally = dim, group, tally
        return _timed(tally, "gathered", shard,
                      lambda: all_gather_dim(shard, dim, group))

    @staticmethod
    def backward(ctx, g):
        return (_timed(ctx.tally, "scattered", g,
                       lambda: reduce_scatter_dim(g, ctx.dim, ctx.group)),
                None, None, None)


def _timed(tally, key: str, t: torch.Tensor, fn):
    """Run one collective; with a ``tally`` dict add the bytes it moved
    (``gathered``: this rank's result; ``scattered`` and ``reduced``: its
    input) under ``key`` and its seconds under ``seconds`` and
    ``{key}_seconds``, synchronizing the card around it."""
    if tally is None:
        return fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    out = fn()
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    dt = time.perf_counter() - t0
    tally["seconds"] = tally.get("seconds", 0.0) + dt
    tally[f"{key}_seconds"] = tally.get(f"{key}_seconds", 0.0) + dt
    moved = out if key == "gathered" else t
    tally[key] = tally.get(key, 0) + moved.numel() * moved.element_size()
    return out


class FsdpGather:
    """The parameter hook of ``llada_hidden`` / ``llada_forward`` (their
    ``gather=``): ``gather(name, x)`` gives the ``wte``, ``ln_f`` or
    ``head`` leaf for ``x`` its ``fsdp`` shard gathered over ``fsdp``, or,
    with ``name == "blocks"``, one layer's dict (``_layer(blocks, i)``)
    gathered leaf by leaf (a W8A8 leaf's ``w_q`` and ``scale`` each by its
    own spec).  ``specs`` is the parameters' spec tree
    (``param_shardings(cfg)``, or ``drop_axis`` of it for ZeRO-2);
    ``tally``, where given, counts bytes and seconds (:func:`_timed`).
    Over a ``tensor`` axis of more than one rank use its subclass
    :class:`~mmada_parallel_torch.parallel.tensor.MeshGather`."""

    def __init__(self, mesh, specs: Dict[str, Any],
                 tally: Optional[dict] = None):
        self.mesh, self.specs, self.tally = mesh, specs, tally
        self.group = mesh.get_group(AXIS)
        self.n = dict(zip(mesh.mesh_dim_names, mesh.shape))[AXIS]

    def _gather(self, x: Any, spec: Any, stacked: bool) -> Any:
        """``x`` gathered over ``fsdp`` by ``spec``; ``stacked``: ``x`` is
        one layer's leaf, whose spec still names the layer dimension."""
        if isinstance(x, dict):
            return {k: self._gather(v, spec[k], stacked)
                    for k, v in x.items()}
        dim = fsdp_dim(spec)
        if dim is None or self.n == 1:
            return x
        return _AllGather.apply(x, dim - stacked, self.group, self.tally)

    def __call__(self, name: str, x: Any) -> Any:
        if name == "blocks":
            return {k: self._gather(t, self.specs["blocks"][k], True)
                    for k, t in x.items()}
        return self._gather(x, self.specs[name], False)


@torch.no_grad()
def whole_params(params: Any, specs: Any, mesh) -> Any:
    """Every leaf of this rank's slices gathered whole over every axis its
    spec names, with no gradient (for work outside the train step, such as
    validation); every rank of the mesh calls it.  An entry naming several
    axes is gathered minor axis first, so the blocks land in order."""
    if isinstance(params, dict):
        return {k: whole_params(v, specs[k], mesh) for k, v in params.items()}
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for dim, entry in enumerate(specs):
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in reversed([a for a in names if a is not None]):
            if shape[name] > 1:
                params = all_gather_dim(params, dim, mesh.get_group(name))
    return params
