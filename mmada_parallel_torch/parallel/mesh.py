"""Device mesh, parameter and optimizer-state placement and distributed
start-up on ``torch.distributed``: the counterpart of
:mod:`mmada_parallel_tpu.parallel.mesh`.

One :class:`~torch.distributed.device_mesh.DeviceMesh` with the JAX axes
``(data, fsdp, tensor)`` stands for the JAX ``Mesh``.  SPMD PyTorch has no
GSPMD, so a parameter's placement is not an annotation the compiler reads:
:func:`shard_params` gives each rank its own slice of every leaf, by its
coordinates on the mesh, and keeps the mesh on the tree: the model's
forwards then compute over it (Megatron tensor parallelism over ``tensor``,
:mod:`mmada_parallel_torch.parallel.tensor`, and FSDP's gathers).  The ring
tensor parallelism of
:mod:`mmada_parallel_torch.parallel.tp_overlap` computes on those slices
with explicit point-to-point rounds on the ``tensor`` axis's process group
(``mesh.get_group("tensor")``).

The training half gives the same spec trees as JAX: :func:`batch_sharding`
(rows over ``data`` x ``fsdp``), :func:`drop_axis` (ZeRO-2's replicated
parameters), :func:`opt_state_specs` / :func:`shard_opt_state` (optimizer
state placed like its parameters).  The collectives FSDP needs are written
out in :mod:`mmada_parallel_torch.parallel.fsdp`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import sys
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

__all__ = ["AXES", "MeshConfig", "PartitionSpec", "make_mesh",
           "shard_params", "ShardedParams", "init_distributed",
           "leaves_process_group", "teardown_barrier", "replicated",
           "batch_sharding", "drop_axis", "opt_state_specs",
           "shard_opt_state", "local_rows", "dp_coordinate", "dp_groups"]

AXES = ("data", "fsdp", "tensor")


class PartitionSpec(tuple):
    """A leaf's placement, one entry per dimension: an axis name (the
    dimension is split over that mesh axis), ``None`` (kept whole), or a
    tuple of names (split over their product, the first name major), as in
    ``jax.sharding.PartitionSpec``.  ``PartitionSpec()`` keeps a leaf whole
    on every rank (JAX's ``replicated(mesh)``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh shape; -1 in ``data`` absorbs remaining devices."""

    data: int = -1
    fsdp: int = 1
    tensor: int = 1

    def resolve(self, n_devices: int) -> Dict[str, int]:
        fixed = self.fsdp * self.tensor
        data = self.data if self.data != -1 else n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{self.fsdp}x{self.tensor} != {n_devices} devices")
        return {"data": data, "fsdp": self.fsdp, "tensor": self.tensor}


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """The ``(data, fsdp, tensor)`` mesh over every rank of the default
    process group (which must be initialized: :func:`init_distributed`).
    Rank ``r`` sits at the row-major coordinates of ``r``, so the ranks of
    one ``tensor`` ring are consecutive."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = cfg.resolve(dist.get_world_size())
    return init_device_mesh(device_type, tuple(shape[a] for a in AXES),
                            mesh_dim_names=AXES)


def _local_view(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` as a view (no copy)."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n, idx = 1, 0
        for name in names:                  # the first name is major
            size = mesh.shape[mesh.mesh_dim_names.index(name)]
            n, idx = n * size, idx * size + mesh.get_local_rank(name)
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} of a {list(t.shape)} leaf does "
                             f"not split into {n} over {names}")
        step = t.shape[dim] // n
        t = t.narrow(dim, idx * step, step)
    return t


def _local_slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    v = _local_view(t, spec, mesh)
    if t.dim() >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1:
        # a column-major leaf (a W8A8 ``w_q``) stays column-major
        return v.transpose(-1, -2).clone(
            memory_format=torch.contiguous_format).transpose(-1, -2)
    return v.clone(memory_format=torch.contiguous_format)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


class ShardedParams(dict):
    """A parameter tree of this rank's slices that carries its ``mesh`` and
    ``specs``: the forwards of :mod:`mmada_parallel_torch.models.llada`
    read them when no ``gather=`` is given and compute over the mesh
    (:class:`~mmada_parallel_torch.parallel.tensor.MeshGather`), so
    samplers and servers take sharded parameters unchanged, as JAX's take
    sharded arrays.  It pickles as a plain dict."""

    def __init__(self, tree: Dict[str, Any], mesh, specs: Any):
        super().__init__(tree)
        self.mesh, self.specs = mesh, specs

    def __reduce__(self):
        return dict, (dict(self),)


def _shard(params: Any, specs: Any, mesh) -> Any:
    if isinstance(params, dict):
        return {k: _shard(v, specs[k], mesh) for k, v in params.items()}
    return _local_slice(params, specs, mesh)


def shard_params(params: Any, specs: Any, mesh) -> Any:
    """This rank's slice of every leaf of ``params`` along the axes its
    :class:`PartitionSpec` in ``specs`` names, as a :class:`ShardedParams`
    carrying ``mesh`` and ``specs``; each slice is a contiguous copy (a
    column-major leaf stays so), so the full tree can be freed."""
    if isinstance(params, dict):
        return ShardedParams(_shard(params, specs, mesh), mesh, specs)
    return _local_slice(params, specs, mesh)


def replicated(mesh=None) -> PartitionSpec:
    """A leaf kept whole on every rank."""
    return PartitionSpec()


def batch_sharding(mesh=None) -> PartitionSpec:
    """The batch dimension split over ``data`` x ``fsdp`` (data major):
    parameters shard on ``fsdp`` and rows on both data-parallel axes, so
    the ranks of one ``tensor`` ring hold the same rows."""
    return PartitionSpec(("data", "fsdp"))


def dp_coordinate(mesh) -> tuple:
    """``(index, size)`` of this rank on the data-parallel axes ``data`` x
    ``fsdp`` (data major): which share of a batch's rows it holds."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return (mesh.get_local_rank("data") * shape["fsdp"]
            + mesh.get_local_rank("fsdp"), shape["data"] * shape["fsdp"])


def dp_groups(mesh) -> list:
    """The process groups of the data-parallel axes with more than one
    rank, data first: what a loss's global denominators sum over (never
    ``tensor``, whose ranks hold the same rows)."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return [mesh.get_group(a) for a in ("data", "fsdp") if shape[a] > 1]


def local_rows(batch: Any, mesh, accum_steps: int = 1) -> Any:
    """This rank's rows of a global batch under :func:`batch_sharding`:
    each of the ``accum_steps`` microbatches (the leading dim is
    ``accum_steps * microbatch``) split over ``data`` x ``fsdp``, and the
    rank's shares of the microbatches stacked again in order."""
    idx, n = dp_coordinate(mesh)

    def rows(x):
        if not isinstance(x, torch.Tensor):
            return x
        mb = x.reshape((accum_steps, -1) + tuple(x.shape[1:]))
        if mb.shape[1] % n:
            raise ValueError(f"a microbatch of {mb.shape[1]} rows does not "
                             f"split over {n} data-parallel ranks")
        step = mb.shape[1] // n
        return mb[:, idx * step:(idx + 1) * step].reshape(
            (-1,) + tuple(x.shape[1:]))

    if isinstance(batch, (tuple, list)):
        return type(batch)(rows(x) for x in batch)
    if isinstance(batch, dict):
        return {k: rows(v) for k, v in batch.items()}
    return rows(batch)


def drop_axis(specs: Any, axis: str) -> Any:
    """``axis`` replaced by ``None`` in every :class:`PartitionSpec` (ZeRO-2:
    parameters whole over ``fsdp`` while the optimizer state keeps the
    original specs).  As in JAX, an entry naming several axes is kept."""
    return _map_specs(lambda s: PartitionSpec(
        *(None if a == axis else a for a in s)), specs)


def _same_structure(a: Any, b: Any) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_same_structure(a[k], b[k])
                                        for k in a)
    return not isinstance(a, dict) and not isinstance(b, dict)


def opt_state_specs(opt_state: Any, params: Any, param_specs: Any) -> Any:
    """The :class:`PartitionSpec` tree of an optimizer state: subtrees
    shaped like ``params`` (AdamW's ``mu``/``nu``, Lion's ``mu``) get
    ``param_specs``; every other leaf (the update count) is whole."""
    if isinstance(opt_state, dict):
        if _same_structure(opt_state, params) and isinstance(params, dict):
            return param_specs
        return {k: opt_state_specs(v, params, param_specs)
                for k, v in opt_state.items()}
    return PartitionSpec()


def shard_opt_state(opt_state: Any, params: Any, param_specs: Any,
                    mesh) -> Any:
    """This rank's slice of every tensor of a whole optimizer state, per
    :func:`opt_state_specs`; other leaves pass through."""
    specs = opt_state_specs(opt_state, params, param_specs)

    def cut(x, s):
        if isinstance(x, dict):
            return {k: cut(v, s[k]) for k, v in x.items()}
        return _local_slice(x, s, mesh) if isinstance(x, torch.Tensor) else x
    return cut(opt_state, specs)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Start the default process group (replaces ``xllm/util/dist.py:33-85``).

    With no ``coordinator`` the rendezvous comes from the environment
    ``torchrun`` sets (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``); without
    it the run stays single-process.  Otherwise ``coordinator`` is an
    explicit ``tcp://host:port`` or ``file://path`` rendezvous of
    ``num_processes`` ranks, and a failure raises.  ``backend`` defaults to
    ``nccl`` where the process sees a CUDA device and ``gloo`` elsewhere.
    Safe to call when already initialized."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is None:
        if "MASTER_ADDR" not in os.environ or "RANK" not in os.environ:
            return          # no launcher environment: single-process
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=coordinator,
                                world_size=num_processes, rank=process_id)


def teardown_barrier(backend: str, deadline: float) -> None:
    """Wait for every rank of the default group, at most until
    ``deadline`` (``time.time()``); on gloo ``monitored_barrier`` names the
    ranks that never came."""
    if backend == "gloo":
        left = max(deadline - time.time(), 1.0)
        dist.monitored_barrier(timeout=datetime.timedelta(seconds=left))
    else:
        dist.barrier()


@contextlib.contextmanager
def leaves_process_group(timeout: float = 300.0):
    """Run the with-block; if the default process group was formed inside
    it (the CLIs' :func:`init_distributed` under torchrun), leave it on the
    way out, also when the block raised: the rank waits for its peers at
    :func:`teardown_barrier` (at most ``timeout`` s; a peer that never
    comes is reported on stderr) and then calls
    ``destroy_process_group()``.  A rank that raised skips the barrier (its
    peers meet the deadline, or its closed sockets) and only destroys the
    group.  A rank that exits with the group alive can abort
    in gloo's teardown while a peer still talks to it."""
    formed_before = dist.is_initialized()
    ok = False
    try:
        yield
        ok = True
    finally:
        if not formed_before and dist.is_initialized():
            try:
                if ok:
                    teardown_barrier(dist.get_backend(),
                                     time.time() + timeout)
            except RuntimeError as e:
                sys.stderr.write(f"rank {dist.get_rank()}: a peer never "
                                 f"reached the teardown barrier: "
                                 f"{str(e)[:200]}\n")
            finally:
                dist.destroy_process_group()
