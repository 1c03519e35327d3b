"""Device mesh, parameter placement and distributed start-up on
``torch.distributed``: the serving half of
:mod:`mmada_parallel_tpu.parallel.mesh`.

One :class:`~torch.distributed.device_mesh.DeviceMesh` with the JAX axes
``(data, fsdp, tensor)`` stands for the JAX ``Mesh``.  SPMD PyTorch has no
GSPMD, so a parameter's placement is not an annotation the compiler reads:
:func:`shard_params` gives each rank its own slice of every leaf, by its
coordinates on the mesh, and the ring tensor parallelism of
:mod:`mmada_parallel_torch.parallel.tp_overlap` computes on those slices
with explicit point-to-point rounds on the ``tensor`` axis's process group
(``mesh.get_group("tensor")``).

The training half of the JAX module (the batch sharding, ZeRO's
optimizer-state specs) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

__all__ = ["AXES", "MeshConfig", "PartitionSpec", "make_mesh",
           "shard_params", "init_distributed"]

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


def _local_slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
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
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(params: Any, specs: Any, mesh) -> Any:
    """This rank's slice of every leaf of ``params`` along the axes its
    :class:`PartitionSpec` in ``specs`` names; each slice is a contiguous
    copy, so the full tree can be freed."""
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    return _local_slice(params, specs, mesh)


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
