"""Train-state checkpoints on disk.

Counterpart of :mod:`mmada_parallel_tpu.training.checkpoint` (orbax there):
the same ``save(step, state, metadata)``, ``restore(state) -> (state,
metadata, step)``, ``max_to_keep`` and ``wait()``.  Layout:
``{directory}/{step}/state.pt`` holds the :class:`TrainState` as a
``torch.save`` dict of tensors and ints (loaded with ``weights_only=True``),
``{directory}/{step}/metadata.json`` a small JSON dict (epoch, data position,
metric-logger state).  A step is written into a temporary directory and
renamed into place, so a crash never leaves a torn checkpoint behind.
Writes are synchronous, so :meth:`wait` has nothing to wait for.

Sharded (a manager given a ``mesh`` and the state's spec tree,
:func:`~mmada_parallel_torch.training.trainer.state_shardings`), as orbax
stores arrays with their sharding: every rank writes its slices to
``{step}/state.rank{r}.pt``, and ``{step}/shards.json`` records the mesh
shape, each rank's coordinates and the spec of every leaf.  All ranks write
into one temporary directory, and rank 0 renames it into place once every
rank's part is there.  :meth:`CheckpointManager.restore` rebuilds each leaf
from the saved slices and re-slices it for the mesh it is given, or keeps
it whole with none: a state saved at ``fsdp=2`` restores at ``data=2`` or
in one process, and a one-process checkpoint restores onto a mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from mmada_parallel_torch.training.trainer import TrainState

__all__ = ["CheckpointManager"]


def _restore_into(template: Any, loaded: Any) -> Any:
    """``loaded`` copied into ``template``'s tensors (keeping their device,
    dtype and ``requires_grad``); other leaves are taken from ``loaded``."""
    if isinstance(template, dict):
        if set(template) != set(loaded):
            raise ValueError(f"checkpoint keys {sorted(loaded)} do not match "
                             f"the state's {sorted(template)}")
        return {k: _restore_into(v, loaded[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore_into(t, x)
                              for t, x in zip(template, loaded))
    if isinstance(template, torch.Tensor):
        if template.shape != loaded.shape:
            raise ValueError(f"checkpoint tensor of shape "
                             f"{tuple(loaded.shape)} for a state tensor of "
                             f"shape {tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(loaded)
        return template
    return loaded


def _flat(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{"params/blocks/q_proj": leaf, ...}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _plain(tree: Any) -> Any:
    """``tree`` with every dict a plain ``dict`` (``shard_params``' tree
    carries its mesh), which ``weights_only`` loads take."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def _state_tree(state: TrainState) -> Dict[str, Any]:
    return {"params": state.params, "opt_state": state.opt_state}


def _blocks(spec, mesh_shape: Dict[str, int], coord: Dict[str, int]
            ) -> List[Tuple[int, int, int]]:
    """``(dim, block index, blocks)`` of a rank's slice under ``spec``."""
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, idx = 1, 0
        for name in (entry if isinstance(entry, (list, tuple)) else (entry,)):
            n, idx = n * mesh_shape[name], idx * mesh_shape[name] + coord[name]
        out.append((dim, idx, n))
    return out


def _whole(parts: List[torch.Tensor], spec, mesh_shape, coords):
    """A leaf rebuilt from every saved rank's slice."""
    first = parts[0]
    shape = list(first.shape)
    for dim, _, n in _blocks(spec, mesh_shape, coords[0]):
        shape[dim] *= n
    out = torch.empty(shape, dtype=first.dtype)
    for part, coord in zip(parts, coords):
        view = out
        for dim, idx, n in _blocks(spec, mesh_shape, coord):
            step = shape[dim] // n
            view = view.narrow(dim, idx * step, step)
        view.copy_(part)
    return out


def _unflat(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


class CheckpointManager:
    """``mesh`` and ``specs`` (a :class:`TrainState` of specs), where
    given, make the checkpoint sharded (module docstring); every rank of
    the mesh then calls :meth:`save` and :meth:`restore`."""

    def __init__(self, directory: str, max_to_keep: int = 2, mesh=None,
                 specs: Optional[TrainState] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.mesh, self.specs = mesh, specs
        os.makedirs(self.directory, exist_ok=True)

    def _rank(self) -> int:
        return dist.get_rank() if self.mesh is not None else 0

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             metadata: Optional[Dict[str, Any]] = None) -> bool:
        """Write ``state`` at ``step``; False (nothing written) when ``step``
        is not past the latest saved step."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        if self.mesh is not None:
            self._save_sharded(step, state, metadata)
        else:
            tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
            try:
                torch.save({"params": _plain(state.params),
                            "opt_state": _plain(state.opt_state),
                            "step": int(state.step)},
                           os.path.join(tmp, "state.pt"))
                with open(os.path.join(tmp, "metadata.json"), "w") as f:
                    json.dump(metadata or {}, f)
                os.replace(tmp, os.path.join(self.directory, str(step)))
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
        if self._rank() == 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        self._barrier()
        return True

    def _save_sharded(self, step: int, state: TrainState,
                      metadata: Optional[Dict[str, Any]]) -> None:
        mesh, rank = self.mesh, self._rank()
        tmp = os.path.join(self.directory, f".{step}.partial")
        if rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        self._barrier()
        torch.save({"tree": _flat(_state_tree(state)),
                    "step": int(state.step)},
                   os.path.join(tmp, f"state.rank{rank}.pt"))
        coord = [int(c) for c in mesh.get_coordinate()]
        coords = [None] * dist.get_world_size()
        dist.all_gather_object(coords, coord)
        if rank == 0:
            specs = {k: [list(e) if isinstance(e, tuple) else e for e in s]
                     for k, s in _flat(_state_tree(self.specs)).items()}
            with open(os.path.join(tmp, "shards.json"), "w") as f:
                json.dump({"mesh": dict(zip(mesh.mesh_dim_names,
                                            map(int, mesh.shape))),
                           "names": list(mesh.mesh_dim_names),
                           "coords": coords, "specs": specs}, f)
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump(metadata or {}, f)
        self._barrier()             # every rank's part is in place
        if rank == 0:
            os.replace(tmp, os.path.join(self.directory, str(step)))

    def _load(self, d: str, cut) -> Tuple[Dict[str, Any], int]:
        """The flat state tree of ``d`` and its step, each leaf rebuilt
        whole and passed through ``cut(key, leaf)`` one at a time."""
        if not os.path.exists(os.path.join(d, "shards.json")):
            loaded = torch.load(os.path.join(d, "state.pt"),
                                map_location="cpu", weights_only=True)
            flat = _flat({"params": loaded["params"],
                          "opt_state": loaded["opt_state"]})
            return {k: cut(k, v) for k, v in flat.items()}, int(
                loaded["step"])
        with open(os.path.join(d, "shards.json")) as f:
            meta = json.load(f)
        names = meta["names"]
        coords = [dict(zip(names, c)) for c in meta["coords"]]
        parts = [torch.load(os.path.join(d, f"state.rank{r}.pt"),
                            map_location="cpu", weights_only=True, mmap=True)
                 for r in range(len(coords))]
        tree = {}
        for key, spec in meta["specs"].items():
            leaves = [p["tree"][key] for p in parts]
            tree[key] = cut(key, _whole(leaves, spec, meta["mesh"], coords)
                            if isinstance(leaves[0], torch.Tensor)
                            else leaves[0])
        return tree, int(parts[0]["step"])

    def restore(self, state_template: TrainState, step: Optional[int] = None):
        """``(state, metadata, step)`` of ``step`` (default: the latest),
        loaded into ``state_template``'s tensors (this rank's slices, with a
        mesh); ``(None, None, None)`` when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        d = os.path.join(self.directory, str(step))
        cut = (lambda k, v: v)
        if self.mesh is not None:
            from mmada_parallel_torch.parallel.mesh import _local_slice
            specs = _flat(_state_tree(self.specs))

            def cut(k, v):
                return (_local_slice(v, specs[k], self.mesh)
                        if isinstance(v, torch.Tensor) else v)
        flat, saved_step = self._load(d, cut)
        with open(os.path.join(d, "metadata.json")) as f:
            metadata = json.load(f)
        loaded = _unflat(flat)
        state = TrainState(
            params=_restore_into(state_template.params, loaded["params"]),
            opt_state=_restore_into(state_template.opt_state,
                                    loaded["opt_state"]),
            step=saved_step)
        return state, metadata, step

    def wait(self) -> None:
        """Writes are synchronous: nothing is pending."""
