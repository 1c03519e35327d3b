"""The train step: optimizer, gradient accumulation, non-finite guard.

Counterpart of :mod:`mmada_parallel_tpu.training.trainer` on one device.
The loss callable owns the model; the trainer is model-agnostic:
``loss_fn(params, batch, generator) -> (loss, metrics_dict)``.

The optimizers are written out (torch has no Lion, and the JAX package's
clip and weight-decay rules are optax's): AdamW as ``optax.adamw``, Lion as
``optax.lion``, both with no weight decay on 1-D parameters, behind optax's
``clip_by_global_norm`` (scale by ``max_norm / norm`` only when ``norm >=
max_norm``).  The learning-rate schedule reads the optimizer's update count,
0-based, as optax's does.

Unlike the JAX step, which returns new arrays, the update runs in place:
parameters and optimizer state are updated where they lie, so a full-width
state (16 bytes a parameter) is never held twice.  A step whose loss or
gradient norm is not finite leaves parameters and optimizer state untouched
(its update count, and so the schedule, included), while ``TrainState.step``
still advances, as in JAX.

Over a ``(data, fsdp, tensor)`` mesh (:func:`create_sharded_state`,
:func:`make_sharded_train_step`) each rank holds the slices of parameters
and optimizer state that JAX's ``shard_params`` would put on its device,
per ``OptimizerConfig.shard_strategy``:

=========  ==========================  =================================
strategy   gradients                   parameters
=========  ==========================  =================================
``full``   reduce-scattered over fsdp  sharded (gathered per layer)
``zero2``  reduce-scattered            whole; each rank updates its shard
                                       with its shard of ``mu``/``nu``,
                                       then all-gathers the parameters
``ddp``    all-reduced                 whole
=========  ==========================  =================================

Every strategy also sums gradients over ``data``.  The ring's gradients
(``ring=True``) follow the ring's own rule (:func:`_ring_syncs`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from mmada_parallel_torch.utils import spans

__all__ = ["OptimizerConfig", "Optimizer", "make_optimizer",
           "make_train_step", "TrainState", "tree_map", "tree_leaves",
           "create_sharded_state", "state_shardings",
           "make_sharded_train_step", "sharded_value_and_grad"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts/lists/tuples (the JAX
    ``tree_map``); ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts/lists/tuples, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Defaults are variant A's recipe: lr 2e-5, weight decay 0.1, clip 4.0,
    betas (0.9, 0.95)."""

    name: str = "adamw"              # "adamw" | "lion"
    lr: float = 2e-5
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: Optional[float] = 4.0
    schedule: Optional[Callable[[int], float]] = None   # None = constant lr
    # over the mesh's fsdp axis (create_sharded_state): "full" (ZeRO-3:
    # parameters and optimizer state sharded), "zero2" (parameters whole,
    # optimizer state sharded), "ddp" (both whole)
    shard_strategy: str = "full"


def _decay_mask(params) -> Any:
    """No weight decay on 1-D parameters (norms, biases)."""
    return tree_map(lambda p: p.ndim > 1, params)


class Optimizer:
    """``optax.chain(clip_by_global_norm, adamw | lion)`` with in-place
    updates.  ``init(params)`` gives the state ``{"count", "mu"[, "nu"]}``;
    ``update(params, grads, state, grad_norm)`` applies one step to
    ``params`` and ``state`` in place."""

    def __init__(self, cfg: OptimizerConfig, params: Any):
        if cfg.name not in ("adamw", "lion"):
            raise ValueError(cfg.name)
        self.cfg = cfg
        self.decay = tree_leaves(_decay_mask(params))
        self.update_bytes = None    # this rank's, at the first update

    def init(self, params: Any) -> Dict[str, Any]:
        state = {"count": 0, "mu": tree_map(torch.zeros_like, params)}
        if self.cfg.name == "adamw":
            state["nu"] = tree_map(torch.zeros_like, params)
        return state

    @torch.no_grad()
    def update(self, params: Any, grads: List[torch.Tensor],
               state: Dict[str, Any], grad_norm: torch.Tensor) -> None:
        """``params``: the tree, or the list of its leaves (or of views of
        them, updated in place)."""
        cfg = self.cfg
        # the schedule reads the 0-based index of this update
        lr = (cfg.schedule(state["count"]) if cfg.schedule is not None
              else cfg.lr)
        count = state["count"] + 1
        clip = (cfg.grad_clip is not None
                and not bool(grad_norm < cfg.grad_clip))
        leaves = tree_leaves(params)
        mus = tree_leaves(state["mu"])
        nus = tree_leaves(state["nu"]) if cfg.name == "adamw" else mus
        if self.update_bytes is None:
            self.update_bytes = _update_bytes(cfg.name, leaves, grads, mus,
                                              nus)
        spans.count("train.update_bytes", self.update_bytes)
        for p, g, mu, nu, decay in zip(leaves, grads, mus, nus, self.decay):
            if clip:
                g = (g / grad_norm) * cfg.grad_clip
            if cfg.name == "adamw":
                mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
                nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
                u = (mu / (1 - cfg.b1 ** count)).div_(
                    (nu / (1 - cfg.b2 ** count)).sqrt_().add_(cfg.eps))
            else:
                u = (g * (1 - cfg.b1)).add_(mu, alpha=cfg.b1).sign_()
                mu.mul_(cfg.b2).add_(g, alpha=1 - cfg.b2)
            if decay:
                u.add_(p, alpha=cfg.weight_decay)
            p.add_(u.to(p.dtype), alpha=-lr)
        state["count"] = count


def _update_bytes(name: str, params, grads, mus, nus) -> int:
    """The bytes an update must move at the least, at each tensor's own
    dtype: a read and a write of each parameter and moment, a read of each
    gradient (AdamW: 28 bytes an f32 parameter; Lion, with one moment,
    20)."""
    total = 0
    for p, g, mu, nu in zip(params, grads, mus, nus):
        moments = 2 * mu.element_size() + (
            2 * nu.element_size() if name == "adamw" else 0)
        total += p.numel() * (2 * p.element_size() + g.element_size()
                              + moments)
    return total


def make_optimizer(cfg: OptimizerConfig, params: Any) -> Optimizer:
    return Optimizer(cfg, params)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0

    @classmethod
    def create(cls, params: Any, optimizer: Optimizer) -> "TrainState":
        return cls(params=params, opt_state=optimizer.init(params), step=0)


def _microbatch(batch: Any, i: int, n: int) -> Any:
    """Microbatch ``i`` of ``n`` along every tensor's leading dim."""
    return tree_map(lambda x: x.reshape((n, -1) + tuple(x.shape[1:]))[i]
                    if isinstance(x, torch.Tensor) else x, batch)


def _accumulate(loss_fn, params, batch, generator, accum_steps: int):
    """Loss, metrics and gradients of one step, summed over the
    microbatches, then scaled by ``1 / accum_steps``.  Returns ``(loss,
    metrics, grads)``, ``grads`` one tensor a leaf of ``params``."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss_sum, metrics_sum = None, None
    with torch.enable_grad():
        for i in range(accum_steps):
            with spans.span("train.microbatch"):
                mb = batch if accum_steps == 1 else _microbatch(
                    batch, i, accum_steps)
                loss, metrics = loss_fn(params, mb, generator)
                loss.backward()
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
            if loss_sum is None:
                loss_sum, metrics_sum = loss, metrics
            else:
                loss_sum = loss_sum + loss
                metrics_sum = {k: metrics_sum[k] + v
                               for k, v in metrics.items()}
    inv = 1.0 / accum_steps
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    for p in leaves:
        p.grad = None
    if accum_steps > 1:
        for g in grads:
            g.mul_(inv)
        loss_sum = loss_sum * inv
        metrics_sum = {k: v * inv for k, v in metrics_sum.items()}
    return loss_sum, metrics_sum, grads


def _finish(state, loss, metrics, grad_norm, apply) -> Dict:
    """The non-finite guard, the update (``apply()``) and the metrics."""
    with spans.span("train.update"):
        finite = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if finite:
            apply()
    metrics = dict(metrics)
    metrics["grad_norm"] = grad_norm
    metrics["loss"] = loss
    metrics["nonfinite"] = torch.tensor(int(not finite))
    state.step += 1
    return metrics


def make_train_step(
        loss_fn: Callable[[Any, Any, Optional[torch.Generator]],
                          Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
        optimizer: Optimizer, accum_steps: int = 1) -> Callable:
    """Build ``step(state, batch, generator=None) -> (state, metrics)``.

    With ``accum_steps > 1`` the batch's leading dim is ``accum_steps *
    microbatch``: the gradients of the microbatches are summed, then scaled
    by ``1 / accum_steps`` (loss and metrics likewise).  ``metrics`` holds
    the loss function's metrics plus ``loss``, ``grad_norm`` (before the
    clip) and ``nonfinite`` (1 when the update was skipped)."""

    def step(state: TrainState, batch: Any,
             generator: Optional[torch.Generator] = None):
        with spans.span("train.step"):
            loss, metrics, grads = _accumulate(loss_fn, state.params, batch,
                                               generator, accum_steps)
            with spans.span("train.grad_norm"):
                grad_norm = torch.sqrt(sum(g.float().square().sum()
                                           for g in grads))
            metrics = _finish(state, loss, metrics, grad_norm,
                              lambda: optimizer.update(state.params, grads,
                                                       state.opt_state,
                                                       grad_norm))
            del grads
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# Over a mesh
# ---------------------------------------------------------------------------


def create_sharded_state(params: Any, optimizer: Optimizer, specs: Any,
                         mesh, strategy: str = "full"):
    """This rank's :class:`TrainState` under ``strategy``: its slices of
    ``params`` (``specs`` for ``full``, :func:`drop_axis` of them over
    ``fsdp`` otherwise) and zeroed optimizer state sliced like ``specs``
    (``zero2``, ``full``) or like the parameters (``ddp``).  Returns
    ``(state, param_specs, opt_specs)``; the whole ``params`` may be freed
    afterwards."""
    from mmada_parallel_torch.parallel.mesh import (_local_view, drop_axis,
                                                    shard_params)
    if strategy not in ("full", "zero2", "ddp"):
        raise ValueError(f"unknown shard_strategy: {strategy}")
    p_specs = specs if strategy == "full" else drop_axis(specs, "fsdp")
    o_specs = specs if strategy in ("full", "zero2") else p_specs
    local = shard_params(params, p_specs, mesh)
    opt_state = optimizer.init(tree_map(lambda p, s: _local_view(p, s, mesh),
                                        params, o_specs))
    return TrainState(local, opt_state, 0), p_specs, o_specs


def state_shardings(params: Any, opt_state: Any, p_specs: Any, o_specs: Any,
                    mesh=None) -> TrainState:
    """The :class:`TrainState`-shaped tree of :class:`~mmada_parallel_torch.
    parallel.mesh.PartitionSpec` saying which slice of each leaf a rank
    holds (JAX pins its jit's ``out_shardings`` with it; here the sharded
    checkpoint records it)."""
    from mmada_parallel_torch.parallel.mesh import (PartitionSpec,
                                                    opt_state_specs)
    return TrainState(p_specs, opt_state_specs(opt_state, params, o_specs),
                      PartitionSpec())


def _spec_leaves(specs: Any, like: Any) -> List[Any]:
    """The leaves of a spec tree in the order of ``tree_leaves(like)``."""
    if isinstance(like, dict):
        return [x for k, v in like.items() for x in _spec_leaves(specs[k], v)]
    return [specs]


def _names(entry) -> tuple:
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


@dataclasses.dataclass(frozen=True)
class _LeafSync:
    """How one leaf's gradient is synced after the backward: summed over
    the ``reduce`` axes; with ``scatter_dim`` (ZeRO-2) first reduce-scattered
    over ``fsdp`` along that dimension, the parameter's slice updated and
    all-gathered again; ``norm``: the axes its final gradient is split
    over (the squared norm sums over them, and over nothing else)."""

    reduce: Tuple[str, ...]
    scatter_dim: Optional[int] = None
    norm: Tuple[str, ...] = ()


def _fsdp_syncs(p_specs, o_specs, params, mesh) -> List[_LeafSync]:
    """``full`` / ``zero2`` / ``ddp``: a parameter sharded over ``fsdp`` got
    its gradient reduce-scattered by the gather's backward; one whole over
    ``fsdp`` whose state is sharded is reduce-scattered here; any other is
    all-reduced over ``fsdp``.  All sum over ``data``, and none over
    ``tensor``: a leaf split over ``tensor`` got its whole gradient on its
    rank (Megatron's split, ``parallel/tensor.py``), and a whole one (the
    norms) the same whole gradient on every rank, so a sum would count it
    ``g`` times.  The norm sums over the axes a leaf is split on."""
    from mmada_parallel_torch.parallel.fsdp import fsdp_dim
    out = []
    for ps, os_ in zip(_spec_leaves(p_specs, params),
                       _spec_leaves(o_specs, params)):
        tp = ("tensor",) if any("tensor" in _names(e) for e in ps) else ()
        if fsdp_dim(ps) is not None:
            out.append(_LeafSync(("data",), norm=("fsdp",) + tp))
        elif fsdp_dim(os_) is not None:
            out.append(_LeafSync(("data",), fsdp_dim(os_), ("fsdp",) + tp))
        else:
            out.append(_LeafSync(("data", "fsdp"), norm=tp))
    return out


def _ring_syncs(p_specs, params) -> List[_LeafSync]:
    """The ring (``parallel/tp_overlap.py``): a leaf split over ``tensor``
    (the blocks' projections, the vocab-parallel ``wte``) saw every chunk
    of its data group, so it sums over ``data`` only; ``head`` ran on the
    same whole hidden state of the whole batch on every rank, so its
    gradient is already whole and sums over nothing; every other leaf
    (``ln_f``, the blocks' norms) ran on this rank's chunk and rows only
    and sums over ``tensor`` and ``data``."""
    out = []
    for ps, name in zip(_spec_leaves(p_specs, params), _tree_names(params)):
        split = any("tensor" in _names(e) for e in ps)
        if name == "head":
            out.append(_LeafSync((), norm=("tensor",) if split else ()))
        elif split:
            out.append(_LeafSync(("data",), norm=("tensor",)))
        else:
            out.append(_LeafSync(("data", "tensor")))
    return out


def _tree_names(tree: Any, prefix: str = "") -> List[str]:
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _tree_names(v, f"{prefix}{k}" if not prefix
                                     else f"{prefix}.{k}")]
    return [prefix]


def _axis_groups(mesh) -> Dict[str, Any]:
    """The process group of each mesh axis with more than one rank."""
    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return {a: mesh.get_group(a) for a in shape if shape[a] > 1}


def _reduce(t: torch.Tensor, axes, groups) -> torch.Tensor:
    from mmada_parallel_torch.parallel.fsdp import all_reduce_
    for a in axes:
        if a in groups:
            all_reduce_(t, groups[a])
    return t


def sharded_value_and_grad(loss_fn: Callable, params: Any, batch: Any, mesh,
                           p_specs: Any, o_specs: Any = None,
                           accum_steps: int = 1, ring: bool = False,
                           generator: Optional[torch.Generator] = None):
    """The loss, metrics, gradients and global gradient norm of one step
    over ``mesh`` (see :func:`make_sharded_train_step`), every gradient
    synced: summed over the axes its rule names and, for a ZeRO-2 leaf,
    reduce-scattered to this rank's slice of the optimizer state.  Returns
    ``(loss, metrics, grads, grad_norm, syncs)``."""
    from mmada_parallel_torch.parallel.fsdp import reduce_scatter_dim
    groups = _axis_groups(mesh)
    syncs = (_ring_syncs(p_specs, params) if ring
             else _fsdp_syncs(p_specs, o_specs, params, mesh))
    loss, metrics, grads = _accumulate(loss_fn, params, batch, generator,
                                       accum_steps)
    with torch.no_grad():
        for i, (g, sync) in enumerate(zip(grads, syncs)):
            if sync.scatter_dim is not None and "fsdp" in groups:
                g = reduce_scatter_dim(g, sync.scatter_dim, groups["fsdp"])
            grads[i] = _reduce(g, sync.reduce, groups)
        keys = sorted(metrics)
        scalars = _reduce(torch.stack([loss.float()] + [
            metrics[k].float() for k in keys]),
            () if ring else ("data", "fsdp"), groups)
        loss = scalars[0]
        metrics = {k: scalars[1 + i] for i, k in enumerate(keys)}
        with spans.span("train.grad_norm"):
            sq: Dict[tuple, torch.Tensor] = {}
            for g, sync in zip(grads, syncs):
                sq[sync.norm] = sq.get(sync.norm, 0) + \
                    g.float().square().sum()
            grad_norm = torch.sqrt(sum(_reduce(v, axes, groups)
                                       for axes, v in sorted(sq.items())))
    return loss, metrics, grads, grad_norm, syncs


def _fsdp_only(spec):
    """``spec`` with only its ``fsdp`` entry: the view of a leaf whose
    ``tensor`` slice this rank already holds."""
    from mmada_parallel_torch.parallel.mesh import PartitionSpec
    return PartitionSpec(*("fsdp" if "fsdp" in _names(e) else None
                           for e in spec))


def make_sharded_train_step(loss_fn: Callable, optimizer: Optimizer, mesh,
                            p_specs: Any, o_specs: Any,
                            accum_steps: int = 1,
                            ring: bool = False) -> Callable:
    """:func:`make_train_step` over ``mesh`` for the state of
    :func:`create_sharded_state` (or, ``ring=True``, for the ring's
    tensor-sharded state, ``fsdp == 1``).

    ``loss_fn`` runs on this rank's rows with its parameter slices: over
    ``fsdp`` it gathers them and over ``tensor`` it runs Megatron's split
    (``llada_forward(..., gather=MeshGather(mesh, p_specs, cfg))``); its
    loss is this rank's share of the global loss (``dp_groups``,
    ``training/losses.py``), so the gradients and losses are *summed* over
    ``data`` x ``fsdp``; the ranks of one ``tensor`` group hold the same
    rows and compute the same loss.  On the ring every rank computes
    the same loss of the whole batch, which is not summed.

    The global gradient norm sums each rank's squared gradient over the
    axes the leaf is split on and counts a whole leaf once; the non-finite
    guard reads the reduced loss and norm, so every rank takes the same
    branch."""
    from mmada_parallel_torch.parallel.fsdp import all_gather_dim
    from mmada_parallel_torch.parallel.mesh import _local_view
    groups = _axis_groups(mesh)

    def step(state: TrainState, batch: Any,
             generator: Optional[torch.Generator] = None):
        with spans.span("train.step"):
            leaves = tree_leaves(state.params)
            loss, metrics, grads, grad_norm, syncs = sharded_value_and_grad(
                loss_fn, state.params, batch, mesh, p_specs, o_specs,
                accum_steps, ring, generator)

            def apply():
                targets = [p if sync.scatter_dim is None
                           or "fsdp" not in groups
                           else _local_view(p, _fsdp_only(o_spec), mesh)
                           for p, sync, o_spec in zip(
                               leaves, syncs, _spec_leaves(o_specs,
                                                           state.params))]
                optimizer.update(targets, grads, state.opt_state, grad_norm)
                with torch.no_grad():
                    for p, t, sync in zip(leaves, targets, syncs):
                        if t is not p:
                            p.copy_(all_gather_dim(t, sync.scatter_dim,
                                                   groups["fsdp"]))

            metrics = _finish(state, loss, metrics, grad_norm, apply)
            del grads
            return state, metrics

    return step
