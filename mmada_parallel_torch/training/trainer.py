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
still advances, as in JAX.  Sharded state (``create_sharded_state``,
``state_shardings``, ``OptimizerConfig.shard_strategy``) waits for
multi-GPU training.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["OptimizerConfig", "Optimizer", "make_optimizer",
           "make_train_step", "TrainState", "tree_map", "tree_leaves"]


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

    def init(self, params: Any) -> Dict[str, Any]:
        state = {"count": 0, "mu": tree_map(torch.zeros_like, params)}
        if self.cfg.name == "adamw":
            state["nu"] = tree_map(torch.zeros_like, params)
        return state

    @torch.no_grad()
    def update(self, params: Any, grads: List[torch.Tensor],
               state: Dict[str, Any], grad_norm: torch.Tensor) -> None:
        cfg = self.cfg
        # the schedule reads the 0-based index of this update
        lr = (cfg.schedule(state["count"]) if cfg.schedule is not None
              else cfg.lr)
        count = state["count"] + 1
        clip = (cfg.grad_clip is not None
                and not bool(grad_norm < cfg.grad_clip))
        mus = tree_leaves(state["mu"])
        nus = tree_leaves(state["nu"]) if cfg.name == "adamw" else mus
        for p, g, mu, nu, decay in zip(tree_leaves(params), grads, mus, nus,
                                       self.decay):
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
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        loss_sum, metrics_sum = None, None
        with torch.enable_grad():
            for i in range(accum_steps):
                mb = batch if accum_steps == 1 else _microbatch(
                    batch, i, accum_steps)
                loss, metrics = loss_fn(state.params, mb, generator)
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
        grad_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        finite = bool(torch.isfinite(loss_sum) & torch.isfinite(grad_norm))
        if finite:
            optimizer.update(state.params, grads, state.opt_state, grad_norm)
        del grads
        metrics = dict(metrics_sum)
        metrics["grad_norm"] = grad_norm
        metrics["loss"] = loss_sum
        metrics["nonfinite"] = torch.tensor(int(not finite))
        state.step += 1
        return state, metrics

    return step
