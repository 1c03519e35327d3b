"""The port's train step against the JAX package's.

The tiny LLaDA (f32, weights bridged from JAX) with the A loss takes three
steps on both sides from the same numpy batches: loss, grad norm and every
parameter must agree at rtol 1e-5 (atol 1e-7 for parameters near zero), for
AdamW with an active clip, two accumulation microbatches and the
half-cosine schedule, and for Lion.  Also: the non-finite guard, remat
strategies giving equal gradients, EMA and the lr schedules."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.training import ema as JE
from mmada_parallel_tpu.training import lr_schedules as JS
from mmada_parallel_tpu.training import trainer as JT
from mmada_parallel_tpu.training.losses import a_variant_losses as j_losses
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.training import ema as TE
from mmada_parallel_torch.training import lr_schedules as TS
from mmada_parallel_torch.training import trainer as TT
from mmada_parallel_torch.training.losses import a_variant_losses as t_losses

torch.set_num_threads(1)
RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)


def _batches(n, B=4, L=16, seed=0):
    """``n`` numpy A batches ``(ids, labels, lengths, scale)``; ``scale``
    multiplies the loss (NaN makes a non-finite step)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, 512, (B, L)).astype(np.int32)
        labels = np.where(rng.random((B, L)) < 0.5, ids, -100).astype(
            np.int32)
        out.append((ids, labels, np.full((B,), L, np.int32),
                    np.ones((B,), np.float32)))
    return out


def _jax_loss(cfg):
    def loss_fn(p, batch, key):
        ids, labels, lengths, scale = batch
        out = j_losses(JL.llada_forward(p, cfg, ids), ids, labels, lengths)
        return out["loss"] * scale.mean(), {"image_loss": out["image_loss"]}
    return loss_fn


def _torch_loss(cfg):
    def loss_fn(p, batch, generator):
        ids, labels, lengths, scale = batch
        out = t_losses(TL.llada_forward(p, cfg, ids), ids, labels, lengths)
        return out["loss"] * scale.mean(), {"image_loss": out["image_loss"]}
    return loss_fn


def _run_both(opt_kw, accum, batches, sched=None):
    """Three steps on each side; returns the metrics and final params."""
    jcfg, tcfg = JL.LLaDAConfig.tiny(), TL.LLaDAConfig.tiny()
    jp = JL.init_llada_params(jax.random.key(0), jcfg)
    tp = llada_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))

    jopt = JT.make_optimizer(JT.OptimizerConfig(
        schedule=sched[0] if sched else None, **opt_kw), jp)
    jstep = jax.jit(JT.make_train_step(_jax_loss(jcfg), jopt, accum))
    jstate = JT.TrainState.create(jp, jopt)
    topt = TT.make_optimizer(TT.OptimizerConfig(
        schedule=sched[1] if sched else None, **opt_kw), tp)
    tstep = TT.make_train_step(_torch_loss(tcfg), topt, accum)
    tstate = TT.TrainState.create(tp, topt)

    jm, tm = [], []
    for b in batches:
        jstate, m = jstep(jstate, tuple(jnp.asarray(x) for x in b), None)
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tstep(tstate, tuple(torch.tensor(x) for x in b))
        tm.append({k: float(v) for k, v in m.items()})
    return jm, tm, jstate, tstate


def _assert_same_run(jm, tm, jstate, tstate):
    for a, b in zip(jm, tm):
        assert set(a) == set(b)
        assert a["nonfinite"] == b["nonfinite"]
        for k in ("loss", "grad_norm", "image_loss"):
            if np.isfinite(a[k]):
                np.testing.assert_allclose(b[k], a[k], rtol=RTOL, err_msg=k)
    jleaves = jax.tree_util.tree_leaves(jstate.params)
    tleaves = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.detach().numpy(), tstate.params))
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_allclose(t, np.asarray(j), **PARAM_TOL)
    assert int(jstate.step) == tstate.step


def test_adamw_clip_accum_schedule_match_jax():
    opt_kw = dict(name="adamw", lr=1e-3, weight_decay=0.1, grad_clip=0.05)
    sched = (JS.half_cosine_with_warmup(1e-3, 2, 10, 1e-5),
             TS.half_cosine_with_warmup(1e-3, 2, 10, 1e-5))
    jm, tm, js, ts = _run_both(opt_kw, 2, _batches(3), sched)
    assert all(m["grad_norm"] > 0.05 for m in tm)        # the clip is active
    _assert_same_run(jm, tm, js, ts)
    assert ts.opt_state["count"] == 3


def test_lion_matches_jax():
    opt_kw = dict(name="lion", lr=3e-4, weight_decay=0.1, grad_clip=None)
    jm, tm, js, ts = _run_both(opt_kw, 1, _batches(3, seed=1))
    _assert_same_run(jm, tm, js, ts)


def test_nonfinite_step_changes_nothing_but_the_step():
    """A NaN batch between two good ones: no change to params or optimizer
    state (its count, and so the schedule, included), ``nonfinite=1``, and
    the same trajectory as JAX's guard."""
    batches = _batches(3, seed=2)
    batches[1] = batches[1][:3] + (np.full((4,), np.nan, np.float32),)
    opt_kw = dict(name="adamw", lr=1e-3, grad_clip=1.0)
    sched = (JS.half_cosine_with_warmup(1e-3, 1, 10),
             TS.half_cosine_with_warmup(1e-3, 1, 10))
    jm, tm, js, ts = _run_both(opt_kw, 1, batches, sched)
    assert [m["nonfinite"] for m in tm] == [0, 1, 0]
    _assert_same_run(jm, tm, js, ts)
    assert ts.step == 3 and ts.opt_state["count"] == 2

    # directly: the NaN step leaves every tensor as it was
    tcfg = TL.LLaDAConfig.tiny()
    tp = TL.init_llada_params(tcfg, torch.Generator().manual_seed(0))
    opt = TT.make_optimizer(TT.OptimizerConfig(), tp)
    step = TT.make_train_step(_torch_loss(tcfg), opt)
    state = TT.TrainState.create(tp, opt)
    state, _ = step(state, tuple(torch.tensor(x) for x in batches[0]))
    before = [t.clone() for t in TT.tree_leaves((state.params,
                                                 state.opt_state))
              if isinstance(t, torch.Tensor)]
    state, m = step(state, tuple(torch.tensor(x) for x in batches[1]))
    after = [t for t in TT.tree_leaves((state.params, state.opt_state))
             if isinstance(t, torch.Tensor)]
    assert int(m["nonfinite"]) == 1 and state.step == 2
    assert state.opt_state["count"] == 1
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.parametrize("remat", ["whole_layer", "one_in_two"])
def test_remat_gives_equal_grads(remat):
    cfg = TL.LLaDAConfig.tiny()
    ids, labels, lengths, scale = (torch.tensor(x) for x in _batches(1)[0])

    def grads(c):
        p = TL.init_llada_params(c, torch.Generator().manual_seed(0))
        leaves = TT.tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        _torch_loss(c)(p, (ids, labels, lengths, scale), None)[0].backward()
        return [t.grad for t in leaves]

    for a, b in zip(grads(cfg), grads(dataclasses.replace(cfg, remat=remat))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_ema_matches_jax():
    cfg_kw = dict(decay=0.99, min_decay=0.1, update_after_step=2,
                  inv_gamma=2.0, power=0.75)
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": [rng.normal(size=(5,)).astype(np.float32)]}
    je = JE.ema_init(jax.tree_util.tree_map(jnp.asarray, params))
    te = TE.ema_init(jax.tree_util.tree_map(torch.tensor, params))
    for step in range(8):
        np.testing.assert_allclose(
            TE.get_decay(TE.EMAConfig(**cfg_kw), step),
            float(JE.get_decay(JE.EMAConfig(**cfg_kw), jnp.asarray(step))),
            rtol=1e-6)
        new = jax.tree_util.tree_map(
            lambda x: (x + rng.normal(size=x.shape)).astype(np.float32),
            params)
        je = JE.ema_update(JE.EMAConfig(**cfg_kw), je,
                           jax.tree_util.tree_map(jnp.asarray, new), step)
        te = TE.ema_update(TE.EMAConfig(**cfg_kw), te,
                           jax.tree_util.tree_map(torch.tensor, new), step)
    for j, t in zip(jax.tree_util.tree_leaves(je), TT.tree_leaves(te)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)


@pytest.mark.parametrize("name", ["half_cosine", "constant",
                                  "constant_with_warmup", "linear", "cosine",
                                  "cosine_with_min_lr", "polynomial"])
def test_lr_schedules_match_jax(name):
    if name == "half_cosine":
        j = JS.half_cosine_with_warmup(2e-5, 3, 20, 1e-6)
        t = TS.half_cosine_with_warmup(2e-5, 3, 20, 1e-6)
    else:
        kw = dict(warmup_steps=3, total_steps=20, num_cycles=0.7,
                  min_lr_scale=0.1, power=2.0)
        j, t = (m.get_scheduler(name, 2e-5, **kw) for m in (JS, TS))
    for step in range(25):
        np.testing.assert_allclose(t(step), float(j(jnp.asarray(step))),
                                   rtol=1e-6, atol=1e-12)
