"""Training over the ``(data, fsdp, tensor)`` mesh (``parallel/mesh.py``'s
training half, ``parallel/fsdp.py``, ``training/trainer.py``'s sharded
step, the losses' global normalisation, the sharded checkpoint) against the
JAX package's whole-batch step.

Ranks are spawned CPU processes on a gloo group (``parallel/launch.py``),
one run of 2 ranks on the ``(1, 2, 1)`` mesh and one of 4 on ``(2, 2, 1)``,
both started by one module fixture while this process computes JAX's
reference: the unsharded JAX ``make_train_step`` on the whole batch, on one
CPU device.  Each rank takes one step of each strategy (``full``,
``zero2``, ``ddp``) with ``accum_steps=2`` on its rows of the same global
batch, whose labels are masked so that the ranks' token counts differ, for
the A loss and for ``m_interleave_loss`` (its text term sums over the
batch).  Loss, metrics, and every rank's slice of the updated parameters
and of ``mu``/``nu`` are held to ``_local_slice`` of JAX's at rtol/atol
1e-5 (the atol scaled by the leaf's largest value, as JAX's tests do).  The
2-rank run also saves a sharded checkpoint at ``fsdp=2`` and restores it at
``data=2`` (this process restores it whole), and takes the full sharded
step of JAX's ``tests/test_multiprocess.py``.

This module's top-level imports are torch and numpy only: spawned ranks
re-import it to find their function, so JAX is imported inside the tests.
"""

import os

import numpy as np
import pytest
import torch

STRATEGIES = ("full", "zero2", "ddp")
MESHES = ((1, 2, 1), (2, 2, 1))
LOSSES = ("a", "m")
ACCUM = 2
ROWS = 2                         # rows a rank holds per microbatch
L_A, MSL, N_VQ = 16, 8, 8
L_M = 4 + N_VQ + MSL
SPECIAL = dict(answer_start_token=500, answer_end_token=501,
               image_start_token=502, image_end_token=503,
               newline_token=504)
OPT = dict(name="adamw", lr=1e-3, weight_decay=0.1, grad_clip=0.05)
TOL = 1e-5


def _cfg_kw():
    return dict(vocab_size=512)


def _child_cfg_kw():
    """``tests/test_multiprocess.py``'s child config."""
    return dict(d_model=64, n_heads=4, n_kv_heads=4, mlp_hidden_size=128,
                vocab_size=512)


# ---------------------------------------------------------------------------
# Batches, from numpy (the same on both sides)
# ---------------------------------------------------------------------------


def _a_batch(rng, B):
    """``B`` A rows: text, ``<answer_start><image_start>``, image codes with
    a newline, ``<image_end>``, answer text, ``<answer_end>``, padding;
    labels kept with a per-row rate, so token counts differ by rank."""
    ids = rng.integers(0, 400, (B, L_A)).astype(np.int64)
    ids[:, 2], ids[:, 3], ids[:, 7] = 500, 502, 504
    ids[:, 9], ids[:, 13] = 503, 501
    keep = rng.random((B, L_A)) < rng.uniform(0.2, 0.9, (B, 1))
    labels = np.where(keep, ids, -100).astype(np.int64)
    labels[:, :3] = -100
    lengths = rng.integers(13, L_A + 1, (B,)).astype(np.int64)
    return ids, labels, lengths


def _m_batch(rng, B, L=L_M):
    ids = rng.integers(0, 500, (B, L)).astype(np.int64)
    keep = rng.random((B, L)) < rng.uniform(0.1, 0.9, (B, 1))
    labels = np.where(keep, rng.integers(0, 500, (B, L)), -100).astype(
        np.int64)
    t = rng.uniform(0.1, 1.0, (B,)).astype(np.float32)
    return ids, labels, t


def _batches(n_dp):
    rng = np.random.default_rng(7 + n_dp)
    B = ACCUM * n_dp * ROWS
    return {"a": _a_batch(rng, B), "m": _m_batch(rng, B)}


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------


def _torch_loss(kind, cfg, gather=None, dp_groups=()):
    from mmada_parallel_torch.models.llada import llada_forward
    from mmada_parallel_torch.training.losses import (a_variant_losses,
                                                      m_interleave_loss)

    def loss_fn(p, batch, generator):
        if kind == "a":
            ids, labels, lengths = batch
            out = a_variant_losses(llada_forward(p, cfg, ids, gather=gather),
                                   ids, labels, lengths, **SPECIAL,
                                   dp_groups=dp_groups)
        else:
            ids, labels, t = batch
            out = m_interleave_loss(llada_forward(p, cfg, ids,
                                                  gather=gather),
                                    labels, t, MSL, N_VQ,
                                    dp_groups=dp_groups)
        return out["loss"], {"text_loss": out["text_loss"],
                             "image_loss": out["image_loss"]}
    return loss_fn


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in _flat(tree).items()}


def _sharded_run(mesh, params, cfg, kind, strategy, batch, tally=None,
                 accum=ACCUM):
    """One sharded step on this rank's rows of ``batch``."""
    from mmada_parallel_torch.models.llada import param_shardings
    from mmada_parallel_torch.parallel.fsdp import FsdpGather
    from mmada_parallel_torch.parallel.mesh import dp_groups, local_rows
    from mmada_parallel_torch.training import trainer as TT
    opt = TT.make_optimizer(TT.OptimizerConfig(**OPT), params)
    state, p_specs, o_specs = TT.create_sharded_state(
        params, opt, param_shardings(cfg), mesh, strategy)
    step = TT.make_sharded_train_step(
        _torch_loss(kind, cfg, FsdpGather(mesh, p_specs, tally),
                    dp_groups(mesh)),
        opt, mesh, p_specs, o_specs, accum_steps=accum)
    batch = local_rows(tuple(torch.from_numpy(x) for x in batch), mesh,
                       accum)
    state, metrics = step(state, batch)
    return state, {k: float(v) for k, v in metrics.items()}, (p_specs,
                                                              o_specs)


def _mesh_rank(rank, world, workdir):
    """Every strategy and loss on this rank; on 2 ranks also the sharded
    checkpoint and the multi-process train step."""
    from mmada_parallel_torch.models.llada import LLaDAConfig
    from mmada_parallel_torch.parallel import MeshConfig, make_mesh
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    from mmada_parallel_torch.training import trainer as TT
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_mesh(MeshConfig(*inp["mesh"]), "cpu")
    cfg = LLaDAConfig.tiny(**_cfg_kw())
    out = {"coord": tuple(mesh.get_coordinate())}
    for kind in LOSSES:
        for strategy in STRATEGIES:
            tally = {}
            params = {k: ({n: t.clone() for n, t in v.items()}
                          if isinstance(v, dict) else v.clone())
                      for k, v in inp["params"].items()}
            state, metrics, specs = _sharded_run(
                mesh, params, cfg, kind, strategy, inp["batches"][kind],
                tally)
            out[(kind, strategy)] = {
                "metrics": metrics, "params": _np(state.params),
                "mu": _np(state.opt_state["mu"]),
                "nu": _np(state.opt_state["nu"]), "tally": tally}
            if world == 2 and kind == "a" and strategy == "full":
                saved = (state, specs)
    if world != 2:
        return out

    # the sharded checkpoint: saved at fsdp=2, restored at data=2
    state, (p_specs, o_specs) = saved
    specs = TT.state_shardings(state.params, state.opt_state, p_specs,
                               o_specs, mesh)
    ckpt = os.path.join(workdir, "ckpt")
    CheckpointManager(ckpt, mesh=mesh, specs=specs).save(
        1, state, {"note": "fsdp2"})
    out["saved"] = {"params": _np(state.params),
                    "mu": _np(state.opt_state["mu"])}
    from mmada_parallel_torch.parallel.fsdp import whole_params
    out["whole"] = _np(whole_params(state.params, p_specs, mesh))
    mesh2 = make_mesh(MeshConfig(data=2, fsdp=1, tensor=1), "cpu")
    opt = TT.make_optimizer(TT.OptimizerConfig(**OPT), inp["params"])
    from mmada_parallel_torch.models.llada import param_shardings
    tmpl, p2, o2 = TT.create_sharded_state(
        inp["params"], opt, param_shardings(cfg), mesh2, "full")
    restored, meta, step = CheckpointManager(
        ckpt, mesh=mesh2, specs=TT.state_shardings(
            tmpl.params, tmpl.opt_state, p2, o2, mesh2)).restore(tmpl)
    out["restored"] = {"params": _np(restored.params),
                       "mu": _np(restored.opt_state["mu"]),
                       "nu": _np(restored.opt_state["nu"]),
                       "count": restored.opt_state["count"],
                       "step": restored.step, "meta": meta, "at": step}

    # tests/test_multiprocess.py's sharded step: full, the M loss
    ccfg = LLaDAConfig.tiny(**_child_cfg_kw())
    _, metrics, _ = _sharded_run(mesh, inp["child_params"], ccfg, "m",
                                 "full", inp["child_batch"], accum=1)
    out["child"] = metrics
    return out


# ---------------------------------------------------------------------------
# The run and JAX's reference
# ---------------------------------------------------------------------------


def _jax_step(jparams, jcfg, kind, batch, accum):
    """JAX's whole-batch step on one device: metrics, params, mu, nu."""
    import jax
    import jax.numpy as jnp
    from mmada_parallel_tpu.models import llada_forward
    from mmada_parallel_tpu.training import trainer as JT
    from mmada_parallel_tpu.training.losses import (a_variant_losses,
                                                    m_interleave_loss)

    def loss_fn(p, b, key):
        if kind == "a":
            ids, labels, lengths = b
            out = a_variant_losses(llada_forward(p, jcfg, ids), ids, labels,
                                   lengths, **SPECIAL)
        else:
            ids, labels, t = b
            out = m_interleave_loss(llada_forward(p, jcfg, ids), labels, t,
                                    MSL, N_VQ)
        return out["loss"], {"text_loss": out["text_loss"],
                             "image_loss": out["image_loss"]}

    opt = JT.make_optimizer(JT.OptimizerConfig(**OPT), jparams)
    state = JT.TrainState.create(jparams, opt)
    step = jax.jit(JT.make_train_step(loss_fn, opt, accum))
    state, metrics = step(state, tuple(jnp.asarray(x) for x in batch), None)
    adam = next(s for s in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "nu")) if
        hasattr(s, "nu"))

    def flat(tree):
        from mmada_parallel_torch.models.from_jax import llada_params_from_jax
        return _np(llada_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                tree)))
    return ({k: float(v) for k, v in metrics.items()}, flat(state.params),
            flat(adam.mu), flat(adam.nu))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from mmada_parallel_tpu.models import LLaDAConfig as JCfg
    from mmada_parallel_tpu.models import init_llada_params as jinit
    from mmada_parallel_torch.models.from_jax import llada_params_from_jax
    from mmada_parallel_torch.parallel.launch import rank_results, spawn_ranks

    jcfg = JCfg.tiny(**_cfg_kw())
    jparams = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(3),
                                                       jcfg))
    tparams = llada_params_from_jax(jparams)
    ccfg = JCfg.tiny(**_child_cfg_kw())
    cparams = llada_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.key(0), ccfg)))
    child = _m_batch(np.random.default_rng(0), 8)
    joins, batches = {}, {}
    for shape in MESHES:
        work = tmp_path_factory.mktemp("mesh" + "".join(map(str, shape)))
        n_dp = shape[0] * shape[1]
        batches[shape] = _batches(n_dp)
        torch.save({"mesh": shape, "params": tparams,
                    "batches": batches[shape], "child_params": cparams,
                    "child_batch": child}, work / "inputs.pt")
        joins[shape] = (spawn_ranks(_mesh_rank, n_dp, work, timeout=300),
                        work)
    ref = {}
    for shape in MESHES:
        for kind in LOSSES:
            ref[(shape, kind)] = _jax_step(jparams, jcfg, kind,
                                           batches[shape][kind], ACCUM)
    ref["child"] = _jax_step(jax.tree_util.tree_map(
        np.asarray, jinit(jax.random.key(0), ccfg)), ccfg, "m", child, 1)
    out = {"ref": ref, "cfg": jcfg}
    for shape, (join, work) in joins.items():
        try:
            out[shape] = rank_results(join(), f"mesh {shape}")
        except RuntimeError as e:
            pytest.fail(str(e))
        out[(shape, "work")] = work
    return out


def _slice(a, spec, shape, coord):
    """``a``'s block at mesh coordinates ``coord`` under ``spec``."""
    names = ("data", "fsdp", "tensor")
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, idx = 1, 0
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            i = names.index(name)
            n, idx = n * shape[i], idx * shape[i] + coord[i]
        step = a.shape[dim] // n
        a = np.take(a, range(idx * step, (idx + 1) * step), axis=dim)
    return a


def _close(got, want, what):
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale,
                               err_msg=what)


def _specs(strategy):
    from mmada_parallel_torch.models.llada import LLaDAConfig, param_shardings
    from mmada_parallel_torch.parallel.mesh import drop_axis
    specs = param_shardings(LLaDAConfig.tiny(**_cfg_kw()))
    p = specs if strategy == "full" else drop_axis(specs, "fsdp")
    o = specs if strategy in ("full", "zero2") else p
    return _flat(p), _flat(o)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("kind", LOSSES)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_step_matches_jax(runs, shape, kind, strategy):
    """One step with ``accum_steps=2`` and ragged token counts: loss,
    metrics and each rank's parameter and ``mu``/``nu`` slices equal JAX's
    whole-batch step.  The FSDP gathers moved bytes where parameters are
    sharded: every leaf split over ``fsdp`` under ``full``; under ``zero2``
    and ``ddp`` only the head, whose ``(fsdp, tensor)`` entry JAX's
    ``drop_axis`` keeps (its whole f32 bytes, once a microbatch)."""
    jm, jp, jmu, jnu = runs["ref"][(shape, kind)]
    p_specs, o_specs = _specs(strategy)
    for r, res in enumerate(runs[shape]):
        got = res[(kind, strategy)]
        for k in ("loss", "grad_norm", "text_loss", "image_loss"):
            np.testing.assert_allclose(got["metrics"][k], jm[k], rtol=TOL,
                                       err_msg=f"rank {r} {k}")
        assert got["metrics"]["nonfinite"] == 0
        assert got["metrics"]["grad_norm"] > OPT["grad_clip"]  # clip active
        for name, want in jp.items():
            _close(got["params"][name],
                   _slice(want, p_specs[name], shape, res["coord"]),
                   f"rank {r} param {name}")
        for tree, ref in (("mu", jmu), ("nu", jnu)):
            for name, want in ref.items():
                _close(got[tree][name],
                       _slice(want, o_specs[name], shape, res["coord"]),
                       f"rank {r} {tree} {name}")
        head = 4 * np.prod(jp["head"].shape) * ACCUM
        assert (got["tally"]["gathered"] > head if strategy == "full"
                else got["tally"]["gathered"] == head)


def test_sharded_checkpoint_restores_under_another_mesh(runs):
    """Saved at ``fsdp=2`` by 2 ranks; restored at ``data=2`` (each rank
    whole) and in this process: every leaf equal, each saved slice the
    block of the whole leaf it came from, and ``whole_params`` of the
    saved slices the whole parameters."""
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    from mmada_parallel_torch.training import trainer as TT
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    shape = (1, 2, 1)
    ranks = runs[shape]
    cfg = LLaDAConfig.tiny(**_cfg_kw())
    params = init_llada_params(cfg, torch.Generator().manual_seed(1))
    opt = TT.make_optimizer(TT.OptimizerConfig(**OPT), params)
    state, meta, step = CheckpointManager(
        str(runs[(shape, "work")] / "ckpt")).restore(
            TT.TrainState.create(params, opt))
    assert (step, state.step, meta) == (1, 1, {"note": "fsdp2"})
    assert state.opt_state["count"] == 1
    whole = {"params": _np(state.params), "mu": _np(state.opt_state["mu"]),
             "nu": _np(state.opt_state["nu"])}
    p_specs, _ = _specs("full")
    for res in ranks:
        got = res["restored"]
        assert (got["at"], got["step"], got["count"]) == (1, 1, 1)
        for tree in ("params", "mu", "nu"):
            for name, want in whole[tree].items():
                np.testing.assert_array_equal(got[tree][name], want,
                                              f"{tree} {name}")
        for name, want in whole["params"].items():     # whole_params
            np.testing.assert_array_equal(res["whole"][name], want, name)
        for tree in ("params", "mu"):
            for name, part in res["saved"][tree].items():
                np.testing.assert_array_equal(
                    part, _slice(whole[tree][name], p_specs[name], shape,
                                 res["coord"]), f"{tree} {name}")


def test_two_process_sharded_train_step(runs):
    """``tests/test_multiprocess.py``'s full sharded step with the M loss,
    here over 2 processes at ``fsdp=2``: a finite loss, equal on both, and
    JAX's whole-batch loss."""
    losses = [res["child"]["loss"] for res in runs[(1, 2, 1)]]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    np.testing.assert_allclose(losses[0], runs["ref"]["child"][0]["loss"],
                               rtol=TOL)


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


def test_drop_axis_and_batch_sharding_equal_jax():
    """``drop_axis`` keeps an entry that names several axes, as JAX's does;
    the batch splits over data x fsdp; ``opt_state_specs`` gives ``mu`` and
    ``nu`` the parameters' specs and the count none."""
    from mmada_parallel_tpu.models import LLaDAConfig as JCfg
    from mmada_parallel_tpu.models import param_shardings as jspecs
    from mmada_parallel_tpu.parallel.mesh import batch_sharding as jbatch
    from mmada_parallel_tpu.parallel.mesh import drop_axis as jdrop
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params,
                                                   param_shardings)
    from mmada_parallel_torch.parallel import mesh as M
    from mmada_parallel_torch.training import trainer as TT

    def as_tuples(tree):
        return {k: (as_tuples(v) if isinstance(v, dict) else tuple(v))
                for k, v in tree.items()}
    cfg = LLaDAConfig.tiny(include_qkv_bias=True)
    want = as_tuples(jdrop(jspecs(JCfg.tiny(include_qkv_bias=True)), "fsdp"))
    assert as_tuples(M.drop_axis(param_shardings(cfg), "fsdp")) == want
    import jax
    from mmada_parallel_tpu.parallel.mesh import MeshConfig as JMeshConfig
    from mmada_parallel_tpu.parallel.mesh import make_mesh as jmake_mesh
    jmesh = jmake_mesh(JMeshConfig(1, 1, 1), jax.devices()[:1])
    assert tuple(M.batch_sharding()) == tuple(jbatch(jmesh).spec)
    assert tuple(M.replicated()) == ()
    params = init_llada_params(cfg, torch.Generator().manual_seed(0))
    opt = TT.make_optimizer(TT.OptimizerConfig(), params)
    specs = M.opt_state_specs(opt.init(params), params, param_shardings(cfg))
    assert specs["mu"] is specs["nu"] and specs["mu"] == param_shardings(cfg)
    assert tuple(specs["count"]) == ()


def test_local_rows_split_each_microbatch():
    """Each microbatch's rows split over data x fsdp, data major, and the
    rank's shares stacked in microbatch order."""
    from mmada_parallel_torch.parallel.mesh import local_rows

    class FakeMesh:
        mesh_dim_names = ("data", "fsdp", "tensor")
        shape = (2, 2, 1)

        def __init__(self, d, f):
            self.c = {"data": d, "fsdp": f, "tensor": 0}

        def get_local_rank(self, name):
            return self.c[name]

    x = torch.arange(16).reshape(16, 1)
    got = [local_rows((x,), FakeMesh(d, f), accum_steps=2)[0].flatten()
           .tolist() for d in range(2) for f in range(2)]
    assert got == [[0, 1, 8, 9], [2, 3, 10, 11], [4, 5, 12, 13],
                   [6, 7, 14, 15]]
