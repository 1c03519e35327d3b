"""Training with Megatron tensor parallelism (``parallel/tensor.py`` through
``training/trainer.py``'s sharded step) against the JAX package's
whole-batch step, which GSPMD gives its sharded step the numbers of.

Spawned CPU ranks on gloo (``parallel/launch.py``) take one step with
``accum_steps=2`` on their rows of one global batch: on ``(1, 1, 2)`` (2
ranks, ``full``), on ``(2, 1, 2)`` (4 ranks, ``full``) and on ``(1, 2, 2)``
(4 ranks, every strategy: ``full``, ``zero2`` and ``ddp``, where JAX's
``drop_axis`` drops ``fsdp`` only, so ``tensor`` stays split), for the A
loss and for ``m_interleave_loss``, while this process runs JAX's step.
The batches and losses are ``test_torch_train_mesh.py``'s: labels masked at
per-row rates, so the data-parallel ranks' token counts differ and the
global denominators matter; the ranks of one ``tensor`` group hold the same
rows, and a row counts once.

The gates are the chip's for the sharded step: the loss to rtol 1e-5, the
global gradient norm (which sums each leaf's squares over the axes it is
split on, not over ``tensor`` for a whole norm weight) to rtol 1e-4, and
each rank's slice of every updated parameter within 1e-3 of JAX's update
in relative L2.  A norm weight's gradient is whole on every ``tensor``
rank; a sum over ``tensor`` would double it, which these gates see.

This module's top-level imports are torch and numpy only (spawned ranks
re-import it); the batches and JAX's step come from
``test_torch_train_mesh.py``.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_train_mesh import (ACCUM, OPT, ROWS, _a_batch, _flat,
                                   _jax_step, _m_batch, _np, _slice,
                                   _torch_loss)

RUNS = {(1, 1, 2): ("full",), (2, 1, 2): ("full",),
        (1, 2, 2): ("full", "zero2", "ddp")}
LOSSES = ("a", "m")
UPDATE_RTOL = 1e-3


def _cfg_kw():
    return dict(vocab_size=512)


def _batches(n_dp):
    rng = np.random.default_rng(17 + n_dp)
    Bg = ACCUM * n_dp * ROWS
    return {"a": _a_batch(rng, Bg), "m": _m_batch(rng, Bg)}


def _bf16_noise(mesh):
    """The relative L2 from the f32 gradient of the bf16 gradient, leaf by
    leaf, solo and over ``mesh`` (this rank's slice), of one A-style cross
    entropy on a small model (d_model 256, 4 heads, L 256)."""
    import dataclasses
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params,
                                                   llada_forward,
                                                   param_shardings)
    from mmada_parallel_torch.parallel.mesh import _local_view, shard_params
    from mmada_parallel_torch.parallel.tensor import MeshGather
    cfg = LLaDAConfig.tiny(d_model=256, n_heads=4, n_kv_heads=4,
                           mlp_hidden_size=512, vocab_size=2048)
    params = init_llada_params(cfg, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    ids = torch.randint(0, 2048, (1, 256), generator=g)
    labels = torch.randint(0, 2048, (1, 256), generator=g)
    specs = param_shardings(cfg)

    def grads(tree, dtype, gather=None):
        p = {k: ({n: t.clone().requires_grad_() for n, t in v.items()}
                 if isinstance(v, dict) else v.clone().requires_grad_())
             for k, v in tree.items()}
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        logits = llada_forward(p, c, ids, gather=gather)
        torch.nn.functional.cross_entropy(logits.float()[0], labels[0]) \
            .backward()
        return {k: v.grad for k, v in _flat(p).items()}

    f32 = grads(params, torch.float32)
    solo = grads(params, torch.bfloat16)
    local = shard_params(params, specs, mesh)
    tp = grads(local, torch.bfloat16, MeshGather(mesh, specs, cfg))
    flat_specs = _flat(specs)
    out = {}
    for k, want in f32.items():
        view = _local_view(want, flat_specs[k], mesh)
        out[k] = (float((_local_view(solo[k], flat_specs[k], mesh) - view)
                        .norm() / view.norm()),
                  float((tp[k] - view).norm() / view.norm()))
    return out


def _tensor_rank(rank, world, workdir):
    """One step of each loss and strategy of this run on this rank."""
    from mmada_parallel_torch.models.llada import LLaDAConfig, param_shardings
    from mmada_parallel_torch.parallel import MeshConfig, make_mesh
    from mmada_parallel_torch.parallel.mesh import dp_groups, local_rows
    from mmada_parallel_torch.parallel.tensor import MeshGather
    from mmada_parallel_torch.training import trainer as TT
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    shape = inp["mesh"]
    mesh = make_mesh(MeshConfig(*shape), "cpu")
    cfg = LLaDAConfig.tiny(**_cfg_kw())
    out = {"coord": tuple(mesh.get_coordinate())}
    for kind in LOSSES:
        for strategy in RUNS[shape]:
            params = {k: ({n: t.clone() for n, t in v.items()}
                          if isinstance(v, dict) else v.clone())
                      for k, v in inp["params"].items()}
            opt = TT.make_optimizer(TT.OptimizerConfig(**OPT), params)
            state, p_specs, o_specs = TT.create_sharded_state(
                params, opt, param_shardings(cfg), mesh, strategy)
            tally = {}
            step = TT.make_sharded_train_step(
                _torch_loss(kind, cfg, MeshGather(mesh, p_specs, cfg, tally),
                            dp_groups(mesh)),
                opt, mesh, p_specs, o_specs, accum_steps=ACCUM)
            batch = local_rows(tuple(torch.from_numpy(x)
                                     for x in inp["batches"][kind]), mesh,
                               ACCUM)
            state, metrics = step(state, batch)
            out[(kind, strategy)] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": _np(state.params), "tally": tally,
                "specs": {k: tuple(v) for k, v in _flat(p_specs).items()}}
    if shape == (1, 1, 2):
        out["bf16_noise"] = _bf16_noise(mesh)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from mmada_parallel_tpu.models import LLaDAConfig as JCfg
    from mmada_parallel_tpu.models import init_llada_params as jinit
    from mmada_parallel_torch.models.from_jax import llada_params_from_jax
    from mmada_parallel_torch.parallel.launch import rank_results, spawn_ranks

    jcfg = JCfg.tiny(**_cfg_kw())
    jparams = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(4),
                                                       jcfg))
    tparams = llada_params_from_jax(jparams)
    joins, batches = {}, {}
    for shape in RUNS:
        work = tmp_path_factory.mktemp("tensor" + "".join(map(str, shape)))
        batches[shape] = _batches(shape[0] * shape[1])
        torch.save({"mesh": shape, "params": tparams,
                    "batches": batches[shape]}, work / "inputs.pt")
        joins[shape] = spawn_ranks(_tensor_rank, int(np.prod(shape)), work,
                                   timeout=300)
    out = {"initial": _np(tparams)}
    for shape in RUNS:
        for kind in LOSSES:
            out[(shape, kind)] = _jax_step(jparams, jcfg, kind,
                                           batches[shape][kind], ACCUM)
    for shape, join in joins.items():
        try:
            out[shape] = rank_results(join(), f"mesh {shape}")
        except RuntimeError as e:
            pytest.fail(str(e))
    return out


CASES = [(shape, kind, strategy) for shape, strategies in RUNS.items()
         for kind in LOSSES for strategy in strategies]


@pytest.mark.parametrize("shape,kind,strategy", CASES,
                         ids=["x".join(map(str, s)) + f"-{k}-{st}"
                              for s, k, st in CASES])
def test_tensor_parallel_step_matches_jax(runs, shape, kind, strategy):
    """Loss, gradient norm and every rank's slice of the updated
    parameters against JAX's whole-batch step; the ``tensor`` collectives
    ran (all-reduces forward and backward)."""
    jm, jp, _, _ = runs[(shape, kind)]
    for r, res in enumerate(runs[shape]):
        got = res[(kind, strategy)]
        m = got["metrics"]
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5,
                                   err_msg=f"rank {r} loss")
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"],
                                   rtol=1e-4, err_msg=f"rank {r} grad_norm")
        assert m["nonfinite"] == 0
        for name, want in jp.items():
            spec = got["specs"][name]
            want = _slice(want, spec, shape, res["coord"])
            start = _slice(runs["initial"][name], spec, shape, res["coord"])
            err = np.linalg.norm(got["params"][name] - want)
            assert err <= UPDATE_RTOL * np.linalg.norm(want - start), \
                f"rank {r} {name}: {err}"
        assert got["tally"]["reduced"] > 0


def test_bf16_gradients_sit_as_far_from_f32_as_solo(runs):
    """The basis of the card's bf16 gate for Megatron's split: in bf16 the
    row-parallel partial products and the column-parallel inputs'
    gradient partials round before their all-reduces, so a leaf's bf16
    gradient over ``tensor=2`` is not the solo bf16 gradient; it sits as
    far from the f32 gradient as the solo one does (within 2x, each under
    2e-2 relative L2), which a wrong sync would not."""
    for r, res in enumerate(runs[(1, 1, 2)]):
        for name, (solo, tp) in res["bf16_noise"].items():
            assert 0 < solo < 2e-2 and 0 < tp < 2e-2, (r, name, solo, tp)
            assert tp <= 2 * solo, (r, name, solo, tp)
