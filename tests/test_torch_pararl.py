"""The port's ParaRL (``training/pararl.py``, ``cli/train_pararl.py``)
against the JAX package on the CPU, weights carried across by
``llada_params_from_jax``.

JAX and torch draw different random numbers, so the rollouts are compared
at temperature 0 (``states``, ``commit_mask`` and ``committed`` equal), and
the update on one temperature-1 trajectory that JAX recorded, fed to both:
``trajectory_log_prob``, ``pararl_loss`` and every parameter gradient
against ``jax.grad``, with and without ``step_indices``, at rtol 1e-4 and
atol 1e-5 of the largest gradient (f32; summation order differs between XLA
and PyTorch).  The rewards equal JAX's on the same arrays, and on its own
the port's REINFORCE loop raises the target-match reward over 25 updates."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.samplers import parallel_ti2ti as JT
from mmada_parallel_tpu.training import pararl as JR
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.samplers import parallel_ti2ti as TT
from mmada_parallel_torch.training import pararl as TR
from mmada_parallel_torch.training.trainer import tree_leaves, tree_map

torch.set_num_threads(1)
T = tk.VariantATokens(mask=250, newline=251, answer_start=252,
                      answer_end=253, boi=254, eoi=255, uncondition=249,
                      pad=248, text_vocab_size=256, codebook_size=32)
OPTS = dict(text_steps=4, timesteps=2, temperature=1.0,
            text_temperature=0.7, cfg_scale=0.0, cfg_img=0.0,
            text_vocab_size=256, codebook_size=32, mask_token=250)


def _models(seed=0, **kw):
    base = dict(d_model=32, n_heads=2, n_kv_heads=2, n_layers=1,
                mlp_hidden_size=64, vocab_size=288, mask_token_id=250)
    base.update(kw)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**base), TL.LLaDAConfig.tiny(**base)
    jp = JL.init_llada_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, llada_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))


def _batch(rows=4):
    ids, lay = tk.assemble_ti2ti_sequence([5, 6, 7, 8], 4, 2, 2, [253],
                                          tokens=T)
    return np.stack([ids] * rows), lay


def test_rewards_match_jax():
    codes = np.asarray([[1, 1, 2, 3], [4, 4, 4, 4], [-1, 5, 5, 7]])
    ids = np.asarray([[9, 250, 11, 30, 31], [9, 10, 11, 30, 31],
                      [10, 10, 250, 250, 30]])
    cases = [(JR.code_diversity_reward, TR.code_diversity_reward),
             (JR.make_target_match_reward(np.array([1, 1, 2, 9])),
              TR.make_target_match_reward(np.array([1, 1, 2, 9]))),
             (JR.make_keyword_reward([10, 30], 1, 5),
              TR.make_keyword_reward([10, 30], 1, 5))]
    spec = [JR.RewardSpec([j for j, _ in cases], [0.5, 1.0, 2.0]),
            TR.RewardSpec([t for _, t in cases], [0.5, 1.0, 2.0])]
    for jfn, tfn in cases + [tuple(spec)]:
        want = np.asarray(jfn(jnp.asarray(ids), jnp.asarray(codes)))
        got = tfn(torch.from_numpy(ids), torch.from_numpy(codes))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(TR.code_diversity_reward(
        None, torch.from_numpy(codes[:2])).numpy(), [0.75, 0.25])
    fin = np.asarray([[0, 250, 256 + 3, 256 + 40, 7]])
    for pos in ([1, 2, 3], [3, 2]):
        np.testing.assert_array_equal(
            TR.extract_image_codes(torch.from_numpy(fin), pos, 256, 32,
                                   250).numpy(),
            np.asarray(JR.extract_image_codes(jnp.asarray(fin), pos, 256, 32,
                                              250)))


def test_rollout_matches_jax_at_temperature_0():
    jcfg, tcfg, jp, tp = _models(2)
    ids, lay = _batch(2)
    ids[1, 3] = 9                            # two different rows
    kw = dict(OPTS, temperature=0.0, text_temperature=0.0)
    jfin, jtraj = JR.rollout_ti2ti(jp, jcfg, jnp.asarray(ids), lay,
                                   JT.TI2TIOptions(**kw), None)
    tfin, ttraj = TR.rollout_ti2ti(tp, tcfg, torch.from_numpy(ids), lay,
                                   TT.TI2TIOptions(**kw))
    np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
    for name in ("states", "commit_mask", "committed"):
        assert ttraj[name].shape == (4, 2, ids.shape[1])
        np.testing.assert_array_equal(ttraj[name].numpy(),
                                      np.asarray(jtraj[name]), err_msg=name)
    assert ttraj["commit_mask"].any() and not ttraj["states"].is_inference()


@pytest.fixture(scope="module")
def jax_trajectory():
    """A temperature-1 trajectory sampled by the JAX package, and rewards."""
    jcfg, tcfg, jp, tp = _models(3, d_model=64, n_heads=4, n_kv_heads=2,
                                 n_layers=2, mlp_hidden_size=128)
    ids, lay = _batch(3)
    _, traj = JR.rollout_ti2ti(jp, jcfg, jnp.asarray(ids), lay,
                               JT.TI2TIOptions(**OPTS), jax.random.key(4))
    traj = jax.tree_util.tree_map(np.asarray, traj)
    rewards = np.asarray([0.25, 1.0, 0.5], np.float32)
    return jcfg, tcfg, jp, tp, traj, rewards


@pytest.mark.parametrize("step_indices", [None, [0, 2, 3]])
def test_loss_and_grads_match_jax(jax_trajectory, step_indices):
    jcfg, tcfg, jp, tp, traj, rewards = jax_trajectory
    assert traj["commit_mask"].any()
    sub = None if step_indices is None else np.asarray(step_indices)
    jopts, topts = JT.TI2TIOptions(**OPTS), TT.TI2TIOptions(**OPTS)

    def jloss(p):
        return JR.pararl_loss(p, jcfg, jax.tree_util.tree_map(jnp.asarray,
                                                              traj),
                              jnp.asarray(rewards), jopts,
                              step_indices=None if sub is None
                              else jnp.asarray(sub))
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)

    params = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    ttraj = {k: torch.from_numpy(v.copy()) for k, v in traj.items()}
    tl, tm = TR.pararl_loss(params, tcfg, ttraj, torch.from_numpy(rewards),
                            topts, step_indices=None if sub is None
                            else torch.from_numpy(sub))
    tl.backward()
    # the loss is a mean of advantage-weighted log-probs that nearly cancel
    # against the mean-reward baseline: held to 1e-4 of its terms' size
    terms = np.abs((rewards - rewards.mean()) * float(jm["traj_logp"]))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=0,
                               atol=1e-4 * float(terms.max()))
    for k in ("reward_mean", "advantage_std", "traj_logp"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-4, err_msg=k)
    with torch.no_grad():
        lp = TR.trajectory_log_prob(tp, tcfg, ttraj, topts,
                                    None if sub is None
                                    else torch.from_numpy(sub))
    np.testing.assert_allclose(lp.numpy(), np.asarray(JR.trajectory_log_prob(
        jp, jcfg, jax.tree_util.tree_map(jnp.asarray, traj), jopts,
        None if sub is None else jnp.asarray(sub))), rtol=1e-4)
    jgl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jg)]
    tgl = [t.grad.numpy() for t in tree_leaves(params)]
    assert len(jgl) == len(tgl)
    top = max(float(np.abs(g).max()) for g in jgl)
    for got, want in zip(tgl, jgl):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * top)


def test_pararl_reward_improves():
    """REINFORCE with the target-match reward on a tiny model: the mean
    reward of the last 5 of 25 updates beats the first 5 by a margin."""
    from mmada_parallel_torch.cli.train_pararl import build_update
    g = torch.Generator().manual_seed(0)
    cfg = TL.LLaDAConfig.tiny(d_model=32, n_heads=2, n_kv_heads=2,
                              n_layers=1, mlp_hidden_size=64, vocab_size=288,
                              mask_token_id=250)
    params = TL.init_llada_params(cfg, g)
    ids, lay = _batch(8)
    opts = TT.TI2TIOptions(**OPTS)
    reward = TR.RewardSpec([TR.make_target_match_reward(
        np.full(4, 17, np.int64))], [1.0])
    state, step = build_update(cfg, params, opts, 3e-3, None)
    from mmada_parallel_torch.cli.train_pararl import rollout_and_score
    hist = []
    for _ in range(25):
        batch = rollout_and_score(state.params, cfg, torch.from_numpy(ids),
                                  lay, opts, reward, g)
        state, metrics = step(state, batch, g)
        hist.append(float(metrics["reward_mean"]))
        assert np.isfinite(float(metrics["loss"]))
    first, last = np.mean(hist[:5]), np.mean(hist[-5:])
    assert last > first + 0.05, f"no improvement: {first:.3f} -> {last:.3f}"


def test_train_pararl_cli_writes_a_checkpoint(tmp_path):
    from mmada_parallel_torch.cli import train_pararl
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    train_pararl.main([
        "--output_dir", str(tmp_path), "--steps", "2",
        "--rollouts_per_step", "2", "--text_steps", "4", "--timesteps", "2",
        "--grid", "2", "--text_gen_length", "4", "--traj_subsample", "2",
        "--lr", "1e-4", "--device", "cpu"])
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mngr.all_steps() == [2]
    cfg, params, _ = train_pararl.tiny_setup(0, "cpu")
    from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                       TrainState,
                                                       make_optimizer)
    template = TrainState.create(params, make_optimizer(OptimizerConfig(),
                                                        params))
    state, meta, step = mngr.restore(template)
    assert step == 2 and meta == {"iters": 2} and state.step == 2
    assert state.opt_state["count"] == 2


def test_train_pararl_cli_over_a_mesh_equals_one_rank(tmp_path):
    """JAX's ``cli/train_pararl.py`` over ``MeshConfig()``: two spawned
    gloo ranks (``data=2``, the parameters placed by ``param_shardings``)
    take the one-rank run's update: rank 0's checkpoint holds its
    parameters and AdamW state."""
    from test_torch_tensor_parallel import pararl_rank
    from mmada_parallel_torch.cli import train_pararl
    from mmada_parallel_torch.parallel.launch import rank_results, spawn_ranks
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                       TrainState,
                                                       make_optimizer,
                                                       tree_leaves)
    argv = ["--steps", "1", "--rollouts_per_step", "2", "--text_steps", "4",
            "--timesteps", "2", "--grid", "2", "--text_gen_length", "4",
            "--traj_subsample", "2", "--lr", "1e-3", "--device", "cpu"]
    work = tmp_path / "ranks"
    work.mkdir()
    torch.save(argv + ["--output_dir", str(tmp_path / "two")],
               work / "argv.pt")
    join = spawn_ranks(pararl_rank, 2, work, timeout=240)
    train_pararl.main(argv + ["--output_dir", str(tmp_path / "one")])
    rank_results(join(), "pararl ranks")
    cfg, params, _ = train_pararl.tiny_setup(0, "cpu")
    template = TrainState.create(params, make_optimizer(OptimizerConfig(),
                                                        params))
    one, _, _ = CheckpointManager(str(tmp_path / "one" / "ckpt")).restore(
        template)
    two, meta, step = CheckpointManager(
        str(tmp_path / "two" / "ckpt")).restore(template)
    assert step == 1 and meta == {"iters": 1}
    for tree in ("params", "opt_state"):
        a = tree_leaves(getattr(one, tree))
        b = tree_leaves(getattr(two, tree))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, torch.Tensor):
                torch.testing.assert_close(y, x, rtol=1e-5, atol=1e-7)
            else:
                assert x == y

