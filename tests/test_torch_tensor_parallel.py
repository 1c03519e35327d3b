"""Megatron tensor parallelism of the port (``parallel/tensor.py``, the
forwards of ``models/llada.py`` over parameters from ``shard_params``)
against the JAX package, which runs the same forwards unsharded here (GSPMD
gives its sharded forward the unsharded numbers:
``tests/test_sharded_inference.py``).

The torch ranks are spawned CPU processes on a gloo group
(``parallel/launch.py``): one run of 4 ranks on the ``(1, 2, 2)`` mesh and
one on ``(2, 1, 2)``, both started by one module fixture while this process
computes the JAX references and the port's solo runs.  Weights cross
through ``models/from_jax.py``; each rank takes its rows of the batch
(``local_rows``, JAX's ``batch_sharding``) and its slices of the weights.

Each case pins one place where a faithful-looking port diverges:

* llama MHA and GQA with q/k/v biases, a ``sequential`` block with SwiGLU
  (its fused ``att_proj`` and ``chunk(2)`` do not split into heads or
  gates: gathered over ``tensor`` and computed whole), the same block with
  GELU (the attention half gathered, the MLP half split), one kv head,
  which ``g = 2`` does not divide, with tied weights (the head is ``wte``);
* out-of-range ids (clamped to the global vocab before the vocab-parallel
  lookup), a padding mask with a fully masked row (mean(v), from the f32
  -1e30 bias);
* the head's ``vocab_slice`` across a vocab-shard boundary, and the image
  slice inside one shard;
* the cached forwards (K2's path), cache shards of ``KV/g`` heads;
* W8A8 through ``quantize_param_shardings``: the row-parallel products'
  per-token amax differs between the ranks (the first half of the heads'
  values is scaled up), so a rank that quantized its own K block alone
  would give other numbers;
* ``generate_ti2ti`` over the mesh at temperature 0 and ``InterleaveServer``
  with sharded parameters (SPMD: every rank runs the batch rank 0 sends)
  give the solo runs' tokens.

Forwards are held to JAX at atol 2e-4 / rtol 2e-3, JAX's own tolerance.

This module's top-level imports are torch and numpy only: spawned ranks
re-import it to find their function, so JAX is imported inside the tests.
"""

import os

import numpy as np
import pytest
import torch

MESHES = ((1, 2, 2), (2, 1, 2))
TVS, CB, MASK = 256, 32, 250
V = TVS + CB
B, L = 4, 12
CASES = {
    "mha": {},
    "gqa": dict(n_kv_heads=2, include_qkv_bias=True),
    "seq_swiglu": dict(block_type="sequential", activation_type="swiglu",
                       n_kv_heads=2, include_qkv_bias=True),
    "seq_gelu": dict(block_type="sequential", activation_type="gelu"),
    "kv1_tied": dict(n_kv_heads=1, weight_tying=True),
}
CACHED = ("mha", "gqa", "kv1_tied")
SLICES = {"across": (100, 100), "image": (TVS, CB)}
SEL = [1, 4, 7, 10]                         # the partial forward's positions
ATOL, RTOL = 2e-4, 2e-3
N_VQ, MSL = 6, 8


def _cfg_kw(name):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=4, n_layers=2,
              mlp_hidden_size=128, vocab_size=V, mask_token_id=MASK)
    kw.update(CASES[name])
    return kw


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, V, (B, L)).astype(np.int64)
    ids[0, 0], ids[1, 3], ids[2, 5] = V + 12, -3, 10 ** 6   # out of range
    mask = np.ones((B, L), bool)
    mask[1, 9:] = False
    mask[3] = False                                  # every key masked
    return ids, mask


def _a_tokens(mod):
    return mod.VariantATokens(mask=MASK, newline=251, answer_start=252,
                              answer_end=253, boi=254, eoi=255,
                              uncondition=249, pad=248,
                              text_vocab_size=TVS, codebook_size=CB)


def _m_tokens(mod):
    return mod.VariantMTokens(mask=MASK, soi=251, eoi=252, bos=249, eos=248,
                              interleave=247, text_vocab_size=TVS,
                              codebook_size=CB)


A_OPTS = dict(text_steps=4, timesteps=2, temperature=0.0,
              text_temperature=0.0, cfg_scale=0.0, cfg_img=2.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
M_OPTS = dict(text_steps=6, image_steps=3, text_cfg=1.5, image_cfg=2.0,
              text_temperature=0.0, image_temperature=0.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
UNCOND = np.asarray([40, 41], np.int32)
PROMPTS = [[5, 6, 7], [8, 9, 10], [11, 12, 13], [14, 15, 16]]


def _ti2ti_batch(tk):
    rows, lay = [], None
    for p in PROMPTS:
        ids, lay = tk.assemble_ti2ti_sequence(p, 8, 2, 3, [9],
                                              tokens=_a_tokens(tk))
        rows.append(ids)
    return np.stack(rows), lay


def _server(params, cfg):
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.samplers.interleave import InterleaveOptions
    from mmada_parallel_torch.serving import InterleaveServer
    return InterleaveServer(params, cfg, InterleaveOptions(**M_OPTS),
                            num_vq_tokens=N_VQ, max_seq_length=MSL,
                            batch_size=2, max_wait_ms=100.0,
                            bucket_quantum=8, tokens=_m_tokens(tk))


def _request():
    rng = np.random.default_rng(9)
    return list(range(40, 45)), rng.integers(TVS, TVS + CB, N_VQ)


def _int8_params(params):
    """W8A8 weights of ``params`` whose row-parallel inputs differ in
    scale between the two ``tensor`` ranks: the first half of each layer's
    v heads and MLP up columns scaled by 16."""
    from mmada_parallel_torch.ops.quant import quantize_llada_params
    blocks = dict(params["blocks"])
    for name in ("v_proj", "up_proj"):
        w = blocks[name].clone()
        w[..., :w.shape[-1] // 2] *= 16.0
        blocks[name] = w
    return quantize_llada_params(dict(params, blocks=blocks))


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------


def _tp_rank(rank, world, workdir):
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models import llada as TL
    from mmada_parallel_torch.ops.quant import quantize_param_shardings
    from mmada_parallel_torch.parallel import (MeshConfig, local_rows,
                                               make_mesh, shard_params)
    from mmada_parallel_torch.samplers import parallel_ti2ti as TT
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_mesh(MeshConfig(*inp["mesh"]), "cpu")
    ids, mask = (local_rows(torch.from_numpy(a), mesh) for a in _inputs())
    out = {"coord": tuple(mesh.get_coordinate())}
    with torch.no_grad():
        for name in CASES:
            cfg = TL.LLaDAConfig.tiny(**_cfg_kw(name))
            sp = shard_params(inp["params"][name], TL.param_shardings(cfg),
                              mesh)
            out[f"fwd/{name}"] = TL.llada_forward(sp, cfg, ids).numpy()
            out[f"masked/{name}"] = TL.llada_forward(sp, cfg, ids,
                                                     mask).numpy()
            hidden = TL.llada_hidden(sp, cfg, ids)
            for s, vs in SLICES.items():
                out[f"slice/{name}/{s}"] = TL.llada_head(
                    sp, cfg, hidden, vocab_slice=vs).numpy()
            if name in CACHED:
                h, cache = TL.llada_hidden_with_cache(sp, cfg, ids)
                pos = torch.tensor([SEL] * ids.shape[0])
                hp, _ = TL.llada_hidden_partial(sp, cfg, ids.gather(1, pos),
                                                pos, cache)
                out[f"cached/{name}"] = (h.numpy(), hp.numpy(),
                                         tuple(cache["k"].shape))

        cfg = TL.LLaDAConfig.tiny(**_cfg_kw("mha"))
        qp = shard_params(inp["int8"], quantize_param_shardings(
            TL.param_shardings(cfg)), mesh)
        out["int8"] = TL.llada_forward(qp, cfg, ids).numpy()

        sp = shard_params(inp["params"]["mha"], TL.param_shardings(cfg),
                          mesh)
        batch, lay = _ti2ti_batch(tk)
        fin, codes = TT.generate_ti2ti(
            sp, cfg, local_rows(torch.from_numpy(batch), mesh), lay,
            TT.TI2TIOptions(**A_OPTS), uncond_image_prefix=UNCOND)
        out["ti2ti"] = (fin.numpy(), codes.numpy())

    # the SPMD server: rank 0 submits, every rank runs the batch
    srv = _server(sp, cfg)
    if rank == 0:
        instr, codes = _request()
        out["server"] = srv.submit(instr, codes=codes, timeout=120)
    srv.close()
    out["server_closed"] = not srv._worker.is_alive()
    return out


def sweep_rank(rank, world, workdir):
    """``run_parabench_sweep(mesh=)`` on this rank's sharded parameters
    (``tests/test_torch_eval.py``)."""
    from mmada_parallel_torch import evaluation as TE
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models import llada as TL
    from mmada_parallel_torch.parallel import (MeshConfig, make_mesh,
                                               shard_params)
    from mmada_parallel_torch.samplers import parallel_ti2ti as TT
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    mesh = make_mesh(MeshConfig(*inp["mesh"]), "cpu")
    cfg = TL.LLaDAConfig.tiny(**inp["cfg"])
    sp = shard_params(inp["params"], TL.param_shardings(cfg), mesh)
    return TE.run_parabench_sweep(
        sp, cfg, [TE.EvalRequest(p) for p in inp["prompts"]],
        opts=TT.TI2TIOptions(**inp["opts"]),
        tokens=tk.VariantATokens(**inp["tokens"]), mesh=mesh, **inp["kw"])


def pararl_rank(rank, world, workdir):
    """``cli/train_pararl.main`` on a rank of a ``world``-rank job
    (``tests/test_torch_pararl.py``)."""
    from mmada_parallel_torch.cli import train_pararl
    train_pararl.main(torch.load(os.path.join(workdir, "argv.pt")))


# ---------------------------------------------------------------------------
# The run and its references
# ---------------------------------------------------------------------------


def _jax_refs(jparams):
    import jax.numpy as jnp
    from mmada_parallel_tpu.models import llada as JL
    ids, mask = (jnp.asarray(a) for a in _inputs())
    refs = {}
    for name in CASES:
        cfg = JL.LLaDAConfig.tiny(**_cfg_kw(name))
        p = jparams[name]
        refs[f"fwd/{name}"] = np.asarray(JL.llada_forward(p, cfg, ids))
        refs[f"masked/{name}"] = np.asarray(JL.llada_forward(p, cfg, ids,
                                                             mask))
        hidden = JL.llada_hidden(p, cfg, ids)
        for s, vs in SLICES.items():
            refs[f"slice/{name}/{s}"] = np.asarray(JL.llada_head(
                p, cfg, hidden, vocab_slice=vs))
        if name in CACHED:
            h, cache = JL.llada_hidden_with_cache(p, cfg, ids)
            pos = jnp.asarray([SEL] * B)
            hp, _ = JL.llada_hidden_partial(
                p, cfg, jnp.take_along_axis(ids, pos, axis=1), pos, cache)
            refs[f"cached/{name}"] = (np.asarray(h), np.asarray(hp))
    return refs


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    import jax
    from mmada_parallel_tpu.models import llada as JL
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models import llada as TL
    from mmada_parallel_torch.models.from_jax import llada_params_from_jax
    from mmada_parallel_torch.parallel.launch import rank_results, spawn_ranks
    from mmada_parallel_torch.samplers import parallel_ti2ti as TT

    jparams, tparams = {}, {}
    for i, name in enumerate(CASES):
        jcfg = JL.LLaDAConfig.tiny(**_cfg_kw(name))
        jparams[name] = jax.tree_util.tree_map(
            np.asarray, JL.init_llada_params(jax.random.key(10 + i), jcfg))
        tparams[name] = llada_params_from_jax(jparams[name])
    int8 = _int8_params(tparams["mha"])
    joins = {}
    for shape in MESHES:
        work = tmp_path_factory.mktemp("tp" + "".join(map(str, shape)))
        torch.save({"mesh": shape, "params": tparams, "int8": int8},
                   work / "inputs.pt")
        joins[shape] = spawn_ranks(_tp_rank, 4, work, timeout=300)

    out = {"jax": _jax_refs(jparams)}
    cfg = TL.LLaDAConfig.tiny(**_cfg_kw("mha"))
    ids, _ = _inputs()
    with torch.no_grad():
        out["int8"] = TL.llada_forward(int8, cfg,
                                       torch.from_numpy(ids)).numpy()
        batch, lay = _ti2ti_batch(tk)
        fin, codes = TT.generate_ti2ti(
            tparams["mha"], cfg, torch.from_numpy(batch), lay,
            TT.TI2TIOptions(**A_OPTS), uncond_image_prefix=UNCOND)
        out["ti2ti"] = (fin.numpy(), codes.numpy())
    srv = _server(tparams["mha"], cfg)
    try:
        instr, codes = _request()
        out["server"] = srv.submit(instr, codes=codes, timeout=120)
    finally:
        srv.close()
    for shape, join in joins.items():
        try:
            out[shape] = rank_results(join(), f"mesh {shape}")
        except RuntimeError as e:
            pytest.fail(str(e))
    return out


def _rows(coord, shape, a):
    """The rows of the global batch a rank at ``coord`` holds."""
    n = shape[0] * shape[1]
    idx = coord[0] * shape[1] + coord[1]
    step = a.shape[0] // n
    return a[idx * step:(idx + 1) * step]


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_forward_matches_jax(tp, shape, name):
    """Every rank's logits of its rows, with no mask and with the padding
    mask (a fully masked row included), equal JAX's unsharded forward."""
    for r, res in enumerate(tp[shape]):
        for kind in ("fwd", "masked"):
            np.testing.assert_allclose(
                res[f"{kind}/{name}"],
                _rows(res["coord"], shape, tp["jax"][f"{kind}/{name}"]),
                atol=ATOL, rtol=RTOL, err_msg=f"rank {r} {kind}")


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_vocab_slices_match_jax(tp, shape, name):
    """The head's ``vocab_slice`` across the shard boundary at 144 (and,
    on ``(1, 2, 2)``, the blocks of 72 the head splits into over ``(fsdp,
    tensor)``) and the image slice inside the last shard."""
    for r, res in enumerate(tp[shape]):
        for s in SLICES:
            np.testing.assert_allclose(
                res[f"slice/{name}/{s}"],
                _rows(res["coord"], shape, tp["jax"][f"slice/{name}/{s}"]),
                atol=ATOL, rtol=RTOL, err_msg=f"rank {r} {s}")


@pytest.mark.parametrize("name", CACHED)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_cached_forwards_match_jax(tp, shape, name):
    """``llada_hidden_with_cache`` and ``llada_hidden_partial`` over the
    mesh equal JAX's; the cache holds ``KV/g`` heads where ``g`` divides
    the kv heads, all of them (computed whole) where it does not."""
    kv = _cfg_kw(name)["n_kv_heads"]
    for r, res in enumerate(tp[shape]):
        h, hp, cache_shape = res[f"cached/{name}"]
        want_h, want_hp = tp["jax"][f"cached/{name}"]
        np.testing.assert_allclose(h, _rows(res["coord"], shape, want_h),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(hp, _rows(res["coord"], shape, want_hp),
                                   atol=ATOL, rtol=RTOL)
        local_kv = kv // 2 if kv % 2 == 0 else kv
        assert cache_shape == (2, 2, L, local_kv * 16)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_int8_forward_matches_unsharded(tp, shape):
    """JAX's ``test_quantized_sharded_forward_matches_unsharded``: the W8A8
    forward over ``quantize_param_shardings`` equals the unsharded int8
    forward, with per-rank amax of the row-parallel inputs that differ
    16-fold."""
    for r, res in enumerate(tp[shape]):
        np.testing.assert_allclose(
            res["int8"], _rows(res["coord"], shape, tp["int8"]), atol=ATOL,
            rtol=RTOL, err_msg=f"rank {r}")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_ti2ti_matches_solo(tp, shape):
    """JAX's ``test_sharded_ti2ti_matches_unsharded``: ``generate_ti2ti``
    on each rank's rows and sharded parameters gives the solo run's final
    ids and codes at temperature 0."""
    fin, codes = tp["ti2ti"]
    for r, res in enumerate(tp[shape]):
        got_fin, got_codes = res["ti2ti"]
        np.testing.assert_array_equal(got_fin,
                                      _rows(res["coord"], shape, fin))
        np.testing.assert_array_equal(got_codes,
                                      _rows(res["coord"], shape, codes))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_interleave_server_with_sharded_params(tp, shape):
    """JAX's ``tests/test_serving.py::
    test_interleave_server_with_sharded_params``: an SPMD
    ``InterleaveServer`` on sharded parameters answers rank 0's request
    with the solo server's text ids and codes, and every rank's worker
    ends at rank 0's ``close()``."""
    want = tp["server"]
    got = tp[shape][0]["server"]
    np.testing.assert_array_equal(got["text_ids"], want["text_ids"])
    np.testing.assert_array_equal(got["codes"], want["codes"])
    assert all(res["server_closed"] for res in tp[shape])
    assert all("server" not in res for res in tp[shape][1:])


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blocks", [1, 2])
@pytest.mark.parametrize("vocab_slice", [None, (100, 100), (256, 32),
                                         (0, 1), (143, 2)])
def test_vocab_pieces_cover_the_slice_once(blocks, vocab_slice):
    """Each rank's pieces are local columns of its blocks, and together, in
    vocab order, they are the slice, each id once."""
    from mmada_parallel_torch.parallel.tensor import vocab_pieces
    g, vocab = 2, 288
    blk = vocab // (g * blocks)
    pieces = vocab_pieces(vocab, g, blocks, vocab_slice)
    start, size = vocab_slice or (0, vocab)
    ids = []
    for t, own in enumerate(pieces):
        for lo, hi, at in own:
            b = at // blk
            assert b % g == t and (b // g) * blk <= lo < hi <= (b // g + 1) \
                * blk
            ids.append((at, hi - lo))
    covered = [i for at, n in sorted(ids) for i in range(at, at + n)]
    assert covered == list(range(start, start + size))


def test_shard_params_carries_its_mesh_and_saves_plain(tmp_path):
    """``shard_params`` keeps the mesh and specs on the tree (the forwards
    read them); the tree pickles as a plain dict, and a one-process
    checkpoint of it loads with ``weights_only``."""
    import io
    from mmada_parallel_torch.parallel.mesh import ShardedParams
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                       TrainState,
                                                       make_optimizer)
    tree = ShardedParams({"wte": torch.ones(2, 3),
                          "blocks": {"w": torch.zeros(3)}},
                         mesh=object(), specs={})
    assert tree.mesh is not None and tree.specs == {}
    buf = io.BytesIO()
    torch.save(tree, buf)
    buf.seek(0)
    back = torch.load(buf, weights_only=False)
    assert type(back) is dict and torch.equal(back["wte"], tree["wte"])
    state = TrainState.create(tree, make_optimizer(OptimizerConfig(), tree))
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(1, state)
    mngr.wait()
    restored, _, step = mngr.restore(state)
    assert step == 1 and torch.equal(restored.params["wte"], tree["wte"])


def test_a_split_tree_without_its_mesh_raises():
    """A rank's vocab-parallel ``wte`` that lost its mesh (a plain
    ``dict(...)`` copy of a ``ShardedParams`` tree) would embed against
    ``V / g`` rows with clamped ids and no error; every forward refuses it
    instead, and the whole tree still runs."""
    from mmada_parallel_torch.models import llada as TL
    cfg = TL.LLaDAConfig.tiny(**_cfg_kw("mha"))
    params = TL.init_llada_params(cfg, torch.Generator().manual_seed(0))
    ids = torch.as_tensor(_inputs()[0])
    assert TL.llada_forward(params, cfg, ids).shape == (B, L, V)
    split = dict(params, wte=params["wte"][:V // 2])
    h = torch.zeros(1, cfg.d_model)
    for run in (lambda: TL.llada_hidden(split, cfg, ids),
                lambda: TL.llada_forward(split, cfg, ids),
                lambda: TL.llada_head(split, cfg, h, vocab_slice=(TVS, CB))):
        with pytest.raises(ValueError, match="without their mesh"):
            run()
