"""Ring tensor parallelism of the port (``parallel/tp_overlap.py``) against
the JAX package's (``mmada_parallel_tpu/parallel/tp_overlap.py``).

The torch ranks are spawned CPU processes on a gloo group (one thread
each), meeting through a ``file://`` rendezvous in the test's temporary
directory; JAX runs here, on the conftest's 8 virtual devices.  Weights
cross through ``models/from_jax.py`` and reach each rank through
``shard_params``.  One module-scoped run of 8 ranks computes every case
(the rank function below records its results; this process computes the
JAX and the torch solo references meanwhile), and each test checks one
case: the ring products per rank against the dense product and JAX's
shard_map outputs (f32: rtol and atol 1e-5; the int8 payload: JAX's
bars), the forwards against the torch solo forward and the JAX ring forward
(2e-4, JAX's bound), JAX's ``ValueError`` messages, the samplers and the
server over the ring token for token against the solo runs at temperature
0, and the bytes through the ``permute=`` hook against JAX's wire-volume
formula.  ``sigma_positions``, ``_quantize_rows`` and ``param_shardings``
need no ranks.  Two smaller runs show that an SPMD server batch that fails
on one rank ends the job, and (on a card) that gloo cannot send a CUDA
tensor, which is why the ring stages it through host memory.

This module's top-level imports are torch and numpy only: spawned ranks
re-import it to find their function, so JAX is imported inside the tests.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

G = 8                        # ranks of the module's run
TVS, CB, MASK = 256, 32, 250


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------


def start_ranks(fn, world, workdir, timeout=300.0):
    """Start ``world`` spawned CPU ranks running ``fn`` on a gloo group
    (``parallel/launch.py``); returns ``join()``, which waits (at most
    ``timeout`` s from now), kills what is left and returns each rank's
    result, or fails with the ranks' tracebacks."""
    from mmada_parallel_torch.parallel.launch import rank_results, spawn_ranks
    wait = spawn_ranks(fn, world, workdir, timeout=timeout)

    def join():
        try:
            return rank_results(wait())
        except RuntimeError as e:
            pytest.fail(str(e))

    return join


# ---------------------------------------------------------------------------
# Configurations shared by the ranks and the references
# ---------------------------------------------------------------------------


def _cfg_kw(**over):
    """JAX's ``_tp_cfg`` (``tests/test_tp_overlap.py``) as keyword args."""
    base = dict(n_heads=8, n_kv_heads=8, d_model=64, mlp_hidden_size=128,
                n_layers=2, block_type="llama", vocab_size=512)
    base.update(over)
    return base


FORWARDS = {            # name -> (config overrides, mesh (data, tensor), ids)
    "mha": ({}, (1, 8), (2, 40)),
    "qkv_bias": ({"include_qkv_bias": True}, (1, 8), (2, 40)),
    "gqa_kv4": ({"n_kv_heads": 4}, (2, 4), (2, 40)),
    "vocab_slice": ({}, (1, 8), (1, 16)),
    "data2_tensor4": ({}, (2, 4), (2, 40)),
}
VOCAB_SLICE = (128, 64)
AG_CASES = {"ag": (2, 48, 16, 24), "odd": (1, 24, 8, 8),
            "int8": (2, 48, 16, 24)}                       # B, L, D, F
RS_CASE = (2, 48, 32, 16)                                  # B, L, K, F
ERRORS = ("mask", "tensor1", "fsdp", "block", "heads", "kv_heads", "seq")
WIRE = (2, 64)                                             # B, L
RING_KV = {8: (1, 8), 4: (2, 4)}            # kv heads -> mesh (data, tensor)
GRAD_IDS = (2, 16)                          # JAX's gradient test's ids
STEP_BATCH = (4, 16)                        # JAX's train-step test's batch
DEEP = dict(d_model=256, n_heads=8, n_kv_heads=8, mlp_hidden_size=768,
            vocab_size=1024, embedding_size=1024)       # llada_8b, narrowed


def _deep_cfg(dtype=torch.bfloat16):
    """All 32 layers of ``llada_8b`` at a narrow width, in ``dtype``."""
    from mmada_parallel_torch.models.llada import LLaDAConfig
    return LLaDAConfig.llada_8b(**DEEP, param_dtype=dtype,
                                compute_dtype=dtype)


def _torch_tokens():
    from mmada_parallel_torch import tokens as tk
    return tk.VariantATokens(mask=250, newline=251, answer_start=252,
                             answer_end=253, boi=254, eoi=255,
                             uncondition=249, pad=248,
                             text_vocab_size=TVS, codebook_size=CB)


def _torch_tokens_m():
    from mmada_parallel_torch import tokens as tk
    return tk.VariantMTokens(soi=251, eoi=250, bos=249, text_vocab_size=TVS,
                             codebook_size=CB)


def _ti2ti_prompt(tk_mod, tok, extra=0):
    """JAX's ring test prompt: ``[5, 6, 7]`` grown by 11s until the layout
    length divides by 8, then ``extra`` more 11s (8 keeps it divisible)."""
    prompt = [5, 6, 7]
    _, lay = tk_mod.assemble_ti2ti_sequence(prompt, 8, 2, 3, [9],
                                            tokens=tok)
    while lay.total_len % G:
        prompt.append(11)
        _, lay = tk_mod.assemble_ti2ti_sequence(prompt, 8, 2, 3, [9],
                                                tokens=tok)
    return prompt + [11] * extra


def _ti2ti_opts(mod):
    return mod.TI2TIOptions(text_steps=4, timesteps=2, temperature=0.0,
                            text_temperature=0.0, cfg_scale=0.0, cfg_img=4.0,
                            text_vocab_size=TVS, codebook_size=CB,
                            mask_token=MASK)


def _interleave_opts(mod):
    return mod.InterleaveOptions(text_steps=6, image_steps=3, text_cfg=1.5,
                                 image_cfg=2.0, text_temperature=0.0,
                                 image_temperature=0.0, text_vocab_size=TVS,
                                 codebook_size=CB, mask_token=MASK)


def _counting(tally):
    """A ``permute=`` hook that adds the bytes each rank sends to
    ``tally`` and then runs the real ring round."""
    from mmada_parallel_torch.parallel.tp_overlap import ring_permute

    def permute(xs, directions, group):
        tally[0] += sum(x.numel() * x.element_size() for x in xs)
        tally[1] += 1
        return ring_permute(xs, directions, group)
    return permute


def _main_rank(rank, world, workdir):
    """Every ring case on this rank; returns ``{case: result}``."""
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import LLaDAConfig, param_shardings
    from mmada_parallel_torch.parallel import (MeshConfig, make_mesh,
                                               shard_params)
    from mmada_parallel_torch.parallel import tp_overlap as TP
    from mmada_parallel_torch.samplers import interleave as TI
    from mmada_parallel_torch.samplers import parallel_ti2ti as TT
    from mmada_parallel_torch.serving import ServeConfig, TI2TIServer

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    meshes = {(1, 8): make_mesh(MeshConfig(data=1, fsdp=1, tensor=8), "cpu"),
              (2, 4): make_mesh(MeshConfig(data=2, fsdp=1, tensor=4), "cpu")}
    m8 = meshes[(1, 8)]
    ring = m8.get_group("tensor")
    r = rank
    out = {}

    for name, (B, L, D, F) in AG_CASES.items():
        h, ws = inp[name]
        C, Fl = L // G, F // G
        out[name] = [y.numpy() for y in TP.ring_ag_matmul(
            h[:, r * C:(r + 1) * C], [w[:, r * Fl:(r + 1) * Fl] for w in ws],
            G, ring, int8_payload=name == "int8")]
    a, w = inp["rs"]
    Kl = a.shape[2] // G
    pos = TP.sigma_positions(G, a.shape[1] // G, r)
    out["rs"] = TP.ring_matmul_rs(a[:, :, r * Kl:(r + 1) * Kl][:, pos],
                                  w[r * Kl:(r + 1) * Kl], G, ring).numpy()

    def cfg_of(**over):
        return LLaDAConfig.tiny(**_cfg_kw(**over))

    for name, (over, mesh_shape, _) in FORWARDS.items():
        cfg = cfg_of(**over)
        mesh = meshes[mesh_shape]
        sp = shard_params(inp["params"][name], param_shardings(cfg),
                          mesh)
        ids = inp["ids"][name]
        vs = VOCAB_SLICE if name == "vocab_slice" else None
        out[f"fwd/{name}"] = TP.llada_forward_tp_overlap(
            sp, cfg, ids, mesh, vocab_slice=vs).numpy()
        if name == "mha":
            out["fwd/int8"] = TP.llada_forward_tp_overlap(
                sp, cfg, ids, mesh, int8_payload=True).numpy()
            mha = sp

    # bf16 at depth: rings of 4, the batch split over data=2
    dcfg = _deep_cfg()
    out["deep"] = TP.llada_hidden_tp_overlap(
        shard_params(inp["deep_params"], param_shardings(dcfg),
                     meshes[(2, 4)]), dcfg, inp["deep_ids"],
        meshes[(2, 4)]).float().numpy()

    # JAX's ValueErrors, raised before any communication
    cfg = cfg_of()
    ids = inp["ids"]["mha"]
    bad = {"mask": (cfg, ids, m8, torch.ones(ids.shape, dtype=torch.bool)),
           "tensor1": (cfg, ids, make_mesh(MeshConfig(data=8, fsdp=1,
                                                      tensor=1), "cpu")),
           "fsdp": (cfg, ids, make_mesh(MeshConfig(data=1, fsdp=2, tensor=4),
                                        "cpu")),
           "block": (cfg_of(block_type="sequential"), ids, m8),
           "heads": (cfg_of(n_heads=4, n_kv_heads=4), ids, m8),
           "kv_heads": (cfg_of(n_kv_heads=4), ids, m8),
           "seq": (cfg, torch.zeros((1, 17), dtype=torch.long), m8)}
    for name, (c, i, mesh, *mask) in bad.items():
        try:
            TP.llada_hidden_tp_overlap(mha, c, i, mesh, *mask)
            out[f"err/{name}"] = None
        except ValueError as e:
            out[f"err/{name}"] = str(e)

    # bytes each rank sends through the permute= hook in one forward
    for name, int8 in (("exact", False), ("int8", True)):
        tally = [0, 0]
        TP.llada_hidden_tp_overlap(mha, cfg, torch.zeros(WIRE,
                                                         dtype=torch.long),
                                   m8, int8_payload=int8,
                                   permute=_counting(tally))
        out[f"wire/{name}"] = tuple(tally)

    # training over the ring: backbone gradients and two train steps
    from mmada_parallel_torch.training import trainer as TTR
    from mmada_parallel_torch.training.losses import a_variant_losses
    for kv, mesh_shape in RING_KV.items():
        mesh = meshes[mesh_shape]
        cfg = cfg_of(n_kv_heads=kv)
        specs = param_shardings(cfg)

        def hidden_sq(p, ids, generator, cfg=cfg, mesh=mesh):
            h = TP.llada_hidden_tp_overlap(p, cfg, ids, mesh)
            return h.float().square().sum(), {}
        sp = shard_params(inp["grad_params"][kv], specs, mesh)
        _, _, grads, _, _ = TTR.sharded_value_and_grad(
            hidden_sq, sp, inp["grad_ids"], mesh, specs, ring=True)
        out[f"ring_grads/{kv}"] = dict(zip(_leaf_names(sp),
                                           [g.numpy() for g in grads]))

        def a_loss(p, batch, generator, cfg=cfg, mesh=mesh):
            ids, labels, lengths = batch
            o = a_variant_losses(TP.llada_forward_tp_overlap(p, cfg, ids,
                                                             mesh),
                                 ids, labels, lengths)
            return o["loss"], {"text_loss": o["text_loss"]}
        opt = TTR.make_optimizer(TTR.OptimizerConfig(lr=1e-3),
                                 inp["step_params"][kv])
        state, p_specs, o_specs = TTR.create_sharded_state(
            inp["step_params"][kv], opt, specs, mesh, "full")
        step = TTR.make_sharded_train_step(a_loss, opt, mesh, p_specs,
                                           o_specs, accum_steps=2, ring=True)
        losses = []
        for _ in range(2):
            state, m = step(state, inp["step_batch"])
            losses.append(float(m["loss"]))
        out[f"ring_step/{kv}"] = (losses, dict(zip(
            _leaf_names(state.params),
            [t.detach().numpy() for t in TTR.tree_leaves(state.params)])))

    # the samplers over the ring
    tok = _torch_tokens()
    scfg = cfg_of(vocab_size=TVS + CB, mask_token_id=MASK)
    sp = shard_params(inp["ti2ti_params"], param_shardings(scfg), m8)
    prompt = _ti2ti_prompt(tk, tok)
    ids, lay = tk.assemble_ti2ti_sequence(prompt, 8, 2, 3, [9], tokens=tok)
    fin, codes = TT.generate_ti2ti(
        sp, scfg, torch.as_tensor(ids)[None], lay, _ti2ti_opts(TT),
        uncond_image_prefix=np.asarray(prompt),
        hidden_fn=TP.ring_hidden_fn(m8))
    out["ti2ti"] = (fin.numpy(), codes.numpy())

    tok_m = _torch_tokens_m()
    sp = shard_params(inp["interleave_params"], param_shardings(scfg),
                      m8)
    ids, lay = tk.assemble_interleave_sequence(
        [10, 11, 12, 13, 14], num_vq_tokens=8, max_seq_length=9,
        tokens=tok_m)
    un_ids, _ = tk.assemble_interleave_sequence(
        [30, 31, 32, 33, 34], num_vq_tokens=8, max_seq_length=9,
        tokens=tok_m)
    fin, codes = TI.interleave_generate(
        sp, scfg, torch.as_tensor(ids)[None], torch.as_tensor(un_ids)[None],
        lay, _interleave_opts(TI), hidden_fn=TP.ring_hidden_fn(m8))
    out["interleave"] = (fin.numpy(), codes.numpy())

    # the SPMD server: rank 0 takes three requests from three threads
    sp = shard_params(inp["server_params"], param_shardings(scfg), m8)
    srv = TI2TIServer(sp, scfg, _ti2ti_opts(TT),
                      ServeConfig(batch_size=2, max_wait_ms=500.0,
                                  grid_hw=(2, 3), text_gen_length=8,
                                  end_token_ids=(9,)),
                      tokens=tok, hidden_fn=TP.ring_hidden_fn(m8))
    if r == 0:
        prompts = [_ti2ti_prompt(tk, tok), _ti2ti_prompt(tk, tok)[::-1],
                   _ti2ti_prompt(tk, tok, extra=8)]
        res = [None] * len(prompts)

        def call(i):
            res[i] = srv.submit(prompts[i], timeout=120)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(150)
        stats = srv.stats()
        # a layout length the ring cannot split: refused on rank 0, before
        # the followers hear of it, and the server goes on
        odd = _ti2ti_prompt(tk, tok, extra=1)
        try:
            srv.submit(odd, timeout=60)
            refused = None
        except ValueError as e:
            refused = str(e)
        again = srv.submit(prompts[0], timeout=120)
        out["server"] = {"prompts": prompts, "results": res,
                         "buckets": [srv._bucket_of(p) for p in prompts],
                         "stats": stats, "refused": refused,
                         "again": again}
    srv.close()               # followers: returns once rank 0 has closed
    out["server_closed"] = not srv._worker.is_alive()
    return out


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}.{k}" if prefix else k)]
    return [prefix]


def _demo_ring_rank(rank, world, workdir):
    """The trained A demo's eval over a ``world``-rank ring, exact and with
    the int8 payload (``test_torch_capability_demo.py``)."""
    from mmada_parallel_torch.examples import train_edit_demo_a as TA
    from mmada_parallel_torch.parallel import (MeshConfig, make_mesh,
                                               shard_params)
    from mmada_parallel_torch.models.llada import param_shardings
    from mmada_parallel_torch.parallel.tp_overlap import ring_hidden_fn
    params = torch.load(os.path.join(workdir, "params.pt"))
    tokens = TA.demo_tokens()
    cfg = TA.demo_config(tokens)
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, tensor=world), "cpu")
    local = shard_params(params, param_shardings(cfg), mesh)
    out = {}
    for name, int8 in (("exact", False), ("int8", True)):
        accs, _, texts, _ = TA.eval_a_model(
            local, cfg, tokens, TA.WordTokA(),
            hidden_fn=ring_hidden_fn(mesh, int8_payload=int8))
        out[name] = (accs, texts)
    return out


class InjectedFault(RuntimeError):
    pass


def _failing_follower_rank(rank, world, workdir):
    """The SPMD server on a 2-rank ring whose follower (rank 1) raises in
    its 5th ring round, partway through the first forward of rank 0's
    batch.  Rank 1 re-raises from ``close()`` and so dies; rank 0 records
    what its request and its ``close()`` raised."""
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params,
                                                   param_shardings)
    from mmada_parallel_torch.parallel import (MeshConfig, make_mesh,
                                               shard_params)
    from mmada_parallel_torch.parallel import tp_overlap as TP
    from mmada_parallel_torch.samplers import parallel_ti2ti as TT
    from mmada_parallel_torch.serving import ServeConfig, TI2TIServer

    cfg = LLaDAConfig.tiny(**_cfg_kw(vocab_size=TVS + CB,
                                     mask_token_id=MASK))
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, tensor=world), "cpu")
    params = shard_params(
        init_llada_params(cfg, torch.Generator().manual_seed(0)),
        param_shardings(cfg), mesh)
    rounds = [0]

    def faulty(xs, directions, group):
        rounds[0] += 1
        if rounds[0] == 5:
            raise InjectedFault("injected fault in ring round 5")
        return TP.ring_permute(xs, directions, group)

    srv = TI2TIServer(params, cfg, _ti2ti_opts(TT),
                      ServeConfig(batch_size=1, max_wait_ms=10.0,
                                  grid_hw=(2, 3), text_gen_length=8,
                                  end_token_ids=(9,)),
                      tokens=_torch_tokens(),
                      hidden_fn=TP.ring_hidden_fn(
                          mesh, permute=faulty if rank == 1 else None))
    if rank == 1:
        srv.close()                      # raises: this rank dies
        return None
    out = {}
    for what, call in (("submit", lambda: srv.submit(
            _ti2ti_prompt(tk, _torch_tokens()), timeout=120)),
                       ("again", lambda: srv.submit([5, 6], timeout=60)),
                       ("close", srv.close)):
        try:
            call()
            out[what] = None
        except Exception as e:
            out[what] = repr(e)
    return out


def _gloo_cuda_rank(rank, world, workdir):
    """Two gloo ranks on ``cuda:0``: rank 0 sends a CUDA tensor as it is,
    with no host staging; rank 1 receives into a CUDA tensor."""
    import torch.distributed as dist
    t = torch.arange(1024, dtype=torch.float32, device="cuda")
    if rank == 0:
        dist.send(t, 1)
    else:
        buf = torch.empty_like(t)
        dist.recv(buf, 0)
        return bool(torch.equal(buf, t))


# ---------------------------------------------------------------------------
# The run and its references
# ---------------------------------------------------------------------------


def _jax_cfg(**over):
    from mmada_parallel_tpu.models import LLaDAConfig
    return LLaDAConfig.tiny(**_cfg_kw(**over))


def _jax_tokens():
    from mmada_parallel_tpu import tokens as tk
    return tk.VariantATokens(mask=250, newline=251, answer_start=252,
                             answer_end=253, boi=254, eoi=255,
                             uncondition=249, pad=248,
                             text_vocab_size=TVS, codebook_size=CB)


def _bridged(jparams):
    import jax
    from mmada_parallel_torch.models.from_jax import llada_params_from_jax
    return llada_params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))


def _jax_shard_map(mesh, fn, in_specs, out_specs, *args):
    import jax
    return [np.asarray(y) for y in jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False))(*args)]


def _jax_ring_refs(inp_np):
    """JAX's shard_map ring products on the 8-device mesh, per chip."""
    from jax.sharding import PartitionSpec as P
    from mmada_parallel_tpu.parallel import MeshConfig, make_mesh
    from mmada_parallel_tpu.parallel import tp_overlap as JTP
    import jax
    mesh = make_mesh(MeshConfig(data=1, fsdp=1, tensor=G))
    refs = {}
    for name in AG_CASES:
        h, ws = inp_np[name]

        def f(h_s, *w_l, int8=name == "int8"):
            return tuple(y[None] for y in JTP.ring_ag_matmul(
                h_s, list(w_l), G, int8_payload=int8))
        refs[name] = _jax_shard_map(
            mesh, f, (P(None, "tensor", None),) + (P(None, "tensor"),)
            * len(ws), tuple(P("tensor") for _ in ws), h, *ws)
    a, w = inp_np["rs"]

    def frs(a_l, w_l):
        r = jax.lax.axis_index("tensor")
        pos = JTP.sigma_positions(G, a_l.shape[1] // G, r)
        return (JTP.ring_matmul_rs(a_l[:, pos, :], w_l, G),)
    refs["rs"] = _jax_shard_map(mesh, frs, (P(None, None, "tensor"),
                                            P("tensor", None)),
                                (P(None, "tensor", None),), a, w)[0]
    return refs


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    import jax
    from mmada_parallel_tpu.models import init_llada_params as jinit
    from mmada_parallel_tpu.parallel import MeshConfig as JMeshConfig
    from mmada_parallel_tpu.parallel import make_mesh as jmake_mesh
    from mmada_parallel_tpu.parallel import shard_params as jshard
    from mmada_parallel_tpu.parallel import tp_overlap as JTP
    from mmada_parallel_tpu.models import param_shardings as jspecs
    from mmada_parallel_torch.models.llada import LLaDAConfig, llada_forward

    work = tmp_path_factory.mktemp("ring")
    rng = np.random.default_rng(0)
    inp_np = {}
    for name, (B, L, D, F) in AG_CASES.items():
        nw = 2 if name == "ag" else 1
        inp_np[name] = (rng.standard_normal((B, L, D), np.float32),
                        [rng.standard_normal((D, F), np.float32)
                         for _ in range(nw)])
    B, L, K, F = RS_CASE
    inp_np["rs"] = (rng.standard_normal((B, L, K), np.float32),
                    rng.standard_normal((K, F), np.float32))

    jparams, tparams, ids = {}, {}, {}
    for i, (name, (over, _, shape)) in enumerate(FORWARDS.items()):
        p = jinit(jax.random.key(20 + i), _jax_cfg(**over))
        p = jax.tree_util.tree_map(np.asarray, p)
        if "q_bias" in p["blocks"]:           # zeros at init: make them count
            for b in ("q_bias", "k_bias", "v_bias"):
                p["blocks"][b] = (0.5 * rng.standard_normal(
                    p["blocks"][b].shape)).astype(np.float32)
        jparams[name], tparams[name] = p, _bridged(p)
        ids[name] = rng.integers(0, 512, shape).astype(np.int64)
    from mmada_parallel_torch.models.llada import (init_llada_params,
                                                   llada_hidden)
    deep_params = init_llada_params(_deep_cfg(),
                                    torch.Generator().manual_seed(0))
    deep_ids = torch.from_numpy(rng.integers(0, 1024, (2, 96)))
    grad_params = {kv: jinit(jax.random.key(5), _jax_cfg(n_kv_heads=kv))
                   for kv in RING_KV}
    step_params = {kv: jinit(jax.random.key(7), _jax_cfg(n_kv_heads=kv))
                   for kv in RING_KV}
    grad_ids = rng.integers(0, 512, GRAD_IDS).astype(np.int64)
    B, L = STEP_BATCH
    s_ids = rng.integers(0, 512, (B, L)).astype(np.int64)
    step_batch = (s_ids, np.where(rng.random((B, L)) < 0.5, s_ids,
                                  -100).astype(np.int64),
                  np.full((B,), L, np.int64))
    scfg = _jax_cfg(vocab_size=TVS + CB, mask_token_id=MASK)
    sampler_params = {k: jinit(jax.random.key(seed), scfg) for k, seed in
                      (("ti2ti", 4), ("interleave", 5), ("server", 6))}
    torch.save({
        **{k: (torch.from_numpy(h), [torch.from_numpy(w) for w in ws])
           for k, (h, ws) in inp_np.items() if k in AG_CASES},
        "rs": tuple(torch.from_numpy(t) for t in inp_np["rs"]),
        "params": tparams,
        "ids": {k: torch.from_numpy(v) for k, v in ids.items()},
        **{f"{k}_params": _bridged(v) for k, v in sampler_params.items()},
        "deep_params": deep_params, "deep_ids": deep_ids,
        "grad_params": {kv: _bridged(p) for kv, p in grad_params.items()},
        "grad_ids": torch.from_numpy(grad_ids),
        "step_params": {kv: _bridged(p) for kv, p in step_params.items()},
        "step_batch": tuple(torch.from_numpy(x) for x in step_batch),
    }, work / "inputs.pt")
    join = start_ranks(_main_rank, G, work)

    # the references, while the ranks run
    ref = {"jax": _jax_ring_refs(inp_np), "torch": {}, "jax_fwd": {}}
    jmeshes = {(1, 8): jmake_mesh(JMeshConfig(data=1, fsdp=1, tensor=8)),
               (2, 4): jmake_mesh(JMeshConfig(data=2, fsdp=1, tensor=4))}
    for name, (over, mesh_shape, _) in FORWARDS.items():
        jcfg = _jax_cfg(**over)
        vs = VOCAB_SLICE if name == "vocab_slice" else None
        mesh = jmeshes[mesh_shape]
        sharded = jshard(jparams[name], jspecs(jcfg), mesh)
        ref["jax_fwd"][name] = np.asarray(jax.jit(
            lambda p, i: JTP.llada_forward_tp_overlap(
                p, jcfg, i, mesh, vocab_slice=vs))(sharded, ids[name]))
        tcfg = LLaDAConfig.tiny(**_cfg_kw(**over))
        logits = llada_forward(tparams[name], tcfg, torch.from_numpy(
            ids[name]))
        if vs is not None:
            logits = logits[..., vs[0]:vs[0] + vs[1]]
        ref["torch"][name] = logits.detach().numpy()
    ref["errors"] = _jax_errors(jparams["mha"], ids["mha"], jmeshes[(1, 8)])
    ref["deep"] = {
        "bf16": llada_hidden(deep_params, _deep_cfg(), deep_ids).float(),
        "f32": llada_hidden({k: ({n: t.float() for n, t in v.items()}
                                 if isinstance(v, dict) else v.float())
                             for k, v in deep_params.items()},
                            _deep_cfg(torch.float32), deep_ids)}
    ref["sampler_params"] = sampler_params
    ref["ring_train"] = _jax_ring_train_refs(grad_params, grad_ids,
                                             step_params, step_batch)
    ref["ranks"] = join()
    ref["ids"] = ids
    ref["inputs"] = inp_np
    return ref


def _jax_ring_train_refs(grad_params, grad_ids, step_params, step_batch):
    """JAX's unsharded references of the ring's training: ``jax.grad`` of
    ``sum(llada_hidden ** 2)``, and two ``make_train_step`` steps (AdamW,
    clip, ``accum_steps=2``) with the A loss, per kv."""
    import jax
    import jax.numpy as jnp
    from mmada_parallel_tpu.models import llada_forward, llada_hidden
    from mmada_parallel_tpu.training import trainer as JT
    from mmada_parallel_tpu.training.losses import a_variant_losses
    out = {}
    for kv in RING_KV:
        cfg = _jax_cfg(n_kv_heads=kv)
        g = jax.jit(jax.grad(lambda p: jnp.sum(llada_hidden(
            p, cfg, jnp.asarray(grad_ids)).astype(jnp.float32) ** 2)))(
                grad_params[kv])

        def loss_fn(p, batch, key, cfg=cfg):
            ids, labels, lengths = batch
            o = a_variant_losses(llada_forward(p, cfg, ids), ids, labels,
                                 lengths)
            return o["loss"], {"text_loss": o["text_loss"]}
        opt = JT.make_optimizer(JT.OptimizerConfig(lr=1e-3), step_params[kv])
        state = JT.TrainState.create(step_params[kv], opt)
        step = jax.jit(JT.make_train_step(loss_fn, opt, accum_steps=2))
        losses = []
        for _ in range(2):
            state, m = step(state, tuple(jnp.asarray(x)
                                         for x in step_batch), None)
            losses.append(float(m["loss"]))
        out[kv] = {"grads": _bridged(g), "losses": losses,
                   "params": _bridged(state.params)}
    return out


def _jax_errors(jparams, ids, mesh8):
    """JAX's messages for the inputs the ranks feed their ring."""
    import jax
    import jax.numpy as jnp
    from mmada_parallel_tpu.parallel import MeshConfig, make_mesh
    from mmada_parallel_tpu.parallel import tp_overlap as JTP
    ids = jnp.asarray(ids)
    bad = {"mask": (_jax_cfg(), ids, mesh8, jnp.ones(ids.shape, bool)),
           "tensor1": (_jax_cfg(), ids, make_mesh(
               MeshConfig(data=1, fsdp=1, tensor=1), jax.devices()[:1])),
           "fsdp": (_jax_cfg(), ids, make_mesh(
               MeshConfig(data=1, fsdp=2, tensor=4))),
           "block": (_jax_cfg(block_type="sequential"), ids, mesh8),
           "heads": (_jax_cfg(n_heads=4, n_kv_heads=4), ids, mesh8),
           "kv_heads": (_jax_cfg(n_kv_heads=4), ids, mesh8),
           "seq": (_jax_cfg(), jnp.zeros((1, 17), jnp.int32), mesh8)}
    msgs = {}
    for name, (cfg, i, mesh, *mask) in bad.items():
        with pytest.raises(ValueError) as e:
            JTP.llada_hidden_tp_overlap(jparams, cfg, i, mesh, *mask)
        msgs[name] = str(e.value)
    return msgs


def _dense_sigma(dense, r, C, Fl):
    """Rank ``r``'s rows in sigma order and its column shard of ``dense``."""
    from mmada_parallel_torch.parallel.tp_overlap import sigma_positions
    pos = sigma_positions(G, C, r).numpy()
    return dense[:, pos, r * Fl:(r + 1) * Fl]


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g,C", [(2, 4), (4, 606), (8, 3), (8, 303),
                                 (4, 5)])
def test_sigma_positions_equal_jax_bitwise(g, C):
    from mmada_parallel_tpu.parallel.tp_overlap import sigma_positions as js
    from mmada_parallel_torch.parallel.tp_overlap import sigma_positions
    for r in range(g):
        got = sigma_positions(g, C, r).numpy()
        np.testing.assert_array_equal(got, np.asarray(js(g, C, r)))
        assert sorted(got.tolist()) == list(range(g * C))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_equal_jax_bitwise(dtype):
    import jax.numpy as jnp
    from mmada_parallel_tpu.parallel.tp_overlap import _quantize_rows as jq
    from mmada_parallel_torch.parallel.tp_overlap import (_dequantize_rows,
                                                          _quantize_rows)
    x = np.random.default_rng(1).standard_normal((2, 7, 96)).astype(
        np.float32) * np.geomspace(1e-3, 1e3, 96, dtype=np.float32)
    x[0, 3] = 0.0                                    # an all-zero row
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    q, s = _quantize_rows(tx)
    jqv, js = jq(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert _dequantize_rows(q, s, torch.float32).shape == tx.shape


def _specs_as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _specs_as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("name", ["tiny", "tied", "sequential",
                                  "sequential_bias", "qkv_bias", "llada_8b"])
def test_param_shardings_equal_jax(name):
    from mmada_parallel_tpu.models import LLaDAConfig as JCfg
    from mmada_parallel_tpu.models import param_shardings as jspecs
    from mmada_parallel_torch.models.llada import LLaDAConfig, param_shardings
    from mmada_parallel_torch.parallel import PartitionSpec
    over = {"tiny": {}, "tied": {"weight_tying": True},
            "sequential": {"block_type": "sequential"},
            "sequential_bias": {"block_type": "sequential",
                                "include_qkv_bias": True},
            "qkv_bias": {"include_qkv_bias": True}}.get(name)
    if over is None:
        tcfg, jcfg = LLaDAConfig.llada_8b(), JCfg.llada_8b()
    else:
        tcfg, jcfg = LLaDAConfig.tiny(**over), JCfg.tiny(**over)
    got = param_shardings(tcfg, "fsdp", "tensor")
    assert got == _specs_as_tuples(jspecs(jcfg))
    assert all(isinstance(s, PartitionSpec)
               for s in list(got["blocks"].values()) + [got["wte"]])
    # the same entries under other axis names
    assert param_shardings(tcfg, "f", "t") == _specs_as_tuples(
        jspecs(jcfg, "f", "t"))


# ---------------------------------------------------------------------------
# Over the ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ag", "odd"])
def test_ring_ag_matmul_matches_dense_and_jax(ring, name):
    """Per rank, the sigma-ordered outputs equal the dense product's rows
    in sigma order and the rank's column shard, and JAX's per-chip
    outputs (``odd``: chunks of 3, halves of 1 and 2)."""
    B, L, D, F = AG_CASES[name]
    h, ws = ring["inputs"][name]
    for r, res in enumerate(ring["ranks"]):
        for i, w in enumerate(ws):
            want = _dense_sigma(h @ w, r, L // G, F // G)
            np.testing.assert_allclose(res[name][i], want, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(res[name][i], ring["jax"][name][i][r],
                                       rtol=1e-5, atol=1e-5)


def test_ring_ag_matmul_int8_payload(ring):
    """The int8 payload: within JAX's bars of the dense product (relative
    max error < 0.03 a rank, cosine > 0.999 over all), and equal to JAX's
    int8 ring to 1e-5 (the same quantized operands)."""
    B, L, D, F = AG_CASES["int8"]
    h, (w,) = ring["inputs"]["int8"]
    got, want = [], []
    for r, res in enumerate(ring["ranks"]):
        y, ref = res["int8"][0], _dense_sigma(h @ w, r, L // G, F // G)
        assert np.abs(y - ref).max() / (np.abs(ref).max() + 1e-9) < 0.03
        np.testing.assert_allclose(y, ring["jax"]["int8"][0][r], rtol=1e-5,
                                   atol=1e-5)
        got.append(y.reshape(-1))
        want.append(ref.reshape(-1))
    got, want = np.concatenate(got), np.concatenate(want)
    assert got @ want / (np.linalg.norm(got) * np.linalg.norm(want)) > 0.999


def test_ring_matmul_rs_matches_dense_and_jax(ring):
    """Sigma-ordered row-sharded input -> chunk ``r`` of the natural-order
    product on rank ``r``."""
    B, L, K, F = RS_CASE
    a, w = ring["inputs"]["rs"]
    dense, C = a @ w, L // G
    for r, res in enumerate(ring["ranks"]):
        np.testing.assert_allclose(res["rs"], dense[:, r * C:(r + 1) * C],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(res["rs"],
                                   ring["jax"]["rs"][:, r * C:(r + 1) * C],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_parity(ring, name):
    """``llada_forward_tp_overlap`` on every rank equals the torch solo
    forward and the JAX ring forward at JAX's 2e-4: MHA over 8 ranks, q/k/v
    biases, GQA (8 q / 4 kv heads over rings of 4), ``vocab_slice``, and
    data=2 x tensor=4 (the batch split over two rings of 4)."""
    for res in ring["ranks"]:
        got = res[f"fwd/{name}"]
        np.testing.assert_allclose(got, ring["torch"][name], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got, ring["jax_fwd"][name], rtol=2e-4,
                                   atol=2e-4)


def test_every_rank_returns_the_same_hidden_rows(ring):
    """The gathered result is the same bits on every rank (every rank then
    runs the same sampler)."""
    for name in list(FORWARDS) + ["int8"]:
        for res in ring["ranks"][1:]:
            np.testing.assert_array_equal(res[f"fwd/{name}"],
                                          ring["ranks"][0][f"fwd/{name}"])


def test_forward_int8_payload_fidelity(ring):
    """JAX's bars for the int8 payload forward against the exact ring:
    cosine > 0.999, argmax agreement > 0.9."""
    exact = ring["ranks"][0]["fwd/mha"]
    q8 = ring["ranks"][0]["fwd/int8"]
    cos = exact.reshape(-1) @ q8.reshape(-1) / (
        np.linalg.norm(exact) * np.linalg.norm(q8))
    assert cos > 0.999, cos
    assert (exact.argmax(-1) == q8.argmax(-1)).mean() > 0.9


@pytest.mark.parametrize("name", ERRORS)
def test_rejects_what_jax_rejects(ring, name):
    """Masks or positions, tensor=1, fsdp=2, the sequential block, 4 heads
    or 4 kv heads over 8 ranks, L=17: JAX's ValueError messages (fsdp's
    names the mesh shape, a dict here)."""
    got, want = ring["ranks"][0][f"err/{name}"], ring["errors"][name]
    assert got is not None
    if name == "fsdp":
        got, want = got.split("(got")[0], want.split("(got")[0]
    assert got == want
    for res in ring["ranks"][1:]:
        assert res[f"err/{name}"] == ring["ranks"][0][f"err/{name}"]


@pytest.mark.parametrize("name", ["exact", "int8"])
def test_wire_bytes_equal_jax_volume(ring, name):
    """Bytes each rank sends in one forward, counted through the
    ``permute=`` hook: 4 boundaries a layer, each ``(g-1)/g`` of the
    global activation ``S = B*L*d`` (JAX: ring == the GSPMD path's two
    all-reduces, ``4*S*(g-1)/g`` a layer).  With the int8 payload the two
    all-gathers send int8 rows plus one f32 scale a row."""
    from mmada_parallel_torch.models.llada import LLaDAConfig
    cfg = LLaDAConfig.tiny(**_cfg_kw())
    B, L = WIRE
    S, rows = B * L * cfg.d_model, B * L
    if name == "exact":
        per_layer = 4 * S * 4 * (G - 1) / G
    else:
        per_layer = (2 * (S + 4 * rows) + 2 * S * 4) * (G - 1) / G
    for res in ring["ranks"]:
        nbytes, rounds = res[f"wire/{name}"]
        assert nbytes == cfg.n_layers * per_layer
        assert rounds == cfg.n_layers * 4 * (G - 1)


def test_generate_ti2ti_over_ring_matches_solo(ring):
    """The whole TI2TI trajectory with ``hidden_fn=ring_hidden_fn(mesh)``
    equals the torch solo run and the JAX solo run token for token at
    temperature 0, on every rank."""
    import jax
    import jax.numpy as jnp
    from mmada_parallel_tpu import tokens as jtk
    from mmada_parallel_tpu.samplers import parallel_ti2ti as JT
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import LLaDAConfig
    from mmada_parallel_torch.samplers import parallel_ti2ti as TT
    prompt = _ti2ti_prompt(tk, _torch_tokens())
    ids, lay = tk.assemble_ti2ti_sequence(prompt, 8, 2, 3, [9],
                                          tokens=_torch_tokens())
    cfg = LLaDAConfig.tiny(**_cfg_kw(vocab_size=TVS + CB,
                                     mask_token_id=MASK))
    fin, codes = TT.generate_ti2ti(
        _bridged(ring["sampler_params"]["ti2ti"]), cfg,
        torch.as_tensor(ids)[None], lay, _ti2ti_opts(TT),
        uncond_image_prefix=np.asarray(prompt))
    jids, jlay = jtk.assemble_ti2ti_sequence(prompt, 8, 2, 3, [9],
                                             tokens=_jax_tokens())
    jcfg = _jax_cfg(vocab_size=TVS + CB, mask_token_id=MASK)
    jfin, jcodes = jax.jit(lambda p, i: JT.generate_ti2ti(
        p, jcfg, i, jlay, _ti2ti_opts(JT),
        uncond_image_prefix=np.asarray(prompt, np.int32)))(
        ring["sampler_params"]["ti2ti"], jnp.asarray(jids, jnp.int32)[None])
    np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    for res in ring["ranks"]:
        np.testing.assert_array_equal(res["ti2ti"][0], fin.numpy())
        np.testing.assert_array_equal(res["ti2ti"][1], codes.numpy())


def test_interleave_generate_over_ring_matches_solo(ring):
    """Variant M over the ring (the batch-2 cond+uncond forwards) equals
    the torch and JAX solo runs at temperature 0, on every rank."""
    import jax
    import jax.numpy as jnp
    from mmada_parallel_tpu import tokens as jtk
    from mmada_parallel_tpu.samplers import interleave as JI
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import LLaDAConfig
    from mmada_parallel_torch.samplers import interleave as TI
    tok_m = _torch_tokens_m()
    ids, lay = tk.assemble_interleave_sequence(
        [10, 11, 12, 13, 14], num_vq_tokens=8, max_seq_length=9,
        tokens=tok_m)
    un_ids, _ = tk.assemble_interleave_sequence(
        [30, 31, 32, 33, 34], num_vq_tokens=8, max_seq_length=9,
        tokens=tok_m)
    assert lay.total_len % G == 0
    cfg = LLaDAConfig.tiny(**_cfg_kw(vocab_size=TVS + CB,
                                     mask_token_id=MASK))
    fin, codes = TI.interleave_generate(
        _bridged(ring["sampler_params"]["interleave"]), cfg,
        torch.as_tensor(ids)[None], torch.as_tensor(un_ids)[None], lay,
        _interleave_opts(TI))
    jtok = jtk.VariantMTokens(soi=251, eoi=250, bos=249, text_vocab_size=TVS,
                              codebook_size=CB)
    jids, jlay = jtk.assemble_interleave_sequence(
        [10, 11, 12, 13, 14], num_vq_tokens=8, max_seq_length=9, tokens=jtok)
    jun, _ = jtk.assemble_interleave_sequence(
        [30, 31, 32, 33, 34], num_vq_tokens=8, max_seq_length=9, tokens=jtok)
    jcfg = _jax_cfg(vocab_size=TVS + CB, mask_token_id=MASK)
    jfin, jcodes = jax.jit(lambda p: JI.interleave_generate(
        p, jcfg, jnp.asarray(jids)[None], jnp.asarray(jun)[None], jlay,
        _interleave_opts(JI), key=None))(ring["sampler_params"]["interleave"])
    np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    for res in ring["ranks"]:
        np.testing.assert_array_equal(res["interleave"][0], fin.numpy())
        np.testing.assert_array_equal(res["interleave"][1], codes.numpy())


def test_ti2ti_server_over_ring(ring):
    """``TI2TIServer(hidden_fn=ring_hidden_fn(mesh))`` on 8 ranks: rank 0
    takes three requests from three threads, two of one length and one 8
    longer; requests group by exact length (no rounding, no mask), the
    other ranks follow rank 0's batches, every rank's ``close()`` returns
    once rank 0 closes, and each request's row equals its solo run."""
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.llada import LLaDAConfig
    from mmada_parallel_torch.samplers import parallel_ti2ti as TT
    srv = ring["ranks"][0]["server"]
    prompts = srv["prompts"]
    assert srv["buckets"] == [len(p) for p in prompts]
    assert srv["stats"]["requests"] == 3 and srv["stats"]["batches"] >= 2
    assert all(res["server_closed"] for res in ring["ranks"])
    cfg = LLaDAConfig.tiny(**_cfg_kw(vocab_size=TVS + CB,
                                     mask_token_id=MASK))
    params = _bridged(ring["sampler_params"]["server"])
    for prompt, out in zip(prompts, srv["results"]):
        ids, lay = tk.assemble_ti2ti_sequence(prompt, 8, 2, 3, [9],
                                              tokens=_torch_tokens())
        fin, codes = TT.generate_ti2ti(params, cfg,
                                       torch.as_tensor(ids)[None], lay,
                                       _ti2ti_opts(TT))
        np.testing.assert_array_equal(out["codes"], codes[0].numpy())
        np.testing.assert_array_equal(
            out["text_ids"], fin[0, lay.text_start:lay.text_end].numpy())


def test_ti2ti_server_refuses_what_the_ring_cannot_split(ring):
    """Rank 0 checks a batch against the ring before sending it: a layout
    length that 8 does not divide is refused with the ring's own
    ``ValueError``, the followers never see it, and the next request is
    served as before."""
    srv = ring["ranks"][0]["server"]
    assert srv["refused"] is not None
    assert "not divisible by g=8" in srv["refused"]
    np.testing.assert_array_equal(srv["again"]["codes"],
                                  srv["results"][0]["codes"])
    assert all(res["server_closed"] for res in ring["ranks"])


def test_ti2ti_server_follower_failure_ends_the_job(tmp_path):
    """A follower that fails partway through a batch dies (its
    ``close()`` re-raises), and rank 0 does not hang: its request fails,
    later requests fail with the same cause, and its ``close()`` raises,
    all well inside the deadline."""
    from mmada_parallel_torch.parallel.launch import spawn_ranks
    t0 = time.time()
    outs = spawn_ranks(_failing_follower_rank, 2, tmp_path, timeout=120)()
    assert time.time() - t0 < 100
    lead, follower = outs
    assert follower.exitcode not in (0, None)
    assert "injected fault in ring round 5" in follower.error
    assert "SPMD server failed on rank 1" in follower.error
    assert lead.exitcode == 0 and lead.error is None, lead
    res = lead.result
    assert res["submit"] is not None and "Timeout" not in res["submit"]
    assert "failed on an earlier batch" in res["again"]
    assert "SPMD server failed on rank 0" in res["close"]


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a card")
def test_gloo_cannot_send_a_cuda_tensor_unstaged(tmp_path):
    """Why ``ring_permute`` stages CUDA tensors through host memory on a
    gloo group: two gloo ranks on one card, sending a CUDA tensor as it
    is, do not deliver it (the sending rank aborts, or the pair fails)."""
    from mmada_parallel_torch.parallel.launch import spawn_ranks
    outs = spawn_ranks(_gloo_cuda_rank, 2, tmp_path, device_type="cuda",
                       timeout=60)()
    print("gloo, an unstaged CUDA tensor: exit codes",
          [o.exitcode for o in outs], "received equal:", outs[1].result)
    assert outs[1].result is not True


def _ring_slice(a, spec, mesh_shape, rank):
    """``a``'s block on ``rank`` of a ``(data, 1, tensor)`` mesh."""
    data, tensor = mesh_shape
    coord = {"data": rank // tensor, "fsdp": 0, "tensor": rank % tensor}
    size = {"data": data, "fsdp": 1, "tensor": tensor}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        n, idx = 1, 0
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            n, idx = n * size[name], idx * size[name] + coord[name]
        step = a.shape[dim] // n
        a = np.take(a, range(idx * step, (idx + 1) * step), axis=dim)
    return a


def _ring_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ring_leaves(v, f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


def _check_ring_leaves(got, want, kv, rtol, what):
    from mmada_parallel_torch.models.llada import LLaDAConfig
    from mmada_parallel_torch.models.llada import param_shardings
    specs = _ring_leaves(param_shardings(LLaDAConfig.tiny(
        **_cfg_kw(n_kv_heads=kv))))
    want = {k: v.detach().numpy() for k, v in _ring_leaves(want).items()}
    assert set(want) == set(got[0])
    for r, rank_leaves in enumerate(got):
        for name, a in want.items():
            scale = max(float(np.max(np.abs(a))), 1.0)
            np.testing.assert_allclose(
                rank_leaves[name], _ring_slice(a, specs[name], RING_KV[kv],
                                               r),
                rtol=rtol, atol=rtol * scale,
                err_msg=f"rank {r} {what} {name}")


@pytest.mark.parametrize("kv", list(RING_KV))
def test_ring_backbone_gradients_match_jax(ring, kv):
    """JAX's ``test_ring_backbone_gradients_match_gspmd``: the gradient of
    ``sum(hidden ** 2)`` through the ring, synced by the ring's rule
    (``training/trainer.py:_ring_syncs``: tensor-split leaves, the
    vocab-parallel ``wte`` among them, over ``data``, the chunk-local
    ``ln_f`` and norms over ``tensor`` and ``data``), equals each rank's slice of ``jax.grad`` of the
    unsharded ``llada_hidden`` at JAX's tolerance, 5e-4 (kv 4: 8 q heads
    over 4 kv, on 4-wide rings with data=2)."""
    got = [res[f"ring_grads/{kv}"] for res in ring["ranks"]]
    _check_ring_leaves(got, ring["ring_train"][kv]["grads"], kv, 5e-4,
                       "grad")


@pytest.mark.parametrize("kv", list(RING_KV))
def test_ring_train_step_matches_jax(ring, kv):
    """JAX's ``test_ring_train_step_matches_gspmd``: two steps of the
    sharded step on the ring (AdamW, clip, ``accum_steps=2``, the A loss)
    give JAX's whole-batch losses (rtol 1e-4) and each rank's slice of its
    updated parameters (5e-4, scaled by the leaf's largest value)."""
    want = ring["ring_train"][kv]
    for r, res in enumerate(ring["ranks"]):
        losses, _ = res[f"ring_step/{kv}"]
        np.testing.assert_allclose(losses, want["losses"], rtol=1e-4,
                                   err_msg=f"rank {r}")
    _check_ring_leaves([res[f"ring_step/{kv}"][1] for res in ring["ranks"]],
                       want["params"], kv, 5e-4, "param")


def test_bf16_ring_at_depth_stays_within_bf16_noise(ring):
    """All 32 layers of a narrowed ``llada_8b`` in bf16 over rings of 4
    (data=2 x tensor=4): the ring's hidden state differs from the solo bf16
    forward by the bf16 rounding its reduce-scatter adds (its partial sums
    round in bf16 where the solo GEMM does not), no more than twice the
    solo bf16 forward's own distance from f32, and no more than 0.25 in
    any value (the largest difference ``chip_smoke.py`` allows the 8B
    ring)."""
    solo, f32 = ring["deep"]["bf16"], ring["deep"]["f32"]

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    noise = rel(solo, f32)
    for res in ring["ranks"]:
        got = torch.from_numpy(res["deep"])
        assert rel(got, solo) <= min(2 * noise, 0.05), (rel(got, solo),
                                                         noise)
        assert float((got - solo).abs().max()) <= 0.25

