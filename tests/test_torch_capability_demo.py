"""The port's capability demos (``mmada_parallel_torch/examples``) against
the JAX package's (``examples/``).

Per training demo (M, A, multitask): the batch the port builds equals the
JAX demo's row for row, from the same numpy seed and the same noising
uniforms (drawn with ``jax.random`` as the JAX demo draws them and fed to
the port's private ``_*_apply`` steps in place of its generator draws);
and the demo's loss and gradients on that batch, with weights bridged by
``models/from_jax.py``, equal JAX's at rtol 1e-5 / atol 1e-6 (f32).

On the JAX-trained models (the JAX demos' own runs with the test suite's
fixture stores, so a warm cache skips their training) the port's evals
give JAX's codes and texts exactly at temperature 0: the M and A evals
exact, through the cached samplers and on int8 params (head quantized and
dense), the multitask t2i/mmu sweeps and the ParaBench demo's sweep.  The
A sampler fills a cell left masked at the end with a random code when it
is given a generator, as the ParaBench sweep is, and the two packages draw
different codes: those cells are found by a deterministic solo run and
compared through that rule, and JAX's scores are recomputed with the
port's fills before the aggregates are compared.  Also: each demo runs
end to end on the CPU and writes its artifacts, and ParaRL's short run is
finite."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import fixture_store_path

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

import train_edit_demo as JM  # noqa: E402
import train_edit_demo_a as JA  # noqa: E402
import train_multitask_demo as JMT  # noqa: E402
from test_capability_demo import _M_SOURCES, _MT_SOURCES  # noqa: E402

from mmada_parallel_torch.eval_scorers import aggregate_scores  # noqa: E402
from mmada_parallel_torch.examples import parabench_demo as PB  # noqa: E402
from mmada_parallel_torch.examples import \
    pararl_resteer_demo as PRL  # noqa: E402
from mmada_parallel_torch.examples import train_edit_demo as TM  # noqa: E402
from mmada_parallel_torch.examples import \
    train_edit_demo_a as TA  # noqa: E402
from mmada_parallel_torch.examples import \
    train_multitask_demo as TMT  # noqa: E402
from mmada_parallel_torch.models.from_jax import \
    llada_params_from_jax  # noqa: E402
from mmada_parallel_torch.ops import sampling as TS  # noqa: E402
from mmada_parallel_torch.ops.quant import \
    quantize_llada_params  # noqa: E402
from mmada_parallel_torch.samplers.parallel_ti2ti import \
    generate_ti2ti  # noqa: E402
from mmada_parallel_torch.training import masking as TMK  # noqa: E402

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)

# the settings of the JAX capability tests' trained fixtures
M_KW = dict(steps=800, batch=32, lr=1.5e-3, log_every=200)
A_KW = dict(steps=800, batch=32, lr=3e-3, log_every=400)
MT_KW = dict(steps=1000, batch=16, lr=1.5e-3, log_every=250)
M_CACHED = ({"cache_ratio": 0.5, "refresh_interval": 3, "warmup_ratio": 0.25},
            {"cache_ratio": 0.5, "refresh_interval": 3, "warmup_ratio": 0.25,
             "refresh_on_image_steps": False})
A_CACHED = ({"cache_ratio": 0.5, "refresh_interval": 3, "warmup_ratio": 0.25},
            {"cache_ratio": 0.3, "refresh_interval": 4, "warmup_ratio": 0.25})


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bridge(jparams):
    return llada_params_from_jax(_np(jparams))


def _t(x):
    return torch.tensor(np.asarray(x))


def _assert_loss_and_grads(jax_loss, torch_loss, jparams, jbatch, tbatch):
    """``jax_loss(p, batch) -> (loss, aux)`` and ``torch_loss`` on bridged
    weights: the loss, the aux losses and every gradient leaf."""
    (jl, jaux), jg = jax.value_and_grad(jax_loss, has_aux=True)(jparams,
                                                                jbatch)
    tp = _bridge(jparams)
    leaves = jax.tree_util.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, taux = torch_loss(tp, tbatch)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **GRAD_TOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   **GRAD_TOL)
    for g, w in zip(leaves, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), **GRAD_TOL)


def _init(mod, T):
    """The JAX demo's model at its ``init_llada_params(key(0), cfg)``."""
    from mmada_parallel_tpu.models import LLaDAConfig, init_llada_params
    cfg = LLaDAConfig.tiny(d_model=128, n_heads=4, n_kv_heads=4,
                           mlp_hidden_size=256, vocab_size=T.full_vocab_size,
                           mask_token_id=T.mask)
    return cfg, init_llada_params(jax.random.key(0), cfg)


# ---------------------------------------------------------------------------
# Batches, losses and gradients
# ---------------------------------------------------------------------------


def _jax_interleave_uniforms(key, B, N, T):
    k1, k2, k3 = jax.random.split(key, 3)
    return (_t(jax.random.uniform(k1, (B,))), _t(jax.random.uniform(k2, (B, N))),
            _t(jax.random.uniform(k3, (B, T))))


def test_m_batch_loss_and_grads_equal_jax(monkeypatch):
    from mmada_parallel_tpu.data.prompting import UniversalPrompting as JUP
    from mmada_parallel_tpu.models import llada_forward
    from mmada_parallel_tpu.training.losses import m_interleave_loss
    from mmada_parallel_torch.data.prompting import UniversalPrompting as TUP

    B, key = 6, jax.random.key(11)
    jT, tT = JM.demo_tokens(), TM.demo_tokens()
    jb, jcodes = JM.make_batch(np.random.default_rng(3), B, jT,
                               JUP(JM.WordTok(), max_text_len=JM.MSL - 1,
                                   tokens=jT, rng=np.random.default_rng(0)),
                               key)

    def noising(generator, img, text, mask_token):
        # the JAX demo's draws from ``key``, through the port's apply step
        return TMK._interleave_noising_apply(
            img, text, *_jax_interleave_uniforms(key, B, img.shape[1],
                                                 text.shape[1]),
            1e-3, TS.cosine_schedule, mask_token)

    monkeypatch.setattr(TM, "interleave_noising", noising)
    tb, tcodes = TM.make_batch(np.random.default_rng(3), B, tT,
                               TUP(TM.WordTok(), max_text_len=TM.MSL - 1,
                                   tokens=tT, rng=np.random.default_rng(0)),
                               torch.Generator())
    np.testing.assert_array_equal(tcodes, jcodes)
    for g, w in zip(tb, jb):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))

    cfg, jp = _init(JM, jT)

    def jax_loss(p, b):      # the JAX demo's loss_fn
        ids, labels, mask, t = b
        out = m_interleave_loss(llada_forward(p, cfg, ids, mask.astype(bool)),
                                labels, t, JM.MSL, JM.N_VQ)
        return out["loss"], {"text_loss": out["text_loss"],
                             "image_loss": out["image_loss"]}

    _assert_loss_and_grads(jax_loss, TM.make_loss_fn(TM.demo_config(tT)), jp,
                           tuple(map(jnp.asarray, jb)),
                           tuple(map(torch.as_tensor, tb)))


def test_a_batch_loss_and_grads_equal_jax(tmp_path):
    import random

    from mmada_parallel_tpu.data.item_processor import AItemProcessor as JAIP
    from mmada_parallel_tpu.models import llada_forward
    from mmada_parallel_tpu.training.losses import a_variant_losses
    from mmada_parallel_torch.data.item_processor import \
        AItemProcessor as TAIP

    jT, tT = JA.demo_tokens(), TA.demo_tokens()
    jitems = JA.write_grid_pickles(str(tmp_path / "j"), 16,
                                   np.random.default_rng(0))
    titems = TA.write_grid_pickles(str(tmp_path / "t"), 16,
                                   np.random.default_rng(0))
    jproc = JAIP(tokenizer=JA.WordTokA(), tokens=jT, uncondition_prob=0.0,
                 rng=random.Random(0))
    tproc = TAIP(tokenizer=TA.WordTokA(), tokens=tT, uncondition_prob=0.0,
                 rng=random.Random(0))
    rows = np.random.default_rng(0).integers(0, 16, 8)

    def jax_collate(rows):   # the JAX demo's collate
        toks, labs = zip(*(jproc.process_item(jitems[r]) for r in rows))
        L = max(len(t) for t in toks)
        ids = np.zeros((len(toks), L), np.int32)
        labels = np.full((len(toks), L), -100, np.int32)
        for r, (t, l) in enumerate(zip(toks, labs)):
            ids[r, :len(t)] = t
            labels[r, :len(l)] = l
        return ids, labels, np.asarray([len(t) for t in toks], np.int32)

    for _ in range(2):       # the item processor's rng carries across
        jb, tb = jax_collate(rows), TA.collate(tproc, titems, rows)
        for g, w in zip(tb, jb):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    cfg, jp = _init(JA, jT)

    def jax_loss(p, b):      # the JAX demo's loss_fn
        ids, labels, lengths = b
        out = a_variant_losses(
            llada_forward(p, cfg, ids), ids, labels, lengths,
            answer_start_token=jT.answer_start,
            answer_end_token=jT.answer_end, image_start_token=jT.boi,
            image_end_token=jT.eoi, newline_token=jT.newline)
        return out["loss"], {"text_loss": out["text_loss"],
                             "image_loss": out["image_loss"]}

    _assert_loss_and_grads(jax_loss,
                           TA.make_loss_fn(TA.demo_config(tT), tT), jp,
                           tuple(map(jnp.asarray, jb)),
                           tuple(map(torch.as_tensor, tb)))


def test_multitask_batch_loss_and_grads_equal_jax(monkeypatch):
    from mmada_parallel_tpu.data.prompting import UniversalPrompting as JUP
    from mmada_parallel_tpu.training.m_tasks import forward_process_separate
    from mmada_parallel_torch.data.prompting import UniversalPrompting as TUP

    B, k_t2i, k_mmu = 6, jax.random.key(5), jax.random.key(6)
    jT, tT = JMT.demo_tokens(), TMT.demo_tokens()

    def ups(mod, UP, T):
        return (UP(mod.WordTok(), max_text_len=mod.T2I_PAD - 1,
                   cond_dropout_prob=0.5, tokens=T,
                   rng=np.random.default_rng(0)),
                UP(mod.WordTok(), max_text_len=mod.MMU_SPAN, tokens=T))

    jup, tup = ups(JMT, JUP, jT), ups(TMT, TUP, tT)
    jrng, trng = np.random.default_rng(2), np.random.default_rng(2)
    jt2i = JMT.make_t2i_batch(jrng, B, jT, jup[0], k_t2i)
    jmmu = JMT.make_mmu_batch(jrng, B, jT, jup[1], k_mmu)

    def schedule(generator, codes, mask_token, codebook_size):
        # the JAX mask_tokens_schedule's draws from ``k_t2i``
        k1, k2, _, _ = jax.random.split(k_t2i, 4)
        return TMK._mask_tokens_schedule_apply(
            codes, _t(jax.random.uniform(k1, (B,))),
            _t(jax.random.uniform(k2, codes.shape)), None, None,
            TS.cosine_schedule, 0.0, mask_token, "mask", False, False)

    def mmu_uniforms(generator, n):
        k1, k2 = jax.random.split(k_mmu)
        return (np.asarray(jax.random.uniform(k1, (n,))),
                np.asarray(jax.random.uniform(k2, (n, TMT.MMU_SPAN))))

    monkeypatch.setattr(TMT, "mask_tokens_schedule", schedule)
    monkeypatch.setattr(TMT, "_mmu_uniforms", mmu_uniforms)
    tt2i = TMT.make_t2i_batch(trng, B, tT, tup[0], torch.Generator())
    tmmu = TMT.make_mmu_batch(trng, B, tT, tup[1], torch.Generator())
    for got, want in ((tt2i, jt2i), (tmmu, jmmu)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (tt2i["input_ids"][:, 1] == tT.bos).any()   # a dropped condition

    cfg, jp = _init(JMT, jT)

    def jax_loss(p, b):      # the JAX demo's loss_fn
        out = forward_process_separate(p, cfg, max_seq_length=JMT.T2I_PAD,
                                       t2i=b[0], mmu=b[1])
        return out["loss_t2i"] + out["loss_mmu"], {
            "loss_t2i": out["loss_t2i"], "loss_mmu": out["loss_mmu"]}

    def on(b, f):
        return {k: f(v) for k, v in b.items()}

    _assert_loss_and_grads(
        jax_loss, TMT.make_loss_fn(TMT.demo_config(tT)), jp,
        (on(jt2i, jnp.asarray), on(jmmu, jnp.asarray)),
        (on(tt2i, torch.as_tensor), on(tmmu, torch.as_tensor)))


# ---------------------------------------------------------------------------
# The JAX-trained models through the port's evals
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_m():
    m, params, cfg, T, tokz = JM.run_demo(
        out_dir=None, return_params=True,
        param_store=fixture_store_path("edit_demo_m", _M_SOURCES, **M_KW),
        **M_KW)
    assert m["eval_code_accuracy"] >= 0.9, m
    return params, cfg, T, tokz, _bridge(params)


@pytest.fixture(scope="module")
def trained_a(tmp_path_factory):
    work = tmp_path_factory.mktemp("edit_demo_a")
    m, params, cfg, T, tokz = JA.run_demo_a(
        out_dir=None, work_dir=str(work / "grids"), return_params=True,
        param_store=fixture_store_path("edit_demo_a", JA.DEMO_SOURCES,
                                       **A_KW), **A_KW)
    assert m["eval_code_accuracy"] >= 0.85, m
    return m, params, cfg, T, tokz, _bridge(params)


def _same_eval(got, want):
    """The eval tuples: accuracies, codes, texts (and inputs) equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, list) and w and isinstance(w[0], str):
            assert g == w
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("mode", ["exact", "cached0", "cached1", "int8",
                                  "int8-dense-head"])
def test_m_eval_on_the_jax_trained_model(trained_m, mode):
    from mmada_parallel_tpu.ops.quant import quantize_llada_params as jquant
    jparams, cfg, T, tokz, tparams = trained_m
    tT, tcfg, kw = TM.demo_tokens(), TM.demo_config(TM.demo_tokens()), {}
    if mode.startswith("cached"):
        kw = dict(M_CACHED[int(mode[-1])], use_cached=True)
    elif mode.startswith("int8"):
        qh = mode == "int8"
        jparams = jax.jit(functools.partial(jquant, quantize_head=qh))(
            jparams)
        tparams = quantize_llada_params(tparams, quantize_head=qh)
    want = JM.eval_palette_model(jparams, cfg, T, tokz, **kw)
    got = TM.eval_palette_model(tparams, tcfg, tT, TM.WordTok(), **kw)
    _same_eval(got, want)
    assert np.mean(got[0]) >= 0.9 and "rotated" in got[2][0]


def _record_final_ids(monkeypatch, module, names):
    """Wrap ``module``'s samplers ``names`` to keep each call's final ids
    (host arrays) in the returned list."""
    finals = []
    for name in names:
        def wrapped(*a, _fn=getattr(module, name), **kw):
            fin, codes = _fn(*a, **kw)
            finals.append(np.asarray(fin.cpu() if isinstance(
                fin, torch.Tensor) else fin)[0])
            return fin, codes
        monkeypatch.setattr(module, name, wrapped)
    return finals


def _record_remask_confidences(monkeypatch):
    """Wrap both packages' ``remask_lowest_exact`` (the A sampler's image
    re-mask) to keep each call's confidences (row 0, f32; the cells
    already decided hold the f32 max) in the returned lists."""
    from mmada_parallel_tpu.ops import sampling as JS
    jconf, tconf = [], []
    jfn, tfn = JS.remask_lowest_exact, TS.remask_lowest_exact

    def jwrap(key, mask_len, probs, temperature):
        jax.debug.callback(lambda p: jconf.append(np.asarray(p)[0]), probs,
                           ordered=True)
        return jfn(key, mask_len, probs, temperature)

    def twrap(mask_len, probs, temperature, z=None):
        tconf.append(probs[0].detach().cpu().numpy().copy())
        return tfn(mask_len, probs, temperature, z)

    monkeypatch.setattr(JS, "remask_lowest_exact", jwrap)
    monkeypatch.setattr(TS, "remask_lowest_exact", twrap)
    return jconf, tconf


def _assert_rounding_tie(jconf, tconf, r, j_still, t_still, rows=4):
    """Row ``r``'s sampler call ends with other cells masked in each
    package: at the first re-mask whose choices differ, both started from
    the same masked cells, and every confidence among them is within
    2**-21 of 1.0 in both packages."""
    n = len(tconf) // rows
    assert len(jconf) == len(tconf) == n * rows
    top = np.finfo(np.float32).max
    for st in range(n):
        j, t = jconf[r * n + st], tconf[r * n + st]
        j_next = jconf[r * n + st + 1] < top if st + 1 < n else j_still
        t_next = tconf[r * n + st + 1] < top if st + 1 < n else t_still
        if not np.array_equal(j_next, t_next):
            open_ = j < top
            np.testing.assert_array_equal(open_, t < top)
            assert (j[open_] >= 1 - 2 ** -21).all(), j[open_]
            assert (t[open_] >= 1 - 2 ** -21).all(), t[open_]
            return
    raise AssertionError(f"row {r}: no re-mask choice differs")


@pytest.mark.parametrize("mode", ["exact", "cached0", "cached1", "int8",
                                  "int8-dense-head"])
def test_a_eval_on_the_jax_trained_model(trained_a, mode, monkeypatch):
    """Texts equal; codes equal at every cell that neither run leaves
    masked.  At temperature 0 the trained model's image confidences sit at
    1.0 and an f32 ulp or two below it, and XLA's and PyTorch's softmax
    round them differently, so a re-mask may keep other cells masked in
    each package, and the one cell the A sampler's last re-mask keeps
    masked (filled with code 0) may be another cell.  That tie is shown:
    where the packages end with other cells masked, at the first re-mask
    whose choices differ, both packages start from the same masked cells,
    and every confidence among them is within 2**-21 of 1.0 in both."""
    from mmada_parallel_tpu.ops.quant import quantize_llada_params as jquant
    from mmada_parallel_tpu.samplers import parallel_ti2ti as JT
    _, jparams, cfg, T, tokz, tparams = trained_a
    tT, tcfg, kw = TA.demo_tokens(), TA.demo_config(TA.demo_tokens()), {}
    if mode.startswith("cached"):
        kw = dict(A_CACHED[int(mode[-1])], use_cached=True)
    elif mode.startswith("int8"):
        qh = mode == "int8"
        jparams = jax.jit(functools.partial(jquant, quantize_head=qh))(
            jparams)
        tparams = quantize_llada_params(tparams, quantize_head=qh)
    names = ("generate_ti2ti", "generate_ti2ti_cached")
    jfin = _record_final_ids(monkeypatch, JT, names)
    tfin = _record_final_ids(monkeypatch, TA, names)
    jconf, tconf = _record_remask_confidences(monkeypatch)
    jaccs, jcodes, jtexts, jin = JA.eval_a_model(jparams, cfg, T, tokz, **kw)
    taccs, tcodes, ttexts, tin = TA.eval_a_model(tparams, tcfg, tT,
                                                 TA.WordTokA(), **kw)
    assert ttexts == jtexts and len(tfin) == len(jfin) == 4
    _, lay, _ = TA.assemble_eval_sequence(TA.WordTokA(), tT, tin[0])
    pos = lay.image_positions()
    for r in range(4):
        np.testing.assert_array_equal(tin[r], jin[r])
        t_still, j_still = tfin[r][pos] == tT.mask, jfin[r][pos] == T.mask
        assert t_still.sum() == j_still.sum() >= 1
        keep = ~(t_still | j_still)
        np.testing.assert_array_equal(tcodes[r][keep], jcodes[r][keep])
        assert abs(taccs[r] - jaccs[r]) <= (~keep).sum() / TA.N_VQ
        if not np.array_equal(t_still, j_still):
            _assert_rounding_tie(jconf, tconf, r, j_still, t_still)
    assert np.mean(taccs) >= 0.85 and ttexts[0] == "rotated colors done"


def test_int8_ring_preserves_trained_task_accuracy(trained_a, tmp_path):
    """JAX's test of this name on the port: the JAX-trained A model's eval
    (64 tokens, maskless, B=1) over a ring of 4 spawned CPU ranks (gloo).
    The exact ring gives the solo accuracy, the int8 payload stays within
    0.1 of it, and both keep "rotated" in the text, on every rank."""
    from test_torch_tp_overlap import _demo_ring_rank, start_ranks
    tparams = trained_a[5]
    tT = TA.demo_tokens()
    base = float(np.mean(TA.eval_a_model(tparams, TA.demo_config(tT), tT,
                                         TA.WordTokA())[0]))
    torch.save(tparams, tmp_path / "params.pt")
    ranks = start_ranks(_demo_ring_rank, 4, tmp_path, timeout=240)()
    for res in ranks:
        accs, texts = res["exact"]
        assert float(np.mean(accs)) == pytest.approx(base), (accs, base)
        assert "rotated" in texts[0], texts
        accs_q, texts_q = res["int8"]
        assert float(np.mean(accs_q)) >= base - 0.1, (accs_q, base)
        assert "rotated" in texts_q[0], texts_q
        assert res == ranks[0]


def test_multitask_sweeps_on_the_jax_trained_model():
    m, jparams, cfg, T, tokz = JMT.run_demo(
        out_dir=None, return_params=True,
        param_store=fixture_store_path("multitask_demo", _MT_SOURCES,
                                       **MT_KW), **MT_KW)
    want = JMT.eval_sweeps(jparams, cfg, T, tokz)
    got = TMT.eval_sweeps(_bridge(jparams), TMT.demo_config(
        TMT.demo_tokens()), TMT.demo_tokens(), TMT.WordTok())
    for task in ("t2i", "mmu"):
        assert got[task]["agg"] == want[task]["agg"], task
        gres, wres = got[task]["sweep"]["results"], want[task]["sweep"][
            "results"]
        assert len(gres) == len(wres) == 8
        for g, w in zip(gres, wres):
            assert g["meta"] == w["meta"] and g["scores"] == w["scores"]
            if task == "t2i":
                np.testing.assert_array_equal(g["codes"], w["codes"])
            else:
                assert g["text"] == w["text"]
    assert got["t2i"]["agg"]["target_match"] >= 0.9
    assert got["mmu"]["agg"]["text_alignment"] >= 0.9


def test_parabench_demo_on_the_jax_trained_model(trained_a, monkeypatch):
    """The ParaBench demo's sweep: texts equal, and codes equal at every
    cell that neither package's deterministic solo run of the request
    leaves masked.  The sweep passes a generator, so a cell still masked at
    the end gets a random code, which the packages draw differently (and
    which cell that is may differ, see the A eval test); JAX's results with
    the port's codes at those cells score as the port's do, and the
    aggregates follow."""
    import parabench_demo as JPB
    from mmada_parallel_tpu import evaluation as JE
    from mmada_parallel_tpu.samplers import parallel_ti2ti as JT

    m, jparams, cfg, T, _, tparams = trained_a
    sweeps = {}

    def spy(store, fn):
        def run(*a, **kw):
            sweeps[store] = fn(*a, **kw)
            return sweeps[store]
        return run

    monkeypatch.setattr(JE, "run_parabench_sweep",
                        spy("jax", JE.run_parabench_sweep))
    monkeypatch.setattr(PB, "run_parabench_sweep",
                        spy("torch", PB.run_parabench_sweep))
    want = JPB.run(None, 8, steps=800)
    tT, tcfg = TA.demo_tokens(), TA.demo_config(TA.demo_tokens())
    tokz = TA.WordTokA()
    got = PB.run(None, 8, device="cpu",
                 trained=(m, tparams, tcfg, tT, tokz))

    scorer = PB.pixel_edit_scorer(PB.palette_decoder(),
                                  base=PB.default_edit_scorer())
    ans_len = len(tokz("rotated colors done")["input_ids"])
    opts = dict(text_steps=ans_len, timesteps=8, temperature=0.0,
                text_temperature=0.0, cfg_scale=0.0, cfg_img=0.0,
                text_vocab_size=TA.TVS, codebook_size=TA.CB,
                mask_token=tT.mask)
    end_ids = tokz("</answer>", add_special_tokens=False)["input_ids"]
    rescored = []
    for req, g, w in zip(PB.build_requests(tokz, tT),
                         sweeps["torch"]["results"],
                         sweeps["jax"]["results"]):
        ids, lay = PB.tk.assemble_ti2ti_sequence(
            list(req.prompt_ids), ans_len, TA.GRID, TA.GRID, end_ids,
            tokens=tT)
        tfin, tcodes = generate_ti2ti(tparams, tcfg, torch.tensor(ids)[None],
                                      lay, PB.TI2TIOptions(**opts))
        jfin, _ = JT.generate_ti2ti(jparams, cfg, jnp.asarray(ids)[None],
                                    lay, JT.TI2TIOptions(**opts))
        pos = lay.image_positions()
        still = ((tfin[0].numpy()[pos] == tT.mask)
                 | (np.asarray(jfin)[0][pos] == tT.mask))
        assert still.any()
        assert g["text"] == w["text"] and g["meta"] == w["meta"]
        np.testing.assert_array_equal(g["codes"][~still],
                                      np.asarray(w["codes"])[~still])
        np.testing.assert_array_equal(g["codes"][~still],
                                      tcodes[0].numpy()[~still])
        jcodes = np.where(still, g["codes"], np.asarray(w["codes"]))
        rescored.append({"scores": scorer(req, w["text"], jcodes)})
        assert rescored[-1]["scores"] == g["scores"]
    agg = aggregate_scores(rescored)
    assert got["aggregate"] == {k: round(v, 4) for k, v in agg.items()}
    assert got["aggregate"]["text_alignment"] == want["aggregate"][
        "text_alignment"]
    assert [r["text"] for r in got["per_request"]] == [
        r["text"] for r in want["per_request"]]
    assert got["n_requests"] == want["n_requests"] == 8
    assert got["aggregate"]["target_match"] >= 0.85
    assert got["aggregate"]["text_alignment"] >= 0.9


@pytest.mark.parametrize("mod", [TM, TA, TMT], ids=["m", "a", "multitask"])
def test_demo_configs_ask_for_the_plain_attention(mod):
    """The demos' head_dim 32 is not the kernels': each demo's config asks
    for the plain attention itself, and ``auto`` off the CPU is left to
    launch a kernel (or raise) whatever the head_dim."""
    from mmada_parallel_torch.ops import attention as OA
    cfg = mod.demo_config(mod.demo_tokens())
    assert (cfg.head_dim, cfg.attention_impl) == (32, "xla")
    assert OA._use_kernel("auto", torch.empty(1, device="meta"))
    assert not OA._use_kernel(cfg.attention_impl,
                              torch.empty(1, device="meta"))


@pytest.mark.cuda
def test_auto_raises_at_the_demos_head_dim_on_cuda():
    """``auto`` on CUDA tensors of head_dim 32 raises (the kernel does not
    take it) rather than running the plain chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    from mmada_parallel_torch.ops import attention as OA
    q = torch.zeros(1, 16, 4 * 32, device="cuda")
    sin = cos = torch.zeros(16, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        OA.rope_attention(q, q, q, sin, cos, n_heads=4, impl="auto")


# ---------------------------------------------------------------------------
# The demos end to end on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("demo", ["m", "a", "multitask"])
def test_demo_runs_end_to_end(demo, tmp_path):
    """Two training steps, the checkpoint round trip into other weights,
    the eval and the artifacts."""
    out = tmp_path / demo
    if demo == "a":
        m = TA.run_demo_a(steps=2, out_dir=str(out), device="cpu")
    else:
        mod = TM if demo == "m" else TMT
        m = mod.run_demo(steps=2, out_dir=str(out), device="cpu")
    assert m["steps"] == 2 and np.isfinite(m["final_loss"])
    assert (out / "ckpt" / "2" / "state.pt").exists()
    assert json.loads((out / "metrics.json").read_text()) == m
    assert len((out / "loss_curve.jsonl").read_text().splitlines()) == 2
    png = "t2i0_generated.png" if demo == "multitask" else \
        "sample0_generated.png"
    assert (out / png).exists()


def test_demos_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        TA.run_demo_a(steps=1)


def test_param_store_round_trip(tmp_path):
    """A run saves its trained params to the store; a second run loads them
    and skips training (0 steps) with the same eval."""
    store = str(tmp_path / "a.npz")
    m1 = TA.run_demo_a(steps=2, param_store=store, device="cpu")
    m2 = TA.run_demo_a(steps=2, param_store=store, device="cpu")
    assert m1["steps"] == 2 and m2["steps"] == 0
    assert m2["per_sample_accuracy"] == m1["per_sample_accuracy"]
    assert m2["generated_text"] == m1["generated_text"]
    a = TA.demo_param_store(steps=1)
    assert os.path.basename(a).startswith("torch_edit_demo_a_")
    assert a != TA.demo_param_store(steps=2)


def test_pararl_demo_update_equals_jax():
    """One update of the ParaRL demo against the JAX demo's: the task (the
    evaluation ids, the target, the rollout options), the rewards and the
    optimizer step on one temperature-1.5 trajectory that JAX sampled from
    the A model at its initial weights (the trained model's rows all earn
    one reward, so its update is vacuous), fed to both: equal rewards, and
    the metrics, the optimizer's first moment and the updated weights at
    the ParaRL tolerance of ``test_torch_pararl.py``."""
    import dataclasses
    from mmada_parallel_tpu.samplers.parallel_ti2ti import \
        TI2TIOptions as JOptions
    from mmada_parallel_tpu.training import pararl as JR
    from mmada_parallel_tpu.training import trainer as JTR
    from mmada_parallel_torch.training.pararl import extract_image_codes
    from mmada_parallel_torch.training.trainer import tree_leaves
    jT, jtokz = JA.demo_tokens(), JA.WordTokA()
    jcfg, jparams = _init(JA, jT)
    tparams = _bridge(jparams)
    tT = TA.demo_tokens()
    ids, lay, target, ropts, _, reward = PRL.resteer_task(TA.WordTokA(), tT)

    # the JAX demo's task, step and loss (``examples/pararl_resteer_demo.py``)
    codes_in = np.random.default_rng(7).integers(0, JA.CB, JA.N_VQ)
    jids, jlay, ans_len = JA.assemble_eval_sequence(jtokz, jT, codes_in)
    jropts = JOptions(text_steps=ans_len, timesteps=8, temperature=1.5,
                      text_temperature=0.7, cfg_scale=0.0, cfg_img=0.0,
                      text_vocab_size=JA.TVS, codebook_size=JA.CB,
                      mask_token=jT.mask)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(target, (codes_in + 1) % JA.CB)
    assert dataclasses.asdict(ropts) == dataclasses.asdict(jropts)
    assert lay.image_positions().tolist() == jlay.image_positions().tolist()
    jreward = JR.RewardSpec(fns=[JR.make_target_match_reward(target)],
                            weights=[1.0])
    fin, traj = JR.rollout_ti2ti(jparams, jcfg,
                                 jnp.asarray(np.stack([jids] * 4)), jlay,
                                 jropts, jax.random.key(3))
    jrw = jreward(fin, JR.extract_image_codes(
        fin, jlay.image_positions(), JA.TVS, JA.CB, jT.mask))
    jopt = JTR.make_optimizer(JTR.OptimizerConfig(
        lr=2e-3, weight_decay=0.0, grad_clip=1.0), jparams)
    jstep = JTR.make_train_step(
        lambda p, b, k: JR.pararl_loss(p, jcfg, b[0], b[1], jropts), jopt)
    jstate, jm = jstep(JTR.TrainState.create(jparams, jopt), (traj, jrw))

    tfin = _t(fin)
    trw = reward(tfin, extract_image_codes(tfin, lay.image_positions(),
                                           TA.TVS, TA.CB, tT.mask))
    np.testing.assert_array_equal(trw.numpy(), np.asarray(jrw))
    assert np.ptp(np.asarray(jrw)) > 0, "no advantage: a vacuous update"
    state, step = PRL.resteer_update(tparams, TA.demo_config(tT), ropts)
    state, tm = step(state, ({k: _t(v) for k, v in traj.items()}, trw))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # the first moment is a tenth of the clipped gradient: held at the
    # gradient tolerance of ``test_torch_pararl.py`` (atol 1e-5 of the
    # largest); the first AdamW step moves a weight by about lr * sign(g),
    # so the weights are held where g stands above that floor
    jmu = [s for s in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(s, "mu")][0].mu
    jmu = [np.asarray(x) for x in jax.tree_util.tree_leaves(jmu)]
    floor = 1e-5 * max(float(np.abs(x).max()) for x in jmu)
    for g, w, m, jm_ in zip(tree_leaves(state.params),
                            jax.tree_util.tree_leaves(jstate.params),
                            tree_leaves(state.opt_state["mu"]), jmu):
        np.testing.assert_allclose(m.numpy(), jm_, rtol=1e-4, atol=floor)
        above = np.abs(jm_) > floor
        np.testing.assert_allclose(g.detach().numpy()[above],
                                   np.asarray(w)[above], rtol=1e-4,
                                   atol=1e-6)


def test_pararl_resteer_runs_on_the_cpu(tmp_path):
    out = PRL.run_resteer(pretrain=4, updates=2, rollout_batch=4,
                          out_dir=str(tmp_path), device="cpu")
    for k in ("pretrain_plus1_accuracy", "initial_accuracy",
              "final_accuracy", "reward_first5", "reward_last5"):
        assert np.isfinite(out[k]) and 0.0 <= out[k] <= 1.0, k
    assert json.loads((tmp_path / "metrics.json").read_text()) == out
    curve = [json.loads(l) for l in
             (tmp_path / "reward_curve.jsonl").read_text().splitlines()]
    assert [c["update"] for c in curve] == [0, 1]
