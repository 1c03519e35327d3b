"""The port's variant-A text-to-image samplers against JAX
``samplers/image_gen.py`` with bridged weights, token-exact at temperature
0: ``generate_image`` with and without CFG, against JAX and against a
literal numpy loop of the reference; the recorded trajectory and its
``dump_trajectory`` files; ``generate_image_cached`` with a partial
recompute set smaller than the grid (``n_compute < n_vq``), with and
without ties in the confidences it ranks, and equal to the exact sampler
when every step refreshes."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.samplers import image_gen as JG
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.samplers import image_gen as TG

torch.set_num_threads(1)
TVS, CB = 256, 32
MASK, NEWLINE = 250, 251
TOK = tk.VariantATokens(mask=MASK, newline=NEWLINE, answer_start=252,
                        answer_end=253, boi=254, eoi=255, uncondition=249,
                        pad=248, text_vocab_size=TVS, codebook_size=CB)
UNCOND = np.array([60, 61, 62], np.int32)


def _bridge(jp):
    return llada_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))


@pytest.fixture(scope="module")
def models():
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, n_layers=2,
              mlp_hidden_size=64, vocab_size=TVS + CB, mask_token_id=MASK)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    jp = JL.init_llada_params(jax.random.key(7), jcfg)
    # a head whose codebook columns are zero but one: every slot whose
    # projection on it is negative has the raw-logit maximum 0.0, an exact
    # tie across slots in the cached sampler's recompute ranking
    head = np.asarray(jp["head"]).copy()
    keep = head[:, TVS + 5].copy()
    head[:, TVS:TVS + CB] = 0.0
    head[:, TVS + 5] = keep
    jp_ties = dict(jp, head=jnp.asarray(head))
    return jcfg, tcfg, {False: (jp, _bridge(jp)),
                        True: (jp_ties, _bridge(jp_ties))}


def _ids():
    return tk.assemble_ti2ti_sequence([5, 6, 7, 8], 0, 2, 3, [], tokens=TOK)


def _opts(cfg_scale, **kw):
    return dict(timesteps=6, temperature=0.0, cfg_scale=cfg_scale,
                text_vocab_size=TVS, codebook_size=CB, mask_token=MASK, **kw)


def _run_both(models, fn, opts, ties=False, **kw):
    jcfg, tcfg, params = models
    jp, tp = params[ties]
    ids, lay = _ids()
    uncond = UNCOND if opts["cfg_scale"] else None
    jout = getattr(JG, fn)(jp, jcfg, jnp.asarray(ids)[None], lay,
                           JG.ImageGenOptions(**opts), uncond_ids=uncond,
                           key=None, **kw)
    tout = getattr(TG, fn)(tp, tcfg, torch.tensor(ids[None]), lay,
                           TG.ImageGenOptions(**opts), uncond_ids=uncond,
                           **kw)
    return jout, tout, lay


@pytest.mark.parametrize("cfg_scale", [0.0, 2.0])
def test_generate_image_token_exact_against_jax(models, cfg_scale):
    (jf, jc), (tf, tc), lay = _run_both(models, "generate_image",
                                        _opts(cfg_scale))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert not (tf[0, lay.image_positions()] == MASK).any()


def _ref_generate_image(fwd, ids, layout, opts, uncond=None):
    """Literal numpy port of the reference MaskGit loop at temperature 0
    (a copy of the JAX tests' oracle, driven by the port's forward)."""
    x = np.asarray(ids).copy()
    img_pos = [i for i in range(layout.image_start, layout.image_end)
               if x[i] != NEWLINE]
    T = opts.timesteps
    vq_len0 = int((x[img_pos] == MASK).sum())
    for step in range(T):
        masked = x[img_pos] == MASK
        if masked.sum() == 0:
            break
        cond = fwd(x)[img_pos, TVS:TVS + CB]
        if opts.cfg_scale > 0 and uncond is not None:
            tail = x[layout.code_start:]
            un = np.concatenate([uncond, tail])
            un_pos = [p - layout.code_start + len(uncond) for p in img_pos]
            ug = fwd(un)[un_pos, TVS:TVS + CB]
            logits = (1 + opts.cfg_scale) * cond - opts.cfg_scale * ug
        else:
            logits = cond
        ml = logits[masked]
        sampled = ml.argmax(-1)
        e = np.exp(ml - ml.max(-1, keepdims=True))
        p = e / e.sum(-1, keepdims=True)
        conf = np.take_along_axis(p, sampled[:, None], -1)[:, 0]
        pos_arr = np.asarray(img_pos)[masked]
        x[pos_arr] = sampled + TVS
        if step < T - 1:
            frac = np.cos(np.pi / 2 * (step + 1) / T)
            keep_n = max(1, int(np.floor(vq_len0 * frac)))
        else:
            keep_n = 0
        k = min(keep_n, len(conf) - 1)
        c = np.log(np.clip(conf, 1e-20, None))
        cutoff = np.sort(c)[k]
        x[pos_arr[c < cutoff]] = MASK
    return x


@pytest.mark.parametrize("cfg_scale", [0.0, 2.0])
def test_generate_image_matches_reference_loop(models, cfg_scale):
    _, tcfg, params = models
    tp = params[False][1]

    def fwd(ids_1d):
        return TL.llada_forward(tp, tcfg, torch.tensor(ids_1d)[None])[0] \
            .numpy()

    ids, lay = _ids()
    opts = TG.ImageGenOptions(**_opts(cfg_scale))
    uncond = UNCOND if cfg_scale else None
    want = _ref_generate_image(fwd, ids, lay, opts, uncond)
    got, _ = TG.generate_image(tp, tcfg, torch.tensor(ids[None]), lay, opts,
                               uncond_ids=uncond)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_trajectory_matches_jax_and_dumps_the_same_files(models, tmp_path):
    (jf, jc, jt), (tf, tc, tt), _ = _run_both(
        models, "generate_image", _opts(2.0), record_trajectory=True,
        record_logits=True)
    assert sorted(tt) == sorted(jt) == ["logits", "sampled_full", "vq_mask",
                                        "x"]
    for name in ("x", "vq_mask", "sampled_full"):
        np.testing.assert_array_equal(tt[name].numpy(), np.asarray(jt[name]))
    np.testing.assert_allclose(tt["logits"].numpy(), np.asarray(jt["logits"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tt["x"][-1].numpy(), np.asarray(jf))
    JG.dump_trajectory(jt, str(tmp_path / "jax"))
    TG.dump_trajectory(tt, str(tmp_path / "port"))
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert len(files) == 6 * 4
    for f in files:
        a = np.load(tmp_path / "port" / f)
        b = np.load(tmp_path / "jax" / f)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
    with pytest.raises(ValueError, match="use_cache"):
        _run_both(models, "generate_image", _opts(0.0, use_cache=True),
                  record_trajectory=True)


@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
@pytest.mark.parametrize("ties", [False, True])
def test_cached_token_exact_against_jax(models, cfg_scale, ties):
    """6 slots, cache_ratio 0.5: 3 recomputed on the partial steps 2, 3
    and 5 (warmup 0-1, refresh at 4)."""
    opts = _opts(cfg_scale, use_cache=True, cache_ratio=0.5,
                 refresh_interval=3, warmup_ratio=0.3)
    assert np.flatnonzero(~TG.image_refresh_schedule(6, 3, 0.3)).tolist() \
        == [2, 3, 5]
    (jf, jc), (tf, tc), lay = _run_both(models, "generate_image_cached",
                                        opts, ties=ties)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # generate_image dispatches on use_cache
    _, (tf2, _), _ = _run_both(models, "generate_image", opts, ties=ties)
    np.testing.assert_array_equal(tf2.numpy(), tf.numpy())


def test_cached_ties_are_real(models):
    """The tie head gives several image slots exactly the same raw-logit
    maximum, the quantity the cached sampler sorts."""
    _, tcfg, params = models
    tp = params[True][1]
    ids, lay = _ids()
    logits = TL.llada_forward(tp, tcfg, torch.tensor(ids[None]))[0]
    vmax = logits[lay.image_positions(), TVS:TVS + CB].amax(-1)
    assert int((vmax == 0).sum()) >= 2


@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
def test_cached_always_refreshing_equals_exact(models, cfg_scale):
    _, tcfg, params = models
    tp = params[False][1]
    ids, lay = _ids()
    uncond = UNCOND if cfg_scale else None
    opts = TG.ImageGenOptions(**_opts(cfg_scale, use_cache=True,
                                      refresh_interval=1, warmup_ratio=1.0))
    got = TG.generate_image_cached(tp, tcfg, torch.tensor(ids[None]), lay,
                                   opts, uncond_ids=uncond)
    want = TG.generate_image(tp, tcfg, torch.tensor(ids[None]), lay,
                             dataclasses.replace(opts, use_cache=False),
                             uncond_ids=uncond)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sampled_run_is_seeded(models):
    _, tcfg, params = models
    tp = params[False][1]
    ids, lay = _ids()
    for use_cache in (False, True):
        opts = TG.ImageGenOptions(**_opts(2.0, use_cache=use_cache,
                                          cache_ratio=0.5,
                                          refresh_interval=3))
        opts = dataclasses.replace(opts, temperature=1.0)
        runs = [TG.generate_image(tp, tcfg, torch.tensor(ids[None]), lay,
                                  opts, uncond_ids=UNCOND,
                                  generator=torch.Generator().manual_seed(3))
                for _ in range(2)]
        assert torch.equal(runs[0][0], runs[1][0])
        codes = runs[0][1]
        assert int(codes.min()) >= 0 and int(codes.max()) < CB
