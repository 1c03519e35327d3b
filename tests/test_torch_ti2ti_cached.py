"""The port's feature-cached TI2TI sampler against its exact sampler and
against JAX ``generate_ti2ti_cached``, with bridged weights at temperature 0:
with ``refresh_interval=1`` every step refreshes and the trajectory equals
the exact one; with the real schedule (partial steps in between) the final
ids and codes are token-exact against JAX."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.samplers import parallel_ti2ti as JT
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.samplers import parallel_ti2ti as TT

torch.set_num_threads(1)
TVS, CB, MASK, NEWLINE = 256, 32, 250, 251
TOK = tk.VariantATokens(mask=MASK, newline=NEWLINE, answer_start=252,
                        answer_end=253, boi=254, eoi=255, uncondition=249,
                        pad=248, text_vocab_size=TVS, codebook_size=CB)


@pytest.fixture(scope="module")
def models():
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, n_layers=2,
              mlp_hidden_size=64, vocab_size=TVS + CB, mask_token_id=MASK)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    jp = JL.init_llada_params(jax.random.key(4), jcfg)
    tp = llada_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _setup(text_len=8, steps=8, timesteps=4, cfg_scale=0.0):
    ids, lay = tk.assemble_ti2ti_sequence([5, 6, 7, 8], text_len, 2, 3, [9],
                                          tokens=TOK)
    kw = dict(text_steps=steps, timesteps=timesteps, temperature=0.0,
              text_temperature=0.0, cfg_scale=cfg_scale, cfg_img=2.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
    return ids, lay, kw, np.asarray([40, 41], np.int32)


@pytest.mark.parametrize("cfg_scale", [0.0, 1.5])
def test_cached_equals_exact_when_always_refreshing(models, cfg_scale):
    _, tcfg, _, tp = models
    ids, lay, kw, un = _setup(cfg_scale=cfg_scale)
    opts = TT.TI2TIOptions(**kw)
    ut = un if cfg_scale else None
    x = torch.tensor(ids[None])
    want = TT.generate_ti2ti(tp, tcfg, x, lay, opts, uncond_text_prefix=ut,
                             uncond_image_prefix=un)
    got = TT.generate_ti2ti_cached(tp, tcfg, x, lay, opts,
                                   refresh_interval=1, warmup_ratio=1.0,
                                   uncond_text_prefix=ut,
                                   uncond_image_prefix=un)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cache_kw", [
    dict(cache_ratio=0.5, refresh_interval=3, warmup_ratio=0.25),
    dict(),                                    # the defaults
])
def test_real_schedule_token_exact_against_jax(models, cache_kw):
    jcfg, tcfg, jp, tp = models
    ids, lay, kw, un = _setup(text_len=24, steps=16, timesteps=4)
    refresh = TT.cached_refresh_schedule(16, 4, **{
        k: v for k, v in cache_kw.items() if k != "cache_ratio"})
    assert (~refresh).sum() >= 2               # partial steps do run
    jf, jc = JT.generate_ti2ti_cached(
        jp, jcfg, jnp.asarray(ids)[None], lay, JT.TI2TIOptions(**kw),
        uncond_image_prefix=un, key=None, **cache_kw)
    tf, tc = TT.generate_ti2ti_cached(
        tp, tcfg, torch.tensor(ids[None]), lay, TT.TI2TIOptions(**kw),
        uncond_image_prefix=un, **cache_kw)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    f = tf.numpy()[0]
    assert not np.any(f[lay.text_start:lay.text_end] == MASK)


def test_refresh_schedule():
    """32 steps, 4 image steps (8, 16, 23, 31): warmup 0-8, the steps after
    each image step, and every 4th step since the last refresh."""
    got = np.flatnonzero(TT.cached_refresh_schedule(32, 4))
    assert got.tolist() == [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 13, 16, 17, 21,
                            23, 24, 28, 31]
    assert TT.cached_refresh_schedule(8, 4, refresh_interval=1).all()


def test_random_remasking_needs_generator(models):
    _, tcfg, _, tp = models
    ids, lay, kw, _ = _setup()
    opts = TT.TI2TIOptions(**dict(kw, remasking="random"))
    with pytest.raises(ValueError, match="generator"):
        TT.generate_ti2ti_cached(tp, tcfg, torch.tensor(ids[None]), lay,
                                 opts)
    fin, codes = TT.generate_ti2ti_cached(
        tp, tcfg, torch.tensor(ids[None]), lay,
        TT.TI2TIOptions(**dict(kw, temperature=1.0, text_temperature=0.7)),
        generator=torch.Generator().manual_seed(0))
    assert (fin[0, lay.text_start:lay.text_end] != MASK).all()
    assert int(codes.min()) >= 0 and int(codes.max()) < CB


def test_wrapped_module_names_see_the_drivers_call_order(models,
                                                         monkeypatch):
    """The cached edit benchmark wraps this module's ``_text_update``,
    ``_uncond_vq`` (replacing its ``hidden_fn`` by keyword),
    ``llada_hidden_with_cache`` and ``llada_hidden_partial``: each step
    runs a refresh or a partial forward as ``cached_refresh_schedule``
    says, then one text update, then on image steps one uncond forward on
    plain ``llada_hidden``; the wrapped run ends where the plain one does."""
    _, tcfg, _, tp = models
    ids, lay, kw, un = _setup(text_len=24, steps=16, timesteps=4)
    opts = TT.TI2TIOptions(**kw)
    x = torch.tensor(ids[None])
    want = TT.generate_ti2ti_cached(tp, tcfg, x, lay, opts,
                                    uncond_image_prefix=un)
    real = {n: getattr(TT, n) for n in (
        "_text_update", "_uncond_vq", "llada_hidden_with_cache",
        "llada_hidden_partial")}
    calls = []

    def text_update(ids, *a, **k):
        calls.append("text_update")
        return real["_text_update"](ids, *a, **k)

    def uncond_vq(*a, **k):
        fn = k.get("hidden_fn", TT.llada_hidden)
        assert fn is TL.llada_hidden

        def hidden(params, cfg, ids, *b, **kk):
            calls.append("uncond")
            return fn(params, cfg, ids, *b, **kk)
        k["hidden_fn"] = hidden
        return real["_uncond_vq"](*a, **k)

    def with_cache(*a, **k):
        calls.append("refresh")
        return real["llada_hidden_with_cache"](*a, **k)

    def partial(*a, **k):
        calls.append("partial")
        return real["llada_hidden_partial"](*a, **k)

    for name, fn in (("_text_update", text_update), ("_uncond_vq", uncond_vq),
                     ("llada_hidden_with_cache", with_cache),
                     ("llada_hidden_partial", partial)):
        monkeypatch.setattr(TT, name, fn)
    got = TT.generate_ti2ti_cached(tp, tcfg, x, lay, opts,
                                   uncond_image_prefix=un)
    refresh = TT.cached_refresh_schedule(16, 4)
    img = TT.S.image_step_mask(16, 4)
    order = []
    for s in range(16):
        order += ["refresh" if refresh[s] else "partial", "text_update"]
        order += ["uncond"] if img[s] else []
    assert calls == order
    assert "partial" in calls
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
