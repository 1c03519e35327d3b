"""The port's feature-cached forwards against the JAX package with bridged
weights: ``llada_hidden_with_cache`` (hidden states and the packed post-RoPE
k/v cache) and ``llada_hidden_partial`` (hidden states at the selected
positions and the updated cache), in f32 on the tiny config (2 layers,
d_model 64, GQA 4/2) at atol/rtol 1e-4, the tolerance of the full forward's
test (f32 matmul summation order differs between XLA and PyTorch).

One block runs the three forwards, so two tests also take each flavour it
serves that JAX has no twin of (per-head q/k norm with a head size apart
from ``d_model / n_heads``, experts, block-causal attention) and hold the
cached forwards to ``llada_hidden`` at the same tolerance."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JL.LLaDAConfig.tiny(), TL.LLaDAConfig.tiny()
    jp = JL.init_llada_params(jax.random.key(5), jcfg)
    tp = llada_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


# the tiny config's flavours without a JAX twin, beside the bridged "llama"
FLAVOURS = {
    "llama": None,
    "qk_norm": dict(n_kv_heads=1, head_dim=32, attention_layer_norm=True),
    "experts": dict(n_experts=4, experts_per_token=2, moe_hidden_size=32),
    "block_causal": dict(attention="block_causal", block_length=4),
}


def _flavour(models, name):
    """``(cfg, params)`` of a flavour: the bridged tiny model, or random
    weights with the norms drawn apart from 1 (unit norms would hide a
    swapped or skipped q/k norm)."""
    if FLAVOURS[name] is None:
        return models[1], models[3]
    cfg = TL.LLaDAConfig.tiny(**FLAVOURS[name])
    params = TL.init_llada_params(cfg, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    for k, w in params["blocks"].items():
        if k.endswith("norm"):
            w.copy_(1 + 0.3 * torch.randn(w.shape, generator=g))
    return cfg, params


def _ids(B, L, V, seed):
    return np.random.default_rng(seed).integers(0, V, (B, L)).astype(np.int32)


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_with_cache_matches_jax_and_the_plain_forward(models, flavour):
    cfg, params = _flavour(models, flavour)
    ids = _ids(2, 40, cfg.vocab_size, 0)
    th, tcache = TL.llada_hidden_with_cache(params, cfg,
                                            torch.from_numpy(ids))
    kv = cfg.effective_n_kv_heads * cfg.head_dim
    for name in ("k", "v"):
        assert tcache[name].shape == (2, 2, 40, kv)      # [layers,B,L,KV*hd]
    if flavour == "llama":
        jcfg, _, jp, _ = models
        jh, jcache = JL.llada_hidden_with_cache(jp, jcfg, jnp.asarray(ids))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(),
                                       np.asarray(jcache[name]), **TOL)
    # the q-only path against pre-rotated k equals the full forward
    np.testing.assert_allclose(
        th.numpy(),
        TL.llada_hidden(params, cfg, torch.from_numpy(ids)).numpy(), **TOL)
    if cfg.attention == "block_causal":     # blocks aligned past position 0
        hi = TL.block_causal_bounds(40, 6, cfg.block_length)
        got, _ = TL.llada_hidden_with_cache(params, cfg, torch.from_numpy(ids),
                                            kv_hi=hi)
        want = TL.llada_hidden(params, cfg, torch.from_numpy(ids), kv_hi=hi)
        torch.testing.assert_close(got, want, **TOL)


def test_partial_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    B, L, n = 2, 40, 7
    ids = _ids(B, L, tcfg.vocab_size, 1)
    _, jcache = JL.llada_hidden_with_cache(jp, jcfg, jnp.asarray(ids))
    rng = np.random.default_rng(2)
    sel_pos = np.sort(np.stack([rng.choice(L, n, replace=False)
                                for _ in range(B)]), axis=1).astype(np.int32)
    sel_ids = _ids(B, n, tcfg.vocab_size, 3)       # new tokens at those slots
    jh, jnew = JL.llada_hidden_partial(jp, jcfg, jnp.asarray(sel_ids),
                                       jnp.asarray(sel_pos), jcache)
    tcache = {k: torch.tensor(np.asarray(v)) for k, v in jcache.items()}
    th, tnew = TL.llada_hidden_partial(tp, tcfg, torch.from_numpy(sel_ids),
                                       torch.from_numpy(sel_pos), tcache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tnew[name].numpy(), np.asarray(jnew[name]),
                                   **TOL)
    assert tnew["k"] is tcache["k"]                # updated in place


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_partial_of_every_position_is_the_full_forward(models, flavour):
    """Recomputing all L positions against any cache rewrites every cache
    row first, so it equals the full forward (a block-causal one with each
    row's bound)."""
    tcfg, tp = _flavour(models, flavour)
    ids = torch.from_numpy(_ids(1, 24, tcfg.vocab_size, 4))
    full, cache = TL.llada_hidden_with_cache(tp, tcfg, ids)
    stale = {k: torch.zeros_like(v) for k, v in cache.items()}
    pos = torch.arange(24)[None]
    hi = (TL.block_causal_bounds(24, 0, tcfg.block_length)
          if tcfg.attention == "block_causal" else None)
    part, new = TL.llada_hidden_partial(tp, tcfg, ids, pos, stale, kv_hi=hi)
    torch.testing.assert_close(part, full, **TOL)
    torch.testing.assert_close(new["k"], cache["k"], **TOL)
    torch.testing.assert_close(new["v"], cache["v"], **TOL)


def test_cached_forwards_leave_the_qkv_biases_out_as_jax_does():
    """JAX's cached forwards add no q/k/v biases; with biases drawn apart
    from their zero init, the port's cached forwards still match them (and
    the plain forward, which adds them, does not)."""
    jcfg = JL.LLaDAConfig.tiny(include_qkv_bias=True)
    tcfg = TL.LLaDAConfig.tiny(include_qkv_bias=True)
    jp = jax.tree_util.tree_map(np.asarray, JL.init_llada_params(
        jax.random.key(6), jcfg))
    rng = np.random.default_rng(9)
    for name in ("q_bias", "k_bias", "v_bias"):
        b = jp["blocks"][name]
        jp["blocks"][name] = rng.normal(0, 0.5, b.shape).astype(b.dtype)
    tp = llada_params_from_jax(jp)
    ids = _ids(2, 16, tcfg.vocab_size, 10)
    jh, jcache = JL.llada_hidden_with_cache(jp, jcfg, jnp.asarray(ids))
    th, tcache = TL.llada_hidden_with_cache(tp, tcfg, torch.from_numpy(ids))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tcache["v"].numpy(), np.asarray(jcache["v"]),
                               **TOL)
    plain = TL.llada_hidden(tp, tcfg, torch.from_numpy(ids))
    assert not torch.allclose(plain, th, **TOL)
    pos = np.asarray([[1, 5, 9], [0, 2, 15]], np.int32)
    sel = _ids(2, 3, tcfg.vocab_size, 11)
    jh, _ = JL.llada_hidden_partial(jp, jcfg, jnp.asarray(sel),
                                    jnp.asarray(pos), jcache)
    th, _ = TL.llada_hidden_partial(tp, tcfg, torch.from_numpy(sel),
                                    torch.from_numpy(pos), tcache)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_sequential_blocks_are_refused():
    cfg = TL.LLaDAConfig.tiny(block_type="sequential")
    params = TL.init_llada_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="llama"):
        TL.llada_hidden_with_cache(params, cfg, torch.zeros(1, 4,
                                                            dtype=torch.long))
