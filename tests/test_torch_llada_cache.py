"""The port's feature-cached forwards against the JAX package with bridged
weights: ``llada_hidden_with_cache`` (hidden states and the packed post-RoPE
k/v cache) and ``llada_hidden_partial`` (hidden states at the selected
positions and the updated cache), in f32 on the tiny config (2 layers,
d_model 64, GQA 4/2) at atol/rtol 1e-4, the tolerance of the full forward's
test (f32 matmul summation order differs between XLA and PyTorch)."""

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


def _ids(B, L, V, seed):
    return np.random.default_rng(seed).integers(0, V, (B, L)).astype(np.int32)


def test_with_cache_matches_jax_and_the_plain_forward(models):
    jcfg, tcfg, jp, tp = models
    ids = _ids(2, 40, tcfg.vocab_size, 0)
    jh, jcache = JL.llada_hidden_with_cache(jp, jcfg, jnp.asarray(ids))
    th, tcache = TL.llada_hidden_with_cache(tp, tcfg, torch.from_numpy(ids))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for name in ("k", "v"):
        assert tcache[name].shape == (2, 2, 40, 2 * 16)   # [layers,B,L,KV*hd]
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(jcache[name]), **TOL)
    # the q-only path against pre-rotated k equals the full forward
    np.testing.assert_allclose(
        th.numpy(), TL.llada_hidden(tp, tcfg, torch.from_numpy(ids)).numpy(),
        **TOL)


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


def test_partial_of_every_position_is_the_full_forward(models):
    """Recomputing all L positions against any cache rewrites every cache
    row first, so it equals the full forward."""
    _, tcfg, _, tp = models
    ids = torch.from_numpy(_ids(1, 24, tcfg.vocab_size, 4))
    full, cache = TL.llada_hidden_with_cache(tp, tcfg, ids)
    stale = {k: torch.zeros_like(v) for k, v in cache.items()}
    pos = torch.arange(24)[None]
    part, new = TL.llada_hidden_partial(tp, tcfg, ids, pos, stale)
    torch.testing.assert_close(part, full, **TOL)
    torch.testing.assert_close(new["k"], cache["k"], **TOL)


def test_sequential_blocks_are_refused():
    cfg = TL.LLaDAConfig.tiny(block_type="sequential")
    params = TL.init_llada_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="llama"):
        TL.llada_hidden_with_cache(params, cfg, torch.zeros(1, 4,
                                                            dtype=torch.long))
