"""The port's training masking against the JAX package.

JAX and torch draw different numbers from one seed, so each test draws the
uniforms (and random tokens) with ``jax.random`` exactly as the JAX function
draws them from its key, and feeds them to the port's private apply step:
the masks, labels and mask probabilities must then equal JAX's exactly
(the subset rule sorts stably, as ``jnp.argsort`` does).  The public
functions, which draw from a ``torch.Generator``, are checked for the
properties every draw has."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_parallel_tpu.training import masking as JMK
from mmada_parallel_torch.ops import sampling as TS
from mmada_parallel_torch.training import masking as TMK

MASK = 126336


def _t(x):
    return torch.tensor(np.asarray(x))


def _codes(B, L, seed=0, lo=0, hi=8192):
    return np.random.default_rng(seed).integers(lo, hi, (B, L)).astype(
        np.int32)


@pytest.mark.parametrize("schedule,L,force", [("cosine", 37, 0),
                                              ("linear", 37, 0),
                                              ("cosine", 4, 5)])
def test_mask_codes_equals_jax_given_its_uniforms(schedule, L, force):
    B = 6
    codes = _codes(B, L)
    key = jax.random.key(3)
    want = JMK.mask_codes(key, jnp.asarray(codes), schedule, force)
    k1, k2 = jax.random.split(key)
    got = TMK._mask_codes_apply(
        torch.tensor(codes), _t(jax.random.uniform(k1, (B,))),
        _t(jax.random.uniform(k2, (B, L))), schedule, force, MASK)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("opts", [
    dict(),
    dict(min_masking_rate=0.4, predict_all_tokens=True),
    dict(noise_type="random_replace", codebook_size=64),
    dict(mask_contiguous_region=True),
    dict(mask_contiguous_region=True, noise_type="random_replace",
         codebook_size=64)])
def test_mask_tokens_schedule_equals_jax_given_its_draws(opts):
    B, L = 5, 64
    tokens = _codes(B, L, seed=1)
    key = jax.random.key(7)
    want = JMK.mask_tokens_schedule(key, jnp.asarray(tokens), **opts)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    t = _t(jax.random.uniform(k1, (B,)))
    order_u = rect_u = rnd = None
    if opts.get("mask_contiguous_region"):
        rect_u = tuple(_t(jax.random.uniform(k, (B,))) for k in (k2, k3, k4))
    else:
        order_u = _t(jax.random.uniform(k2, (B, L)))
    if opts.get("noise_type") == "random_replace":
        rnd = _t(jax.random.randint(k3, (B, L), 0, opts["codebook_size"],
                                    jnp.int32))
    got = TMK._mask_tokens_schedule_apply(
        torch.tensor(tokens), t, order_u, rect_u, rnd, TS.cosine_schedule,
        opts.get("min_masking_rate", 0.0), MASK,
        opts.get("noise_type", "mask"),
        opts.get("mask_contiguous_region", False),
        opts.get("predict_all_tokens", False))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               atol=1e-7)


def test_interleave_noising_equals_jax_given_its_uniforms():
    B, N, T = 4, 64, 12
    img = _codes(B, N, seed=2, lo=126356, hi=126356 + 8192)
    text = _codes(B, T, seed=3, hi=126000)
    key = jax.random.key(11)
    want = JMK.interleave_noising(key, jnp.asarray(img), jnp.asarray(text))
    k1, k2, k3 = jax.random.split(key, 3)
    got = TMK._interleave_noising_apply(
        torch.tensor(img), torch.tensor(text),
        _t(jax.random.uniform(k1, (B,))), _t(jax.random.uniform(k2, (B, N))),
        _t(jax.random.uniform(k3, (B, T))), 1e-3, TS.cosine_schedule, MASK)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                               atol=1e-7)


def test_public_functions_draw_valid_masks():
    g = torch.Generator().manual_seed(0)
    codes = torch.tensor(_codes(8, 50, seed=4))
    masked, labels = TMK.mask_codes(g, codes)
    hit = masked == MASK
    assert (hit.sum(1) >= 1).all()
    assert torch.equal(labels[hit], codes[hit]) and (labels[~hit] == -100).all()

    ids, labels, p = TMK.mask_tokens_schedule(g, codes[:, :49],
                                              mask_contiguous_region=True)
    assert ((ids == MASK).sum(1) >= 1).all() and p.shape == (8,)
    ids, labels, p = TMK.mask_tokens_schedule(
        g, codes, noise_type="random_replace", codebook_size=16)
    assert torch.equal(labels, codes)

    text = torch.tensor(_codes(8, 10, seed=5, hi=1000))
    nimg, ilab, ntext, tlab, t = TMK.interleave_noising(g, codes, text)
    assert ((nimg == MASK).sum(1) >= 1).all()
    assert (ntext[:, 0] == text[:, 0]).all() and (tlab[:, 0] == -100).all()
    assert ((t >= 1e-3) & (t <= 1)).all()
