"""The port's training losses against the JAX package on the same numpy
logits and labels, in f32 at atol = rtol = 1e-5 (the same f32 arithmetic up
to summation order over the vocab and the batch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.training import losses as JLS
from mmada_parallel_torch.training import losses as TLS

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
V = 300


def _logits(B, L, seed=0):
    return (np.random.default_rng(seed).normal(size=(B, L, V)) * 3
            ).astype(np.float32)


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k].detach()),
                                   np.asarray(want[k]), err_msg=k, **TOL)


def test_token_cross_entropy_and_masked_mean():
    rng = np.random.default_rng(1)
    logits = _logits(2, 9)
    labels = rng.integers(0, V, (2, 9)).astype(np.int32)
    labels[0, :3] = -100
    labels[1, 4] = V + 7           # outside the vocab: CE is the lse
    got = TLS.token_cross_entropy(torch.tensor(logits), torch.tensor(labels))
    want = JLS.token_cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mask = labels != -100
    np.testing.assert_allclose(
        float(TLS.masked_mean(got, torch.tensor(mask))),
        float(JLS.masked_mean(want, jnp.asarray(mask))), **TOL)
    assert float(TLS.masked_mean(got, torch.zeros(2, 9, dtype=torch.bool))) \
        == 0.0


def _a_rows(L=40):
    """Rows that cover the region rules: an answer with an image and text
    after it; an answer with no image; an image with no end; no answer."""
    T = tk.TOKENS_A
    rng = np.random.default_rng(2)
    ids = rng.integers(10, 200, (4, L)).astype(np.int32)
    ids[0, [5, 8, 12, 20, 30]] = [T.answer_start, T.boi, T.newline, T.eoi,
                                  T.answer_end]
    ids[1, [3, 25]] = [T.answer_start, T.answer_end]
    ids[2, [4, 6]] = [T.answer_start, T.boi]
    labels = np.where(rng.random((4, L)) < 0.6, ids, -100).astype(np.int32)
    return ids, labels, np.array([L, L, 33, 20], np.int32)


@pytest.mark.parametrize("with_t,debug", [(False, False), (True, True)])
def test_a_variant_losses_match_jax(with_t, debug):
    ids, labels, lengths = _a_rows()
    logits = _logits(4, ids.shape[1], seed=3)
    t = np.array([0.3, 0.5, 0.005, 0.9], np.float32) if with_t else None
    got = TLS.a_variant_losses(
        torch.tensor(logits), torch.tensor(ids), torch.tensor(labels),
        torch.tensor(lengths), None if t is None else torch.tensor(t),
        debug_stats=debug)
    want = JLS.a_variant_losses(
        jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(labels),
        jnp.asarray(lengths), None if t is None else jnp.asarray(t),
        debug_stats=debug)
    _close(got, want)


def test_m_interleave_loss_matches_jax():
    rng = np.random.default_rng(4)
    logits = _logits(2, 30, seed=5)
    labels = np.where(rng.random((2, 30)) < 0.5,
                      rng.integers(0, V, (2, 30)), -100).astype(np.int32)
    t = np.array([0.25, 0.8], np.float32)
    got = TLS.m_interleave_loss(torch.tensor(logits), torch.tensor(labels),
                                torch.tensor(t), 8, 12, 0.7, 1.3)
    want = JLS.m_interleave_loss(jnp.asarray(logits), jnp.asarray(labels),
                                 jnp.asarray(t), 8, 12, 0.7, 1.3)
    _close(got, want)


@pytest.mark.parametrize("sizes,extras", [
    ((1, 1, 1), False), ((2, 1, 1), True), ((0, 2, 0), True),
    ((1, 0, 2), False)])
def test_m_forward_process_losses_match_jax(sizes, extras):
    rng = np.random.default_rng(6)
    B, L = sum(sizes), 24
    logits = _logits(B, L, seed=7)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    ids[rng.random((B, L)) < 0.4] = 250                 # the mask token
    labels = np.where(rng.random((B, L)) < 0.7, ids, -100).astype(np.int32)
    kw = {}
    if extras:
        kw = dict(p_mask_lm=rng.random((sizes[1], L)).astype(np.float32),
                  p_mask_mmu=rng.random((sizes[2], 1)).astype(np.float32),
                  answer_lengths_mmu=np.full((sizes[2], 1), 5, np.int32),
                  answer_lengths_lm=np.full((sizes[1], 1), 7, np.int32))
    got = TLS.m_forward_process_losses(
        torch.tensor(logits), torch.tensor(ids), torch.tensor(labels),
        *sizes, 6, mask_token=250,
        **{k: torch.tensor(v) for k, v in kw.items()})
    want = JLS.m_forward_process_losses(
        jnp.asarray(logits), jnp.asarray(ids), jnp.asarray(labels), *sizes,
        6, mask_token=250, **{k: jnp.asarray(v) for k, v in kw.items()})
    _close(got, want)


def test_soft_target_ce_and_loss_weight_match_jax():
    rng = np.random.default_rng(8)
    logits = _logits(2, 10, seed=9)
    soft = rng.random((2, 9, 64)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    targets = rng.integers(0, 64, (2, 10)).astype(np.int32)
    targets[1, 3:6] = -100
    np.testing.assert_allclose(
        float(TLS.soft_target_cross_entropy(torch.tensor(logits),
                                            torch.tensor(targets),
                                            torch.tensor(soft))),
        float(JLS.soft_target_cross_entropy(jnp.asarray(logits),
                                            jnp.asarray(targets),
                                            jnp.asarray(soft))), **TOL)
    t = rng.random(2).astype(np.float32)
    mask = (rng.random((2, 10)) < 0.5).astype(np.float32)
    np.testing.assert_allclose(
        TLS.masking_loss_weight(torch.tensor(t), torch.tensor(mask)).numpy(),
        np.asarray(JLS.masking_loss_weight(jnp.asarray(t),
                                           jnp.asarray(mask))), **TOL)
