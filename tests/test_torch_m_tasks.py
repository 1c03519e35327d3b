"""The port's variant-M training forwards against the JAX package.

The tiny LLaDA (2 layers, d_model 64, GQA 4/2) with weights bridged from
JAX runs each forward on the same numpy batch, f32; the losses agree at
atol = rtol = 1e-4, the tolerance of the forward itself
(``test_torch_llada.py``).  The batch's mask tokens come from
``interleave_noising`` fed JAX's uniforms, as in ``test_torch_masking``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.training import m_tasks as JMT
from mmada_parallel_tpu.training import masking as JMK
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.training import m_tasks as TMT

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
MASK = 3                     # LLaDAConfig.tiny's mask token
L, MAX_SEQ = 24, 8


@pytest.fixture(scope="module")
def models():
    jcfg = JL.LLaDAConfig.tiny()
    jp = JL.init_llada_params(jax.random.key(0), jcfg)
    tp = llada_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, TL.LLaDAConfig.tiny(), tp


def _batch(B, seed=0):
    """Ids with a noised image tail and noised text head (JAX's noising),
    labels at the noised positions, and t2i padding masks."""
    rng = np.random.default_rng(seed)
    img = rng.integers(100, 500, (B, L - MAX_SEQ)).astype(np.int32)
    text = rng.integers(10, 100, (B, MAX_SEQ)).astype(np.int32)
    nimg, ilab, ntext, tlab, t = JMK.interleave_noising(
        jax.random.key(seed), jnp.asarray(img), jnp.asarray(text),
        mask_token=MASK)
    ids = np.concatenate([np.asarray(ntext), np.asarray(nimg)], 1)
    labels = np.concatenate([np.asarray(tlab), np.asarray(ilab)], 1)
    masks = np.ones((B, L), bool)
    masks[0, :3] = False                      # left padding of one t2i row
    return ids, labels, masks, np.asarray(t)


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("sizes,extras", [((1, 1, 1), False),
                                          ((2, 1, 1), True)])
def test_forward_process_matches_jax(models, sizes, extras):
    jcfg, jp, tcfg, tp = models
    B = sum(sizes)
    ids, labels, masks, t = _batch(B)
    kw = {}
    if extras:
        kw = dict(p_mask_lm=t[sizes[0]:sizes[0] + sizes[1], None],
                  p_mask_mmu=t[-sizes[2]:, None],
                  answer_lengths_mmu=np.full((sizes[2], 1), 5, np.int32))
    want = JMT.forward_process(
        jp, jcfg, jnp.asarray(ids), jnp.asarray(labels), *sizes, MAX_SEQ,
        jnp.asarray(masks[:sizes[0]]),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = TMT.forward_process(
        tp, tcfg, torch.tensor(ids), torch.tensor(labels), *sizes, MAX_SEQ,
        torch.tensor(masks[:sizes[0]]),
        **{k: torch.tensor(v) for k, v in kw.items()})
    _close(got, want)


def test_forward_t2i_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    ids, labels, masks, _ = _batch(2, seed=1)
    want = JMT.forward_t2i(jp, jcfg, jnp.asarray(ids), jnp.asarray(labels),
                           MAX_SEQ, jnp.asarray(masks))
    got = TMT.forward_t2i(tp, tcfg, torch.tensor(ids), torch.tensor(labels),
                          MAX_SEQ, torch.tensor(masks))
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("full_attn", [False, True])
def test_forward_process_separate_matches_jax(models, full_attn):
    jcfg, jp, tcfg, tp = models
    ids, labels, masks, t = _batch(4, seed=2)
    attn = masks.copy()
    attn[2, -4:] = False

    def tasks(conv):
        return dict(
            t2i={"input_ids": conv(ids[:2]), "labels": conv(labels[:2]),
                 "t2i_masks": conv(masks[:2])},
            lm={"input_ids": conv(ids[2:3]), "labels": conv(labels[2:3]),
                "attention_mask": conv(attn[2:3]),
                "p_mask": conv(t[2:3, None]),
                "answer_lengths": conv(np.full((1, 1), 6, np.int32))},
            mmu={"input_ids": conv(ids[3:]), "labels": conv(labels[3:]),
                 "attention_mask": conv(attn[3:]),
                 "p_mask": conv(t[3:, None])})

    jfn = (JMT.forward_process_separate_full_attn if full_attn
           else JMT.forward_process_separate)
    tfn = (TMT.forward_process_separate_full_attn if full_attn
           else TMT.forward_process_separate)
    want = jfn(jp, jcfg, MAX_SEQ, **tasks(jnp.asarray))
    got = tfn(tp, tcfg, MAX_SEQ, **tasks(torch.tensor))
    _close(got, want)
    # a missing task contributes 0
    lm_only = tfn(tp, tcfg, MAX_SEQ, lm=tasks(torch.tensor)["lm"])
    assert float(lm_only["loss_t2i"]) == 0.0 == float(lm_only["loss_mmu"])
