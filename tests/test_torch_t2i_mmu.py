"""The port's variant-M text-to-image and multimodal-understanding samplers
against JAX ``samplers/t2i.py`` and ``samplers/mmu.py`` with bridged
weights, token-exact at temperature 0: ``t2i_generate`` with and without
CFG and with left-padding masks; ``mmu_generate`` against JAX (plain, CFG,
a ragged batch) and a literal numpy loop of the reference, a ragged batch
equal to its solo rows; ``mmu_generate_fast`` equal to the slow sampler
without an ``eot`` and stopping early with one (forwards counted)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.samplers import mmu as JM
from mmada_parallel_tpu.samplers import t2i as JT
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.samplers import mmu as TM
from mmada_parallel_torch.samplers import t2i as TT

torch.set_num_threads(1)
TVS, CB, MASK = 256, 32, 250
TOK = tk.VariantMTokens(mask=MASK, soi=251, eoi=252, bos=249, eos=248,
                        interleave=247, text_vocab_size=TVS, codebook_size=CB)
N_VQ = 6


@pytest.fixture(scope="module")
def models():
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, n_layers=2,
              mlp_hidden_size=64, vocab_size=TVS + CB, mask_token_id=MASK)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    jp = JL.init_llada_params(jax.random.key(5), jcfg)
    return jcfg, tcfg, jp, llada_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.tensor(x)


# ---------------------------------------------------------------------------
# t2i_generate
# ---------------------------------------------------------------------------


def _t2i_batch():
    """Two rows in one bucket of 8: ``[t2i] bos text eos`` left-padded with
    ipad (hidden), then ``[soi] MASK*6 [eoi]``; the uncond rows ``[t2i, bos,
    eos]`` left-padded likewise."""
    plen = 8
    tail = [TOK.soi] + [MASK] * N_VQ + [TOK.eoi]
    ids, un, m, um = [], [], [], []
    for text in ([10, 11, 12, 13], [30, 31]):
        temp = [TOK.t2i, TOK.bos] + text + [TOK.eos]
        pad = plen - len(temp)
        ids.append([TOK.ipad] * pad + temp + tail)
        m.append([False] * pad + [True] * (len(temp) + len(tail)))
        un.append([TOK.ipad] * (plen - 3) + [TOK.t2i, TOK.bos, TOK.eos] + tail)
        um.append([False] * (plen - 3) + [True] * (3 + len(tail)))
    return (np.asarray(ids, np.int32), np.asarray(un, np.int32),
            np.asarray(m), np.asarray(um), plen)


@pytest.mark.parametrize("guidance,masked", [(0.0, False), (1.5, False),
                                             (0.0, True), (1.5, True)])
def test_t2i_token_exact_against_jax(models, guidance, masked):
    jcfg, tcfg, jp, tp = models
    ids, un, m, um, plen = _t2i_batch()
    if not masked:
        m = um = None
    kw = dict(timesteps=5, temperature=0.0, guidance_scale=guidance,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
    want = JT.t2i_generate(jp, jcfg, jnp.asarray(ids), jnp.asarray(un),
                           prompt_len=plen, num_vq_tokens=N_VQ,
                           opts=JT.T2IOptions(**kw), attn_mask=_j(m),
                           uncond_attn_mask=_j(um), key=None)
    got = TT.t2i_generate(tp, tcfg, torch.tensor(ids), torch.tensor(un),
                          prompt_len=plen, num_vq_tokens=N_VQ,
                          opts=TT.T2IOptions(**kw), attn_mask=_t(m),
                          uncond_attn_mask=_t(um))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (2, N_VQ) and int(got.max()) < CB


def test_t2i_sampled_run_is_seeded(models):
    _, tcfg, _, tp = models
    ids, un, m, um, plen = _t2i_batch()
    opts = TT.T2IOptions(timesteps=5, temperature=1.0, guidance_scale=1.5,
                         text_vocab_size=TVS, codebook_size=CB,
                         mask_token=MASK)
    runs = [TT.t2i_generate(tp, tcfg, torch.tensor(ids), torch.tensor(un),
                            plen, N_VQ, opts, torch.tensor(m),
                            torch.tensor(um),
                            generator=torch.Generator().manual_seed(4))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < CB


# ---------------------------------------------------------------------------
# mmu_generate
# ---------------------------------------------------------------------------

MMU = dict(max_new_tokens=8, steps=8, block_length=4, temperature=0.0,
           mask_token=MASK)
PROMPTS = ([TOK.mmu, TOK.soi] + list(range(TVS, TVS + 4))
           + [TOK.eoi, TOK.bos, 11, 12, TOK.eos],
           [TOK.mmu, TOK.soi] + list(range(TVS + 8, TVS + 12))
           + [TOK.eoi, TOK.bos, 21, TOK.eos])


def _ragged():
    P = max(map(len, PROMPTS))
    ids = np.full((2, P), TOK.eos, np.int32)
    mask = np.zeros((2, P), bool)
    for i, p in enumerate(PROMPTS):
        ids[i, :len(p)] = p
        mask[i, :len(p)] = True
    return ids, mask


@pytest.mark.parametrize("case", ["plain", "cfg", "ragged"])
def test_mmu_token_exact_against_jax(models, case):
    jcfg, tcfg, jp, tp = models
    kw = dict(MMU, cfg_scale=1.5 if case == "cfg" else 0.0)
    if case == "ragged":
        ids, mask = _ragged()
    else:
        ids, mask = np.asarray([PROMPTS[0]], np.int32), None
    want = JM.mmu_generate(jp, jcfg, jnp.asarray(ids), JM.MMUOptions(**kw),
                           attn_mask=_j(mask), key=None)
    got = TM.mmu_generate(tp, tcfg, torch.tensor(ids), TM.MMUOptions(**kw),
                          attn_mask=_t(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not (got[:, ids.shape[1]:] == MASK).any()


def _ref_mmu(fwd, prompt, opts):
    """Literal numpy port of the reference MMU loop at temperature 0 with
    no CFG (a copy of the JAX tests' oracle)."""
    x = np.concatenate([prompt, np.full(opts.max_new_tokens, MASK)])
    P = len(prompt)
    nb = opts.max_new_tokens // opts.block_length
    spb = opts.steps // nb
    for b in range(nb):
        total, steps = opts.block_length, spb
        budgets = [total // steps + (1 if s < total % steps else 0)
                   for s in range(steps)]
        for i in range(spb):
            mask_index = x == MASK
            logits = fwd(x)
            x0 = logits.argmax(-1)
            e = np.exp(logits - logits.max(-1, keepdims=True))
            p = e / e.sum(-1, keepdims=True)
            conf = np.take_along_axis(p, x0[:, None], -1)[:, 0]
            conf[P + (b + 1) * opts.block_length:] = -np.inf
            x0 = np.where(mask_index, x0, x)
            conf = np.where(mask_index, conf, -np.inf)
            k = budgets[i]
            if k > 0:
                sel = np.argsort(-conf, kind="stable")[:k]
                x[sel] = x0[sel]
    return x


def test_mmu_matches_reference_loop(models):
    _, tcfg, _, tp = models

    def fwd(ids_1d):
        return TL.llada_forward(tp, tcfg, torch.tensor(ids_1d)[None])[0] \
            .numpy()

    prompt = np.arange(20, 30, dtype=np.int64)
    opts = TM.MMUOptions(**MMU)
    want = _ref_mmu(fwd, prompt, opts)
    got = TM.mmu_generate(tp, tcfg, torch.tensor(prompt)[None], opts)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_mmu_ragged_batch_equals_solo_rows(models):
    _, tcfg, _, tp = models
    ids, mask = _ragged()
    opts = TM.MMUOptions(**MMU)
    batch = TM.mmu_generate(tp, tcfg, torch.tensor(ids), opts,
                            attn_mask=torch.tensor(mask))
    P = ids.shape[1]
    for i, p in enumerate(PROMPTS):
        solo = TM.mmu_generate(tp, tcfg, torch.tensor([p]), opts)
        assert torch.equal(batch[i, P:], solo[0, len(p):]), i


def test_mmu_fast_early_exit(models, monkeypatch):
    _, tcfg, _, tp = models
    opts = TM.MMUOptions(**MMU)
    prompt = torch.tensor([PROMPTS[0]])
    slow = TM.mmu_generate(tp, tcfg, prompt, opts)
    P = prompt.shape[1]
    # no eot, or one that never ends a block: the slow sampler's tokens
    assert torch.equal(TM.mmu_generate_fast(tp, tcfg, prompt, opts), slow)
    assert torch.equal(TM.mmu_generate_fast(tp, tcfg, prompt, opts,
                                            eot_token=-7), slow)
    # the token that ends block 0 as eot: one block of forwards, not two
    calls = []
    real = TM.llada_hidden

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(TM, "llada_hidden", counting)
    eot = int(slow[0, P + opts.block_length - 1])
    fast = TM.mmu_generate_fast(tp, tcfg, prompt, opts, eot_token=eot)
    assert len(calls) == opts.steps // 2
    assert torch.equal(fast[:, :P + opts.block_length],
                       slow[:, :P + opts.block_length])
    assert (fast[:, P + opts.block_length:] == MASK).all()


def test_mmu_guards(models):
    _, tcfg, _, tp = models
    prompt = torch.tensor([PROMPTS[0]])
    with pytest.raises(ValueError, match="generator"):
        TM.mmu_generate(tp, tcfg, prompt,
                        TM.MMUOptions(**dict(MMU, remasking="random")))
    with pytest.raises(ValueError, match="block_length"):
        TM.mmu_generate(tp, tcfg, prompt,
                        TM.MMUOptions(**dict(MMU, max_new_tokens=6)))
    out = TM.mmu_generate(tp, tcfg, prompt,
                          TM.MMUOptions(**dict(MMU, remasking="random")),
                          generator=torch.Generator().manual_seed(1))
    assert not (out == MASK).any()
