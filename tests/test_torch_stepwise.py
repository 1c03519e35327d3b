"""The port's streaming stepwise samplers and demo against JAX
``samplers/stepwise.py`` and ``cli/demo.py`` with bridged weights at
temperature 0: every frame of the three generators equal to JAX's; the
interleave generator's last frame equal to the port's
``interleave_generate``; ``decode_text_with_masks`` giving JAX's strings;
``run_stream`` / ``run_stream_m`` writing JAX's ``status.jsonl`` records,
with the same overlay pixels."""

import json
import os

import numpy as np
import jax
import pytest
import torch
from PIL import Image

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.cli import demo as JD
from mmada_parallel_tpu.models import amused_vq as JV
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.models import magvit2 as JM
from mmada_parallel_tpu.pipeline import InterleavePipeline as JaxMPipe
from mmada_parallel_tpu.pipeline import TI2TIPipeline as JaxAPipe
from mmada_parallel_tpu.samplers import interleave as JI
from mmada_parallel_tpu.samplers import parallel_ti2ti as JT
from mmada_parallel_tpu.samplers import stepwise as JS
from mmada_parallel_tpu.samplers import t2i as JT2I
from mmada_parallel_torch.cli import demo as TD
from mmada_parallel_torch.models import amused_vq as TV
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models import magvit2 as TM
from mmada_parallel_torch.models.from_jax import (amused_params_from_jax,
                                                  llada_params_from_jax,
                                                  magvit_params_from_jax)
from mmada_parallel_torch.pipeline import InterleavePipeline, TI2TIPipeline
from mmada_parallel_torch.samplers import interleave as TI
from mmada_parallel_torch.samplers import parallel_ti2ti as TT
from mmada_parallel_torch.samplers import stepwise as TS
from mmada_parallel_torch.samplers import t2i as TT2I

torch.set_num_threads(1)
TVS, CB, MASK = 256, 32, 250
TOK_A = tk.VariantATokens(mask=MASK, newline=251, answer_start=252,
                          answer_end=253, boi=254, eoi=255, uncondition=249,
                          pad=248, text_vocab_size=TVS, codebook_size=CB)
TOK_M = tk.VariantMTokens(mask=MASK, soi=251, eoi=252, bos=249, eos=248,
                          interleave=247, text_vocab_size=TVS,
                          codebook_size=CB)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, n_layers=2,
              mlp_hidden_size=64, vocab_size=TVS + CB, mask_token_id=MASK)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    jp = JL.init_llada_params(jax.random.key(3), jcfg)
    return jcfg, tcfg, jp, llada_params_from_jax(_np_tree(jp))


def _assert_frames_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(g[0]))


def test_ti2ti_stepwise_frames_match_jax(models):
    jcfg, tcfg, jp, tp = models
    ids, lay = tk.assemble_ti2ti_sequence([5, 6, 7, 8], 8, 2, 3, [9],
                                          tokens=TOK_A)
    kw = dict(text_steps=10, timesteps=3, temperature=0.0,
              text_temperature=0.0, cfg_scale=1.5, cfg_img=2.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
    ut, ui = np.array([40, 41, 42], np.int32), np.array([50, 51], np.int32)
    want = list(JS.generate_ti2ti_stepwise(
        jp, jcfg, ids, lay, JT.TI2TIOptions(**kw), ut, ui, key=None,
        yield_every=3))
    got = list(TS.generate_ti2ti_stepwise(
        tp, tcfg, ids, lay, TT.TI2TIOptions(**kw), ut, ui, yield_every=3))
    _assert_frames_equal(got, want)
    assert [f[0] for f in got] == [1, 4, 5, 7, 10]
    # one uncond prefix only: the other guidance term is zeros
    want = list(JS.generate_ti2ti_stepwise(
        jp, jcfg, ids, lay, JT.TI2TIOptions(**kw), None, ui, key=None))
    got = list(TS.generate_ti2ti_stepwise(
        tp, tcfg, ids, lay, TT.TI2TIOptions(**kw), None, ui))
    _assert_frames_equal(got, want)


def test_t2i_stepwise_frames_match_jax(models):
    jcfg, tcfg, jp, tp = models
    plen, n = 5, 6
    ids = np.asarray(list(range(10, 15)) + [251] + [MASK] * n + [252],
                     np.int32)
    un = np.asarray([40] * plen + [251] + [MASK] * n + [252], np.int32)
    kw = dict(timesteps=4, temperature=0.0, guidance_scale=1.5,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
    want = list(JS.t2i_generate_stepwise(jp, jcfg, ids, un, plen, n,
                                         JT2I.T2IOptions(**kw), key=None))
    got = list(TS.t2i_generate_stepwise(tp, tcfg, ids, un, plen, n,
                                        TT2I.T2IOptions(**kw)))
    _assert_frames_equal(got, want)
    # the last frame's codes are t2i_generate's result
    final = TT2I.t2i_generate(tp, tcfg, torch.tensor(ids[None]),
                              torch.tensor(un[None]), plen, n,
                              TT2I.T2IOptions(**kw))
    np.testing.assert_array_equal(got[-1][1], final[0].numpy())


def _m_sequences():
    head = [TOK_M.interleave, TOK_M.soi] + [TVS + 3] * 6 + [TOK_M.eoi]
    instr = [TOK_M.bos, 11, 12, 13, TOK_M.eos]
    ids, lay = tk.assemble_interleave_sequence(head + instr, 6, 8,
                                               tokens=TOK_M)
    un_head = [TOK_M.interleave, TOK_M.soi] + [0] * 6 + [TOK_M.eoi]
    un, _ = tk.assemble_interleave_sequence(
        un_head + [TOK_M.bos, TOK_M.eos] + [TOK_M.eos] * 3, 6, 8,
        tokens=TOK_M)
    return ids, un, lay


def test_interleave_stepwise_frames_match_jax_and_the_sampler(models):
    jcfg, tcfg, jp, tp = models
    ids, un, lay = _m_sequences()
    kw = dict(text_steps=8, image_steps=4, text_cfg=1.5, image_cfg=2.0,
              text_temperature=0.0, image_temperature=0.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
    want = list(JS.interleave_generate_stepwise(
        jp, jcfg, ids, un, lay, JI.InterleaveOptions(**kw), key=None,
        yield_every=3))
    got = list(TS.interleave_generate_stepwise(
        tp, tcfg, ids, un, lay, TI.InterleaveOptions(**kw), yield_every=3))
    _assert_frames_equal(got, want)
    fin, codes = TI.interleave_generate(tp, tcfg, torch.tensor(ids[None]),
                                        torch.tensor(un[None]), lay,
                                        TI.InterleaveOptions(**kw))
    np.testing.assert_array_equal(got[-1][1], fin[0].numpy())
    np.testing.assert_array_equal(got[-1][2], codes[0].numpy())
    with pytest.raises(ValueError, match="generator"):
        next(TS.interleave_generate_stepwise(
            tp, tcfg, ids, un, lay,
            TI.InterleaveOptions(**dict(kw, remasking="random"))))


class FakeTok:
    bos_token_id, eos_token_id = 1, 2

    def __call__(self, t, **kw):
        return {"input_ids": [1] + [10 + ord(c) % 80 for c in t[:8]] + [2]}

    def decode(self, ids, **kw):
        return " ".join(map(str, ids))


def test_decode_text_with_masks_matches_jax():
    lay = tk.build_ti2ti_layout(3, 30, 1, 1, tokens=TOK_A)
    ids = np.zeros(lay.total_len, np.int64)
    span = [7, 8, MASK, MASK, 9] + [MASK] * 14 + [10, 11, 12] + [MASK] * 8
    ids[lay.text_start:lay.text_end] = span
    for tok in (FakeTok(), object()):
        got = TS.decode_text_with_masks(ids, lay, tok, MASK)
        assert got == JS.decode_text_with_masks(ids, lay, tok, MASK)
    assert "[...9 more]" in got


@pytest.fixture(scope="module")
def a_pipes():
    T = tk.TOKENS_A
    jv, tv = JV.AmusedVQConfig.tiny(), TV.AmusedVQConfig.tiny()
    jvp = JV.init_amused_vq_params(jax.random.key(0), jv)
    kw = dict(vocab_size=T.full_vocab_size, n_layers=1)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    jp = JL.init_llada_params(jax.random.key(1), jcfg)
    return (JaxAPipe(jcfg, jp, jv, jvp, FakeTok()),
            TI2TIPipeline(tcfg, llada_params_from_jax(_np_tree(jp)), tv,
                          amused_params_from_jax(_np_tree(jvp)), FakeTok()))


def _records(out_dir):
    with open(os.path.join(out_dir, "status.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        r["frame"] = os.path.basename(r["frame"])
    return recs


def _frames_close(a_dir, b_dir, recs):
    """Decoded pixels agree at f32 tolerance, so the PNG frames differ by at
    most one level where a value sits at a rounding boundary."""
    for r in recs:
        a = np.asarray(Image.open(os.path.join(a_dir, r["frame"])), np.int16)
        b = np.asarray(Image.open(os.path.join(b_dir, r["frame"])), np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_run_stream_writes_jax_records(a_pipes, tmp_path):
    jax_pipe, port = a_pipes
    kw = dict(text_steps=6, timesteps=2, temperature=0.0,
              text_temperature=0.0, cfg_scale=2.5, cfg_img=4.0,
              codebook_size=32)
    arr = (np.random.default_rng(0).random((32, 32, 3)) * 255).astype(
        np.uint8)
    call = dict(height=32, width=32, text_gen_length=8, seed=0)
    j_text, j_prev = JD.run_stream(jax_pipe, "add a hat",
                                   Image.fromarray(arr),
                                   opts=JT.TI2TIOptions(**kw),
                                   output_dir=str(tmp_path / "jax"), **call)
    seen = []
    t_text, t_prev = TD.run_stream(port, "add a hat", arr,
                                   opts=TT.TI2TIOptions(**kw),
                                   output_dir=str(tmp_path / "port"),
                                   on_frame=lambda *a: seen.append(a[0]),
                                   **call)
    recs = _records(tmp_path / "port")
    assert recs == _records(tmp_path / "jax")
    assert t_text == j_text and seen == [r["step"] for r in recs]
    _frames_close(tmp_path / "port", tmp_path / "jax", recs)


def test_overlay_pixels_equal_jax():
    rng = np.random.default_rng(2)
    img = Image.fromarray((rng.random((32, 48, 3)) * 255).astype(np.uint8))
    still = rng.random(2 * 3) < 0.5
    a = np.asarray(TD.overlay_masked_patches(img, still, (2, 3)))
    b = np.asarray(JD.overlay_masked_patches(img, still, (2, 3)))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, np.asarray(img))


def test_run_stream_m_writes_jax_records(models, tmp_path):
    jcfg, tcfg, jp, tp = models
    vcfg = JM.MagvitConfig.tiny()                 # 16 codes, scale 2
    jvp = JM.init_magvit_params(jax.random.key(9), vcfg)
    T = tk.VariantMTokens(mask=MASK, soi=251, eoi=252, bos=249, eos=248,
                          interleave=247, text_vocab_size=TVS,
                          codebook_size=16)
    pkw = dict(tokens=T, num_vq_tokens=64, max_seq_length=8, resolution=16)
    jax_pipe = JaxMPipe(jcfg, jp, vcfg, jvp, FakeTok(), **pkw)
    port = InterleavePipeline(tcfg, tp, TM.MagvitConfig.tiny(),
                              magvit_params_from_jax(_np_tree(jvp)),
                              FakeTok(), **pkw)
    kw = dict(text_steps=6, image_steps=3, text_cfg=1.5, image_cfg=2.0,
              text_temperature=0.0, image_temperature=0.0,
              text_vocab_size=TVS, codebook_size=16, mask_token=MASK)
    img = Image.fromarray((np.random.default_rng(1).random((16, 16, 3))
                           * 255).astype(np.uint8))
    j_text, _ = JD.run_stream_m(jax_pipe, "add a hat", img,
                                JI.InterleaveOptions(**kw), 5,
                                str(tmp_path / "jax"))
    t_text, t_prev = TD.run_stream_m(port, "add a hat", img,
                                     TI.InterleaveOptions(**kw), 5,
                                     str(tmp_path / "port"))
    recs = _records(tmp_path / "port")
    assert recs == _records(tmp_path / "jax") and t_text == j_text
    assert t_prev.size == (16, 16)
    _frames_close(tmp_path / "port", tmp_path / "jax", recs)


def test_demo_cli_flags():
    """The JAX demo's flags, plus ``--device`` (the card by default)."""
    import argparse
    import inspect
    src = inspect.getsource(JD.main)
    port = {a.dest: a.default for a in TD.build_parser()._actions
            if not isinstance(a, argparse._HelpAction)}
    assert port.pop("device") == "cuda"
    for dest, default in port.items():
        assert f'"--{dest}"' in src, dest
    opts, paint = TD.knobs_to_options(64, 0.0, 4.0, 1.0, 0.7,
                                      "low_confidence", "", 0.5, 0.5)
    jopts, jpaint = JD.knobs_to_options(64, 0.0, 4.0, 1.0, 0.7,
                                        "low_confidence", "", 0.5, 0.5)
    assert paint == jpaint
    assert {k: v for k, v in vars(opts).items()} == \
        {k: v for k, v in vars(jopts).items()}
