"""Variant M in the port against the JAX package, with bridged weights at
temperature 0: ``interleave_generate`` and ``interleave_generate_cached``
token-exact (the cached one also equal to the exact one when every step
refreshes), ``InterleavePipeline`` against JAX's (text, codes, decoded
pixels at f32 tolerance), a MagViT safetensors round trip, and the
``cli/infer_m`` flags."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.models import magvit2 as JM
from mmada_parallel_tpu.pipeline import InterleavePipeline as JaxPipeline
from mmada_parallel_tpu.samplers import interleave as JI
from mmada_parallel_torch.models import convert as TCV
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models import magvit2 as TM
from mmada_parallel_torch.models.from_jax import (llada_params_from_jax,
                                                  magvit_params_from_jax)
from mmada_parallel_torch.pipeline import InterleavePipeline
from mmada_parallel_torch.samplers import interleave as TI

torch.set_num_threads(1)
TVS, CB, MASK = 256, 16, 250
TOK = tk.VariantMTokens(mask=MASK, soi=251, eoi=252, bos=249, eos=248,
                        interleave=247, text_vocab_size=TVS,
                        codebook_size=CB)
N_VQ, MSL = 6, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    kw = dict(d_model=32, n_heads=2, n_kv_heads=2, n_layers=2,
              mlp_hidden_size=64, vocab_size=TVS + CB, mask_token_id=MASK)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    jp = JL.init_llada_params(jax.random.key(4), jcfg)
    return jcfg, tcfg, jp, llada_params_from_jax(_np_tree(jp))


def _setup(steps=8, image_steps=4):
    head = [TOK.interleave, TOK.soi] + [TVS + 3] * N_VQ + [TOK.eoi]
    instr = [TOK.bos, 11, 12, 13, TOK.eos]
    ids, lay = tk.assemble_interleave_sequence(head + instr, N_VQ, MSL,
                                               tokens=TOK)
    un_head = [TOK.interleave, TOK.soi] + [0] * N_VQ + [TOK.eoi]
    un_ids, _ = tk.assemble_interleave_sequence(
        un_head + [TOK.bos, TOK.eos] + [TOK.eos] * (len(instr) - 2),
        N_VQ, MSL, tokens=TOK)
    kw = dict(text_steps=steps, image_steps=image_steps, text_cfg=1.5,
              image_cfg=2.0, text_temperature=0.0, image_temperature=0.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
    return ids, un_ids, lay, kw


def test_exact_token_exact_against_jax(models):
    jcfg, tcfg, jp, tp = models
    ids, un_ids, lay, kw = _setup()
    jf, jc = JI.interleave_generate(jp, jcfg, jnp.asarray(ids)[None],
                                    jnp.asarray(un_ids)[None], lay,
                                    JI.InterleaveOptions(**kw), key=None)
    tf, tc = TI.interleave_generate(tp, tcfg, torch.tensor(ids[None]),
                                    torch.tensor(un_ids[None]), lay,
                                    TI.InterleaveOptions(**kw))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    f = tf.numpy()[0]
    assert not np.any(f[lay.text_start:lay.text_end] == MASK)


def test_exact_with_uncond_pad_mask_against_jax(models):
    """A ragged uncond row (its own pad pattern) re-ranks RoPE positions and
    hides the pads in both packages alike."""
    jcfg, tcfg, jp, tp = models
    ids, un_ids, lay, kw = _setup()
    un_mask = np.ones((1, len(ids)), bool)
    un_mask[0, lay.code_start - 3:lay.code_start] = False
    jf, jc = JI.interleave_generate(
        jp, jcfg, jnp.asarray(ids)[None], jnp.asarray(un_ids)[None], lay,
        JI.InterleaveOptions(**kw), key=None,
        uncond_attn_mask=jnp.asarray(un_mask))
    tf, tc = TI.interleave_generate(
        tp, tcfg, torch.tensor(ids[None]), torch.tensor(un_ids[None]), lay,
        TI.InterleaveOptions(**kw), uncond_attn_mask=torch.tensor(un_mask))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_cached_equals_exact_when_always_refreshing(models):
    _, tcfg, _, tp = models
    ids, un_ids, lay, kw = _setup()
    opts = TI.InterleaveOptions(**kw)
    args = (tp, tcfg, torch.tensor(np.stack([ids, ids])),
            torch.tensor(np.stack([un_ids, un_ids])), lay, opts)
    want = TI.interleave_generate(*args)
    got = TI.interleave_generate_cached(*args, refresh_interval=1,
                                        warmup_ratio=1.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("cache_kw", [
    dict(cache_ratio=0.5, refresh_interval=3, warmup_ratio=0.25),
    dict(refresh_on_image_steps=False),
])
def test_cached_real_schedule_token_exact_against_jax(models, cache_kw):
    jcfg, tcfg, jp, tp = models
    ids, un_ids, lay, kw = _setup(steps=16, image_steps=4)
    sched_kw = {k: v for k, v in cache_kw.items() if k != "cache_ratio"}
    assert (~TI.interleave_refresh_schedule(16, 4, **sched_kw)).sum() >= 2
    jf, jc = JI.interleave_generate_cached(
        jp, jcfg, jnp.asarray(ids)[None], jnp.asarray(un_ids)[None], lay,
        JI.InterleaveOptions(**kw), key=None, **cache_kw)
    tf, tc = TI.interleave_generate_cached(
        tp, tcfg, torch.tensor(ids[None]), torch.tensor(un_ids[None]), lay,
        TI.InterleaveOptions(**kw), **cache_kw)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_refresh_schedule():
    """16 steps, 4 image steps (4, 8, 11, 15): warmup 0-4, every 4th step
    after it, and each image step and the one after it."""
    got = np.flatnonzero(TI.interleave_refresh_schedule(16, 4))
    assert got.tolist() == [0, 1, 2, 3, 4, 5, 8, 9, 11, 12, 15]
    bare = TI.interleave_refresh_schedule(16, 4, refresh_on_image_steps=False)
    assert np.flatnonzero(bare).tolist() == [0, 1, 2, 3, 4, 8, 12]


def test_sampled_run_is_seeded(models):
    _, tcfg, _, tp = models
    ids, un_ids, lay, kw = _setup()
    opts = TI.InterleaveOptions(**dict(kw, text_temperature=0.7,
                                       image_temperature=1.0))
    runs = [TI.interleave_generate_cached(
        tp, tcfg, torch.tensor(ids[None]), torch.tensor(un_ids[None]), lay,
        opts, generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert int(runs[0][1].min()) >= 0 and int(runs[0][1].max()) < CB


class FakeTok:
    bos_token_id, eos_token_id = 1, 2

    def __call__(self, t, **kw):
        return {"input_ids": [1] + [10 + ord(c) % 80 for c in t[:8]] + [2]}

    def decode(self, ids, **kw):
        return " ".join(map(str, ids))


@pytest.fixture(scope="module")
def pipes(models):
    jcfg, tcfg, jp, tp = models
    vcfg = JM.MagvitConfig.tiny()                 # z=4: 16 codes, scale 2
    jvp = JM.init_magvit_params(jax.random.key(9), vcfg)
    kw = dict(tokens=TOK, num_vq_tokens=64, max_seq_length=MSL,
              resolution=16)
    jax_pipe = JaxPipeline(jcfg, jp, vcfg, jvp, FakeTok(), **kw)
    port = InterleavePipeline(tcfg, tp, TM.MagvitConfig.tiny(),
                              magvit_params_from_jax(_np_tree(jvp)),
                              FakeTok(), **kw)
    return jax_pipe, port


@pytest.mark.parametrize("use_cache", [False, True])
def test_pipeline_matches_jax(pipes, use_cache):
    jax_pipe, port = pipes
    kw = dict(text_steps=8, image_steps=4, text_cfg=1.5, image_cfg=2.0,
              text_temperature=0.0, image_temperature=0.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
    arr = (np.random.default_rng(0).random((16, 16, 3)) * 255).astype(
        np.uint8)
    call = dict(seed=7, use_cache=use_cache,
                cache_kw=dict(refresh_interval=3, refresh_on_image_steps=False)
                if use_cache else None)      # partial steps 3, 4, 6, 7
    _, j_text, j_info = jax_pipe("add a hat", Image.fromarray(arr),
                                 JI.InterleaveOptions(**kw), **call)
    t_img, t_text, t_info = port("add a hat", arr, TI.InterleaveOptions(**kw),
                                 **call)
    assert t_text == j_text and len(t_text) > 0
    np.testing.assert_array_equal(t_info["codes"], j_info["codes"])
    want = np.asarray(JM.magvit_decode_code(jax_pipe.vq_params,
                                            jax_pipe.vq_cfg,
                                            jnp.asarray(j_info["codes"])))[0]
    np.testing.assert_allclose(t_info["pixels"],
                               np.clip((want + 1.0) / 2.0, 0.0, 1.0),
                               atol=1e-4, rtol=1e-4)
    assert t_img is None                           # array in, no PIL out
    # the sequences the two packages build agree, ids included
    j_ids, j_un, j_lay = jax_pipe.build_sequences("add a hat",
                                                  Image.fromarray(arr))
    t_ids, t_un, t_lay = port.build_sequences("add a hat", arr)
    # the port's SequenceLayout is its own copy of the class: compare fields
    assert dataclasses.asdict(t_lay) == dataclasses.asdict(j_lay)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_un, j_un)


def test_pipeline_resizes_other_sizes_like_jax(pipes):
    """A PIL image or an array at another size is squashed to the
    resolution with PIL's bicubic resize, as the JAX pipeline does."""
    jax_pipe, port = pipes
    arr = (np.random.default_rng(1).random((24, 20, 3)) * 255).astype(
        np.uint8)
    j_ids, _, _ = jax_pipe.build_sequences("x", Image.fromarray(arr))
    for image in (arr, Image.fromarray(arr)):
        t_ids, _, _ = port.build_sequences("x", image)
        np.testing.assert_array_equal(t_ids, j_ids)


def test_magvit_safetensors_roundtrip(tmp_path):
    """Taming-named safetensors -> the port's params equal the bridged JAX
    tree (OIHW convs, ``nin_shortcut``, conv attention)."""
    from safetensors.numpy import save_file
    from test_convert import _magvit_state_dict
    cfg = JM.MagvitConfig.tiny()
    params = JM.init_magvit_params(jax.random.key(2), cfg)
    sd = {k: np.ascontiguousarray(v)
          for k, v in _magvit_state_dict(params).items()}
    save_file(sd, str(tmp_path / "model.safetensors"))
    got = TCV.magvit_params_from_torch(
        TCV.load_safetensors_dir(str(tmp_path)), TM.MagvitConfig.tiny())
    want = magvit_params_from_jax(_np_tree(params))

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in flat(v, f"{prefix}{k}.").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in flat(v, f"{prefix}{i}.").items()}
        return {prefix[:-1]: tree}
    fg, fw = flat(got), flat(want)
    assert set(fg) == set(fw)
    for k in fw:
        assert torch.equal(fg[k], fw[k]), k


def test_infer_cli_keeps_the_jax_flags(tmp_path):
    from mmada_parallel_tpu.cli import infer_m as jcli
    from mmada_parallel_torch.cli import infer_m as tcli
    assert {k: v for k, v in tcli.DEFAULTS.items()
            if k not in ("use_cache", "device")} == jcli.DEFAULTS
    assert tcli.DEFAULTS["use_cache"] is False
    assert tcli.DEFAULTS["device"] == "cuda"
    path = tmp_path / "m.yaml"
    path.write_text(json.dumps({"text_steps": 64, "image_steps": 10}))
    cfg = tcli.parse_config([f"config={path}", "use_cache=true",
                             "text_cfg=3.0"])
    assert (cfg.text_steps, cfg.image_steps, cfg.text_cfg, cfg.use_cache,
            cfg.resolution) == (64, 10, 3.0, True, 512)
