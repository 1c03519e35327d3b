"""A tiny ``TI2TIPipeline`` edit through both packages with shared weights,
and the port's checkpoint conversion on synthetic safetensors.

At temperature 0 the thinking text and every image code that the sampler
decided are equal; the re-mask keeps at least one image token masked to the
end, and each package fills those from its own generator (JAX from its key,
the port from its ``torch.Generator``), so they are compared through that
rule.  Decoded pixels agree at atol/rtol 1e-4 (f32 convolutions)."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import amused_vq as JV
from mmada_parallel_tpu.models import convert as JCV
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.pipeline import TI2TIPipeline as JaxPipeline
from mmada_parallel_tpu.samplers.parallel_ti2ti import TI2TIOptions as JOpts
from mmada_parallel_torch.models import amused_vq as TV
from mmada_parallel_torch.models import convert as TCV
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import (amused_params_from_jax,
                                                  llada_params_from_jax)
from mmada_parallel_torch.pipeline import TI2TIPipeline
from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions

torch.set_num_threads(1)
T = tk.TOKENS_A
TOL = dict(atol=1e-4, rtol=1e-4)


class FakeTok:
    bos_token_id, eos_token_id = 1, 2

    def __call__(self, t, **kw):
        return {"input_ids": [1] + [10 + ord(c) % 80 for c in t[:8]] + [2]}

    def decode(self, ids, **kw):
        return " ".join(map(str, ids))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipes():
    jv, tv = JV.AmusedVQConfig.tiny(), TV.AmusedVQConfig.tiny()
    jvp = JV.init_amused_vq_params(jax.random.key(0), jv)
    kw = dict(vocab_size=T.full_vocab_size)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    jp = JL.init_llada_params(jax.random.key(1), jcfg)
    jax_pipe = JaxPipeline(jcfg, jp, jv, jvp, FakeTok())
    port = TI2TIPipeline(tcfg, llada_params_from_jax(_np_tree(jp)), tv,
                         amused_params_from_jax(_np_tree(jvp)), FakeTok())
    return jax_pipe, port


def _image():
    arr = (np.random.default_rng(0).random((32, 32, 3)) * 255).astype(
        np.uint8)
    return arr, Image.fromarray(arr)


@pytest.mark.parametrize("cfg_scale,cfg_img,painting", [
    (2.5, 4.0, None), (0.0, 1.0, "inpainting")])
def test_pipeline_edit_matches_jax(pipes, cfg_scale, cfg_img, painting):
    jax_pipe, port = pipes
    # codebook_size matches the tiny VQ's 32 entries
    kw = dict(text_steps=4, timesteps=2, temperature=0.0,
              text_temperature=0.0, cfg_scale=cfg_scale, cfg_img=cfg_img,
              codebook_size=32)
    arr, pil = _image()
    call = dict(text_gen_length=8, seed=7, painting_mode=painting)
    j_img, j_text, j_info = jax_pipe("add a hat", pil, 32, 32, JOpts(**kw),
                                     **call)
    t_img, t_text, t_info = port("add a hat", arr, 32, 32,
                                 TI2TIOptions(**kw), **call)
    assert t_text == j_text and len(t_text) > 0
    # the port's SequenceLayout is its own copy of the class: compare fields
    assert dataclasses.asdict(t_info["layout"]) == \
        dataclasses.asdict(j_info["layout"])

    lay = t_info["layout"]
    still = t_info["ids"][0, lay.image_positions()] == T.mask
    jc, tc = j_info["codes"][0], t_info["codes"][0]
    assert np.array_equal(tc[~still], jc[~still])
    fill = np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.key(7), 0xF1), j_info["codes"].shape,
        0, 32))[0]
    assert np.array_equal(jc[still], fill[still])

    want = np.asarray(JV.amused_decode_code(
        jax_pipe.vq_params, jax_pipe.vq_cfg, jnp.asarray(j_info["codes"]),
        (16, 16)))[0]
    np.testing.assert_allclose(port.decode_vq_to_pixels(j_info["codes"], 32,
                                                        32), want, **TOL)
    px = t_info["pixels"]
    assert px.shape == (32, 32, 3) and np.isfinite(px).all()
    assert t_img is None                        # array in, no PIL out
    # a PIL input gives the same edit as its array, and a PIL image back
    img2, text2, info2 = port("add a hat", pil, 32, 32, TI2TIOptions(**kw),
                              **call)
    assert text2 == t_text and np.array_equal(info2["ids"], t_info["ids"])
    assert img2.size == (32, 32)


def test_pipeline_cache_option_not_ported(pipes):
    """``use_cache=True`` (once refused) runs the cached sampler: at
    temperature 0 the text and the decided codes equal the JAX pipeline's
    cached edit, whose schedule here has partial steps (4, 5, 6 and 8 of
    0-9)."""
    jax_pipe, port = pipes
    kw = dict(text_steps=10, timesteps=2, temperature=0.0,
              text_temperature=0.0, cfg_scale=2.5, cfg_img=4.0,
              codebook_size=32)
    arr, pil = _image()
    call = dict(text_gen_length=16, seed=7, use_cache=True)
    _, j_text, j_info = jax_pipe("add a hat", pil, 32, 32, JOpts(**kw),
                                 **call)
    _, t_text, t_info = port("add a hat", arr, 32, 32, TI2TIOptions(**kw),
                             **call)
    assert t_text == j_text and len(t_text) > 0
    lay = t_info["layout"]
    still = t_info["ids"][0, lay.image_positions()] == T.mask
    assert np.array_equal(t_info["codes"][0][~still],
                          j_info["codes"][0][~still])


def test_infer_cli_keeps_the_jax_flags():
    from mmada_parallel_tpu.cli import infer_a as jcli
    from mmada_parallel_torch.cli import infer_a as tcli

    def flags(parser):
        return {a.dest: (a.default, a.required) for a in parser._actions}

    port = flags(tcli.build_parser())
    # the one flag the port adds: the device, explicit, the card by default
    assert port.pop("device") == ("cuda", False)
    assert port == flags(jcli.build_parser())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.mark.parametrize("block_type", ["llama", "sequential"])
def test_llada_checkpoint_roundtrip(tmp_path, block_type):
    """The JAX package writes an HF-layout checkpoint; the port loads it
    into the same tensors the bridge gives."""
    cfg = JL.LLaDAConfig.tiny(block_type=block_type, include_qkv_bias=True,
                              weight_tying=block_type == "sequential")
    params = JL.init_llada_params(jax.random.key(3), cfg)
    JCV.save_llada_checkpoint(str(tmp_path), params, cfg)
    tcfg, tparams = TCV.load_llada_checkpoint(str(tmp_path))
    for f in ("d_model", "n_heads", "n_kv_heads", "n_layers", "block_type",
              "weight_tying", "include_qkv_bias", "vocab_size"):
        assert getattr(tcfg, f) == getattr(cfg, f), f
    want = _flat(_np_tree(params))
    got = _flat(tparams)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


def test_amused_checkpoint_roundtrip(tmp_path):
    """Diffusers-named safetensors -> the port's params equal the bridged
    JAX tree (OIHW convs, 1x1-conv attention, re-indexed up blocks)."""
    from safetensors.numpy import save_file
    from test_convert import _amused_state_dict
    cfg = JV.AmusedVQConfig.tiny()
    params = JV.init_amused_vq_params(jax.random.key(4), cfg)
    vq_dir = tmp_path / "vqvae"
    vq_dir.mkdir()
    sd = {k: np.ascontiguousarray(v)
          for k, v in _amused_state_dict(params, cfg).items()}
    save_file(sd, str(vq_dir / "diffusion_pytorch_model.safetensors"))
    (vq_dir / "config.json").write_text(json.dumps({
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        "latent_channels": cfg.latent_channels,
        "num_vq_embeddings": cfg.num_vq_embeddings,
        "norm_num_groups": cfg.norm_num_groups}))
    tcfg = TCV.amused_config_from_hf(json.loads(
        (vq_dir / "config.json").read_text()))
    assert tcfg == TV.AmusedVQConfig.tiny()
    got = TCV.amused_params_from_torch(TCV.load_safetensors_dir(str(vq_dir)),
                                       tcfg)
    want = amused_params_from_jax(_np_tree(params))
    fg, fw = _flat(got), _flat(want)
    assert set(fg) == set(fw)
    for k in fw:
        np.testing.assert_array_equal(fg[k], fw[k], k)


def test_pipelines_run_the_tokenizers_with_tf32_off(pipes, monkeypatch):
    """Every VQ encode and decode of both pipelines enters the scoped cuDNN
    settings with TF32 off, the caller's other settings passed through, and
    leaves them as they were."""
    from mmada_parallel_torch.models import magvit2 as TM
    from mmada_parallel_torch.pipeline import InterleavePipeline
    calls = []
    real = torch.backends.cudnn.flags

    def recording(**kw):
        calls.append(kw)
        return real(**kw)

    monkeypatch.setattr(torch.backends.cudnn, "flags", recording)
    before = torch.backends.cudnn.allow_tf32
    _, port = pipes
    arr, _ = _image()
    port.encode_img_with_breaks(arr)
    port.decode_vq_to_pixels(np.zeros((1, 256), np.int64), 32, 32)
    mcfg = TM.MagvitConfig.tiny()
    mpipe = InterleavePipeline(
        port.llada_cfg, port.llada_params, mcfg,
        TM.init_magvit_params(mcfg, torch.Generator().manual_seed(0)),
        FakeTok(), num_vq_tokens=64, max_seq_length=4, resolution=16)
    mpipe.build_sequences("x", arr[:16, :16])
    mpipe.decode_codes_to_pixels(np.zeros((1, 64), np.int64))
    assert len(calls) == 4
    for kw in calls:
        assert kw["allow_tf32"] is False
        assert kw["enabled"] == torch.backends.cudnn.enabled
        assert kw["deterministic"] == torch.backends.cudnn.deterministic
    assert torch.backends.cudnn.allow_tf32 == before
