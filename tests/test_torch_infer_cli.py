"""The port's inference CLIs from disk, on the CPU through ``--device cpu``.

The device is an explicit flag (default ``cuda``): nothing moves a run to the
CPU by itself.  These tests load the tiny HF-format checkpoints that
``test_cli_e2e.py`` writes for the JAX CLIs and run the port's
``infer_a.main`` / ``infer_m.main`` with the CPU named, checking the files
each writes."""

import json
import os

import jax
import numpy as np
from PIL import Image

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import amused_vq as A
from mmada_parallel_tpu.models import convert as CV
from mmada_parallel_tpu.models import magvit2 as M

from test_cli_e2e import (_save_safetensors, _write_llada_checkpoint)
from test_convert import _amused_state_dict, _magvit_state_dict


def _image(path):
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), np.uint8)).save(path)


def test_infer_a_cli_on_cpu(tmp_path):
    from mmada_parallel_torch.cli import infer_a

    T = tk.TOKENS_A
    ckpt = str(tmp_path / "ckpt_a")
    _write_llada_checkpoint(ckpt, T.full_vocab_size, T.mask)
    vq_dir = os.path.join(ckpt, "vqvae")
    os.makedirs(vq_dir)
    hf_cfg = {"block_out_channels": [8, 8, 8, 8, 8], "layers_per_block": 1,
              "latent_channels": 8, "num_vq_embeddings": T.codebook_size,
              "norm_num_groups": 4}
    with open(os.path.join(vq_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    vq_params = A.init_amused_vq_params(jax.random.key(1),
                                        CV.amused_config_from_hf(hf_cfg))
    _save_safetensors(os.path.join(vq_dir, "model.safetensors"),
                      _amused_state_dict(vq_params,
                                         CV.amused_config_from_hf(hf_cfg)))
    in_path = str(tmp_path / "in.png")
    _image(in_path)

    out_dir = str(tmp_path / "out_a")
    infer_a.main([
        "--checkpoint", ckpt, "--vae_ckpt", ckpt, "--device", "cpu",
        "--prompt", "make the sky purple", "--image_path", in_path,
        "--height", "64", "--width", "64", "--timesteps", "2",
        "--text_steps", "2", "--text_gen_length", "8", "--cfg_scale", "0",
        "--cfg_img", "0", "--temperature", "0", "--text_temperature", "0",
        "--output_dir", out_dir])
    pngs = [p for p in os.listdir(out_dir)
            if p.endswith(".png") and "concat" not in p]
    assert len(pngs) == 1, os.listdir(out_dir)
    assert Image.open(os.path.join(out_dir, pngs[0])).size == (64, 64)
    assert os.path.exists(os.path.join(
        out_dir, pngs[0].replace(".png", "_thinking.txt")))


def test_infer_m_cli_on_cpu(tmp_path):
    from mmada_parallel_torch.cli import infer_m

    T = tk.TOKENS_M
    ckpt = str(tmp_path / "ckpt_m")
    _write_llada_checkpoint(ckpt, T.full_vocab_size, T.mask)
    vq_dir = str(tmp_path / "magvit")
    os.makedirs(vq_dir)
    arch = {"ch": 16, "enc_ch_mult": [1, 2], "enc_blocks": [1, 1],
            "dec_ch_mult": [1, 2], "dec_blocks": [1, 1], "z_channels": 13,
            "groups": 4}
    with open(os.path.join(vq_dir, "config.json"), "w") as f:
        json.dump(arch, f)
    vq_cfg = M.MagvitConfig(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in arch.items()})
    _save_safetensors(os.path.join(vq_dir, "model.safetensors"),
                      _magvit_state_dict(M.init_magvit_params(
                          jax.random.key(2), vq_cfg)))
    root = tmp_path / "cases"
    root.mkdir()
    _image(str(root / "case0.png"))
    (root / "case0.txt").write_text("shift the palette by one")

    out_dir = str(tmp_path / "out_m")
    infer_m.main([
        f"checkpoint={ckpt}", f"vq_checkpoint={vq_dir}", "device=cpu",
        f"interleave_root={root}", f"output_dir={out_dir}", "text_steps=2",
        "image_steps=2", "text_cfg=0", "image_cfg=0", "text_temperature=0",
        "image_temperature=0", "max_seq_length=16", "num_vq_tokens=1024",
        "resolution=64"])
    out = Image.open(os.path.join(out_dir, "case0_out.png"))
    assert out.size == (64, 64)
    assert os.path.exists(os.path.join(out_dir, "case0_out.txt"))
