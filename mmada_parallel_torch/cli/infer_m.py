"""Interleave inference CLI (variant M) on PyTorch/CUDA.

The ``key=value`` flags and defaults of :mod:`mmada_parallel_tpu.cli.infer_m`,
plus ``use_cache`` and ``device`` (default ``cuda``; a missing card raises,
the run does not move to the CPU): walk ``interleave_root`` for (image, ``.txt``
instruction) pairs and run interleave generation.  The backbone loads through
the port's ``load_llada_checkpoint``, the VQ through
``magvit_params_from_torch``.  ``yaml`` (through the shared config loader),
``transformers`` and PIL are imported inside :func:`main` and
:func:`load_pipeline`.

    python -m mmada_parallel_torch.cli.infer_m config=configs/infer_m.yaml \
        interleave_root=./interleave_validation use_cache=true
"""

import dataclasses
import glob
import json
import os
import sys

DEFAULTS = {
    "checkpoint": None,
    "vq_checkpoint": None,
    "interleave_root": "./interleave_validation",
    "output_dir": "results_interleave",
    "text_cfg": 2.5,
    "image_cfg": 4.0,
    "text_steps": 128,
    "image_steps": 30,
    "text_temperature": 0.0,
    "image_temperature": 1.0,
    "max_seq_length": 256,
    "num_vq_tokens": 1024,
    "resolution": 512,
    "seed": 42,
    "use_cache": False,
    "device": "cuda",
}


def load_pipeline(checkpoint: str, vq_checkpoint: str, device: str,
                  dtype="bfloat16"):
    import torch
    from transformers import AutoTokenizer

    from mmada_parallel_torch.models import convert as CV
    from mmada_parallel_torch.models.magvit2 import MagvitConfig
    from mmada_parallel_torch.pipeline import InterleavePipeline

    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    tokenizer = AutoTokenizer.from_pretrained(checkpoint,
                                              trust_remote_code=True)
    cfg, params = CV.load_llada_checkpoint(checkpoint, dtype=tdt)
    cfg = dataclasses.replace(cfg, param_dtype=tdt, compute_dtype=tdt)
    params = {k: ({n: t.to(device) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(device))
              for k, v in params.items()}
    # a config.json in the VQ dir sets the architecture; absent one, the
    # production defaults
    vq_cfg = MagvitConfig()
    vq_cfg_path = os.path.join(vq_checkpoint, "config.json")
    if os.path.exists(vq_cfg_path):
        names = {f.name for f in dataclasses.fields(MagvitConfig)}
        with open(vq_cfg_path) as f:
            fields = {k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in json.load(f).items() if k in names}
        vq_cfg = MagvitConfig(**fields)
    vq_params = CV.magvit_params_from_torch(
        CV.load_safetensors_dir(vq_checkpoint, device), vq_cfg)
    return InterleavePipeline(cfg, params, vq_cfg, vq_params, tokenizer)


def parse_config(argv=None):
    """``config=path.yaml`` plus ``key=value`` overrides over
    :data:`DEFAULTS` (the port's copy of the JAX package's loader, which
    needs ``yaml``: imported here, reached from :func:`main` only)."""
    from mmada_parallel_torch.config import load_config
    argv = list(sys.argv[1:] if argv is None else argv)
    path = None
    overrides = []
    for a in argv:
        if a.startswith("config="):
            path = a.split("=", 1)[1]
        else:
            overrides.append(a)
    return load_config(path, overrides, DEFAULTS)


def main(argv=None):
    from PIL import Image

    from mmada_parallel_torch.samplers.interleave import InterleaveOptions

    cfg = parse_config(argv)
    pipe = load_pipeline(cfg.checkpoint, cfg.vq_checkpoint, cfg.device)
    pipe.max_seq_length = cfg.max_seq_length
    pipe.num_vq_tokens = cfg.num_vq_tokens
    pipe.resolution = cfg.resolution

    opts = InterleaveOptions(
        text_steps=cfg.text_steps, image_steps=cfg.image_steps,
        text_cfg=cfg.text_cfg, image_cfg=cfg.image_cfg,
        text_temperature=cfg.text_temperature,
        image_temperature=cfg.image_temperature)

    os.makedirs(cfg.output_dir, exist_ok=True)
    images = sorted(sum((glob.glob(os.path.join(cfg.interleave_root, ext))
                         for ext in ("*.jpg", "*.jpeg", "*.png")), []))
    for img_path in images:
        txt_path = os.path.splitext(img_path)[0] + ".txt"
        if not os.path.exists(txt_path):
            continue
        with open(txt_path) as f:
            instruction = f.read().strip()
        img = Image.open(img_path).convert("RGB")
        out_img, text, info = pipe(instruction, img, opts, seed=cfg.seed,
                                   use_cache=bool(cfg.use_cache))
        base = os.path.splitext(os.path.basename(img_path))[0]
        out_img.save(os.path.join(cfg.output_dir, base + "_out.png"))
        with open(os.path.join(cfg.output_dir, base + "_out.txt"), "w") as f:
            f.write(text if isinstance(text, str) else str(text))
        print(f"[ok] {base}: {info['elapsed']:.2f}s — "
              f"{(text[:120] if isinstance(text, str) else text)}")


if __name__ == "__main__":
    main()
