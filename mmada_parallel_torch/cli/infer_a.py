"""TI2TI inference CLI (variant A) on PyTorch/CUDA.

The flags of :mod:`mmada_parallel_tpu.cli.infer_a`, plus ``--device``
(default ``cuda``; a missing card raises, the run does not move to the
CPU).  Loads the HF checkpoint
and the Amused-VQ ``vqvae`` subfolder through the port's converters and runs
the exact sampler.  ``transformers`` and PIL are imported inside
:func:`main` and :func:`load_pipeline`.

    python -m mmada_parallel_torch.cli.infer_a \
        --checkpoint /ckpts/MMaDA-Parallel-A --vae_ckpt /ckpts/MMaDA-Parallel-A \
        --prompt "make the sky purple" --image_path in.png
"""

import argparse
import json
import os
import time


def build_parser():
    p = argparse.ArgumentParser(description="Text+Image to Text+Image (TI2TI)")
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--image_path", type=str, required=True)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--timesteps", type=int, default=64)
    p.add_argument("--text_steps", type=int, default=256)
    p.add_argument("--text_gen_length", type=int, default=256)
    p.add_argument("--text_block_length", type=int, default=32)
    p.add_argument("--cfg_scale", type=float, default=2.5)
    p.add_argument("--cfg_img", type=float, default=4.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--text_temperature", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--vae_ckpt", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="results_ti2ti")
    p.add_argument("--remasking", type=str, default="low_confidence",
                   choices=["low_confidence", "random"])
    p.add_argument("--painting_mode", type=str, default=None)
    p.add_argument("--mask_h_ratio", type=float, default=0.5)
    p.add_argument("--mask_w_ratio", type=float, default=0.5)
    p.add_argument("--debug_tokens", action="store_true")
    p.add_argument("--edit_type", type=str, default=None,
                   help="edit-type-specific prompt/system template: e.g. "
                        "edit, canny_dense, control, subject, ref_transfer, "
                        "multi_view_left")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cpu for the tests)")
    return p


def load_pipeline(checkpoint: str, vae_ckpt: str, device: str,
                  dtype="bfloat16"):
    import dataclasses

    import torch
    from transformers import AutoTokenizer

    from mmada_parallel_torch.models import convert as CV
    from mmada_parallel_torch.pipeline import TI2TIPipeline

    tdt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    tokenizer = AutoTokenizer.from_pretrained(checkpoint,
                                              trust_remote_code=True)
    cfg, params = CV.load_llada_checkpoint(checkpoint, dtype=tdt)
    cfg = dataclasses.replace(cfg, param_dtype=tdt, compute_dtype=tdt)
    params = {k: ({n: t.to(device) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(device))
              for k, v in params.items()}

    vq_dir = os.path.join(vae_ckpt, "vqvae")
    with open(os.path.join(vq_dir, "config.json")) as f:
        vq_cfg = CV.amused_config_from_hf(json.load(f))
    vq_params = CV.amused_params_from_torch(
        CV.load_safetensors_dir(vq_dir, device), vq_cfg)
    return TI2TIPipeline(cfg, params, vq_cfg, vq_params, tokenizer)


def main(argv=None):
    from PIL import Image

    from mmada_parallel_torch.utils.image import preprocess_image
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions

    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    pipe = load_pipeline(args.checkpoint, args.vae_ckpt, args.device)

    opts = TI2TIOptions(
        text_steps=args.text_steps, timesteps=args.timesteps,
        temperature=args.temperature, text_temperature=args.text_temperature,
        cfg_scale=args.cfg_scale, cfg_img=args.cfg_img,
        remasking=args.remasking)

    img = preprocess_image(args.image_path)
    prompt = args.prompt
    pipe_kw = {}
    if args.edit_type:
        from mmada_parallel_torch import tokens as tk
        if "multiturn" in args.edit_type:
            raise SystemExit(
                "--edit_type *_multiturn_* needs a list of turns; use "
                "tokens.edit_type_prompt from the API instead")
        prompt = tk.edit_type_prompt(args.edit_type, args.prompt)
        pipe_kw["system_prompt"] = tk.edit_type_system_prompt(args.edit_type)
    t0 = time.time()
    out_img, text, info = pipe(
        prompt, img, args.height, args.width, opts,
        text_gen_length=args.text_gen_length, seed=args.seed,
        painting_mode=args.painting_mode, mask_h_ratio=args.mask_h_ratio,
        mask_w_ratio=args.mask_w_ratio, **pipe_kw)
    elapsed = time.time() - t0

    words = "".join(c for c in "_".join(args.prompt.split()[:10])
                    if c.isalnum() or c in "_-")
    base = (f"{words}_{args.height}x{args.width}_t{args.timesteps}"
            f"_cfg{args.cfg_scale}_ti2ti")
    save_path = os.path.join(args.output_dir, base + ".png")
    out_img.save(save_path)
    # side-by-side concat like the reference
    w1, h1 = img.size
    w2, h2 = out_img.size
    canvas = Image.new("RGB", (w1 + w2, max(h1, h2)), "white")
    canvas.paste(img, (0, 0))
    canvas.paste(out_img, (w1, 0))
    canvas.save(save_path.replace(".png", "_concat.png"))
    with open(save_path.replace(".png", "_thinking.txt"), "w") as f:
        f.write(f"{text}\n")
    print(f"[ok] image: {save_path}")
    print(f"[ok] thinking text: {text[:200] if isinstance(text, str) else text}")
    print(f"[ok] total time: {elapsed:.2f}s")


if __name__ == "__main__":
    main()
