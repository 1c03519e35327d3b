"""Streaming demo on PyTorch/CUDA.

Counterpart of :mod:`mmada_parallel_tpu.cli.demo`: runs a stepwise sampler
and, per yielded step, renders the partially decoded thinking text with mask
placeholders and a preview image with a gray overlay on still-masked latent
patches.  Frames go to ``--output_dir`` (``frame_{step:04d}.png`` and
``status.jsonl``); with gradio installed, ``--serve`` drives a live UI from
the same generator.  ``--device`` (default ``cuda``) names the card; a
missing card raises.  PIL, gradio and ``transformers`` are imported inside
the functions that use them.

    python -m mmada_parallel_torch.cli.demo --checkpoint /ckpts/A \
        --vae_ckpt /ckpts/A --prompt "make the sky purple" --image_path in.png
"""

import argparse
import json
import os


def overlay_masked_patches(img, still_masked, grid_hw,
                           gray=(128, 128, 128, 120)):
    """Gray rectangles over the still-masked latent cells of a PIL image."""
    import numpy as np
    from PIL import ImageDraw
    gh, gw = grid_hw
    ph, pw = img.size[1] // gh, img.size[0] // gw
    out = img.copy().convert("RGB")
    draw = ImageDraw.Draw(out, "RGBA")
    for idx in np.nonzero(still_masked)[0]:
        r, c = divmod(int(idx), gw)
        draw.rectangle([c * pw, r * ph, (c + 1) * pw, (r + 1) * ph],
                       fill=gray)
    return out


def _stream(frames, decode_text, preview, output_dir, on_frame):
    """Write each frame's preview and status record; returns the last
    ``(text, preview)``."""
    os.makedirs(output_dir, exist_ok=True)
    text = image = None
    with open(os.path.join(output_dir, "status.jsonl"), "w") as status:
        for step, ids_np, codes, still_masked in frames:
            text = decode_text(ids_np)
            image = preview(codes, still_masked)
            frame_path = os.path.join(output_dir, f"frame_{step:04d}.png")
            image.save(frame_path)
            rec = {"step": step, "text": text, "frame": frame_path,
                   "image_masked_pct":
                   round(float(100.0 * still_masked.mean()), 1)}
            status.write(json.dumps(rec) + "\n")
            status.flush()
            if on_frame is not None:
                on_frame(step, text, image, rec)
    return text, image


def _generator(device, seed: int):
    import torch
    return torch.Generator(device=device).manual_seed(seed)


def run_stream(pipe, prompt: str, image, height: int, width: int, opts,
               text_gen_length: int, seed: int, output_dir: str,
               on_frame=None, painting_mode=None, mask_h_ratio: float = 0.5,
               mask_w_ratio: float = 0.5):
    """Drive :func:`generate_ti2ti_stepwise` through a ``TI2TIPipeline``'s
    parts, assembling the sequence as the reference app does: the prompt
    with the image spliced in, the text- and image-CFG prefixes where their
    scales are nonzero, and an optional inpainting/outpainting span.
    ``seed=0`` is deterministic (argmax)."""
    import numpy as np
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.pipeline import SYSTEM_PROMPT_EDIT
    from mmada_parallel_torch.samplers.stepwise import (
        decode_text_with_masks, generate_ti2ti_stepwise)
    from mmada_parallel_torch.utils.image import array_to_image

    T = pipe.tokens
    cond_txt, uncond_txt = tk.make_ti2ti_prompt(prompt, SYSTEM_PROMPT_EDIT)
    prompt_ids = pipe.tokenizer(cond_txt)["input_ids"]
    uncond_ids = pipe.tokenizer(uncond_txt)["input_ids"]
    input_img_token = pipe.encode_img_with_breaks(image)
    con_input = prompt_ids[:-1] + input_img_token + prompt_ids[-1:]
    uncon_text = np.asarray(
        uncond_ids[:-1] + input_img_token + uncond_ids[-1:], np.int64)
    uncon_image = np.asarray(prompt_ids, np.int64)

    _, _, gh, gw = tk.calculate_vq_params(height, width, pipe.vq_cfg.scale)
    end_ids = pipe.tokenizer("</answer>", add_special_tokens=False)[
        "input_ids"]
    span = None
    if painting_mode:
        span = pipe.encode_img_with_paint(image, mask_h_ratio, mask_w_ratio,
                                          painting_mode)
    ids, layout = tk.assemble_ti2ti_sequence(con_input, text_gen_length,
                                             gh, gw, end_ids,
                                             image_span_tokens=span, tokens=T)
    frames = generate_ti2ti_stepwise(
        pipe.llada_params, pipe.llada_cfg, ids, layout, opts,
        uncond_text_prefix=uncon_text if opts.cfg_scale else None,
        uncond_image_prefix=uncon_image if opts.cfg_img else None,
        generator=_generator(pipe.device, seed) if seed else None)
    return _stream(
        frames,
        lambda ids_np: decode_text_with_masks(ids_np, layout, pipe.tokenizer,
                                              T.mask),
        lambda codes, still: overlay_masked_patches(
            array_to_image(pipe.decode_vq_to_pixels(codes[None], height,
                                                    width)),
            still, (gh, gw)),
        output_dir, on_frame)


def run_stream_m(pipe, instruction: str, image, opts, seed: int,
                 output_dir: str, on_frame=None):
    """Streaming interleave generation through an ``InterleavePipeline``,
    :func:`run_stream` for variant M.  ``seed=0`` draws an OS-random seed
    (the pipeline's unseeded-but-stochastic semantics)."""
    import numpy as np
    from mmada_parallel_torch.samplers.stepwise import (
        decode_text_with_masks, interleave_generate_stepwise)
    from mmada_parallel_torch.utils.image import array_to_image

    ids, un_ids, layout = pipe.build_sequences(instruction, image)
    side = int(round(pipe.num_vq_tokens ** 0.5))
    frames = interleave_generate_stepwise(
        pipe.llada_params, pipe.llada_cfg, ids, un_ids, layout, opts,
        generator=_generator(pipe.device, seed if seed else
                             int(np.random.randint(1, 2 ** 31))))
    return _stream(
        frames,
        lambda ids_np: decode_text_with_masks(ids_np, layout, pipe.tokenizer,
                                              pipe.tokens.mask),
        lambda codes, still: overlay_masked_patches(
            array_to_image(pipe.decode_codes_to_pixels(codes[None])),
            still, (side, side)),
        output_dir, on_frame)


def build_parser():
    p = argparse.ArgumentParser(description="Streaming TI2TI demo")
    p.add_argument("--variant", default="a", choices=["a", "m"])
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--vae_ckpt", required=True)
    p.add_argument("--prompt", required=True)
    p.add_argument("--image_path", required=True)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--text_steps", type=int, default=64)
    p.add_argument("--text_gen_length", type=int, default=256)
    p.add_argument("--cfg_img", type=float, default=4.0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--text_temperature", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--painting_mode", default=None,
                   choices=[None, "inpainting", "outpainting"])
    p.add_argument("--mask_h_ratio", type=float, default=0.5)
    p.add_argument("--mask_w_ratio", type=float, default=0.5)
    p.add_argument("--output_dir", default="demo_frames")
    p.add_argument("--serve", action="store_true",
                   help="launch a gradio UI if gradio is installed")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cpu for the tests)")
    return p


def main(argv=None):
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    from mmada_parallel_torch.utils.image import preprocess_image

    args = build_parser().parse_args(argv)

    def show(s, t, i, r):
        print(f"step {s}: {r['image_masked_pct']}% masked | {t[:80]}")

    if args.variant == "m":
        if args.serve:
            print("[warn] --serve is not wired for --variant m yet; "
                  "dumping frames instead")
        from PIL import Image
        from mmada_parallel_torch.cli.infer_m import load_pipeline as load_m
        from mmada_parallel_torch.samplers.interleave import InterleaveOptions
        pipe = load_m(args.checkpoint, args.vae_ckpt, args.device)
        m_opts = InterleaveOptions(
            text_steps=args.text_steps,
            image_steps=max(int(args.text_steps * 0.3), 1),
            text_temperature=args.text_temperature,
            image_temperature=args.temperature, image_cfg=args.cfg_img)
        img = Image.open(args.image_path).convert("RGB")
        run_stream_m(pipe, args.prompt, img, m_opts, args.seed,
                     args.output_dir, on_frame=show)
        print(f"[done] frames in {args.output_dir}")
        return

    from mmada_parallel_torch.cli.infer_a import load_pipeline
    pipe = load_pipeline(args.checkpoint, args.vae_ckpt, args.device)
    opts = TI2TIOptions(text_steps=args.text_steps,
                        timesteps=max(int(args.text_steps * 0.3), 1),
                        temperature=args.temperature,
                        text_temperature=args.text_temperature,
                        cfg_scale=0.0, cfg_img=args.cfg_img)
    img = preprocess_image(args.image_path)

    if args.serve:
        try:
            import gradio  # noqa: F401
        except ImportError:
            print("[warn] gradio not installed; falling back to frame dump")
            args.serve = False
    if not args.serve:
        run_stream(pipe, args.prompt, img, args.height, args.width, opts,
                   args.text_gen_length, args.seed, args.output_dir,
                   painting_mode=args.painting_mode,
                   mask_h_ratio=args.mask_h_ratio,
                   mask_w_ratio=args.mask_w_ratio, on_frame=show)
        print(f"[done] frames in {args.output_dir}")
        return

    build_demo_blocks(pipe, args.output_dir).launch()


def knobs_to_options(text_steps, cfg_scale, cfg_img, temperature,
                     text_temperature, remasking, painting_mode,
                     mask_h_ratio, mask_w_ratio):
    """Map the UI knob values to ``(TI2TIOptions, painting kwargs)``: the
    reference panel's knobs, less its "Block Length" slider, which the
    reference never passes to the sampler."""
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    opts = TI2TIOptions(
        text_steps=int(text_steps),
        timesteps=max(int(int(text_steps) * 0.3), 1),
        temperature=float(temperature),
        text_temperature=float(text_temperature),
        cfg_scale=float(cfg_scale), cfg_img=float(cfg_img),
        remasking=str(remasking))
    paint = dict(painting_mode=painting_mode or None,
                 mask_h_ratio=float(mask_h_ratio),
                 mask_w_ratio=float(mask_w_ratio))
    return opts, paint


def build_demo_blocks(pipe, output_dir: str):
    """The full-panel streaming UI: every functional knob of the reference
    panel; a worker thread feeds the sampler's frames through a queue and
    the handler yields them one by one."""
    import queue
    import threading
    import gradio as gr
    from mmada_parallel_torch.utils.image import preprocess_image

    def generate_wrapper(image, prompt, height, width, text_steps,
                         text_gen_length, cfg_scale, cfg_img, temperature,
                         text_temperature, remasking, painting_mode,
                         mask_h_ratio, mask_w_ratio, seed):
        if image is None:
            yield "*No input image*", None, "✗ No input image"
            return
        opts, paint = knobs_to_options(
            text_steps, cfg_scale, cfg_img, temperature, text_temperature,
            remasking, painting_mode, mask_h_ratio, mask_w_ratio)
        img = preprocess_image(image)
        q = queue.Queue()

        def work():
            try:
                run_stream(pipe, prompt, img, int(height), int(width), opts,
                           int(text_gen_length), int(seed), output_dir,
                           on_frame=lambda s, t, p, r: q.put((t, p, r)),
                           **paint)
                q.put(None)
            except Exception as e:  # surfaced as the UI status
                q.put(e)

        threading.Thread(target=work, daemon=True).start()
        text, preview = "", None
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                yield "*error*", None, f"✗ Error: {item}"
                return
            text, preview, rec = item
            yield (text.replace("\n", "\n\n"), preview,
                   f"step {rec['step']} | image "
                   f"{rec['image_masked_pct']}% masked")
        yield text.replace("\n", "\n\n"), preview, "✓ Done"

    with gr.Blocks(title="MMaDA-Parallel demo") as demo:
        gr.Markdown("# MMaDA-Parallel: Text+Image → Text+Image\n"
                    "Streaming parallel generation with step-by-step "
                    "visualization.")
        with gr.Row():
            with gr.Column(scale=1):
                input_image = gr.Image(type="pil", label="Input Image")
                prompt_text = gr.Textbox(
                    label="Editing Instruction", lines=3,
                    placeholder="Enter your editing instruction...")
                with gr.Accordion("Parameters", open=False):
                    with gr.Row():
                        height = gr.Slider(256, 768, value=512, step=64,
                                           label="Height")
                        width = gr.Slider(256, 768, value=512, step=64,
                                          label="Width")
                    text_steps = gr.Slider(32, 512, value=128, step=32,
                                           label="Steps")
                    text_gen_length = gr.Slider(64, 512, value=256, step=32,
                                                label="Text Length")
                    with gr.Row():
                        cfg_scale = gr.Slider(0, 5, value=0.0, step=0.5,
                                              label="Text CFG")
                        cfg_img = gr.Slider(0, 8, value=4.0, step=0.5,
                                            label="Image CFG")
                    with gr.Row():
                        temperature = gr.Slider(0, 2, value=1.0, step=0.1,
                                                label="Image Temp")
                        text_temperature = gr.Slider(0, 2, value=0.7,
                                                     step=0.1,
                                                     label="Text Temp")
                    remasking = gr.Dropdown(
                        choices=["low_confidence", "random"],
                        value="low_confidence", label="Remasking")
                    seed = gr.Slider(0, 10000, value=0, step=1,
                                     label="Seed (0=random)")
                with gr.Accordion("Painting Mode", open=False):
                    painting_mode = gr.Dropdown(
                        choices=[None, "inpainting", "outpainting"],
                        value=None, label="Mode")
                    with gr.Row():
                        mask_h_ratio = gr.Slider(0.1, 1.0, value=0.5,
                                                 step=0.1, label="Mask H")
                        mask_w_ratio = gr.Slider(0.1, 1.0, value=0.5,
                                                 step=0.1, label="Mask W")
                generate_btn = gr.Button("Generate", variant="primary")
            with gr.Column(scale=2):
                status_text = gr.Textbox(label="Status", lines=2,
                                         interactive=False)
                with gr.Row():
                    output_text = gr.Markdown(
                        value="*Waiting...*",
                        label="Generated Text (▓ = masked)")
                    output_image = gr.Image(label="Generated Image",
                                            type="pil", interactive=False)
        generate_btn.click(
            fn=generate_wrapper,
            inputs=[input_image, prompt_text, height, width, text_steps,
                    text_gen_length, cfg_scale, cfg_img, temperature,
                    text_temperature, remasking, painting_mode,
                    mask_h_ratio, mask_w_ratio, seed],
            outputs=[output_text, output_image, status_text])
    return demo


if __name__ == "__main__":
    main()
