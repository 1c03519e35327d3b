"""Batched-evaluation CLI over the sweep harness (``evaluation.py``) on
PyTorch/CUDA.

Counterpart of :mod:`mmada_parallel_tpu.cli.eval_sweep`, with the same flags
plus ``--device`` (default ``cuda``; a missing card raises, the sweep does
not move to the CPU): run any of the four batched sweeps on a checkpoint
from a JSONL request file (or a local ParaBench copy) and write aggregated
metrics.

    python -m mmada_parallel_torch.cli.eval_sweep --task edit \
        --checkpoint /ckpts/mmada-a --requests reqs.jsonl \
        --out metrics.json --grid 16,16 --text_gen_length 256

Request JSONL lines by ``--task`` (``meta`` is optional everywhere and
feeds the default scorer: ``input_codes`` / ``target_codes`` /
``keywords`` / ``edit_mask``):

    edit        {"prompt_ids": [...], "meta": {...}}
    interleave  {"instr_ids": [...], "codes": [...], "meta": {...}}
                (codes = RAW VQ codes without the vocab offset)
    t2i         {"text_ids": [...]} or {"text": "..."}  (needs tokenizer)
    mmu         {"prompt_ids": [...], "meta": {...}}

Output JSON: ``{"task", "quant", "num_requests", "aggregate", <rate-key>,
"total_time_s", "per_request": [...]}``.  ``--quant int8|int8_bf16head``
runs the sweep on W8A8 params (``ops/quant.py``).  ``--vq_checkpoint``
adds decoded-pixel PSNR/SSIM axes through the port's Amused-VQ (edit) or
MagViT-v2 (the M tasks), run in f32 with cuDNN's TF32 off
(``vq_precision``).  ``transformers`` (the tokenizer) is imported only with
``--checkpoint``.
"""

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--task", required=True,
                   choices=["edit", "interleave", "t2i", "mmu"])
    p.add_argument("--requests", default=None,
                   help="JSONL file, one request per line (see module doc)")
    p.add_argument("--parabench", default=None,
                   help="path to a local copy of the published ParaBench "
                        "dataset (HF save_to_disk dir, parquet snapshot, "
                        "or jsonl export) — rows are adapted into "
                        "requests via data/parabench.py; image rows need "
                        "--vq_checkpoint to encode inputs")
    p.add_argument("--pb_fields", default="",
                   help="override the ParaBench column auto-detection: "
                        "comma list of role=column "
                        "(roles: instruction,image,type,id,target_text,"
                        "target_image), e.g. "
                        "'instruction=edit_prompt,image=src_img'")
    p.add_argument("--out", default=None, help="metrics JSON path (default: "
                   "stdout only)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--tiny_model", action="store_true",
                   help="debug: random tiny model instead of a checkpoint")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_scores", action="store_true")
    p.add_argument("--quant", type=str, default="",
                   choices=["", "int8", "int8_bf16head"],
                   help="W8A8-quantize the params before the sweep")
    p.add_argument("--vq_checkpoint", type=str, default=None,
                   help="VQ tokenizer dir — adds decoded-pixel PSNR/SSIM "
                        "axes: Amused-VQ layout (vqvae/ subfolder) for "
                        "--task edit, MagViT-v2 dir for the M tasks")
    # task=edit (variant A) knobs — defaults mirror cli/infer_a
    p.add_argument("--grid", type=str, default="16,16",
                   help="edit: image grid 'h,w' in VQ tokens")
    p.add_argument("--text_gen_length", type=int, default=256)
    p.add_argument("--end_token_ids", type=str, default="",
                   help="edit: comma ids appended after the answer span "
                        "(default: tokenizer('</answer>'))")
    p.add_argument("--timesteps", type=int, default=64)
    p.add_argument("--text_steps", type=int, default=128)
    p.add_argument("--cfg_scale", type=float, default=0.0)
    p.add_argument("--cfg_img", type=float, default=0.0,
                   help="edit: image CFG scale; needs --uncond_image_ids "
                        "(the sweep shares ONE uncond prefix)")
    p.add_argument("--uncond_image_ids", type=str, default="",
                   help="edit: comma token ids of the image-CFG uncond "
                        "prefix (the prompt without the input image)")
    # variant M knobs (the reference M inference defaults)
    p.add_argument("--num_vq_tokens", type=int, default=1024)
    p.add_argument("--max_seq_length", type=int, default=256)
    p.add_argument("--m_text_steps", type=int, default=128,
                   help="interleave: text denoise steps")
    p.add_argument("--image_steps", type=int, default=30)
    p.add_argument("--text_cfg", type=float, default=2.5)
    p.add_argument("--image_cfg", type=float, default=4.0)
    p.add_argument("--t2i_guidance", type=float, default=3.5)
    p.add_argument("--t2i_timesteps", type=int, default=18)
    p.add_argument("--mmu_max_new_tokens", type=int, default=128)
    p.add_argument("--mmu_block_length", type=int, default=128)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cpu for the tests)")
    return p


def _load_requests(path):
    reqs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                reqs.append(json.loads(line))
    if not reqs:
        raise SystemExit(f"no requests in {path}")
    return reqs


def _amused(vq_checkpoint: str, device: str):
    """``(cfg, params)`` of the Amused-VQ in ``vq_checkpoint`` (its
    ``vqvae/`` subfolder when there is one)."""
    from mmada_parallel_torch.models import convert as CV
    vq_dir = os.path.join(vq_checkpoint, "vqvae")
    if not os.path.isdir(vq_dir):
        vq_dir = vq_checkpoint
    with open(os.path.join(vq_dir, "config.json")) as f:
        vq_cfg = CV.amused_config_from_hf(json.load(f))
    return vq_cfg, CV.amused_params_from_torch(
        CV.load_safetensors_dir(vq_dir, device), vq_cfg)


def _magvit(vq_checkpoint: str, device: str):
    """``(cfg, params)`` of the MagViT-v2 in ``vq_checkpoint``; a
    ``config.json`` there sets the architecture."""
    import dataclasses

    from mmada_parallel_torch.models import convert as CV
    from mmada_parallel_torch.models import magvit2 as MVQ
    vq_cfg = MVQ.MagvitConfig()
    cfg_path = os.path.join(vq_checkpoint, "config.json")
    if os.path.exists(cfg_path):
        names = {f.name for f in dataclasses.fields(MVQ.MagvitConfig)}
        with open(cfg_path) as f:
            fields = {k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in json.load(f).items() if k in names}
        vq_cfg = MVQ.MagvitConfig(**fields)
    return vq_cfg, CV.magvit_params_from_torch(
        CV.load_safetensors_dir(vq_checkpoint, device), vq_cfg)


def _vq_decode_fn(vq_checkpoint: str, task: str, grid_hw, device: str):
    """``decode_fn(codes_flat) -> float image [H, W, 3] in [0, 1]`` for
    :func:`eval_scorers.pixel_edit_scorer`: Amused-VQ for ``task=edit``,
    MagViT-v2 (its [-1, 1] output rescaled) for the M tasks."""
    if task == "edit":
        vq_cfg, vq_params = _amused(vq_checkpoint, device)
        return amused_decoder(vq_cfg, vq_params, grid_hw)
    vq_cfg, vq_params = _magvit(vq_checkpoint, device)
    return magvit_decoder(vq_cfg, vq_params)


def amused_decoder(vq_cfg, vq_params, grid_hw):
    """Codes ``[N]`` -> Amused-VQ pixels ``[H, W, 3]`` in [0, 1] (numpy),
    decoded in f32 with cuDNN's TF32 off."""
    import numpy as np
    import torch

    from mmada_parallel_torch.models import amused_vq as AVQ
    from mmada_parallel_torch.models.vqgan_common import vq_precision
    device = vq_params["quant"]["embedding"].device

    @torch.inference_mode()
    @vq_precision()
    def decode(codes):
        c = torch.as_tensor(np.asarray(codes), device=device).reshape(1, -1)
        return AVQ.amused_decode_code(vq_params, vq_cfg, c, grid_hw)[
            0].float().cpu().numpy()
    return decode


def magvit_decoder(vq_cfg, vq_params):
    """Codes ``[N]`` -> MagViT-v2 pixels ``[H, W, 3]`` in [0, 1] (numpy),
    decoded in f32 with cuDNN's TF32 off."""
    import numpy as np
    import torch

    from mmada_parallel_torch.models import magvit2 as MVQ
    from mmada_parallel_torch.models.vqgan_common import vq_precision
    device = vq_params["decoder"]["conv_in"]["w"].device

    @torch.inference_mode()
    @vq_precision()
    def decode(codes):
        c = torch.as_tensor(np.asarray(codes), device=device).reshape(1, -1)
        px = MVQ.magvit_decode_code(vq_params, vq_cfg, c)[0].float()
        return ((px + 1.0) / 2.0).clamp(0.0, 1.0).cpu().numpy()
    return decode


def _vq_encode_fn(vq_checkpoint: str, task: str, device: str):
    """Image-encoding callable for ``data/parabench.parabench_requests``:
    ``task=edit`` -> ``(span_ids, raw_codes)`` through Amused-VQ (the
    reference crop to 512x512 first); the M tasks -> raw MagViT codes of the
    squashed ``resolution`` x ``resolution`` image."""
    import numpy as np
    import torch

    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.models.vqgan_common import vq_precision
    from mmada_parallel_torch.utils import image as IM

    if task == "edit":
        from mmada_parallel_torch.models import amused_vq as AVQ
        vq_cfg, vq_params = _amused(vq_checkpoint, device)

        @torch.inference_mode()
        @vq_precision()
        def enc(px):
            x = torch.as_tensor(px, dtype=torch.float32, device=device)
            lat = AVQ.amused_encode(vq_params, vq_cfg, x)
            return AVQ.amused_quantize(vq_params, vq_cfg,
                                       lat)[1].cpu().numpy()

        def encode_edit(img):
            # preprocess unconditionally: off-grid sizes would break the
            # h*w span layout downstream
            px = IM.image_to_array(IM.preprocess_image(img), "zero_one")
            codes = enc(px)
            span = AVQ.amused_img_span(lambda _: codes, vq_cfg, px,
                                       tk.TOKENS_A)
            return span, codes[0]
        return encode_edit

    from mmada_parallel_torch.models import magvit2 as MVQ
    vq_cfg, vq_params = _magvit(vq_checkpoint, device)

    @torch.inference_mode()
    @vq_precision()
    def encode_m(img, resolution=512):
        px = torch.as_tensor(IM.image_transform_squash(img, resolution),
                             dtype=torch.float32, device=device)
        return np.asarray(MVQ.magvit_get_code(vq_params, vq_cfg,
                                              px).cpu())[0]
    return encode_m


def _jsonable(x):
    import numpy as np
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return x


def main(argv=None):
    import numpy as np

    from mmada_parallel_torch import evaluation as EV
    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.cli.serve import _load_llada
    from mmada_parallel_torch.eval_scorers import (aggregate_scores,
                                                   default_edit_scorer)

    args = build_parser().parse_args(argv)
    if args.checkpoint is None and not args.tiny_model:
        raise SystemExit("--checkpoint is required (or pass --tiny_model "
                         "explicitly for a random-weight debug sweep)")
    # cheap argument contradictions fail before the checkpoint load
    if bool(args.requests) == bool(args.parabench):
        raise SystemExit("pass exactly one of --requests / --parabench")
    if args.parabench and (args.tiny_model or args.checkpoint is None):
        raise SystemExit("--parabench needs --checkpoint (tokenizer); "
                         "for offline tests drive "
                         "data/parabench.parabench_requests directly")
    T = tk.TOKENS_A if args.task == "edit" else tk.TOKENS_M
    cfg, params, tokenizer = _load_llada(args, T)
    if args.quant:
        from mmada_parallel_torch.ops.quant import quantize_llada_params
        params = quantize_llada_params(
            params, quantize_head="bf16head" not in args.quant)

    if args.parabench:
        from mmada_parallel_torch.data.parabench import (load_parabench,
                                                         parabench_requests)
        rows = load_parabench(args.parabench)
        fm = dict(kv.split("=", 1) for kv in args.pb_fields.split(",")
                  if kv) or None
        enc = (_vq_encode_fn(args.vq_checkpoint, args.task, args.device)
               if args.vq_checkpoint else None)
        raw = parabench_requests(rows, args.task,
                                 lambda s: tokenizer(s)["input_ids"], enc,
                                 field_map=fm)
    else:
        raw = _load_requests(args.requests)
    scorer = None if args.no_scores else default_edit_scorer()
    if scorer is not None and args.vq_checkpoint:
        from mmada_parallel_torch.eval_scorers import pixel_edit_scorer
        gh, gw = (int(v) for v in args.grid.split(","))
        scorer = pixel_edit_scorer(
            _vq_decode_fn(args.vq_checkpoint, args.task, (gh, gw),
                          args.device), base=scorer)

    if args.task == "edit":
        from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
        gh, gw = (int(v) for v in args.grid.split(","))
        if args.end_token_ids:
            end_ids = [int(v) for v in args.end_token_ids.split(",")]
        elif tokenizer is not None:
            end_ids = tokenizer("</answer>",
                                add_special_tokens=False)["input_ids"]
        else:
            raise SystemExit("--end_token_ids is required with --tiny_model")
        # one SHARED image-CFG uncond prefix and no text CFG (per-request
        # prefixes are an infer_a/serve feature)
        uncond_img = (np.asarray([int(v) for v in
                                  args.uncond_image_ids.split(",")],
                                 np.int64)
                      if args.uncond_image_ids else None)
        if args.cfg_img > 0 and uncond_img is None:
            raise SystemExit("--cfg_img > 0 needs --uncond_image_ids "
                             "(the sweep-wide uncond prefix)")
        if args.cfg_scale > 0:
            raise SystemExit("text CFG is per-request and not supported "
                             "by the batched sweep; use cli/infer_a or "
                             "cli/serve for cfg_scale > 0")
        opts = TI2TIOptions(
            text_steps=args.text_steps, timesteps=args.timesteps,
            temperature=args.temperature, text_temperature=args.temperature,
            cfg_scale=args.cfg_scale, cfg_img=args.cfg_img,
            text_vocab_size=T.text_vocab_size, codebook_size=T.codebook_size,
            mask_token=T.mask)
        reqs = [EV.EvalRequest(prompt_ids=r["prompt_ids"],
                               meta=r.get("meta")) for r in raw]
        sweep = EV.run_parabench_sweep(
            params, cfg, reqs, grid_hw=(gh, gw),
            text_gen_length=args.text_gen_length, end_token_ids=end_ids,
            opts=opts, batch_size=args.batch_size, tokenizer=tokenizer,
            uncond_image_prefix=uncond_img,
            seed=args.seed, scorer=scorer, tokens=T)
        rate_key = "edits_per_min"
    elif args.task == "interleave":
        from mmada_parallel_torch.samplers.interleave import (
            InterleaveOptions)
        opts = InterleaveOptions(
            text_steps=args.m_text_steps, image_steps=args.image_steps,
            text_cfg=args.text_cfg, image_cfg=args.image_cfg,
            text_temperature=args.temperature,
            image_temperature=args.temperature,
            text_vocab_size=T.text_vocab_size, codebook_size=T.codebook_size,
            mask_token=T.mask)
        reqs = [EV.InterleaveEvalRequest(
            instr_ids=r["instr_ids"],
            codes=np.asarray(r["codes"]) + T.vq_offset
            if r.get("codes") is not None else None,
            meta=r.get("meta")) for r in raw]
        sweep = EV.run_interleave_sweep(
            params, cfg, reqs, num_vq_tokens=args.num_vq_tokens, opts=opts,
            max_seq_length=args.max_seq_length, batch_size=args.batch_size,
            tokenizer=tokenizer, scorer=scorer, tokens=T, seed=args.seed)
        rate_key = "gens_per_min"
    elif args.task == "t2i":
        from mmada_parallel_torch.samplers.t2i import T2IOptions
        opts = T2IOptions(
            timesteps=args.t2i_timesteps, temperature=args.temperature,
            guidance_scale=args.t2i_guidance,
            text_vocab_size=T.text_vocab_size, codebook_size=T.codebook_size,
            mask_token=T.mask)

        def text_ids(r):
            if r.get("text_ids") is not None:
                return r["text_ids"]
            if tokenizer is None:
                raise SystemExit('"text" requests need --checkpoint '
                                 "(tokenizer); pass text_ids with "
                                 "--tiny_model")
            return tokenizer(r["text"])["input_ids"]

        reqs = [EV.T2IEvalRequest(text_ids=text_ids(r), meta=r.get("meta"))
                for r in raw]
        sweep = EV.run_t2i_sweep(
            params, cfg, reqs, num_vq_tokens=args.num_vq_tokens, opts=opts,
            batch_size=args.batch_size, tokenizer=tokenizer, scorer=scorer,
            tokens=T, seed=args.seed)
        rate_key = "images_per_min"
    else:  # mmu
        from mmada_parallel_torch.samplers.mmu import MMUOptions
        opts = MMUOptions(
            max_new_tokens=args.mmu_max_new_tokens,
            steps=args.mmu_max_new_tokens,
            block_length=args.mmu_block_length,
            temperature=args.temperature, cfg_scale=args.cfg_scale,
            mask_token=T.mask)
        reqs = [EV.MMUEvalRequest(prompt_ids=r["prompt_ids"],
                                  meta=r.get("meta")) for r in raw]
        sweep = EV.run_mmu_sweep(
            params, cfg, reqs, opts=opts, batch_size=args.batch_size,
            tokenizer=tokenizer, scorer=scorer, tokens=T, seed=args.seed)
        rate_key = "answers_per_min"

    agg = aggregate_scores(sweep["results"]) if scorer else {}
    metrics = {
        "task": args.task,
        "quant": args.quant or None,
        "num_requests": sweep["num_requests"],
        "aggregate": {k: round(v, 4) for k, v in agg.items()},
        rate_key: round(sweep[rate_key], 2),
        "total_time_s": round(sweep["total_time_s"], 2),
        "per_request": [
            {k: _jsonable(v) for k, v in r.items() if k != "meta"}
            for r in sweep["results"]],
    }
    out = json.dumps(metrics, indent=2)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(out)
    print(out)
    return metrics


if __name__ == "__main__":
    main()
