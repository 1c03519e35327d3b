"""Serving CLI on PyTorch/CUDA: an HTTP front end over the continuous
batchers of :mod:`mmada_parallel_torch.serving`, both variants.

Counterpart of :mod:`mmada_parallel_tpu.cli.serve`, with the same flags and
endpoints, plus ``--device`` (default ``cuda``; a missing card raises, the
server does not move to the CPU).  Stdlib HTTP; the tokenizer comes through
a lazy ``transformers`` import, PIL only for ``image_b64`` requests.

    # variant A (TI2TI edits)
    python -m mmada_parallel_torch.cli.serve --checkpoint /ckpts/A \
        --port 8000 --batch_size 4 --warmup 128,256

    POST /edit {"prompt": "...", "image_tokens": [...]}  (tokens optional)
    POST /edit {"prompt_ids": [...]}
    POST /edit {"prompt"|"prompt_ids": ..., "image_b64": "..."}
        (needs --vq_checkpoint: Amused-VQ encode into the boi/grid/eoi span)
        -> {"text": ..., "codes": [...]}

    # variant M (interleave, text-to-image, understanding)
    python -m mmada_parallel_torch.cli.serve --variant m --checkpoint ...

    POST /interleave {"instruction"|"instr_ids": ...,
                      "image_tokens": [...] | "image_b64": "..."}
        -> {"text": ..., "codes": [...]}   (image_tokens: raw MagViT codes)
    POST /t2i {"prompt"|"text_ids": ...} -> {"codes": [...]}
    POST /mmu {"prompt_ids": [...]} | {"question": "...",
                                       "image_tokens": [...]} -> {"text": ...}
    GET  /stats -> {"requests": N, "batches": M, "batched_rows": K}

``--use_cache ratio,interval,warmup[,img]`` serves variant m through the
feature-cached sampler.  ``--quant int8|int8_bf16head`` serves W8A8 params
(``ops/quant.py``; ``int8_bf16head`` keeps the vocab head dense).

``--tp_ring N`` serves variant a tensor-parallel over an N-rank ring
(``parallel/tp_overlap.py``; ``--tp_ring_int8`` sends its all-gather
halves as int8), one process a rank:

    torchrun --nproc_per_node N -m mmada_parallel_torch.cli.serve \
        --tp_ring N --checkpoint /ckpts/A --port 8000

With ``--device cuda`` each rank takes the card of its local rank and the
ranks talk over NCCL; ``--device cpu`` puts them on gloo.  Rank 0 serves
HTTP; the other ranks follow its batches.
"""

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--variant", type=str, default="a", choices=["a", "m"])
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_wait_ms", type=float, default=50.0)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--text_gen_length", type=int, default=256)
    p.add_argument("--timesteps", type=int, default=64)
    p.add_argument("--text_steps", type=int, default=128)
    p.add_argument("--cfg_scale", type=float, default=0.0)
    p.add_argument("--cfg_img", type=float, default=4.0)
    # variant m knobs (the reference M inference defaults)
    p.add_argument("--num_vq_tokens", type=int, default=1024)
    p.add_argument("--max_seq_length", type=int, default=256)
    p.add_argument("--image_steps", type=int, default=30)
    p.add_argument("--text_cfg", type=float, default=2.5)
    p.add_argument("--image_cfg", type=float, default=4.0)
    p.add_argument("--warmup", type=str, default="",
                   help="comma-separated prompt lengths to run once before "
                        "serving")
    p.add_argument("--quant", type=str, default="",
                   choices=["", "int8", "int8_bf16head"],
                   help="W8A8-quantize the params (int8_bf16head: keep "
                        "the vocab head dense)")
    p.add_argument("--tiny_model", action="store_true",
                   help="debug: random tiny model instead of a checkpoint")
    p.add_argument("--vq_checkpoint", type=str, default=None,
                   help="VQ checkpoint dir ('tiny' for a random tiny one): "
                        "enables raw image submission (image_b64)")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--max_prompt_len", type=int, default=0,
                   help="0 = auto (1024, + the image span when "
                        "--vq_checkpoint enables server-side encoding)")
    p.add_argument("--t2i_guidance", type=float, default=3.5)
    p.add_argument("--mmu_max_new_tokens", type=int, default=128)
    p.add_argument("--mmu_block_length", type=int, default=128)
    p.add_argument("--use_cache", type=str, default="",
                   help="variant m: serve through the cached sampler, "
                        "'ratio,interval,warmup[,img]' e.g. 0.95,4,0.25,1 "
                        "(opt-in approximation; exact-length grouping)")
    p.add_argument("--tp_ring", type=int, default=0,
                   help="serve variant a tensor-parallel over a ring of N "
                        "ranks (launch N processes with torchrun)")
    p.add_argument("--tp_ring_int8", action="store_true",
                   help="with --tp_ring: per-token int8 all-gather payloads "
                        "(opt-in approximation)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on (cpu for the tests)")
    return p


def _load_llada(args, T):
    """``(cfg, params, tokenizer)`` on ``args.device``: the tiny random
    model, or a checkpoint in bf16 with its tokenizer."""
    import dataclasses

    import torch
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    if args.tiny_model:
        cfg = LLaDAConfig.tiny(vocab_size=T.full_vocab_size,
                               mask_token_id=T.mask)
        params = init_llada_params(
            cfg, torch.Generator(device=args.device).manual_seed(0))
        return cfg, params, None
    from transformers import AutoTokenizer
    from mmada_parallel_torch.models import convert as CV
    tokenizer = AutoTokenizer.from_pretrained(args.checkpoint,
                                              trust_remote_code=True)
    cfg, params = CV.load_llada_checkpoint(args.checkpoint,
                                           dtype=torch.bfloat16)
    cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    params = {k: ({n: t.to(args.device) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(args.device))
              for k, v in params.items()}
    return cfg, params, tokenizer


def _check_ring_flags(args) -> None:
    """The JAX CLI's refusals of ``--tp_ring`` / ``--tp_ring_int8``."""
    if args.tp_ring_int8 and not args.tp_ring:
        raise SystemExit("--tp_ring_int8 requires --tp_ring N")
    if args.tp_ring:
        if args.quant:
            raise SystemExit("--tp_ring serves the dense bf16 path; "
                             "combine with --quant is not supported")
        if args.variant != "a":
            raise SystemExit("--tp_ring currently serves variant a "
                             "(the M reference layout length 2341 does not "
                             "divide the TP degree)")
        if args.tp_ring < 2:
            raise SystemExit("--tp_ring needs N >= 2 (the ring protocols "
                             "have no single-chip form)")


def _ring_mesh(args):
    """Join the launcher's job as one rank of the ``--tp_ring`` ring and
    return the ``(data=1, fsdp=1, tensor=N)`` mesh; on CUDA the rank takes
    the card of its local rank (``args.device`` is set to it) and NCCL."""
    import torch
    import torch.distributed as dist
    from mmada_parallel_torch.parallel import (MeshConfig, init_distributed,
                                               make_mesh)
    n = args.tp_ring
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        if torch.cuda.device_count() < n:
            raise SystemExit(
                f"--tp_ring {n} --device cuda needs {n} cards, one a rank "
                f"(NCCL); {torch.cuda.device_count()} visible")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        args.device = f"cuda:{local}"
    init_distributed(backend="nccl" if cuda else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise SystemExit(f"--tp_ring {n} needs {n} ranks (torchrun "
                         f"--nproc_per_node {n}); the world has {world}")
    return make_mesh(MeshConfig(data=1, fsdp=1, tensor=n),
                     "cuda" if cuda else "cpu")


def _a_encoder(args, cfg, params, tokenizer, T):
    """``PIL image -> [boi] grid-with-newlines [eoi]`` through Amused-VQ
    (the pipeline's encode: f32, TF32 off).  Serving resizes to the fixed
    ``--width`` x ``--height``, one encoder shape for every request."""
    import torch
    from mmada_parallel_torch.models import amused_vq as AVQ
    from mmada_parallel_torch.models import convert as CV
    from mmada_parallel_torch.pipeline import TI2TIPipeline
    if args.vq_checkpoint == "tiny":
        vq_cfg = AVQ.AmusedVQConfig.tiny()
        vq_params = AVQ.init_amused_vq_params(
            vq_cfg, torch.Generator(device=args.device).manual_seed(1))
    else:
        cfg_path = os.path.join(args.vq_checkpoint, "config.json")
        vq_cfg = AVQ.AmusedVQConfig()
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                vq_cfg = CV.amused_config_from_hf(json.load(f))
        vq_params = CV.amused_params_from_torch(
            CV.load_safetensors_dir(args.vq_checkpoint, args.device), vq_cfg)
    pipe = TI2TIPipeline(cfg, params, vq_cfg, vq_params, tokenizer, T)
    return lambda img: pipe.encode_img_with_breaks(
        img.resize((args.width, args.height)))


def _m_encoder(args, cfg, params, tokenizer, T):
    """Pixels ``[B, R, R, 3]`` in [-1, 1] -> MagViT codes ``[B, N]``
    (the pipeline's encode: f32, TF32 off)."""
    import torch
    from mmada_parallel_torch.models import convert as CV
    from mmada_parallel_torch.models import magvit2 as MVQ
    from mmada_parallel_torch.pipeline import InterleavePipeline
    if args.vq_checkpoint == "tiny":
        vq_cfg = MVQ.MagvitConfig.tiny()
        vq_params = MVQ.init_magvit_params(
            vq_cfg, torch.Generator(device=args.device).manual_seed(1))
    else:
        vq_cfg = MVQ.MagvitConfig()
        vq_params = CV.magvit_params_from_torch(
            CV.load_safetensors_dir(args.vq_checkpoint, args.device), vq_cfg)
    return InterleavePipeline(cfg, params, vq_cfg, vq_params, tokenizer, T,
                              resolution=args.resolution).get_code


def _main(argv=None):
    import numpy as np
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from mmada_parallel_torch import tokens as tk
    from mmada_parallel_torch.samplers.interleave import InterleaveOptions
    from mmada_parallel_torch.samplers.mmu import MMUOptions
    from mmada_parallel_torch.samplers.parallel_ti2ti import TI2TIOptions
    from mmada_parallel_torch.samplers.t2i import T2IOptions
    from mmada_parallel_torch.serving import (InterleaveServer, MMUServer,
                                              ServeConfig, T2IServer,
                                              TI2TIServer)

    args = build_parser().parse_args(argv)
    _check_ring_flags(args)
    if args.checkpoint is None and not args.tiny_model:
        raise SystemExit(
            "--checkpoint is required (or pass --tiny_model explicitly for "
            "a random-weight debug server)")
    mesh = _ring_mesh(args) if args.tp_ring else None
    T = tk.TOKENS_A if args.variant == "a" else tk.TOKENS_M
    cfg, params, tokenizer = _load_llada(args, T)
    if args.quant:
        from mmada_parallel_torch.ops.quant import quantize_llada_params
        params = quantize_llada_params(
            params, quantize_head="bf16head" not in args.quant)
    hidden_fn = None
    if mesh is not None:
        from mmada_parallel_torch.models.llada import param_shardings
        from mmada_parallel_torch.parallel import shard_params
        from mmada_parallel_torch.parallel.tp_overlap import ring_hidden_fn
        params = shard_params(params, param_shardings(cfg), mesh)
        hidden_fn = ring_hidden_fn(mesh, int8_payload=args.tp_ring_int8)

    a_encode = None
    t2i_server = mmu_server = None
    if args.variant == "a":
        if args.vq_checkpoint:
            a_encode = _a_encoder(args, cfg, params, tokenizer, T)
        _, _, gh, gw = tk.calculate_vq_params(args.height, args.width, 16)
        opts = TI2TIOptions(timesteps=args.timesteps,
                            text_steps=args.text_steps,
                            cfg_scale=args.cfg_scale, cfg_img=args.cfg_img,
                            text_vocab_size=T.text_vocab_size,
                            codebook_size=T.codebook_size, mask_token=T.mask)
        end_ids = (list(tokenizer("</answer>",
                                  add_special_tokens=False)["input_ids"])
                   if tokenizer is not None else [T.answer_end])
        server = TI2TIServer(
            params, cfg, opts,
            ServeConfig(grid_hw=(gh, gw),
                        text_gen_length=args.text_gen_length,
                        end_token_ids=tuple(end_ids),
                        batch_size=args.batch_size,
                        max_wait_ms=args.max_wait_ms,
                        # auto: room for a server-encoded image span
                        max_prompt_len=(args.max_prompt_len
                                        or 1024 + (gh * (gw + 1) + 2
                                                   if a_encode else 0))),
            tokenizer=tokenizer, tokens=T, hidden_fn=hidden_fn)
    else:
        m_opts = InterleaveOptions(
            text_steps=args.text_steps, image_steps=args.image_steps,
            text_cfg=args.text_cfg, image_cfg=args.image_cfg,
            text_vocab_size=T.text_vocab_size,
            codebook_size=T.codebook_size, mask_token=T.mask)
        get_code = (_m_encoder(args, cfg, params, tokenizer, T)
                    if args.vq_checkpoint else None)
        cache_kw = None
        if args.use_cache:
            parts = args.use_cache.split(",")
            cache_kw = {"cache_ratio": float(parts[0]),
                        "refresh_interval": int(parts[1]),
                        "warmup_ratio": float(parts[2]),
                        "refresh_on_image_steps": (bool(int(parts[3]))
                                                   if len(parts) > 3
                                                   else True)}
        server = InterleaveServer(
            params, cfg, m_opts, num_vq_tokens=args.num_vq_tokens,
            max_seq_length=args.max_seq_length,
            batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
            tokenizer=tokenizer, get_code=get_code, tokens=T,
            use_cache=bool(args.use_cache), cache_kw=cache_kw)
        # sibling endpoints over the same params: /t2i and /mmu
        t2i_server = T2IServer(
            params, cfg,
            T2IOptions(guidance_scale=args.t2i_guidance,
                       text_vocab_size=T.text_vocab_size,
                       codebook_size=T.codebook_size, mask_token=T.mask),
            num_vq_tokens=args.num_vq_tokens, batch_size=args.batch_size,
            max_wait_ms=args.max_wait_ms, tokenizer=tokenizer, tokens=T)
        mmu_server = MMUServer(
            params, cfg,
            MMUOptions(max_new_tokens=args.mmu_max_new_tokens,
                       steps=args.mmu_max_new_tokens,
                       block_length=args.mmu_block_length,
                       mask_token=T.mask),
            batch_size=args.batch_size, max_wait_ms=args.max_wait_ms,
            tokenizer=tokenizer, tokens=T)
    servers = [s for s in (server, t2i_server, mmu_server) if s is not None]

    if args.warmup:
        lens = [int(x) for x in args.warmup.split(",") if x]
        print(f"[serve] warming up buckets for prompt lens {lens} ...",
              flush=True)
        for s in servers:
            s.warmup(lens)
    if mesh is not None and mesh.get_rank() != 0:
        print(f"[serve] rank {mesh.get_rank()} of the --tp_ring "
              f"{args.tp_ring} ring follows rank 0", flush=True)
        server.close()                      # returns when rank 0 closes
        return

    def need_tokenizer(field):
        return {"error": f"no tokenizer loaded; send {field}"}

    def image_from_b64(data):
        import base64
        import io
        from PIL import Image
        return Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")

    def answer(out):
        return {"text": out["text"] if isinstance(out["text"], str)
                else [int(t) for t in out["text_ids"]],
                "codes": [int(c) for c in out["codes"]]}

    def edit(req):
        if "prompt_ids" in req:
            pids = [int(t) for t in req["prompt_ids"]]
        elif tokenizer is None:
            return 400, need_tokenizer("prompt_ids")
        else:
            pids = list(tokenizer(req["prompt"])["input_ids"])
        if req.get("image_b64"):
            if a_encode is None:
                return 400, {"error": "image_b64 needs --vq_checkpoint"}
            pids = (pids[:-1] + a_encode(image_from_b64(req["image_b64"]))
                    + pids[-1:])
        elif req.get("image_tokens"):
            pids = (pids[:-1] + [T.boi]
                    + [int(t) for t in req["image_tokens"]]
                    + [T.eoi] + pids[-1:])
        return 200, answer(server.submit(pids))

    def interleave(req):
        if "instr_ids" in req:
            iids = [int(t) for t in req["instr_ids"]]
        elif tokenizer is None:
            return 400, need_tokenizer("instr_ids")
        else:
            iids = list(tokenizer(req["instruction"])["input_ids"])
        if req.get("image_b64"):
            if server.get_code is None:
                return 400, {"error": "image_b64 needs --vq_checkpoint"}
            from mmada_parallel_torch.utils.image import (
                image_transform_squash)
            px = np.asarray(image_transform_squash(
                image_from_b64(req["image_b64"]), args.resolution))[0]
            return 200, answer(server.submit(iids, image=px))
        codes = np.asarray(req["image_tokens"], np.int64) + T.vq_offset
        return 200, answer(server.submit(iids, codes=codes))

    def t2i(req):
        tids = req.get("text_ids")
        if tids is None:
            if tokenizer is None:
                return 400, need_tokenizer("text_ids")
            tids = tokenizer(req["prompt"])["input_ids"]
        out = t2i_server.submit([int(t) for t in tids])
        return 200, {"codes": [int(c) for c in out["codes"]]}

    def mmu(req):
        if "prompt_ids" in req:
            pids = [int(t) for t in req["prompt_ids"]]
        elif tokenizer is None:
            return 400, need_tokenizer("prompt_ids")
        else:
            q = tk.normalize_text_ids(
                tokenizer(req["question"])["input_ids"],
                getattr(tokenizer, "bos_token_id", T.bos),
                getattr(tokenizer, "eos_token_id", T.eos),
                append_eos_always=False)
            pids = ([T.mmu, T.soi]
                    + [int(t) + T.vq_offset for t in req["image_tokens"]]
                    + [T.eoi] + q)
        out = mmu_server.submit(pids)
        return 200, {"text": out["text"] if isinstance(out["text"], str)
                     else [int(t) for t in out["text_ids"]]}

    routes = ({"/edit": edit} if args.variant == "a" else
              {"/interleave": interleave, "/t2i": t2i, "/mmu": mmu})

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/stats":
                return self._json(200, server.stats())
            return self._json(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                route = routes.get(self.path)
                if route is None:
                    return self._json(404, {
                        "error": f"unknown path for variant {args.variant!r}"})
                self._json(*route(req))
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    httpd = ThreadingHTTPServer((args.host, args.port), Handler)
    print(f"[serve] listening on {args.host}:{httpd.server_address[1]} "
          f"(batch_size={args.batch_size}, max_wait_ms={args.max_wait_ms}, "
          f"device={args.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        for s in servers:
            s.close()



def main(argv=None):
    """The CLI; a rank that formed its process group here (torchrun) leaves
    it on the way out, also when the run raises
    (``parallel.mesh.leaves_process_group``)."""
    from mmada_parallel_torch.parallel.mesh import leaves_process_group
    with leaves_process_group():
        return _main(argv)


if __name__ == "__main__":
    main()
