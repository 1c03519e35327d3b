"""Variant-M interleave SFT trainer CLI on PyTorch/CUDA.

Mirrors ``MMaDA-Parallel-M/training/train_interleave.py:133-980``: tar-shard
(input image, instruction, output image, output text) stream, on-the-fly
MagViT-v2 tokenization, double-cosine noising, the tail-slice interleave
loss, checkpoints, periodic validation generation.

    python -m mmada_parallel_torch.cli.train_m config=configs/train_m.yaml \
        device=cuda

Counterpart of :mod:`mmada_parallel_tpu.cli.train_m`: the same ``DEFAULTS``,
command line (``config=`` plus dotted overrides), loop, logging,
checkpoints and validators, plus a ``device`` key (default ``cuda``; a
missing card raises).  One device: ``mesh.fsdp``, ``mesh.tensor`` and
``training.shard_strategy`` raise away from ``1``, ``1`` and ``"full"``.
The interleave noising draws from one ``torch.Generator`` on the device,
seeded from ``training.seed``.  The pieces :func:`main` wires together are
functions of their own, which ``chip_smoke.py`` and the tests call:
:func:`build_models`, :func:`make_loss_fn`, :func:`build_train_step`,
:func:`assemble_batch` and :func:`train_loop`.
"""

import dataclasses
import os
import sys
import time
from typing import Any

DEFAULTS = {
    "checkpoint": None,           # LLaDA init (None -> tiny debug model)
    "vq_checkpoint": None,        # MagViT-v2 weights (None -> random)
    "output_dir": "out_interleave",
    "shards": None,               # tar pattern with in/out image + texts
    "dataset": {"preprocessing": {"max_seq_length": 256, "resolution": 512},
                "params": {"mmu_validation_prompts_file": "",
                           "mmu_image_root": "",
                           "lm_chat_validation_jsonl": ""}},
    "model": {"mmada": {"num_vq_tokens": 1024, "codebook_size": 8192}},
    "training": {
        "lr": 1e-4, "weight_decay": 0.01, "max_grad_norm": 1.0,
        "batch_size": 1, "gradient_accumulation_steps": 1,
        "max_train_steps": 1000, "text_coeff": 1.0, "image_coeff": 1.0,
        "min_masking_rate": 1e-3, "cond_dropout_prob": 0.1,
        "warmup_steps": 100, "scheduler": "cosine",
        "save_every": 500, "log_every": 10, "seed": 0,
        "generate_every": 0,   # >0: periodic validation generation
        "validate_mmu_every": 0,   # >0: MMU understanding validation
        "validate_chat_every": 0,  # >0: chat text validation
    },
    "mesh": {"fsdp": 1, "tensor": 1},
    "tiny_debug": False,
    # tracker surface of train_interleave.py:179-201 — set a project name
    # to mirror scalars/validation images into wandb when it is installed;
    # TensorBoard/jsonl/PNG sinks are always on regardless
    "wandb": {"project": None, "run_name": None},
    "device": "cuda",             # torch device (cpu for the tests)
}


@dataclasses.dataclass
class Models:
    """The backbone and the image tokenizer of a run (:func:`build_models`);
    ``tokenizer`` is None for the tiny debug model."""
    mcfg: Any
    params: Any
    tokenizer: Any
    vq_cfg: Any
    vq_params: Any

    def get_code(self, px):
        """MagViT-v2 codes ``[B, N]`` (without the vocab offset) of pixels
        ``[B, R, R, 3]`` in [-1, 1], on the tokenizer's device, encoded in
        full f32 (``vq_precision``)."""
        import torch
        from mmada_parallel_torch.models import magvit2 as MVQ
        from mmada_parallel_torch.models.vqgan_common import vq_precision
        dev = self.vq_params["encoder"]["conv_in"]["w"].device
        with torch.inference_mode(), vq_precision():
            px = torch.as_tensor(px, dtype=torch.float32, device=dev)
            return MVQ.magvit_get_code(self.vq_params, self.vq_cfg, px)


def _validate(params, mcfg, vq_params, vq_cfg, tokenizer, sample, cfg,
              step):
    """Generate from one validation sample and save the result
    (the reference's ``generate_interleave`` wandb table,
    ``train_interleave.py:986-1169``, minus the wandb sink)."""
    import torch
    from mmada_parallel_torch.pipeline import InterleavePipeline
    from mmada_parallel_torch.samplers.interleave import InterleaveOptions
    from mmada_parallel_torch.utils.image import array_to_image
    # build the pipeline once per (backbone, tokenizer, shapes) and keep it
    # across calls; the cache holds the objects whose ids key it
    pre = cfg.dataset.preprocessing
    key = (id(mcfg), id(vq_params), id(tokenizer),
           cfg.model.mmada.num_vq_tokens, pre.max_seq_length, pre.resolution)
    cached = getattr(_validate, "_pipe", None)
    if cached is None or cached[0] != key:
        cached = (key, InterleavePipeline(
            mcfg, params, vq_cfg, vq_params, tokenizer,
            num_vq_tokens=cfg.model.mmada.num_vq_tokens,
            max_seq_length=pre.max_seq_length, resolution=pre.resolution))
        _validate._pipe = cached
    pipe = cached[1]
    pipe.llada_params = params
    opts = InterleaveOptions(text_steps=32, image_steps=8)
    with torch.no_grad():
        _, text, info = pipe(sample["instruction"], sample["input_image"],
                             opts, seed=step)
    out = os.path.join(cfg.output_dir, "validation")
    os.makedirs(out, exist_ok=True)
    array_to_image(info["pixels"]).save(
        os.path.join(out, f"step{step:07d}.png"))
    with open(os.path.join(out, f"step{step:07d}.txt"), "w") as f:
        f.write(text if isinstance(text, str) else str(text))
    print(f"[validate] step {step}: saved validation sample")


def _chat_prompt_ids(tokenizer, question):
    """The reference's chat template wrap (train_interleave.py:1327-1330)."""
    chat = ("<|start_header_id|>user<|end_header_id|>\n" + question
            + "<eot_id><|start_header_id|>assistant<|end_header_id|>\n")
    ids = tokenizer(chat)["input_ids"]
    bos = getattr(tokenizer, "bos_token_id", None)
    return ([bos] if bos is not None else []) + list(ids)


def _conversation_prompt_ids(tokenizer, messages):
    """Full multi-turn history through the tokenizer's chat template with
    the assistant generation header appended — the reference's
    ``apply_chat_template(messages, add_generation_prompt=True)``
    (``train_interleave.py:1236-1241``).  Falls back to the header-tag
    format of ``:1327-1330`` for tokenizers without a chat template."""
    tmpl = getattr(tokenizer, "apply_chat_template", None)
    if tmpl is not None and getattr(tokenizer, "chat_template", None):
        return list(tmpl(messages, tokenize=True,
                         add_generation_prompt=True))
    chat = "".join(
        f"<|start_header_id|>{m.get('role', 'user')}<|end_header_id|>\n"
        f"{m.get('content', '')}<eot_id>" for m in messages)
    chat += "<|start_header_id|>assistant<|end_header_id|>\n"
    ids = tokenizer(chat)["input_ids"]
    bos = getattr(tokenizer, "bos_token_id", None)
    return ([bos] if bos is not None else []) + list(ids)


def _batched_mmu(params, mcfg, prompt_lists, opts, pad_id):
    """One ``mmu_generate`` call for a batch of ragged prompts.

    Prompts are right-padded to a 32-multiple bucket with a true-length
    ``attn_mask`` (positions re-ranked by the sampler), so each row decodes
    exactly as its unpadded single run — the reference re-runs the full
    model per item (``train_interleave.py:1245-1258``).

    Returns ``(final_ids [B, P + max_new_tokens], prompt_len P)``.
    """
    import numpy as np
    import torch
    from mmada_parallel_torch.samplers.mmu import mmu_generate

    B = len(prompt_lists)
    P = max(32, -(-max(len(p) for p in prompt_lists) // 32) * 32)
    ids = np.full((B, P), pad_id, np.int64)
    mask = np.zeros((B, P), bool)
    for i, p in enumerate(prompt_lists):
        ids[i, :len(p)] = p
        mask[i, :len(p)] = True
    dev = params["wte"].device
    with torch.no_grad():
        fin = mmu_generate(params, mcfg, torch.as_tensor(ids, device=dev),
                           opts, attn_mask=torch.as_tensor(mask, device=dev))
    return fin.cpu().numpy(), P


def _validate_mmu(params, mcfg, get_code, tokenizer, cfg, step):
    """MMU understanding validation (``understanding_images``,
    ``train_interleave.py:1176-1290``): encode each validation image, build
    the MMU prompt (image span + chat-template question), run the MMU
    sampler; the wandb table becomes ``validation/mmu_step{N}.jsonl``."""
    import json
    from PIL import Image
    from mmada_parallel_torch import tokens as _tk
    from mmada_parallel_torch.utils.image import (image_transform,
                                                  image_transform_squash)
    from mmada_parallel_torch.samplers.mmu import MMUOptions

    pf = cfg.dataset.params.mmu_validation_prompts_file
    root = cfg.dataset.params.mmu_image_root
    if not pf or not os.path.exists(pf):
        print(f"[validate_mmu] prompts file missing: {pf!r}; skipping")
        return
    with open(pf) as f:
        items = json.load(f)
    T = _tk.TOKENS_M
    msl = cfg.dataset.preprocessing.max_seq_length
    # reference generation params (train_interleave.py:1255-1258)
    opts = MMUOptions(max_new_tokens=msl, steps=msl // 2,
                      block_length=msl // 4, temperature=0.0,
                      mask_token=T.mask)
    out_dir = os.path.join(cfg.output_dir, "validation")
    os.makedirs(out_dir, exist_ok=True)
    prompts, kept = [], []
    for item in items:
        name, msgs = item.get("file_name"), item.get("messages")
        if not name or not msgs:
            continue
        path = os.path.join(root, name)
        if not os.path.exists(path):
            continue
        img = Image.open(path).convert("RGB")
        # squash transform for document/diagram sets (ref :1224-1228)
        tf = (image_transform_squash if any(
            t in name for t in ("ai2d", "clevr", "docvqa", "geo", "llava"))
            else image_transform)
        px = tf(img, cfg.dataset.preprocessing.resolution)
        codes = get_code(px)[0].cpu().numpy() + T.vq_offset
        # full multi-turn history through the chat template (ref :1236-1241)
        msgs = msgs if isinstance(msgs, list) else [
            {"role": "user", "content": str(msgs)}]
        qids = _conversation_prompt_ids(tokenizer, msgs)
        prompts.append([T.mmu, T.soi] + [int(c) for c in codes]
                       + [T.eoi] + [int(q) for q in qids])
        kept.append((name, msgs))
    rows = []
    if prompts:
        fin, P = _batched_mmu(params, mcfg, prompts, opts, T.eos)
        for i, (name, msgs) in enumerate(kept):
            ans = [int(t) for t in fin[i, P:] if int(t) != T.mask]
            text = (tokenizer.decode(ans, skip_special_tokens=True)
                    if hasattr(tokenizer, "decode") else ans)
            rows.append({"file_name": name, "messages": msgs,
                         "response": text})
    with open(os.path.join(out_dir, f"mmu_step{step:07d}.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"[validate_mmu] step {step}: {len(rows)} items")


def _validate_chat(params, mcfg, tokenizer, cfg, step):
    """Chat text validation (``generate_chat_text``,
    ``train_interleave.py:1292-1359``): lm-chat questions through the text
    sampler; the HTML/wandb sink becomes ``validation/chat_step{N}.jsonl``."""
    import json
    from mmada_parallel_torch import tokens as _tk
    from mmada_parallel_torch.samplers.mmu import MMUOptions

    jl = cfg.dataset.params.lm_chat_validation_jsonl
    if not jl or not os.path.exists(jl):
        print(f"[validate_chat] jsonl missing: {jl!r}; skipping")
        return
    with open(jl) as f:
        questions = [json.loads(line)["question"] for line in f
                     if line.strip()]
    T = _tk.TOKENS_M
    msl = cfg.dataset.preprocessing.max_seq_length
    # reference generation params (train_interleave.py:1332-1337)
    opts = MMUOptions(max_new_tokens=msl, steps=msl // 2,
                      block_length=msl // 4, temperature=0.0,
                      mask_token=T.mask)
    out_dir = os.path.join(cfg.output_dir, "validation")
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    if questions:
        prompts = [_chat_prompt_ids(tokenizer, q) for q in questions]
        fin, P = _batched_mmu(params, mcfg, prompts, opts, T.eos)
        for i, q in enumerate(questions):
            ans = [int(t) for t in fin[i, P:] if int(t) != T.mask]
            text = (tokenizer.decode(ans, skip_special_tokens=True)
                    if hasattr(tokenizer, "decode") else ans)
            rows.append({"question": q, "response": text})
    with open(os.path.join(out_dir, f"chat_step{step:07d}.jsonl"), "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"[validate_chat] step {step}: {len(rows)} prompts")


def _check_one_device(cfg) -> None:
    if (cfg.mesh.fsdp != 1 or cfg.mesh.tensor != 1
            or cfg.training.get("shard_strategy", "full") != "full"):
        raise SystemExit(
            "mesh.fsdp, mesh.tensor and training.shard_strategy need "
            "multi-GPU training, which is not ported yet (ROADMAP.md Queue "
            "1, item 16): leave them at 1, 1 and 'full'")


def _device(name: str):
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={name}: no CUDA device here (pass "
                           f"device=cpu to train on the CPU)")
    return device


def build_models(cfg, device) -> Models:
    """The backbone (f32 params on ``device``, bf16 compute, remat
    ``whole_layer``), the tokenizer and MagViT-v2: the released checkpoints
    when ``checkpoint`` / ``vq_checkpoint`` name them, else random weights
    from the seed (the tiny debug backbone with the full M vocab and no
    tokenizer; MagViT-v2 tiny under ``tiny_debug``)."""
    import torch
    from mmada_parallel_torch.models import convert as CV
    from mmada_parallel_torch.models import magvit2 as MVQ
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    from mmada_parallel_torch.tokens import TOKENS_M

    device = torch.device(device)
    if cfg.tiny_debug or cfg.checkpoint is None:
        # tiny width, REAL token space — the full M vocab embedding at
        # d_model 64 is ~35 MB, cheap enough for smoke runs
        mcfg = LLaDAConfig.tiny(vocab_size=TOKENS_M.full_vocab_size,
                                mask_token_id=TOKENS_M.mask)
        params = init_llada_params(mcfg, torch.Generator(
            device=device).manual_seed(cfg.training.seed))
        tokenizer = None
    else:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(cfg.checkpoint,
                                                  trust_remote_code=True)
        mcfg, params = CV.load_llada_checkpoint(cfg.checkpoint)
        params = {k: ({n: t.to(device) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(device))
                  for k, v in params.items()}
    mcfg = dataclasses.replace(mcfg, compute_dtype=torch.bfloat16,
                               remat="whole_layer")

    vq_cfg = (MVQ.MagvitConfig.tiny() if cfg.tiny_debug
              else MVQ.MagvitConfig())
    if cfg.vq_checkpoint:
        vq_params = CV.magvit_params_from_torch(
            CV.load_safetensors_dir(cfg.vq_checkpoint, device=device),
            vq_cfg)
    else:
        vq_params = MVQ.init_magvit_params(
            vq_cfg, torch.Generator(device=device).manual_seed(1))
    return Models(mcfg, params, tokenizer, vq_cfg, vq_params)


def make_loss_fn(mcfg, cfg):
    """``loss_fn(params, batch, generator) -> (loss, {text_loss,
    image_loss})``: the full forward with the key-padding mask and
    :func:`m_interleave_loss` on ``batch = (ids, labels, mask, t)``."""
    from mmada_parallel_torch.models.llada import llada_forward
    from mmada_parallel_torch.training.losses import m_interleave_loss
    tr = cfg.training
    msl = cfg.dataset.preprocessing.max_seq_length
    n_vq = cfg.model.mmada.num_vq_tokens

    def loss_fn(p, batch, generator):
        ids, labels, mask, t = batch
        logits = llada_forward(p, mcfg, ids, mask.bool())
        out = m_interleave_loss(logits, labels, t, msl, n_vq,
                                tr.text_coeff, tr.image_coeff)
        return out["loss"], {"text_loss": out["text_loss"],
                             "image_loss": out["image_loss"]}

    return loss_fn


def build_train_step(mcfg, params, cfg):
    """``(state, step, schedule)`` of the recipe: :func:`make_loss_fn`,
    AdamW (betas 0.9 / 0.999, no decay on 1-D params) behind the
    global-norm clip, the ``training.scheduler`` schedule, gradients
    accumulated over ``gradient_accumulation_steps`` microbatches."""
    from mmada_parallel_torch.training.lr_schedules import get_scheduler
    from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                       TrainState,
                                                       make_optimizer,
                                                       make_train_step)
    tr = cfg.training
    sched = get_scheduler(tr.scheduler, tr.lr, tr.warmup_steps,
                          tr.max_train_steps)
    opt = make_optimizer(OptimizerConfig(
        lr=tr.lr, weight_decay=tr.weight_decay, b1=0.9, b2=0.999,
        grad_clip=tr.max_grad_norm, schedule=sched), params)
    step = make_train_step(make_loss_fn(mcfg, cfg), opt,
                           accum_steps=tr.gradient_accumulation_steps)
    return TrainState.create(params, opt), step, sched


def assemble_batch(group, get_code, tokenizer, up, generator, cfg, device):
    """Decoded samples -> ``(ids, labels, mask, t)`` on ``device``: both
    images through MagViT-v2, the output texts bos/eos-normalised and
    eos-padded, the output image and text noised (``interleave_noising``
    with ``generator``), then the interleave sequence of ``up`` (or, with no
    tokenizer, the bare ``[codes_in | image | text]`` rows).  A sample needs
    ``pixels_in``, ``pixels_out`` (``[1, R, R, 3]`` in [-1, 1]),
    ``instruction``, ``output_text`` and ``is_text_only``."""
    import numpy as np
    import torch
    from mmada_parallel_torch.data.prompting import encode_output_texts
    from mmada_parallel_torch.tokens import TOKENS_M
    from mmada_parallel_torch.training.masking import interleave_noising

    tr = cfg.training
    msl = cfg.dataset.preprocessing.max_seq_length
    px_in = np.concatenate([np.asarray(g["pixels_in"]) for g in group])
    px_out = np.concatenate([np.asarray(g["pixels_out"]) for g in group])
    codes_in = get_code(px_in).cpu().numpy() + TOKENS_M.vq_offset
    codes_out = get_code(px_out).to(device) + TOKENS_M.vq_offset
    texts_in = [g["instruction"] for g in group]
    out_text_ids, out_text_lens = encode_output_texts(
        tokenizer, [g["output_text"] for g in group], msl)
    noisy_img, img_lab, noisy_txt, txt_lab, t = interleave_noising(
        generator, codes_out, torch.as_tensor(out_text_ids, device=device),
        eps=tr.min_masking_rate, mask_token=TOKENS_M.mask)
    noisy_img, img_lab, noisy_txt, txt_lab = (
        x.cpu().numpy() for x in (noisy_img, img_lab, noisy_txt, txt_lab))
    if up is not None:
        seq, labels, mask = up.interleave(
            codes_in, texts_in, noisy_img, noisy_txt, txt_lab,
            cond_dropout_prob=tr.cond_dropout_prob,
            output_image_labels=img_lab,
            output_text_lengths=out_text_lens,
            is_text_only=[g["is_text_only"] for g in group])
    else:  # tiny debug path without a tokenizer
        seq = np.concatenate([codes_in, noisy_img, noisy_txt], 1)
        labels = np.concatenate(
            [np.full_like(codes_in, -100), img_lab, txt_lab], 1)
        mask = np.ones_like(seq)
    return (torch.as_tensor(seq, dtype=torch.long, device=device),
            torch.as_tensor(labels, dtype=torch.long, device=device),
            torch.as_tensor(mask, dtype=torch.long, device=device),
            t.float())


def _groups(samples, size: int):
    """Consecutive groups of ``size`` samples; a short tail is dropped."""
    buf = []
    for s in samples:
        buf.append(s)
        if len(buf) == size:
            yield buf
            buf = []


def train_loop(cfg, state, step, samples, models: Models, sched,
               generator, mngr=None, writer=None):
    """Train from ``state.step`` to ``training.max_train_steps`` over
    ``samples``, an iterable of decoded sample dicts (see
    :func:`assemble_batch`) that is iterated again for each epoch: groups
    of ``batch_size * gradient_accumulation_steps`` samples, one step each;
    scalars to ``writer`` every ``log_every`` steps, checkpoints to ``mngr``
    every ``save_every``, and the validators at their intervals (with a
    tokenizer).  Returns ``(state, history)``, ``history`` the logged
    scalars of each step."""
    from mmada_parallel_torch.data.prompting import UniversalPrompting
    from mmada_parallel_torch.utils.logging import MetricLogger

    tr = cfg.training
    tokenizer = models.tokenizer
    device = state.params["wte"].device
    up = None
    if tokenizer is not None:
        up = UniversalPrompting(
            tokenizer, max_text_len=cfg.dataset.preprocessing.max_seq_length)
    logger = MetricLogger()
    history = []
    global_step = int(state.step)
    t_end = time.time()
    while global_step < tr.max_train_steps:
        epoch_steps = 0
        for group in _groups(samples, tr.batch_size
                             * tr.gradient_accumulation_steps):
            epoch_steps += 1
            batch = assemble_batch(group, models.get_code, tokenizer, up,
                                   generator, cfg, device)
            state, metrics = step(state, batch)
            global_step += 1
            scalars = {k: float(v) for k, v in metrics.items()}
            scalars["lr"] = float(sched(global_step))
            scalars["batch_time"] = time.time() - t_end
            t_end = time.time()
            logger.update(**scalars)
            history.append(scalars)
            if global_step % tr.log_every == 0:
                if writer is not None:
                    writer.write(global_step, scalars)
                print(f"step {global_step}: {logger}")
            if mngr is not None and global_step % tr.save_every == 0:
                mngr.save(global_step, state, {"step": global_step})
            if (tr.generate_every and tokenizer is not None
                    and global_step % tr.generate_every == 0):
                # periodic validation generation (train_interleave.py:950-964)
                _validate(state.params, models.mcfg, models.vq_params,
                          models.vq_cfg, tokenizer, group[0], cfg,
                          global_step)
            if (tr.get("validate_mmu_every", 0) and tokenizer is not None
                    and global_step % tr.validate_mmu_every == 0):
                _validate_mmu(state.params, models.mcfg, models.get_code,
                              tokenizer, cfg, global_step)
            if (tr.get("validate_chat_every", 0) and tokenizer is not None
                    and global_step % tr.validate_chat_every == 0):
                _validate_chat(state.params, models.mcfg, tokenizer, cfg,
                               global_step)
            if global_step >= tr.max_train_steps:
                break
        if epoch_steps == 0:
            raise RuntimeError(
                f"data stream produced no batches — check shards pattern "
                f"{cfg.shards!r} (need >= batch x accum = "
                f"{tr.batch_size * tr.gradient_accumulation_steps} samples)")
    return state, history


def main(argv=None):
    import torch
    from mmada_parallel_torch.config import load_config
    from mmada_parallel_torch.data.shards import InterleavePairShardDataset
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    from mmada_parallel_torch.utils.image import image_transform_squash
    from mmada_parallel_torch.utils.logging import ScalarWriter

    argv = list(sys.argv[1:] if argv is None else argv)
    path = None
    overrides = []
    for a in argv:
        if a.startswith("config="):
            path = a.split("=", 1)[1]
        else:
            overrides.append(a)
    cfg = load_config(path, overrides, DEFAULTS)
    _check_one_device(cfg)
    device = _device(cfg.device)
    tr = cfg.training
    os.makedirs(cfg.output_dir, exist_ok=True)

    models = build_models(cfg, device)
    state, step, sched = build_train_step(models.mcfg, models.params, cfg)
    mngr = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"))
    restored, meta, last = mngr.restore(state)
    if restored is not None:
        state = restored
        print(f"[resume] step {last}")
    wandb_cfg = cfg.get("wandb", {}) or {}
    writer = ScalarWriter(os.path.join(cfg.output_dir, "tb"), is_main=True,
                          wandb_project=wandb_cfg.get("project"),
                          wandb_run_name=wandb_cfg.get("run_name"),
                          wandb_config=dict(cfg))

    # edit-pair samples (input image, instruction, output image, output
    # text) via the normalize_example field zoo (train_interleave.py:
    # 340-476); a shard whose samples carry only one image trains
    # t2i-style with input == target (the reference's placeholder path)
    res = cfg.dataset.preprocessing.resolution
    ds = InterleavePairShardDataset(
        cfg.shards, transform=lambda im: image_transform_squash(im, res),
        resolution=res)
    generator = torch.Generator(device=device).manual_seed(tr.seed)
    state, _ = train_loop(cfg, state, step, ds, models, sched, generator,
                          mngr=mngr, writer=writer)
    mngr.save(state.step, state, {"step": state.step})
    mngr.wait()
    writer.close()
    print(f"[done] {state.step} steps")


if __name__ == "__main__":
    main()
