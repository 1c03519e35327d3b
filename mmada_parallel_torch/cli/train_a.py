"""Variant-A finetune CLI on PyTorch/CUDA.

The flags of :mod:`mmada_parallel_tpu.cli.train_a`, plus ``--device``:
length-clustered deterministic data order, gradient accumulation, AdamW with
the half-cosine schedule, checkpoints with mid-epoch resume, TensorBoard /
jsonl metrics.  One device: the mesh and sharding flags raise when set away
from their single-device defaults.  The data pipeline (``MetaDataset``,
``LengthClusteredSampler``, ``AItemProcessor``) and the metric logging are
the port's copies of the JAX package's host modules, imported inside
:func:`main`.

    python -m mmada_parallel_torch.cli.train_a --data_config data.yaml \
        --output_dir out --init_from /ckpts/MMaDA-Parallel-A --checkpointing

:func:`build_train_step` is the step the CLI runs; ``chip_smoke.py`` runs it
at full width.
"""

import argparse
import dataclasses
import os
import time


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data_config", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--init_from", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--accum_iter", type=int, default=4)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--wd", type=float, default=0.1)
    p.add_argument("--warmup_epochs", type=float, default=0.001)
    p.add_argument("--clip_grad", type=float, default=4.0)
    p.add_argument("--max_seq_len", type=int, default=5120)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--save_iteration_interval", type=int, default=1000)
    p.add_argument("--ckpt_max_keep", type=int, default=2)
    p.add_argument("--checkpointing", action="store_true",
                   help="activation rematerialization (whole_layer)")
    p.add_argument("--precision", type=str, default="bf16",
                   choices=["bf16", "fp32"])
    p.add_argument("--mesh_fsdp", type=int, default=1,
                   help="one device only: must stay 1")
    p.add_argument("--shard_strategy", type=str, default="full",
                   choices=["full", "zero2", "ddp"],
                   help="one device only: must stay 'full'")
    p.add_argument("--mesh_tensor", type=int, default=1,
                   help="one device only: must stay 1")
    p.add_argument("--tp_ring", action="store_true",
                   help="ring tensor parallelism: not ported (raises)")
    p.add_argument("--cache_ann_on_disk", action="store_true",
                   help="build a shared mmap annotation cache")
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--tiny_model", action="store_true",
                   help="debug: random tiny model instead of a checkpoint")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cpu for the tests)")
    return p


def build_train_step(cfg, params, *, lr: float, min_lr: float, wd: float,
                     clip_grad: float, warmup_steps: int, total_steps: int,
                     accum_steps: int):
    """``(state, step, schedule)`` of the A recipe: the full forward and
    :func:`a_variant_losses` on ``batch = (ids, labels, lengths)``, AdamW
    (no decay on 1-D params) behind the global-norm clip, half-cosine
    schedule with warmup, gradients accumulated over ``accum_steps``
    microbatches."""
    from mmada_parallel_torch.models.llada import llada_forward
    from mmada_parallel_torch.training.losses import a_variant_losses
    from mmada_parallel_torch.training.lr_schedules import \
        half_cosine_with_warmup
    from mmada_parallel_torch.training.trainer import (OptimizerConfig,
                                                       TrainState,
                                                       make_optimizer,
                                                       make_train_step)

    def loss_fn(params, batch, generator):
        ids, labels, lengths = batch
        out = a_variant_losses(llada_forward(params, cfg, ids), ids, labels,
                               lengths)
        return out["loss"], {"text_loss": out["text_loss"],
                             "image_loss": out["image_loss"]}

    sched = half_cosine_with_warmup(lr, warmup_steps, total_steps, min_lr)
    opt = make_optimizer(OptimizerConfig(lr=lr, weight_decay=wd,
                                         grad_clip=clip_grad,
                                         schedule=sched), params)
    step = make_train_step(loss_fn, opt, accum_steps=accum_steps)
    return TrainState.create(params, opt), step, sched


def collate_fn(ds, max_seq_len: int, bucket: int = 128):
    """``collate(batch_indices) -> (ids, labels, lengths)`` numpy arrays,
    each row cut to ``max_seq_len`` and the batch padded to a multiple of
    ``bucket`` (0 ids, -100 labels)."""
    import numpy as np
    seq_cap = max(max_seq_len // bucket * bucket, bucket)

    def collate(batch_indices):
        toks, labs = zip(*(ds[i] for i in batch_indices))
        L = min(max(len(t) for t in toks), seq_cap)
        L = min((L + bucket - 1) // bucket * bucket, seq_cap)
        ids = np.zeros((len(toks), L), np.int64)
        labels = np.full((len(toks), L), -100, np.int64)
        lengths = np.asarray([min(len(t), L) for t in toks], np.int64)
        for r, (t, lab) in enumerate(zip(toks, labs)):
            n = min(len(t), L)
            ids[r, :n] = t[:n]
            labels[r, :n] = lab[:n]
        return ids, labels, lengths

    return collate


def _padcat(micro, k: int):
    """Field ``k`` of the microbatches, padded to one length and stacked
    along the batch dim."""
    import numpy as np
    Lm = max(m[0].shape[1] for m in micro)
    outs = []
    for m in micro:
        a = m[k]
        if a.ndim == 2 and a.shape[1] < Lm:
            pad = np.full((a.shape[0], Lm - a.shape[1]),
                          0 if k == 0 else -100, a.dtype)
            a = np.concatenate([a, pad], 1)
        outs.append(a)
    return np.concatenate(outs, 0)


def main(argv=None):
    import torch

    from mmada_parallel_torch.data.dataset import (LengthClusteredSampler,
                                                   MetaDataset)
    from mmada_parallel_torch.data.item_processor import AItemProcessor
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    from mmada_parallel_torch.utils.logging import MetricLogger, ScalarWriter

    args = build_parser().parse_args(argv)
    if (args.mesh_fsdp != 1 or args.mesh_tensor != 1 or args.tp_ring
            or args.shard_strategy != "full"):
        raise SystemExit("--mesh_fsdp, --mesh_tensor, --tp_ring and "
                         "--shard_strategy need multi-GPU training, which is "
                         "not ported: leave them at 1, 1, off and 'full'")
    os.makedirs(args.output_dir, exist_ok=True)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32

    # --- model: f32 params, compute in --precision ---
    if args.tiny_model:
        cfg = LLaDAConfig.tiny(vocab_size=512)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_llada_params(cfg, gen)
    else:
        from mmada_parallel_torch.models import convert as CV
        cfg, params = CV.load_llada_checkpoint(args.init_from)
        params = {k: ({n: t.to(device) for n, t in v.items()}
                      if isinstance(v, dict) else v.to(device))
                  for k, v in params.items()}
    cfg = dataclasses.replace(
        cfg, compute_dtype=dtype,
        remat="whole_layer" if args.checkpointing else "none")

    # --- data ---
    tok_src = args.tokenizer or args.init_from
    if args.tiny_model and tok_src is None:
        class _T:
            bos_token_id, eos_token_id = 1, 2

            def __call__(self, t, **kw):
                return {"input_ids": [1] + [10 + ord(c) % 400
                                            for c in t[:32]]}
        tokenizer = _T()
    else:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(tok_src,
                                                  trust_remote_code=True)
    proc = AItemProcessor(tokenizer, max_len=args.max_seq_len)
    ds = MetaDataset(args.data_config, proc,
                     cache_on_disk=args.cache_ann_on_disk, rank=0)
    sampler = LengthClusteredSampler(
        ds.lengths(), ds.types, batch_size=args.batch_size, world_size=1,
        rank=0, acc_grad=args.accum_iter, seed=args.seed)
    iters_per_epoch = max(len(sampler) // args.accum_iter, 1)

    # --- optimizer / step ---
    total = args.epochs * iters_per_epoch
    state, step, sched = build_train_step(
        cfg, params, lr=args.lr, min_lr=args.min_lr, wd=args.wd,
        clip_grad=args.clip_grad,
        warmup_steps=int(args.warmup_epochs * iters_per_epoch),
        total_steps=total, accum_steps=args.accum_iter)

    mngr = CheckpointManager(os.path.join(args.output_dir, "ckpt"),
                             max_to_keep=args.ckpt_max_keep)
    restored, meta, last = mngr.restore(state)
    start_epoch, start_iter = 0, 0
    logger = MetricLogger()
    if restored is not None:
        state = restored
        start_epoch = meta.get("epoch", 0)
        start_iter = meta.get("iter", 0)
        if meta.get("metrics"):
            logger.load_state_dict(meta["metrics"])
        print(f"[resume] step {last} (epoch {start_epoch} iter {start_iter})")

    writer = ScalarWriter(os.path.join(args.output_dir, "tb"), is_main=True)
    collate = collate_fn(ds, args.max_seq_len)

    global_step = state.step
    for epoch in range(start_epoch, args.epochs):
        sampler.set_epoch(epoch, start_iter if epoch == start_epoch else 0)
        micro = []
        t_end = time.time()
        for batch_idx in sampler:
            micro.append(collate(batch_idx))
            if len(micro) < args.accum_iter:
                continue
            batch = tuple(torch.from_numpy(_padcat(micro, k)).to(device)
                          for k in range(3))
            micro = []
            state, metrics = step(state, batch)
            global_step += 1
            scalars = {k: float(v) for k, v in metrics.items()}
            scalars["lr"] = float(sched(global_step))
            scalars["iter_time"] = time.time() - t_end
            t_end = time.time()
            logger.update(**scalars)
            if global_step % 10 == 0:
                writer.write(global_step, scalars)
                print(f"epoch {epoch} step {global_step}: {logger}")
            if global_step % args.save_iteration_interval == 0:
                mngr.save(global_step, state,
                          {"epoch": epoch,
                           "iter": global_step % iters_per_epoch,
                           "metrics": logger.state_dict()})
            if args.max_steps and global_step >= args.max_steps:
                break
        if args.max_steps and global_step >= args.max_steps:
            break
        mngr.save(global_step, state, {"epoch": epoch + 1, "iter": 0,
                                       "metrics": logger.state_dict()})
    mngr.wait()
    writer.close()
    print(f"[done] {global_step} steps")


if __name__ == "__main__":
    main()
