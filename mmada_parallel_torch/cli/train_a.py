"""Variant-A finetune CLI on PyTorch/CUDA.

The flags of :mod:`mmada_parallel_tpu.cli.train_a`, plus ``--device``:
length-clustered deterministic data order, gradient accumulation, AdamW with
the half-cosine schedule, checkpoints with mid-epoch resume, TensorBoard /
jsonl metrics.  The data pipeline (``MetaDataset``,
``LengthClusteredSampler``, ``AItemProcessor``) and the metric logging are
the port's copies of the JAX package's host modules, imported inside
:func:`main`.

    python -m mmada_parallel_torch.cli.train_a --data_config data.yaml \
        --output_dir out --init_from /ckpts/MMaDA-Parallel-A --checkpointing

Under ``torchrun`` the ranks form the ``(data, fsdp, tensor)`` mesh:
``--mesh_fsdp`` with ``--shard_strategy`` (``full``, ``zero2``, ``ddp``)
shards over ``fsdp``, ``--mesh_tensor g`` splits heads, MLP hidden and vocab
over ``tensor`` (Megatron, ``parallel/tensor.py``), and ``--tp_ring
--mesh_tensor g`` runs the backbone on the ring (``parallel/tp_overlap.py``).  Each data-parallel rank draws its
own rows, the ranks of one ring the same rows; only rank 0 logs, and the
checkpoint is sharded (``training/checkpoint.py``).

    torchrun --nproc_per_node 4 -m mmada_parallel_torch.cli.train_a \
        --data_config data.yaml --output_dir out --init_from ... \
        --checkpointing --mesh_fsdp 4 --shard_strategy full

:func:`build_train_step` is the step the CLI runs; ``chip_smoke.py`` runs it
at full width.
"""

import argparse
import dataclasses
import math
import os
import time


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--data_config", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--init_from", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=4,
                   help="rows each data-parallel rank draws a microbatch: "
                        "the global microbatch is batch_size x data x "
                        "fsdp rows (the ranks of one --tp_ring ring share "
                        "theirs)")
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
                   help="ranks of the mesh's fsdp axis (data takes the "
                        "rest of the torchrun world)")
    p.add_argument("--shard_strategy", type=str, default="full",
                   choices=["full", "zero2", "ddp"],
                   help="fsdp-axis policy: full=FULL_SHARD/ZeRO-3, "
                        "zero2=SHARD_GRAD_OP, ddp=NO_SHARD")
    p.add_argument("--mesh_tensor", type=int, default=1,
                   help="ranks of the tensor axis: Megatron tensor "
                        "parallelism, or the ring with --tp_ring")
    p.add_argument("--tp_ring", action="store_true",
                   help="run the backbone on the ring tensor-parallel path "
                        "(parallel/tp_overlap.py); needs --mesh_tensor >= "
                        "2, --mesh_fsdp 1, llama blocks and head counts "
                        "divisible by the ring")
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
                     accum_steps: int, mesh=None, shard_strategy: str = "full",
                     tp_ring: bool = False, tally=None):
    """``(state, step, schedule)`` of the A recipe: the full forward and
    :func:`a_variant_losses` on ``batch = (ids, labels, lengths)``, AdamW
    (no decay on 1-D params) behind the global-norm clip, half-cosine
    schedule with warmup, gradients accumulated over ``accum_steps``
    microbatches.

    With a ``mesh``, ``state`` holds this rank's slices and ``step`` (with
    its spec tree as ``step.state_specs``) runs the sharded step:
    ``shard_strategy`` over ``fsdp`` on this rank's rows, or, with
    ``tp_ring``, the ring backbone on the whole batch; a ``tensor`` axis
    without the ring runs Megatron's split (``parallel/tensor.py``) under
    any ``shard_strategy``.  ``tally`` counts the bytes and seconds of the
    FSDP gathers and the ``tensor`` collectives (``gathered``,
    ``scattered``, ``reduced``)."""
    from mmada_parallel_torch.models.llada import (llada_forward,
                                                   param_shardings)
    from mmada_parallel_torch.training.losses import a_variant_losses
    from mmada_parallel_torch.training.lr_schedules import \
        half_cosine_with_warmup
    from mmada_parallel_torch.training.trainer import (
        OptimizerConfig, TrainState, create_sharded_state, make_optimizer,
        make_sharded_train_step, make_train_step, state_shardings)

    forward, dp_groups = (lambda p, ids: llada_forward(p, cfg, ids)), ()
    sched = half_cosine_with_warmup(lr, warmup_steps, total_steps, min_lr)
    opt = make_optimizer(OptimizerConfig(lr=lr, weight_decay=wd,
                                         grad_clip=clip_grad, schedule=sched,
                                         shard_strategy=shard_strategy),
                         params)
    if mesh is not None:
        from mmada_parallel_torch.parallel.mesh import \
            dp_groups as data_parallel_groups
        from mmada_parallel_torch.parallel.tensor import MeshGather
        from mmada_parallel_torch.parallel.tp_overlap import \
            llada_forward_tp_overlap
        state, p_specs, o_specs = create_sharded_state(
            params, opt, param_shardings(cfg), mesh,
            "full" if tp_ring else shard_strategy)
        if tp_ring:
            forward = (lambda p, ids: llada_forward_tp_overlap(p, cfg, ids,
                                                               mesh))
        else:
            gather = MeshGather(mesh, p_specs, cfg, tally)
            forward = (lambda p, ids: llada_forward(p, cfg, ids,
                                                    gather=gather))
            dp_groups = data_parallel_groups(mesh)

    def loss_fn(params, batch, generator):
        ids, labels, lengths = batch
        out = a_variant_losses(forward(params, ids), ids, labels, lengths,
                               dp_groups=dp_groups)
        return out["loss"], {"text_loss": out["text_loss"],
                             "image_loss": out["image_loss"]}

    if mesh is None:
        step = make_train_step(loss_fn, opt, accum_steps=accum_steps)
        return TrainState.create(params, opt), step, sched
    step = make_sharded_train_step(loss_fn, opt, mesh, p_specs, o_specs,
                                   accum_steps=accum_steps, ring=tp_ring)
    step.state_specs = state_shardings(state.params, state.opt_state,
                                       p_specs, o_specs, mesh)
    return state, step, sched


def check_mesh_flags(mesh_fsdp: int, mesh_tensor: int, tp_ring: bool,
                     world: int) -> None:
    """Raise ``SystemExit`` on mesh flags the port cannot run."""
    if tp_ring and (mesh_tensor < 2 or mesh_fsdp != 1):
        raise SystemExit("--tp_ring needs --mesh_tensor >= 2 and "
                         "--mesh_fsdp 1 (ring TP shards the sequence "
                         "between blocks; fsdp would double-shard)")
    if world == 1 and (mesh_fsdp != 1 or mesh_tensor != 1):
        raise SystemExit("--mesh_fsdp and --mesh_tensor need the ranks of "
                         "a torchrun world (one process has one device)")


def gather_ring_batch(batch, mesh, accum_steps: int = 1):
    """The whole batch of a ring step on every rank: each data group's
    rows gathered over ``data`` (padded to the longest), microbatch by
    microbatch, so global microbatch ``i`` holds every group's ``i``-th."""
    import numpy as np
    import torch.distributed as dist
    if mesh.shape[mesh.mesh_dim_names.index("data")] == 1:
        return batch
    parts = [None] * dist.get_world_size(mesh.get_group("data"))
    dist.all_gather_object(parts, batch, group=mesh.get_group("data"))
    L = max(p[0].shape[1] for p in parts)

    def stack(k, fill):
        mbs = [np.pad(p[k], ((0, 0), (0, L - p[k].shape[1])),
                      constant_values=fill) if p[k].ndim == 2 else p[k]
               for p in parts]
        mbs = [m.reshape((accum_steps, -1) + m.shape[1:]) for m in mbs]
        out = np.concatenate(mbs, axis=1)
        return out.reshape((-1,) + out.shape[2:])
    return stack(0, 0), stack(1, -100), stack(2, 0)


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


def _main(argv=None):
    import torch
    import torch.distributed as dist

    from mmada_parallel_torch.data.dataset import (LengthClusteredSampler,
                                                   MetaDataset)
    from mmada_parallel_torch.data.item_processor import AItemProcessor
    from mmada_parallel_torch.models.llada import (LLaDAConfig,
                                                   init_llada_params)
    from mmada_parallel_torch.parallel.mesh import (MeshConfig, dp_coordinate,
                                                    init_distributed,
                                                    make_mesh)
    from mmada_parallel_torch.training.checkpoint import CheckpointManager
    from mmada_parallel_torch.utils.logging import MetricLogger, ScalarWriter

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    init_distributed(backend="gloo" if device.type == "cpu" else None)
    world = dist.get_world_size() if dist.is_initialized() else 1
    check_mesh_flags(args.mesh_fsdp, args.mesh_tensor, args.tp_ring, world)
    mesh, rank, dp_rank, dp_world = None, 0, 0, 1
    if world > 1:
        if (device.type == "cuda" and device.index is None
                and dist.get_backend() == "nccl"):
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        mesh = make_mesh(MeshConfig(data=-1, fsdp=args.mesh_fsdp,
                                    tensor=args.mesh_tensor), device.type)
        rank = dist.get_rank()
        dp_rank, dp_world = dp_coordinate(mesh)
    is_main = rank == 0
    os.makedirs(args.output_dir, exist_ok=True)
    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32

    # --- model: f32 params, compute in --precision ---
    if args.tiny_model:
        # the ring needs head counts divisible by its ranks: widen as JAX
        tiny_kw = (dict(n_heads=2 * args.mesh_tensor,
                        n_kv_heads=args.mesh_tensor) if args.tp_ring else {})
        cfg = LLaDAConfig.tiny(vocab_size=512, **tiny_kw)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_llada_params(cfg, gen)
    else:
        from mmada_parallel_torch.models import convert as CV
        cfg, params = CV.load_llada_checkpoint(args.init_from)
        if mesh is None:
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
                     cache_on_disk=args.cache_ann_on_disk, rank=rank)
    # the sampler's rank is the (data, fsdp) coordinate: one ring, one rank
    sampler = LengthClusteredSampler(
        ds.lengths(), ds.types, batch_size=args.batch_size,
        world_size=dp_world, rank=dp_rank, acc_grad=args.accum_iter,
        seed=args.seed)
    iters_per_epoch = max(len(sampler) // args.accum_iter, 1)

    # --- optimizer / step ---
    total = args.epochs * iters_per_epoch
    state, step, sched = build_train_step(
        cfg, params, lr=args.lr, min_lr=args.min_lr, wd=args.wd,
        clip_grad=args.clip_grad,
        warmup_steps=int(args.warmup_epochs * iters_per_epoch),
        total_steps=total, accum_steps=args.accum_iter, mesh=mesh,
        shard_strategy=args.shard_strategy, tp_ring=args.tp_ring)
    del params
    if mesh is not None:       # the slices, cut on the host for a checkpoint
        from mmada_parallel_torch.training.trainer import tree_map
        state.params = tree_map(lambda t: t.to(device), state.params)
        state.opt_state = tree_map(
            lambda t: t.to(device) if isinstance(t, torch.Tensor) else t,
            state.opt_state)

    mngr = CheckpointManager(
        os.path.join(args.output_dir, "ckpt"), max_to_keep=args.ckpt_max_keep,
        mesh=mesh, specs=getattr(step, "state_specs", None))
    restored, meta, last = mngr.restore(state)
    start_epoch, start_iter = 0, 0
    logger = MetricLogger()
    if restored is not None:
        state = restored
        start_epoch = meta.get("epoch", 0)
        start_iter = meta.get("iter", 0)
        if meta.get("metrics"):
            logger.load_state_dict(meta["metrics"])
        if is_main:
            print(f"[resume] step {last} (epoch {start_epoch} iter "
                  f"{start_iter})")

    writer = ScalarWriter(os.path.join(args.output_dir, "tb"),
                          is_main=is_main)
    # the ring needs L % g == 0: buckets of lcm(128, g)
    collate = collate_fn(ds, args.max_seq_len,
                         math.lcm(128, args.mesh_tensor) if args.tp_ring
                         else 128)

    global_step = state.step
    for epoch in range(start_epoch, args.epochs):
        sampler.set_epoch(epoch, start_iter if epoch == start_epoch else 0)
        micro = []
        t_end = time.time()
        for batch_idx in sampler:
            micro.append(collate(batch_idx))
            if len(micro) < args.accum_iter:
                continue
            batch = tuple(_padcat(micro, k) for k in range(3))
            if args.tp_ring:
                batch = gather_ring_batch(batch, mesh, args.accum_iter)
            batch = tuple(torch.from_numpy(a).to(device) for a in batch)
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
                if is_main:
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
    if is_main:
        print(f"[done] {global_step} steps")



def main(argv=None):
    """The CLI; a rank that formed its process group here (torchrun) leaves
    it on the way out, also when the run raises
    (``parallel.mesh.leaves_process_group``)."""
    from mmada_parallel_torch.parallel.mesh import leaves_process_group
    with leaves_process_group():
        return _main(argv)


if __name__ == "__main__":
    main()
