"""Batched ParaBench-style evaluation harness on PyTorch/CUDA.

Counterpart of :mod:`mmada_parallel_tpu.evaluation`.  The variant-A edit
sweep buckets requests by prompt length (rounded up to 64), right-pads each
bucket's prompts behind a true-length attention mask, pads every chunk to
``batch_size`` rows and runs the exact sampler once per chunk; per-request
outputs are decoded on the host.  The variant-M sweeps (interleave,
text-to-image, understanding) drive the continuous-batching servers of
:mod:`mmada_parallel_torch.serving` with concurrent submissions.

Scoring is pluggable: any ``scorer(request, text, codes) -> dict`` works
(:mod:`mmada_parallel_torch.eval_scorers` has local proxies).  Over a
``mesh`` the edit sweep is SPMD: every rank of the mesh calls it with the
same requests and its parameters (``shard_params``, which the forwards
read), each chunk's rows split over ``data`` x ``fsdp`` as JAX's
``batch_sharding`` splits them, and every rank gets the gathered results.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.models.llada import LLaDAConfig
from mmada_parallel_torch.ops import sampling as S
from mmada_parallel_torch.samplers.parallel_ti2ti import (TI2TIOptions,
                                                          decode_text,
                                                          generate_ti2ti)

__all__ = ["EvalRequest", "InterleaveEvalRequest", "T2IEvalRequest",
           "MMUEvalRequest", "run_parabench_sweep", "run_interleave_sweep",
           "run_t2i_sweep", "run_mmu_sweep"]


@dataclasses.dataclass
class EvalRequest:
    prompt_ids: Sequence[int]          # assembled conditional prompt ids
    meta: Optional[Dict] = None


@dataclasses.dataclass
class T2IEvalRequest:
    """One text-to-image sweep item: raw text ids (templated by the server
    into ``[<|t2i|>] bos text eos``)."""
    text_ids: Sequence[int]
    meta: Optional[Dict] = None


@dataclasses.dataclass
class MMUEvalRequest:
    """One multimodal-understanding sweep item: the fully assembled MMU
    prompt (``[<|mmu|>][soi] image [eoi]`` + question)."""
    prompt_ids: Sequence[int]
    meta: Optional[Dict] = None


@dataclasses.dataclass
class InterleaveEvalRequest:
    """One variant-M sweep item: a raw instruction plus exactly one of
    ``codes`` (VQ-offset image tokens, ``[num_vq_tokens]``) or ``image``
    (pixels for the server's MagViT encode)."""
    instr_ids: Sequence[int]
    codes: Optional[np.ndarray] = None
    image: Optional[Any] = None
    meta: Optional[Dict] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_parabench_sweep(
    params: Any,
    cfg: LLaDAConfig,
    requests: Sequence[EvalRequest],
    grid_hw: Tuple[int, int],
    text_gen_length: int,
    end_token_ids: Sequence[int],
    opts: TI2TIOptions = TI2TIOptions(),
    batch_size: int = 8,
    mesh=None,
    tokenizer=None,
    uncond_image_prefix: Optional[np.ndarray] = None,
    seed: int = 42,
    scorer: Optional[Callable] = None,
    tokens: tk.VariantATokens = tk.TOKENS_A,
) -> Dict[str, Any]:
    """Run all requests; returns results and throughput metrics.

    All requests share ``grid_hw`` and ``text_gen_length``.  Within a
    prompt-length bucket (lengths rounded up to 64), prompts are
    right-padded with the pad token behind a true-length attention mask
    (and re-ranked RoPE positions), so each row produces the tokens of its
    unpadded single-row run at temperature 0.  One generator, drawn from
    ``seed`` on the params' device, samples every chunk in turn.  Each
    chunk's time runs from its launch to its results on the host (the copy
    synchronizes), after a synchronize before it.

    ``mesh``: every rank of it calls the sweep (SPMD) with its parameters.
    A chunk is padded to a multiple of the ``data`` x ``fsdp`` ranks (the
    last row repeats, as JAX pads to ``batch_size``), each rank samples its
    rows with the noise those rows get in one draw over the whole chunk
    (:class:`~mmada_parallel_torch.ops.sampling.RowSplitGenerator`), and
    the rows are gathered on every rank; where the ranks divide
    ``batch_size`` (as JAX's sharding needs) the results are the meshless
    sweep's at any temperature.  The per-chip rate divides by the mesh's
    ranks."""
    gh, gw = grid_hw
    device = params["wte"].device
    dp_idx, n_dp = 0, 1
    if mesh is not None:
        from mmada_parallel_torch.parallel.mesh import dp_coordinate
        dp_idx, n_dp = dp_coordinate(mesh)
    rows = -(-batch_size // n_dp) * n_dp
    mine = slice(dp_idx * rows // n_dp, (dp_idx + 1) * rows // n_dp)
    results: List[Dict] = []
    total_time = 0.0

    buckets: Dict[int, List[int]] = {}
    for i, r in enumerate(requests):
        key = (len(r.prompt_ids) + 63) // 64 * 64
        buckets.setdefault(key, []).append(i)

    generator = torch.Generator(device=device).manual_seed(seed)
    if mesh is not None:
        generator = S.RowSplitGenerator(generator, rows, mine)
    for plen, idxs in sorted(buckets.items()):
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s:s + batch_size]
            ids_list, mask_list, layout = [], [], None
            for i in chunk:
                prompt = list(requests[i].prompt_ids)
                n_pad = plen - len(prompt)
                ids, layout = tk.assemble_ti2ti_sequence(
                    prompt + [tokens.pad] * n_pad, text_gen_length, gh, gw,
                    list(end_token_ids), tokens=tokens)
                ids_list.append(ids)
                # the pads sit at the prompt's tail, [plen - n_pad, plen)
                mask = np.ones(len(ids), dtype=bool)
                mask[plen - n_pad:plen] = False
                mask_list.append(mask)
            batch = np.stack(ids_list)
            masks = np.stack(mask_list)
            # every chunk of a bucket has the same rows: the last repeats
            if batch.shape[0] < rows:
                reps = rows - batch.shape[0]
                batch = np.concatenate([batch, batch[-1:].repeat(reps, 0)])
                masks = np.concatenate([masks, masks[-1:].repeat(reps, 0)])

            _sync(device)
            t0 = time.time()
            fin, codes = generate_ti2ti(
                params, cfg, torch.as_tensor(batch[mine], device=device),
                layout, opts, uncond_image_prefix=uncond_image_prefix,
                generator=generator,
                attn_mask=torch.as_tensor(masks[mine], device=device))
            fin, codes = fin.cpu().numpy(), codes.cpu().numpy()
            if mesh is not None:
                fin, codes = _gather_rows(dp_idx, n_dp, fin, codes)
            total_time += time.time() - t0

            for bi, i in enumerate(chunk):
                text = decode_text(fin[bi], layout, opts, tokenizer)
                entry = {"index": i, "text": text, "codes": codes[bi],
                         "meta": requests[i].meta}
                if scorer is not None:
                    entry["scores"] = scorer(requests[i], text, codes[bi])
                results.append(entry)

    n = len(requests)
    rate = 60.0 * n / max(total_time, 1e-9)
    return {
        "results": sorted(results, key=lambda r: r["index"]),
        "num_requests": n,
        "total_time_s": total_time,
        "edits_per_min": rate,
        "edits_per_min_per_chip": rate / (1 if mesh is None
                                          else mesh.size()),
    }


def _gather_rows(dp_idx: int, n_dp: int, *parts: np.ndarray):
    """Each array's rows of every data-parallel rank, in rank order, on
    every rank (the ranks of one ``tensor`` group hold the same rows)."""
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (dp_idx, parts))
    by_rank = dict(every)
    return tuple(np.concatenate([by_rank[i][k] for i in range(n_dp)])
                 for k in range(len(parts)))


def _drive_server(server, submit_calls, warmup_lens=None):
    """Submit thunks concurrently against a batch server so its worker can
    group compatible rows; returns ``(outputs, total_time_s, stats)`` and
    always closes the server.  The servers return host arrays, so the time
    ends with the card's work done."""
    import concurrent.futures as cf

    try:
        if warmup_lens:
            server.warmup(warmup_lens)
        t0 = time.time()
        # enough in-flight submissions to fill several batches, but bounded
        workers = min(max(len(submit_calls), 1),
                      max(4 * getattr(server, "_batch_size", 8), 32))
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            futs = [ex.submit(fn) for fn in submit_calls]
            outs = [f.result() for f in futs]
        total_time = time.time() - t0
        stats = server.stats()
    finally:
        server.close()
    return outs, total_time, stats


def _sweep_summary(results, n, total_time, stats, rate_key):
    rate = 60.0 * n / max(total_time, 1e-9)
    return {
        "results": results,
        "num_requests": n,
        "total_time_s": total_time,
        rate_key: rate,
        f"{rate_key}_per_chip": rate,
        "server_stats": stats,
    }


def run_interleave_sweep(
    params: Any,
    cfg: LLaDAConfig,
    requests: Sequence[InterleaveEvalRequest],
    num_vq_tokens: int,
    opts: Any = None,
    max_seq_length: int = 256,
    batch_size: int = 4,
    tokenizer=None,
    get_code: Optional[Callable] = None,
    scorer: Optional[Callable] = None,
    tokens: tk.VariantMTokens = tk.TOKENS_M,
    seed: int = 42,
    use_cache: bool = False,
    cache_kw: Optional[Dict[str, Any]] = None,
    warmup_lens: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """Variant-M counterpart of :func:`run_parabench_sweep`, through
    :class:`~mmada_parallel_torch.serving.InterleaveServer` (``use_cache``:
    the feature-cached sampler, exact-length groups).  Each result is scored
    as ``scorer(request, text, codes)``, codes being raw codebook indices."""
    from mmada_parallel_torch.samplers.interleave import InterleaveOptions
    from mmada_parallel_torch.serving import InterleaveServer

    server = InterleaveServer(
        params, cfg, opts if opts is not None else InterleaveOptions(),
        num_vq_tokens=num_vq_tokens, max_seq_length=max_seq_length,
        batch_size=batch_size, tokenizer=tokenizer, get_code=get_code,
        tokens=tokens, seed=seed, use_cache=use_cache, cache_kw=cache_kw)
    outs, total_time, stats = _drive_server(
        server,
        [lambda r=r: server.submit(r.instr_ids, codes=r.codes, image=r.image)
         for r in requests],
        warmup_lens)

    results: List[Dict] = []
    for i, (r, o) in enumerate(zip(requests, outs)):
        text = o["text"] if isinstance(o["text"], str) else None
        entry = {"index": i, "text": text, "text_ids": o["text_ids"],
                 "codes": o["codes"], "meta": r.meta}
        if scorer is not None:
            entry["scores"] = scorer(r, text, o["codes"])
        results.append(entry)
    return _sweep_summary(results, len(requests), total_time, stats,
                          "gens_per_min")


def run_t2i_sweep(
    params: Any,
    cfg: LLaDAConfig,
    requests: Sequence[T2IEvalRequest],
    num_vq_tokens: int,
    opts: Any = None,
    batch_size: int = 4,
    bucket_quantum: int = 32,
    max_text_len: int = 512,
    tokenizer=None,
    scorer: Optional[Callable] = None,
    tokens: tk.VariantMTokens = tk.TOKENS_M,
    seed: int = 42,
    warmup_lens: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """Text-to-image sweep over
    :class:`~mmada_parallel_torch.serving.T2IServer`; the scorer is called as
    ``scorer(request, None, codes)``."""
    from mmada_parallel_torch.serving import T2IServer

    server = T2IServer(params, cfg, opts, num_vq_tokens=num_vq_tokens,
                       batch_size=batch_size, bucket_quantum=bucket_quantum,
                       max_text_len=max_text_len, tokenizer=tokenizer,
                       tokens=tokens, seed=seed)
    outs, total_time, stats = _drive_server(
        server, [lambda r=r: server.submit(r.text_ids) for r in requests],
        warmup_lens)

    results: List[Dict] = []
    for i, (r, o) in enumerate(zip(requests, outs)):
        entry = {"index": i, "codes": o["codes"], "meta": r.meta}
        if scorer is not None:
            entry["scores"] = scorer(r, None, o["codes"])
        results.append(entry)
    return _sweep_summary(results, len(requests), total_time, stats,
                          "images_per_min")


def run_mmu_sweep(
    params: Any,
    cfg: LLaDAConfig,
    requests: Sequence[MMUEvalRequest],
    opts: Any = None,
    batch_size: int = 4,
    bucket_quantum: int = 64,
    max_prompt_len: int = 2048,
    tokenizer=None,
    scorer: Optional[Callable] = None,
    tokens: tk.VariantMTokens = tk.TOKENS_M,
    seed: int = 42,
    warmup_lens: Optional[Sequence[int]] = None,
) -> Dict[str, Any]:
    """Multimodal-understanding sweep over
    :class:`~mmada_parallel_torch.serving.MMUServer`; the scorer is called as
    ``scorer(request, text, None)``."""
    from mmada_parallel_torch.serving import MMUServer

    server = MMUServer(params, cfg, opts, batch_size=batch_size,
                       bucket_quantum=bucket_quantum,
                       max_prompt_len=max_prompt_len, tokenizer=tokenizer,
                       tokens=tokens, seed=seed)
    outs, total_time, stats = _drive_server(
        server, [lambda r=r: server.submit(r.prompt_ids) for r in requests],
        warmup_lens)

    results: List[Dict] = []
    for i, (r, o) in enumerate(zip(requests, outs)):
        text = o["text"] if isinstance(o["text"], str) else None
        entry = {"index": i, "text": text, "text_ids": o["text_ids"],
                 "meta": r.meta}
        if scorer is not None:
            entry["scores"] = scorer(r, text, None)
        results.append(entry)
    return _sweep_summary(results, len(requests), total_time, stats,
                          "answers_per_min")
