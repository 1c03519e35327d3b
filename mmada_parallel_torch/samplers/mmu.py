"""Semi-autoregressive block text decoding (multimodal understanding).

Counterpart of :mod:`mmada_parallel_tpu.samplers.mmu`: the answer is decoded
in blocks of ``block_length``; within a block, ``steps_per_block``
confidence top-k transfer steps run with the confidence beyond the current
block forced to ``-inf``, so blocks complete left to right.  Optional CFG
masks the prompt in the uncond row with guidance ``uncond + (cfg+1)*(cond -
uncond)``.  The head runs on the answer span only.  The JAX scans are Python
loops; :func:`mmu_generate_fast` syncs with the host once per block to stop
early.

``generator=None`` is fully deterministic (argmax everywhere), the parity
configuration.

A ``block_causal`` config (SDAR) takes the cached route instead: the blocks
are the model's own (``opts.block_length == cfg.block_length``), so a
finished block never changes and lives in a k/v cache.  The prompt is
prefilled into the cache once (K4, each row seeing up to its block's end);
each step of a block runs the block's positions only, against the cache up
to the block's end (:func:`~mmada_parallel_torch.models.llada.
llada_hidden_partial`), and commits as :meth:`_Decoder.step` does
(:func:`_commit`); after the block's last step one forward of the finished
block, without the head, writes its keys and values.  Spans
``mmu.prefill``, ``mmu.step`` (a forward and its commit) and ``mmu.write``.
On a card a block's step (with its commit, where that draws no random
numbers) and write forwards are CUDA graphs (:class:`DecodeGraphs`),
captured once for a shape and replayed by every block: a decode forward is
~3,600 small launches, which the host would otherwise take longer to issue
than the card to run.  A caller that keeps a :class:`DecodeGraphs` and
passes it to every call (``graphs=``) captures once; without one, each
call captures its own and frees it on return.  The spans inside a forward
do not record in a replay, and a kernel's ``.launches`` counts only what
the host launched; ``mmu.step`` and ``mmu.write`` do record, and the
replay adds the experts' counters (``ops/moe.count_experts``) from a
device tally the graph keeps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from mmada_parallel_torch.models.llada import (LLaDAConfig, _rope_sin_cos,
                                               block_causal_bounds,
                                               llada_head, llada_hidden,
                                               llada_hidden_partial,
                                               llada_hidden_with_cache)
from mmada_parallel_torch.ops import moe as MO
from mmada_parallel_torch.ops import sampling as S
from mmada_parallel_torch.ops.masks import ragged_positions
from mmada_parallel_torch.utils.spans import recording, span

__all__ = ["MMUOptions", "DecodeGraphs", "mmu_generate",
           "mmu_generate_fast"]


def _extend_prompt_mask(attn_mask, B: int, P: int, L: int):
    """A ``[B, P]`` prompt mask (or a ``[B, L]`` full one) -> a full-sequence
    bool mask and its re-ranked RoPE positions; the answer span is always
    real."""
    if attn_mask is None:
        return None, None
    m = attn_mask.bool()
    if m.shape[1] == P and P != L:
        m = torch.cat([m, torch.ones((B, L - P), dtype=torch.bool,
                                     device=m.device)], dim=1)
    elif m.shape[1] != L:
        raise ValueError(
            f"attn_mask length {m.shape[1]} matches neither the prompt "
            f"({P}) nor the full sequence ({L})")
    return m, ragged_positions(m)


@dataclasses.dataclass(frozen=True)
class MMUOptions:
    max_new_tokens: int = 128
    steps: int = 128
    block_length: int = 128
    temperature: float = 0.0
    cfg_scale: float = 0.0
    remasking: str = "low_confidence"
    mask_token: int = 126336


class _Decoder:
    """The state both samplers share: the initial sequence, the prompt
    mask, the per-block budget and one block step."""

    def __init__(self, params, cfg, prompt_ids, opts: MMUOptions, attn_mask,
                 generator):
        if opts.remasking == "random" and generator is None:
            raise ValueError("remasking='random' requires a generator")
        if opts.max_new_tokens % opts.block_length:
            raise ValueError("max_new_tokens must be a multiple of "
                             "block_length")
        self.num_blocks = opts.max_new_tokens // opts.block_length
        if opts.steps % self.num_blocks:
            raise ValueError("steps must be a multiple of num_blocks")
        self.spb = opts.steps // self.num_blocks       # steps per block
        self.params, self.cfg, self.opts = params, cfg, opts
        self.generator = generator
        prompt_ids = prompt_ids.long()
        B, P = prompt_ids.shape
        self.P, self.N = P, opts.max_new_tokens
        dev = prompt_ids.device
        self.x0 = torch.cat([prompt_ids, torch.full(
            (B, self.N), opts.mask_token, dtype=torch.long, device=dev)], 1)
        self.prompt_index = self.x0 != opts.mask_token
        self.attn_mask, self.pos_ids = _extend_prompt_mask(
            attn_mask, B, P, P + self.N)
        # every block starts fully masked: one static budget per block step
        # (M's front-loaded form)
        self.budgets = S.get_num_transfer_tokens_frontloaded(
            torch.full((1,), opts.block_length, device=dev), self.spb)[0]
        self.ans_pos = P + torch.arange(self.N, device=dev)[None, :]

    def answer_logits(self, x: torch.Tensor) -> torch.Tensor:
        P, N, opts = self.P, self.N, self.opts
        if opts.cfg_scale > 0.0:
            # the batched cond/uncond forward takes no attn_mask, as the
            # reference's does
            B = x.shape[0]
            un_x = torch.where(self.prompt_index,
                               torch.full_like(x, opts.mask_token), x)
            hidden = llada_hidden(self.params, self.cfg,
                                  torch.cat([x, un_x]))
            logits2 = llada_head(self.params, self.cfg, hidden[:, P:P + N])
            cond, uncond = logits2[:B], logits2[B:]
            return uncond + (opts.cfg_scale + 1) * (cond - uncond)
        hidden = llada_hidden(self.params, self.cfg, x, self.attn_mask,
                              self.pos_ids)
        return llada_head(self.params, self.cfg, hidden[:, P:P + N])

    def step(self, x: torch.Tensor, block: int, step_in_block: int
             ) -> torch.Tensor:
        P, N = self.P, self.N
        bend = P + (block + 1) * self.opts.block_length
        x = x.clone()
        # the commit over the whole answer span, the positions beyond the
        # current block out of reach: its random draws are of the span's
        # shape, as the JAX sampler's are
        x[:, P:P + N] = _commit(x[:, P:P + N], self.answer_logits(x),
                                self.budgets[step_in_block], self.opts,
                                self.generator, beyond=self.ans_pos >= bend)
        return x

    @property
    def random(self) -> bool:
        """True where a commit draws from the generator."""
        return self.opts.remasking == "random" or (
            self.generator is not None and self.opts.temperature != 0)


def _commit(cur: torch.Tensor, logits: torch.Tensor, budget: torch.Tensor,
            opts: MMUOptions, gen: Optional[torch.Generator],
            beyond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A step's commit: ``cur [B, n]`` the ids, ``logits [B, n, V]`` their
    logits, ``budget`` the step's count (a device scalar); returns ``cur``
    with that many masked slots filled, never one where ``beyond`` (``[B,
    n]`` or broadcast to it) is set: confidence beyond the current block
    boundary is ``-inf``."""
    mask_index = cur == opts.mask_token
    u = (S.uniform_noise(logits, gen)
         if gen is not None and opts.temperature != 0 else None)
    x0 = S.gumbel_argmax(logits, opts.temperature, u)
    if opts.remasking == "low_confidence":
        conf = S.token_confidence(logits, x0)
    else:
        conf = S.uniform_noise(x0, gen, dtype=torch.float32)
    neg = torch.full_like(conf, S.NEG_INF)
    if beyond is not None:
        conf = torch.where(beyond, neg, conf)
    x0 = torch.where(mask_index, x0, cur)
    conf = torch.where(mask_index, conf, neg)
    k = budget.expand(cur.shape[0])
    return torch.where(S.topk_transfer_mask(conf, k), x0, cur)


def _check_block_causal(dec: _Decoder, attn_mask) -> None:
    cfg, opts = dec.cfg, dec.opts
    if opts.block_length != cfg.block_length:
        raise ValueError(f"block_length {opts.block_length}: the model's "
                         f"blocks are {cfg.block_length}")
    if opts.cfg_scale > 0.0:
        raise NotImplementedError("CFG on the block-causal route")
    if attn_mask is not None and not bool(attn_mask.bool().all()):
        raise NotImplementedError("padded prompts on the block-causal "
                                  "route: K4 bounds keys from above only")


class DecodeGraphs:
    """The block-causal route's decode forwards as CUDA graphs, for a
    caller to keep between calls (``graphs=`` of :func:`mmu_generate` and
    :func:`mmu_generate_fast`): the step (the partial forward over the
    block's positions, the head and, where it draws no random numbers, the
    commit) and the write (the partial forward alone), over static inputs:
    the block's ids, positions, key bounds and step budget, and a k/v cache
    of every position (the prefill writes into it).  Each is captured at
    its first run, after one eager warm-up on a side stream, and replayed
    by every block of every later call of the same model, shape and
    options; another model, shape or options captures anew and drops the
    old graphs.  The object holds the model's parameters and the cache
    while it lives: drop it to free them.  ``replays`` counts the replays;
    while the profiler records, a replay adds the experts' counters from
    ``self.touched`` (the graph zeroes it and each layer adds its touched
    experts).  A replay's outputs are overwritten by the next."""

    def __init__(self):
        self.key = self.params = None
        self.graphs = {}
        self.replays = 0

    def bind(self, dec: _Decoder, B: int, L: int, device) -> "DecodeGraphs":
        """Ready for ``dec``'s calls at ``[B, L]``: keeps the graphs of the
        same model, shape and options, else allocates anew."""
        cfg, opts = dec.cfg, dec.opts
        key = (cfg, opts, not dec.random, B, L, str(device))
        if self.params is dec.params and self.key == key:
            return self
        self.graphs = {}                # the old graphs and cache go first
        self.cache = None
        self.key, self.params, self.cfg, self.opts = key, dec.params, cfg, \
            opts
        self.commits = not dec.random
        bl = opts.block_length
        shape = (cfg.n_layers, B, L,
                 cfg.effective_n_kv_heads * cfg.head_dim)
        self.cache = {n: torch.zeros(shape, dtype=cfg.compute_dtype,
                                     device=device) for n in ("k", "v")}
        self.ids = torch.zeros((B, bl), dtype=torch.long, device=device)
        self.pos = torch.zeros((B, bl), dtype=torch.long, device=device)
        self.hi = torch.zeros((B, bl), dtype=torch.int32, device=device)
        self.budget = torch.zeros((), dtype=torch.long, device=device)
        self.tables = _rope_sin_cos(L, cfg.head_dim, cfg.rope_theta, device)
        self.touched = torch.zeros((), dtype=torch.long, device=device)
        self.pool = torch.cuda.graph_pool_handle()
        return self

    def _forward(self, step: bool):
        h, _ = llada_hidden_partial(self.params, self.cfg, self.ids,
                                    self.pos, self.cache, kv_hi=self.hi,
                                    tables=self.tables)
        if not step:
            return h
        logits = llada_head(self.params, self.cfg, h)
        new = (_commit(self.ids, logits, self.budget, self.opts, None)
               if self.commits else None)
        return new, logits

    def _capture(self, step: bool):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._forward(step)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.touched.zero_()
                MO.TALLY = self.touched
                out = self._forward(step)
        finally:
            MO.TALLY = None
        return graph, out

    def _replay(self, step: bool):
        if step not in self.graphs:
            self.graphs[step] = self._capture(step)
        graph, out = self.graphs[step]
        graph.replay()
        self.replays += 1
        if recording():
            cfg, B, bl = self.cfg, self.ids.shape[0], self.ids.shape[1]
            MO.count_experts(cfg.n_layers, B * bl, cfg.d_model,
                             cfg.moe_hidden_size,
                             B * bl * cfg.experts_per_token,
                             self.touched.clone(),
                             self.cache["k"].element_size())
        return out

    def step(self, block: torch.Tensor, budget: torch.Tensor,
             gen: Optional[torch.Generator]):
        """A step of ``block`` at ``budget``: ``(the block's new ids, its
        logits)``."""
        self.ids.copy_(block)
        self.budget.copy_(budget)
        new, logits = self._replay(True)
        if new is None:
            new = _commit(self.ids, logits, self.budget, self.opts, gen)
        return new, logits

    def write(self, block: torch.Tensor) -> None:
        """The write forward of the finished ``block``."""
        self.ids.copy_(block)
        self._replay(False)


def _block_step(dec: _Decoder, graphs: Optional[DecodeGraphs],
                block: torch.Tensor, pos: torch.Tensor, hi: torch.Tensor,
                cache, i: int):
    """Step ``i`` of the block whose ids are ``block [B, bl]`` at ``pos``,
    seeing keys below ``hi``: its forward, its head and its commit, as a
    graph replay or eagerly.  Returns ``(the block's new ids, its
    logits)``."""
    if graphs is not None:
        return graphs.step(block, dec.budgets[i], dec.generator)
    h, _ = llada_hidden_partial(dec.params, dec.cfg, block, pos, cache,
                                kv_hi=hi)
    logits = llada_head(dec.params, dec.cfg, h)
    return _commit(block, logits, dec.budgets[i], dec.opts,
                   dec.generator), logits


def _eot_check(last: torch.Tensor, eot_token: int):
    """Start reading whether every row's ``last`` token is ``eot_token``:
    on a card, an asynchronous copy to pinned memory and its event, so
    that waiting for it later waits for nothing queued after it."""
    done = (last == eot_token).all()
    if not done.is_cuda:
        return done, None
    host = torch.empty((), dtype=torch.bool, pin_memory=True)
    host.copy_(done, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _eot_read(check) -> bool:
    host, event = check
    if event is not None:
        event.synchronize()
    return bool(host)


def _generate_block_causal(dec: _Decoder, eot_token: Optional[int],
                           graphs: Optional[DecodeGraphs]) -> torch.Tensor:
    """The cached route of a ``block_causal`` config (module docstring),
    its decode forwards through ``graphs`` (or graphs of its own) on a
    card and eagerly on the CPU; with ``eot_token`` it stops after a block
    whose last token is ``eot_token`` in every row.  That check lags a block: block ``b``'s
    work is queued before the host waits for block ``b - 1``'s answer, so
    the card never drains; where ``b - 1`` ended it, block ``b`` goes back
    to the mask, as if never computed."""
    params, cfg, opts = dec.params, dec.cfg, dec.opts
    P, bl = dec.P, opts.block_length
    x = dec.x0.clone()
    B, L = x.shape
    graphs = ((graphs or DecodeGraphs()).bind(dec, B, L, x.device)
              if x.is_cuda else None)
    with span("mmu.prefill"):
        bounds = block_causal_bounds(L, P, bl, x.device)
        _, cache = llada_hidden_with_cache(
            params, cfg, x[:, :P], kv_hi=bounds[:P], cache_len=L,
            out=graphs.cache if graphs is not None else None)
    stop = None                 # the last block's eot check, under way
    for block in range(dec.num_blocks):
        bs = P + block * bl
        pos = torch.arange(bs, bs + bl, device=x.device).expand(B, bl)
        hi = torch.full((B, bl), bs + bl, dtype=torch.int32, device=x.device)
        if graphs is not None:
            graphs.pos.copy_(pos)
            graphs.hi.copy_(hi)
        for i in range(dec.spb):
            with span("mmu.step"):
                x[:, bs:bs + bl], _ = _block_step(
                    dec, graphs, x[:, bs:bs + bl], pos, hi, cache, i)
        with span("mmu.write"):
            if graphs is not None:
                graphs.write(x[:, bs:bs + bl])
            else:
                llada_hidden_partial(params, cfg, x[:, bs:bs + bl], pos,
                                     cache, kv_hi=hi)
        if eot_token is None:
            continue
        if stop is not None and _eot_read(stop):
            x[:, bs:bs + bl] = opts.mask_token
            break
        stop = _eot_check(x[:, bs + bl - 1], eot_token)
    return x


@torch.inference_mode()
def mmu_generate(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    prompt_ids: torch.Tensor,
    opts: MMUOptions = MMUOptions(),
    attn_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    graphs: Optional[DecodeGraphs] = None,
) -> torch.Tensor:
    """Returns the full ``[B, prompt_len + max_new_tokens]`` sequence.

    ``attn_mask`` (``[B, prompt_len]`` bool, True = real; a full-sequence
    mask is also accepted) enables ragged batched prompts: pads are hidden
    from attention and RoPE positions re-ranked, so each row generates what
    its unpadded single run would.  With ``cfg_scale > 0`` the batched
    cond/uncond forward runs without ``attn_mask``, as the reference's
    does.  A ``block_causal`` config takes the cached route (module
    docstring), which takes neither CFG nor padded prompts; on a card its
    decode forwards replay ``graphs``, which a caller keeps to capture
    them once (other configs ignore it)."""
    dec = _Decoder(params, cfg, prompt_ids, opts, attn_mask, generator)
    if cfg.attention == "block_causal":
        _check_block_causal(dec, attn_mask)
        return _generate_block_causal(dec, None, graphs)
    x = dec.x0
    for block in range(dec.num_blocks):
        for i in range(dec.spb):
            x = dec.step(x, block, i)
    return x


@torch.inference_mode()
def mmu_generate_fast(
    params: Dict[str, Any],
    cfg: LLaDAConfig,
    prompt_ids: torch.Tensor,
    opts: MMUOptions = MMUOptions(),
    eot_token: Optional[int] = None,
    attn_mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    graphs: Optional[DecodeGraphs] = None,
) -> torch.Tensor:
    """:func:`mmu_generate` that stops after a block whose final token is
    ``eot_token`` in every row (one host sync per block, a block late on the
    block-causal route); the blocks after it stay masked.
    ``eot_token=None`` is :func:`mmu_generate`."""
    if eot_token is None:
        return mmu_generate(params, cfg, prompt_ids, opts, attn_mask,
                            generator, graphs)
    dec = _Decoder(params, cfg, prompt_ids, opts, attn_mask, generator)
    if cfg.attention == "block_causal":
        _check_block_causal(dec, attn_mask)
        return _generate_block_causal(dec, eot_token, graphs)
    x = dec.x0
    for block in range(dec.num_blocks):
        for i in range(dec.spb):
            x = dec.step(x, block, i)
        bend = dec.P + (block + 1) * opts.block_length
        if bool((x[:, bend - 1] == eot_token).all()):
            break
    return x
