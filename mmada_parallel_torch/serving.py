"""Continuous-batching servers for both variants, on PyTorch/CUDA.

Counterpart of :mod:`mmada_parallel_tpu.serving`: a request queue drained by
one worker thread that owns the device, groups requests into prompt-length
buckets, pads each bucket to one layout and runs one ragged-batch sampler
call per group.  The padding mask (and, where the sampler re-ranks them, the
RoPE positions) make each row decode what its unpadded solo run would, at
temperature 0; sampled runs share one generator per server.

* :class:`TI2TIServer` -- variant-A edits over ``generate_ti2ti``;
* :class:`InterleaveServer` -- variant-M interleave generation over
  ``interleave_generate`` (or, with ``use_cache``, the cached sampler), with
  batched MagViT encodes of request images on the worker thread;
* :class:`T2IServer` -- variant-M text-to-image over ``t2i_generate``;
* :class:`MMUServer` -- variant-M understanding over ``mmu_generate``.

The worker calls the samplers, which run under ``torch.inference_mode()``
themselves (grad mode is per thread), on tensors it puts on the server's
device: the device of the params, named explicitly, never the thread's
current one.  ``warmup`` runs each named bucket's sampler once on pad rows,
which builds the attention kernels and warms cuBLAS and cuDNN, and records
the bucket.  Producer threads only enqueue and wait.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmada_parallel_torch import tokens as tk
from mmada_parallel_torch.models.llada import LLaDAConfig
from mmada_parallel_torch.samplers.interleave import (
    InterleaveOptions, interleave_generate, interleave_generate_cached)
from mmada_parallel_torch.samplers.mmu import MMUOptions, mmu_generate
from mmada_parallel_torch.samplers.parallel_ti2ti import (TI2TIOptions,
                                                          decode_text,
                                                          generate_ti2ti)
from mmada_parallel_torch.samplers.t2i import T2IOptions, t2i_generate

__all__ = ["ServeConfig", "TI2TIServer", "InterleaveServer", "T2IServer",
           "MMUServer"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    grid_hw: Tuple[int, int] = (32, 32)     # 512x512 at stride 16 (A)
    text_gen_length: int = 256
    end_token_ids: Tuple[int, ...] = (126355,)
    batch_size: int = 4
    max_wait_ms: float = 50.0
    bucket_quantum: int = 64                # prompt lengths round up to this
    max_prompt_len: int = 1024


class _Pending:
    __slots__ = ("payload", "event", "result", "error", "cancelled")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.cancelled = False   # submit() timed out; skip if still queued


def _round_bucket(n: int, quantum: int, cap: int) -> int:
    return min(-(-max(n, 1) // quantum) * quantum, cap)


class _BatchServerBase:
    """Queue, device-owning worker and bucket grouping.

    Subclasses implement ``_bucket_of(payload) -> int`` and
    ``_serve_group(bucket, group)`` (which sets each pending's ``result``
    and ``event``), and ``_warm_bucket(bucket)`` for :meth:`warmup`."""

    def __init__(self, params: Any, batch_size: int, max_wait_ms: float,
                 deterministic: bool, seed: int):
        self.params = params
        self.device = params["wte"].device
        self._batch_size = batch_size
        self._max_wait_ms = max_wait_ms
        # nothing samples: fully deterministic (no generator), the parity
        # configuration
        self._generator = (None if deterministic else torch.Generator(
            device=self.device).manual_seed(seed))
        self.warm_buckets: set = set()
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stats = {"requests": 0, "batches": 0, "batched_rows": 0}
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _submit(self, payload, timeout: Optional[float]) -> Any:
        p = _Pending(payload)
        self._q.put(p)
        if not p.event.wait(timeout):
            # abandoned: the worker drops it instead of running a batch
            # whose result nobody reads
            p.cancelled = True
            raise TimeoutError("request did not complete in time")
        if p.error is not None:
            raise p.error
        return p.result

    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _account(self, group: List[_Pending]) -> None:
        self._stats["requests"] += len(group)
        self._stats["batches"] += 1
        self._stats["batched_rows"] += self._batch_size

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.time() + self._max_wait_ms / 1e3
            while len(batch) < self._batch_size:
                left = deadline - time.time()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            # one sampler call per bucket; abandoned requests are dropped
            groups: Dict[int, List[_Pending]] = {}
            for p in batch:
                if p.cancelled:
                    continue
                groups.setdefault(self._bucket_of(p.payload), []).append(p)
            for bucket, group in groups.items():
                try:
                    self._serve_group(bucket, group)
                except BaseException as e:  # deliver, don't kill the worker
                    for p in group:
                        p.error, _ = e, p.event.set()

    def _warm(self, buckets) -> None:
        for b in buckets:
            if b not in self.warm_buckets:
                self._warm_bucket(b)
                self.warm_buckets.add(b)

    # -- subclass hooks
    def _bucket_of(self, payload) -> int:
        raise NotImplementedError

    def _serve_group(self, bucket: int, group: List[_Pending]) -> None:
        raise NotImplementedError

    def _warm_bucket(self, bucket: int) -> None:
        raise NotImplementedError


def _decode_answer(tokenizer, text_ids: np.ndarray, mask_token: int):
    """Decoded text without mask tokens, or the ids with no tokenizer."""
    if tokenizer is None or not hasattr(tokenizer, "decode"):
        return text_ids
    return tokenizer.decode([int(t) for t in text_ids
                             if int(t) != mask_token],
                            skip_special_tokens=True)


class TI2TIServer(_BatchServerBase):
    """Variant-A thinking-aware edit server over ``generate_ti2ti``.

    ``submit(prompt_ids)`` blocks until the edit is done and returns
    ``{"text_ids", "codes", "text"}``; call it from any number of threads.
    Rows are the prompt right-padded to the bucket with pads hidden by the
    mask."""

    def __init__(self, params: Any, cfg: LLaDAConfig,
                 opts: TI2TIOptions = TI2TIOptions(),
                 serve: ServeConfig = ServeConfig(),
                 tokenizer: Any = None,
                 uncond_image_prefix: Optional[np.ndarray] = None,
                 tokens: tk.VariantATokens = tk.TOKENS_A,
                 seed: int = 0):
        self.cfg, self.opts = cfg, opts
        self.serve, self.tokens = serve, tokens
        self.tokenizer = tokenizer
        self.uncond_image_prefix = uncond_image_prefix
        self._layouts: Dict[int, tk.SequenceLayout] = {}
        super().__init__(params, serve.batch_size, serve.max_wait_ms,
                         opts.temperature == 0.0
                         and opts.text_temperature == 0.0
                         and opts.remasking != "random", seed)

    def submit(self, prompt_ids: Sequence[int],
               timeout: Optional[float] = None) -> Dict[str, Any]:
        if len(prompt_ids) > self.serve.max_prompt_len:
            raise ValueError(
                f"prompt length {len(prompt_ids)} exceeds max_prompt_len "
                f"{self.serve.max_prompt_len}")
        return self._submit(list(prompt_ids), timeout)

    def warmup(self, prompt_lens: Sequence[int]) -> None:
        """Run the buckets of these prompt lengths once on pad rows."""
        self._warm(self._bucket_of([0] * n) for n in prompt_lens)

    def _bucket_of(self, payload) -> int:
        return _round_bucket(len(payload), self.serve.bucket_quantum,
                             self.serve.max_prompt_len)

    def _row(self, prompt: List[int]):
        gh, gw = self.serve.grid_hw
        return tk.assemble_ti2ti_sequence(
            prompt, self.serve.text_gen_length, gh, gw,
            list(self.serve.end_token_ids), tokens=self.tokens)

    def _layout(self, plen: int) -> tk.SequenceLayout:
        if plen not in self._layouts:
            self._layouts[plen] = self._row([self.tokens.pad] * plen)[1]
        return self._layouts[plen]

    def _generate(self, plen: int, prompts: List[List[int]]):
        """One ragged batch of ``batch_size`` rows (the last prompt repeats
        to fill it) -> host ``(final ids, codes)``."""
        layout = self._layout(plen)
        B = self._batch_size
        ids = np.zeros((B, layout.total_len), np.int64)
        mask = np.ones((B, layout.total_len), bool)
        for i in range(B):
            prompt = prompts[min(i, len(prompts) - 1)]
            n = len(prompt)
            ids[i] = self._row(prompt + [self.tokens.pad] * (plen - n))[0]
            mask[i, n:plen] = False
        fin, codes = generate_ti2ti(
            self.params, self.cfg, self._tensor(ids), layout, self.opts,
            uncond_image_prefix=self.uncond_image_prefix,
            generator=self._generator, attn_mask=self._tensor(mask))
        return fin.cpu().numpy(), codes.cpu().numpy()

    def _warm_bucket(self, plen: int) -> None:
        self._generate(plen, [[self.tokens.pad] * plen])

    def _serve_group(self, plen: int, group: List[_Pending]) -> None:
        layout = self._layout(plen)
        fin, codes = self._generate(plen, [p.payload for p in group])
        self._account(group)
        for i, p in enumerate(group):
            p.result = {
                "text_ids": fin[i, layout.text_start:layout.text_end],
                "codes": codes[i],
                "text": decode_text(fin[i], layout, self.opts,
                                    self.tokenizer),
            }
            p.event.set()


class InterleaveServer(_BatchServerBase):
    """Variant-M interleave-generation server over ``interleave_generate``.

    ``submit(instr_ids, codes=..., image=...)`` blocks until generation is
    done and returns ``{"text_ids", "codes", "text"}``.  ``codes`` are
    vocab-offset image tokens (``[num_vq_tokens]``); pass ``image`` (``[R,
    R, 3]`` pixels in [-1, 1]) instead to have the worker batch-encode it
    through ``get_code`` (``[B, R, R, 3]`` -> codes ``[B, N]``).

    Rows follow the reference template: ``[<|interleave|>][<|soi|>] codes
    [<|eoi|>] instruction``, the instruction bos/eos-normalised and
    eos-padded to the bucket behind the mask.  The uncond row zeroes the
    image span (literal token 0), takes ``[bos, eos]`` for the instruction
    and eos-pads it, attended, to the cond instruction's true length; only
    bucket padding beyond that is hidden.  ``use_cache=True`` serves through
    the cached sampler, which takes no mask: requests then group by exact
    length."""

    def __init__(self, params: Any, cfg: LLaDAConfig,
                 opts: InterleaveOptions = InterleaveOptions(),
                 num_vq_tokens: int = 1024,
                 max_seq_length: int = 256,
                 batch_size: int = 4, max_wait_ms: float = 50.0,
                 bucket_quantum: int = 32, max_instr_len: int = 512,
                 tokenizer: Any = None,
                 get_code: Optional[Callable] = None,
                 tokens: tk.VariantMTokens = tk.TOKENS_M,
                 seed: int = 0,
                 use_cache: bool = False,
                 cache_kw: Optional[Dict[str, Any]] = None):
        self.use_cache = use_cache
        self.cache_kw = dict(cache_kw or {})
        self.cfg, self.opts = cfg, opts
        self.num_vq_tokens = num_vq_tokens
        self.max_seq_length = max_seq_length
        self.bucket_quantum = bucket_quantum
        self.max_instr_len = max_instr_len
        self.tokenizer = tokenizer
        self.get_code = get_code
        self.tokens = tokens
        self._layouts: Dict[int, tk.SequenceLayout] = {}
        _bos = getattr(tokenizer, "bos_token_id", None)
        _eos = getattr(tokenizer, "eos_token_id", None)
        self._bos = tokens.bos if _bos is None else int(_bos)
        self._eos = tokens.eos if _eos is None else int(_eos)
        raw_uncond = (list(tokenizer("")["input_ids"])
                      if tokenizer is not None else [])
        self._uncond_ids = self._normalize(raw_uncond)  # typically [bos,eos]
        if len(self._uncond_ids) > max_instr_len:
            raise ValueError(
                f"normalized uncond prompt ({len(self._uncond_ids)} tokens) "
                f"exceeds max_instr_len {max_instr_len}")
        super().__init__(params, batch_size, max_wait_ms,
                         opts.text_temperature == 0.0
                         and opts.image_temperature == 0.0
                         and opts.remasking != "random", seed)

    def _normalize(self, ids: Sequence[int]) -> List[int]:
        """bos prefix and eos suffix guard of the reference template."""
        return tk.normalize_text_ids(ids, self._bos, self._eos)

    def submit(self, instr_ids: Sequence[int],
               codes: Optional[np.ndarray] = None,
               image: Optional[Any] = None,
               timeout: Optional[float] = None) -> Dict[str, Any]:
        if (codes is None) == (image is None):
            raise ValueError("pass exactly one of codes= or image=")
        instr = self._normalize(instr_ids)
        if len(instr) > self.max_instr_len:
            raise ValueError(
                f"instruction length {len(instr)} (bos/eos-normalized) "
                f"exceeds max_instr_len {self.max_instr_len}")
        if self.use_cache and len(instr) < len(self._uncond_ids):
            raise ValueError(
                "use_cache=True cannot serve an instruction shorter than "
                "the normalized uncond prompt (the cond row would need "
                "mask-hidden padding, which the cached sampler does not "
                "take)")
        if codes is not None:
            codes = np.asarray(codes).reshape(-1)
            if codes.shape[0] != self.num_vq_tokens:
                raise ValueError(
                    f"codes has {codes.shape[0]} tokens, server expects "
                    f"{self.num_vq_tokens}")
        return self._submit({"instr": instr, "codes": codes, "image": image},
                            timeout)

    def warmup(self, instr_lens: Sequence[int]) -> None:
        """Run the buckets of these instruction lengths (bos/eos-normalised
        first, as :meth:`submit` does) once on pad rows."""
        self._warm(self._bucket_of({"instr": self._normalize([0] * n)})
                   for n in instr_lens)

    def _bucket_of(self, payload) -> int:
        # the bucket must also fit the uncond tail
        n = max(len(payload["instr"]), len(self._uncond_ids))
        if self.use_cache:
            return n          # exact attend length: no hidden padding
        return _round_bucket(n, self.bucket_quantum, self.max_instr_len)

    def _layout(self, ilen: int) -> tk.SequenceLayout:
        if ilen not in self._layouts:
            T = self.tokens
            prompt_len = 3 + self.num_vq_tokens + ilen
            self._layouts[ilen] = tk.assemble_interleave_sequence(
                [T.eos] * prompt_len, self.num_vq_tokens,
                self.max_seq_length, tokens=T)[1]
        return self._layouts[ilen]

    def _generate(self, ilen: int, rows: List[Tuple[List[int], List[int]]]):
        """One batch of ``(instruction, codes)`` rows -> host ``(final ids,
        codes)``."""
        T = self.tokens
        layout = self._layout(ilen)
        B = self._batch_size
        L = layout.total_len
        ids = np.zeros((B, L), np.int64)
        un_ids = np.zeros((B, L), np.int64)
        mask = np.ones((B, L), bool)
        un_mask = np.ones((B, L), bool)
        zero_codes = [0] * self.num_vq_tokens
        for i in range(B):
            instr, codes = rows[min(i, len(rows) - 1)]
            head = [T.interleave, T.soi] + codes + [T.eoi]
            un_head = [T.interleave, T.soi] + zero_codes + [T.eoi]
            attend = max(len(instr), len(self._uncond_ids))
            un_tail = (self._uncond_ids
                       + [self._eos] * (attend - len(self._uncond_ids)))
            prompt = head + instr + [self._eos] * (ilen - len(instr))
            un_prompt = un_head + un_tail + [self._eos] * (ilen - attend)
            ids[i] = tk.assemble_interleave_sequence(
                prompt, self.num_vq_tokens, self.max_seq_length, tokens=T)[0]
            un_ids[i] = tk.assemble_interleave_sequence(
                un_prompt, self.num_vq_tokens, self.max_seq_length,
                tokens=T)[0]
            mask[i, len(head) + len(instr):len(head) + ilen] = False
            un_mask[i, len(head) + attend:len(head) + ilen] = False
        args = (self.params, self.cfg, self._tensor(ids),
                self._tensor(un_ids), layout, self.opts)
        if self.use_cache:
            fin, out = interleave_generate_cached(
                *args, generator=self._generator, **self.cache_kw)
        else:
            fin, out = interleave_generate(
                *args, generator=self._generator,
                attn_mask=self._tensor(mask),
                uncond_attn_mask=self._tensor(un_mask))
        return fin.cpu().numpy(), out.cpu().numpy()

    def _warm_bucket(self, ilen: int) -> None:
        self._generate(ilen, [([self._eos] * ilen,
                               [self.tokens.vq_offset] * self.num_vq_tokens)])

    def _encode_images(self, group: List[_Pending]) -> List[_Pending]:
        """Batch-encode the group's image submissions on this thread; a bad
        image fails only its own submitters.  Returns the servable rest."""
        to_encode = [p for p in group if p.payload["codes"] is None]
        if not to_encode:
            return group
        err = None
        if self.get_code is None:
            err = ValueError("image= submitted but server has no get_code "
                             "encoder (pass get_code= / --vq_checkpoint)")
        else:
            px = torch.stack([torch.as_tensor(np.asarray(p.payload["image"]),
                                              dtype=torch.float32)
                              for p in to_encode]).to(self.device)
            enc = (torch.as_tensor(self.get_code(px)).cpu().numpy()
                   + self.tokens.vq_offset)
            if enc.shape[1] != self.num_vq_tokens:
                err = ValueError(
                    f"encoder produced {enc.shape[1]} codes per image; "
                    f"server expects num_vq_tokens={self.num_vq_tokens} "
                    "(check --resolution vs --num_vq_tokens)")
            else:
                for row, p in enumerate(to_encode):
                    p.payload["codes"] = enc[row]
        if err is not None:
            for p in to_encode:
                p.error, _ = err, p.event.set()
        return [p for p in group if p.payload["codes"] is not None]

    def _serve_group(self, ilen: int, group: List[_Pending]) -> None:
        group = self._encode_images(group)
        if not group:
            return
        layout = self._layout(ilen)
        fin, codes = self._generate(
            ilen, [(p.payload["instr"], [int(c) for c in p.payload["codes"]])
                   for p in group])
        self._account(group)
        for i, p in enumerate(group):
            text_ids = fin[i, layout.text_start:layout.text_end]
            p.result = {"text_ids": text_ids, "codes": codes[i],
                        "text": _decode_answer(self.tokenizer, text_ids,
                                               self.opts.mask_token)}
            p.event.set()


class T2IServer(_BatchServerBase):
    """Variant-M text-to-image server over ``t2i_generate``.

    ``submit(text_ids)`` returns ``{"codes"}`` (raw codebook indices).  Rows
    follow the reference t2i template: ``[<|t2i|>] bos text eos``
    left-padded with ``ipad`` to the bucket (pads hidden), then ``[soi]
    MASK*n [eoi]``; the CFG negative is ``[<|t2i|>, bos, eos]``."""

    def __init__(self, params: Any, cfg: LLaDAConfig,
                 opts: Optional[T2IOptions] = None,
                 num_vq_tokens: int = 1024,
                 batch_size: int = 4, max_wait_ms: float = 50.0,
                 bucket_quantum: int = 32, max_text_len: int = 512,
                 tokenizer: Any = None,
                 tokens: tk.VariantMTokens = tk.TOKENS_M,
                 seed: int = 0):
        self.cfg = cfg
        self.opts = opts if opts is not None else T2IOptions()
        self.num_vq_tokens = num_vq_tokens
        self.bucket_quantum = bucket_quantum
        self.max_text_len = max_text_len
        self.tokenizer = tokenizer
        self.tokens = tokens
        _bos = getattr(tokenizer, "bos_token_id", None)
        _eos = getattr(tokenizer, "eos_token_id", None)
        self._bos = tokens.bos if _bos is None else int(_bos)
        self._eos = tokens.eos if _eos is None else int(_eos)
        super().__init__(params, batch_size, max_wait_ms,
                         self.opts.temperature == 0.0, seed)

    def _temp(self, text_ids: Sequence[int]) -> List[int]:
        """``[t2i] bos text eos``."""
        return [self.tokens.t2i] + tk.normalize_text_ids(
            text_ids, self._bos, self._eos)

    def submit(self, text_ids: Sequence[int],
               timeout: Optional[float] = None) -> Dict[str, Any]:
        temp = self._temp(text_ids)
        if len(temp) > self.max_text_len:
            raise ValueError(f"templated prompt length {len(temp)} exceeds "
                             f"max_text_len {self.max_text_len}")
        return self._submit({"temp": temp}, timeout)

    def warmup(self, text_lens: Sequence[int]) -> None:
        """Run the buckets of these text lengths (templated first, as
        :meth:`submit` does) once on pad rows."""
        self._warm(self._bucket_of({"temp": self._temp([0] * n)})
                   for n in text_lens)

    def _bucket_of(self, payload) -> int:
        return _round_bucket(len(payload["temp"]), self.bucket_quantum,
                             self.max_text_len)

    def _generate(self, plen: int, temps: List[List[int]]) -> np.ndarray:
        T = self.tokens
        B = self._batch_size
        tail = [T.soi] + [self.opts.mask_token] * self.num_vq_tokens + [T.eoi]
        L = plen + len(tail)
        un_temp = [T.t2i, self._bos, self._eos]
        ids = np.zeros((B, L), np.int64)
        un_ids = np.zeros((B, L), np.int64)
        mask = np.zeros((B, L), bool)
        un_mask = np.zeros((B, L), bool)
        un_row = [T.ipad] * (plen - len(un_temp)) + un_temp + tail
        for i in range(B):
            temp = temps[min(i, len(temps) - 1)]
            pad = plen - len(temp)
            ids[i] = [T.ipad] * pad + temp + tail
            mask[i, pad:] = True
            un_ids[i] = un_row
            un_mask[i, plen - len(un_temp):] = True
        return t2i_generate(
            self.params, self.cfg, self._tensor(ids), self._tensor(un_ids),
            plen, self.num_vq_tokens, self.opts,
            attn_mask=self._tensor(mask), uncond_attn_mask=self._tensor(
                un_mask), generator=self._generator).cpu().numpy()

    def _warm_bucket(self, plen: int) -> None:
        self._generate(plen, [[self.tokens.ipad] * plen])

    def _serve_group(self, plen: int, group: List[_Pending]) -> None:
        codes = self._generate(plen, [p.payload["temp"] for p in group])
        self._account(group)
        for i, p in enumerate(group):
            p.result = {"codes": codes[i]}
            p.event.set()


class MMUServer(_BatchServerBase):
    """Variant-M multimodal-understanding server over ``mmu_generate``.

    ``submit(prompt_ids)`` takes the assembled MMU prompt (``[<|mmu|>][soi]
    image [eoi]`` + question) and returns ``{"text_ids", "text"}``, the
    generated answer span.  Prompts are right-padded to their bucket behind
    the sampler's ``attn_mask`` (pads hidden, positions re-ranked).  With
    ``cfg_scale > 0`` the sampler's CFG forward takes no mask, so requests
    then group by exact prompt length."""

    def __init__(self, params: Any, cfg: LLaDAConfig,
                 opts: Optional[MMUOptions] = None,
                 batch_size: int = 4, max_wait_ms: float = 50.0,
                 bucket_quantum: int = 64, max_prompt_len: int = 2048,
                 tokenizer: Any = None,
                 tokens: tk.VariantMTokens = tk.TOKENS_M,
                 seed: int = 0):
        self.cfg = cfg
        self.opts = opts if opts is not None else MMUOptions()
        self.bucket_quantum = bucket_quantum
        self.max_prompt_len = max_prompt_len
        self.tokenizer = tokenizer
        self.tokens = tokens
        super().__init__(params, batch_size, max_wait_ms,
                         self.opts.temperature == 0.0
                         and self.opts.remasking != "random", seed)

    def submit(self, prompt_ids: Sequence[int],
               timeout: Optional[float] = None) -> Dict[str, Any]:
        if len(prompt_ids) > self.max_prompt_len:
            raise ValueError(f"prompt length {len(prompt_ids)} exceeds "
                             f"max_prompt_len {self.max_prompt_len}")
        return self._submit({"prompt": list(prompt_ids)}, timeout)

    def warmup(self, prompt_lens: Sequence[int]) -> None:
        """Run the buckets of these prompt lengths once on pad rows."""
        self._warm(self._bucket_of({"prompt": [0] * n}) for n in prompt_lens)

    def _bucket_of(self, payload) -> int:
        if self.opts.cfg_scale > 0:
            return len(payload["prompt"])   # the CFG forward takes no mask
        return _round_bucket(len(payload["prompt"]), self.bucket_quantum,
                             self.max_prompt_len)

    def _generate(self, plen: int, prompts: List[List[int]]) -> np.ndarray:
        B = self._batch_size
        ids = np.full((B, plen), self.tokens.eos, np.int64)
        mask = np.zeros((B, plen), bool)
        for i in range(B):
            prompt = prompts[min(i, len(prompts) - 1)]
            ids[i, :len(prompt)] = prompt
            mask[i, :len(prompt)] = True
        return mmu_generate(self.params, self.cfg, self._tensor(ids),
                            self.opts, attn_mask=self._tensor(mask),
                            generator=self._generator).cpu().numpy()

    def _warm_bucket(self, plen: int) -> None:
        self._generate(plen, [[self.tokens.eos] * plen])

    def _serve_group(self, plen: int, group: List[_Pending]) -> None:
        out = self._generate(plen, [p.payload["prompt"] for p in group])
        self._account(group)
        for i, p in enumerate(group):
            text_ids = out[i, plen:]
            p.result = {"text_ids": text_ids,
                        "text": _decode_answer(self.tokenizer, text_ids,
                                               self.opts.mask_token)}
            p.event.set()
