"""Python face of the native token store (ctypes, no pybind).

Writer packs pre-tokenized sequences into the mmap format of
``native/tokenstore.cc``; the reader gathers padded batches through the C
API with the GIL released, and :class:`PrefetchLoader` overlaps host batch
assembly with device steps using one background thread -- the one-process
replacement for the reference's 16 DataLoader worker processes
(``finetune.py:415-441``).

Counterpart of :mod:`mmada_parallel_tpu.data.tokenstore`, copied so that the
port imports nothing of the JAX package.  The library is built with ``g++
-O2 -shared -fPIC`` into ``mmada_parallel_torch/_build/`` at first use
(:mod:`mmada_parallel_torch.data._native`).
"""

from __future__ import annotations

import ctypes
import queue
import threading
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from mmada_parallel_torch.data import _native

__all__ = ["write_token_store", "TokenStore", "PrefetchLoader"]

_MAGIC = 0x544F4B53544F5245


def write_token_store(path: str, records: Iterable[Sequence[int]]) -> int:
    """Pack records into the TOKSTORE format; returns record count."""
    recs = [np.asarray(r, dtype=np.int32) for r in records]
    offsets = np.zeros(len(recs) + 1, dtype=np.uint64)
    for i, r in enumerate(recs):
        offsets[i + 1] = offsets[i] + len(r)
    with open(path, "wb") as f:
        header = np.asarray([_MAGIC, 1, len(recs), 0], dtype=np.uint64)
        f.write(header.tobytes())
        f.write(offsets.tobytes())
        for r in recs:
            f.write(r.tobytes())
    return len(recs)


def _build_lib() -> str:
    return _native.build("tokenstore")


class TokenStore:
    def __init__(self, path: str):
        self._lib = ctypes.CDLL(_build_lib())
        self._lib.ts_open.restype = ctypes.c_void_p
        self._lib.ts_open.argtypes = [ctypes.c_char_p]
        self._lib.ts_count.restype = ctypes.c_uint64
        self._lib.ts_count.argtypes = [ctypes.c_void_p]
        self._lib.ts_length.restype = ctypes.c_int64
        self._lib.ts_length.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        self._lib.ts_gather.restype = ctypes.c_int
        self._lib.ts_gather.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_uint64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64)]
        self._lib.ts_close.argtypes = [ctypes.c_void_p]
        self._h = self._lib.ts_open(path.encode())
        if not self._h:
            raise OSError(f"failed to open token store: {path}")

    def __len__(self) -> int:
        return int(self._lib.ts_count(self._h))

    def length(self, index: int) -> int:
        n = int(self._lib.ts_length(self._h, index))
        if n < 0:
            raise IndexError(index)
        return n

    def lengths(self) -> List[int]:
        return [self.length(i) for i in range(len(self))]

    def gather(self, indices: Sequence[int], max_len: int,
               pad: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Padded ``[n, max_len]`` int32 batch + true lengths ``[n]``."""
        idx = np.ascontiguousarray(indices, dtype=np.uint64)
        out = np.empty((len(idx), max_len), dtype=np.int32)
        lens = np.empty(len(idx), dtype=np.int64)
        rc = self._lib.ts_gather(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_len, pad, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if rc != 0:
            raise RuntimeError(f"ts_gather failed: rc={rc}")
        return out, lens

    def close(self):
        if self._h:
            self._lib.ts_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class PrefetchLoader:
    """One background thread assembling batches ahead of the train loop."""

    def __init__(self, store: TokenStore,
                 batch_indices: Iterable[Sequence[int]], max_len: int,
                 pad: int = 0, depth: int = 4,
                 postprocess=None):
        self.store = store
        self.max_len = max_len
        self.pad = pad
        self.postprocess = postprocess
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(
            target=self._work, args=(list(batch_indices),), daemon=True)
        self._thread.start()

    def _work(self, schedule):
        try:
            for idxs in schedule:
                batch = self.store.gather(idxs, self.max_len, self.pad)
                if self.postprocess is not None:
                    batch = self.postprocess(*batch)
                self._q.put(batch)
        except BaseException as e:  # propagate instead of hanging the consumer
            self._q.put(e)
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
