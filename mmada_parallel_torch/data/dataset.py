"""Annotation datasets + deterministic length-clustered sampler.

Mirrors the A-variant data stack:

* :class:`MetaDataset` — YAML ``META`` list of annotation files
  (json/jsonl/pkl), per-file ``type`` and ``ratio`` subsampling
  (``xllm/data/dataset.py:22-97``), error-item fallback to a neighboring
  index (``:177-192``).
* :class:`LengthClusteredSampler` — group-by-type batches, length
  clustering (sort by item length, shuffle inside 500-global-batch
  windows), grad-accum grouping, and ``set_epoch(epoch, start_iter)``
  mid-epoch resume (``xllm/data/sampler.py:50-222``).

The reference's rank0-builds-h5-cache dance (``dataset.py:99-145``) has a
host-native equivalent here: ``cache_on_disk=True`` makes process 0 build an
offset-indexed JSON blob store next to the config, write a ``ready``
sentinel, and every process (including 0) then reads items lazily through
one shared ``mmap`` of the file — on a host running several
processes, the page cache holds ONE copy of a multi-GB annotation list
instead of one deserialized copy per process, which is exactly what the
reference's h5 file buys its ranks.  Token caching still belongs to the
pre-tokenizer.

Counterpart of :mod:`mmada_parallel_tpu.data.dataset`, copied so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import pickle
import random
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import yaml

__all__ = ["MetaDataset", "LengthClusteredSampler"]


_BLOB_MAGIC = b"MPTBLOB1"


def _write_blob_store(path: str, records: Sequence[bytes]) -> None:
    """Offset-indexed byte-blob file: magic, count, offsets u64[n+1], bytes.

    Written to a per-process tmp then renamed so readers never see a
    half-written store (and concurrent writers never interleave).
    """
    offsets = np.zeros(len(records) + 1, dtype=np.uint64)
    for i, r in enumerate(records):
        offsets[i + 1] = offsets[i] + len(r)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(_BLOB_MAGIC)
        f.write(np.asarray([len(records)], dtype=np.uint64).tobytes())
        f.write(offsets.tobytes())
        for r in records:
            f.write(r)
    os.replace(tmp, path)


class _BlobStore(Sequence):
    """mmap-backed lazy reader for :func:`_write_blob_store` files."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            if f.read(8) != _BLOB_MAGIC:
                raise ValueError(f"not a blob store: {path}")
            (self._n,) = np.frombuffer(f.read(8), dtype=np.uint64)
        self._n = int(self._n)
        head = 16 + 8 * (self._n + 1)
        self._offsets = np.memmap(path, dtype=np.uint64, mode="r",
                                  offset=16, shape=(self._n + 1,))
        self._data = np.memmap(path, dtype=np.uint8, mode="r", offset=head)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> bytes:
        if i < 0:                      # list semantics (the eager path)
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        a, b = int(self._offsets[i]), int(self._offsets[i + 1])
        return self._data[a:b].tobytes()


class _LazyJsonList(Sequence):
    """Decodes one annotation per access from a :class:`_BlobStore`."""

    def __init__(self, store: _BlobStore):
        self._store = store

    def __len__(self) -> int:
        return len(self._store)

    def __getitem__(self, i: int):
        return json.loads(self._store[i])


def _load_annotations(cfg: Dict) -> tuple:
    annotations: List[Dict] = []
    types: List[str] = []
    for meta in cfg["META"]:
        path = meta["path"]
        mtype = meta.get("type", "default")
        if path.endswith(".json"):
            with open(path) as f:
                items = json.load(f)
        elif path.endswith(".jsonl"):
            with open(path) as f:
                items = [json.loads(l) for l in f if l.strip()]
        elif path.endswith((".pkl", ".pth")):
            with open(path, "rb") as f:
                items = pickle.load(f)
        else:
            raise ValueError(f"unsupported annotation format: {path}")
        ratio = meta.get("ratio")
        if ratio is not None and ratio < 1.0:
            rng = random.Random(0)
            items = rng.sample(items, int(len(items) * ratio))
        annotations.extend(items)
        types.extend([mtype] * len(items))
    return annotations, types


def _cache_key(config_path: str, cfg: Dict) -> str:
    """Config bytes + each annotation file's (size, mtime) — a changed
    source invalidates the cache, mirroring a rebuilt h5."""
    h = hashlib.sha256()
    with open(config_path, "rb") as f:
        h.update(f.read())
    for meta in cfg["META"]:
        st = os.stat(meta["path"])
        h.update(f"{meta['path']}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


class MetaDataset:
    """YAML ``META`` dataset with optional shared on-disk cache.

    ``cache_on_disk=True`` reproduces the reference's rank0-builds /
    others-spin-wait protocol (``xllm/data/dataset.py:99-145``): the
    process with ``rank == 0`` parses the annotation sources once, writes
    an offset-indexed blob store plus a ``ready`` sentinel (both via
    tmp+rename, so a crash mid-build never publishes a torn cache), and
    every other process polls for the sentinel before mmap-opening the
    store. Items decode lazily per access; the OS page cache shares the
    bytes across all processes on the host.  If the sentinel never shows
    up within ``cache_wait_s`` (rank 0 died, or a multi-host pod without
    a shared filesystem), the process logs a warning and builds the store
    locally instead of failing the job.
    """

    def __init__(self, config_path: str, item_processor: Any = None,
                 cache_on_disk: bool = False,
                 cache_dir: Optional[str] = None, rank: int = 0,
                 cache_wait_s: float = 600.0):
        with open(config_path) as f:
            cfg = yaml.safe_load(f)
        self.item_processor = item_processor
        if not cache_on_disk:
            self.annotations, self.types = _load_annotations(cfg)
            return
        key = _cache_key(config_path, cfg)
        cdir = cache_dir or config_path + ".cache"
        os.makedirs(cdir, exist_ok=True)
        blob = os.path.join(cdir, f"annotations-{key}.blob")
        types_path = os.path.join(cdir, f"annotations-{key}.types.json")
        ready = blob + ".ready"
        if rank == 0 and not os.path.exists(ready):
            annotations, types = _load_annotations(cfg)
            _write_blob_store(
                blob, [json.dumps(a).encode() for a in annotations])
            tmp = types_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(types, f)
            os.replace(tmp, types_path)
            with open(ready + ".tmp", "w") as f:
                f.write("ready\n")
            os.replace(ready + ".tmp", ready)
        else:
            deadline = time.monotonic() + cache_wait_s
            while not os.path.exists(ready):
                if time.monotonic() > deadline:
                    # rank 0's sentinel never appeared: either it died, or
                    # this is a multi-HOST run without a shared filesystem
                    # (the rank spans hosts).
                    # Build the store locally instead of killing the job —
                    # the per-pid tmp + rename makes same-host races safe.
                    logging.getLogger(__name__).warning(
                        "rank %s: annotation cache never became ready (%s);"
                        " no shared filesystem with rank 0? building "
                        "locally", rank, ready)
                    annotations, types = _load_annotations(cfg)
                    _write_blob_store(
                        blob,
                        [json.dumps(a).encode() for a in annotations])
                    tmp = f"{types_path}.tmp.{os.getpid()}"
                    with open(tmp, "w") as f:
                        json.dump(types, f)
                    os.replace(tmp, types_path)
                    break
                time.sleep(0.05)
        self.annotations = _LazyJsonList(_BlobStore(blob))
        with open(types_path) as f:
            self.types = json.load(f)

    def __len__(self):
        return len(self.annotations)

    def get_raw(self, i: int) -> Dict:
        return self.annotations[i]

    def __getitem__(self, i: int):
        # error-item fallback to a neighboring index (dataset.py:177-192)
        for attempt in range(8):
            j = (i + attempt) % len(self)
            try:
                item = self.annotations[j]
                if self.item_processor is None:
                    return item
                return self.item_processor.process_item(item)
            except Exception:
                if attempt == 7:
                    raise
        raise RuntimeError("unreachable")

    def lengths(self) -> List[int]:
        if self.item_processor is not None and hasattr(self.item_processor,
                                                       "predict_length"):
            return [self.item_processor.predict_length(a)
                    for a in self.annotations]
        return [len(a.get("token", a.get("input_ids", []))) or 1024
                for a in self.annotations]


@dataclasses.dataclass
class LengthClusteredSampler:
    """Deterministic epoch-seeded batch sampler.

    ``batch_size`` is per-process; a "global batch" spans
    ``batch_size * acc_grad * world_size`` items of a single meta ``type``.
    """

    lengths: Sequence[int]
    types: Sequence[str]
    batch_size: int
    world_size: int = 1
    rank: int = 0
    acc_grad: int = 1
    seed: int = 0
    length_clustering: bool = True
    cluster_window: int = 500  # global batches per shuffle window

    def __post_init__(self):
        self.epoch = 0
        self.start_iter = 0
        gbs = self.batch_size * self.world_size * self.acc_grad
        if gbs <= 0:
            raise ValueError("empty global batch")
        self._gbs = gbs

    def set_epoch(self, epoch: int, start_iter: int = 0):
        """Mid-epoch resume (``sampler.py:211-222``)."""
        self.epoch = epoch
        self.start_iter = start_iter

    def _global_batches(self) -> List[List[int]]:
        rng = random.Random(self.seed + self.epoch)
        by_type: Dict[str, List[int]] = {}
        for i, t in enumerate(self.types):
            by_type.setdefault(t, []).append(i)
        batches: List[List[int]] = []
        for t, idx in sorted(by_type.items()):
            idx = idx[:]
            rng.shuffle(idx)
            idx = idx[:len(idx) // self._gbs * self._gbs]
            if self.length_clustering:
                # sort by length, then shuffle inside windows
                idx.sort(key=lambda i: self.lengths[i])
                w = self.cluster_window * self._gbs
                out = []
                for s in range(0, len(idx), w):
                    win = idx[s:s + w]
                    rng.shuffle(win)
                    out.extend(win)
                idx = out
            batches.extend(idx[s:s + self._gbs]
                           for s in range(0, len(idx), self._gbs))
        rng.shuffle(batches)
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        """Yields per-process batches of ``batch_size`` indices."""
        for gi, gb in enumerate(self._global_batches()):
            # grad-accum grouping: rank r takes acc_grad contiguous
            # microbatches (sampler.py:166-183)
            if gi < self.start_iter:
                continue
            per = self.batch_size * self.acc_grad
            mine = gb[self.rank * per:(self.rank + 1) * per]
            for a in range(self.acc_grad):
                yield mine[a * self.batch_size:(a + 1) * self.batch_size]

    def __len__(self):
        n = len(self._global_batches()) - self.start_iter
        return max(n, 0) * self.acc_grad
