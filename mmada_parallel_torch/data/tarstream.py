"""Python face of the native tar streamer (ctypes, no pybind).

``NativeTarStream(path)`` iterates ``(name, bytes)`` in archive order while
a C++ thread prefetches ahead with the GIL released
(``native/tarstream.cc``) -- the one-process replacement for tarfile
inside DataLoader worker processes (reference ``training/data.py:279-286``).
``ShardReader`` uses it automatically and falls back to ``tarfile`` when
the native library cannot build.

Counterpart of :mod:`mmada_parallel_tpu.data.tarstream`, copied so that the
port imports nothing of the JAX package.  The library is built with ``g++
-O2 -shared -fPIC -pthread`` into ``mmada_parallel_torch/_build/`` at first
use (:mod:`mmada_parallel_torch.data._native`).
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import Iterator, Optional, Tuple

from mmada_parallel_torch.data import _native

__all__ = ["NativeTarStream", "native_available"]

_LIB = None
_LIB_ERR: Optional[Exception] = None


def _build_lib():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        so = _native.build("tarstream",
                           ("-O2", "-shared", "-fPIC", "-pthread"))
        lib = ctypes.CDLL(so)
        lib.tar_open.restype = ctypes.c_void_p
        lib.tar_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.tar_next.restype = ctypes.c_int
        lib.tar_next.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint64),
                                 ctypes.c_char_p, ctypes.c_uint64,
                                 ctypes.POINTER(ctypes.c_uint64)]
        lib.tar_read.restype = ctypes.c_int64
        lib.tar_read.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_uint64]
        lib.tar_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError) as e:
        # missing toolchain -> tarfile fallback
        _LIB_ERR = e
    return _LIB


def native_available() -> bool:
    return _build_lib() is not None


class NativeTarStream:
    """Iterate ``(name, payload_bytes)`` over one tar shard."""

    def __init__(self, path: str, prefetch_bytes: int = 64 << 20):
        lib = _build_lib()
        if lib is None:
            raise OSError(f"native tarstream unavailable: {_LIB_ERR}")
        self._lib = lib
        self._h = lib.tar_open(path.encode(), prefetch_bytes)
        if not self._h:
            raise OSError(f"cannot open tar shard: {path}")
        self._path = path

    def __iter__(self) -> Iterator[Tuple[str, bytes]]:
        name = ctypes.create_string_buffer(4096)
        size = ctypes.c_uint64()
        nlen = ctypes.c_uint64()
        while True:
            rc = self._lib.tar_next(self._h, ctypes.byref(size), name,
                                    len(name), ctypes.byref(nlen))
            if rc == 1:
                return
            if rc != 0:
                raise OSError(f"malformed tar shard: {self._path}")
            if nlen.value >= len(name):  # pax path longer than the buffer:
                # re-query with an exact-size buffer (entry stays current)
                name = ctypes.create_string_buffer(int(nlen.value) + 1)
                continue
            buf = ctypes.create_string_buffer(size.value)
            got = self._lib.tar_read(self._h, buf, size.value)
            if got < 0:
                raise OSError(f"tar_read failed: {self._path}")
            yield name.value.decode("utf-8", "replace"), buf.raw[:got]

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.tar_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
