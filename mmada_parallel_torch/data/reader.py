"""Pluggable path reader — the reference's ``read_general``.

The reference ships a ceph/petrel S3 dispatcher (``xllm/data/data_reader.py:
31-57``) hard-wired to one cluster config.  Here the same role is a scheme
registry: deployments register a ``prefix -> bytes`` fetcher (S3, GCS,
ceph, ...) at startup and every data-pipeline file load goes through
:func:`read_general`; local paths pass through untouched, so the default
install has zero remote dependencies.

    from mmada_parallel_torch.data import reader
    reader.register_scheme("s3://", my_s3_client.get_bytes)

``no_proxy()`` mirrors the reference's proxy-stripping context
(``data_reader.py:14-28``) for fetchers that must bypass cluster proxies.

Counterpart of :mod:`mmada_parallel_tpu.data.reader`, copied so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import contextlib
import os
from io import BytesIO
from typing import Callable, Dict, Union

__all__ = ["no_proxy", "register_scheme", "read_general", "open_general"]

_SCHEMES: Dict[str, Callable[[str], bytes]] = {}


@contextlib.contextmanager
def no_proxy():
    """Temporarily strip proxy env vars (``data_reader.py:14-28``)."""
    saved = {}
    for var in ("http_proxy", "https_proxy", "HTTP_PROXY", "HTTPS_PROXY"):
        saved[var] = os.environ.pop(var, None)
    try:
        yield
    finally:
        for var, val in saved.items():
            if val is not None:
                os.environ[var] = val
            else:
                os.environ.pop(var, None)


def register_scheme(prefix: str, fetch: Callable[[str], bytes]) -> None:
    """Route paths starting with ``prefix`` through ``fetch(path) -> bytes``."""
    _SCHEMES[prefix] = fetch


def read_general(path: str) -> Union[str, BytesIO]:
    """Local paths pass through; registered remote schemes fetch to a
    ``BytesIO`` (the reference's contract, ``data_reader.py:31-42``)."""
    for prefix, fetch in _SCHEMES.items():
        if path.startswith(prefix):
            with no_proxy():
                return BytesIO(fetch(path))
    if "://" in path and not path.startswith("file://"):
        raise ValueError(
            f"no reader registered for {path!r} — call "
            "mmada_parallel_torch.data.reader.register_scheme() at startup")
    return path.removeprefix("file://")


def open_general(path: str, mode: str = "rb"):
    """``open()`` that also accepts registered remote schemes."""
    r = read_general(path)
    if isinstance(r, BytesIO):
        return r
    return open(r, mode)
