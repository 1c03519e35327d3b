"""Build the data layer's C++ readers (``native/*.cc``) with ``g++``.

Each source compiles at its first use into ``mmada_parallel_torch/_build/``
(never beside the source), under a name keyed by a hash of the source and
the flags, so an unchanged tree reuses the library.  The compile writes to a
temporary file that is renamed into place, so processes that build at once
(test workers) never load a half-written library.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_PKG, "native")
BUILD_DIR = os.path.join(_PKG, "_build")


def build(name: str, flags=("-O2", "-shared", "-fPIC")) -> str:
    """Path of ``lib<name>.so`` built from ``native/<name>.cc``; compiles
    it unless the library for this source and these flags exists.  Raises
    ``OSError`` or ``subprocess.CalledProcessError`` when ``g++`` is missing
    or fails."""
    src = os.path.join(NATIVE_DIR, f"{name}.cc")
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    so = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, "-o", tmp, src], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so
