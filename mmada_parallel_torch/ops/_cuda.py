"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a``, all of
them at once, and the objects are linked into one shared library with a plain
C interface, loaded with :mod:`ctypes`.  The build runs at the first CUDA call
(never at import, so the CPU-only tests import every module) and lands in
``mmada_parallel_torch/_build/``, keyed by a hash of the sources (headers
included) and flags, so an unchanged tree reuses it.  A missing ``nvcc`` or a
failed compile raises with the compiler's output; nothing carries on without
the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the entry points' dtype codes
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C signatures of the entry points in csrc/, for ctypes (every pointer and the
# stream as c_void_p, or ctypes would cut them to 32 bits)
_SIGNATURES = {
    "mmada_flash_attention_rope": (
        [_P] * 12 + [_I] * 6 + [_LL, _LL, _F, _I, _P], _I),
    "mmada_rope_rotate": ([_P] * 4 + [_I] * 4 + [_LL, _P], _I),
    "mmada_flash_attention_rope_qonly": (
        [_P] * 11 + [_I] * 7 + [_LL, _F, _I, _P], _I),
    "mmada_flash_attention": (
        [_P] * 6 + [_I] * 6 + [_F, _I, _P], _I),
    "mmada_flash_attention_rope_prefix": (
        [_P] * 11 + [_I] * 6 + [_LL, _LL, _F, _I, _P], _I),
    # the backward (csrc/attention_bwd.cu)
    "mmada_rope_rotate_bwd": ([_P] * 3 + [_I] * 4 + [_LL, _P], _I),
    "mmada_flash_attention_bwd": ([_P] * 11 + [_I] * 6 + [_F, _P], _I),
    "mmada_flash_attention_rope_bwd": (
        [_P] * 17 + [_I] * 6 + [_LL, _LL, _F, _P], _I),
    "mmada_flash_attention_rope_qonly_bwd": (
        [_P] * 14 + [_I] * 6 + [_LL, _F, _P], _I),
    # the tokenizers' GroupNorm + swish (csrc/group_norm.cu)
    "mmada_group_norm": ([_P] * 5 + [_I] * 4 + [_F] + [_I] * 3
                         + [_LL, _P], _I),
    "mmada_group_norm_cl": ([_P] * 6 + [_I] * 4 + [_F] + [_I] * 5 + [_P],
                            _I),
    # the mixture of experts' grouped GEMM (csrc/moe_grouped_gemm.cu)
    "mmada_moe_grouped_gemm": ([_P] * 8 + [_I] * 7 + [_P], _I),
    # the backbone's RMSNorm (csrc/rms_norm.cu)
    "mmada_rms_norm": ([_P] * 3 + [_LL, _I, _F] + [_I] * 5 + [_P], _I),
}


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's SMs, which the kernels' planners fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc"), shutil.which("nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels "
                       "are built from csrc/ at first use")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def library_path() -> str:
    """Path of the shared library for the current sources (may not exist)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmmada_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Run the commands concurrently; raise with the first failure's output.
    Returns the output of each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return outs


def build() -> str:
    """Compile ``csrc/*.cu`` unless the library for these sources exists:
    one ``nvcc -c`` per source, all started together, then one link.
    Returns the library's path; the compilers' output (``-Xptxas -v``
    register and shared-memory report) is kept beside it as ``.log``."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, os.path.basename(s)[:-3] + ".o")
                for s in _sources()]
        logs = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
                         for s, o in zip(_sources(), objs)])
        tmp = os.path.join(work, "lib.so")
        logs += _run_all([[nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", tmp,
                           *objs]])
        with open(path[:-3] + ".log", "w") as f:
            f.write("".join(logs))
        os.replace(tmp, path)
    return path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, with ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(build())
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
