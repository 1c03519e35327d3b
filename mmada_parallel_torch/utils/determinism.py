"""Seeding and determinism controls.

Mirrors ``MMaDA-Parallel-M/models/training_utils.py:27-58``
(``set_seed`` / ``enable_full_determinism``) and A's ``setup_seed``
(``utils/generation_utils.py:84-89``).  The port's samplers and trainers take
their randomness from explicit ``torch.Generator`` arguments; these seed the
global RNGs that library code draws from.

Counterpart of :mod:`mmada_parallel_tpu.utils.determinism`.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

__all__ = ["set_seed", "enable_full_determinism"]


def set_seed(seed: int):
    """Seed python's, numpy's and torch's global RNGs (torch's on every
    CUDA device too)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def enable_full_determinism(seed: int):
    """:func:`set_seed` plus deterministic CUDA algorithms.

    The JAX package sets ``TF_DETERMINISTIC_OPS`` for XLA; here "full
    determinism" is torch's: ``torch.use_deterministic_algorithms(True)``
    (an op with no deterministic CUDA implementation then raises),
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (which cuBLAS needs for
    reproducible GEMMs; set before the first cuBLAS call), and cuDNN's
    deterministic mode with autotuning off.  The port's attention kernels
    are deterministic as they are: fixed tiles, fixed summation order."""
    set_seed(seed)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
