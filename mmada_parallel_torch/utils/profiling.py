"""Profiling and timing helpers.

The reference has only wall-clock prints and a Triton microbench
(``inference.py:162``, ``omni_attention.py:159-240``); here:

* :func:`trace` -- a ``torch.profiler`` trace (CPU and, with a card, CUDA
  activity) written into ``log_dir`` as a Chrome trace that TensorBoard's
  profiler plugin and ``chrome://tracing`` load;
* :func:`time_fn` -- steady-state timing with the first call apart and a
  device synchronize after each call (a CUDA call returns before its
  kernels finish);
* :class:`StepTimer` -- per-step wall-clock meter for training loops.

Counterpart of :mod:`mmada_parallel_tpu.utils.profiling`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import numpy as np
import torch

__all__ = ["trace", "time_fn", "StepTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _sync(out):
    """Wait for the devices of ``out``'s CUDA tensors."""
    from mmada_parallel_torch.training.trainer import tree_leaves
    devices = {t.device for t in tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def time_fn(fn: Callable, *args, iters: int = 5, warmup: int = 1,
            **kwargs) -> Dict[str, float]:
    """``{compile_s, mean_s, min_s}``: ``compile_s`` is the first call
    (kernel builds, allocator and library warm-up), the others are over
    ``iters`` calls after ``warmup`` calls in all."""
    t0 = time.time()
    out = fn(*args, **kwargs)
    _sync(out)
    compile_s = time.time() - t0
    for _ in range(max(warmup - 1, 0)):
        _sync(fn(*args, **kwargs))
    times = []
    for _ in range(iters):
        t0 = time.time()
        _sync(fn(*args, **kwargs))
        times.append(time.time() - t0)
    return {"compile_s": compile_s, "mean_s": float(np.mean(times)),
            "min_s": float(np.min(times))}


class StepTimer:
    def __init__(self):
        self._last = time.time()
        self.data_s = 0.0
        self.step_s = 0.0

    def data_done(self):
        now = time.time()
        self.data_s = now - self._last
        self._last = now

    def step_done(self) -> Dict[str, float]:
        now = time.time()
        self.step_s = now - self._last
        self._last = now
        return {"data_time": self.data_s, "step_time": self.step_s}
