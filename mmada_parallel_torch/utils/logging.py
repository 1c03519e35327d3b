"""Metrics and observability.

Mirrors the A metric stack (``xllm/util/misc.py:21-151``): windowed
``SmoothedValue`` with cross-process synchronization (an all-reduce through
``torch.distributed`` when a process group is initialised, no-op otherwise)
and a ``MetricLogger`` printing samples/sec; scalar sinks are TensorBoard
(via ``torch.utils.tensorboard``, baked in) and/or a jsonl ``log.txt`` like
``finetune.py:530-536``.

Counterpart of :mod:`mmada_parallel_tpu.utils.logging`, copied so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np

__all__ = ["SmoothedValue", "MetricLogger", "ScalarWriter"]


class SmoothedValue:
    """Windowed + global average (``misc.py:21-77``)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        v = float(value)
        self.deque.append(v)
        self.count += n
        self.total += v * n

    def synchronize_between_processes(self):
        """all-reduce (count, total) across processes (``misc.py:39-48``);
        a single process (no initialised process group) keeps its own."""
        import torch
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return
        t = torch.tensor([self.count, self.total], dtype=torch.float64)
        dist.all_reduce(t)
        self.count = int(t[0].item())
        self.total = float(t[1].item())

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """``log_every`` with iter-time / samples-sec reporting
    (``misc.py:111-151``)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        # guard against recursion during unpickling/deepcopy, where
        # lookups happen before __init__ populated the instance dict
        meters = self.__dict__.get("meters")
        if meters is not None and name in meters:
            return meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def log_every(self, iterable, print_freq: int, header: str = "",
                  samples_per_iter: Optional[int] = None, printer=print):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                parts = [header, f"[{i}" + (f"/{total}]" if total else "]"),
                         str(self), f"time: {iter_time}"]
                if samples_per_iter:
                    sps = samples_per_iter / max(iter_time.avg, 1e-9)
                    parts.append(f"samples/sec: {sps:.1f}")
                if total:
                    eta = iter_time.global_avg * (total - i)
                    parts.append("eta: " + str(datetime.timedelta(seconds=int(eta))))
                printer(self.delimiter.join(p for p in parts if p))
            i += 1
            end = time.time()
        printer(f"{header} total time: "
                f"{datetime.timedelta(seconds=int(time.time() - start))}")

    def state_dict(self):
        return {k: {"total": m.total, "count": m.count}
                for k, m in self.meters.items()}

    def load_state_dict(self, state):
        for k, v in state.items():
            self.meters[k].total = v["total"]
            self.meters[k].count = v["count"]


class ScalarWriter:
    """TensorBoard + jsonl scalar sink (``finetune.py:121-125,530-536``),
    with an optional wandb backend covering the M trainer's tracker
    surface (``train_interleave.py:179-201`` init/config logging,
    ``:953-964`` validation-image tables).

    wandb is not a baked-in dependency: when ``wandb_project`` is given
    but the package is missing, the writer degrades to TensorBoard/jsonl
    (and the PNG dumps the trainers already write) without failing.
    """

    def __init__(self, log_dir: str, use_tensorboard: bool = True,
                 is_main: bool = True, wandb_project: Optional[str] = None,
                 wandb_run_name: Optional[str] = None,
                 wandb_config: Optional[Dict] = None):
        self.is_main = is_main
        self.log_dir = log_dir
        self.tb = None
        self.wandb = None
        if is_main:
            os.makedirs(log_dir, exist_ok=True)
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                    self.tb = SummaryWriter(log_dir)
                except Exception:
                    self.tb = None
            if wandb_project:
                try:
                    import wandb
                    wandb.init(project=wandb_project, name=wandb_run_name,
                               config=wandb_config or {}, dir=log_dir)
                    self.wandb = wandb
                except Exception:
                    self.wandb = None
            self.jsonl = open(os.path.join(log_dir, "log.txt"), "a")

    def write(self, step: int, scalars: Dict[str, float]):
        if not self.is_main:
            return
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)
        if self.wandb is not None:
            self.wandb.log({k: float(v) for k, v in scalars.items()},
                           step=step)
        self.jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v
                                                      in scalars.items()}})
                         + "\n")
        self.jsonl.flush()

    def write_images(self, step: int, tag: str, images,
                     captions: Optional[Iterable[str]] = None):
        """Validation-image logging (the wandb-table surface of
        ``train_interleave.py:953-964``).  ``images``: iterable of HWC
        uint8 arrays.  Logged to TensorBoard and (when live) wandb; the
        trainers' on-disk PNG dumps are unaffected."""
        if not self.is_main:
            return
        images = list(images)
        caps = list(captions) if captions is not None \
            else [f"{tag}/{i}" for i in range(len(images))]
        if self.tb is not None:
            for i, img in enumerate(images):
                self.tb.add_image(f"{tag}/{i}", np.asarray(img), step,
                                  dataformats="HWC")
        if self.wandb is not None:
            self.wandb.log(
                {tag: [self.wandb.Image(np.asarray(img), caption=c)
                       for img, c in zip(images, caps)]}, step=step)

    def close(self):
        if self.tb is not None:
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()
        if self.is_main:
            self.jsonl.close()
