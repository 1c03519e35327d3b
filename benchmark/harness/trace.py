"""The profiler's trace of a window, reduced to what the per-layer readers
and the result line need: device busy seconds, device time by kernel class
and by kernel, and the longest idle gaps with what the host was doing.

The window runs under ``torch.profiler`` with CPU and CUDA activity.  The
raw events are read from the profiler's Kineto result, not through
``prof.events()``, which builds a tree of a million Python objects for a
long window.
"""

from __future__ import annotations

import bisect
import dataclasses

# Kernel classes by (lowercased) kernel name, first match wins.  TF32 is
# off, so an f32 GEMM runs on the FMA pipes (``sgemm``, ``f32f32``) and a
# tensor-core GEMM (``nvjet``, other ``gemm``) takes bf16 operands.
KERNEL_CLASSES = (
    ("attention", ("attention_kernel", "attention_ws_kernel",
                   "split_combine_kernel", "rope_rotate_kernel")),
    ("attention_bwd", ("attention_bwd_", "bwd_delta_kernel",
                       "rope_rotate_bwd_kernel")),
    ("f32_gemm", ("sgemm", "f32f32")),
    ("int8_gemm", ("s8s8", "i8i8", "imma", "int8", "_s8_")),
    ("bf16_gemm", ("nvjet", "gemm")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    return next(cls for cls, keys in KERNEL_CLASSES
                if any(k in low for k in keys))


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{what}_us")() * 1000)


@dataclasses.dataclass
class Trace:
    busy_s: float                 # union of the device ops' intervals
    by_class: dict                # class -> device s
    by_kernel: dict               # name -> (count, device s)
    idle_gaps: list               # [(host op at the gap, s)], longest first

    def class_s(self, cls: str) -> float:
        return self.by_class.get(cls, 0.0)


def summarize(prof, top: int = 10, device: str = "cuda") -> Trace:
    """Reduce a finished ``torch.profiler.profile``.  Returns ``None``
    when the trace holds no device operation.  ``device="cpu"`` (the CPU
    tests) takes the host's ``aten`` operations for device operations."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = _ns(e, "start"), _ns(e, "duration")
        on_device = (e.device_type() == cuda if device == "cuda"
                     else e.name().startswith("aten::"))
        if on_device:
            if dur > 0 and not e.is_user_annotation():
                dev.append((start, start + dur, e.name()))
        elif dur > 0 and e.name() and not e.is_user_annotation():
            host.append((start, start + dur, e.name()))
    if not dev:
        return None
    dev.sort()
    busy, gaps = 0, []
    lo, hi = dev[0][0], dev[0][1]
    for a, b, _ in dev[1:]:
        if a > hi:
            busy += hi - lo
            gaps.append((a - hi, hi))
            lo = a
        hi = max(hi, b)
    busy += hi - lo
    by_class, by_kernel = {}, {}
    for a, b, name in dev:
        s = (b - a) / 1e9
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + s
        n, t = by_kernel.get(name, (0, 0.0))
        by_kernel[name] = (n + 1, t + s)
    return Trace(busy_s=busy / 1e9, by_class=by_class, by_kernel=by_kernel,
                 idle_gaps=_name_gaps(sorted(gaps, reverse=True)[:top],
                                      host))


def _name_gaps(gaps, host) -> list:
    """Each gap named by the host operation that was running when it
    began: the shortest host event covering that instant, or the one that
    last began before it."""
    host.sort()
    starts = [h[0] for h in host]
    out = []
    for length, at in gaps:
        i = bisect.bisect_right(starts, at)
        cover = [h for h in host[max(0, i - 2000):i] if h[1] >= at]
        if cover:
            name = min(cover, key=lambda h: h[1] - h[0])[2]
        else:
            name = host[i - 1][2] if i else "(no host event)"
        out.append((name, length / 1e9))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its arguments and namespaces, cut to 120
    characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:120]


def breakdown(tr: Trace, top: int = 10) -> dict:
    ops = sorted(tr.by_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_ops": [[short_name(n), s] for n, (_, s) in ops],
            "idle_gaps": [[short_name(n), s] for n, s in tr.idle_gaps]}
