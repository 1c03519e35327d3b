"""Named spans and counters inside the program, recorded only while
``torch.profiler`` records.

The profiler is the switch: :func:`mmada_parallel_torch.utils.profiling.
trace`, or any ``torch.profiler.profile`` window.  There is no other.
With the profiler off a span costs one read of the profiler's flag and
records nothing.  While it records, ``with span("layer.what"):``

* opens ``torch.profiler.record_function`` of that name, so the span sits
  in the profiler's own trace, on the device trace's clock;
* takes ``time.time_ns()`` at entry and exit (the profiler's epoch);
* on a card, records a timing ``torch.cuda.Event`` pair on the current
  stream, with no synchronize;
* notes its parent, the innermost span open on the same thread.

:func:`count` adds to a named counter, also only while recording: a
number, or a tensor on the card, which is summed there (no synchronize) and
read as a number by :func:`counters`.  :func:`recording` says whether the
profiler records, for a counter that costs work to compute.  A span adds no
synchronize and no kernel, so it changes no result.  Names are
``layer.what``; each is read by a per-layer metric of the benchmark
(``PERF.md`` §3 lists them).

The store holds one recording session.  A session is over once a span,
a counter or a read finds the profiler off; the next span or counter that
records then empties the store first.  :func:`summary`,
:func:`counters` and :func:`records` read it, after the window:
:func:`summary` synchronizes the card once to read the events.

This is a module of its own because ``utils/profiling.py``'s ``__all__``
is held equal to its JAX counterpart's.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Optional, Union

import torch

__all__ = ["span", "count", "recording", "summary", "counters", "records"]

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Store:
    """The records and counters of the current session.  A record is
    ``[name, start_ns, end_ns, parent record or None, events or None]``;
    ``end_ns`` is 0 while the span is open."""

    def __init__(self):
        self.records = []
        self.counters: Dict[str, Any] = {}
        self.ended = True           # the profiler was seen off
        self.lock = threading.Lock()
        self.local = threading.local()

    def begin(self) -> None:
        """Empty the store if the last session has ended."""
        with self.lock:
            if self.ended:
                self.records, self.counters = [], {}
                self.ended = False

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_store = _Store()


class _Span:
    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _store.begin()
        stack = _store.stack()
        events = None
        if torch.cuda.is_initialized():
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        self.rec = [self.name, time.time_ns(), 0,
                    stack[-1] if stack else None, events]
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if events is not None:
            events[0].record()
        with _store.lock:
            _store.records.append(self.rec)
        stack.append(self.rec)

    def __exit__(self, *exc):
        _store.stack().pop()
        if self.rec[4] is not None:
            self.rec[4][1].record()
        self.rf.__exit__(*exc)
        self.rec[2] = time.time_ns()
        return False


def span(name: str):
    """A context manager that records ``name`` while the profiler
    records, and does nothing otherwise."""
    if not _recording():
        _store.ended = True
        return _OFF
    return _Span(name)


def recording() -> bool:
    """True while the profiler records (spans and counters are on)."""
    return bool(_recording())


def count(name: str, n: Union[int, torch.Tensor]) -> None:
    """Add ``n`` to the counter ``name`` while the profiler records; a
    tensor ``n`` is added on its device."""
    if not _recording():
        _store.ended = True
        return
    _store.begin()
    with _store.lock:
        _store.counters[name] = _store.counters.get(name, 0) + n


def _closed() -> list:
    if not _recording():
        _store.ended = True
    with _store.lock:
        return [r for r in _store.records if r[2]]


def summary() -> Dict[str, Dict[str, Optional[float]]]:
    """``{name: {"n", "host_s", "self_host_s", "device_s"}}`` of the
    session's closed spans: the count, the host seconds, the host seconds
    less those of the spans' children, and the device seconds of the
    event pairs (``None`` without a card).  Synchronizes the card once."""
    recs = _closed()
    if any(r[4] is not None for r in recs):
        torch.cuda.synchronize()
    child_ns: Dict[int, int] = {}
    for r in recs:
        if r[3] is not None:
            child_ns[id(r[3])] = child_ns.get(id(r[3]), 0) + r[2] - r[1]
    out: Dict[str, Dict[str, Optional[float]]] = {}
    for r in recs:
        s = out.setdefault(r[0], {"n": 0, "host_s": 0.0, "self_host_s": 0.0,
                                  "device_s": None})
        host = r[2] - r[1]
        s["n"] += 1
        s["host_s"] += host / 1e9
        s["self_host_s"] += (host - child_ns.get(id(r), 0)) / 1e9
        if r[4] is not None:
            s["device_s"] = ((s["device_s"] or 0.0)
                             + r[4][0].elapsed_time(r[4][1]) / 1e3)
    return out


def counters() -> Dict[str, Union[int, float]]:
    """The session's counters, a tensor's read as a number (which
    synchronizes with the card)."""
    _closed()
    with _store.lock:
        return {k: v.item() if isinstance(v, torch.Tensor) else v
                for k, v in _store.counters.items()}


def records() -> list:
    """The session's closed spans in the order they opened, as ``(name,
    start_ns, end_ns, parent)``; ``parent`` is the index of the parent
    span in this list, or ``None``."""
    recs = _closed()
    index = {id(r): i for i, r in enumerate(recs)}
    return [(r[0], r[1], r[2], index.get(id(r[3])) if r[3] is not None
             else None) for r in recs]
