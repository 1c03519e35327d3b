"""``vq_norm_roofline.m_sft`` from a synthetic span summary and counter:
the fused norm's least bytes at 3.35 TB/s over the ``vq.norm`` spans'
device seconds; ``None`` without device times, without the span or the
counter (a program without the fused call), or without a span store."""

import os
import sys

import pytest

from benchmark.harness.core import BENCH_DIR, PEAK_HBM_BYTES, load_module

NAME = "vq_norm_roofline.m_sft"
CTX = {"peak_bytes": PEAK_HBM_BYTES}


def _reader():
    return load_module(os.path.join(BENCH_DIR, "metrics", NAME + ".py"),
                       "vq_norm_reader")


@pytest.fixture
def store(monkeypatch):
    """Stands in a span summary and counters for the store's."""
    from mmada_parallel_torch.utils import spans
    state = {"summary": {}, "counters": {}}
    monkeypatch.setattr(spans, "summary", lambda: state["summary"])
    monkeypatch.setattr(spans, "counters", lambda: state["counters"])
    return state


def test_reads_the_share_of_the_memory_bound(store):
    # 84 calls a step of 45 steps moving 1.4 TB in all, on 0.85 device s
    store["summary"] = {
        "vq.norm": {"n": 84 * 45, "host_s": 1.0, "self_host_s": 1.0,
                    "device_s": 0.85},
        "vq.encode": {"n": 90, "host_s": 9.0, "self_host_s": 8.0,
                      "device_s": 8.5}}
    store["counters"] = {"vq.norm_bytes": 1_400_000_000_000,
                         "train.update_bytes": 5}
    want = 100.0 * 1.4e12 / PEAK_HBM_BYTES / 0.85
    assert _reader().read(CTX) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


@pytest.mark.parametrize("summary, counters", [
    ({}, {"vq.norm_bytes": 10}),                              # no span
    ({"vq.norm": {"n": 1, "host_s": 1.0, "self_host_s": 1.0,
                  "device_s": 0.5}}, {}),                     # no counter
    ({"vq.norm": {"n": 1, "host_s": 1.0, "self_host_s": 1.0,
                  "device_s": None}}, {"vq.norm_bytes": 10}),  # no card
], ids=["no-span", "no-counter", "no-device-time"])
def test_reads_none_without_what_it_reads(store, summary, counters):
    store["summary"], store["counters"] = summary, counters
    assert _reader().read(CTX) is None


def test_reads_none_from_a_program_without_spans(monkeypatch):
    import mmada_parallel_torch.utils as utils
    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "mmada_parallel_torch.utils.spans",
                        None)
    assert _reader().read(CTX) is None
