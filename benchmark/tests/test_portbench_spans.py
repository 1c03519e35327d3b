"""The readers of the program's spans and counters on a tiny traced window
on the CPU: each host metric reads above 0, each device metric reads
``None`` (the CPU has no CUDA events), and every reader reads ``None``,
without raising, from a program that has no span store."""

import os
import sys

import pytest

from conftest import run_cell
from benchmark.harness.core import BENCH_DIR, PEAK_HBM_BYTES, load_module

HOST = {"tiny-edit": ["pipeline_self_ms.edit", "sampler_host_ms.edit"],
        "tiny-sft": [],
        "tiny-msft": ["assembly_span_ms.m_sft"]}
DEVICE = {"tiny-edit": ["sampler_ms.edit"],
          "tiny-sft": ["optimizer_ms.train", "optimizer_roofline.train"],
          "tiny-msft": ["optimizer_ms.train", "optimizer_roofline.train",
                        "vq_encode_ms.m_sft"]}
ALL = sorted({n for names in (*HOST.values(), *DEVICE.values())
              for n in names})


def _reader(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                       "span_reader_" + name.replace(".", "_"))


@pytest.mark.parametrize("cell", sorted(HOST))
def test_span_readers_on_a_tiny_traced_window(tiny_root, cell):
    rc, res = run_cell(tiny_root, cell, trace=1)
    assert rc == 0 and res["correct"] is True
    for name in HOST[cell]:
        assert res["metrics"][name]["value"] > 0, name
    for name in DEVICE[cell]:
        assert name not in res["metrics"], name
    ctx = {"peak_bytes": PEAK_HBM_BYTES}      # the window's store, read again
    for name in HOST[cell]:
        assert _reader(name).read(ctx) == res["metrics"][name]["value"]
    for name in DEVICE[cell]:
        assert _reader(name).read(ctx) is None, name


def test_readers_read_none_from_a_program_without_spans(monkeypatch):
    import mmada_parallel_torch.utils as utils
    # the import raises, as in a program that has no span store
    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "mmada_parallel_torch.utils.spans",
                        None)
    for name in ALL:
        assert _reader(name).read({"peak_bytes": PEAK_HBM_BYTES}) is None
