"""``norm_roofline.edit`` from a synthetic trace and counter: the RMSNorm
kernel's least bytes at 3.35 TB/s over the device seconds of the trace's
``rms_norm_kernel`` launches; ``None`` without the counter (a program
without the kernel), without the kernel in the trace, or without a span
store."""

import os
import sys

import pytest

from benchmark.harness.core import BENCH_DIR, PEAK_HBM_BYTES, load_module
from benchmark.harness.trace import Trace, kernel_class

NAME = "norm_roofline.edit"
KERNEL = ("void rmsn::rms_norm_kernel<__nv_bfloat16, __nv_bfloat16, 4>"
          "(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
          "long, int, int, float)")


def _reader():
    return load_module(os.path.join(BENCH_DIR, "metrics", NAME + ".py"),
                       "norm_roofline_reader")


def _ctx(by_kernel):
    tr = Trace(busy_s=40.0, by_class={}, by_kernel=by_kernel, idle_gaps=[])
    return {"trace": tr, "peak_bytes": PEAK_HBM_BYTES}


@pytest.fixture
def counters(monkeypatch):
    """Stands in counters for the store's."""
    from mmada_parallel_torch.utils import spans
    state = {}
    monkeypatch.setattr(spans, "counters", lambda: state)
    return state


def test_the_kernel_is_elementwise():
    """The kernel's name keeps ``elementwise_ms.*`` reading the class the
    plain chain's launches were in."""
    assert kernel_class(KERNEL) == "elementwise"


def test_reads_the_share_of_the_memory_bound(counters):
    # 3 edits of 192 forwards of 65 launches, 0.5 TB in all, on 0.2 s
    counters.update({"backbone.norm_bytes": 500_000_000_000,
                     "vq.norm_bytes": 7})
    ctx = _ctx({KERNEL: (3 * 192 * 65, 0.15),
                KERNEL.replace(", 4>", ", 8>"): (10, 0.05),
                "void at::native::reduce_kernel<512, 1>(...)": (99, 3.0)})
    want = 100.0 * 5e11 / PEAK_HBM_BYTES / 0.2
    assert _reader().read(ctx) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


@pytest.mark.parametrize("present, by_kernel", [
    (False, {KERNEL: (1, 0.5)}),                                  # no counter
    (True, {"void at::native::reduce_kernel<512, 1>(...)": (1, 0.5)}),
    (True, {}),                                                   # no kernel
], ids=["no-counter", "other-kernels", "empty-trace"])
def test_reads_none_without_what_it_reads(counters, present, by_kernel):
    if present:
        counters["backbone.norm_bytes"] = 10
    assert _reader().read(_ctx(by_kernel)) is None


def test_reads_none_from_a_program_without_spans(monkeypatch):
    import mmada_parallel_torch.utils as utils
    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "mmada_parallel_torch.utils.spans",
                        None)
    assert _reader().read(_ctx({KERNEL: (1, 0.5)})) is None
