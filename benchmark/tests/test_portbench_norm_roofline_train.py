"""``norm_roofline.train`` from synthetic traces and counters: the RMSNorm
kernels' least bytes (``backbone.norm_bytes`` for the forward launches,
``backbone.norm_bwd_bytes`` for the backward ones) at 3.35 TB/s over the
device seconds of the trace's ``rms_norm_kernel``,
``rms_norm_bwd_kernel`` and ``rms_norm_dw_kernel`` launches; ``None``
without the backward counter (a program whose training steps run the
chain), without the kernels in the trace, or without a span store."""

import os
import sys

import pytest

from benchmark.harness.core import BENCH_DIR, PEAK_HBM_BYTES, load_module
from benchmark.harness.trace import Trace, kernel_class

NAME = "norm_roofline.train"
KERNEL = ("void rmsn::rms_norm_kernel<__nv_bfloat16, float, 4>"
          "(__nv_bfloat16 const*, float const*, __nv_bfloat16*, "
          "long, int, int, float)")
BWD = ("void rmsn::rms_norm_bwd_kernel<__nv_bfloat16, float, 4>"
       "(__nv_bfloat16 const*, float const*, __nv_bfloat16 const*, "
       "__nv_bfloat16*, float*, long, int, int, float)")
DW = ("void rmsn::rms_norm_dw_kernel<__nv_bfloat16, float>"
      "(float const*, float*, int, int)")


def _reader():
    return load_module(os.path.join(BENCH_DIR, "metrics", NAME + ".py"),
                       "norm_roofline_train_reader")


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


def test_the_backward_kernels_are_elementwise():
    """The backward's kernels stay in the class the chain's autograd
    launches were in (``elementwise_ms.train``), and out of
    ``norm_roofline.edit``'s reader, which reads the forward kernel
    alone."""
    assert kernel_class(BWD) == "elementwise"
    assert kernel_class(DW) == "elementwise"
    assert "rms_norm_kernel" not in BWD and "rms_norm_kernel" not in DW


def test_reads_the_share_of_the_memory_bound(counters):
    # 4 steps of 4 microbatches: 17 forward and 9 backward launches each
    counters.update({"backbone.norm_bytes": 68 * 252_000_000,
                     "backbone.norm_bwd_bytes": 36 * 378_000_000,
                     "vq.norm_bytes": 7})
    ctx = _ctx({KERNEL: (68, 0.0065), BWD: (36, 0.0045), DW: (36, 0.0005),
                "void at::native::reduce_kernel<512, 1>(...)": (99, 3.0)})
    want = 100.0 * (68 * 252e6 + 36 * 378e6) / PEAK_HBM_BYTES / 0.0115
    assert _reader().read(ctx) == pytest.approx(want, rel=1e-12)
    assert 0 < want < 100


@pytest.mark.parametrize("counted, by_kernel", [
    ({}, {KERNEL: (1, 0.5), BWD: (1, 0.5)}),                   # no counter
    ({"backbone.norm_bytes": 10}, {KERNEL: (1, 0.5)}),         # the chain
    ({"backbone.norm_bwd_bytes": 10},
     {"void at::native::reduce_kernel<512, 1>(...)": (1, 0.5)}),
    ({"backbone.norm_bwd_bytes": 10}, {}),                     # no kernel
], ids=["no-counter", "chain-backward", "other-kernels", "empty-trace"])
def test_reads_none_without_what_it_reads(counters, counted, by_kernel):
    counters.update(counted)
    assert _reader().read(_ctx(by_kernel)) is None


def test_reads_none_from_a_program_without_spans(monkeypatch):
    import mmada_parallel_torch.utils as utils
    monkeypatch.delattr(utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "mmada_parallel_torch.utils.spans",
                        None)
    assert _reader().read(_ctx({BWD: (1, 0.5)})) is None
