"""The operation and byte counters and the per-layer readers, against
counts made by hand."""

import os

import pytest

from benchmark.harness import counts
from benchmark.harness.core import BENCH_DIR, load_module
from benchmark.harness.trace import Trace, kernel_class

M8B = dict(d_model=4096, n_heads=32, n_kv_heads=32, mlp_hidden_size=12288,
           n_layers=32, embedding_size=134656)
TINY = dict(d_model=64, n_heads=4, n_kv_heads=2, mlp_hidden_size=128,
            n_layers=2, embedding_size=100)


@pytest.mark.parametrize("m, want", [
    # 2 x layers x (q, o: d*d; k, v: d*kv_d; ff_proj, up_proj, ff_out)
    (TINY, 2 * 2 * (64 * 64 * 2 + 64 * 32 * 2 + 3 * 64 * 128)),
    (M8B, 13_958_643_712),          # 2 x 6.979 B block parameters
])
def test_block_gemm_flops_per_token(m, want):
    assert counts.block_gemm_flops_per_token(m) == want


def test_attention_counts_by_hand():
    # K1 at the edit's B=1 L=2424: 4 H L^2 D = 96.27 GFLOP, 0.0973 ms at
    # 989 TFLOP/s; bytes q, k, v, o (bf16) and the f32 sin/cos tables
    assert counts.attention_flops(M8B, 1, 2424, 2424, False) == \
        4 * 32 * 2424 * 2424 * 128
    qkvo = 2424 * 4096 * 2
    assert counts.attention_bytes(M8B, 1, 2424, 2424, False) == \
        4 * qkvo + 2 * 2424 * 128 * 4
    call = {"B": 1, "Lq": 2424, "L": 2424, "bwd": False, "count": 3}
    assert counts.attention_bound_s(M8B, call, 989e12, 3.35e12) == \
        pytest.approx(3 * 0.0973e-3, rel=1e-3)
    # the backward at the A step's B=1 L=5120: 10 H L^2 D, 1.0857 ms
    bwd = {"B": 1, "Lq": 5120, "L": 5120, "bwd": True, "count": 1}
    assert counts.attention_bound_s(M8B, bwd, 989e12, 3.35e12) == \
        pytest.approx(1.0857e-3, rel=1e-3)
    # q, k, v, o, dO, dQ, dK, dV in bf16, (m, l) in f32, the tables
    assert counts.attention_bytes(TINY, 2, 8, 8, True) == (
        4 * 2 * 8 * 4 * 16 * 2 + 4 * 2 * 8 * 2 * 16 * 2 + 2 * 4 * 8 * 2 * 4
        + 2 * 8 * 16 * 4)


def test_forward_and_train_step_flops():
    fwd = {"B": 2, "L": 8, "count": 3, "head": [[5, 100], [2, 10]]}
    per = (8 * counts.block_gemm_flops_per_token(TINY)
           + 2 * 5 * 100 * 64 + 2 * 2 * 10 * 64
           + 2 * 4 * 4 * 8 * 8 * 16)
    assert counts.forward_flops(TINY, fwd) == 3 * 2 * per
    tr = {"microbatches": 2, "rows": 3, "L": 8}
    f = counts.train_step_flops(TINY, tr)
    assert f["gemm_block"] == 6 * 8 * counts.block_gemm_flops_per_token(
        TINY)
    assert f["gemm_head"] == 2 * 6 * 8 * 100 * 64
    assert f["attention"] == 2 * 4 * 6 * 4 * 8 * 8 * 16


def test_kernel_classes():
    assert kernel_class("void attention_ws_kernel<128, true>(...)") == \
        "attention"
    assert kernel_class("attention_bwd_dkdv_kernel") == "attention_bwd"
    assert kernel_class("nvjet_tst_128x256_64x4") == "bf16_gemm"
    assert kernel_class("sgemm_128x128") == "f32_gemm"
    assert kernel_class("vectorized_elementwise_kernel") == "elementwise"


def _reader(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                       "bench_metric_test_" + name.replace(".", "_"))


def _ctx(work, by_class, busy=1.0, window=2.0):
    tr = Trace(busy_s=busy, by_class=by_class, by_kernel={}, idle_gaps=[])
    return {"trace": tr, "window_s": window, "work": work,
            "peak_flops": 1e12, "peak_bytes": 1e12}


def test_edit_readers_by_hand():
    fwd = {"B": 1, "L": 8, "count": 4, "head": [[2, 100]]}
    attn = {"B": 1, "L": 8, "Lq": 8, "count": 8, "bwd": False}
    work = {"model": TINY, "forwards": [fwd], "attention": [attn]}
    ctx = _ctx(work, {"attention": 2e-6, "bf16_gemm": 1e-5,
                      "elementwise": 4e-3}, busy=1.5, window=2.0)
    gemm = 4 * (8 * counts.block_gemm_flops_per_token(TINY)
                + 2 * 2 * 100 * 64)
    att = 4 * 2 * 4 * 4 * 8 * 8 * 16
    assert _reader("mfu.edit").read(ctx) == pytest.approx(
        100 * (gemm + att) / 2e12)
    assert _reader("gemm_roofline.edit").read(ctx) == pytest.approx(
        100 * gemm / 1e12 / 1e-5)
    one = max(counts.attention_flops(TINY, 1, 8, 8, False),
              counts.attention_bytes(TINY, 1, 8, 8, False)) / 1e12
    assert _reader("attn_roofline.edit").read(ctx) == pytest.approx(
        100 * 8 * one / 2e-6)
    assert _reader("idle_share.edit").read(ctx) == pytest.approx(25.0)
    assert _reader("elementwise_ms.edit").read(ctx) == pytest.approx(1.0)
    # nothing to read: no attention time, no training
    assert _reader("attn_roofline.edit").read(_ctx(work, {})) is None
    assert _reader("mfu.train").read(ctx) is None


def test_train_readers_by_hand():
    tr = {"steps": 2, "microbatches": 2, "rows": 1, "L": 8, "remat": True}
    work = {"model": TINY, "train": tr, "attention": [
        {"B": 1, "L": 8, "Lq": 8, "count": 16, "bwd": False},
        {"B": 1, "L": 8, "Lq": 8, "count": 8, "bwd": True}]}
    ctx = _ctx(work, {"attention": 1e-6, "attention_bwd": 1e-6,
                      "bf16_gemm": 1e-5, "elementwise": 6e-3})
    f = counts.train_step_flops(TINY, tr)
    assert _reader("mfu.train").read(ctx) == pytest.approx(
        100 * 2 * 3 * (f["gemm_block"] + f["gemm_head"] + f["attention"])
        / 2e12)
    assert _reader("gemm_roofline.train").read(ctx) == pytest.approx(
        100 * 2 * (4 * f["gemm_block"] + 3 * f["gemm_head"]) / 1e12 / 1e-5)
    assert _reader("elementwise_ms.train").read(ctx) == pytest.approx(3.0)
    assert _reader("attn_roofline.train").read(ctx) > 0
