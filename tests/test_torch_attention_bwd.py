"""The attention gradient (``ops/attention_bwd.py``): the plain backward
that the CUDA backward kernel (``csrc/attention_bwd.cu``) is held to.

On the CPU, the plain backward of each entry point -- K1's
``flash_attention_rope_bwd``, K2's ``flash_attention_rope_qonly_bwd`` and
K3's ``flash_attention_bwd``, fed the forward's own output and row
statistics (``with_stats=True``) -- equals ``jax.vjp`` of the JAX package's
backward chains (``_packed_reference``, ``_packed_qonly_reference``,
``_xla_attention``) and autograd of the port's plain chains, in f32 at
atol = rtol = 1e-5 (the same math; the kernel's arithmetic, key tile by
key tile from the saved statistics, against the chains' one-pass softmax,
so only the f32 rounding differs).  The cases cover MHA and GQA, a padding
bias whose padded query rows are masked everywhere, shared and per-row
tables, Lq != Lk and an odd Lk.  The rotation post-pass's plain version
equals autograd of ``rope_tensor`` bit for bit.  On the card
(``cuda``-marked) each backward kernel is held to the plain backward in
bf16, at the bf16 body's edges, K2 with forced splits, and two launches
are bitwise equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_parallel_tpu.ops import attention as JA
from mmada_parallel_torch.ops import attention as TA
from mmada_parallel_torch.ops import attention_bwd as TB
from mmada_parallel_torch.ops import flash_attention as TF
from mmada_parallel_torch.ops import rope_attention as TR

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tables(L, D):
    """Neox tables ``[L, D]`` f32 from numpy."""
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2, dtype=np.float32) / D))
    emb = np.concatenate([np.outer(np.arange(L), inv)] * 2, 1)
    return np.sin(emb).astype(np.float32), np.cos(emb).astype(np.float32)


def _pad_bias(B, Lq, Lk, keep_q, keep_k):
    """Pairwise padding bias ``[B, 1, Lq, Lk]``: row b keeps its first
    ``keep_q[b]`` queries and ``keep_k[b]`` keys; a padded query row is
    masked everywhere (-1e30 on every key)."""
    mq = np.arange(Lq)[None] < np.asarray(keep_q)[:, None]
    mk = np.arange(Lk)[None] < np.asarray(keep_k)[:, None]
    pair = mq[:, :, None] & mk[:, None, :]
    return np.where(pair, 0.0, -1e30).astype(np.float32)[:, None]


# name -> (entry, B, Lq, Lk, H, KV, D, bias, per-row tables)
CASES = {
    "K3-mha": ("K3", 2, 40, 40, 2, 2, 64, False, False),
    "K3-gqa-bias-odd-Lk": ("K3", 2, 24, 37, 4, 2, 64, True, False),
    "K3-d128-Lq-ne-Lk": ("K3", 1, 33, 96, 2, 1, 128, True, False),
    "K1-mha-bias": ("K1", 2, 40, 40, 2, 2, 64, True, False),
    "K1-gqa-rows-odd-L": ("K1", 2, 29, 29, 4, 2, 128, True, True),
    "K2-gqa-rows-bias-odd-Lk": ("K2", 2, 8, 45, 4, 2, 64, True, True),
    "K2-mha-d128": ("K2", 1, 50, 96, 2, 2, 128, False, False),
}


def _inputs(name):
    """numpy ``(q, k, v, dout, sin, cos, bias)`` for a case; sin/cos are
    None for K3, ``[Lq, D]`` / ``[B, Lq, D]`` for K2 (q's positions), and
    the shared or per-row tables of both for K1 (Lq == Lk)."""
    entry, B, Lq, Lk, H, KV, D, bias, rows = CASES[name]
    blhd = entry == "K3"
    shapes = [(B, Lq, H, D), (B, Lk, KV, D), (B, Lk, KV, D), (B, Lq, H, D)]
    if not blhd:
        shapes = [(s[0], s[1], s[2] * s[3]) for s in shapes]
    q, k, v, dout = (_rand(s, i) for i, s in enumerate(shapes))
    b = (_pad_bias(B, Lq, Lk, [Lq, Lq - 5][:B], [Lk, Lk - 7][:B])
         if bias else None)
    sin = cos = None
    if not blhd:
        s, c = _tables(max(Lq, Lk) + 8, D)
        if rows:                         # per-row positions, as a ragged batch
            rng = np.random.default_rng(3)
            pos = np.sort(np.stack([rng.permutation(s.shape[0])[:Lq]
                                    for _ in range(B)]), 1)
            sin, cos = s[pos], c[pos]
        else:
            sin, cos = s[:Lq], c[:Lq]
    return q, k, v, dout, sin, cos, b


def _port_grads(name, arrays):
    """The plain backward's ``(dq, dk, dv)``, fed the forward's own output
    and statistics."""
    entry, B, Lq, Lk, H, KV, D, *_ = CASES[name]
    q, k, v, dout, sin, cos, b = (None if a is None else torch.tensor(a)
                                  for a in arrays)
    heads = dict(n_heads=H, n_kv_heads=KV)
    if entry == "K3":
        out, stats = TF.flash_attention(q, k, v, b, with_stats=True)
        grads = TB.flash_attention_bwd(q, k, v, b, out, stats, dout)
    elif entry == "K1":
        out, stats = TR.flash_attention_rope(q, k, v, sin, cos, b,
                                             with_stats=True, **heads)
        grads = TB.flash_attention_rope_bwd(q, k, v, sin, cos, b, out, stats,
                                            dout, **heads)
    else:
        out, stats = TR.flash_attention_rope_qonly(q, k, v, sin, cos, b,
                                                   with_stats=True, **heads)
        grads = TB.flash_attention_rope_qonly_bwd(q, k, v, sin, cos, b, out,
                                                  stats, dout, **heads)
    assert stats.shape == (B, H, Lq, 2) and stats.dtype == torch.float32
    return [g.numpy() for g in grads]


def _chain(name, lib):
    """The entry point's plain chain of ``lib`` (the JAX package's or the
    port's ``ops.attention``) as ``fn(q, k, v, sin, cos, bias)``."""
    entry, _, _, _, H, KV, *_ = CASES[name]
    if entry == "K3":
        return lambda q, k, v, s, c, b: lib._xla_attention(q, k, v, b)
    if entry == "K1":
        return lambda q, k, v, s, c, b: lib._packed_reference(q, k, v, s, c,
                                                              b, H=H, KV=KV)
    return lambda q, k, v, s, c, b: lib._packed_qonly_reference(
        q, k, v, s, c, b, H=H, KV=KV)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_vjp(name):
    arrays = _inputs(name)
    q, k, v, dout, sin, cos, b = arrays
    fn = _chain(name, JA)
    _, vjp = jax.vjp(lambda q_, k_, v_: fn(q_, k_, v_, sin, cos, b),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    for got, w in zip(_port_grads(name, arrays), want):
        np.testing.assert_allclose(got, np.asarray(w), **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_port_autograd(name):
    arrays = _inputs(name)
    q, k, v, dout, sin, cos, b = (None if a is None else torch.tensor(a)
                                  for a in arrays)
    xs = [t.requires_grad_(True) for t in (q, k, v)]
    out = _chain(name, TA)(*xs, sin, cos, b)
    want = torch.autograd.grad(out, xs, dout)
    for got, w in zip(_port_grads(name, arrays), want):
        np.testing.assert_allclose(got, w.numpy(), **TOL)


def test_fully_masked_rows_get_the_uniform_softmax_gradient():
    """A row masked everywhere has x == m on every key, so P is 1/Lk: its
    dq is nonzero and equals autograd of the plain chain (whose softmax of
    equal scores is uniform)."""
    name = "K3-gqa-bias-odd-Lk"
    arrays = _inputs(name)
    dq = _port_grads(name, arrays)[0]
    q, k, v, dout, _, _, b = (None if a is None else torch.tensor(a)
                              for a in arrays)
    qg = q.requires_grad_(True)
    want = torch.autograd.grad(TA._xla_attention(qg, k, v, b), qg, dout)[0]
    masked = dq[1, -5:]                  # batch row 1's padded queries
    assert np.abs(masked).max() > 1e-3
    np.testing.assert_allclose(masked, want[1, -5:].numpy(), **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_row", [False, True])
def test_rotation_post_pass_is_rope_tensor_autograd(dtype, per_row):
    B, L, NH, D = 2, 12, 3, 64
    s, c = _tables(20, D)
    if per_row:
        pos = np.stack([np.arange(L), np.arange(L) + 5])
        s, c = s[pos], c[pos]
    else:
        s, c = s[:L], c[:L]
    sin, cos = torch.tensor(s), torch.tensor(c)
    x = torch.tensor(_rand((B, L, NH, D), 0)).to(dtype).requires_grad_(True)
    dy = torch.tensor(_rand((B, L, NH, D), 1)).to(dtype)
    want = torch.autograd.grad(TR.rope_tensor(x, sin, cos, True), x, dy)[0]
    got = TB.rope_rotate_backward(dy.reshape(B, L, NH * D), sin, cos,
                                  n_heads=NH).reshape(B, L, NH, D)
    assert got.dtype == dtype
    assert torch.equal(got, want)


def test_stats_are_the_softmax():
    """``exp2((x - m) - log2 l)`` from the statistics is the softmax of the
    plain chain's scores."""
    q, k = _rand((2, 10, 2, 64), 0), _rand((2, 13, 1, 64), 1)
    b = _pad_bias(2, 10, 13, [10, 6], [13, 9])
    qt, kt, bt = map(torch.tensor, (q, k, b))
    stats = TB.attention_stats_reference(qt, kt, bt)
    x = TB._scores_log2(qt, kt.repeat_interleave(2, 2), bt)
    p = torch.exp2((x - stats[..., :1]) - stats[..., 1:])
    scores = torch.einsum("bqhd,bkhd->bhqk", qt,
                          kt.repeat_interleave(2, 2)) * 64 ** -0.5 + bt
    torch.testing.assert_close(p, torch.softmax(scores, -1), **TOL)


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__2650c3a8_16_attention_bwd_cu_23c4c3372tc25attention_bwd_dkdv_kernelILi128ELb1EEEv14CUtensorMap_stS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__2650c3a8_16_attention_bwd_cu_23c4c3372tc25attention_bwd_dkdv_kernelILi128ELb1EEEv14CUtensorMap_stS2_
    40 bytes stack frame, 44 bytes spill stores, 64 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__2650c3a8_16_attention_bwd_cu_23c4c3372tc16bwd_delta_kernelILi64EEEvPK13__nv_bfloat16S4_Pfiix' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__2650c3a8_16_attention_bwd_cu_23c4c3372tc16bwd_delta_kernelILi64EEEvPK13__nv_bfloat16S4_Pfiix
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__2650c3a8_16_attention_bwd_cu_23c4c3372tc23attention_bwd_dq_kernelILi64ELb0EEEv14CUtensorMap_stS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN49_GLOBAL__N__2650c3a8_16_attention_bwd_cu_23c4c3372tc23attention_bwd_dq_kernelILi64ELb0EEEv14CUtensorMap_stS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
"""


def test_bwd_ptxas_report_reads_each_pass():
    """``chip_smoke.ptxas_entries`` takes each backward pass's registers and
    spill bytes from the ``-Xptxas -v`` report the build keeps, by pass, D
    and bias, and nothing of the other kernels."""
    import chip_smoke
    assert chip_smoke.ptxas_entries(PTXAS_LOG) == {
        ("dkdv", 128, True): (168, 44, 64), ("dq", 64, False): (168, 0, 0)}


def test_backward_launchers_refuse_f32_on_the_card_path():
    """The backward kernel is bf16 only (f32 recomputes the plain chain in
    the Function); its checks run before any launch."""
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="bfloat16"):
        TB._launch_bwd(q, q, q, None, q, torch.zeros(1, 2, 8, 2), q)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


# the backward kernel against its plain version in bf16: both round P and
# dS to bf16 before the products, but the scores are summed in another
# order and P comes from the SFU's 2^x, so a P or dS element can round to
# the neighbouring bf16 value; outputs are rounded to bf16 (2^-8 relative).
# Each gradient's relative L2 from the plain one, and its largest |error|
# in units of the plain gradient's RMS (a wrong row or tile, which the L2
# dilutes), as chip_smoke.py holds them (readings: PERF.md section 6)
BWD_REL_L2, BWD_MAX_RMS = 2e-3, 0.25


def _assert_grad_close(g, w):
    g, w = g.float(), w.float()
    err = g - w
    rms = float(w.norm()) / w.numel() ** 0.5
    assert float(err.norm()) <= BWD_REL_L2 * float(w.norm())
    assert float(err.abs().max()) <= BWD_MAX_RMS * rms


# (entry, B, Lq, Lk, H, KV, D, bias, per-row tables): D 64 and 128, ragged
# Lq/Lk off the 128-row and 64-key tiles, odd Lk with a bias, GQA, fully
# masked rows (the padding bias), K2 at Lq != Lk; then the edges of the
# warp-specialised passes: the bias tile staged by TMA (Lk % 4 == 0) and by
# the producer's cp.async (odd Lk), one q tile (Lq <= 64, fewer than the
# ring's stages), G = 4 (the dK/dV loop crosses heads), B = 2 with Lq and
# Lk off the 64-row tiles (the tensor maps' zero fill at a batch boundary)
CUDA_CASES = [("K3", 2, 190, 301, 4, 2, 64, True, False),
              ("K3", 1, 197, 517, 8, 2, 128, False, False),
              ("K1", 2, 130, 130, 4, 2, 128, True, True),
              ("K1", 1, 300, 300, 4, 4, 64, False, False),
              ("K2", 2, 40, 301, 4, 2, 128, True, True),
              ("K2", 1, 606, 2424, 2, 2, 128, False, False),
              ("K3", 2, 190, 300, 4, 2, 128, True, False),
              ("K3", 1, 40, 256, 4, 4, 64, True, False),
              ("K3", 2, 130, 203, 8, 2, 128, True, False),
              ("K1", 2, 196, 196, 8, 2, 64, True, False),
              ("K2", 2, 33, 300, 8, 2, 128, True, True)]


def _cuda_call(case, dev, gen):
    entry, B, Lq, Lk, H, KV, D, bias, rows = case
    blhd = entry == "K3"
    shapes = [(B, Lq, H, D), (B, Lk, KV, D), (B, Lk, KV, D), (B, Lq, H, D)]
    if not blhd:
        shapes = [(s[0], s[1], s[2] * s[3]) for s in shapes]
    q, k, v, dout = (torch.randn(*s, generator=gen, device=dev)
                     .to(torch.bfloat16) for s in shapes)
    b = (torch.tensor(_pad_bias(B, Lq, Lk, [Lq, Lq - 5][:B],
                                [Lk, Lk - 7][:B]), device=dev)
         if bias else None)
    heads = dict(n_heads=H, n_kv_heads=KV)
    if blhd:
        return (lambda: TF.flash_attention(q, k, v, b, with_stats=True),
                lambda out, st, bwd: bwd(q, k, v, b, out, st, dout),
                TB.flash_attention_bwd)
    s, c = (torch.tensor(t, device=dev) for t in _tables(max(Lq, Lk), D))
    if entry == "K1":
        if rows:
            pos = torch.stack([torch.arange(Lq, device=dev)] * B)
            s, c = s[pos].contiguous(), c[pos].contiguous()
        return (lambda: TR.flash_attention_rope(q, k, v, s, c, b,
                                                with_stats=True, **heads),
                lambda out, st, bwd: bwd(q, k, v, s, c, b, out, st, dout,
                                         **heads),
                TB.flash_attention_rope_bwd)
    sq, cq = s[:Lq].contiguous(), c[:Lq].contiguous()
    if rows:
        sq, cq = (torch.stack([t] * B).contiguous() for t in (sq, cq))
    return (lambda: TR.flash_attention_rope_qonly(q, k, v, sq, cq, b,
                                                  with_stats=True, **heads),
            lambda out, st, bwd: bwd(q, k, v, sq, cq, b, out, st, dout,
                                     **heads),
            TB.flash_attention_rope_qonly_bwd)


def _plain_bwd(kernel_bwd):
    """The same backward on CPU copies of the card's tensors (the plain
    version), moved back."""
    def bwd(*args, **kw):
        cpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
        return [g.to(args[0].device) for g in kernel_bwd(*cpu, **kw)]
    return bwd


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_backward_kernel_matches_plain_on_cuda(cuda_device, case):
    gen = torch.Generator(device=cuda_device).manual_seed(case[2])
    fwd, call, kernel_bwd = _cuda_call(case, cuda_device, gen)
    out, stats = fwd()
    before = kernel_bwd.launches
    got = call(out, stats, kernel_bwd)
    again = call(out, stats, kernel_bwd)
    assert kernel_bwd.launches == before + 2
    want = call(out, stats, _plain_bwd(kernel_bwd))
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)                 # no atomics: bit for bit
        _assert_grad_close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [2, 5])
def test_split_forward_stats_feed_the_backward_on_cuda(cuda_device, n_split,
                                                       monkeypatch):
    """K2's split forward writes its statistics in the combine: they equal
    the unsplit call's to f32 rounding, and the backward from them equals
    the plain backward."""
    case = ("K2", 1, 16, 640, 4, 2, 128, True, False)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    fwd, call, kernel_bwd = _cuda_call(case, cuda_device, gen)
    _, whole = fwd()
    monkeypatch.setattr(TR, "plan_splits", lambda *a: n_split)
    out, stats = fwd()
    torch.testing.assert_close(stats, whole, atol=1e-4, rtol=1e-5)
    want = call(out, stats, _plain_bwd(kernel_bwd))
    for g, w in zip(call(out, stats, kernel_bwd), want):
        _assert_grad_close(g, w)


@pytest.mark.cuda
def test_rotation_post_pass_on_cuda_is_bitwise(cuda_device):
    B, L, NH, D = 2, 300, 4, 128
    s, c = (torch.tensor(t, device=cuda_device) for t in _tables(L, D))
    dy = torch.randn(B, L, NH * D, device=cuda_device).to(torch.bfloat16)
    got = TB.rope_rotate_backward(dy, s, c, n_heads=NH)
    want = TB.rope_rotate_backward(dy.cpu(), s.cpu(), c.cpu(), n_heads=NH)
    assert torch.equal(got.cpu(), want)
