"""The port's fused-RoPE attention (plain version and dispatch) against the
JAX package: ``flash_attention_rope`` in Pallas interpret mode and
``_packed_reference``, on the same numpy inputs, in f32 at atol 2e-5 /
rtol 1e-4 (the tolerance of the JAX kernel's own tests: the same math up to
f32 summation order).  The CUDA kernel itself is checked against the plain
version on the card (``chip_smoke.py`` and the ``cuda``-marked test)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu.models.llada import _rope_sin_cos as jax_tables
from mmada_parallel_tpu.ops import attention as JA
from mmada_parallel_tpu.ops import rope_attention as JR
from mmada_parallel_torch.ops import attention as TA
from mmada_parallel_torch.ops import rope_attention as TR

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _tables(L, D):
    s, c = jax_tables(L, D, 10000.0)
    return np.asarray(s), np.asarray(c)


def _both(*arrays):
    return ([jnp.asarray(a) if a is not None else None for a in arrays],
            [torch.tensor(a) if a is not None else None for a in arrays])


def _pad_bias(mask):
    pair = (mask[:, :, None] & mask[:, None, :])[:, None]
    return np.where(pair, 0.0, -1e30).astype(np.float32)


def test_port_tables_match_jax():
    from mmada_parallel_torch.models.llada import _rope_sin_cos
    s, c = _rope_sin_cos(300, 128, 10000.0)
    js, jc = _tables(300, 128)
    np.testing.assert_allclose(s.numpy(), js, atol=1e-6)
    np.testing.assert_allclose(c.numpy(), jc, atol=1e-6)


@pytest.mark.parametrize("L", [128, 300])
def test_reference_matches_pallas_mha(L):
    B, H, D = 2, 4, 128
    arrs = [_rand((B, L, H * D), i) for i in range(3)] + list(_tables(L, D))
    (jq, jk, jv, js, jc), (tq, tk, tv, ts, tc) = _both(*arrs)
    want = np.asarray(JR.flash_attention_rope(jq, jk, jv, js, jc, n_heads=H,
                                              interpret=True))
    got = TR.flash_attention_rope_reference(tq, tk, tv, ts, tc, n_heads=H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the dispatching op on a CPU tensor runs the same plain chain
    disp = TA.rope_attention(tq, tk, tv, ts, tc, n_heads=H)
    np.testing.assert_allclose(disp.numpy(), want, **TOL)
    np.testing.assert_allclose(
        TR.flash_attention_rope(tq, tk, tv, ts, tc, n_heads=H).numpy(),
        want, **TOL)


def test_reference_matches_pallas_gqa():
    B, L, H, KV, D = 1, 128, 8, 2, 128
    arrs = [_rand((B, L, H * D), 3), _rand((B, L, KV * D), 4),
            _rand((B, L, KV * D), 5)] + list(_tables(L, D))
    (jq, jk, jv, js, jc), (tq, tk, tv, ts, tc) = _both(*arrs)
    want = np.asarray(JR.flash_attention_rope(
        jq, jk, jv, js, jc, n_heads=H, n_kv_heads=KV, interpret=True))
    got = TR.flash_attention_rope_reference(tq, tk, tv, ts, tc, n_heads=H,
                                            n_kv_heads=KV)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = np.asarray(JA._packed_reference(jq, jk, jv, js, jc, None, H, KV))
    np.testing.assert_allclose(
        TA._packed_reference(tq, tk, tv, ts, tc, None, H, KV).numpy(), ref,
        **TOL)


def test_padding_bias_with_per_row_tables():
    B, L, H, D = 2, 200, 2, 128
    mask = np.ones((B, L), bool)
    mask[0, 150:] = False
    mask[1, 100:] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0)
    s, c = _tables(L, D)
    arrs = [_rand((B, L, H * D), i) for i in (6, 7, 8)] + [
        s[pos], c[pos], _pad_bias(mask)]
    (jq, jk, jv, js, jc, jb), (tq, tk, tv, ts, tc, tb) = _both(*arrs)
    got = TR.flash_attention_rope_reference(tq, tk, tv, ts, tc, tb,
                                            n_heads=H).numpy()
    ref = np.asarray(JA._packed_reference(jq, jk, jv, js, jc, jb, H, H))
    np.testing.assert_allclose(got, ref, **TOL)
    # the Pallas kernel averages padded rows over its own 128-padding too,
    # so it is compared on the real rows only (as its own test does)
    want = np.array(JR.flash_attention_rope(jq, jk, jv, js, jc, jb,
                                            n_heads=H, interpret=True))
    np.testing.assert_allclose(got[mask], want[mask], **TOL)


def test_distinct_lengths_from_one_table():
    B, Lq, Lk, H, D = 1, 100, 260, 2, 128
    s, c = _tables(Lk, D)
    arrs = [_rand((B, Lq, H * D), 9), _rand((B, Lk, H * D), 10),
            _rand((B, Lk, H * D), 11), s, c]
    (jq, jk, jv, js, jc), (tq, tk, tv, ts, tc) = _both(*arrs)
    want = np.asarray(JR.flash_attention_rope(jq, jk, jv, js, jc, n_heads=H,
                                              interpret=True))
    got = TR.flash_attention_rope_reference(tq, tk, tv, ts, tc, n_heads=H)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_fully_masked_row_is_mean_of_v():
    B, L, H, D = 1, 128, 1, 128
    bias = np.zeros((B, 1, L, L), np.float32)
    bias[0, 0, 5, :] = -1e30
    arrs = [_rand((B, L, H * D), i) for i in (12, 13, 14)] + \
        list(_tables(L, D)) + [bias]
    (jq, jk, jv, js, jc, jb), (tq, tk, tv, ts, tc, tb) = _both(*arrs)
    got = TR.flash_attention_rope_reference(tq, tk, tv, ts, tc, tb,
                                            n_heads=H).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0, 5], arrs[2][0].mean(axis=0), **TOL)
    ref = np.asarray(JA._packed_reference(jq, jk, jv, js, jc, jb, H, H))
    np.testing.assert_allclose(got, ref, **TOL)


def test_apply_rope_matches_jax():
    B, L, H, D = 2, 40, 3, 64
    s, c = _tables(L, D)
    q, k = _rand((B, L, H, D), 15), _rand((B, L, H, D), 16)
    want = JR.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(s),
                         jnp.asarray(c), True)
    got = TR.apply_rope(*(torch.tensor(a) for a in (q, k, s, c)), True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_dispatch_rules_on_cpu():
    B, L, H, D = 1, 16, 2, 64
    q = torch.from_numpy(_rand((B, L, H * D), 17))
    s, c = (torch.tensor(t) for t in _tables(L, D))
    with pytest.raises(ValueError, match="CUDA"):
        TA.rope_attention(q, q, q, s, c, n_heads=H, impl="pallas")
    with pytest.raises(ValueError, match="unknown"):
        TA.rope_attention(q, q, q, s, c, n_heads=H, impl="flash")
    xla = TA.rope_attention(q, q, q, s, c, n_heads=H, impl="xla")
    auto = TA.rope_attention(q, q, q, s, c, n_heads=H)
    assert torch.equal(xla, auto)
    assert TR.flash_attention_rope.launches == 0
    # the BLHD kernel (K3) launches only for CUDA tensors
    q4 = q.reshape(B, L, H, D)
    with pytest.raises(ValueError, match="CUDA"):
        TA.dot_product_attention(q4, q4, q4, impl="pallas")


def test_dot_product_attention_matches_jax():
    B, L, H, KV, D = 2, 50, 4, 2, 32
    mask = np.ones((B, L), bool)
    mask[1, 40:] = False
    arrs = [_rand((B, L, H, D), 18), _rand((B, L, KV, D), 19),
            _rand((B, L, KV, D), 20), _pad_bias(mask)]
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(*arrs)
    want = np.asarray(JA.dot_product_attention(jq, jk, jv, jb, impl="xla"))
    for impl in ("xla", "auto"):
        got = TA.dot_product_attention(tq, tk, tv, tb, impl=impl).numpy()
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda_device):
    """The CUDA kernel against its plain version on the card (bf16 at the
    tolerance chip_smoke.py states, f32 tighter)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype, tol in ((torch.bfloat16, dict(atol=1e-2, rtol=1e-2)),
                       (torch.float32, dict(atol=1e-4, rtol=1e-4))):
        B, L, H, KV, D = 2, 300, 4, 2, 128
        q = torch.randn(B, L, H * D, generator=g, device=cuda_device)
        k = torch.randn(B, L, KV * D, generator=g, device=cuda_device)
        v = torch.randn(B, L, KV * D, generator=g, device=cuda_device)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        from mmada_parallel_torch.models.llada import _rope_sin_cos
        s, c = _rope_sin_cos(L, D, 10000.0, cuda_device)
        before = TR.flash_attention_rope.launches
        got = TR.flash_attention_rope(q, k, v, s, c, n_heads=H, n_kv_heads=KV)
        assert TR.flash_attention_rope.launches == before + 1
        want = TR.flash_attention_rope_reference(q, k, v, s, c, n_heads=H,
                                                 n_kv_heads=KV)
        torch.testing.assert_close(got.float(), want.float(), **tol)


# The bf16 tensor-core body's edges (csrc/attention_ws.cuh): D=64; Lq and
# Lk that are not multiples of the 128-row q tile or the key tile, and
# Lq != Lk; GQA; per-row tables with a padding bias and a fully masked row;
# an odd Lk with a bias (scalar bias loads).  (B, Lq, Lk, H, KV, D, ragged)
BF16_EDGES = [(2, 333, 333, 8, 8, 64, False), (1, 197, 517, 8, 2, 128, False),
              (2, 301, 301, 4, 2, 64, True), (2, 130, 130, 32, 8, 128, True)]
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


def _ragged_inputs(B, L, D, device, lengths):
    """Per-row positions cumsum(mask) - 1 and the pairwise padding bias of
    rows padded from ``lengths``; row 5 of batch row 1 fully masked."""
    mask = torch.zeros(B, L, dtype=torch.bool, device=device)
    for b, n in enumerate(lengths):
        mask[b, :n] = True
    pos = (torch.cumsum(mask.long(), dim=1) - 1).clamp_min(0)
    pair = (mask[:, :, None] & mask[:, None, :])[:, None]
    bias = torch.where(pair, 0.0, -1e30).to(torch.float32)
    bias[1, 0, 5, :] = -1e30
    return pos, bias.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,ragged", BF16_EDGES)
def test_tensor_core_body_edges_on_cuda(cuda_device, B, Lq, Lk, H, KV, D,
                                        ragged):
    """K1 in bf16 (rotation pre-pass + tensor-core body) against its plain
    version at the body's edges, one launch counted per call."""
    from mmada_parallel_torch.models.llada import _rope_sin_cos
    g = torch.Generator(device=cuda_device).manual_seed(Lq)
    q, k, v = (torch.randn(B, n, h * D, generator=g, device=cuda_device
                           ).bfloat16() for n, h in ((Lq, H), (Lk, KV),
                                                     (Lk, KV)))
    s, c = _rope_sin_cos(max(Lq, Lk), D, 10000.0, cuda_device)
    bias = None
    if ragged:
        pos, bias = _ragged_inputs(B, Lq, D, cuda_device, (Lq, Lq // 2 + 3))
        s, c = s[pos].contiguous(), c[pos].contiguous()
    kw = dict(n_heads=H, n_kv_heads=KV)
    before = TR.flash_attention_rope.launches
    got = TR.flash_attention_rope(q, k, v, s, c, bias, **kw)
    assert TR.flash_attention_rope.launches == before + 1
    want = TR.flash_attention_rope_reference(q, k, v, s, c, bias, **kw)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,ragged",
                         BF16_EDGES + [(2, 1000, 1000, 8, 8, 128, False),
                                       (2, 1000, 1000, 32, 8, 128, True)])
def test_ws_body_stats_and_repeat_on_cuda(cuda_device, B, Lq, Lk, H, KV, D,
                                          ragged):
    """K1's bf16 path (pre-pass + the warp-specialised body,
    ``csrc/attention_ws.cuh``): its row statistics against the plain
    softmax's on the rotated inputs (``packed_stats_reference``, at
    ``test_stats_are_the_softmax``'s tolerance), output and statistics bit
    for bit on a second launch.  B=2 at Lq = Lk = 1000 puts the last q and
    key tiles at the batch boundary."""
    from mmada_parallel_torch.models.llada import _rope_sin_cos
    from mmada_parallel_torch.ops.attention_bwd import packed_stats_reference
    g = torch.Generator(device=cuda_device).manual_seed(Lq + Lk)
    q, k, v = (torch.randn(B, n, h * D, generator=g, device=cuda_device
                           ).bfloat16() for n, h in ((Lq, H), (Lk, KV),
                                                     (Lk, KV)))
    s, c = _rope_sin_cos(max(Lq, Lk), D, 10000.0, cuda_device)
    bias = None
    if ragged:
        pos, bias = _ragged_inputs(B, Lq, D, cuda_device, (Lq, Lq // 2 + 3))
        s, c = s[pos].contiguous(), c[pos].contiguous()
    kw = dict(n_heads=H, n_kv_heads=KV)
    got, stats = TR.flash_attention_rope(q, k, v, s, c, bias, **kw,
                                         with_stats=True)
    again, stats_again = TR.flash_attention_rope(q, k, v, s, c, bias, **kw,
                                                 with_stats=True)
    assert torch.equal(got, again) and torch.equal(stats, stats_again)
    want = TR.flash_attention_rope_reference(q, k, v, s, c, bias, **kw)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    tables = TR._split_tables(s, c, Lq, Lk)
    torch.testing.assert_close(
        stats, packed_stats_reference(q, k, *tables, bias, H, KV),
        atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
def test_rope_prepass_bitwise_on_cuda(cuda_device, per_row):
    """K1's bf16 rotation pre-pass equals rope_tensor bit for bit."""
    from mmada_parallel_torch.models.llada import _rope_sin_cos
    g = torch.Generator(device=cuda_device).manual_seed(1)
    B, L, H, D = 2, 300, 4, 128
    x = torch.randn(B, L, H * D, generator=g, device=cuda_device).bfloat16()
    s, c = _rope_sin_cos(L, D, 10000.0, cuda_device)
    if per_row:
        pos = torch.randint(0, L, (B, L), generator=g, device=cuda_device)
        s, c = s[pos].contiguous(), c[pos].contiguous()
    want = TR.rope_tensor(x.view(B, L, H, D), s, c, True).view(B, L, H * D)
    assert torch.equal(TR.rope_rotate(x, s, c, n_heads=H), want)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_rotate_on_cpu_is_rope_tensor_and_jax(per_row):
    """On the CPU ``rope_rotate`` is ``rope_tensor(full_precision=True)`` on
    the packed layout, which is JAX's ``rope_tensor``."""
    B, L, H, D = 2, 24, 4, 64
    x = _rand((B, L, H * D), 40)
    s, c = _tables(L, D)
    if per_row:
        pos = np.random.default_rng(41).integers(0, L, (B, L))
        s, c = s[pos], c[pos]
    got = TR.rope_rotate(torch.tensor(x), torch.tensor(s), torch.tensor(c),
                         n_heads=H).numpy()
    want = np.asarray(JR.rope_tensor(jnp.asarray(x.reshape(B, L, H, D)),
                                     jnp.asarray(s), jnp.asarray(c), True))
    np.testing.assert_allclose(got, want.reshape(B, L, H * D), **TOL)


def test_bf16_body_refuses_misaligned_inputs():
    """The tensor-core body and the pre-pass load 16 bytes at a time: a view
    that starts off a 16-byte boundary is refused before any launch."""
    base = torch.zeros(65, dtype=torch.bfloat16)
    TR.check_aligned("k", 16, base[:64], None)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TR.check_aligned("k", 16, base[1:])
    with pytest.raises(ValueError, match="8-byte aligned"):
        TR.check_aligned("k", 8, torch.zeros(9)[1:])
