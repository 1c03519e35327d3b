"""The port's q-only RoPE attention (K2's plain version and dispatch) and its
BLHD attention (K3's plain version and dispatch) against the JAX package, on
the same numpy inputs, in f32 at atol 2e-5 / rtol 1e-4 (the tolerance of the
JAX kernels' own tests: the same math up to f32 summation order).

K2 is held against ``flash_attention_rope_qonly(..., interpret=True)`` and
``_packed_qonly_reference``; K3 against ``flash_attention(...,
interpret=True)``, on rows that are not fully masked (the Pallas kernel
averages a fully masked row over its key padding too).  The CUDA kernels
themselves are checked against these plain versions on the card
(``chip_smoke.py`` and the ``cuda``-marked tests)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu.models.llada import _rope_sin_cos as jax_tables
from mmada_parallel_tpu.ops import attention as JA
from mmada_parallel_tpu.ops import flash_attention as JF
from mmada_parallel_tpu.ops import rope_attention as JR
from mmada_parallel_torch.ops import attention as TA
from mmada_parallel_torch.ops import flash_attention as TF
from mmada_parallel_torch.ops import rope_attention as TR

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) if a is not None else None for a in arrays],
            [torch.tensor(a) if a is not None else None for a in arrays])


def _qonly_inputs(B, Lq, Lk, H, KV, D, per_row, seed, bias_rows=None):
    """q at Lq sorted distinct positions of an Lk sequence; k/v caches.
    ``bias_rows``: per batch row, the number of real keys (padding bias)."""
    rng = np.random.default_rng(seed)
    s, c = (np.asarray(t) for t in jax_tables(Lk, D, 10000.0))
    if per_row:
        pos = np.sort(np.stack([rng.choice(Lk, Lq, replace=False)
                                for _ in range(B)]), axis=1)
        sq, cq = s[pos], c[pos]
    else:
        sq, cq = s[:Lq], c[:Lq]
    bias = None
    if bias_rows is not None:
        keep = np.arange(Lk)[None, :] < np.asarray(bias_rows)[:, None]
        bias = np.where(keep[:, None, None, :], 0.0, -1e30).astype(
            np.float32) * np.ones((1, 1, Lq, 1), np.float32)
    return [_rand((B, Lq, H * D), seed), _rand((B, Lk, KV * D), seed + 1),
            _rand((B, Lk, KV * D), seed + 2), sq, cq, bias]


@pytest.mark.parametrize("B,Lq,Lk,H,KV,per_row,bias_rows", [
    (2, 16, 300, 2, 2, True, None),         # partial step, per-row tables
    (1, 130, 130, 4, 4, False, None),       # full step, shared tables
    (2, 40, 260, 8, 2, True, (260, 200)),   # GQA + padding bias
])
def test_qonly_matches_jax(B, Lq, Lk, H, KV, per_row, bias_rows):
    D = 128
    arrs = _qonly_inputs(B, Lq, Lk, H, KV, D, per_row, 3, bias_rows)
    (jq, jk, jv, js, jc, jb), (tq, tk, tv, ts, tc, tb) = _both(*arrs)
    ref = np.asarray(JA._packed_qonly_reference(jq, jk, jv, js, jc, jb, H,
                                                KV))
    want = np.asarray(JR.flash_attention_rope_qonly(
        jq, jk, jv, js, jc, jb, n_heads=H, n_kv_heads=KV, interpret=True))
    kw = dict(n_heads=H, n_kv_heads=KV)
    got = TR.flash_attention_rope_qonly_reference(tq, tk, tv, ts, tc, tb,
                                                  **kw).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, want, **TOL)
    # the wrapper and the dispatching op on CPU tensors run the same chain
    np.testing.assert_allclose(
        TR.flash_attention_rope_qonly(tq, tk, tv, ts, tc, tb, **kw).numpy(),
        want, **TOL)
    np.testing.assert_allclose(
        TA.rope_attention_qonly(tq, tk, tv, ts, tc, tb, **kw).numpy(),
        want, **TOL)
    np.testing.assert_allclose(
        TA._packed_qonly_reference(tq, tk, tv, ts, tc, tb, H, KV).numpy(),
        ref, **TOL)


def test_qonly_low_precision_rope_matches_jax():
    """``full_precision=False`` rotates q in the compute dtype, as the JAX
    unpacked chain does."""
    B, Lq, Lk, H, D = 1, 12, 64, 2, 64
    arrs = _qonly_inputs(B, Lq, Lk, H, H, D, True, 9)
    (jq, jk, jv, js, jc, _), (tq, tk, tv, ts, tc, _) = _both(*arrs)
    want = np.asarray(JA.rope_attention_qonly(
        jq.astype(jnp.bfloat16), jk.astype(jnp.bfloat16),
        jv.astype(jnp.bfloat16), js, jc, n_heads=H, full_precision=False,
        impl="xla").astype(jnp.float32))
    got = TA.rope_attention_qonly(
        tq.bfloat16(), tk.bfloat16(), tv.bfloat16(), ts, tc, n_heads=H,
        full_precision=False).float().numpy()
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("Lq,Lk,H,KV,masked", [
    (128, 128, 4, 4, False), (100, 300, 8, 2, False), (256, 256, 2, 2, True)])
def test_blhd_matches_pallas(Lq, Lk, H, KV, masked):
    B, D = 2, 128
    arrs = [_rand((B, Lq, H, D), 20), _rand((B, Lk, KV, D), 21),
            _rand((B, Lk, KV, D), 22), None]
    rows = np.arange(Lq)
    if masked:
        mask = np.ones((B, Lk), bool)
        mask[1, 200:] = False
        pair = (mask[:, :Lq, None] & mask[:, None, :])[:, None]
        arrs[3] = np.where(pair, 0.0, -1e30).astype(np.float32)
        rows = rows[:200]             # row 1 >= 200 is fully masked
    (jq, jk, jv, jb), (tq, tk, tv, tb) = _both(*arrs)
    want = np.asarray(JF.flash_attention(jq, jk, jv, jb, interpret=True))
    got = TF.flash_attention(tq, tk, tv, tb).numpy()
    np.testing.assert_allclose(got[:, rows], want[:, rows], **TOL)
    for impl in ("auto", "xla"):
        np.testing.assert_allclose(
            TA.dot_product_attention(tq, tk, tv, tb, impl=impl).numpy()[
                :, rows], want[:, rows], **TOL)
    if masked:                        # fully masked row: mean(v), as JAX xla
        ref = np.asarray(JA._xla_attention(jq, jk, jv, jb))
        np.testing.assert_allclose(got, ref, **TOL)


def test_dispatch_repairs_on_cpu():
    """``rope_attention(full_precision=False)`` and ``dot_product_attention``
    no longer refuse: on CPU tensors ``auto`` runs the plain chain with no
    kernel launch, ``pallas`` asks for CUDA tensors, unknown impls raise."""
    B, L, H, D = 1, 16, 2, 64
    q = torch.from_numpy(_rand((B, L, H * D), 30))
    s, c = (torch.tensor(np.asarray(t)) for t in jax_tables(L, D, 10000.0))
    before = (TR.flash_attention_rope.launches,
              TR.flash_attention_rope_qonly.launches,
              TF.flash_attention.launches)
    for fn in (TA.rope_attention, TA.rope_attention_qonly):
        lo = fn(q, q, q, s, c, n_heads=H, full_precision=False)
        assert torch.equal(lo, fn(q, q, q, s, c, n_heads=H,
                                  full_precision=False, impl="xla"))
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, s, c, n_heads=H, full_precision=False, impl="pallas")
        with pytest.raises(ValueError, match="unknown"):
            fn(q, q, q, s, c, n_heads=H, impl="flash")
    q4 = q.reshape(B, L, H, D)
    assert torch.equal(TA.dot_product_attention(q4, q4, q4),
                       TA._xla_attention(q4, q4, q4, None))
    with pytest.raises(ValueError, match="CUDA"):
        TA.dot_product_attention(q4, q4, q4, impl="pallas")
    assert (TR.flash_attention_rope.launches,
            TR.flash_attention_rope_qonly.launches,
            TF.flash_attention.launches) == before


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(cuda_device):
    """K2 and K3 against their plain versions on the card (bf16 at the
    tolerance chip_smoke.py states, f32 tighter)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    from mmada_parallel_torch.models.llada import _rope_sin_cos
    for dtype, tol in ((torch.bfloat16, dict(atol=1e-2, rtol=1e-2)),
                       (torch.float32, dict(atol=1e-4, rtol=1e-4))):
        B, Lq, Lk, H, KV, D = 2, 40, 300, 4, 2, 128

        def rnd(*shape):
            return torch.randn(*shape, generator=g,
                               device=cuda_device).to(dtype)
        q, k, v = rnd(B, Lq, H * D), rnd(B, Lk, KV * D), rnd(B, Lk, KV * D)
        s, c = _rope_sin_cos(Lk, D, 10000.0, cuda_device)
        pos = torch.randperm(Lk, generator=g, device=cuda_device)[:Lq]
        sq, cq = s[pos].contiguous(), c[pos].contiguous()
        before = TR.flash_attention_rope_qonly.launches
        got = TR.flash_attention_rope_qonly(q, k, v, sq, cq, n_heads=H,
                                            n_kv_heads=KV)
        assert TR.flash_attention_rope_qonly.launches == before + 1
        want = TR.flash_attention_rope_qonly_reference(
            q, k, v, sq, cq, n_heads=H, n_kv_heads=KV)
        torch.testing.assert_close(got.float(), want.float(), **tol)

        q4, k4, v4 = (t.view(B, t.shape[1], -1, D) for t in (q, k, v))
        before = TF.flash_attention.launches
        got = TF.flash_attention(q4, k4, v4)
        assert TF.flash_attention.launches == before + 1
        want = TA._xla_attention(q4, k4, v4, None)
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [1, 3, None])
@pytest.mark.parametrize("Lq", [1, 16, 65, 308, 600])
def test_qonly_bf16_split_on_cuda(cuda_device, monkeypatch, Lq, n_split):
    """K2's bf16 tensor-core path against its plain version: partial and
    full shapes, split-K forced off (1), on (3) and planned (None); GQA 8/2,
    per-row tables, a padding bias and one row masked on every key."""
    from mmada_parallel_torch.models.llada import _rope_sin_cos
    if n_split is not None:
        monkeypatch.setattr(TR, "plan_splits", lambda *args: n_split)
    g = torch.Generator(device=cuda_device).manual_seed(Lq)
    B, Lk, H, KV, D = 2, 600, 8, 2, 128
    q, k, v = (torch.randn(B, L, n * D, generator=g, device=cuda_device
                           ).bfloat16() for L, n in ((Lq, H), (Lk, KV),
                                                     (Lk, KV)))
    s, c = _rope_sin_cos(Lk, D, 10000.0, cuda_device)
    pos = torch.stack([torch.randperm(Lk, generator=g, device=cuda_device
                                      )[:Lq] for _ in range(B)]).sort().values
    sq, cq = s[pos].contiguous(), c[pos].contiguous()
    keep = torch.arange(Lk, device=cuda_device) < torch.tensor(
        [Lk, 350], device=cuda_device)[:, None]
    bias = torch.where(keep[:, None, None, :], 0.0, -1e30).expand(
        B, 1, Lq, Lk).contiguous()
    bias[1, 0, Lq // 2, :] = -1e30
    kw = dict(n_heads=H, n_kv_heads=KV)
    before = TR.flash_attention_rope_qonly.launches
    got = TR.flash_attention_rope_qonly(q, k, v, sq, cq, bias, **kw)
    assert TR.flash_attention_rope_qonly.launches == before + 1
    want = TR.flash_attention_rope_qonly_reference(q, k, v, sq, cq, bias,
                                                   **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1e-2)


def test_masks_match_jax():
    from mmada_parallel_tpu.ops import masks as JM
    from mmada_parallel_torch.ops import masks as TM
    m = np.random.default_rng(40).random((3, 17)) > 0.3
    m[2] = False                                  # an all-pad row
    tm = torch.from_numpy(m)
    pair = TM.pairwise_padding_mask(tm)
    np.testing.assert_array_equal(pair.numpy(), np.asarray(
        JM.pairwise_padding_mask(jnp.asarray(m))))
    np.testing.assert_array_equal(TM.ragged_positions(tm).numpy(),
                                  np.asarray(JM.ragged_positions(
                                      jnp.asarray(m))))
    bias = TM.to_bias(pair)
    assert bias.dtype == torch.float32
    np.testing.assert_array_equal(bias.numpy(), np.asarray(
        JM.to_bias(JM.pairwise_padding_mask(jnp.asarray(m)))))
