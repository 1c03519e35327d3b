"""The port's task masks and prefix-bounds attention against the JAX package.

* Every mask function (causal, t2i with and without ``pad_ends``, mmu,
  mixed, ``prefix_bounds``, ``mixed_prefix_bounds``) equals JAX's exactly,
  and the bounds equal the dense masks (``dense == kv < bounds``).
* ``flash_attention_rope_prefix_reference`` (the plain version of the K4
  kernel) equals JAX's ``flash_attention_rope_prefix`` in Pallas interpret
  mode at the JAX tests' toy shapes (B=2, Lq=160, H=2, D=128), with GQA, a
  bound-0 row and a bound past Lk, in f32 at atol = rtol = 2e-5 (the JAX
  kernel tests' tolerance: the same math up to summation order).
* ``rope_attention_prefix(impl="xla")`` gradients equal JAX's at 1e-5.
The CUDA kernel is held to the plain version on the card (``chip_smoke.py``
and the ``cuda``-marked test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_parallel_tpu.models.llada import _rope_sin_cos as jax_tables
from mmada_parallel_tpu.ops import attention as JA
from mmada_parallel_tpu.ops import masks as JM
from mmada_parallel_tpu.ops.rope_attention import \
    flash_attention_rope_prefix as jax_prefix_kernel
from mmada_parallel_torch.ops import attention as TA
from mmada_parallel_torch.ops import masks as TM
from mmada_parallel_torch.ops import rope_attention as TR

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
L = 21
SPANS = ((3, 9), (12, 15))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _pad_ends(B):
    return np.random.default_rng(3).integers(0, 6, (B, L)).astype(np.int32)


MASK_CASES = {
    "causal": (lambda: JM.causal_mask(L), lambda: TM.causal_mask(L)),
    "t2i": (lambda: JM.t2i_mask(L, SPANS), lambda: TM.t2i_mask(L, SPANS)),
    "t2i_pad_ends": (
        lambda: JM.t2i_mask(L, SPANS, jnp.asarray(_pad_ends(2))),
        lambda: TM.t2i_mask(L, SPANS, torch.tensor(_pad_ends(2)))),
    "mmu": (lambda: JM.mmu_mask(L, 7), lambda: TM.mmu_mask(L, 7)),
    "mixed": (lambda: JM.mixed_mask(L, 2, 1, 2, SPANS, 7),
              lambda: TM.mixed_mask(L, 2, 1, 2, SPANS, 7)),
    "mixed_pad_ends": (
        lambda: JM.mixed_mask(L, 2, 1, 1, SPANS, 7,
                              jnp.asarray(_pad_ends(4))),
        lambda: TM.mixed_mask(L, 2, 1, 1, SPANS, 7,
                              torch.tensor(_pad_ends(4)))),
    "prefix_bounds_causal": (lambda: JM.prefix_bounds(L),
                             lambda: TM.prefix_bounds(L)),
    "prefix_bounds_mmu": (lambda: JM.prefix_bounds(L, 7),
                          lambda: TM.prefix_bounds(L, 7)),
    "prefix_bounds_t2i": (lambda: JM.prefix_bounds(L, 0, SPANS),
                          lambda: TM.prefix_bounds(L, 0, SPANS)),
    "mixed_prefix_bounds": (
        lambda: JM.mixed_prefix_bounds(L, 2, 1, 2, SPANS, 7),
        lambda: TM.mixed_prefix_bounds(L, 2, 1, 2, SPANS, 7)),
}


@pytest.mark.parametrize("case", sorted(MASK_CASES))
def test_masks_equal_jax(case):
    jfn, tfn = MASK_CASES[case]
    want, got = np.asarray(jfn()), tfn().numpy()
    assert got.shape == want.shape
    if want.dtype != bool:
        assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["causal", "mmu", "t2i", "mixed"])
def test_bounds_equal_dense_masks(kind):
    cols = np.arange(L)
    if kind == "mixed":
        dense = TM.mixed_mask(L, 2, 1, 2, SPANS, 7).numpy()[:, 0]
        hi = TM.mixed_prefix_bounds(L, 2, 1, 2, SPANS, 7).numpy()
        np.testing.assert_array_equal(dense,
                                      cols[None, None] < hi[:, :, None])
        return
    dense, hi = {
        "causal": (TM.causal_mask(L), TM.prefix_bounds(L)),
        "mmu": (TM.mmu_mask(L, 7), TM.prefix_bounds(L, 7)),
        "t2i": (TM.t2i_mask(L, SPANS), TM.prefix_bounds(L, 0, SPANS)),
    }[kind]
    np.testing.assert_array_equal(dense.numpy()[0, 0],
                                  cols[None, :] < hi.numpy()[:, None])


def _toy(B=2, Lq=160, H=2, KV=2, D=128, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, H * D)).astype(np.float32)
    k = rng.normal(size=(B, Lq, KV * D)).astype(np.float32)
    v = rng.normal(size=(B, Lq, KV * D)).astype(np.float32)
    s, c = (np.asarray(t) for t in jax_tables(Lq, D, 10000.0))
    return q, k, v, s, c


def _bounds(kind, B, Lq):
    if kind == "mixed":
        hi = np.array(JM.mixed_prefix_bounds(Lq, 1, 1, 1, ((16, 96),), 32))
    else:
        spans = ((16, 80),) if kind == "t2i" else ()
        pe = 48 if kind == "mmu" else 0
        hi = np.broadcast_to(np.asarray(JM.prefix_bounds(Lq, pe, spans)),
                             (B, Lq)).copy()
    hi[0, 5] = 0                    # a bound-0 row: attends to key 0
    hi[-1, 7] = Lq + 100            # a bound past Lk: attends to every key
    return hi.astype(np.int32)


@pytest.mark.parametrize("kind,H,KV,B", [("causal", 2, 2, 2),
                                         ("mmu", 2, 2, 2),
                                         ("t2i", 2, 2, 2),
                                         ("causal", 4, 2, 2),
                                         ("mixed", 2, 2, 3)])
def test_reference_matches_jax_interpret_kernel(kind, H, KV, B):
    Lq = 160
    q, k, v, s, c = _toy(B=B, Lq=Lq, H=H, KV=KV)
    hi = _bounds(kind, B, Lq)
    want = np.asarray(jax_prefix_kernel(
        *(jnp.asarray(a) for a in (q, k, v, s, c, hi)), n_heads=H,
        n_kv_heads=KV, block_q=128, block_k=128, interpret=True))
    got = TR.flash_attention_rope_prefix_reference(
        *(torch.tensor(a) for a in (q, k, v, s, c, hi)), n_heads=H,
        n_kv_heads=KV).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the CPU dispatch of every entry point gives the same numbers
    for out in (TR.flash_attention_rope_prefix(
                    *(torch.tensor(a) for a in (q, k, v, s, c, hi)),
                    n_heads=H, n_kv_heads=KV),
                TA.rope_attention_prefix(
                    *(torch.tensor(a) for a in (q, k, v, s, c, hi)),
                    n_heads=H, n_kv_heads=KV)):
        np.testing.assert_array_equal(out.numpy(), got)


def test_prefix_dense_bias_clamps_like_jax():
    hi = np.array([[0, 1, 5, 30], [-4, 9, 9, 2]], np.int32)
    np.testing.assert_array_equal(
        TA._prefix_dense_bias(torch.tensor(hi), 9).numpy(),
        np.asarray(JA._prefix_dense_bias(jnp.asarray(hi), 9)))


def test_rope_attention_prefix_grads_match_jax():
    q, k, v, s, c = _toy(B=2, Lq=40, H=4, KV=2, D=16, seed=4)
    hi = _bounds("mmu", 2, 40)
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    xs = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = TA.rope_attention_prefix(*xs, torch.tensor(s), torch.tensor(c),
                                   torch.tensor(hi), n_heads=4, n_kv_heads=2,
                                   impl="xla")
    got = torch.autograd.grad((out * torch.tensor(w)).sum(), xs)
    want = jax.grad(lambda q, k, v: (JA.rope_attention_prefix(
        q, k, v, s, c, hi, n_heads=4, n_kv_heads=2, impl="xla") * w).sum(),
        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


def test_prefix_refuses_what_it_cannot_run():
    q, k, v, s, c = (torch.tensor(a) for a in _toy(B=1, Lq=96))
    hi = torch.tensor(_bounds("mmu", 1, 96))
    with pytest.raises(ValueError, match="CUDA tensors"):
        TA.rope_attention_prefix(q, k, v, s, c, hi, n_heads=2,
                                 impl="pallas")
    with pytest.raises(ValueError, match="head_dim"):
        TA.rope_attention_prefix(q, k, v, s[:, :64], c[:, :64], hi,
                                 n_heads=8, impl="pallas")
    with pytest.raises(ValueError, match="kv_hi"):
        TR.flash_attention_rope_prefix(q, k, v, s, c, hi.expand(2, 96),
                                       n_heads=2)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda(cuda_device):
    """K4 against its plain version on the card: causal and mixed bounds,
    GQA, f32 and bf16, a bound-0 row and a bound past Lk."""
    from mmada_parallel_torch.models.llada import _rope_sin_cos
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for B, Lq, H, KV, D, dtype, tol in [
            (2, 300, 4, 2, 128, torch.float32, 1e-4),
            (3, 200, 4, 4, 64, torch.float32, 1e-4),
            (2, 300, 8, 2, 128, torch.bfloat16, 1e-2)]:
        q = torch.randn(B, Lq, H * D, generator=g, device=cuda_device)
        k = torch.randn(B, Lq, KV * D, generator=g, device=cuda_device)
        v = torch.randn(B, Lq, KV * D, generator=g, device=cuda_device)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        s, c = _rope_sin_cos(Lq, D, 10000.0, cuda_device)
        hi = TM.mixed_prefix_bounds(Lq, 1, B - 2, 1, ((16, 96),), 40,
                                    device=cuda_device)
        hi[0, 5], hi[-1, 7] = 0, Lq + 100
        got = TR.flash_attention_rope_prefix(q, k, v, s, c, hi, n_heads=H,
                                             n_kv_heads=KV)
        want = TR.flash_attention_rope_prefix_reference(
            q, k, v, s, c, hi, n_heads=H, n_kv_heads=KV)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,D,KV", [("causal", 128, 8), ("causal", 64, 2),
                                       ("mixed", 128, 2), ("edge", 64, 8),
                                       ("edge", 128, 2)])
def test_kernel_bf16_bounds_on_cuda(cuda_device, kind, D, KV):
    """K4's bf16 tensor-core path against its plain version: causal, mixed
    and edge bounds (0, negative and past Lk), D=64 and GQA, an Lq that is
    no multiple of the 128-row q tile."""
    from mmada_parallel_torch.models.llada import _rope_sin_cos
    g = torch.Generator(device=cuda_device).manual_seed(D + KV)
    B, L, H = 3, 333, 8
    q, k, v = (torch.randn(B, L, n * D, generator=g, device=cuda_device
                           ).bfloat16() for n in (H, KV, KV))
    s, c = _rope_sin_cos(L, D, 10000.0, cuda_device)
    if kind == "causal":
        hi = TM.prefix_bounds(L, device=cuda_device)[None].expand(B, L)
    elif kind == "mixed":
        hi = TM.mixed_prefix_bounds(L, 1, 1, 1, ((20, 140),), 60,
                                    device=cuda_device)
    else:
        hi = torch.randint(-3, L + 50, (B, L), generator=g,
                           device=cuda_device)
        hi[0, :7], hi[1, :7] = 0, 10_000
    hi = hi.to(torch.int32).contiguous()
    before = TR.flash_attention_rope_prefix.launches
    got = TR.flash_attention_rope_prefix(q, k, v, s, c, hi, n_heads=H,
                                         n_kv_heads=KV)
    assert TR.flash_attention_rope_prefix.launches == before + 1
    want = TR.flash_attention_rope_prefix_reference(q, k, v, s, c, hi,
                                                    n_heads=H, n_kv_heads=KV)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1e-2)
