"""K3, the BLHD flash attention (``ops/flash_attention.py``): its CPU path
against the JAX package's Pallas kernel in interpret mode at shapes that
reach the CUDA kernels' edges, and, on the card (``cuda``-marked), the bf16
tensor-core body (``csrc/attention_mma.cuh``) against the plain version at
the tolerance ``chip_smoke.py`` states (a few bf16 ulps: p is rounded to
bf16 per key tile in the kernel, after normalising in the plain softmax)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu.ops import flash_attention as JF
from mmada_parallel_torch.ops import attention as TA
from mmada_parallel_torch.ops import flash_attention as TF

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)       # f32, the JAX kernel tests' own
BF16_TOL = dict(atol=1e-2, rtol=1e-2)

# (B, Lq, Lk, H, KV, D, bias): D=64; Lq/Lk off the 128-row and 64-key
# tiles; GQA 32/8; a padding bias with a fully masked row and an odd Lk
EDGES = [(2, 100, 260, 4, 4, 64, False), (1, 197, 517, 32, 8, 128, False),
         (2, 190, 301, 4, 2, 64, True), (2, 130, 130, 8, 2, 128, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _bias(B, Lq, Lk):
    """A pairwise padding bias (rows keep Lk and Lk // 2 keys) with row 3 of
    batch row 0 fully masked, f32 -1e30."""
    keep = np.arange(Lk)[None] < np.array([Lk, Lk // 2])[:B, None]
    b = np.where(keep[:, None, None, :], 0.0, -1e30).astype(np.float32)
    b = np.broadcast_to(b, (B, 1, Lq, Lk)).copy()
    b[0, 0, 3] = -1e30
    return b


@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,bias", EDGES)
def test_cpu_path_matches_pallas(B, Lq, Lk, H, KV, D, bias):
    rng = np.random.default_rng(Lq)
    q, k, v = (rng.normal(size=(B, n, h, D)).astype(np.float32)
               for n, h in ((Lq, H), (Lk, KV), (Lk, KV)))
    b = _bias(B, Lq, Lk) if bias else None
    before = TF.flash_attention.launches
    got = TF.flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                             torch.tensor(b) if bias else None).numpy()
    assert TF.flash_attention.launches == before     # the CPU launches none
    want = np.asarray(JF.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)),
        jnp.asarray(b) if bias else None, interpret=True))
    rows = np.ones((B, Lq), bool)
    if bias:        # a fully masked row: the Pallas kernel averages v over
        rows[0, 3] = False      # its key padding too (see flash_attention.cu)
    np.testing.assert_allclose(got[rows], want[rows], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,bias", EDGES)
def test_tensor_core_body_on_cuda(cuda_device, B, Lq, Lk, H, KV, D, bias):
    g = torch.Generator(device=cuda_device).manual_seed(Lk)
    q, k, v = (torch.randn(B, n, h, D, generator=g, device=cuda_device
                           ).bfloat16() for n, h in ((Lq, H), (Lk, KV),
                                                     (Lk, KV)))
    b = torch.tensor(_bias(B, Lq, Lk), device=cuda_device) if bias \
        else None
    before = TF.flash_attention.launches
    got = TF.flash_attention(q, k, v, b)
    assert TF.flash_attention.launches == before + 1
    want = TA._xla_attention(q, k, v, b)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
