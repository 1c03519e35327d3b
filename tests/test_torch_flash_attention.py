"""K3, the BLHD flash attention (``ops/flash_attention.py``): its CPU path
against the JAX package's Pallas kernel in interpret mode at shapes that
reach the CUDA kernels' edges, and, on the card (``cuda``-marked), the bf16
warp-specialised body (``csrc/attention_ws.cuh``) against the plain version
at the tolerance ``chip_smoke.py`` states (a few bf16 ulps: p is rounded to
bf16 per key tile in the kernel, after normalising in the plain softmax),
its row statistics against the plain softmax's, and its bits on a repeat.
On the CPU, ``chip_smoke.ptxas_entries`` reads the body's registers and
spills from a sample build report."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu.ops import flash_attention as JF
from mmada_parallel_torch.ops import attention as TA
from mmada_parallel_torch.ops import attention_bwd as TB
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


# The warp-specialised body's edges beside EDGES: B=2 with Lq = Lk = 1000,
# so the last 128-row q tile and 64-key tile meet the batch boundary,
# without a bias and with one under GQA 32/8
WS_CASES = EDGES + [(2, 1000, 1000, 32, 32, 128, False),
                    (2, 1000, 1000, 32, 8, 128, True)]
# the statistics against the plain softmax's: test_stats_are_the_softmax's
# tolerance (tests/test_torch_attention_bwd.py)
STATS_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,bias", WS_CASES)
def test_ws_body_stats_and_repeat_on_cuda(cuda_device, B, Lq, Lk, H, KV, D,
                                          bias):
    """The body's output against the plain version, its row statistics
    ``(m, log2 l)`` against ``attention_stats_reference``, and both bit
    for bit on a second launch."""
    g = torch.Generator(device=cuda_device).manual_seed(Lq + Lk)
    q, k, v = (torch.randn(B, n, h, D, generator=g, device=cuda_device
                           ).bfloat16() for n, h in ((Lq, H), (Lk, KV),
                                                     (Lk, KV)))
    b = torch.tensor(_bias(B, Lq, Lk), device=cuda_device) if bias \
        else None
    got, stats = TF.flash_attention(q, k, v, b, with_stats=True)
    again, stats_again = TF.flash_attention(q, k, v, b, with_stats=True)
    assert torch.equal(got, again) and torch.equal(stats, stats_again)
    torch.testing.assert_close(got.float(),
                               TA._xla_attention(q, k, v, b).float(),
                               **BF16_TOL)
    torch.testing.assert_close(stats, TB.attention_stats_reference(q, k, b),
                               **STATS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,KV,D,bias", WS_CASES[-2:])
def test_ws_body_equals_the_previous_body_on_cuda(cuda_device, B, Lq, Lk, H,
                                                  KV, D, bias):
    """K3 and K2's unsplit path (512 work items, no split on a 132-SM card)
    with identity rotation tables run the same warp-specialised body on the
    same q, k, v and give the same output and statistics bit for bit (the
    body's equality with the cp.async body before it is recorded by
    ``chip_ab.py --against``)."""
    from mmada_parallel_torch.ops import rope_attention as TR
    g = torch.Generator(device=cuda_device).manual_seed(Lq + Lk + 1)
    q, k, v = (torch.randn(B, n, h, D, generator=g, device=cuda_device
                           ).bfloat16() for n, h in ((Lq, H), (Lk, KV),
                                                     (Lk, KV)))
    b = torch.tensor(_bias(B, Lq, Lk), device=cuda_device) if bias \
        else None
    assert TR.plan_splits(B, H, Lq, Lk, TR._sm_count(cuda_device), D,
                          KV) == 1
    got, stats = TF.flash_attention(q, k, v, b, with_stats=True)
    cos = torch.ones(Lq, D, device=cuda_device)
    old, old_stats = TR.flash_attention_rope_qonly(
        q.flatten(2), k.flatten(2), v.flatten(2), torch.zeros_like(cos), cos,
        b, n_heads=H, n_kv_heads=KV, with_stats=True)
    assert torch.equal(got.flatten(2), old)
    assert torch.equal(stats, old_stats)


FWD_PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__b4e1a1c2_18_flash_attention_cu_5f2f1a6e2tc19attention_ws_kernelILi128ELb0EEEv14CUtensorMap_stS2_S2_PKfP13__nv_bfloat16P6float2iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__b4e1a1c2_18_flash_attention_cu_5f2f1a6e2tc19attention_ws_kernelILi128ELb0EEEv14CUtensorMap_stS2_S2_PKfP13__nv_bfloat16P6float2iiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__b4e1a1c2_18_flash_attention_cu_5f2f1a6e2tc20attention_mma_kernelILi64ELb1ELb0ELb0EEEvPK13__nv_bfloat16S4_S4_PKfPKiPS2_PfP6float2SB_iiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__b4e1a1c2_18_flash_attention_cu_5f2f1a6e2tc20attention_mma_kernelILi64ELb1ELb0ELb0EEEvPK13__nv_bfloat16S4_S4_PKfPKiPS2_PfP6float2SB_iiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__b4e1a1c2_18_flash_attention_cu_5f2f1a6e2tc19attention_ws_kernelILi64ELb1EEEv14CUtensorMap_stS2_S2_PKfP13__nv_bfloat16P6float2iiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__b4e1a1c2_18_flash_attention_cu_5f2f1a6e2tc19attention_ws_kernelILi64ELb1EEEv14CUtensorMap_stS2_S2_PKfP13__nv_bfloat16P6float2iiiif
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__0c2d6f7a_26_flash_attention_rope_qonly_cu_3e0a1b2c2tc19attention_ws_kernelILi128ELb1ELb1ELb0ELb1EEEv14CUtensorMap_stS2_S2_PKfPKiP13__nv_bfloat16PfP6float2SC_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__0c2d6f7a_26_flash_attention_rope_qonly_cu_3e0a1b2c2tc19attention_ws_kernelILi128ELb1ELb1ELb0ELb1EEEv14CUtensorMap_stS2_S2_PKfPKiP13__nv_bfloat16PfP6float2SC_iiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__5d1e9c3b_27_flash_attention_rope_prefix_cu_7a4f2e1d2tc19attention_ws_kernelILi64ELb0ELb0ELb1ELb0EEEv14CUtensorMap_stS2_S2_PKfPKiP13__nv_bfloat16PfP6float2SC_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__5d1e9c3b_27_flash_attention_rope_prefix_cu_7a4f2e1d2tc19attention_ws_kernelILi64ELb0ELb0ELb1ELb0EEEv14CUtensorMap_stS2_S2_PKfPKiP13__nv_bfloat16PfP6float2SC_iiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__5d1e9c3b_20_flash_attention_cu_7a4f2e1d2tc19attention_ws_kernelILi128ELb1ELb0ELb0ELb0EEEv14CUtensorMap_stS2_S2_PKfPKiP13__nv_bfloat16PfP6float2SC_iiiiiif' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__5d1e9c3b_20_flash_attention_cu_7a4f2e1d2tc19attention_ws_kernelILi128ELb1ELb0ELb0ELb0EEEv14CUtensorMap_stS2_S2_PKfPKiP13__nv_bfloat16PfP6float2SC_iiiiiif
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
"""


def test_ptxas_report_reads_the_forward_body():
    """``chip_smoke.ptxas_entries`` takes the warp-specialised forward
    body's registers and spill bytes by its flags (split-K, prefix bounds,
    one consumer warpgroup), D and bias, from names with and without the
    flags, and nothing of
    another body (the retired ``attention_mma_kernel``)."""
    import chip_smoke
    assert chip_smoke.ptxas_entries(FWD_PTXAS_LOG) == {
        ("fwd", 128, False): (168, 0, 0), ("fwd", 64, True): (168, 8, 12),
        ("fwd-split-solo", 128, True): (168, 0, 0),
        ("fwd-prefix", 64, False): (168, 0, 0),
        ("fwd", 128, True): (168, 0, 0)}


def test_ab_variants_apply_to_the_forward_body():
    """Every variant of ``chip_ab.py`` (the forward body's same-run A/B) is
    a set of edits that each match ``csrc/attention_ws.cuh`` exactly once,
    and the variants differ from the header and from each other."""
    import os
    import chip_ab
    with open(os.path.join(chip_ab.REPO, chip_ab.HEADER)) as f:
        header = f.read()
    texts = set()
    for name, edits in chip_ab.VARIANTS.items():
        text = header
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        texts.add(text)
    assert len(texts) == len(chip_ab.VARIANTS)


def test_profile_classes_the_attention_bodies():
    """``chip_smoke._profile`` counts the warp-specialised body (K1-K4)
    with the attention kernels, as it counts the f32 template, the pre-pass
    and the combine, and the backward apart."""
    import chip_smoke
    fwd = "attention kernels K1-K4"
    for name, cls in (
            ("void (anonymous namespace)::tc::attention_ws_kernel<128, false>"
             "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*)",
             fwd),
            ("void (anonymous namespace)::attention_kernel<128, true, true>()",
             fwd),
            ("void (anonymous namespace)::rope_rotate_kernel<128>()", fwd),
            ("void (anonymous namespace)::tc::split_combine_kernel<128>()",
             fwd),
            ("void (anonymous namespace)::tc::attention_bwd_dq_kernel<128, "
             "false>(CUtensorMap_st)", "attention backward kernels"),
            ("void (anonymous namespace)::rope_rotate_bwd_kernel<128>()",
             "attention backward kernels"),
            ("nvjet_tst_128x304_64x3_2x1_v_bz_coopA_NNT",
             "bf16 tensor-core GEMMs")):
        assert chip_smoke._kernel_class(name) == cls, name
