"""The fused GroupNorm + swish (``ops/group_norm.py``, ``csrc/group_norm.cu``).

On the CPU: the wrapper runs the plain chain, ``swish(group_norm(...))``,
bit for bit, in f32 and bf16, with and without the swish; both routes'
plans cover every group of the tokenizers' shapes in whole vectors within
the kernels' limits; the ctypes binding matches the C entry points; each
``vqgan_common.norm_swish`` call is a ``vq.norm`` span (under ``vq.encode``
in an encode) that adds one read and one write of its input to
``vq.norm_bytes``.  On the card (``cuda``-marked): the kernel against the
JAX package's ``group_norm`` and ``swish`` (on the CPU) at every group shape
of the tokenizers, and against the plain chain at every group shape of
MagViT-v2's and Amused-VQ's encoders and decoders at B = 1, 4 and 8,
contiguous and channels-last (f32 to 1e-5, bf16 to one ulp; the plain
chain's layout kept), ragged groups, an input whose mean is far from 0
(against an f64 chain), channels-last groups the route declines, bits on a
repeat, the gradient refusal, and one launch a norm in an encode with no
op of the plain chain."""

import ctypes
import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmada_parallel_torch.models import amused_vq as AVQ
from mmada_parallel_torch.models import magvit2 as MVQ
from mmada_parallel_torch.models import vqgan_common as C
from mmada_parallel_torch.ops import _cuda
from mmada_parallel_torch.ops import group_norm as GN
from mmada_parallel_torch.utils import spans

torch.set_num_threads(1)
DTYPES = [torch.float32, torch.bfloat16]
F32_ATOL = 1e-5         # the kernel against the plain chain, also rtol


def _tokenizer_shapes():
    """The distinct ``(C, H, W, swish)`` of every fused call in MagViT-v2's
    and Amused-VQ's encoders and decoders at 512x512, traced on the meta
    device."""
    seen = []

    def record(x, scale, bias, groups=32, eps=1e-6, swish=True):
        seen.append((*x.shape[1:], swish))
        return x

    real, C.group_norm_swish = C.group_norm_swish, record
    try:
        g = torch.Generator()
        m = MVQ.MagvitConfig()
        mp = MVQ.init_magvit_params(m, g, device="meta")
        MVQ._encoder(mp["encoder"], m, torch.empty(1, 3, 512, 512,
                                                   device="meta"))
        MVQ._decoder(mp["decoder"], m, torch.empty(1, m.z_channels, 32, 32,
                                                   device="meta"))
        a = AVQ.AmusedVQConfig()
        ap = AVQ.init_amused_vq_params(a, g, device="meta")
        AVQ.amused_encode(ap, a, torch.empty(1, 512, 512, 3, device="meta"))
        AVQ.amused_decode_code(ap, a, torch.zeros(1, 1024, dtype=torch.long),
                               (32, 32))
    finally:
        C.group_norm_swish = real
    return list(dict.fromkeys(seen))


SHAPES = _tokenizer_shapes()


def _inputs(B, Cc, H, W, dtype, device, seed, offset=0.5):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, Cc, H, W, generator=g, device=device) * 2.0 + offset
    scale = torch.rand(Cc, generator=g, device=device) + 0.5
    bias = torch.rand(Cc, generator=g, device=device) - 0.5
    return x.to(dtype), scale, bias


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


def test_traced_shapes_are_the_tokenizers_norms():
    assert len(SHAPES) == 13
    assert (128, 512, 512, True) in SHAPES            # MagViT-v2 level 0
    assert (512, 32, 32, False) in SHAPES             # its attention norm
    assert (768, 32, 32, False) in SHAPES             # Amused-VQ's
    assert all(c % 32 == 0 for c, *_ in SHAPES)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("shape, groups", [((2, 16, 5, 7), 4),
                                           ((1, 64, 8, 8), 32)])
def test_cpu_wrapper_is_the_plain_chain_bit_for_bit(dtype, swish, shape,
                                                    groups):
    x, scale, bias = _inputs(*shape, dtype, "cpu", 3)
    p = {"scale": scale, "bias": bias}
    want = C.group_norm(p, x, groups, 1e-6)
    if swish:
        want = C.swish(want)
    before = GN.group_norm_swish.launches
    got = GN.group_norm_swish(x, scale, bias, groups, 1e-6, swish)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(C.norm_swish(p, x, groups, 1e-6, swish), want)
    assert GN.group_norm_swish.launches == before       # no kernel on a CPU


@pytest.mark.parametrize("elem_size", [4, 2])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_plans_cover_each_tokenizer_group(B, elem_size):
    """Both routes' plans cover every element in whole vectors, within the
    kernels' limits; the channels-last route declines groups of channels
    that are not whole vectors (bf16 at MagViT-v2's 128 channels)."""
    vec = 16 // elem_size
    for Cc, H, W, _ in SHAPES + [(96, 601, 601, True), (6, 7, 7, True)]:
        groups = 32 if Cc >= 32 else 2
        group = Cc // groups * H * W
        plan = GN.plan_group_norm(B, Cc, H * W, groups, elem_size, 132)
        assert plan.elems % vec == 0
        assert plan.elems * elem_size <= GN.CHUNK_BYTES
        assert plan.chunks * plan.elems >= group > (plan.chunks - 1) * \
            plan.elems
        cl = GN.channels_last_plan(B, Cc, H * W, groups, elem_size, 132)
        if (Cc // groups) % vec:
            assert cl is None
            continue
        assert cl.threads <= 1024 and cl.threads % (Cc // vec) == 0
        assert cl.tiles * cl.pixels >= H * W > (cl.tiles - 1) * cl.pixels
        assert cl.pixels * Cc * elem_size <= GN.CHUNK_BYTES
    # MagViT-v2's level 0 at the M trainer's batch: 4 MB groups in 64 KB
    # chunks, or tiles of 128 pixels of its 128 channels
    assert GN.plan_group_norm(4, 128, 512 * 512, 32, 4, 132) == (64, 16384)
    assert GN.channels_last_plan(4, 128, 512 * 512, 32, 4, 132) == (
        256, 2048, 128)
    assert GN.channels_last_plan(4, 128, 64, 32, 2, 132) is None


@pytest.mark.parametrize("entry", ["mmada_group_norm", "mmada_group_norm_cl"])
def test_the_binding_matches_the_entry_point(entry):
    """``_cuda._SIGNATURES`` declares the C entry points' parameters as
    ``csrc/group_norm.cu`` has them (ctypes would otherwise refuse or
    cut an argument)."""
    src = open(os.path.join(_cuda.CSRC, "group_norm.cu")).read()
    params = re.search(r'extern "C" int ' + entry + r'\(([^)]*)\)',
                       src).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    want = [kinds.get(p.strip().rsplit(" ", 1)[0], ctypes.c_void_p)
            for p in params.split(",")]
    assert _cuda._SIGNATURES[entry] == (want, ctypes.c_int)


def _tree(records):
    return [(name, None if parent is None else records[parent][0])
            for name, _, _, parent in records]


def test_a_fused_call_spans_vq_norm_and_counts_its_bytes():
    x, scale, bias = _inputs(2, 16, 5, 7, torch.bfloat16, "cpu", 4)
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("vq.encode"):
            C.norm_swish({"scale": scale, "bias": bias}, x, 4)
    assert _tree(spans.records()) == [("vq.encode", None),
                                      ("vq.norm", "vq.encode")]
    assert spans.counters() == {"vq.norm_bytes": 2 * x.numel() * 2}


def test_an_encode_opens_a_vq_norm_span_a_norm(monkeypatch):
    """The tiny MagViT-v2's encode: one ``vq.norm`` under ``vq.encode`` a
    norm of the encoder, and their bytes in ``vq.norm_bytes``."""
    cfg = MVQ.MagvitConfig.tiny()
    params = MVQ.init_magvit_params(cfg, torch.Generator().manual_seed(0))
    seen = []
    plain = GN.group_norm_swish_reference

    def record(x, *args):
        seen.append(2 * x.numel() * x.element_size())
        return plain(x, *args)

    monkeypatch.setattr(GN, "group_norm_swish_reference", record)
    px = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]):
        codes = MVQ.magvit_get_code(params, cfg, px * 2 - 1)
    norms = 2 * sum(cfg.enc_blocks) + 5 + 1    # blocks, mid, norm_out
    assert len(seen) == norms and codes.shape == (2, 64)
    assert _tree(spans.records()) == [("vq.encode", None)] + [
        ("vq.norm", "vq.encode")] * norms
    assert spans.counters() == {"vq.norm_bytes": sum(seen)}


# ---------------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _ordinal(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in their order (adjacent values differ by
    1), for distances in ulps."""
    b = t.view(torch.int16).to(torch.int32)
    return torch.where(b < 0, -(b & 0x7FFF), b)


def _strides(t: torch.Tensor) -> list:
    """The layout: the strides of the dimensions longer than 1."""
    return [st for st, n in zip(t.stride(), t.shape) if n > 1]


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((_ordinal(a) - _ordinal(b)).abs().max())


def _within_an_ulp(got: torch.Tensor, want: torch.Tensor) -> bool:
    """bf16 ``got`` within one ulp of ``want``, or within F32_ATOL where
    ``want`` is so near 0 that its ulp is smaller: the two f32 values before
    the rounding differ by the statistics' rounding, ~1e-7 absolute."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    return bool(((got.float() - w).abs() <= torch.maximum(
        ulp, torch.full_like(w, F32_ATOL))).all())


def _check(x, scale, bias, groups, name):
    """The kernel against the plain chain, with and without the swish: f32
    to 1e-5; bf16 within one ulp of the plain norm (or F32_ATOL near 0),
    the swish within one ulp of the plain swish of the kernel's own norm,
    and of the plain chain where the norms agree."""
    norm = GN.group_norm_swish(x, scale, bias, groups, 1e-6, False)
    sw = GN.group_norm_swish(x, scale, bias, groups, 1e-6, True)
    want_norm = GN.group_norm_swish_reference(x, scale, bias, groups, 1e-6,
                                              False)
    want_sw = C.swish(want_norm)
    assert torch.isfinite(norm).all() and torch.isfinite(sw).all(), name
    for got, want in ((norm, want_norm), (sw, want_sw)):    # the layout
        assert _strides(got) == _strides(want), name
    if x.dtype == torch.float32:
        torch.testing.assert_close(norm, want_norm, rtol=1e-5,
                                   atol=F32_ATOL, msg=name)
        torch.testing.assert_close(sw, want_sw, rtol=1e-5, atol=F32_ATOL,
                                   msg=name)
        return
    assert _within_an_ulp(norm, want_norm), name
    assert _ulps(sw, C.swish(norm)) <= 1, name
    same = norm == want_norm
    assert _ulps(sw[same], want_sw[same]) <= 1, name


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_against_the_plain_chain_on_cuda(cuda_device, B, shape,
                                                layout):
    """Contiguous inputs, and channels-last ones (the tokenizers' residual
    stream after the pixels' NHWC permute; bf16 at 4 channels a group
    takes the contiguous route and comes back channels-last)."""
    Cc, H, W, _ = shape
    for dtype in DTYPES:
        x, scale, bias = _inputs(B, Cc, H, W, dtype, cuda_device,
                                 B * Cc + H)
        if layout == "channels_last":
            x = x.to(memory_format=torch.channels_last)
        _check(x, scale, bias, 32, f"B={B} {shape} {dtype} {layout}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_against_the_jax_norm_on_cuda(cuda_device, shape):
    """The kernel on the card against the JAX package's ``group_norm`` and
    ``swish`` (NHWC, on the CPU) on the same f32 inputs at B = 2, with and
    without the swish, contiguous and channels-last, to 1e-5."""
    import jax
    import numpy as np
    from mmada_parallel_tpu.models import vqgan_common as JC
    Cc, H, W, _ = shape
    x, scale, bias = _inputs(2, Cc, H, W, torch.float32, cuda_device,
                             Cc + H)
    cpu = jax.devices("cpu")[0]
    p = {"scale": jax.device_put(scale.cpu().numpy(), cpu),
         "bias": jax.device_put(bias.cpu().numpy(), cpu)}
    norm = JC.group_norm(p, jax.device_put(
        x.permute(0, 2, 3, 1).cpu().numpy(), cpu), 32, 1e-6)
    for swish, want in ((False, norm), (True, JC.swish(norm))):
        want = torch.from_numpy(np.asarray(want)).permute(0, 3, 1, 2)
        for xl in (x, x.to(memory_format=torch.channels_last)):
            got = GN.group_norm_swish(xl, scale, bias, 32, 1e-6, swish)
            torch.testing.assert_close(
                got.cpu(), want, rtol=1e-5, atol=F32_ATOL,
                msg=f"{shape} swish={swish} {_strides(xl)}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape, groups", [((2, 6, 7, 7), 2),
                                           ((2, 96, 333, 333), 32),
                                           ((1, 96, 601, 601), 32)])
def test_ragged_groups_on_cuda(cuda_device, shape, groups):
    """Groups of 147, 332 667 and 1 083 603 elements (not whole 16-byte
    vectors; channels of 49 elements cross vectors)."""
    B, Cc, H, W = shape
    assert (Cc // groups * H * W) % 4
    for dtype in DTYPES:
        x, scale, bias = _inputs(B, Cc, H, W, dtype, cuda_device, H)
        _check(x, scale, bias, groups, f"{shape} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape, layout", [
    ((4, 256, 128, 128), torch.contiguous_format),
    ((4, 128, 512, 512), torch.contiguous_format),
    ((4, 128, 512, 512), torch.channels_last)],
    ids=["small-groups", "large-groups", "channels_last"])
def test_mean_far_from_zero_on_cuda(cuda_device, shape, layout):
    """Offset 1e3, unit spread: against the chain in f64, the kernel's
    error is at most twice the plain f32 chain's."""
    B, Cc, H, W = shape
    g = torch.Generator(device=cuda_device).manual_seed(7)
    x = (torch.randn(B, Cc, H, W, generator=g, device=cuda_device)
         + 1e3).to(memory_format=layout)
    scale = torch.rand(Cc, generator=g, device=cuda_device) + 0.5
    bias = torch.rand(Cc, generator=g, device=cuda_device) - 0.5
    xd = x.double().reshape(B, 32, -1)
    mean = xd.mean(-1, keepdim=True)
    var = xd.var(-1, unbiased=False, keepdim=True)
    want = ((xd - mean) / torch.sqrt(var + 1e-6)).reshape(x.shape) \
        * scale.double()[:, None, None] + bias.double()[:, None, None]
    want = want * torch.sigmoid(want)
    plain = GN.group_norm_swish_reference(x, scale, bias, 32, 1e-6)
    got = GN.group_norm_swish(x, scale, bias, 32, 1e-6)
    plain_err = float((plain.double() - want).abs().max())
    err = float((got.double() - want).abs().max())
    assert err <= 2 * plain_err, (err, plain_err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, layout", [
    ((4, 256, 128, 128), torch.contiguous_format),
    ((4, 128, 512, 512), torch.contiguous_format),
    ((4, 128, 512, 512), torch.channels_last)],
    ids=["small-groups", "large-groups", "channels_last"])
def test_bits_on_a_repeat_on_cuda(cuda_device, shape, layout):
    x, scale, bias = _inputs(*shape, torch.float32, cuda_device, 9)
    x = x.to(memory_format=layout)
    a = GN.group_norm_swish(x, scale, bias)
    assert torch.equal(a, GN.group_norm_swish(x, scale, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("shape, groups, dtype", [
    ((2, 96, 33, 33), 32, torch.float32),
    ((2, 128, 64, 64), 32, torch.bfloat16),
    ((2, 6, 7, 7), 2, torch.float32),
    ((1, 8, 32, 32), 4, torch.float32)])
def test_channels_last_groups_the_route_does_not_take_on_cuda(
        cuda_device, shape, groups, dtype):
    """Groups of 3 or 2 f32 or 4 bf16 channels (not whole 16-byte vectors;
    the last is the tiny Amused-VQ's first norm): through the contiguous
    route and back to channels-last."""
    x, scale, bias = _inputs(*shape, dtype, cuda_device, 5)
    assert GN.channels_last_plan(shape[0], shape[1], shape[2] * shape[3],
                                 groups, x.element_size(), 132) is None
    _check(x.to(memory_format=torch.channels_last), scale, bias, groups,
           f"{shape} {dtype}")


@pytest.mark.cuda
def test_an_input_that_requires_grad_raises_on_cuda(cuda_device):
    x, scale, bias = _inputs(1, 64, 8, 8, torch.float32, cuda_device, 1)
    with pytest.raises(RuntimeError, match="requires grad"):
        GN.group_norm_swish(x.requires_grad_(), scale, bias)
    with torch.no_grad():
        GN.group_norm_swish(x, scale, bias)


@pytest.mark.cuda
def test_an_encode_launches_once_a_norm_on_cuda(cuda_device):
    """MagViT-v2's encode: 42 launches, and no PyTorch norm, sigmoid or
    reduction of the plain chain."""
    cfg = MVQ.MagvitConfig()
    params = MVQ.init_magvit_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    px = torch.rand(1, 64, 64, 3, device=cuda_device) * 2 - 1
    before = GN.group_norm_swish.launches
    with torch.inference_mode(), C.vq_precision(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        MVQ.magvit_get_code(params, cfg, px)
    assert GN.group_norm_swish.launches - before == 42
    ops = {e.key for e in prof.key_averages()}
    for name in ("aten::sigmoid", "aten::var", "aten::mean",
                 "aten::group_norm", "aten::native_group_norm"):
        assert name not in ops, name
    s = spans.summary()["vq.norm"]
    assert s["n"] == 42 and s["device_s"] > 0
