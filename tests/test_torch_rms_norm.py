"""The backbone's RMSNorm kernels (``ops/rms_norm.py``, ``csrc/rms_norm.cu``).

On the CPU: ``rms_norm_reference`` is the backbone's former chain bit for
bit; ``rms_norm_backward_reference`` (the backward kernel's formula and
rounding points) is that chain's autograd; ``models/llada._rms_norm`` takes
the wrapper for every norm but gemma's, with or without autograd, with the
chain's gradients; the planner's plans by width and its refusals, the
backward's grid; the ctypes bindings match the C entry points;
``norm_bytes``, ``norm_bwd_bytes`` and the ``backbone.norm_bytes`` counter,
which only a launch adds to.  On the card (``cuda``-marked): the kernel
against the plain chain at the edit's and SDAR-30B-A3B's shapes (at least
99.9 % of the bf16 elements equal, none more than 2 ulps away; f32 within a
few ulps), inside a CUDA graph, one row alone against its batch; the
backward kernel against the chain's autograd at the training steps' shapes,
bit for bit on a repeat, at grids the rows do not fill evenly; and the
launches and counted bytes of inference forwards (no backward) and of a
training step (a forward and a backward launch a norm)."""

import ctypes
import math
import os
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mmada_parallel_torch.models import llada
from mmada_parallel_torch.ops import _cuda
from mmada_parallel_torch.ops import rms_norm as RN
from mmada_parallel_torch.utils import spans

torch.set_num_threads(1)
DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [128, 2048, 4096]
EQUAL_SHARE, MAX_ULPS, F32_RTOL = 0.999, 2, 1e-6
# the backward against the chain's autograd: every element within 2 ulps
# of the largest |gradient| (BWD_BF16_REL in bf16, 16 ulps in f32,
# BWD_F32_REL) and, where summed cancellations leave no small gradient (dx
# in bf16), BWD_SHARE of the elements within MAX_ULPS ulps
BWD_SHARE, BWD_BF16_REL, BWD_F32_REL = 0.9999, 2.0 ** -6, 2.0 ** -19


def _former_chain(x, weight, eps, gemma=False):
    """``models/llada._rms_norm`` as it was before the kernel, verbatim."""
    og = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    x = (xf * torch.rsqrt(var + eps)).to(og)
    if gemma:
        return x * (1 + weight).to(og)
    return x * weight.to(og)


def _inputs(shape, dtype, w_dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g, device=device))
    return x, w.to(w_dtype)


@pytest.mark.parametrize("w_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_reference_is_the_former_chain(width, dtype, w_dtype):
    x, w = _inputs((3, 5, width), dtype, w_dtype, "cpu")
    want = _former_chain(x, w, 1e-5)
    assert torch.equal(RN.rms_norm_reference(x, w, 1e-5), want)
    assert torch.equal(RN.rms_norm(x, w, 1e-5), want)       # the CPU route
    with torch.no_grad():
        assert torch.equal(llada._rms_norm(x, w, 1e-5), want)
    assert torch.equal(llada._rms_norm(x, w, 1e-5, gemma=True),
                       _former_chain(x, w, 1e-5, gemma=True))


@pytest.fixture
def routes(monkeypatch):
    """Records which of the two routes ``llada._rms_norm`` took."""
    taken = []

    def wrapper(x, weight, eps):
        taken.append("kernel")
        return RN.rms_norm_reference(x, weight, eps)

    def chain(x, weight, eps):
        taken.append("chain")
        return RN.rms_norm_reference(x, weight, eps)

    monkeypatch.setattr(llada, "rms_norm", wrapper)
    monkeypatch.setattr(llada, "rms_norm_reference", chain)
    return taken


@pytest.mark.parametrize("mode, x_grad, w_grad, want", [
    ("no_grad", True, True, "kernel"),
    ("inference_mode", False, False, "kernel"),
    ("grad", False, False, "kernel"),
    ("grad", True, False, "kernel"),
    ("grad", False, True, "kernel"),
    ("grad", True, True, "kernel"),
])
def test_the_route_follows_autograd(routes, mode, x_grad, w_grad, want):
    """Every non-gemma norm takes the wrapper, which chooses the launch or
    the autograd Function itself; what autograd records carries a grad."""
    x, w = _inputs((2, 7, 64), torch.bfloat16, torch.float32, "cpu")
    x.requires_grad_(x_grad)
    w.requires_grad_(w_grad)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "grad": torch.enable_grad}[mode]
    with ctx():
        y = llada._rms_norm(x, w, 1e-5)
        llada._rms_norm(x, w, 1e-5, gemma=True)     # gemma: the chain
    assert routes == [want, "chain"]
    assert y.requires_grad == (mode == "grad" and (x_grad or w_grad))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradients_are_the_former_chains(dtype):
    x, w = _inputs((2, 9, 128), dtype, torch.float32, "cpu", seed=3)
    grads = []
    for fn in (llada._rms_norm, _former_chain):
        xi = x.clone().requires_grad_()
        wi = w.clone().requires_grad_()
        y = fn(xi, wi, 1e-6)
        (y.float() * torch.linspace(-1, 1, y.numel()).view(y.shape)
         ).sum().backward()
        grads.append((y, xi.grad, wi.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _ulps(a, b):
    """Elementwise distance of two bf16 or f32 tensors in ulps of their
    type (+0 and -0 equal)."""
    ints, top = ((torch.int16, 1 << 15) if a.dtype == torch.bfloat16
                 else (torch.int32, 1 << 31))

    def key(t):
        bits = t.view(ints).long()
        return torch.where(bits < 0, -(bits + top), bits)
    return (key(a) - key(b)).abs()


def _assert_grad_near(got, want, x_dtype, ulp_share=True):
    """A gradient of the backward kernel or its reference against the
    chain's autograd, in the type it was last rounded to (x's, or a bf16
    weight's): every element within ``BWD_BF16_REL`` or ``BWD_F32_REL`` of
    the largest |gradient| and, where ``ulp_share``, ``BWD_SHARE`` of them
    within ``MAX_ULPS`` ulps."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32 and x_dtype == torch.bfloat16:
        got, want = got.to(x_dtype), want.to(x_dtype)
    bf16 = got.dtype == torch.bfloat16
    if ulp_share:
        ulps = _ulps(got, want)
        assert float((ulps <= MAX_ULPS).float().mean()) >= BWD_SHARE
    err = float((got.float() - want.float()).abs().max())
    assert err <= (BWD_BF16_REL if bf16 else BWD_F32_REL) * float(
        want.float().abs().max())


@pytest.mark.parametrize("w_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_backward_reference_is_the_chains_autograd(width, dtype, w_dtype):
    """The backward kernel's formula, in plain PyTorch, gives the chain's
    autograd ``dx`` and ``dw``: differences only at f32 summation order,
    at most 2 ulps of the gradient's type on 99.99 % of the elements (on
    the CPU the sums run in the chain's own order)."""
    x, w = _inputs((3, 5, width), dtype, w_dtype, "cpu", seed=width)
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(7)
                     ).to(dtype)
    xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
    RN.rms_norm_reference(xi, wi, 1e-5).backward(dy)
    dx, dw = RN.rms_norm_backward_reference(x, w, dy, 1e-5)
    assert dx.dtype == dtype and dw.dtype == w_dtype
    _assert_grad_near(dx, xi.grad, dtype)
    _assert_grad_near(dw, wi.grad, dtype)


def test_a_training_forward_keeps_the_chain(routes):
    """``llada_hidden`` with ``remat`` and parameters that require grad (a
    training step and its recompute) takes the wrapper for every norm, whose
    CPU route keeps the chain: two a layer and ``ln_f`` in the forward, the
    layers' again in the recompute; without grad, the forward's alone."""
    cfg = llada.LLaDAConfig.tiny(remat="whole_layer")
    params = llada.init_llada_params(cfg, torch.Generator().manual_seed(0))
    for p in torch.utils._pytree.tree_leaves(params):
        p.requires_grad_()
    ids = torch.randint(0, cfg.vocab_size, (2, 6),
                        generator=torch.Generator().manual_seed(1))
    llada.llada_hidden(params, cfg, ids).float().sum().backward()
    assert set(routes) == {"kernel"}
    # the forward's norms, and its layers' again in the recompute
    assert len(routes) == (2 * cfg.n_layers + 1) + 2 * cfg.n_layers
    for w in (params["ln_f"], params["blocks"]["attn_norm"],
              params["blocks"]["ff_norm"]):
        assert w.grad is not None and bool(w.grad.abs().sum() > 0)
    routes.clear()
    with torch.inference_mode():
        llada.llada_hidden(params, cfg, ids)
    assert routes == ["kernel"] * (2 * cfg.n_layers + 1)


@pytest.mark.parametrize("width, elem, want", [
    (128, 2, (16, 1, 16)),          # SDAR's per-head q/k norms, bf16
    (128, 4, (32, 1, 8)),
    (64, 2, (8, 1, 32)),
    (8, 2, (1, 1, 256)),
    (2048, 2, (128, 2, 1)),         # SDAR's d_model
    (2048, 4, (128, 4, 1)),
    (4096, 2, (128, 4, 1)),         # LLaDA-8B's d_model
    (4096, 4, (128, 8, 1)),
    (256, 4, (64, 1, 1)),
    (12288, 2, (192, 8, 1)),
    (32768, 2, (512, 8, 1)),        # the widest bf16 row
])
def test_the_plan_by_width(width, elem, want):
    plan = RN.plan_rms_norm(width, elem)
    assert plan == want
    n = width * elem // 16
    threads = plan.row_threads * plan.rows
    assert plan.row_threads * plan.vecs >= n        # every vector held
    assert threads % 32 == 0 and threads <= RN.MAX_THREADS
    assert plan.rows == 1 or (plan.row_threads <= 32 and plan.vecs == 1)


@pytest.mark.parametrize("width, elem", [(100, 2), (6, 4), (0, 2),
                                         (32776, 2), (16400, 4)])
def test_the_planner_refuses(width, elem):
    with pytest.raises(ValueError, match="rms_norm"):
        RN.plan_rms_norm(width, elem)


def test_the_binding_matches_the_entry_point():
    """``_cuda._SIGNATURES`` declares ``mmada_rms_norm``'s parameters as
    ``csrc/rms_norm.cu`` has them."""
    src = open(os.path.join(_cuda.CSRC, "rms_norm.cu")).read()
    params = re.search(r'extern "C" int mmada_rms_norm\(([^)]*)\)',
                       src).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    want = [kinds.get(p.strip().rsplit(" ", 1)[0], ctypes.c_void_p)
            for p in params.split(",")]
    assert _cuda._SIGNATURES["mmada_rms_norm"] == (want, ctypes.c_int)


def test_the_backward_binding_matches_the_entry_point():
    """``_cuda._SIGNATURES`` declares ``mmada_rms_norm_bwd``'s parameters as
    ``csrc/rms_norm.cu`` has them."""
    src = open(os.path.join(_cuda.CSRC, "rms_norm.cu")).read()
    params = re.search(r'extern "C" int mmada_rms_norm_bwd\(([^)]*)\)',
                       src).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long long": ctypes.c_longlong}
    want = [kinds.get(p.strip().rsplit(" ", 1)[0], ctypes.c_void_p)
            for p in params.split(",")]
    assert _cuda._SIGNATURES["mmada_rms_norm_bwd"] == (want, ctypes.c_int)


@pytest.mark.parametrize("rows, width, elem, sms, want", [
    (3 * 5120, 4096, 2, 132, 528),      # a-sft's norms: 4 blocks an SM
    (2565, 4096, 2, 132, 528),          # m-sft's
    (300, 4096, 4, 132, 300),           # fewer rows than the grid holds
    (3 * 5120 * 32, 128, 2, 132, 264),  # q heads: 2 blocks of 256 an SM
    (1000, 128, 2, 132, 63),            # 16 rows a block
    (0, 4096, 2, 132, 1),
    (10**6, 32768, 2, 132, 132),        # 512 threads: one block an SM
])
def test_the_backward_grid(rows, width, elem, sms, want):
    plan = RN.plan_rms_norm(width, elem)
    assert RN.backward_grid(rows, plan, sms) == want
    threads = plan.row_threads * plan.rows
    assert want * threads <= max(threads, sms * RN.BWD_THREADS_PER_SM)


def test_the_plan_constants_are_the_kernels():
    src = open(os.path.join(_cuda.CSRC, "rms_norm.cu")).read()
    assert f"kMaxThreads = {RN.MAX_THREADS};" in src
    assert "case 8:" in src and RN.MAX_VECS == 8


@pytest.mark.parametrize("shape, x_dtype, w_dtype, want", [
    ((2, 2424, 4096), torch.bfloat16, torch.bfloat16,
     2 * 2 * 2424 * 4096 * 2 + 4096 * 2),
    ((16, 4, 32, 128), torch.bfloat16, torch.float32,
     2 * 16 * 4 * 32 * 128 * 2 + 128 * 4),
    ((3, 64), torch.float32, torch.bfloat16, 2 * 3 * 64 * 4 + 64 * 2),
])
def test_norm_bytes(shape, x_dtype, w_dtype, want):
    x = torch.empty(shape, dtype=x_dtype, device="meta")
    w = torch.empty(shape[-1], dtype=w_dtype, device="meta")
    assert RN.norm_bytes(x, w) == want


@pytest.mark.parametrize("shape, x_dtype, w_dtype, want", [
    ((3, 5120, 4096), torch.bfloat16, torch.float32,
     3 * 3 * 5120 * 4096 * 2 + 2 * 4096 * 4),
    ((16, 4, 32, 128), torch.float32, torch.bfloat16,
     3 * 16 * 4 * 32 * 128 * 4 + 2 * 128 * 2),
])
def test_norm_bwd_bytes(shape, x_dtype, w_dtype, want):
    x = torch.empty(shape, dtype=x_dtype, device="meta")
    w = torch.empty(shape[-1], dtype=w_dtype, device="meta")
    assert RN.norm_bwd_bytes(x, w) == want


def test_the_cpu_route_counts_nothing():
    """``backbone.norm_bytes`` and ``backbone.norm_bwd_bytes`` count the
    kernels' launches only: the CPU chain adds nothing while the spans
    record, forward or backward, and no launch."""
    x, w = _inputs((2, 5, 64), torch.bfloat16, torch.bfloat16, "cpu")
    before = RN.rms_norm.launches, RN.rms_norm.backward_launches
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("edit"):
            RN.rms_norm(x, w, 1e-5)
            RN.rms_norm(x, w.requires_grad_(), 1e-5).float().sum().backward()
    assert spans.counters() == {}
    assert (RN.rms_norm.launches, RN.rms_norm.backward_launches) == before


def test_another_device_raises():
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        RN.rms_norm(x, torch.empty(64, device="meta"), 1e-5)


# ---------------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


def _assert_near_chain(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        ulps = _ulps(got, want)
        assert float((ulps == 0).float().mean()) >= EQUAL_SHARE
        assert int(ulps.max()) <= MAX_ULPS
    else:
        torch.testing.assert_close(got, want, rtol=F32_RTOL, atol=0)


# the edit's forwards (d 4096), SDAR-30B-A3B's decode forward, 64 positions
# of 16 rows, its q and k heads, its prefill's rows
CUDA_SHAPES = [(1, 2424, 4096), (2, 2424, 4096), (16, 4, 2048),
               (16, 64, 2048), (16, 64, 32, 128), (16, 64, 4, 128),
               (16, 4096, 2048), (16, 4096, 4, 128), (7, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES,
                         ids=["x".join(map(str, s)) for s in CUDA_SHAPES])
@pytest.mark.parametrize("dtype, w_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)])
def test_kernel_against_the_plain_chain_on_cuda(cuda_device, shape, dtype,
                                                w_dtype):
    x, w = _inputs(shape, dtype, w_dtype, cuda_device, seed=len(shape))
    with torch.inference_mode():
        got = RN.rms_norm(x, w, 1e-5)
        _assert_near_chain(got, RN.rms_norm_reference(x, w, 1e-5))
        assert torch.equal(got, RN.rms_norm(x, w, 1e-5))       # a repeat


@pytest.mark.cuda
def test_a_row_alone_equals_its_batch_on_cuda(cuda_device):
    x, w = _inputs((2, 2424, 4096), torch.bfloat16, torch.bfloat16,
                   cuda_device)
    with torch.inference_mode():
        both = RN.rms_norm(x, w, 1e-5)
        assert torch.equal(both[1], RN.rms_norm(x[1].clone(), w, 1e-5))
        assert torch.equal(both[0, 5:9], RN.rms_norm(x[0, 5:9], w, 1e-5))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 4, 2048), (16, 4, 32, 128)])
def test_kernel_inside_a_cuda_graph_on_cuda(cuda_device, shape):
    """Captured, the call launches nothing the host counts; each replay
    gives the eager output, bit for bit, on the inputs of the moment."""
    x, w = _inputs(shape, torch.bfloat16, torch.bfloat16, cuda_device)
    with torch.inference_mode():
        eager = RN.rms_norm(x, w, 1e-6)
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            RN.rms_norm(x, w, 1e-6)                    # warm on the stream
        torch.cuda.current_stream().wait_stream(s)
        graph = torch.cuda.CUDAGraph()
        before = RN.rms_norm.launches
        with torch.cuda.graph(graph):
            out = RN.rms_norm(x, w, 1e-6)
        assert RN.rms_norm.launches == before
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        x.mul_(3)
        graph.replay()
        _assert_near_chain(out, RN.rms_norm_reference(x, w, 1e-6))
        assert torch.equal(out, RN.rms_norm(x, w, 1e-6))


@pytest.mark.cuda
def test_an_input_that_requires_grad_raises_on_cuda(cuda_device):
    """An input that requires grad gives gradients through the Function,
    the backward kernel's against the chain's autograd; the raw launch
    still refuses one, since its output has no history."""
    x, w = _inputs((4, 128), torch.bfloat16, torch.bfloat16, cuda_device)
    dy = torch.randn(x.shape, device=cuda_device).to(x.dtype)
    xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = RN.rms_norm(xi, wi, 1e-5)
    assert y.grad_fn is not None
    y.backward(dy)
    want_dx, want_dw = _chain_grads(x, w, dy, 1e-5)
    _assert_grad_near(xi.grad, want_dx, x.dtype)
    _assert_grad_near(wi.grad, want_dw, x.dtype, ulp_share=False)
    with pytest.raises(RuntimeError, match="requires grad"):
        RN._launch(x.requires_grad_(), w, 1e-5)
    with torch.no_grad():
        RN.rms_norm(x, w, 1e-5)


def _chain_grads(x, w, dy, eps):
    xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
    RN.rms_norm_reference(xi, wi, eps).backward(dy)
    return xi.grad, wi.grad


# the training steps' norms: a-sft's [3, 5120, 4096] and m-sft's
# [1, 2565, 4096] bf16 rows beside f32 weights, the edit's shape in bf16,
# the f32 template's, SDAR's q/k heads (width 128), its d_model, a
# sub-warp row of 40 and a wide row of 12288 (192 threads of 8 vectors)
BWD_CASES = [((3, 5120, 4096), torch.bfloat16, torch.float32),
             ((1, 2565, 4096), torch.bfloat16, torch.float32),
             ((2, 2424, 4096), torch.bfloat16, torch.bfloat16),
             ((1, 2424, 4096), torch.float32, torch.float32),
             ((1, 2424, 4096), torch.float32, torch.bfloat16),
             ((4, 256, 32, 128), torch.bfloat16, torch.bfloat16),
             ((4, 256, 4, 128), torch.bfloat16, torch.float32),
             ((4, 256, 32, 128), torch.float32, torch.float32),
             ((16, 64, 2048), torch.bfloat16, torch.bfloat16),
             ((7, 40), torch.bfloat16, torch.bfloat16),
             ((7, 40), torch.float32, torch.float32),
             ((3, 1000, 12288), torch.bfloat16, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype, w_dtype", BWD_CASES, ids=[
    "x".join(map(str, c[0])) + f"-{str(c[1])[6:]}-{str(c[2])[6:]}"
    for c in BWD_CASES])
def test_backward_against_the_chains_autograd_on_cuda(cuda_device, shape,
                                                      dtype, w_dtype):
    """dx and dw of the backward kernel against the chain's autograd on
    the card (differences only at f32 summation order), and the same bits
    on a repeat."""
    x, w = _inputs(shape, dtype, w_dtype, cuda_device, seed=len(shape))
    dy = torch.randn(shape, generator=torch.Generator(
        device=cuda_device).manual_seed(5), device=cuda_device).to(dtype)
    dx, dw = RN._launch_backward(x, w, dy, 1e-5)
    want_dx, want_dw = _chain_grads(x, w, dy, 1e-5)
    _assert_grad_near(dx, want_dx, dtype, dtype == torch.bfloat16)
    _assert_grad_near(dw, want_dw, dtype, ulp_share=False)
    dx2, dw2 = RN._launch_backward(x, w, dy, 1e-5)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape, grid", [
    ((2424, 4096), 1), ((2424, 4096), 7), ((2424, 4096), 3000),
    ((5000, 128), 3), ((5000, 128), 313)])
def test_backward_at_grids_the_rows_do_not_fill_on_cuda(cuda_device, shape,
                                                        grid):
    """A grid whose blocks take uneven shares of the rows (and one with
    blocks left without a row) gives the planned grid's dx bit for bit, and
    dw within the chain's tolerance."""
    x, w = _inputs(shape, torch.bfloat16, torch.float32, cuda_device)
    dy = torch.randn(shape, device=cuda_device).to(x.dtype)
    dx, dw = RN._launch_backward(x, w, dy, 1e-5)
    gdx, gdw = RN._launch_backward(x, w, dy, 1e-5, grid=grid)
    assert torch.equal(gdx, dx)
    _assert_grad_near(gdw, _chain_grads(x, w, dy, 1e-5)[1], x.dtype,
                      ulp_share=False)


def _card_cfg(**kw):
    """A small bf16 model for the card, through the plain attention."""
    return llada.LLaDAConfig.tiny(**{
        "d_model": 256, "n_heads": 2, "n_kv_heads": 2,
        "mlp_hidden_size": 512, "param_dtype": torch.bfloat16,
        "compute_dtype": torch.bfloat16, "attention_impl": "xla", **kw})


@pytest.mark.cuda
@pytest.mark.parametrize("qk_norm", [False, True])
def test_a_forward_launches_once_a_norm_on_cuda(cuda_device, qk_norm):
    """An inference forward: two launches a layer and ``ln_f`` (four a
    layer with q/k norms), each adding its bytes to ``backbone.norm_bytes``,
    and no op of the plain chain; its hidden states near the chain's."""
    cfg = _card_cfg(attention_layer_norm=qk_norm)
    params = llada.init_llada_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    before = RN.rms_norm.launches
    with torch.inference_mode(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        h = llada.llada_hidden(params, cfg, ids)
    per = (4 if qk_norm else 2) * cfg.n_layers + 1
    assert RN.rms_norm.launches - before == per
    hd = cfg.head_dim
    x_bytes = 2 * 2 * 40 * cfg.d_model * 2 + cfg.d_model * 2
    want = (2 * cfg.n_layers + 1) * x_bytes
    if qk_norm:
        want += cfg.n_layers * (2 * 2 * 40 * (cfg.n_heads + cfg.n_kv_heads)
                                * hd * 2 + 2 * hd * 2)
    assert spans.counters()["backbone.norm_bytes"] == want
    ops = {e.key for e in prof.key_averages()}
    for name in ("aten::rsqrt", "aten::mean", "aten::rms_norm"):
        assert name not in ops, name
    with torch.inference_mode():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(llada, "rms_norm", RN.rms_norm_reference)
            plain = llada.llada_hidden(params, cfg, ids)
    err = (h.float() - plain.float()).abs().max()
    assert math.isfinite(float(err)) and float(err) <= 0.05 * float(
        plain.float().abs().max())


@pytest.mark.cuda
def test_a_training_step_launches_none_on_cuda(cuda_device):
    """Forward and backward with parameters that require grad, remat on:
    the forward kernel ``(2n + 1) + 2n`` times (the recompute's layers
    again), the backward kernel ``2n + 1`` times, each adding its bytes,
    and no op of the plain chain; every norm weight gets a gradient."""
    cfg = _card_cfg(remat="whole_layer", param_dtype=torch.float32)
    params = llada.init_llada_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    for p in torch.utils._pytree.tree_leaves(params):
        p.requires_grad_()
    ids = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    before = RN.rms_norm.launches, RN.rms_norm.backward_launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        llada.llada_hidden(params, cfg, ids).float().square().sum(
        ).backward()
        counted = spans.counters()
    n = cfg.n_layers
    assert RN.rms_norm.launches - before[0] == (2 * n + 1) + 2 * n
    assert RN.rms_norm.backward_launches - before[1] == 2 * n + 1
    x = torch.empty((2, 40, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    w = torch.empty(cfg.d_model, dtype=torch.float32, device="meta")
    assert counted["backbone.norm_bytes"] == (4 * n + 1) * RN.norm_bytes(x, w)
    assert counted["backbone.norm_bwd_bytes"] == (2 * n + 1) * \
        RN.norm_bwd_bytes(x, w)
    ops = {e.key for e in prof.key_averages()}
    for name in ("aten::rsqrt", "aten::mean", "aten::rms_norm"):
        assert name not in ops, name
    for w in (params["ln_f"], params["blocks"]["attn_norm"],
              params["blocks"]["ff_norm"]):
        assert w.grad is not None and bool(w.grad.abs().sum() > 0)


@pytest.mark.cuda
def test_a_remat_step_matches_the_chain_on_cuda(cuda_device):
    """A 2-layer ``whole_layer`` remat step's gradients through the kernels
    against the same step through the chain: every leaf within the
    backward's bf16 tolerance of the largest of its gradient."""
    cfg = _card_cfg(remat="whole_layer", param_dtype=torch.float32)
    params = llada.init_llada_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device,
                        generator=torch.Generator(
                            device=cuda_device).manual_seed(1))
    grads = []
    for norm in (RN.rms_norm, RN.rms_norm_reference):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in _flat(params).items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(llada, "rms_norm", norm)
            llada.llada_hidden(_unflat(leaves), cfg, ids).float().square(
            ).mean().backward()
        grads.append({k: v.grad for k, v in leaves.items()})
    for name, want in grads[1].items():
        got = grads[0][name]
        if want is None:                        # the head: not in the forward
            assert got is None, name
            continue
        err = float((got - want).abs().max())
        assert err <= BWD_BF16_REL * float(want.abs().max()), name


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat):
    tree = {}
    for name, v in flat.items():
        *path, last = name.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree
