"""The backbone's RMSNorm kernel (``ops/rms_norm.py``, ``csrc/rms_norm.cu``).

On the CPU: ``rms_norm_reference`` is the backbone's former chain bit for
bit; ``models/llada._rms_norm`` takes the wrapper where autograd records
nothing and the chain where it records, with the chain's gradients; the
planner's plans by width and its refusals; the ctypes binding matches the C
entry point; ``norm_bytes`` and the ``backbone.norm_bytes`` counter, which
only a launch adds to.  On the card (``cuda``-marked): the kernel against
the plain chain at the edit's and SDAR-30B-A3B's shapes (at least 99.9 % of
the bf16 elements equal, none more than 2 ulps away; f32 within a few
ulps), inside a CUDA graph, one row alone against its batch, the gradient
refusal, and the launches and counted bytes of inference forwards and of a
training step (none)."""

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
    ("grad", True, False, "chain"),
    ("grad", False, True, "chain"),
    ("grad", True, True, "chain"),
])
def test_the_route_follows_autograd(routes, mode, x_grad, w_grad, want):
    x, w = _inputs((2, 7, 64), torch.bfloat16, torch.float32, "cpu")
    x.requires_grad_(x_grad)
    w.requires_grad_(w_grad)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "grad": torch.enable_grad}[mode]
    with ctx():
        llada._rms_norm(x, w, 1e-5)
        llada._rms_norm(x, w, 1e-5, gemma=True)     # gemma: the chain
    assert routes == [want, "chain"]


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


def test_a_training_forward_keeps_the_chain(routes):
    """``llada_hidden`` with ``remat`` and parameters that require grad (a
    training step and its recompute) never calls the wrapper; without
    grad, every norm does: two a layer and ``ln_f``."""
    cfg = llada.LLaDAConfig.tiny(remat="whole_layer")
    params = llada.init_llada_params(cfg, torch.Generator().manual_seed(0))
    for p in torch.utils._pytree.tree_leaves(params):
        p.requires_grad_()
    ids = torch.randint(0, cfg.vocab_size, (2, 6),
                        generator=torch.Generator().manual_seed(1))
    llada.llada_hidden(params, cfg, ids).float().sum().backward()
    assert set(routes) == {"chain"}
    # the forward's norms, and its layers' again in the recompute
    assert len(routes) == (2 * cfg.n_layers + 1) + 2 * cfg.n_layers
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


def test_the_cpu_route_counts_nothing():
    """``backbone.norm_bytes`` counts the kernel's launches only: the CPU
    chain adds nothing while the spans record, and no launch."""
    x, w = _inputs((2, 5, 64), torch.bfloat16, torch.bfloat16, "cpu")
    before = RN.rms_norm.launches
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("edit"):
            RN.rms_norm(x, w, 1e-5)
    assert spans.counters() == {}
    assert RN.rms_norm.launches == before


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


def _ulps(a, b):
    def key(t):
        bits = t.view(torch.int16).int()
        return torch.where(bits < 0, -(bits + 32768), bits)
    return (key(a) - key(b)).abs()


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
    x, w = _inputs((4, 128), torch.bfloat16, torch.bfloat16, cuda_device)
    with pytest.raises(RuntimeError, match="requires grad"):
        RN.rms_norm(x.requires_grad_(), w, 1e-5)
    with torch.no_grad():
        RN.rms_norm(x, w, 1e-5)


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
    every norm through the plain chain, no launch."""
    cfg = _card_cfg(remat="whole_layer", param_dtype=torch.float32)
    params = llada.init_llada_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    for p in torch.utils._pytree.tree_leaves(params):
        p.requires_grad_()
    ids = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda_device)
    before = RN.rms_norm.launches
    llada.llada_hidden(params, cfg, ids).float().square().mean().backward()
    assert RN.rms_norm.launches == before
    for w in (params["ln_f"], params["blocks"]["attn_norm"],
              params["blocks"]["ff_norm"]):
        assert w.grad is not None and bool(w.grad.abs().sum() > 0)
