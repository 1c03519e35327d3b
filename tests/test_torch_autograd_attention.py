"""Gradients through the attention kernels' autograd Functions.

A CUDA kernel's output comes back through ``ctypes`` with no autograd
history.  Here each kernel is stood in for by a function that, like that
launch, computes the plain version under ``torch.no_grad()`` and returns a
tensor with no ``grad_fn``, and ``ops.attention._use_kernel`` routes the CPU
tensors to it.  Through the Functions, the q/k/v gradients of
``rope_attention``, ``rope_attention_qonly``, ``dot_product_attention`` and
``rope_attention_prefix`` must equal the plain path's (``impl="xla"``) and
JAX's ``jax.grad`` on the same numpy inputs, in f32 at atol = rtol = 1e-5
(the same math; only the f32 summation order differs between XLA and
PyTorch).  The Functions of the first three take the backward kernel's
route (``ops.attention._kernel_backward`` routes the CPU tensors there):
their forward stand-ins return the row statistics, and their backward
reaches a stand-in of the backward launcher (the plain backward of
``ops.attention_bwd``, counted); ``rope_attention_prefix`` at this length
takes K1 on the dense bias.  Without
the Functions the gradients are lost, and the raw launchers refuse inputs
that need a gradient."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.models.llada import _rope_sin_cos as jax_tables
from mmada_parallel_tpu.ops import attention as JA
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.ops import attention as TA
from mmada_parallel_torch.ops import attention_bwd as TB
from mmada_parallel_torch.ops import flash_attention as TF
from mmada_parallel_torch.ops import rope_attention as TR

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
B, L, H, KV, D = 2, 24, 4, 2, 16


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _detached(fn):
    """A stand-in for a kernel: the plain version with no autograd history,
    as the ctypes launch returns it."""
    def kernel(*args, **kw):
        with torch.no_grad():
            return fn(*args, **kw)
    return kernel


BACKWARDS = {"rope_attention": "flash_attention_rope_bwd",
             "rope_attention_qonly": "flash_attention_rope_qonly_bwd",
             "dot_product_attention": "flash_attention_bwd",
             # below PREFIX_MIN_LEN ``auto`` takes K1 on the dense bias
             "rope_attention_prefix": "flash_attention_rope_bwd"}


@pytest.fixture
def fake_kernels(monkeypatch):
    """Route ``auto`` on CPU tensors to stand-in kernels, and the
    Functions' backward to stand-ins of the backward launchers; returns the
    backward stand-ins' call counts."""
    monkeypatch.setattr(TA, "_use_kernel", lambda impl, t: impl != "xla")
    monkeypatch.setattr(TA, "_kernel_backward", lambda t: True)
    # the CPU wrappers run the plain versions (with the row statistics
    # where ``with_stats`` asks for them)
    for name, plain in (
            ("flash_attention_rope", TR.flash_attention_rope),
            ("flash_attention_rope_qonly", TR.flash_attention_rope_qonly),
            ("flash_attention", TF.flash_attention),
            ("flash_attention_rope_prefix",
             TR.flash_attention_rope_prefix_reference)):
        monkeypatch.setattr(TA, name, _detached(plain))
    calls = dict.fromkeys(BACKWARDS.values(), 0)

    def counted(name):
        plain = _detached(getattr(TB, name))

        def bwd(*args, **kw):
            calls[name] += 1
            return plain(*args, **kw)
        return bwd
    for name in calls:
        monkeypatch.setattr(TA, name, counted(name))
    return calls


def _case(name):
    """``(numpy inputs, torch fn(q, k, v, impl), jax fn(q, k, v))``."""
    rng = np.random.default_rng(7)
    s, c = (np.asarray(t) for t in jax_tables(L, D, 10000.0))
    mask = np.ones((B, L), bool)
    mask[1, 17:] = False
    pair = (mask[:, :, None] & mask[:, None, :])[:, None]
    bias = np.where(pair, 0.0, -1e30).astype(np.float32)
    pos = np.maximum(np.cumsum(mask, 1) - 1, 0)
    heads = dict(n_heads=H, n_kv_heads=KV)
    if name == "rope_attention":
        q, k, v = (_rand((B, L, n * D), i) for i, n in enumerate((H, KV, KV)))
        ps, pc = s[pos], c[pos]
        return ((q, k, v),
                lambda q, k, v, impl: TA.rope_attention(
                    q, k, v, torch.tensor(ps), torch.tensor(pc),
                    torch.tensor(bias), impl=impl, **heads),
                lambda q, k, v: JA.rope_attention(
                    q, k, v, ps, pc, bias, impl="xla", **heads))
    if name == "rope_attention_qonly":
        Lq = 8
        q = _rand((B, Lq, H * D), 0)
        k, v = (_rand((B, L, KV * D), i) for i in (1, 2))
        sel = np.sort(np.stack([rng.permutation(L)[:Lq] for _ in range(B)]),
                      axis=1)
        qb = np.where(mask[np.arange(B)[:, None], sel][:, :, None]
                      & mask[:, None, :], 0.0, -1e30)[:, None]
        qb = qb.astype(np.float32)
        return ((q, k, v),
                lambda q, k, v, impl: TA.rope_attention_qonly(
                    q, k, v, torch.tensor(s[sel]), torch.tensor(c[sel]),
                    torch.tensor(qb), impl=impl, **heads),
                lambda q, k, v: JA.rope_attention_qonly(
                    q, k, v, s[sel], c[sel], qb, impl="xla", **heads))
    if name == "dot_product_attention":
        q, k, v = (_rand((B, L, n, D), i) for i, n in enumerate((H, KV, KV)))
        return ((q, k, v),
                lambda q, k, v, impl: TA.dot_product_attention(
                    q, k, v, torch.tensor(bias), impl=impl),
                lambda q, k, v: JA.dot_product_attention(q, k, v, bias,
                                                         impl="xla"))
    assert name == "rope_attention_prefix"
    q, k, v = (_rand((B, L, n * D), i) for i, n in enumerate((H, KV, KV)))
    hi = np.stack([np.arange(1, L + 1), np.full(L, 9)]).astype(np.int32)
    hi[0, 3], hi[1, 5] = 0, L + 30            # a bound-0 row, a bound > Lk
    return ((q, k, v),
            lambda q, k, v, impl: TA.rope_attention_prefix(
                q, k, v, torch.tensor(s), torch.tensor(c), torch.tensor(hi),
                impl=impl, **heads),
            lambda q, k, v: JA.rope_attention_prefix(
                q, k, v, s, c, hi, impl="xla", **heads))


ENTRY_POINTS = ["rope_attention", "rope_attention_qonly",
                "dot_product_attention", "rope_attention_prefix"]


def _torch_grads(fn, arrays, w, impl):
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*xs, impl)
    grads = torch.autograd.grad((out * torch.tensor(w)).sum(), xs)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _check_grads(name, calls, want_calls):
    """The kernel path's output and q/k/v gradients against the plain
    path's and ``jax.grad``'s; the backward stand-ins' counts against
    ``want_calls``."""
    arrays, tfn, jfn = _case(name)
    w_shape = arrays[0].shape
    w = _rand(w_shape, 11)
    out_k, grads_k = _torch_grads(tfn, arrays, w, "auto")
    assert calls == want_calls
    out_p, grads_p = _torch_grads(tfn, arrays, w, "xla")
    np.testing.assert_allclose(out_k, out_p, **TOL)
    jgrads = jax.grad(lambda q, k, v: (jfn(q, k, v) * w).sum(),
                      argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    for gk, gp, gj in zip(grads_k, grads_p, jgrads):
        np.testing.assert_allclose(gk, gp, **TOL)
        np.testing.assert_allclose(gk, np.asarray(gj), **TOL)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_grads_through_function_match_plain_and_jax(name, fake_kernels):
    _check_grads(name, fake_kernels, {bwd: int(BACKWARDS[name] == bwd)
                                      for bwd in BACKWARDS.values()})


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_grads_through_the_chain_recompute_match_plain_and_jax(
        name, fake_kernels, monkeypatch):
    """The Functions' other backward, taken where ``_kernel_backward``
    refuses the input (f32 on the card, K4): the plain chain recomputed
    and differentiated, with no backward launcher reached."""
    monkeypatch.setattr(TA, "_kernel_backward", lambda t: False)
    _check_grads(name, fake_kernels, dict.fromkeys(BACKWARDS.values(), 0))


def _no_grad_ctx():
    """A context for calling ``_KernelFn.forward`` straight: no input asks
    for a gradient, so the kernel is called without statistics."""
    return types.SimpleNamespace(save_for_backward=lambda *a: None,
                                 needs_input_grad=(False,) * 12)


@pytest.fixture
def without_functions(fake_kernels, monkeypatch):
    """The routing before the Functions: each entry point calls its kernel
    straight, so autograd never sees the launch."""
    ctx = _no_grad_ctx()
    monkeypatch.setattr(TA._KernelFn, "apply", staticmethod(
        functools.partial(TA._KernelFn.forward, ctx)))


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_grads_are_lost_without_the_function(name, without_functions):
    arrays, tfn, _ = _case(name)
    xs = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = tfn(*xs, "auto")
    assert out.grad_fn is None and not out.requires_grad
    loss = (out * torch.tensor(_rand(arrays[0].shape, 11))).sum()
    assert not loss.requires_grad          # no path back to q, k or v


def _llada_block_grads(tcfg, tp, ids):
    """Gradients of the blocks' parameters of ``mean(logsumexp(logits))``
    (``None`` where autograd found no path)."""
    for t in [tp["wte"], tp["ln_f"], tp["head"], *tp["blocks"].values()]:
        t.requires_grad_(True)
    TL.llada_forward(tp, tcfg, ids).logsumexp(-1).mean().backward()
    return {n: (None if t.grad is None else t.grad.numpy().copy())
            for n, t in tp["blocks"].items()}


def test_model_projection_grads_through_the_kernel_path(fake_kernels,
                                                        monkeypatch):
    """The tiny LLaDA with the kernel path: the q/k/v projections get the
    plain path's and JAX's gradients through the Function, and none at all
    when the kernel is called without it."""
    jcfg = JL.LLaDAConfig.tiny()
    jp = JL.init_llada_params(jax.random.key(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    tcfg = TL.LLaDAConfig.tiny()
    ids = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(np.int32)

    def grads(impl):
        tp = llada_params_from_jax(np_params)
        return _llada_block_grads(
            dataclasses.replace(tcfg, attention_impl=impl), tp,
            torch.from_numpy(ids))

    kernel, plain = grads("auto"), grads("xla")
    # every layer's attention went back through the backward stand-in
    assert fake_kernels["flash_attention_rope_bwd"] == tcfg.n_layers
    jgrads = jax.grad(lambda p: jax.nn.logsumexp(
        JL.llada_forward(p, jcfg, jnp.asarray(ids)), axis=-1).mean())(jp)
    for name in ("q_proj", "k_proj", "v_proj", "ff_proj"):
        np.testing.assert_allclose(kernel[name], plain[name], **TOL)
        np.testing.assert_allclose(kernel[name],
                                   np.asarray(jgrads["blocks"][name]),
                                   atol=1e-5, rtol=1e-4)

    # the old routing: the kernel called without its Function
    ctx = _no_grad_ctx()
    monkeypatch.setattr(TA._KernelFn, "apply", staticmethod(
        functools.partial(TA._KernelFn.forward, ctx)))
    lost = grads("auto")
    for name in ("q_proj", "k_proj", "v_proj"):
        assert lost[name] is None
    assert lost["ff_proj"] is not None


@pytest.mark.parametrize("launcher", ["K1", "K2", "K3", "K4"])
def test_raw_launchers_refuse_inputs_that_need_grad(launcher):
    q = torch.zeros(1, 8, H * D, requires_grad=True)
    k = torch.zeros(1, 8, KV * D)
    s, c = TL._rope_sin_cos(8, D, 10000.0)
    call = {
        "K1": lambda: TR._launch(q, k, k, s, c, s, c, None, H, KV),
        "K2": lambda: TR._launch_qonly(q, k, k, s, c, None, H, KV),
        "K3": lambda: TF._launch(q.view(1, 8, H, D), k.view(1, 8, KV, D),
                                 k.view(1, 8, KV, D), None),
        "K4": lambda: TR._launch_prefix(
            q, k, k, s, c, s, c, torch.ones(1, 8, dtype=torch.int32), H, KV),
    }[launcher]
    with pytest.raises(RuntimeError, match="no autograd history"):
        call()
