"""The port's LLaDA forward against the JAX package with bridged weights.

Both packages run the tiny config (2 layers, d_model 64, GQA 4/2) in f32 on
the same numpy ids; hidden states and logits must agree at atol/rtol 1e-4
(f32 matmul summation order differs between XLA and PyTorch, through a few
layers of unit-scale activations)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _pair(seed=0, **overrides):
    jcfg = JL.LLaDAConfig.tiny(**overrides)
    tcfg = TL.LLaDAConfig.tiny(**overrides)
    jp = JL.init_llada_params(jax.random.key(seed), jcfg)
    tp = llada_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _ids(B, L, V, seed=1):
    return np.random.default_rng(seed).integers(0, V, (B, L)).astype(np.int32)


def _hidden_both(jcfg, tcfg, jp, tp, ids, mask=None, pos=None):
    jm = jnp.asarray(mask) if mask is not None else None
    jpos = jnp.asarray(pos) if pos is not None else None
    want = np.asarray(JL.llada_hidden(jp, jcfg, jnp.asarray(ids), jm, jpos))
    got = TL.llada_hidden(
        tp, tcfg, torch.from_numpy(ids),
        torch.from_numpy(mask) if mask is not None else None,
        torch.from_numpy(pos) if pos is not None else None).numpy()
    return got, want


@pytest.mark.parametrize("block_type,overrides", [
    ("llama", {}),
    ("sequential", dict(activation_type="swiglu", mlp_hidden_size=256)),
    ("sequential", dict(activation_type="gelu", include_qkv_bias=True)),
])
def test_hidden_and_head_match_jax(block_type, overrides):
    jcfg, tcfg, jp, tp = _pair(block_type=block_type, **overrides)
    ids = _ids(2, 24, jcfg.vocab_size)
    got, want = _hidden_both(jcfg, tcfg, jp, tp, ids)
    np.testing.assert_allclose(got, want, **TOL)
    logits = TL.llada_head(tp, tcfg, torch.tensor(want)).numpy()
    np.testing.assert_allclose(
        logits, np.asarray(JL.llada_head(jp, jcfg, jnp.asarray(want))), **TOL)


@pytest.mark.parametrize("overrides", [
    dict(weight_tying=True),
    dict(scale_logits=True),
    dict(input_emb_norm=True, layer_norm_type="gemma_rms"),
    dict(layer_norm_type="default"),
])
def test_head_options_match_jax(overrides):
    jcfg, tcfg, jp, tp = _pair(seed=2, **overrides)
    ids = _ids(1, 16, jcfg.vocab_size, seed=3)
    want = np.asarray(JL.llada_forward(jp, jcfg, jnp.asarray(ids)))
    got = TL.llada_forward(tp, tcfg, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_vocab_slice_matches_jax_and_full_head():
    jcfg, tcfg, jp, tp = _pair(seed=4)
    h = np.random.default_rng(5).normal(size=(2, 7, 64)).astype(np.float32)
    want = np.asarray(JL.llada_head(jp, jcfg, jnp.asarray(h),
                                    vocab_slice=(100, 50)))
    got = TL.llada_head(tp, tcfg, torch.from_numpy(h),
                        vocab_slice=(100, 50)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    full = TL.llada_head(tp, tcfg, torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, full[..., 100:150], **TOL)


def test_attn_mask_and_position_ids_match_jax():
    jcfg, tcfg, jp, tp = _pair(seed=6)
    ids = _ids(2, 20, jcfg.vocab_size, seed=7)
    mask = np.ones((2, 20), bool)
    mask[1, 3:7] = False                       # padding mid-sequence
    mask[0, 17:] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    got, want = _hidden_both(jcfg, tcfg, jp, tp, ids, mask, pos)
    np.testing.assert_allclose(got[mask], want[mask], **TOL)


def test_out_of_range_ids_are_clamped_like_jax():
    jcfg, tcfg, jp, tp = _pair(seed=8)
    ids = _ids(1, 12, jcfg.vocab_size, seed=9)
    ids[0, 3] = jcfg.vocab_size + 40          # past the embedding
    ids[0, 5] = -2
    got, want = _hidden_both(jcfg, tcfg, jp, tp, ids)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_random_init_shapes_and_errors():
    cfg = TL.LLaDAConfig.tiny()
    p = TL.init_llada_params(cfg, torch.Generator().manual_seed(0))
    jp = JL.init_llada_params(jax.random.key(0), JL.LLaDAConfig.tiny())
    assert jax.tree_util.tree_map(np.shape, jp) == \
        {k: ({n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict)
             else tuple(v.shape)) for k, v in p.items()}
    assert TL.count_params(p) == JL.count_params(jp)
    ids = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="unknown remat"):
        TL.llada_hidden(p, dataclasses.replace(cfg, remat="sometimes"), ids)
    with pytest.raises(ValueError, match="divisible by 3"):
        TL.llada_hidden(p, dataclasses.replace(cfg, remat="one_in_three"),
                        ids)
    # remat is a training option now; the forward is unchanged by it
    np.testing.assert_array_equal(
        TL.llada_hidden(p, dataclasses.replace(cfg, remat="whole_layer"),
                        ids).detach().numpy(),
        TL.llada_hidden(p, cfg, ids).numpy())
    # a W8A8 head (ops/quant.py) takes the int8 product, no longer raises
    from mmada_parallel_torch.ops.quant import int8_matmul, quantize_weight
    q = quantize_weight(p["head"])
    h = torch.randn(1, 3, 64, generator=torch.Generator().manual_seed(1))
    assert torch.equal(TL.llada_head(dict(p, head=q), cfg, h),
                       int8_matmul(h, q["w_q"], q["scale"], torch.float32))


def test_head_cpu_path_is_unchanged_against_jax():
    """A bf16 ``hidden`` on the CPU keeps the f32 upcast (the overload the
    card uses has no CPU kernel): equal to the upcast product bit for bit
    and to JAX's bf16-operand, f32-result einsum."""
    jcfg, tcfg, jp, tp = _pair(seed=10)
    h = np.random.default_rng(11).normal(size=(2, 5, 64)).astype(np.float32)
    hb = torch.from_numpy(h).to(torch.bfloat16)
    for vs in (None, (100, 50)):
        got = TL.llada_head(tp, tcfg, hb, vocab_slice=vs)
        head = tp["head"] if vs is None else tp["head"][:, 100:150]
        assert got.dtype == torch.float32
        assert torch.equal(got, hb.float() @ head.to(torch.bfloat16).float())
        want = JL.llada_head(jp, jcfg, jnp.asarray(hb.float().numpy(),
                                                   jnp.bfloat16),
                             vocab_slice=vs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the bf16 head runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,vocab_slice", [(256, None), (1024, (4096,
                                                                   8192))])
def test_bf16_head_on_cuda_against_f32(cuda_device, rows, vocab_slice):
    """On the card a bf16 ``hidden`` takes the tensor cores with an f32
    result: the same products as the f32 upcast, summed in another order
    (f32 accumulation of 4096 bf16 products of unit-scale values: ~1e-4
    relative of the row's magnitude), and its gradients match the upcast
    path's (the output gradient rounded to bf16: 2^-8 relative)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cfg = TL.LLaDAConfig.tiny(d_model=4096, vocab_size=16384)
    head = torch.randn(4096, 16384, generator=g, device=cuda_device) * 0.02
    hidden = torch.randn(rows, 4096, generator=g, device=cuda_device).to(
        torch.bfloat16)
    # the hook holds an unsharded tree to wte's rows: a width-0 stand-in
    params = {"head": head.requires_grad_(True),
              "wte": torch.empty(cfg.emb_size, 0, device=cuda_device)}
    h = hidden.detach().requires_grad_(True)
    got = TL.llada_head(params, cfg, h, vocab_slice=vocab_slice)
    w = head if vocab_slice is None else head[:, 4096:4096 + 8192]
    want = hidden.float() @ w.detach().to(torch.bfloat16).float()
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got.detach(), want, atol=2e-3, rtol=2e-3)
    got.square().mean().backward()
    h_ref = hidden.detach().float().requires_grad_(True)
    w_ref = head.detach().clone().requires_grad_(True)
    ref_w = w_ref if vocab_slice is None else w_ref[:, 4096:4096 + 8192]
    (h_ref @ ref_w.to(torch.bfloat16).float()).square().mean().backward()
    for got_g, want_g in ((h.grad.float(), h_ref.grad),
                          (head.grad, w_ref.grad)):
        torch.testing.assert_close(got_g, want_g, rtol=1e-2,
                                   atol=1e-2 * float(want_g.abs().max()))
