"""The port's W8A8 int8 path (``ops/quant.py`` and its wiring into
``models/llada.py``) against the JAX package on the same inputs, weights
carried across by ``llada_params_from_jax``.

Tolerances: ``quantize_weight`` gives the same int8 weights exactly and the
same scales to rtol 1e-6 (one f32 division of the same amax); ``int8_matmul``
matches at rtol/atol 1e-6 (the same rounded activations, an exact int32
product, the same two f32 multiplies); the quantized forwards at the f32
forward's tolerance, atol/rtol 1e-4 (f32 summation order upstream of the
GEMMs differs between XLA and PyTorch); the quantized temperature-0 edit
token for token.  The ``cuda`` cases hold the card's int8 GEMM
(``torch._int_mm``) to the CPU's int32 product, accumulators exactly
equal, including fewer rows than ``_int_mm`` takes, K and N off its
multiples of 8, and a column slice of the stored weight."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu import tokens as tk
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_tpu.ops import quant as JQ
from mmada_parallel_tpu.samplers import parallel_ti2ti as JT
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax
from mmada_parallel_torch.ops import quant as TQ
from mmada_parallel_torch.samplers import parallel_ti2ti as TT

torch.set_num_threads(1)
TVS, CB, MASK = 256, 32, 250
TOK = tk.VariantATokens(mask=MASK, newline=251, answer_start=252,
                        answer_end=253, boi=254, eoi=255, uncondition=249,
                        pad=248, text_vocab_size=TVS, codebook_size=CB)
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(seed, **kw):
    base = dict(vocab_size=TVS + CB, mask_token_id=MASK)
    base.update(kw)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**base), TL.LLaDAConfig.tiny(**base)
    jp = JL.init_llada_params(jax.random.key(seed), jcfg)
    return jcfg, tcfg, jp, llada_params_from_jax(_np(jp))


@pytest.mark.parametrize("shape", [(64, 96), (3, 32, 48)])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    w[..., 0] = 0.0                       # an all-zero channel: the 1e-8 floor
    want = JQ.quantize_weight(jnp.asarray(w))
    got = TQ.quantize_weight(torch.from_numpy(w))
    assert got["w_q"].dtype == torch.int8 and got["scale"].dtype == \
        torch.float32
    assert got["scale"].shape == (*shape[:-2], 1, shape[-1])
    # stored column-major: the layout cuBLASLt's int8 GEMM takes
    assert got["w_q"].transpose(-1, -2).is_contiguous()
    np.testing.assert_array_equal(got["w_q"].numpy(), np.asarray(want["w_q"]))
    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                               rtol=1e-6)


@pytest.mark.parametrize("x_shape,out_dtype", [((4, 33, 64), None),
                                               ((7, 64), "float32")])
def test_int8_matmul_matches_jax(x_shape, out_dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=x_shape).astype(np.float32)
    w = rng.normal(size=(64, 96)).astype(np.float32)
    q = JQ.quantize_weight(jnp.asarray(w))
    want = np.asarray(JQ.int8_matmul(jnp.asarray(x), q["w_q"], q["scale"],
                                     out_dtype=out_dtype and jnp.float32))
    tq = llada_params_from_jax(_np(q))
    got = TQ.int8_matmul(torch.from_numpy(x), tq["w_q"], tq["scale"],
                         out_dtype=out_dtype and torch.float32)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_bridge_carries_quantized_leaves():
    """``llada_params_from_jax`` keeps a JAX-quantized tree's int8 ``w_q``
    and f32 ``scale`` as they are: the same tensors the port's own
    quantization of the bridged dense params gives."""
    _, _, jp, tp = _models(3, n_layers=1)
    jq = llada_params_from_jax(_np(JQ.quantize_llada_params(jp)))
    tq = TQ.quantize_llada_params(tp)
    for name in list(TQ._GEMM_KEYS & set(tq["blocks"])) + ["head"]:
        got = jq["head"] if name == "head" else jq["blocks"][name]
        want = tq["head"] if name == "head" else tq["blocks"][name]
        assert got["w_q"].dtype == torch.int8
        assert got["scale"].dtype == torch.float32
        assert torch.equal(got["w_q"], want["w_q"])
        torch.testing.assert_close(got["scale"], want["scale"], rtol=1e-6,
                                   atol=0)
    assert torch.equal(jq["wte"], tp["wte"])          # dense leaves untouched
    assert not isinstance(tq["blocks"]["attn_norm"], dict)


def _forward_case(case, jcfg, tcfg, jp, tp, quantize_head):
    jq = JQ.quantize_llada_params(jp, quantize_head=quantize_head)
    tq = TQ.quantize_llada_params(tp, quantize_head=quantize_head)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 200, (2, 12)).astype(np.int32)
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids)
    if case == "forward":
        return (np.asarray(JL.llada_forward(jq, jcfg, jids)),
                TL.llada_forward(tq, tcfg, tids))
    h = rng.normal(size=(2, 5, jcfg.d_model)).astype(np.float32)
    if case in ("head", "head_slice"):
        vs = (TVS, CB) if case == "head_slice" else None
        return (np.asarray(JL.llada_head(jq, jcfg, jnp.asarray(h),
                                         vocab_slice=vs)),
                TL.llada_head(tq, tcfg, torch.from_numpy(h), vocab_slice=vs))
    jh, jcache = JL.llada_hidden_with_cache(jq, jcfg, jids)
    th, tcache = TL.llada_hidden_with_cache(tq, tcfg, tids)
    if case == "with_cache":
        return np.asarray(jh), th
    sel = np.asarray([[2, 5, 7], [0, 3, 11]], np.int32)
    new = rng.integers(0, 200, (2, 3)).astype(np.int32)
    jsel, _ = JL.llada_hidden_partial(jq, jcfg, jnp.asarray(new),
                                      jnp.asarray(sel), jcache)
    tsel, _ = TL.llada_hidden_partial(tq, tcfg, torch.from_numpy(new),
                                      torch.from_numpy(sel), tcache)
    return np.asarray(jsel), tsel


@pytest.mark.parametrize("case,quantize_head", [
    ("forward", True), ("forward", False), ("head", True),
    ("head_slice", True), ("head", False), ("with_cache", True),
    ("partial", True)])
def test_quantized_forwards_match_jax(case, quantize_head):
    """``llada_forward``, the head with and without ``vocab_slice`` (an int8
    head, and a dense one under ``quantize_head=False``) and both cached
    forwards on W8A8 params: the JAX values at f32 tolerance."""
    want, got = _forward_case(case, *_models(1, d_model=64, n_heads=4,
                                                n_kv_heads=4,
                                                mlp_hidden_size=128),
                              quantize_head)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_quantized_edit_token_exact_with_jax():
    """The W8A8 temperature-0 edit (image CFG with an uncond prefix) gives
    JAX's final ids and codes."""
    jcfg, tcfg, jp, tp = _models(3, d_model=32, n_heads=2, n_kv_heads=2,
                                 n_layers=1, mlp_hidden_size=64)
    ids, lay = tk.assemble_ti2ti_sequence([5, 6, 7], 8, 2, 3, [9], tokens=TOK)
    kw = dict(text_steps=8, timesteps=4, temperature=0.0,
              text_temperature=0.0, cfg_scale=0.0, cfg_img=2.0,
              text_vocab_size=TVS, codebook_size=CB, mask_token=MASK)
    ui = np.asarray([40, 41], np.int32)
    jfin, jcodes = JT.generate_ti2ti(JQ.quantize_llada_params(jp), jcfg,
                                     jnp.asarray(ids)[None], lay,
                                     JT.TI2TIOptions(**kw),
                                     uncond_image_prefix=ui, key=None)
    tfin, tcodes = TT.generate_ti2ti(TQ.quantize_llada_params(tp), tcfg,
                                     torch.tensor(ids[None]), lay,
                                     TT.TI2TIOptions(**kw),
                                     uncond_image_prefix=ui)
    np.testing.assert_array_equal(tfin.numpy(), np.asarray(jfin))
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
    assert not np.any(tfin.numpy()[0, lay.text_start:lay.text_end] == MASK)


def test_tied_model_keeps_a_dense_head():
    """A tied model has no ``head``: quantization leaves the embedding (the
    head it reads) dense, as JAX does."""
    _, tcfg, _, tp = _models(6, n_layers=1, weight_tying=True)
    assert "head" not in tp
    tq = TQ.quantize_llada_params(tp)
    assert "head" not in tq and torch.equal(tq["wte"], tp["wte"])
    h = torch.randn(1, 4, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    torch.testing.assert_close(TL.llada_head(tq, tcfg, h),
                               TL.llada_head(tp, tcfg, h))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch._int_mm runs only on the "
                    "card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows,K,N,sliced", [
    (1, 4096, 1024, False), (16, 4096, 1024, False), (17, 4096, 1024, False),
    (2424, 4096, 1024, False), (16, 4096, 1024, True),
    (2424, 4096, 1024, True), (20, 100, 1020, False)])
def test_int8_gemm_on_cuda_equals_cpu(cuda_device, rows, K, N, sliced):
    """``torch._int_mm`` on the card gives the CPU int32 product's
    accumulators exactly: with fewer rows than it takes, with K and N off
    its multiples of 8 (zero-padded), and on a column slice of a wider
    weight (the head's ``vocab_slice``); the rescaled output then matches
    to the last bit."""
    g = torch.Generator().manual_seed(rows + K + N)
    x = torch.randn(rows, K, generator=g)
    w = torch.randn(K, 3 * N if sliced else N, generator=g) * 0.02
    q = TQ.quantize_weight(w)
    w_q, scale = q["w_q"], q["scale"]
    if sliced:
        w_q, scale = w_q[:, N:2 * N], scale[:, N:2 * N]
    x_q = torch.randint(-127, 128, (rows, K), generator=g, dtype=torch.int8)
    acc = TQ._int8_mm(x_q.to(cuda_device), w_q.to(cuda_device))
    assert acc.dtype == torch.int32 and acc.shape == (rows, N)
    assert torch.equal(acc.cpu(), TQ._int8_mm(x_q, w_q))
    got = TQ.int8_matmul(x.to(cuda_device), w_q.to(cuda_device),
                         scale.to(cuda_device))
    assert torch.equal(got.cpu(), TQ.int8_matmul(x, w_q, scale))
