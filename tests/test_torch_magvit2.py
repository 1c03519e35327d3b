"""The port's MagViT-v2 (variant M's tokenizer) against the JAX package:
LFQ bit packing, codes exact and decoded pixels at f32 tolerance (atol/rtol
1e-4, the Amused-VQ test's: f32 convolutions summed in another order) on the
tiny config with bridged weights, and the full config's parameter tree
(names and shapes, built on the meta device: no forward at full size on the
CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmada_parallel_tpu.models import magvit2 as JM
from mmada_parallel_torch.models import magvit2 as TM
from mmada_parallel_torch.models.from_jax import magvit_params_from_jax

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def test_lfq_bitpacking_matches_jax():
    z = np.random.default_rng(5).normal(size=(2, 4, 4, 5)).astype(np.float32)
    jq, jidx = JM.lfq_quantize(jnp.asarray(z))
    tq, tidx = TM.lfq_quantize(torch.from_numpy(z))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    # MSB first: channel 0 is bit 2^(C-1)
    assert np.all((tidx.numpy() & 16) == (z[..., 0] > 0).reshape(2, -1) * 16)
    back = TM.lfq_codebook_entry(tidx, 5)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        JM.lfq_codebook_entry(jidx, 5)))
    np.testing.assert_array_equal(back.numpy(), tq.numpy())
    with pytest.raises(ValueError, match="grid"):
        TM.lfq_codebook_entry(tidx, 5, shape=(3, 5))


@pytest.fixture(scope="module")
def tiny():
    cfg = JM.MagvitConfig.tiny()
    jp = JM.init_magvit_params(jax.random.key(6), cfg)
    tp = magvit_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, TM.MagvitConfig.tiny(), jp, tp


def test_bridged_tiny_codes_exact_and_pixels_close(tiny):
    jcfg, tcfg, jp, tp = tiny
    px = np.random.default_rng(6).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(JM.magvit_get_code(jp, jcfg, jnp.asarray(px)))
    got = TM.magvit_get_code(tp, tcfg, torch.from_numpy(px)).numpy()
    assert got.shape == (2, (32 // tcfg.scale) ** 2)
    np.testing.assert_array_equal(got, want)
    zq_j, _ = JM.magvit_encode(jp, jcfg, jnp.asarray(px))
    zq_t, _ = TM.magvit_encode(tp, tcfg, torch.from_numpy(px))
    np.testing.assert_array_equal(zq_t.numpy(), np.asarray(zq_j))

    codes = np.random.default_rng(7).integers(0, tcfg.codebook_size,
                                              (1, 32))
    want_px = np.asarray(JM.magvit_decode_code(jp, jcfg, jnp.asarray(codes),
                                               (4, 8)))
    got_px = TM.magvit_decode_code(tp, tcfg, torch.from_numpy(codes),
                                   (4, 8)).numpy()
    assert got_px.shape == (1, 4 * tcfg.scale, 8 * tcfg.scale, 3)
    np.testing.assert_allclose(got_px, want_px, **TOL)


def test_full_config_tree_matches_jax():
    """Names, nesting and shapes of the full-size tree against the JAX
    init (HWIO -> OIHW), and the paper's scale and codebook size."""
    cfg = TM.MagvitConfig()
    assert cfg.scale == 16 and cfg.codebook_size == 8192
    assert JM.MagvitConfig() == JM.MagvitConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    got = _flat(TM.init_magvit_params(cfg, torch.Generator(),
                                      device="meta"))
    shapes = jax.eval_shape(
        lambda k: JM.init_magvit_params(k, JM.MagvitConfig()),
        jax.random.key(0))
    want = _flat(shapes)
    assert set(got) == set(want)
    for name, s in want.items():
        shape = tuple(s.shape)
        if len(shape) == 4:
            shape = (shape[3], shape[2], shape[0], shape[1])
        assert tuple(got[name].shape) == shape, name
    n = sum(int(np.prod(s.shape)) for s in want.values())
    assert sum(t.numel() for t in got.values()) == n


def test_port_init_is_seeded_and_bounded():
    cfg = TM.MagvitConfig.tiny()
    a = TM.init_magvit_params(cfg, torch.Generator().manual_seed(1))
    b = TM.init_magvit_params(cfg, torch.Generator().manual_seed(1))
    fa, fb = _flat(a), _flat(b)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    w = a["encoder"]["conv_in"]["w"]               # kaiming-uniform bound
    assert float(w.abs().max()) <= (1.0 / (3 * 3 * 3)) ** 0.5
