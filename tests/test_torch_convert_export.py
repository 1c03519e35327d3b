"""The port's checkpoint export (``models/convert.py``:
``llada_state_dict_from_params``, ``save_llada_checkpoint``) against the
JAX package's.

The state dict equals JAX's name for name and bit for bit on the same
weights (random values in every leaf, biases and norms included), for both
block types, with and without qkv biases and weight tying, in f32 and
bf16.  A checkpoint the port writes loads in the JAX
``load_llada_checkpoint`` and one JAX writes loads in the port's, both
bit for bit; their ``config.json`` files are equal; a bf16 checkpoint goes
through the port and back unchanged.  Both packages write with the
``safetensors`` package."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmada_parallel_tpu.models import convert as JCV
from mmada_parallel_tpu.models import llada as JL
from mmada_parallel_torch.models import convert as TCV
from mmada_parallel_torch.models import llada as TL
from mmada_parallel_torch.models.from_jax import llada_params_from_jax

CASES = {
    "llama": dict(),
    "llama-qkv-bias": dict(include_qkv_bias=True),
    "llama-tied": dict(weight_tying=True),
    "sequential": dict(block_type="sequential"),
    "sequential-qkv-bias-tied": dict(block_type="sequential",
                                     include_qkv_bias=True,
                                     weight_tying=True),
}


def _model(case):
    """The JAX and port configs and random f32 numpy params of one case."""
    kw = dict(CASES[case], n_layers=3)
    jcfg, tcfg = JL.LLaDAConfig.tiny(**kw), TL.LLaDAConfig.tiny(**kw)
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda x: rng.normal(size=x.shape).astype(np.float32),
        JL.init_llada_params(jax.random.key(0), jcfg))
    return jcfg, tcfg, params


def _bits(a):
    """A numpy array's raw bits (bf16 as uint16)."""
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _torch_bits(t):
    return _bits(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                 else t.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_state_dict_equals_jax(case, dtype):
    jcfg, tcfg, params = _model(case)
    jdt, tdt = ((np.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = JCV.llada_state_dict_from_params(params, jcfg, jdt)
    got = TCV.llada_state_dict_from_params(llada_params_from_jax(params),
                                           tcfg, tdt)
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == tdt and g.device.type == "cpu", name
        assert g.is_contiguous() and tuple(g.shape) == w.shape, name
        np.testing.assert_array_equal(_torch_bits(g), _bits(w), name)
    # every tensor owns its storage (safetensors refuses shared ones)
    assert len({t.untyped_storage().data_ptr() for t in got.values()}) == \
        len(got)


@pytest.mark.parametrize("case", ["llama-qkv-bias", "sequential"])
def test_port_checkpoint_loads_in_jax(case, tmp_path):
    jcfg, tcfg, params = _model(case)
    TCV.save_llada_checkpoint(str(tmp_path / "t"),
                              llada_params_from_jax(params), tcfg)
    JCV.save_llada_checkpoint(str(tmp_path / "j"), params, jcfg)
    # compute_dtype is an execution policy, not in the checkpoint
    cfg, loaded = JCV.load_llada_checkpoint(str(tmp_path / "t"),
                                            compute_dtype=jcfg.compute_dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    configs = [json.loads((tmp_path / d / "config.json").read_text())
               for d in ("t", "j")]
    assert configs[0] == configs[1]


@pytest.mark.parametrize("case", ["llama-tied", "sequential-qkv-bias-tied"])
def test_jax_checkpoint_loads_in_the_port(case, tmp_path):
    jcfg, tcfg, params = _model(case)
    JCV.save_llada_checkpoint(str(tmp_path), params, jcfg,
                              extra_config={"note": "from jax"})
    cfg, loaded = TCV.load_llada_checkpoint(
        str(tmp_path), compute_dtype=tcfg.compute_dtype)
    assert cfg == tcfg
    want = llada_params_from_jax(params)
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(want)):
        assert torch.equal(a, b)


def test_bf16_checkpoint_round_trips_in_the_port(tmp_path):
    _, tcfg, params = _model("llama")
    tparams = llada_params_from_jax(params, dtype=torch.bfloat16)
    TCV.save_llada_checkpoint(str(tmp_path), tparams, tcfg,
                              dtype=torch.bfloat16)
    cfg, loaded = TCV.load_llada_checkpoint(
        str(tmp_path), dtype=torch.bfloat16, compute_dtype=tcfg.compute_dtype)
    assert cfg == tcfg
    for a, b in zip(jax.tree_util.tree_leaves(loaded),
                    jax.tree_util.tree_leaves(tparams)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    ids = torch.tensor(np.random.default_rng(1).integers(0, 512, (1, 12)))
    assert torch.equal(TL.llada_hidden(loaded, cfg, ids),
                       TL.llada_hidden(tparams, tcfg, ids))
