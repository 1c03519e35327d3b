"""The port's mesh module (``parallel/mesh.py``) against the JAX package's.

``MeshConfig`` resolves as JAX's does; ``shard_params`` gives each of 4
spawned CPU ranks (gloo, ``file://`` rendezvous) the slice of every leaf
that JAX's ``NamedSharding`` puts on the device at the same mesh
coordinates, for the whole ``param_shardings`` tree over ``fsdp=2 x
tensor=2`` (the untied head split over both axes); ``init_distributed``
joins two processes through an explicit rendezvous, after which an
all-gather crosses them and a second call is a no-op; an explicit
rendezvous that fails raises, and no launcher environment leaves the
process single.

The rank functions live in ``test_torch_tp_overlap.py`` (torch and numpy
imports only) or here, whose top-level imports are the same."""

import os

import numpy as np
import pytest
import torch

from test_torch_tp_overlap import start_ranks


@pytest.mark.parametrize("shape,n", [((-1, 1, 1), 8), ((-1, 2, 2), 8),
                                     ((1, 2, 4), 8), ((2, 1, 4), 8),
                                     ((-1, 1, 4), 4), ((3, 1, 2), 8)])
def test_mesh_config_resolves_as_jax(shape, n):
    from mmada_parallel_tpu.parallel import MeshConfig as JMeshConfig
    from mmada_parallel_torch.parallel import MeshConfig
    try:
        want = JMeshConfig(*shape).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            MeshConfig(*shape).resolve(n)
        assert str(got.value) == str(e)
        return
    assert MeshConfig(*shape).resolve(n) == want


def _tiny_cfg():
    from mmada_parallel_torch.models.llada import LLaDAConfig
    return LLaDAConfig.tiny(n_heads=4, n_kv_heads=2, include_qkv_bias=True)


def _shard_rank(rank, world, workdir):
    """This rank's slices of the tiny tree over (data=1, fsdp=2,
    tensor=2), with its mesh coordinates."""
    from mmada_parallel_torch.models.llada import param_shardings
    from mmada_parallel_torch.parallel import (MeshConfig, PartitionSpec,
                                               make_mesh, shard_params)
    params = torch.load(os.path.join(workdir, "params.pt"))
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2), "cpu")
    local = shard_params(params, param_shardings(_tiny_cfg()), mesh)
    whole = shard_params(params["ln_f"], PartitionSpec(), mesh)
    flat = {"ln_f_replicated": whole}
    for k, v in local.items():
        for n, t in (v.items() if isinstance(v, dict) else [(None, v)]):
            assert t.is_contiguous()
            flat[k if n is None else f"{k}.{n}"] = t.numpy()
    return {"coord": mesh.get_coordinate(), "leaves": flat}


def test_shard_params_matches_jax_placement(tmp_path):
    import jax
    from jax.sharding import NamedSharding
    from mmada_parallel_tpu.models import init_llada_params as jinit
    from mmada_parallel_tpu.models import LLaDAConfig as JCfg
    from mmada_parallel_tpu.models import param_shardings as jspecs
    from mmada_parallel_tpu.parallel import MeshConfig, make_mesh
    from mmada_parallel_torch.models.from_jax import llada_params_from_jax
    jcfg = JCfg.tiny(n_heads=4, n_kv_heads=2, include_qkv_bias=True)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jinit(jax.random.key(0), jcfg))
    torch.save(llada_params_from_jax(jparams), tmp_path / "params.pt")
    ranks = start_ranks(_shard_rank, 4, tmp_path, timeout=180)()
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2),
                     jax.devices()[:4])
    flat = {}
    for k, v in jax.tree_util.tree_map(
            lambda p, s: jax.device_put(p, NamedSharding(mesh, s)), jparams,
            jspecs(jcfg)).items():
        for n, a in (v.items() if isinstance(v, dict) else [(None, v)]):
            flat[k if n is None else f"{k}.{n}"] = a
    for r, res in enumerate(ranks):
        assert tuple(res["coord"]) == (0, r // 2, r % 2)
        dev = mesh.devices[tuple(res["coord"])]
        assert set(res["leaves"]) == set(flat) | {"ln_f_replicated"}
        for name, arr in flat.items():
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(res["leaves"][name],
                                          np.asarray(shard.data), name)
        np.testing.assert_array_equal(res["leaves"]["ln_f_replicated"],
                                      jparams["ln_f"])


def _allgather_rank(rank, world, workdir):
    import torch.distributed as dist
    from mmada_parallel_torch.parallel import init_distributed
    init_distributed(f"file://{workdir}/other", 7, 3)   # already joined
    out = [torch.zeros(1) for _ in range(world)]
    dist.all_gather(out, torch.tensor([rank + 1.0]))
    return {"world": dist.get_world_size(), "rank": dist.get_rank(),
            "backend": dist.get_backend(), "gathered": [float(t) for t in out]}


def test_two_process_rendezvous_and_allgather(tmp_path):
    """``init_distributed(coordinator="file://...", 2, r)`` in two spawned
    processes (``start_ranks`` calls it with ``backend="gloo"``); a second
    call returns without joining anything."""
    ranks = start_ranks(_allgather_rank, 2, tmp_path, timeout=120)()
    for r, res in enumerate(ranks):
        assert res == {"world": 2, "rank": r, "backend": "gloo",
                       "gathered": [1.0, 2.0]}


def test_failed_explicit_rendezvous_raises_and_no_env_stays_single(
        monkeypatch):
    import torch.distributed as dist
    from mmada_parallel_torch.parallel import init_distributed
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="rendezvous"):
        init_distributed("bogus://nowhere", 2, 0, backend="gloo")
    assert not dist.is_initialized()
    for var in ("MASTER_ADDR", "RANK"):
        monkeypatch.delenv(var, raising=False)
    init_distributed()              # no launcher environment: single
    assert not dist.is_initialized()
