"""The spawned-rank launcher (``parallel/launch.py``) tears a group down
only once every rank is done.

A rank that left as soon as its function returned closed its gloo sockets
while a slower peer was still connecting the subgroups of the mesh, so that
peer failed (``Gloo connectFullMesh failed ... Connection closed by peer``)
or hung.  The rank function here only builds the ``(1, 2, 2)`` mesh and
returns, the shape of that race; it runs several times, one spawn of 4
ranks each, and every rank of every repeat must exit 0.

This module's top-level imports are pytest only: spawned ranks re-import it
to find their function."""

import pytest

REPEATS = 6


def _mesh_rank(rank, world, workdir):
    from mmada_parallel_torch.parallel import MeshConfig, make_mesh
    mesh = make_mesh(MeshConfig(data=1, fsdp=2, tensor=2), "cpu")
    return tuple(mesh.get_coordinate())


def test_mesh_build_and_teardown_repeated(tmp_path):
    from mmada_parallel_torch.parallel.launch import spawn_ranks
    for i in range(REPEATS):
        work = tmp_path / str(i)
        work.mkdir()
        outs = spawn_ranks(_mesh_rank, 4, work, timeout=120)()
        assert [o.exitcode for o in outs] == [0] * 4, (
            i, [o.error for o in outs])
        assert [o.result for o in outs] == [
            (0, r // 2, r % 2) for r in range(4)]


def _failing_rank(rank, world, workdir):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    return rank


def test_a_failed_rank_skips_the_barrier_and_is_the_one_reported(tmp_path):
    """Rank 1 raises and leaves at once; rank 0's barrier then fails (its
    peer's sockets closed) well before the deadline, and rank 0 ends as it
    would have without the barrier, with its result; ``rank_results``
    reports rank 1's traceback."""
    from mmada_parallel_torch.parallel.launch import rank_results, spawn_ranks
    outs = spawn_ranks(_failing_rank, 2, tmp_path, timeout=60)()
    assert outs[1].exitcode not in (0, None)
    assert "rank 1 fails" in outs[1].error
    assert (outs[0].exitcode, outs[0].result, outs[0].error) == (0, 0, None)
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        rank_results(outs)


def _a_data_config(workdir) -> str:
    """A tiny ``train_a`` data config of 8 text-to-image items (as in
    ``test_torch_train_cli.py``)."""
    import json
    import os
    import pickle
    img = os.path.join(workdir, "img.pkl")
    with open(img, "wb") as f:
        pickle.dump({"input_ids": [137], "height": 16, "width": 16}, f)
    items = [{"system_prompt": f"system prompt number {i:02d} of the set",
              "user_prompt": "<uncondition>", "answer_image": img,
              "answer_text": "", "len": 40 + i} for i in range(8)]
    ann = os.path.join(workdir, "items.json")
    with open(ann, "w") as f:
        json.dump(items, f)
    cfg = os.path.join(workdir, "data.yaml")
    with open(cfg, "w") as f:
        f.write(f"META:\n  - path: {ann}\n    type: t2i\n")
    return cfg


def _train_a_rank(rank, world, workdir):
    """One torchrun-style rank of ``cli/train_a.main``: the launcher's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``), from which ``main`` forms its own gloo group.  Returns
    whether a process group is left after ``main`` returned or raised, and
    whether it raised."""
    import os
    import torch.distributed as dist
    from mmada_parallel_torch.cli import train_a
    with open(os.path.join(workdir, "port")) as f:
        port = f.read().strip()
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    with open(os.path.join(workdir, "flags")) as f:
        flags = f.read().split()
    try:
        train_a.main(["--data_config", os.path.join(workdir, "data.yaml"),
                      "--output_dir", os.path.join(workdir, "o"),
                      "--tiny_model", "--device", "cpu", "--precision",
                      "fp32", "--batch_size", "1", "--accum_iter", "2",
                      "--max_steps", "2", "--save_iteration_interval", "2",
                      *flags])
        raised = False
    except (Exception, SystemExit):
        raised = True
    return dist.is_initialized(), raised


@pytest.mark.parametrize("flags,raised", [
    ("--mesh_tensor 2 --tp_ring", False),
    ("--mesh_tensor 4 --tp_ring", True)], ids=["ring", "raises"])
def test_train_a_main_leaves_its_process_group(tmp_path, flags, raised):
    """``train_a.main`` on 2 gloo ranks that it joins itself from the
    launcher's environment, as under torchrun: on the ring (``--mesh_tensor
    2 --tp_ring``, whose rounds are ``batch_isend_irecv`` works) and when it
    raises (a mesh the world cannot hold), each rank returns with no process
    group left."""
    import socket
    from mmada_parallel_torch.parallel.launch import rank_results, spawn_ranks
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    (tmp_path / "port").write_text(str(port))
    (tmp_path / "flags").write_text(flags)
    _a_data_config(str(tmp_path))
    outs = spawn_ranks(_train_a_rank, 2, tmp_path, timeout=240,
                       init_group=False)()
    assert rank_results(outs, "train_a ranks") == [(False, raised)] * 2
