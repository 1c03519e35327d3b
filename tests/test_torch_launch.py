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
