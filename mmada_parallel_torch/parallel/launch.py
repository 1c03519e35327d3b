"""Run a function as the ranks of one process group on this host.

:func:`spawn_ranks` starts ``world`` spawned processes that meet through a
``file://`` rendezvous in a working directory and run ``fn(rank, world,
workdir)``: CPU ranks on gloo with one thread each, or CUDA ranks (on gloo
every rank on ``cuda:0``, on NCCL rank ``r`` on ``cuda:r``).  Each rank's
result, or its traceback, lands in the working directory, and ``join()``
collects them, killing what outlives its deadline.  A rank that returns
waits at a barrier for its peers before it leaves the group, so none closes
its sockets while a peer is still setting up a group of the mesh; a rank
that raised skips it, and its peers leave at their deadline (or when its
sockets close) with their results.  The CLIs that form a group under
torchrun leave it the same way (``mesh.leaves_process_group``).  The rings
and sharded trainers of ``chip_smoke.py`` and of the port's tests start this
way.

``fn`` must be a module-level function: spawned children re-import its
module to find it.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["RankOutcome", "spawn_ranks", "rank_results"]


@dataclasses.dataclass
class RankOutcome:
    """How one spawned rank ended: ``exitcode`` is None where the rank was
    still running at the deadline (it was killed); ``error`` is its
    traceback where ``fn`` raised; ``result`` is what ``fn`` returned."""

    exitcode: Optional[int]
    result: Any = None
    error: Optional[str] = None


def _rank_entry(fn, rank, world, workdir, backend, device_type, deadline,
                init_group=True):
    if device_type == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    else:
        torch.set_num_threads(1)
    try:
        from mmada_parallel_torch.parallel.mesh import (init_distributed,
                                                        teardown_barrier)
        if init_group:
            init_distributed(f"file://{workdir}/rdv", world, rank, backend)
        out = fn(rank, world, workdir)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
        # a rank whose fn raised never gets here: its peers' barrier fails
        # at the deadline (or when the gone rank's sockets close), and the
        # rank that raised is the one reported
        try:
            if dist.is_initialized():
                teardown_barrier(backend, deadline)
        except RuntimeError as e:
            sys.stderr.write(f"rank {rank}: a peer never reached the "
                             f"teardown barrier: {str(e)[:200]}\n")
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, workdir, backend: str = "gloo",
                device_type: str = "cpu", timeout: float = 300.0,
                init_group: bool = True) -> Callable[[], List[RankOutcome]]:
    """Start ``world`` ranks running ``fn(rank, world, workdir)``; returns
    ``join()``, which waits at most ``timeout`` s from now, kills what is
    left and gives each rank's :class:`RankOutcome`.  ``workdir`` must be
    empty of an earlier run's rendezvous and results.  With ``init_group``
    false the ranks form no group: ``fn`` forms its own (as a torchrun
    rank's ``main`` does) and leaves it."""
    import torch.multiprocessing as mp
    workdir = str(workdir)
    ctx = mp.get_context("spawn")
    deadline = time.time() + timeout
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, workdir, backend, device_type,
                               deadline, init_group))
             for r in range(world)]
    for p in procs:
        p.start()

    def join() -> List[RankOutcome]:
        try:
            for p in procs:
                p.join(max(deadline - time.time(), 1.0))
        finally:
            hung = [p.is_alive() for p in procs]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        outs = []
        for r, p in enumerate(procs):
            err = os.path.join(workdir, f"rank{r}.err")
            res = os.path.join(workdir, f"rank{r}.pt")
            outs.append(RankOutcome(
                None if hung[r] else p.exitcode,
                torch.load(res, weights_only=False)
                if os.path.exists(res) else None,
                open(err).read() if os.path.exists(err) else None))
        return outs

    return join


def rank_results(outcomes: List[RankOutcome], what: str = "ranks") -> list:
    """Each rank's result; raises ``RuntimeError`` with the tracebacks
    where a rank raised, died or was still running at its deadline."""
    if all(o.exitcode == 0 and o.error is None for o in outcomes):
        return [o.result for o in outcomes]
    errs = "".join(f"--- rank {r}\n{o.error}"
                   for r, o in enumerate(outcomes) if o.error)
    raise RuntimeError(
        f"{what} failed (exit codes {[o.exitcode for o in outcomes]}; None: "
        f"still running at the deadline, killed)\n{errs[-8000:]}")
