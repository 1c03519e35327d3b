"""The capability demos: tiny models trained from scratch through the port's
production stack (item processors and prompting, masking, losses, the train
step, checkpoints), then scored through its samplers, servers and eval
sweeps.

Counterparts of the JAX package's ``examples/`` scripts, one module each,
run as ``python -m mmada_parallel_torch.examples.<name> --device cuda``:

* :mod:`.train_edit_demo` -- variant M, the palette-shift interleave edit;
* :mod:`.train_edit_demo_a` -- variant A, the same edit through the TI2TI
  template;
* :mod:`.train_multitask_demo` -- joint t2i + mmu through
  ``forward_process_separate``, scored by the t2i and mmu sweeps;
* :mod:`.parabench_demo` -- the ParaBench-style sweep on the trained A model;
* :mod:`.pararl_resteer_demo` -- a short SFT, then ParaRL's REINFORCE.

Their models have head_dim 32, which the attention kernels do not take
(``auto`` on a CUDA tensor launches a kernel or raises), so each demo's
config asks for the plain attention (``attention_impl="xla"``) on every
device.
"""

import shutil
import tempfile
from typing import Any, Dict, Optional

import torch

from mmada_parallel_torch.training.checkpoint import CheckpointManager
from mmada_parallel_torch.training.trainer import TrainState

__all__ = ["resolve_device", "checkpoint_round_trip"]


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device without a card raises (pass
    ``--device cpu`` to run on the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device here (pass "
                           f"--device cpu to run on the CPU)")
    return device


def checkpoint_round_trip(state: TrainState, step: int, fresh: TrainState,
                          metadata: Dict[str, Any],
                          directory: Optional[str] = None) -> Any:
    """Save ``state`` at ``step`` with the port's :class:`CheckpointManager`,
    restore it into ``fresh`` (other weights, an optimizer state of the same
    tree) and return the restored params.  ``directory`` is emptied first;
    ``None`` uses a temporary directory, removed afterwards."""
    tmp = None
    if directory is None:
        directory = tmp = tempfile.mkdtemp(prefix="demo_ckpt_")
    else:
        shutil.rmtree(directory, ignore_errors=True)
    try:
        CheckpointManager(directory).save(step, state, metadata=metadata)
        restored, meta, last = CheckpointManager(directory).restore(fresh)
        if restored is None or last != step or meta != metadata:
            raise RuntimeError(f"checkpoint restore failed: step {last}, "
                               f"metadata {meta}")
        return restored.params
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
