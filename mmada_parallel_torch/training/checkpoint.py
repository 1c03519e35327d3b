"""Train-state checkpoints on disk.

Counterpart of :mod:`mmada_parallel_tpu.training.checkpoint` (orbax there):
the same ``save(step, state, metadata)``, ``restore(state) -> (state,
metadata, step)``, ``max_to_keep`` and ``wait()``.  Layout:
``{directory}/{step}/state.pt`` holds the :class:`TrainState` as a
``torch.save`` dict of tensors and ints (loaded with ``weights_only=True``),
``{directory}/{step}/metadata.json`` a small JSON dict (epoch, data position,
metric-logger state).  A step is written into a temporary directory and
renamed into place, so a crash never leaves a torn checkpoint behind.
Writes are synchronous, so :meth:`wait` has nothing to wait for.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import torch

from mmada_parallel_torch.training.trainer import TrainState

__all__ = ["CheckpointManager"]


def _restore_into(template: Any, loaded: Any) -> Any:
    """``loaded`` copied into ``template``'s tensors (keeping their device,
    dtype and ``requires_grad``); other leaves are taken from ``loaded``."""
    if isinstance(template, dict):
        if set(template) != set(loaded):
            raise ValueError(f"checkpoint keys {sorted(loaded)} do not match "
                             f"the state's {sorted(template)}")
        return {k: _restore_into(v, loaded[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore_into(t, x)
                              for t, x in zip(template, loaded))
    if isinstance(template, torch.Tensor):
        if template.shape != loaded.shape:
            raise ValueError(f"checkpoint tensor of shape "
                             f"{tuple(loaded.shape)} for a state tensor of "
                             f"shape {tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(loaded)
        return template
    return loaded


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             metadata: Optional[Dict[str, Any]] = None) -> bool:
        """Write ``state`` at ``step``; False (nothing written) when ``step``
        is not past the latest saved step."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            torch.save({"params": state.params, "opt_state": state.opt_state,
                        "step": int(state.step)},
                       os.path.join(tmp, "state.pt"))
            with open(os.path.join(tmp, "metadata.json"), "w") as f:
                json.dump(metadata or {}, f)
            os.replace(tmp, os.path.join(self.directory, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, state_template: TrainState, step: Optional[int] = None):
        """``(state, metadata, step)`` of ``step`` (default: the latest),
        loaded into ``state_template``'s tensors; ``(None, None, None)``
        when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        d = os.path.join(self.directory, str(step))
        loaded = torch.load(os.path.join(d, "state.pt"), map_location="cpu",
                            weights_only=True)
        with open(os.path.join(d, "metadata.json")) as f:
            metadata = json.load(f)
        state = TrainState(
            params=_restore_into(state_template.params, loaded["params"]),
            opt_state=_restore_into(state_template.opt_state,
                                    loaded["opt_state"]),
            step=int(loaded["step"]))
        return state, metadata, step

    def wait(self) -> None:
        """Writes are synchronous: nothing is pending."""
