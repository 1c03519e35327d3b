"""Flat ``.npz`` persistence for parameter trees.

A dependency-light sibling of ``training/checkpoint.py`` for small artifacts
that want a single portable file (a trained demo model's parameters keyed by
a source hash, an example's optional ``param_store``).

Leaves are stored under the JAX package's key paths
(``jax.tree_util.keystr``: ``['blocks']['att_proj']['w']`` for a dict key,
``[0]`` for a list index), so a store written by either package loads in the
other.  bfloat16 leaves are stored as float32 (``np.savez`` cannot hold
bf16; the upcast is exact) and cast back to the template leaf's dtype on
load, so a round-trip is bit-exact for bf16/f32 trees.

Counterpart of :mod:`mmada_parallel_tpu.utils.param_store`.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["save_params", "load_params"]


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """``{keystr: leaf}`` of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        items = ((f"[{k!r}]", v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((f"[{i}]", v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    return {k: leaf for key, v in items
            for k, leaf in _flatten(v, prefix + key).items()}


def _unflatten(template: Any, fn, prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, fn, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, fn, f"{prefix}[{i}]")
                              for i, v in enumerate(template))
    return fn(prefix, template)


def save_params(path: str, params: Any) -> None:
    arrays = {}
    for key, leaf in _flatten(params).items():
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        else:
            a = np.asarray(leaf)
        arrays[key] = a
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_params(path: str, template: Any) -> Any:
    """Rebuild ``template``'s tree from ``path``; every leaf gets the
    template leaf's dtype and device.  Raises ``KeyError`` if the file does
    not cover the template (shape/key drift -> retrain)."""
    with np.load(path) as z:
        stored = {k: z[k] for k in z.files}

    def pick(key, leaf):
        a = stored[key]
        if tuple(a.shape) != tuple(leaf.shape):
            raise KeyError(f"shape drift at {key}: stored {a.shape} vs "
                           f"template {tuple(leaf.shape)}")
        return torch.from_numpy(a).to(device=leaf.device, dtype=leaf.dtype)

    return _unflatten(template, pick)
