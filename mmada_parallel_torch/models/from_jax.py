"""Bridge: the JAX package's parameter trees -> the port's parameters.

The input is a JAX tree already turned into nested dicts/lists of **numpy**
arrays (``jax.tree_util.tree_map(np.asarray, params)`` on the caller's side),
so this module needs no ``jax``.  Names and nesting are kept; what changes:

* LLaDA: nothing but the container (stacked ``[n_layers, ...]`` blocks and
  ``[d_in, d_out]`` linears are the port's layout too);
* Amused-VQ and MagViT-v2: every conv weight goes from HWIO (JAX, NHWC
  convs) to OIHW (PyTorch, NCHW convs).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

__all__ = ["llada_params_from_jax", "amused_params_from_jax",
           "magvit_params_from_jax"]


def _tensor(x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.kind not in "fiub":       # e.g. ml_dtypes bfloat16
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a, copy=True)).to(device)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def llada_params_from_jax(tree: Any, device=None,
                          dtype: Optional[torch.dtype] = None) -> Any:
    """LLaDA numpy tree -> torch params (same names and shapes)."""
    return _map(tree, lambda a: _tensor(a, device, dtype))


def amused_params_from_jax(tree: Any, device=None,
                           dtype: Optional[torch.dtype] = torch.float32
                           ) -> Any:
    """Amused-VQ numpy tree -> torch params, conv weights HWIO -> OIHW."""
    def convert(node):
        if isinstance(node, dict):
            out = {k: convert(v) for k, v in node.items()}
            if set(node) == {"w", "b"} and np.ndim(node["w"]) == 4:
                out["w"] = out["w"].permute(3, 2, 0, 1).contiguous()
            return out
        if isinstance(node, (list, tuple)):
            return [convert(v) for v in node]
        return _tensor(node, device, dtype)
    return convert(tree)


def magvit_params_from_jax(tree: Any, device=None,
                           dtype: Optional[torch.dtype] = torch.float32
                           ) -> Any:
    """MagViT-v2 numpy tree -> torch params, conv weights HWIO -> OIHW (the
    same conversion as :func:`amused_params_from_jax`)."""
    return amused_params_from_jax(tree, device, dtype)
