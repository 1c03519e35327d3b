"""Typed config tree with YAML + dotted CLI overrides.

One config system serving both reference styles (A: argparse + data yaml,
``finetune.py:163-213``; M: OmegaConf ``config=<yaml>`` with dotted
overrides, ``training/utils.py:12-17``) without the OmegaConf dependency:

    cfg = load_config("run.yaml", ["training.lr=1e-4", "mesh.tensor=4"])

Values parse as YAML scalars (plus OmegaConf-style ``1e-4`` floats); new
keys are accepted permissively (DEFAULTS-driven CLIs add run-specific keys).

Counterpart of :mod:`mmada_parallel_tpu.config`, copied so that the port
imports nothing of the JAX package.  ``yaml`` is imported by the functions
that parse, so importing this module does not import it.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence

_SCI_NOTATION = re.compile(r"[+-]?\d+(\.\d*)?[eE][+-]?\d+")

__all__ = ["ConfigNode", "merge_dict", "parse_overrides", "load_config"]


class ConfigNode(dict):
    """Attribute-accessible nested dict (tiny OmegaConf stand-in)."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    @staticmethod
    def wrap(obj):
        if isinstance(obj, Mapping):
            return ConfigNode({k: ConfigNode.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [ConfigNode.wrap(v) for v in obj]
        return obj

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node


def merge_dict(base: Dict, override: Mapping) -> Dict:
    out = copy.deepcopy(dict(base))
    for k, v in override.items():
        if (k in out and isinstance(out[k], Mapping)
                and isinstance(v, Mapping)):
            out[k] = merge_dict(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def parse_overrides(args: Sequence[str]) -> Dict:
    """``["a.b=1", "c=[1,2]"] -> {"a": {"b": 1}, "c": [1, 2]}``."""
    import yaml
    out: Dict = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override must be key=value: {arg!r}")
        key, _, raw = arg.partition("=")
        value = yaml.safe_load(raw) if raw != "" else None
        if (isinstance(value, str) and raw == value
                and _SCI_NOTATION.fullmatch(value)):
            # YAML 1.1 reads "1e-4" as a string (no dot before the
            # exponent); users reasonably expect a float — match OmegaConf.
            # Only unquoted strict scientific notation is coerced, so quoted
            # values and strings like "nan"/"1_000" stay strings.
            value = float(value)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def load_config(path: Optional[str] = None,
                overrides: Sequence[str] = (),
                defaults: Optional[Mapping] = None) -> ConfigNode:
    import yaml
    cfg: Dict = dict(defaults or {})
    if path is not None:
        with open(path) as f:
            cfg = merge_dict(cfg, yaml.safe_load(f) or {})
    cfg = merge_dict(cfg, parse_overrides(list(overrides)))
    return ConfigNode.wrap(cfg)
