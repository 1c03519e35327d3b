"""The port's configuration objects built from a configuration file: the
one place that maps the file's keys onto ``LLaDAConfig``."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LLADA_KEYS = ("d_model", "n_heads", "n_kv_heads", "n_layers",
              "mlp_hidden_size", "vocab_size", "embedding_size",
              "rope_theta", "rms_norm_eps", "max_sequence_length",
              "init_std")


def llada_config(conf: dict, param_dtype: str, compute_dtype: str,
                 remat: str = "none"):
    from mmada_parallel_torch.models.llada import LLaDAConfig
    return LLaDAConfig(**{k: conf[k] for k in LLADA_KEYS},
                       param_dtype=DTYPES[param_dtype],
                       compute_dtype=DTYPES[compute_dtype],
                       mask_token_id=conf["tokens"]["mask"], remat=remat)
