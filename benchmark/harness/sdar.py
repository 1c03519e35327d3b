"""SDAR-30B-A3B in the benchmark: the port's configuration built from a
configuration file's published keys, and the seeded weights.

The file holds the published ``config.json`` keys (``hidden_size``,
``num_experts``, ...) and, under ``assumed``-listed keys of its own, what
the config does not give (``block_length``, ``steps_per_block``, the
tokens).  :func:`port_config` maps them onto
``LLaDAConfig.sdar_30b_a3b``, passing every one, so a smaller test file
makes a smaller model through the same preset.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness import port


def port_config(conf: dict):
    from mmada_parallel_torch.models.llada import LLaDAConfig
    dt = port.DTYPES[conf["dtype"]]
    return LLaDAConfig.sdar_30b_a3b(
        d_model=conf["hidden_size"], n_layers=conf["num_hidden_layers"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], head_dim=conf["head_dim"],
        mlp_hidden_size=conf["intermediate_size"],
        vocab_size=conf["vocab_size"], rope_theta=float(conf["rope_theta"]),
        rms_norm_eps=conf["rms_norm_eps"],
        max_sequence_length=conf["max_position_embeddings"],
        n_experts=conf["num_experts"],
        experts_per_token=conf["num_experts_per_tok"],
        moe_hidden_size=conf["moe_intermediate_size"],
        norm_topk_prob=conf["norm_topk_prob"],
        block_length=conf["block_length"],
        mask_token_id=conf["tokens"]["mask"], init_std=conf["init_std"],
        param_dtype=dt, compute_dtype=dt)


def sdar_params(conf: dict, gen: torch.Generator, dtype) -> dict:
    """The SDAR tree of ``conf`` in the port's layout, one draw a leaf, in
    ``dtype`` on the generator's device: normal(0, ``init_std``), the
    experts' down projection divided by ``sqrt(2 n_layers)`` (as LLaDA's
    ``ff_out``), norms 1."""
    dev = gen.device
    d, L = conf["hidden_size"], conf["num_hidden_layers"]
    H, KV, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    E, m, V = (conf["num_experts"], conf["moe_intermediate_size"],
               conf["vocab_size"])
    std = conf["init_std"]

    def normal(*shape, scale=1.0):
        w = torch.empty(shape, dtype=dtype, device=dev)
        return w.normal_(0.0, std * scale, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    blocks = {"attn_norm": ones(L, d), "ff_norm": ones(L, d),
              "q_proj": normal(L, d, H * hd), "k_proj": normal(L, d, KV * hd),
              "v_proj": normal(L, d, KV * hd),
              "attn_out": normal(L, H * hd, d),
              "q_norm": ones(L, hd), "k_norm": ones(L, hd),
              "router": normal(L, d, E),
              "expert_gate": normal(L, E, d, m),
              "expert_up": normal(L, E, d, m),
              "expert_down": normal(L, E, m, d,
                                    scale=1.0 / math.sqrt(2 * L))}
    return {"wte": normal(V, d), "ln_f": ones(d), "blocks": blocks,
            "head": normal(d, V)}
