"""Plain replay of a feature-cached LLaDA forward: the full forward that
builds the per-layer k/v cache, and a partial forward of selected
positions against it, for the ``a-edit-cached`` check.

Written from the feature cache's description (the A sampler's opt-in
``use_cache`` path): a refresh step runs every position and keeps each
layer's post-RoPE k and its v; a partial step runs only the selected
positions, writes their fresh k (rotated at their own positions) and v
into the cache, and attends from them to every cached position.  One row,
float32 with TF32 off, the same block as ``reference/llada.py`` (whose
pieces it uses), no kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import llada as R


def _layer(x, lp, cfg: dict, sin, cos, attend, mm):
    """One LLaDA block on ``x [n, d]`` whose attention is ``attend(q, k,
    v)`` on ``[1, n, H|KV, hd]`` tensors, q and k rotated by ``sin``,
    ``cos`` ``[n, hd]``."""
    p = {k: v.float() for k, v in lp.items()}
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["d_model"] // H
    eps = cfg["rms_norm_eps"]
    n = x.shape[0]
    h = R.rms_norm(x, p["attn_norm"], eps)
    q = R.rope(mm(h, p["q_proj"]).view(1, n, H, hd), sin, cos)
    k = R.rope(mm(h, p["k_proj"]).view(1, n, KV, hd), sin, cos)
    v = mm(h, p["v_proj"]).view(1, n, KV, hd)
    att = attend(q, k, v).reshape(n, H * hd)
    x = x + mm(att, p["attn_out"])
    h = R.rms_norm(x, p["ff_norm"], eps)
    g = F.silu(mm(h, p["ff_proj"])) * mm(h, p["up_proj"])
    return x + mm(g, p["ff_out"])


def _full_kv(k, v, H: int):
    KV = k.shape[2]
    return (k.repeat_interleave(H // KV, dim=2),
            v.repeat_interleave(H // KV, dim=2))


def build(params: dict, cfg: dict, ids: torch.Tensor, mm=R.f32_mm):
    """One row's ``ids [L]`` -> (``[L, d]`` f32 hidden states after
    ``ln_f``, the cache ``{"k", "v"}``: ``[n_layers, L, KV, hd]`` f32, k
    after RoPE)."""
    L = ids.shape[0]
    hd = cfg["d_model"] // cfg["n_heads"]
    sin, cos = R.rope_tables(L, hd, cfg["rope_theta"], ids.device)
    x = F.embedding(ids.long().clamp(0, params["wte"].shape[0] - 1),
                    params["wte"]).float()
    cache = {"k": [], "v": []}

    def attend(q, k, v):
        cache["k"].append(k[0])
        cache["v"].append(v[0])
        return R.attention(q, *_full_kv(k, v, cfg["n_heads"]))

    for i in range(cfg["n_layers"]):
        x = _layer(x, R.layer_params(params, i), cfg, sin, cos, attend, mm)
    cache = {n: torch.stack(t) for n, t in cache.items()}
    return R.rms_norm(x, params["ln_f"].float(), cfg["rms_norm_eps"]), cache


def partial(params: dict, cfg: dict, cache: dict, sel_ids: torch.Tensor,
            sel_pos: torch.Tensor, mm=R.f32_mm) -> torch.Tensor:
    """The selected ``sel_ids [n]`` at positions ``sel_pos [n]`` through
    every layer against the cache (updated in place with their k and v);
    returns their ``[n, d]`` f32 hidden states after ``ln_f``."""
    L = cache["k"].shape[1]
    hd = cfg["d_model"] // cfg["n_heads"]
    sin, cos = R.rope_tables(L, hd, cfg["rope_theta"], sel_ids.device)
    pos = sel_pos.long()
    x = F.embedding(sel_ids.long().clamp(0, params["wte"].shape[0] - 1),
                    params["wte"]).float()
    for i in range(cfg["n_layers"]):
        def attend(q, k, v, i=i):
            cache["k"][i][pos] = k[0]
            cache["v"][i][pos] = v[0]
            return R.attention(q, *_full_kv(cache["k"][i][None],
                                            cache["v"][i][None],
                                            cfg["n_heads"]))
        x = _layer(x, R.layer_params(params, i), cfg, sin[pos], cos[pos],
                   attend, mm)
    return R.rms_norm(x, params["ln_f"].float(), cfg["rms_norm_eps"])
