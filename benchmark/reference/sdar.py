"""Plain SDAR-30B-A3B forward: the reference of the ``sdar-blockgen`` cell
and of the port's CPU tests.

Written from the published description (huggingface.co/JetLM/
SDAR-30B-A3B-Chat's ``config.json``, Qwen3-MoE's block, which SDAR keeps;
the keys ``decoder_sparse_step`` 1 and ``mlp_only_layers`` [] make every
layer a mixture of experts).  Each of the ``num_hidden_layers`` layers::

    h = RMSNorm(x);  q, k, v = h Wq, h Wk, h Wv          (no bias)
    q, k = RMSNorm_head(q), RMSNorm_head(k)            (over head_dim)
    q, k = RoPE(q), RoPE(k)                            (Neox, rope_theta)
    x += softmax(q k^T / sqrt(head_dim) + mask) v Wo   (GQA)
    h = RMSNorm(x);  p = softmax(h Wr)                 (num_experts)
    w, e = top_k(p), renormalised to 1 (norm_topk_prob)
    x += sum_j w_j down_e_j(silu(gate_e_j h) * up_e_j h)

then a final RMSNorm and the untied head.  The mask is block-causal: a
position sees every key before the end of its block.  It reads the
configuration file's published keys (``hidden_size``,
``num_attention_heads``, ...) and the parameter dict in the port's layout
(per-layer weights stacked on a leading axis, linear weights ``[d_in,
d_out]``, experts ``[E, d_in, d_out]``).

Float32 throughout, TF32 off (the caller's: ``benchmark/harness/core.py``
sets it, the tests run on the CPU); no kernel, cache or batching: one row,
a dense ``[L, L]`` mask, the experts as a loop.  Departures from the
published description, each deliberate:

* blocks are aligned at ``start`` (the answer's first position), so the
  prompt's first block is the short one: what a prompt left-padded to a
  multiple of the block with pads nobody attends to gives.  The block
  length itself is not published (the configuration file assumes it);
* the router's product and softmax are f32, and the top-k weights stay
  f32; Qwen3-MoE's modeling rounds the router's logits and the weights to
  bf16 and sums the experts in bf16.  The reference is the exact function;
* ``routes``: where the caller gives a program's top-k choices at watched
  positions, the reference takes them wherever its own 8th and 9th
  probabilities lie within ``tie`` (a near-tie that rounding may flip), so
  that the layers after it see the same experts; elsewhere it keeps its
  own and counts the difference (:func:`hidden`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import llada as R

f32_mm = R.f32_mm


def block_bounds(L: int, start: int, block: int, device=None):
    """``[L]`` key bounds: position ``q`` sees keys ``< bound[q]``, the end
    of its block (blocks aligned at ``start``), at most ``L``."""
    q = torch.arange(L, device=device)
    return ((q - start).div(block, rounding_mode="floor") * block + start
            + block).clamp(max=L)


def mask_bias(bounds: torch.Tensor, L: int) -> torch.Tensor:
    """The dense ``[1, 1, n, L]`` additive mask of ``n`` rows' bounds."""
    keys = torch.arange(L, device=bounds.device)
    return torch.where(keys[None] < bounds[:, None], 0.0,
                       -1e30)[None, None].float()


def dims(cfg: dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"],
            cfg["num_key_value_heads"], cfg["head_dim"])


def route(probs: torch.Tensor, k: int, norm: bool, forced=None,
          tie: float = 0.0):
    """Top-``k`` of ``probs [n, E]``: ``(weights, experts, flips, gaps)``.
    ``forced [n, k]``: a program's choices, taken at the rows whose
    ``k``-th and ``k+1``-th probabilities lie within ``tie``; ``flips``
    counts the rows where they differ from the reference's own and are not
    taken, ``gaps`` holds each differing row's gap (taken or not)."""
    top = torch.topk(probs, k + 1, dim=-1)
    ids = top.indices[:, :k]
    gaps = torch.zeros(0, device=probs.device)
    flips = 0
    if forced is not None:
        forced = forced.to(ids.device).long()
        same = (ids.sort(-1).values == forced.sort(-1).values).all(-1)
        gap = top.values[:, k - 1] - top.values[:, k]
        differ = ~same
        gaps = gap[differ]
        take = differ & (gap < tie)
        flips = int((differ & ~take).sum())
        ids = torch.where(take[:, None], forced, ids)
    w = probs.gather(-1, ids)
    if norm:
        w = w / w.sum(-1, keepdim=True)
    return w, ids, flips, gaps


def moe(h: torch.Tensor, lp: dict, cfg: dict, mm=f32_mm, forced=None,
        watch=None, tie: float = 0.0):
    """The experts on ``h [L, d]``; returns ``(out, info)``.  ``watch``
    (positions): ``info`` has their chosen experts (``experts``) and,
    with ``forced`` (the program's choices there), ``flips`` and
    ``gaps`` (:func:`route`)."""
    k, E = cfg["num_experts_per_tok"], cfg["num_experts"]
    probs = torch.softmax(mm(h, lp["router"].float()), dim=-1)
    w, ids, flips, gaps = route(probs, k, cfg["norm_topk_prob"])
    info = {}
    if watch is not None:
        ww, wi, flips, gaps = route(probs[watch], k, cfg["norm_topk_prob"],
                                    forced, tie)
        w, ids = w.clone(), ids.clone()
        w[watch], ids[watch] = ww, wi
        info = {"experts": wi, "flips": flips, "gaps": gaps}
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        g = F.silu(mm(x, lp["expert_gate"][e].float()))
        y = mm(g * mm(x, lp["expert_up"][e].float()),
               lp["expert_down"][e].float())
        out.index_add_(0, tok, y * w[tok, slot][:, None])
    return out, info


def layer_params(params: dict, i: int, experts: bool = False) -> dict:
    """Layer ``i``'s weights, upcast to f32 except the experts (the loop
    upcasts one expert at a time)."""
    big = ("expert_gate", "expert_up", "expert_down")
    return {k: (v[i] if k in big else v[i].float())
            for k, v in params["blocks"].items()}


def block(x, lp, cfg: dict, sin, cos, bias, mm=f32_mm, forced=None,
          watch=None, tie: float = 0.0):
    """One layer on ``x [L, d]`` (f32); returns ``(x, routing info)``."""
    d, H, KV, hd = dims(cfg)
    eps = cfg["rms_norm_eps"]
    L = x.shape[0]
    h = R.rms_norm(x, lp["attn_norm"], eps)
    q = R.rms_norm(mm(h, lp["q_proj"]).view(1, L, H, hd), lp["q_norm"], eps)
    k = R.rms_norm(mm(h, lp["k_proj"]).view(1, L, KV, hd), lp["k_norm"],
                   eps)
    v = mm(h, lp["v_proj"]).view(1, L, KV, hd)
    q, k = R.rope(q, sin, cos), R.rope(k, sin, cos)
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    att = R.attention(q, k, v, bias).reshape(L, H * hd)
    x = x + mm(att, lp["attn_out"])
    y, info = moe(R.rms_norm(x, lp["ff_norm"], eps), lp, cfg, mm, forced,
                  watch, tie)
    return x + y, info


def hidden(params: dict, cfg: dict, ids: torch.Tensor, start: int,
           block_length: int, mm=f32_mm, routes=None, watch=None,
           tie: float = 0.0):
    """One row's ``ids [L]`` -> ``([L, d]`` f32 hidden states after the
    final norm, ``[info a layer]``) under the block-causal mask aligned at
    ``start``.  ``watch``: positions whose routing each layer's info
    reports; ``routes``: the program's choices there, ``[n_layers][n,
    k]`` (see the module's departures)."""
    L = ids.shape[0]
    wte = params["wte"]
    x = F.embedding(ids.long().clamp(0, wte.shape[0] - 1), wte).float()
    sin, cos = R.rope_tables(L, cfg["head_dim"], cfg["rope_theta"],
                             ids.device)
    bias = mask_bias(block_bounds(L, start, block_length, ids.device), L)
    infos = []
    for i in range(cfg["num_hidden_layers"]):
        forced = None if routes is None else routes[i]
        x, info = block(x, layer_params(params, i), cfg, sin, cos, bias, mm,
                        forced, watch, tie)
        infos.append(info)
    return R.rms_norm(x, params["ln_f"].float(), cfg["rms_norm_eps"]), infos


def head(params: dict, h: torch.Tensor, mm=f32_mm) -> torch.Tensor:
    """Logits of the untied head for hidden states ``h``."""
    return mm(h, params["head"].float())
