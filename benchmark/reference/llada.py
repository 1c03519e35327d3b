"""Plain LLaDA backbone and vocab head: the benchmark's reference.

Written from the published description of the LLaDA-8B block (RMSNorm,
bidirectional multi-head attention with Neox RoPE, SwiGLU MLP, united
text+image vocab head), with no kernel, cache or batching.  It reads the
parameter dict the benchmark made (``weights.llada_params``): per-layer
weights stacked on a leading axis, linear weights ``[d_in, d_out]``.

Everything is float32 with TF32 off: each layer's weights are upcast when
the layer runs, so a bf16 tree costs one f32 layer at a time.  ``mm`` is
the product used for every linear layer and the head; the control passes
a lower-precision one (``lowp.fp8_mm``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope_tables(L: int, hd: int, theta: float, device):
    """Neox sin/cos ``[L, hd]``: angles in float64, tables in float32."""
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=device) / hd)
    ang = torch.arange(L, dtype=torch.float64, device=device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.sin().float(), ang.cos().float()


def rope(t: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """``t`` ``[B, L, H, hd]``; rotate-half form of Neox RoPE."""
    a, b = t.chunk(2, dim=-1)
    rot = torch.cat([-b, a], dim=-1)
    return t * cos[None, :, None] + rot * sin[None, :, None]


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """``[B, L]`` bool (True = real token) -> ``[B, 1, L, L]`` additive
    bias: 0 where query and key are both real, -1e30 elsewhere (a padded
    query's row is all -1e30 and averages every value)."""
    both = mask[:, :, None] & mask[:, None, :]
    return torch.where(both, 0.0, -1e30)[:, None].float()


def attention(q, k, v, bias=None, heads_per_chunk: int = 8):
    """Softmax attention over all keys, ``[B, L, H, hd]`` in and out, with
    an optional additive ``bias`` ``[B, 1, L, L]``; ``heads_per_chunk``
    heads at a time to bound the score matrix."""
    B, L, H, hd = q.shape
    out = []
    for h0 in range(0, H, heads_per_chunk):
        sl = slice(h0, h0 + heads_per_chunk)
        qh, kh, vh = (t[:, :, sl].transpose(1, 2) for t in (q, k, v))
        s = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
        if bias is not None:
            s = s + bias
        out.append((torch.softmax(s, dim=-1) @ vh).transpose(1, 2))
    return torch.cat(out, dim=2)


def block(x, lp, cfg: dict, sin, cos, mm=f32_mm, bias=None):
    """One LLaDA block on ``x`` ``[B, L, d]`` (f32) with layer weights
    ``lp`` (any float dtype; upcast here)."""
    p = {k: v.float() for k, v in lp.items()}
    H, KV = cfg["n_heads"], cfg["n_kv_heads"]
    hd = cfg["d_model"] // H
    eps = cfg["rms_norm_eps"]
    B, L, _ = x.shape
    h = rms_norm(x, p["attn_norm"], eps)
    q = mm(h, p["q_proj"]).view(B, L, H, hd)
    k = mm(h, p["k_proj"]).view(B, L, KV, hd)
    v = mm(h, p["v_proj"]).view(B, L, KV, hd)
    q, k = rope(q, sin, cos), rope(k, sin, cos)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    att = attention(q, k, v, bias).reshape(B, L, H * hd)
    x = x + mm(att, p["attn_out"])
    h = rms_norm(x, p["ff_norm"], eps)
    g = F.silu(mm(h, p["ff_proj"])) * mm(h, p["up_proj"])
    return x + mm(g, p["ff_out"])


def layer_params(params: dict, i: int) -> dict:
    return {k: v[i] for k, v in params["blocks"].items()}


def hidden(params: dict, cfg: dict, ids: torch.Tensor, mm=f32_mm,
           checkpoint_layers: bool = False, mask=None) -> torch.Tensor:
    """``[B, L]`` ids -> ``[B, L, d]`` f32 hidden states after ``ln_f``.
    ``checkpoint_layers`` recomputes each layer in the backward (for the
    training reference, so one layer's scores are alive at a time);
    ``mask`` (``[B, L]`` bool, True = real) pads keys and queries."""
    bias = None if mask is None else padding_bias(mask.bool())
    wte = params["wte"]
    x = F.embedding(ids.long().clamp(0, wte.shape[0] - 1), wte).float()
    L = ids.shape[1]
    hd = cfg["d_model"] // cfg["n_heads"]
    sin, cos = rope_tables(L, hd, cfg["rope_theta"], ids.device)
    for i in range(cfg["n_layers"]):
        lp = layer_params(params, i)
        if checkpoint_layers and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(
                block, x, lp, cfg, sin, cos, mm, bias, use_reentrant=False)
        else:
            x = block(x, lp, cfg, sin, cos, mm, bias)
    return rms_norm(x, params["ln_f"].float(), cfg["rms_norm_eps"])


def head(params: dict, h: torch.Tensor, lo: int = 0, hi=None, mm=f32_mm):
    """Logits of head columns ``[lo, hi)`` for hidden states ``h``."""
    w = params["head"]
    hi = w.shape[1] if hi is None else hi
    return mm(h, w[:, lo:hi].float())
