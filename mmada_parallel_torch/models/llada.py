"""LLaDA masked-diffusion transformer backbone in PyTorch.

Counterpart of :mod:`mmada_parallel_tpu.models.llada`: bidirectional
attention, GQA, Neox RoPE, RMSNorm, SwiGLU-gated MLP, united text+image vocab
head.  Parameters are a plain dict whose names and shapes map 1:1 to the JAX
pytree: per-layer weights stack on a leading ``[n_layers, ...]`` axis and
linear weights keep the ``[d_in, d_out]`` layout, applied as ``x @ w``.  The
layer stack is a Python loop over that axis (the JAX ``lax.scan``).

The forwards are differentiable: f32 parameters are cast to
``compute_dtype`` inside them, so their gradients come back in f32, and
``remat`` checkpoints layers (``torch.utils.checkpoint``) as the JAX
``jax.checkpoint`` strategies do.  The inference pipelines run them under
``torch.inference_mode()``; nothing here turns grad off.

Attention goes through :func:`mmada_parallel_torch.ops.attention.rope_attention`
(and, for the feature-cached forwards, ``rope_attention_qonly``), which
launch the fused-RoPE CUDA kernels for CUDA tensors.  A linear weight may be
a W8A8 dict (:func:`mmada_parallel_torch.ops.quant.quantize_llada_params`):
the block GEMMs and the head then take the int8 product.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mmada_parallel_torch.ops.attention import (rope_attention,
                                                 rope_attention_qonly)
from mmada_parallel_torch.ops.masks import pairwise_padding_mask, to_bias
from mmada_parallel_torch.ops.quant import int8_matmul
from mmada_parallel_torch.ops.rope_attention import rope_tensor

__all__ = ["LLaDAConfig", "init_llada_params", "llada_hidden", "llada_head",
           "llada_forward", "llada_hidden_with_cache", "llada_hidden_partial",
           "count_params"]


@dataclasses.dataclass(frozen=True)
class LLaDAConfig:
    """Architecture hyperparameters; fields and defaults as the JAX
    ``LLaDAConfig``, with ``torch.dtype`` execution dtypes."""

    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: Optional[int] = None          # None -> n_heads (MHA)
    n_layers: int = 32
    mlp_hidden_size: Optional[int] = None     # None -> mlp_ratio * d_model
    mlp_ratio: int = 4
    vocab_size: int = 126464
    embedding_size: Optional[int] = None      # None -> vocab_size
    max_sequence_length: int = 8192           # RoPE table bound (informative)
    rope_theta: float = 500000.0
    rope_full_precision: bool = True
    rms_norm_eps: float = 1e-5
    layer_norm_type: str = "rms"              # "rms" | "gemma_rms" | "default"
    include_bias: bool = False
    include_qkv_bias: bool = False
    block_type: str = "llama"                 # "llama" | "sequential"
    activation_type: str = "silu"             # "silu" | "gelu" | "relu" | "swiglu"
    weight_tying: bool = False
    input_emb_norm: bool = False
    scale_logits: bool = False
    attention_layer_norm: bool = False        # q/k norm (unused by 8B ckpts)
    init_fn: str = "normal"
    init_std: float = 0.02
    init_cutoff_factor: Optional[float] = None
    mask_token_id: int = 126336
    eos_token_id: int = 126081
    pad_token_id: int = 126081
    # --- execution policy (not part of the checkpoint contract) ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "none"                       # "none" | "whole_layer" | "one_in_{two,three,four}"
    attention_impl: str = "auto"              # "auto" | "xla" | "pallas"

    @property
    def effective_n_kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def hidden_size(self) -> int:
        return (self.mlp_hidden_size if self.mlp_hidden_size is not None
                else self.mlp_ratio * self.d_model)

    @property
    def emb_size(self) -> int:
        return self.embedding_size if self.embedding_size is not None else self.vocab_size

    @property
    def act_output_multiplier(self) -> float:
        return 0.5 if self.activation_type == "swiglu" else 1.0

    def validate(self) -> None:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        if self.n_heads % self.effective_n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @classmethod
    def tiny(cls, **overrides) -> "LLaDAConfig":
        """A CPU-testable config preserving every structural feature."""
        base = dict(d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
                    mlp_hidden_size=128, vocab_size=512, rope_theta=10000.0,
                    max_sequence_length=512, mask_token_id=3,
                    param_dtype=torch.float32, compute_dtype=torch.float32)
        base.update(overrides)
        return cls(**base)

    @classmethod
    def llada_8b(cls, **overrides) -> "LLaDAConfig":
        """The released MMaDA-Parallel-A/M backbone shape: d_model 4096,
        32 layers, 32 heads, mlp 12288, united vocab 126464 / 134656."""
        base = dict(d_model=4096, n_heads=32, n_kv_heads=32, n_layers=32,
                    mlp_hidden_size=12288, vocab_size=126464,
                    embedding_size=134656, rope_theta=500000.0,
                    max_sequence_length=8192)
        base.update(overrides)
        return cls(**base)


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def init_llada_params(cfg: LLaDAConfig, generator: torch.Generator,
                      device: Optional[torch.device] = None
                      ) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` straight into
    ``cfg.param_dtype`` on ``device`` (default: the generator's device), so
    the 8B tree (~16 GB in bf16) never passes through host memory.

    The ``normal`` init of the JAX package: std ``init_std``, truncated at
    ``init_cutoff_factor`` when set, with the residual ``ff_out`` scaled by
    ``1/sqrt(2*n_layers)``.  The two frameworks draw different numbers from
    one seed; tests that need equal weights bridge them with
    :mod:`mmada_parallel_torch.models.from_jax`."""
    cfg.validate()
    if cfg.init_fn != "normal":
        raise NotImplementedError(f"init_fn={cfg.init_fn!r}: only 'normal' "
                                  "is ported")
    dev = torch.device(device) if device is not None else generator.device
    d, h = cfg.d_model, cfg.hidden_size
    kvd = cfg.effective_n_kv_heads * cfg.head_dim
    L = cfg.n_layers
    pd = cfg.param_dtype
    resid_div = math.sqrt(2 * L)

    def nrm(shape, role: str = "in"):
        w = torch.empty(shape, dtype=pd, device=dev)
        cut = cfg.init_cutoff_factor
        if cut is None:
            w.normal_(0.0, cfg.init_std, generator=generator)
        else:
            torch.nn.init.trunc_normal_(w, 0.0, cfg.init_std,
                                        -cut * cfg.init_std,
                                        cut * cfg.init_std,
                                        generator=generator)
        if role == "out_resid":
            w.div_(resid_div)
        return w

    def ones(*shape):
        return torch.ones(shape, dtype=pd, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=pd, device=dev)

    if cfg.block_type == "llama":
        blocks = {
            "attn_norm": ones(L, d),
            "ff_norm": ones(L, d),
            "q_proj": nrm((L, d, d)),
            "k_proj": nrm((L, d, kvd)),
            "v_proj": nrm((L, d, kvd)),
            "attn_out": nrm((L, d, d), "out_attn"),
            "ff_proj": nrm((L, d, h)),
            "up_proj": nrm((L, d, h)),
            "ff_out": nrm((L, h, d), "out_resid"),
        }
        if cfg.include_qkv_bias:
            blocks.update(q_bias=zeros(L, d), k_bias=zeros(L, kvd),
                          v_bias=zeros(L, kvd))
    elif cfg.block_type == "sequential":
        ff_out_in = int(cfg.act_output_multiplier * h)
        blocks = {
            "attn_norm": ones(L, d),
            "ff_norm": ones(L, d),
            "att_proj": nrm((L, d, d + 2 * kvd)),
            "attn_out": nrm((L, d, d), "out_attn"),
            "ff_proj": nrm((L, d, h)),
            "ff_out": nrm((L, ff_out_in, d), "out_resid"),
        }
        if cfg.include_qkv_bias:
            blocks["att_proj_bias"] = zeros(L, d + 2 * kvd)
    else:
        raise ValueError(f"unknown block_type: {cfg.block_type}")

    params: Dict[str, Any] = {"wte": nrm((cfg.emb_size, d), "emb"),
                              "ln_f": ones(d), "blocks": blocks}
    if not cfg.weight_tying:
        params["head"] = nrm((d, cfg.emb_size), "final")
    return params


def count_params(params) -> int:
    """Number of elements in a (nested dict/list) parameter tree."""
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(p) for p in params)
    return params.numel()


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
              gemma: bool = False) -> torch.Tensor:
    """RMSNorm with fp32 statistics."""
    og = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    x = (xf * torch.rsqrt(var + eps)).to(og)
    if gemma:
        return x * (1 + weight).to(og)
    return x * weight.to(og)


def _layer_norm(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """Plain LayerNorm without bias; fp32 statistics."""
    og = x.dtype
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(og) * weight.to(og)


def _norm(x: torch.Tensor, weight: torch.Tensor,
          cfg: LLaDAConfig) -> torch.Tensor:
    if cfg.layer_norm_type == "default":
        return _layer_norm(x, weight)
    return _rms_norm(x, weight, cfg.rms_norm_eps,
                     cfg.layer_norm_type == "gemma_rms")


def _rope_sin_cos(seq_len: int, head_dim: int, theta: float,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neox RoPE tables ``[L, head_dim]`` in fp32 (``cat(freqs, freqs)``)."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                                / head_dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, torch.from_numpy(inv_freq).to(device))
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.sin(emb), torch.cos(emb)


def _activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="none")
    if kind == "relu":
        return F.relu(x)
    if kind == "swiglu":
        a, gate = x.chunk(2, dim=-1)
        return F.silu(gate) * a
    raise ValueError(f"unknown activation: {kind}")


def _pmm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """Param matmul ``x @ w`` in x's dtype: dense, or W8A8 int8 when ``w``
    is a quantized-weight dict (:mod:`mmada_parallel_torch.ops.quant`)."""
    if isinstance(w, dict):
        return int8_matmul(x, w["w_q"], w["scale"])
    return x @ w.to(x.dtype)


def _layer(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s weights from the stacked blocks (a quantized leaf's
    ``w_q`` and ``scale`` sliced alike)."""
    return {name: ({k: t[i] for k, t in p.items()} if isinstance(p, dict)
                   else p[i]) for name, p in blocks.items()}


def _block(x: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: LLaDAConfig,
           sin: torch.Tensor, cos: torch.Tensor,
           attn_bias: Optional[torch.Tensor]) -> torch.Tensor:
    """One transformer block: ``llama`` (separate q/k/v, gated MLP) or
    ``sequential`` (fused ``att_proj``, plain or SwiGLU MLP)."""
    B, L, D = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.effective_n_kv_heads, cfg.head_dim
    cdt = x.dtype

    h = _norm(x, lp["attn_norm"], cfg)
    if cfg.block_type == "sequential":
        qkv = _pmm(h, lp["att_proj"])
        if "att_proj_bias" in lp:
            qkv = qkv + lp["att_proj_bias"].to(cdt)
        kvd = nkv * hd
        q, k, v = (t.contiguous()
                   for t in qkv.split([D, kvd, kvd], dim=-1))
    else:
        q = _pmm(h, lp["q_proj"])
        k = _pmm(h, lp["k_proj"])
        v = _pmm(h, lp["v_proj"])
        if "q_bias" in lp:
            q = q + lp["q_bias"].to(cdt)
            k = k + lp["k_bias"].to(cdt)
            v = v + lp["v_bias"].to(cdt)

    att = rope_attention(q, k, v, sin, cos, bias=attn_bias,
                         n_heads=nh, n_kv_heads=nkv,
                         full_precision=cfg.rope_full_precision,
                         impl=cfg.attention_impl)
    x = x + _pmm(att, lp["attn_out"])

    h = _norm(x, lp["ff_norm"], cfg)
    if cfg.block_type == "sequential":
        act = _activation(_pmm(h, lp["ff_proj"]), cfg.activation_type)
        return x + _pmm(act, lp["ff_out"])
    gate = F.silu(_pmm(h, lp["ff_proj"]))
    up = _pmm(h, lp["up_proj"])
    return x + _pmm(gate * up, lp["ff_out"])


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def llada_hidden(params: Dict[str, Any], cfg: LLaDAConfig,
                 input_ids: torch.Tensor,
                 attn_mask: Optional[torch.Tensor] = None,
                 position_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Backbone only: ``[B, L]`` ids -> ``[B, L, d_model]`` hidden states
    after ``ln_f``.

    ``attn_mask``: optional ``[B, L]`` bool padding mask (True = real),
    folded into a pairwise f32 0 / -1e30 bias.  ``position_ids``: optional
    ``[B, L]`` per-row RoPE positions.  Out-of-range ids are clamped into the
    embedding, as the JAX ``mode="clip"`` gather does.

    ``cfg.remat``: ``whole_layer`` recomputes each layer in backward;
    ``one_in_{two,three,four}`` checkpoints only every k-th layer boundary
    (groups of k layers recompute together) and needs ``n_layers``
    divisible by k."""
    group = _REMAT_GROUPS.get(cfg.remat)
    if group is None:
        raise ValueError(f"unknown remat strategy: {cfg.remat}")
    if group > 1 and cfg.n_layers % group != 0:
        raise ValueError(
            f"remat={cfg.remat!r} needs n_layers divisible by {group} "
            f"(got {cfg.n_layers}); use 'whole_layer' instead")
    cdt = cfg.compute_dtype
    B, L = input_ids.shape
    wte = params["wte"]
    ids = input_ids.long().clamp(0, wte.shape[0] - 1)
    x = F.embedding(ids, wte).to(cdt)
    if cfg.input_emb_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)

    sin, cos = _rope_sin_cos(L, cfg.head_dim, cfg.rope_theta, x.device)
    if position_ids is not None:
        pos = position_ids.long()
        sin, cos = sin[pos], cos[pos]                # [B, L, hd]

    attn_bias = None
    if attn_mask is not None:
        attn_bias = to_bias(pairwise_padding_mask(attn_mask))

    blocks = params["blocks"]

    def layers(x, start: int, stop: int):
        for i in range(start, stop):
            x = _block(x, _layer(blocks, i), cfg, sin, cos, attn_bias)
        return x

    step = max(group, 1)
    for start in range(0, cfg.n_layers, step):
        stop = start + step
        if group == 0:
            x = layers(x, start, stop)
        else:
            x = checkpoint(layers, x, start, stop, use_reentrant=False)
    return _norm(x, params["ln_f"], cfg)


# layers per checkpointed group (0: no checkpointing), as in the JAX package
_REMAT_GROUPS = {"none": 0, "whole_layer": 1, "one_in_two": 2,
                 "one_in_three": 3, "one_in_four": 4}


class _Bf16Head(torch.autograd.Function):
    """``hidden @ head`` on the tensor cores: bf16 operands, f32 result
    (``aten::mm.dtype``, the JAX einsum's ``preferred_element_type``).
    That overload has no derivative, so the backward forms both products
    the same way, from the f32 output gradient rounded to bf16; the head's
    gradient comes back in the head's own dtype."""

    @staticmethod
    def forward(ctx, hidden, head):
        ctx.save_for_backward(hidden, head)
        h2 = hidden.reshape(-1, hidden.shape[-1])
        out = torch.mm(h2, head.to(hidden.dtype), out_dtype=torch.float32)
        return out.reshape(*hidden.shape[:-1], head.shape[1])

    @staticmethod
    def backward(ctx, g):
        hidden, head = ctx.saved_tensors
        h2 = hidden.reshape(-1, hidden.shape[-1])
        g2 = g.reshape(-1, g.shape[-1]).to(hidden.dtype)
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = torch.mm(g2, head.to(hidden.dtype).T,
                          out_dtype=torch.float32).to(hidden.dtype)
            dh = dh.reshape(hidden.shape)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(h2.T, g2, out_dtype=torch.float32).to(head.dtype)
        return dh, dw


def llada_head(params: Dict[str, Any], cfg: LLaDAConfig,
               hidden: torch.Tensor,
               vocab_slice: Optional[Tuple[int, int]] = None,
               logits_dtype=torch.float32) -> torch.Tensor:
    """Vocab projection ``[..., d_model] -> [..., V]``; ``vocab_slice=
    (start, size)`` projects onto that slice of the vocab only.  The product
    accumulates in ``logits_dtype`` (the JAX ``preferred_element_type``).
    A bf16 ``hidden`` on CUDA with f32 logits takes the tensor cores with
    bf16 operands and an f32 result (:class:`_Bf16Head`); anywhere else both
    operands are upcast, which forms the same products (exact for bf16
    values) in f32.  A W8A8 head (a quantized-weight dict) takes the int8
    product, with ``vocab_slice`` slicing its ``w_q`` and ``scale`` columns
    alike, rescaled straight into ``logits_dtype``."""
    head = params["wte"].T if cfg.weight_tying else params["head"]

    def cols(w):
        if vocab_slice is None:
            return w
        start, size = vocab_slice
        return w[:, start:start + size]

    if isinstance(head, dict):
        logits = int8_matmul(hidden, cols(head["w_q"]), cols(head["scale"]),
                             out_dtype=logits_dtype)
    elif (hidden.is_cuda and hidden.dtype == torch.bfloat16
          and logits_dtype == torch.float32):
        logits = _Bf16Head.apply(hidden, cols(head))
    else:
        logits = (hidden.to(logits_dtype)
                  @ cols(head).to(hidden.dtype).to(logits_dtype))
    if cfg.scale_logits:
        logits = logits * (1.0 / math.sqrt(cfg.d_model))
    return logits.to(logits_dtype)


def llada_forward(params: Dict[str, Any], cfg: LLaDAConfig,
                  input_ids: torch.Tensor,
                  attn_mask: Optional[torch.Tensor] = None,
                  logits_dtype=torch.float32) -> torch.Tensor:
    """Full-sequence forward: ``[B, L]`` ids -> ``[B, L, emb_size]`` logits."""
    hidden = llada_hidden(params, cfg, input_ids, attn_mask)
    return llada_head(params, cfg, hidden, logits_dtype=logits_dtype)


# ---------------------------------------------------------------------------
# Feature-cached forwards (the samplers' opt-in use_cache path)
# ---------------------------------------------------------------------------


def _rope_packed(t: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
                 n_heads: int, full_precision: bool) -> torch.Tensor:
    """Neox rotation on a packed ``[B, L, H*hd]`` tensor through a 4-D view
    of :func:`~mmada_parallel_torch.ops.rope_attention.rope_tensor`."""
    B, L, HD = t.shape
    t4 = t.reshape(B, L, n_heads, HD // n_heads)
    return rope_tensor(t4, sin, cos, full_precision).reshape(B, L, HD)


def _cached_block(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                  cfg: LLaDAConfig, attend) -> torch.Tensor:
    """A llama block whose attention is ``attend(q, k, v) -> att``: the
    caller rotates k, updates its cache and runs the q-only attention."""
    h = _norm(x, lp["attn_norm"], cfg)
    att = attend(_pmm(h, lp["q_proj"]), _pmm(h, lp["k_proj"]),
                 _pmm(h, lp["v_proj"]))
    x = x + _pmm(att, lp["attn_out"])
    h = _norm(x, lp["ff_norm"], cfg)
    gate = F.silu(_pmm(h, lp["ff_proj"]))
    return x + _pmm(gate * _pmm(h, lp["up_proj"]), lp["ff_out"])


def llada_hidden_with_cache(params: Dict[str, Any], cfg: LLaDAConfig,
                            input_ids: torch.Tensor
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full forward that also returns the per-layer k/v feature cache
    ``{"k": [n_layers, B, L, KV*hd], "v": ...}`` in the packed layout, k
    stored POST-RoPE (rounded to the compute dtype), so partial steps rotate
    only the recomputed positions.  Attention is the q-only path against the
    layer's own rotated k."""
    if cfg.block_type != "llama":
        raise NotImplementedError("feature cache supports llama blocks only")
    cdt = cfg.compute_dtype
    B, L = input_ids.shape
    nh, nkv = cfg.n_heads, cfg.effective_n_kv_heads
    wte = params["wte"]
    x = F.embedding(input_ids.long().clamp(0, wte.shape[0] - 1), wte).to(cdt)
    sin, cos = _rope_sin_cos(L, cfg.head_dim, cfg.rope_theta, x.device)
    shape = (cfg.n_layers, B, L, nkv * cfg.head_dim)
    cache = {"k": torch.empty(shape, dtype=cdt, device=x.device),
             "v": torch.empty(shape, dtype=cdt, device=x.device)}

    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        def attend(q, k, v, i=i):
            cache["k"][i] = _rope_packed(k, sin, cos, nkv,
                                         cfg.rope_full_precision)
            cache["v"][i] = v
            return rope_attention_qonly(
                q, cache["k"][i], cache["v"][i], sin, cos, n_heads=nh,
                n_kv_heads=nkv, full_precision=cfg.rope_full_precision,
                impl=cfg.attention_impl)
        x = _cached_block(x, _layer(blocks, i), cfg, attend)
    return _norm(x, params["ln_f"], cfg), cache


def llada_hidden_partial(params: Dict[str, Any], cfg: LLaDAConfig,
                         sel_ids: torch.Tensor, sel_pos: torch.Tensor,
                         cache: Dict[str, torch.Tensor]
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Partial recompute: run only the ``n`` selected tokens (``sel_ids``
    ``[B, n]`` at absolute positions ``sel_pos`` ``[B, n]``) through the
    stack, attending to the full k/v cache with their fresh k/v written in.

    Returns ``(hidden_sel [B, n, d], cache)``.  The cache is updated IN
    PLACE (the JAX function returns a new one; the values are the same):
    each layer scatters the selected rows' rotated k and v into its slice
    before attending.  RoPE uses the true absolute positions."""
    cdt = cfg.compute_dtype
    B, n = sel_ids.shape
    L = cache["k"].shape[2]
    nh, nkv = cfg.n_heads, cfg.effective_n_kv_heads
    wte = params["wte"]
    x = F.embedding(sel_ids.long().clamp(0, wte.shape[0] - 1), wte).to(cdt)
    sin_full, cos_full = _rope_sin_cos(L, cfg.head_dim, cfg.rope_theta,
                                       x.device)
    pos = sel_pos.long()
    sin_sel, cos_sel = sin_full[pos], cos_full[pos]        # [B, n, hd]
    idx = pos[:, :, None].expand(B, n, cache["k"].shape[-1])

    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        def attend(q, k, v, i=i):
            k_full, v_full = cache["k"][i], cache["v"][i]
            k_full.scatter_(1, idx, _rope_packed(
                k, sin_sel, cos_sel, nkv, cfg.rope_full_precision))
            v_full.scatter_(1, idx, v)
            return rope_attention_qonly(
                q, k_full, v_full, sin_sel, cos_sel, n_heads=nh,
                n_kv_heads=nkv, full_precision=cfg.rope_full_precision,
                impl=cfg.attention_impl)
        x = _cached_block(x, _layer(blocks, i), cfg, attend)
    return _norm(x, params["ln_f"], cfg), cache
