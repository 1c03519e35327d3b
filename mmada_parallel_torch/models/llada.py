"""LLaDA masked-diffusion transformer backbone in PyTorch.

Counterpart of :mod:`mmada_parallel_tpu.models.llada`: bidirectional
attention, GQA, Neox RoPE, RMSNorm, SwiGLU-gated MLP, united text+image vocab
head.  Beyond the JAX package, the same block also runs SDAR-30B-A3B
(:meth:`LLaDAConfig.sdar_30b_a3b`, Qwen3-MoE's block): a head size apart
from ``d_model / n_heads``, a per-head q/k RMSNorm before RoPE, a mixture
of experts in place of the MLP (:mod:`mmada_parallel_torch.ops.moe`), and
block-causal attention (a row sees the keys up to its block's end: K4's
per-row bounds in a full forward, a bias on the cache in a partial one).
Parameters are a plain dict whose names and shapes map 1:1 to the JAX
pytree: per-layer weights stack on a leading ``[n_layers, ...]`` axis and
linear weights keep the ``[d_in, d_out]`` layout, applied as ``x @ w``.  The
layer stack is a Python loop over that axis (the JAX ``lax.scan``).

The forwards are differentiable: f32 parameters are cast to
``compute_dtype`` inside them, so their gradients come back in f32, and
``remat`` checkpoints layers (``torch.utils.checkpoint``) as the JAX
``jax.checkpoint`` strategies do.  The inference pipelines run them under
``torch.inference_mode()``; nothing here turns grad off.

One block (:func:`_block`) runs the three forwards, :func:`llada_hidden`
and the feature-cached :func:`llada_hidden_with_cache` and
:func:`llada_hidden_partial`; each forward hands it only its attention.
That goes through :func:`mmada_parallel_torch.ops.attention.rope_attention`
(and, for the feature-cached forwards, ``rope_attention_qonly``), which
launch the fused-RoPE CUDA kernels for CUDA tensors; RMSNorm, where autograd
records nothing, through :func:`mmada_parallel_torch.ops.rms_norm.rms_norm`
(one CUDA launch a norm).  A linear weight may be
a W8A8 dict (:func:`mmada_parallel_torch.ops.quant.quantize_llada_params`):
the block GEMMs and the head then take the int8 product.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from mmada_parallel_torch.ops.attention import (_prefix_dense_bias,
                                                 rope_attention,
                                                 rope_attention_prefix,
                                                 rope_attention_qonly)
from mmada_parallel_torch.ops.masks import pairwise_padding_mask, to_bias
from mmada_parallel_torch.ops.moe import moe_mlp
from mmada_parallel_torch.ops.quant import int8_matmul
from mmada_parallel_torch.ops.rms_norm import rms_norm, rms_norm_reference
from mmada_parallel_torch.ops.rope_attention import rope_tensor

__all__ = ["LLaDAConfig", "init_llada_params", "llada_hidden", "llada_head",
           "llada_forward", "llada_hidden_with_cache", "llada_hidden_partial",
           "block_causal_bounds", "count_params", "param_shardings"]

ATTENTION_MODES = ("bidirectional", "block_causal")


@dataclasses.dataclass(frozen=True)
class LLaDAConfig:
    """Architecture hyperparameters; fields and defaults as the JAX
    ``LLaDAConfig``, with ``torch.dtype`` execution dtypes, and the fields
    the JAX package lacks: ``head_dim`` (``None``: ``d_model // n_heads``,
    filled in at construction), the mixture of experts (``n_experts > 0``
    replaces every layer's MLP), and ``attention``."""

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
    attention_layer_norm: bool = False        # per-head q/k RMSNorm
    init_fn: str = "normal"
    init_std: float = 0.02
    init_cutoff_factor: Optional[float] = None
    mask_token_id: int = 126336
    eos_token_id: int = 126081
    pad_token_id: int = 126081
    head_dim: Optional[int] = None            # None -> d_model // n_heads
    n_experts: int = 0                        # 0: the dense MLP
    experts_per_token: int = 0
    moe_hidden_size: int = 0                  # each expert's SwiGLU width
    norm_topk_prob: bool = True               # renormalise the top-k to 1
    attention: str = "bidirectional"          # | "block_causal"
    block_length: int = 0                     # block_causal's block
    # --- execution policy (not part of the checkpoint contract) ---
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "none"                       # "none" | "whole_layer" | "one_in_{two,three,four}"
    attention_impl: str = "auto"              # "auto" | "xla" | "pallas"

    @property
    def effective_n_kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    def __post_init__(self):
        if self.head_dim is None and self.d_model % self.n_heads == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.n_heads)

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
        if self.head_dim is None:
            raise ValueError("d_model must be a multiple of n_heads where "
                             "head_dim is not given")
        if self.n_heads % self.effective_n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        if self.attention not in ATTENTION_MODES:
            raise ValueError(f"attention must be one of {ATTENTION_MODES}")
        if self.attention == "block_causal" and self.block_length < 1:
            raise ValueError("block_causal attention needs block_length")
        if self.n_experts and not (
                0 < self.experts_per_token <= self.n_experts
                and self.moe_hidden_size > 0):
            raise ValueError("a mixture of experts needs 0 < "
                             "experts_per_token <= n_experts and "
                             "moe_hidden_size")
        if (self.n_experts or self.head_dim * self.n_heads != self.d_model
                or self.attention_layer_norm) and \
                self.block_type != "llama":
            raise ValueError("experts, q/k norms and a head size apart "
                             "from d_model / n_heads need llama blocks")

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

    @classmethod
    def sdar_30b_a3b(cls, **overrides) -> "LLaDAConfig":
        """SDAR-30B-A3B (huggingface.co/JetLM/SDAR-30B-A3B-Chat, Qwen3-MoE's
        block): d_model 2048, 48 layers, 32 query heads over 4 kv heads of
        128 with per-head q/k RMSNorm, 128 experts of width 768 in every
        layer, top-8 renormalised, untied vocab 151936, RoPE 1e6, eps 1e-6,
        block-causal.  The config does not give the block length (4 here)
        or the mask id (151669, the first id past the tokenizer's, a
        reserved row of the embedding)."""
        base = dict(d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
                    n_layers=48, mlp_hidden_size=6144, vocab_size=151936,
                    rope_theta=1000000.0, rms_norm_eps=1e-6,
                    max_sequence_length=32768, attention_layer_norm=True,
                    n_experts=128, experts_per_token=8, moe_hidden_size=768,
                    norm_topk_prob=True, attention="block_causal",
                    block_length=4, mask_token_id=151669,
                    eos_token_id=151645, pad_token_id=151643)
        base.update(overrides)
        return cls(**base)


def block_causal_bounds(L: int, start: int, block_length: int,
                        device=None) -> torch.Tensor:
    """``[L]`` int32 key bounds of block-causal attention: position ``q``
    sees the keys before its block's end.  Blocks of ``block_length`` are
    aligned at ``start`` (the answer's first position), so the prompt's
    first block is the short one, as if the prompt were left-padded to a
    multiple of ``block_length`` with pads nobody attends to."""
    q = torch.arange(L, device=device)
    hi = start + torch.div(q - start, block_length,
                           rounding_mode="floor") * block_length
    return (hi + block_length).clamp(max=L).int()


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
    qd = cfg.n_heads * cfg.head_dim
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
            "q_proj": nrm((L, d, qd)),
            "k_proj": nrm((L, d, kvd)),
            "v_proj": nrm((L, d, kvd)),
            "attn_out": nrm((L, qd, d), "out_attn"),
        }
        if cfg.n_experts:
            E, m = cfg.n_experts, cfg.moe_hidden_size
            blocks.update(router=nrm((L, d, E)),
                          expert_gate=nrm((L, E, d, m)),
                          expert_up=nrm((L, E, d, m)),
                          expert_down=nrm((L, E, m, d), "out_resid"))
        else:
            blocks.update(ff_proj=nrm((L, d, h)), up_proj=nrm((L, d, h)),
                          ff_out=nrm((L, h, d), "out_resid"))
        if cfg.attention_layer_norm:
            blocks.update(q_norm=ones(L, cfg.head_dim),
                          k_norm=ones(L, cfg.head_dim))
        if cfg.include_qkv_bias:
            blocks.update(q_bias=zeros(L, qd), k_bias=zeros(L, kvd),
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
    """RMSNorm with fp32 statistics: where autograd records (``x`` or the
    weight requires grad), and for the gemma variant, the plain chain;
    everywhere else :func:`~mmada_parallel_torch.ops.rms_norm.rms_norm`,
    the hand-written kernel on a card."""
    if gemma:
        return rms_norm_reference(x, 1 + weight, eps)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return rms_norm_reference(x, weight, eps)
    return rms_norm(x, weight, eps)


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


def _qk_norm(q: torch.Tensor, k: torch.Tensor, lp: Dict[str, Any],
             cfg: LLaDAConfig, nh: int, nkv: int):
    """Packed ``q [..., nh*hd]`` and ``k [..., nkv*hd]`` each through the
    per-head RMSNorm over ``hd`` (``lp["q_norm"]``, ``lp["k_norm"]``),
    f32 statistics, as Qwen3's attention applies it before RoPE."""
    hd = cfg.head_dim
    qn = _rms_norm(q.unflatten(-1, (nh, hd)), lp["q_norm"], cfg.rms_norm_eps)
    kn = _rms_norm(k.unflatten(-1, (nkv, hd)), lp["k_norm"], cfg.rms_norm_eps)
    return qn.flatten(-2), kn.flatten(-2)


def _mlp(h: torch.Tensor, lp: Dict[str, Any], cfg: LLaDAConfig,
         out: Callable) -> torch.Tensor:
    """The llama block's feed-forward branch on the normed ``h``: the
    SwiGLU MLP with its output projection through ``out``, or, where the
    config has experts, :func:`~mmada_parallel_torch.ops.moe.moe_mlp`."""
    if cfg.n_experts:
        return moe_mlp(h, lp["router"], lp["expert_gate"], lp["expert_up"],
                       lp["expert_down"], cfg.experts_per_token,
                       cfg.norm_topk_prob)
    gate = F.silu(_pmm(h, lp["ff_proj"]))
    return out(gate * _pmm(h, lp["up_proj"]), lp["ff_out"])


def _block(x: torch.Tensor, lp: Dict[str, Any], cfg: LLaDAConfig,
           attend: Callable, tp, nh: int, nkv: int) -> torch.Tensor:
    """One transformer block: ``llama`` (separate q/k/v with the biases
    ``lp`` holds, the per-head q/k norm, gated MLP or experts) or
    ``sequential`` (fused ``att_proj``, plain or SwiGLU MLP).
    ``attend(q, k, v) -> att`` is the forward's attention on the packed
    projections, q and k unrotated.  ``tp``: the hook's
    :class:`~mmada_parallel_torch.parallel.tensor.TensorPlan` or None; a half it
    runs split computes this rank's heads or MLP hidden, its input through
    ``tp.copy`` and its output projection row-parallel (``tp.row``).
    ``nh``, ``nkv``: the head counts this rank computes."""
    attn_tp = tp is not None and tp.attn_local
    mlp_tp = tp is not None and tp.mlp_local
    cdt = x.dtype

    h = _norm(x, lp["attn_norm"], cfg)
    if attn_tp:
        h = tp.copy(h)
    if cfg.block_type == "sequential":
        qkv = _pmm(h, lp["att_proj"])
        if "att_proj_bias" in lp:
            qkv = qkv + lp["att_proj_bias"].to(cdt)
        kvd = nkv * cfg.head_dim
        q, k, v = (t.contiguous()
                   for t in qkv.split([x.shape[-1], kvd, kvd], dim=-1))
    else:
        q = _pmm(h, lp["q_proj"])
        k = _pmm(h, lp["k_proj"])
        v = _pmm(h, lp["v_proj"])
        if "q_bias" in lp:
            q = q + lp["q_bias"].to(cdt)
            k = k + lp["k_bias"].to(cdt)
            v = v + lp["v_bias"].to(cdt)
        if cfg.attention_layer_norm:
            q, k = _qk_norm(q, k, lp, cfg, nh, nkv)
    att = attend(q, k, v)
    del q, k, v                         # not held through the MLP
    x = x + (tp.row(att, lp["attn_out"]) if attn_tp
             else _pmm(att, lp["attn_out"]))

    h = _norm(x, lp["ff_norm"], cfg)
    if mlp_tp:
        h = tp.copy(h)
    out = tp.row if mlp_tp else _pmm
    if cfg.block_type == "sequential":
        act = _activation(_pmm(h, lp["ff_proj"]), cfg.activation_type)
        return x + out(act, lp["ff_out"])
    return x + _mlp(h, lp, cfg, out)


def _hook(params: Dict[str, Any], cfg: LLaDAConfig,
          gather: Optional[Callable[[str, Any], Any]]):
    """``gather``, or the mesh hook of parameters that carry their mesh
    (:func:`~mmada_parallel_torch.parallel.mesh.shard_params`).  Without
    either the tree must be whole: a rank's vocab-parallel ``wte`` that
    lost its mesh (a ``dict(...)`` copy) raises here."""
    if gather is not None:
        return gather
    if getattr(params, "mesh", None) is None:
        rows = params["wte"].shape[0]
        if rows != cfg.emb_size:
            raise ValueError(
                f"wte has {rows} rows, the config {cfg.emb_size}: a rank's "
                f"shards passed without their mesh or gather=?")
        return None
    from mmada_parallel_torch.parallel.tensor import MeshGather
    return MeshGather(params.mesh, params.specs, cfg)


class _Stack:
    """What the three forwards share: the parameter hook (:func:`_hook`)
    and its ``tp``, the head counts this rank computes (``nh``, ``nkv``),
    the embedding (:meth:`embed`), the layers (:meth:`run`) and ``ln_f``
    (:meth:`final`).  ``drop``: weights each layer leaves out."""

    def __init__(self, params: Dict[str, Any], cfg: LLaDAConfig, gather,
                 drop: Tuple[str, ...] = ()):
        self.params, self.cfg, self.drop = params, cfg, drop
        self.gather = _hook(params, cfg, gather)
        self.tp = tp = getattr(self.gather, "tp", None)
        self.nh, self.nkv = ((cfg.n_heads, cfg.effective_n_kv_heads)
                             if tp is None else (tp.n_heads, tp.n_kv_heads))

    def _fetch(self, name: str, p: Any) -> Any:
        return p if self.gather is None else self.gather(name, p)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The embedding of ``ids`` in the compute dtype, out-of-range ids
        clamped into the global vocab as JAX's ``mode="clip"`` gather does;
        vocab-parallel where the hook has a ``tp``."""
        wte = self._fetch("wte", self.params["wte"])
        x = (self.tp.embed(ids, wte) if self.tp is not None else
             F.embedding(ids.long().clamp(0, wte.shape[0] - 1), wte))
        return x.to(self.cfg.compute_dtype)

    def run(self, x: torch.Tensor, attend: Callable, start: int = 0,
            stop: Optional[int] = None) -> torch.Tensor:
        """Layers ``[start, stop)`` on ``x``, each layer's weights through
        the hook into :func:`_block`; ``attend(i, q, k, v)`` is layer
        ``i``'s attention.  A layer's input is freed when the layer has
        run unless the caller keeps a reference to ``x``."""
        for i in range(start, self.cfg.n_layers if stop is None else stop):
            lp = self._fetch("blocks", _layer(self.params["blocks"], i))
            lp = {k: t for k, t in lp.items() if k not in self.drop}
            x = _block(x, lp, self.cfg, functools.partial(attend, i),
                       self.tp, self.nh, self.nkv)
        return x

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return _norm(x, self._fetch("ln_f", self.params["ln_f"]), self.cfg)


def _bounds(cfg: LLaDAConfig, kv_hi: Optional[torch.Tensor], B: int, L: int,
            device) -> Optional[torch.Tensor]:
    """``kv_hi`` as ``[B, L]``; a ``block_causal`` config without them
    takes :func:`block_causal_bounds` aligned at position 0."""
    if kv_hi is None and cfg.attention == "block_causal":
        kv_hi = block_causal_bounds(L, 0, cfg.block_length, device)
    return None if kv_hi is None else kv_hi.expand(B, L)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def llada_hidden(params: Dict[str, Any], cfg: LLaDAConfig,
                 input_ids: torch.Tensor,
                 attn_mask: Optional[torch.Tensor] = None,
                 position_ids: Optional[torch.Tensor] = None,
                 gather: Optional[Callable[[str, Any], Any]] = None,
                 kv_hi: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Backbone only: ``[B, L]`` ids -> ``[B, L, d_model]`` hidden states
    after ``ln_f``.

    ``kv_hi``: optional ``[B, L]`` (or ``[L]``) per-row key bounds (row
    ``q`` sees keys ``< kv_hi[q]``), in place of ``attn_mask``, through
    :func:`~mmada_parallel_torch.ops.attention.rope_attention_prefix` (K4
    on the card from 4096 positions); a ``block_causal`` config without
    them takes :func:`block_causal_bounds` aligned at position 0.

    ``attn_mask``: optional ``[B, L]`` bool padding mask (True = real),
    folded into a pairwise f32 0 / -1e30 bias.  ``position_ids``: optional
    ``[B, L]`` per-row RoPE positions.  Out-of-range ids are clamped into the
    embedding, as the JAX ``mode="clip"`` gather does.

    ``cfg.remat``: ``whole_layer`` recomputes each layer in backward;
    ``one_in_{two,three,four}`` checkpoints only every k-th layer boundary
    (groups of k layers recompute together) and needs ``n_layers``
    divisible by k.

    ``gather(name, x)``, where given, turns this rank's shards into the
    parameters it computes with (:class:`~mmada_parallel_torch.parallel.
    tensor.MeshGather`): ``wte`` and ``ln_f`` once a forward, each layer's
    dict (``name="blocks"``) where the layer runs, so a remat recompute
    gathers again; its ``tp`` runs the Megatron split over ``tensor``.
    Without it, parameters from ``shard_params`` bring their own."""
    group = _REMAT_GROUPS.get(cfg.remat)
    if group is None:
        raise ValueError(f"unknown remat strategy: {cfg.remat}")
    if group > 1 and cfg.n_layers % group != 0:
        raise ValueError(
            f"remat={cfg.remat!r} needs n_layers divisible by {group} "
            f"(got {cfg.n_layers}); use 'whole_layer' instead")
    cdt = cfg.compute_dtype
    B, L = input_ids.shape
    s = _Stack(params, cfg, gather)
    x = s.embed(input_ids)
    if cfg.input_emb_norm:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)

    sin, cos = _rope_sin_cos(L, cfg.head_dim, cfg.rope_theta, x.device)
    if position_ids is not None:
        pos = position_ids.long()
        sin, cos = sin[pos], cos[pos]                # [B, L, hd]

    attn_bias = None
    if attn_mask is not None:
        attn_bias = to_bias(pairwise_padding_mask(attn_mask))
    kv_hi = _bounds(cfg, kv_hi, B, L, x.device)
    if kv_hi is not None and attn_bias is not None:
        raise ValueError("kv_hi and attn_mask do not combine")

    def attend(i, q, k, v):
        if kv_hi is not None:
            return rope_attention_prefix(
                q, k, v, sin, cos, kv_hi, n_heads=s.nh, n_kv_heads=s.nkv,
                full_precision=cfg.rope_full_precision,
                impl=cfg.attention_impl)
        return rope_attention(q, k, v, sin, cos, bias=attn_bias,
                              n_heads=s.nh, n_kv_heads=s.nkv,
                              full_precision=cfg.rope_full_precision,
                              impl=cfg.attention_impl)

    run = (s.run if group == 0 else
           functools.partial(checkpoint, s.run, use_reentrant=False))
    step = max(group, 1)
    for start in range(0, cfg.n_layers, step):   # x rebound: the embedding
        x = run(x, attend, start, start + step)  # is freed after the first
    return s.final(x)


# layers per checkpointed group (0: no checkpointing), as in the JAX package
_REMAT_GROUPS = {"none": 0, "whole_layer": 1, "one_in_two": 2,
                 "one_in_three": 3, "one_in_four": 4}


class _Bf16Head(torch.autograd.Function):
    """``hidden @ head`` on the tensor cores: bf16 operands, f32 result
    (``aten::mm.dtype``, the JAX einsum's ``preferred_element_type``).
    That overload has no derivative, so the backward forms both products
    the same way, from the f32 output gradient rounded to bf16; each
    gradient comes back in its input's own dtype (an f32 ``hidden`` holding
    bf16 values, as the tensor-parallel head passes it, gets its gradient
    unrounded, to be summed over ``tensor`` before it rounds)."""

    @staticmethod
    def forward(ctx, hidden, head):
        ctx.save_for_backward(hidden, head)
        h2 = hidden.reshape(-1, hidden.shape[-1]).to(torch.bfloat16)
        out = torch.mm(h2, head.to(torch.bfloat16), out_dtype=torch.float32)
        return out.reshape(*hidden.shape[:-1], head.shape[1])

    @staticmethod
    def backward(ctx, g):
        hidden, head = ctx.saved_tensors
        h2 = hidden.reshape(-1, hidden.shape[-1]).to(torch.bfloat16)
        g2 = g.reshape(-1, g.shape[-1]).to(torch.bfloat16)
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = torch.mm(g2, head.to(torch.bfloat16).T,
                          out_dtype=torch.float32).to(hidden.dtype)
            dh = dh.reshape(hidden.shape)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(h2.T, g2, out_dtype=torch.float32).to(head.dtype)
        return dh, dw


def llada_head(params: Dict[str, Any], cfg: LLaDAConfig,
               hidden: torch.Tensor,
               vocab_slice: Optional[Tuple[int, int]] = None,
               logits_dtype=torch.float32,
               gather: Optional[Callable[[str, Any], Any]] = None
               ) -> torch.Tensor:
    """Vocab projection ``[..., d_model] -> [..., V]``; ``vocab_slice=
    (start, size)`` projects onto that slice of the vocab only.  The product
    accumulates in ``logits_dtype`` (the JAX ``preferred_element_type``).
    A bf16 ``hidden`` on CUDA with f32 logits takes the tensor cores with
    bf16 operands and an f32 result (:class:`_Bf16Head`); anywhere else both
    operands are upcast, which forms the same products (exact for bf16
    values) in f32.  A W8A8 head (a quantized-weight dict) takes the int8
    product, with ``vocab_slice`` slicing its ``w_q`` and ``scale`` columns
    alike, rescaled straight into ``logits_dtype``.  ``gather``: as in
    :func:`llada_hidden`, applied to the head once; over ``tensor`` each
    rank projects its vocab blocks (met with ``vocab_slice``) and every
    rank gets the whole logits (:meth:`~mmada_parallel_torch.parallel.
    tensor.TensorPlan.head`)."""
    name = "wte" if cfg.weight_tying else "head"
    gather = _hook(params, cfg, gather)
    head = params[name] if gather is None else gather(name, params[name])
    if cfg.weight_tying:
        head = head.T

    def project(h, w, lo, hi):
        """Logits of head columns ``[lo, hi)`` for ``h``: ``hidden``, or
        its f32 copy (the tensor-parallel head), computed as for
        ``hidden``."""
        if isinstance(w, dict):
            return int8_matmul(h, w["w_q"][:, lo:hi], w["scale"][..., lo:hi],
                               out_dtype=logits_dtype)
        w = w[:, lo:hi]
        if (hidden.is_cuda and hidden.dtype == torch.bfloat16
                and logits_dtype == torch.float32):
            return _Bf16Head.apply(h, w)
        return h.to(logits_dtype) @ w.to(hidden.dtype).to(logits_dtype)

    tp = getattr(gather, "tp", None)
    if tp is not None:
        logits = tp.head(hidden, head, gather.head_blocks(name), vocab_slice,
                         project)
    else:
        width = (head["w_q"] if isinstance(head, dict) else head).shape[-1]
        start, size = vocab_slice if vocab_slice is not None else (0, width)
        logits = project(hidden, head, start, start + size)
    if cfg.scale_logits:
        logits = logits * (1.0 / math.sqrt(cfg.d_model))
    return logits.to(logits_dtype)


def llada_forward(params: Dict[str, Any], cfg: LLaDAConfig,
                  input_ids: torch.Tensor,
                  attn_mask: Optional[torch.Tensor] = None,
                  logits_dtype=torch.float32,
                  gather: Optional[Callable[[str, Any], Any]] = None
                  ) -> torch.Tensor:
    """Full-sequence forward: ``[B, L]`` ids -> ``[B, L, emb_size]`` logits.
    ``gather``: the parameter hook of :func:`llada_hidden`."""
    gather = _hook(params, cfg, gather)
    hidden = llada_hidden(params, cfg, input_ids, attn_mask, gather=gather)
    return llada_head(params, cfg, hidden, logits_dtype=logits_dtype,
                      gather=gather)


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


def _cached_stack(params: Dict[str, Any], cfg: LLaDAConfig,
                  gather) -> _Stack:
    """The cached forwards' :class:`_Stack`, under JAX's contract for them:
    llama blocks only, no ``input_emb_norm`` and no q/k/v biases (left out
    of each layer's weights)."""
    if cfg.block_type != "llama":
        raise NotImplementedError("feature cache supports llama blocks only")
    return _Stack(params, cfg, gather, drop=("q_bias", "k_bias", "v_bias"))


def llada_hidden_with_cache(params: Dict[str, Any], cfg: LLaDAConfig,
                            input_ids: torch.Tensor,
                            gather: Optional[Callable[[str, Any], Any]] = None,
                            kv_hi: Optional[torch.Tensor] = None,
                            cache_len: Optional[int] = None,
                            out: Optional[Dict[str, torch.Tensor]] = None
                            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full forward that also returns the per-layer k/v feature cache
    ``{"k": [n_layers, B, L, KV*hd], "v": ...}`` in the packed layout, k
    stored POST-RoPE (rounded to the compute dtype), so partial steps rotate
    only the recomputed positions.  Attention is the q-only path against the
    layer's own rotated k.  ``gather`` as in :func:`llada_hidden`; over
    ``tensor`` the cache holds this rank's ``KV/g`` heads.

    ``kv_hi`` (``[B, L]`` or ``[L]`` key bounds; a ``block_causal`` config
    without them takes :func:`block_causal_bounds` aligned at 0): the
    attention is :func:`~mmada_parallel_torch.ops.attention.
    rope_attention_prefix` on the unrotated k (K4 on the card from 4096
    positions), the cache still gets the rotated k.  ``cache_len`` (at
    least L) sizes the cache for the positions partial forwards will
    write; the rows past ``L`` start at zero.  ``out``: a cache of that
    shape to write into in place of a new one (its rows past ``L`` keep
    what they hold)."""
    cdt = cfg.compute_dtype
    B, L = input_ids.shape
    s = _cached_stack(params, cfg, gather)
    dev = input_ids.device
    sin, cos = _rope_sin_cos(L, cfg.head_dim, cfg.rope_theta, dev)
    kv_hi = _bounds(cfg, kv_hi, B, L, dev)
    Lc = L if cache_len is None else cache_len
    if Lc < L:
        raise ValueError(f"cache_len {Lc} is shorter than the ids' {L}")
    shape = (cfg.n_layers, B, Lc, s.nkv * cfg.head_dim)
    if out is not None:
        if any(out[n].shape != shape or out[n].dtype != cdt
               for n in ("k", "v")):
            raise ValueError(f"out must hold k and v of {list(shape)} {cdt}")
        cache = out
    else:
        alloc = torch.empty if Lc == L else torch.zeros
        cache = {"k": alloc(shape, dtype=cdt, device=dev),
                 "v": alloc(shape, dtype=cdt, device=dev)}

    def attend(i, q, k, v):
        cache["k"][i, :, :L] = _rope_packed(k, sin, cos, s.nkv,
                                            cfg.rope_full_precision)
        cache["v"][i, :, :L] = v
        if kv_hi is not None:
            return rope_attention_prefix(
                q, k, v, sin, cos, kv_hi, n_heads=s.nh, n_kv_heads=s.nkv,
                full_precision=cfg.rope_full_precision,
                impl=cfg.attention_impl)
        return rope_attention_qonly(
            q, cache["k"][i], cache["v"][i], sin, cos, n_heads=s.nh,
            n_kv_heads=s.nkv, full_precision=cfg.rope_full_precision,
            impl=cfg.attention_impl)

    return s.final(s.run(s.embed(input_ids), attend)), cache


def _cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     sin: torch.Tensor, cos: torch.Tensor,
                     bias: Optional[torch.Tensor], nh: int, nkv: int,
                     cfg: LLaDAConfig, fold: bool) -> torch.Tensor:
    """The selected rows' q-only attention against the whole cache
    (:func:`~mmada_parallel_torch.ops.attention.rope_attention_qonly`).
    ``fold`` (GQA, ``G = nh / nkv > 1``): the ``G`` query heads that share a
    kv head become ``G`` rows of one head, ``[B, n*G, nkv*hd]`` with the
    tables and the bias repeated alike, so K2 reads each kv head's cache
    once for ``n*G`` rows rather than ``G`` times for ``n`` (a 64-row tile
    for 4 rows at SDAR's 8:1); the result is the same function."""
    G = nh // nkv
    if not fold or G == 1:
        return rope_attention_qonly(
            q, k, v, sin, cos, bias, n_heads=nh, n_kv_heads=nkv,
            full_precision=cfg.rope_full_precision, impl=cfg.attention_impl)
    B, n, _ = q.shape
    hd = cfg.head_dim
    qg = q.view(B, n, nkv, G, hd).transpose(2, 3).reshape(B, n * G,
                                                           nkv * hd)
    row = sin.ndim - 2
    sin, cos = (t.repeat_interleave(G, dim=row) for t in (sin, cos))
    if bias is not None:
        bias = bias.repeat_interleave(G, dim=2)
    out = rope_attention_qonly(
        qg, k, v, sin, cos, bias, n_heads=nkv, n_kv_heads=nkv,
        full_precision=cfg.rope_full_precision, impl=cfg.attention_impl)
    return out.view(B, n, G, nkv, hd).transpose(2, 3).reshape(B, n, nh * hd)


def llada_hidden_partial(params: Dict[str, Any], cfg: LLaDAConfig,
                         sel_ids: torch.Tensor, sel_pos: torch.Tensor,
                         cache: Dict[str, torch.Tensor],
                         gather: Optional[Callable[[str, Any], Any]] = None,
                         kv_hi: Optional[torch.Tensor] = None,
                         tables: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Partial recompute: run only the ``n`` selected tokens (``sel_ids``
    ``[B, n]`` at absolute positions ``sel_pos`` ``[B, n]``) through the
    stack, attending to the full k/v cache with their fresh k/v written in.

    Returns ``(hidden_sel [B, n, d], cache)``.  The cache is updated IN
    PLACE (the JAX function returns a new one; the values are the same):
    each layer scatters the selected rows' rotated k and v into its slice
    before attending.  RoPE uses the true absolute positions.  ``gather``
    as in :func:`llada_hidden_with_cache`.  ``kv_hi`` (``[B, n]``): each
    selected row sees the cache's keys before its bound only (a bias built
    once a call), as a block-causal step's rows see up to their block's
    end.  On the card a GQA model's query heads fold into rows of their kv
    head (:func:`_cache_attention`).  ``tables``: the RoPE ``(sin, cos)``
    of the cache's positions, made beforehand (a CUDA graph's capture
    takes no host-to-device copy)."""
    B, n = sel_ids.shape
    L = cache["k"].shape[2]
    s = _cached_stack(params, cfg, gather)
    sin_full, cos_full = (tables if tables is not None else _rope_sin_cos(
        L, cfg.head_dim, cfg.rope_theta, sel_ids.device))
    pos = sel_pos.long()
    sin_sel, cos_sel = sin_full[pos], cos_full[pos]        # [B, n, hd]
    idx = pos[:, :, None].expand(B, n, cache["k"].shape[-1])
    bias = (None if kv_hi is None
            else to_bias(_prefix_dense_bias(kv_hi.expand(B, n), L)))

    def attend(i, q, k, v):
        k_full, v_full = cache["k"][i], cache["v"][i]
        k_full.scatter_(1, idx, _rope_packed(
            k, sin_sel, cos_sel, s.nkv, cfg.rope_full_precision))
        v_full.scatter_(1, idx, v)
        return _cache_attention(q, k_full, v_full, sin_sel, cos_sel, bias,
                                s.nh, s.nkv, cfg, fold=q.is_cuda)

    return s.final(s.run(s.embed(sel_ids), attend)), cache


# ---------------------------------------------------------------------------
# Sharding metadata
# ---------------------------------------------------------------------------


def param_shardings(cfg: LLaDAConfig, fsdp_axis: str = "fsdp",
                    tensor_axis: str = "tensor") -> Dict[str, Any]:
    """Placement tree mirroring :func:`init_llada_params`, one
    :class:`~mmada_parallel_torch.parallel.mesh.PartitionSpec` a leaf, as
    the JAX ``param_shardings``: tensor parallelism splits the attention
    heads and the MLP hidden dimension (Megatron), FSDP the other large
    axis, ``wte`` its vocab over ``tensor``, and the untied head its vocab
    over both axes.  :func:`~mmada_parallel_torch.parallel.mesh.shard_params`
    cuts a tree by it."""
    from mmada_parallel_torch.parallel.mesh import PartitionSpec as P
    if cfg.n_experts or cfg.attention_layer_norm:
        raise NotImplementedError("experts and q/k norms have no placement "
                                  "over a mesh yet")
    fs, tp = fsdp_axis, tensor_axis
    if cfg.block_type == "sequential":
        blocks = {
            "attn_norm": P(None, None),
            "ff_norm": P(None, None),
            "att_proj": P(None, fs, tp),
            "attn_out": P(None, tp, fs),
            "ff_proj": P(None, fs, tp),
            "ff_out": P(None, tp, fs),
        }
        if cfg.include_qkv_bias:
            blocks["att_proj_bias"] = P(None, tp)
    else:
        blocks = {
            "attn_norm": P(None, None),
            "ff_norm": P(None, None),
            "q_proj": P(None, fs, tp),
            "k_proj": P(None, fs, tp),
            "v_proj": P(None, fs, tp),
            "attn_out": P(None, tp, fs),
            "ff_proj": P(None, fs, tp),
            "up_proj": P(None, fs, tp),
            "ff_out": P(None, tp, fs),
        }
        if cfg.include_qkv_bias:
            blocks["q_bias"] = P(None, tp)
            blocks["k_bias"] = P(None, tp)
            blocks["v_bias"] = P(None, tp)
    specs = {"wte": P(tp, fs), "ln_f": P(None), "blocks": blocks}
    if not cfg.weight_tying:
        specs["head"] = P(None, (fs, tp))
    return specs
