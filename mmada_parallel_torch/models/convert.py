"""Checkpoint conversion: HF safetensors <-> the port's params.

Counterpart of :mod:`mmada_parallel_tpu.models.convert`: the LLaDA backbone
(``model.transformer.*``, torch ``Linear`` ``[out, in]`` transposed to
``[in, out]``, per-layer tensors stacked on a leading layer axis), the
Amused-VQ diffusers ``VQModel`` of variant A (conv weights stay OIHW, the
port's conv layout; mid-block attention ``Linear`` layers fold into 1x1
convs; diffusers ``up_blocks`` are listed deepest-first and re-indexed to
the shallow-first levels) and the MagViT-v2 of variant M (taming-style
names, already shallow-first).  The reverse direction writes the LLaDA
backbone back out as an HF checkpoint (``model.safetensors`` and
``config.json``, the JAX package's names, layout and config keys), so a
model fine-tuned with the port leaves it in the released format.
``safetensors`` is imported inside the loader and the writer.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import torch

from mmada_parallel_torch.models.amused_vq import AmusedVQConfig
from mmada_parallel_torch.models.llada import LLaDAConfig
from mmada_parallel_torch.models.magvit2 import MagvitConfig

__all__ = ["load_safetensors_dir", "llada_config_from_hf",
           "llada_params_from_torch", "amused_config_from_hf",
           "amused_params_from_torch", "magvit_params_from_torch",
           "load_llada_checkpoint", "llada_state_dict_from_params",
           "save_llada_checkpoint"]

Tensors = Dict[str, torch.Tensor]


def load_safetensors_dir(path: str, device="cpu") -> Tensors:
    """All ``*.safetensors`` of a checkpoint directory (sharded or one)."""
    from safetensors import safe_open
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no safetensors files under {path}")
    tensors: Tensors = {}
    for f in files:
        with safe_open(os.path.join(path, f), framework="pt",
                       device=str(device)) as sf:
            for k in sf.keys():
                tensors[k] = sf.get_tensor(k)
    return tensors


def _t(w: torch.Tensor) -> torch.Tensor:
    """torch Linear ``[out, in]`` -> ``[in, out]``."""
    return w.T.contiguous()


# ---------------------------------------------------------------------------
# LLaDA
# ---------------------------------------------------------------------------


def llada_config_from_hf(config_json: Dict[str, Any],
                         **overrides) -> LLaDAConfig:
    """:class:`LLaDAConfig` from an HF ``config.json`` dict."""
    c = config_json
    kw = dict(
        d_model=c["d_model"],
        n_heads=c["n_heads"],
        n_kv_heads=c.get("n_kv_heads"),
        n_layers=c["n_layers"],
        mlp_hidden_size=c.get("mlp_hidden_size"),
        mlp_ratio=c.get("mlp_ratio", 4),
        vocab_size=c["vocab_size"],
        embedding_size=c.get("embedding_size"),
        max_sequence_length=c.get("max_sequence_length", 4096),
        rope_theta=c.get("rope_theta", 10000.0),
        rope_full_precision=c.get("rope_full_precision", True),
        rms_norm_eps=c.get("rms_norm_eps", 1e-5),
        layer_norm_type=c.get("layer_norm_type", "rms"),
        include_bias=c.get("include_bias", False),
        include_qkv_bias=c.get("include_qkv_bias", False),
        block_type=c.get("block_type", "llama"),
        activation_type=c.get("activation_type", "silu"),
        weight_tying=c.get("weight_tying", False),
        input_emb_norm=c.get("input_emb_norm", False),
        scale_logits=c.get("scale_logits", False),
        mask_token_id=c.get("mask_token_id", 126336),
        eos_token_id=c.get("eos_token_id", 126081),
        pad_token_id=c.get("pad_token_id", 126081),
    )
    kw.update(overrides)
    return LLaDAConfig(**kw)


def llada_params_from_torch(tensors: Tensors, cfg: LLaDAConfig,
                            dtype=torch.float32) -> Dict[str, Any]:
    """Map an HF LLaDA state dict to the stacked-layer params."""
    def get(name):
        for prefix in ("model.transformer.", "transformer."):
            if prefix + name in tensors:
                return tensors[prefix + name].to(dtype)
        raise KeyError(f"missing checkpoint tensor: *transformer.{name} "
                       f"(have {len(tensors)} keys)")

    def stack(sub: str, f: Callable[[torch.Tensor], torch.Tensor]):
        return torch.stack([f(get(f"blocks.{i}.{sub}"))
                            for i in range(cfg.n_layers)])

    def same(w):
        return w

    if cfg.block_type == "sequential":
        names = ["att_proj", "attn_out", "ff_proj", "ff_out"]
        biases = {"att_proj_bias": "att_proj.bias"}
    else:
        names = ["q_proj", "k_proj", "v_proj", "attn_out", "ff_proj",
                 "up_proj", "ff_out"]
        biases = {"q_bias": "q_proj.bias", "k_bias": "k_proj.bias",
                  "v_bias": "v_proj.bias"}
    blocks = {"attn_norm": stack("attn_norm.weight", same),
              "ff_norm": stack("ff_norm.weight", same)}
    blocks.update({n: stack(f"{n}.weight", _t) for n in names})
    if cfg.include_qkv_bias:
        blocks.update({k: stack(v, same) for k, v in biases.items()})

    params: Dict[str, Any] = {"wte": get("wte.weight"),
                              "ln_f": get("ln_f.weight"), "blocks": blocks}
    if not cfg.weight_tying:
        params["head"] = _t(get("ff_out.weight"))
    return params


def load_llada_checkpoint(ckpt_dir: str, dtype=torch.float32,
                          **cfg_overrides):
    """``(cfg, params)`` from an HF checkpoint directory."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = llada_config_from_hf(json.load(f), **cfg_overrides)
    tensors = load_safetensors_dir(ckpt_dir)
    return cfg, llada_params_from_torch(tensors, cfg, dtype)


# ---------------------------------------------------------------------------
# Reverse direction: params -> an HF-style checkpoint (the role of the
# reference's consolidated save, xllm/util/ckpt.py:66-97 save_pretrained)
# ---------------------------------------------------------------------------


def _host(x: torch.Tensor, dtype, transpose: bool = False) -> torch.Tensor:
    """``x`` in ``dtype`` (transposed when asked), contiguous, on the CPU,
    in storage of its own: cast and transpose run on ``x``'s device."""
    x = x.detach().to(dtype)
    if transpose:
        x = x.T
    return x.contiguous().to("cpu", copy=True)


def llada_state_dict_from_params(params: Dict[str, Any], cfg: LLaDAConfig,
                                 dtype=torch.float32) -> Tensors:
    """Params (on any device) -> the HF-named torch-layout state dict on the
    CPU: ``[in, out]`` linears back to ``[out, in]``, one tensor a layer."""
    pre = "model.transformer."
    sd: Tensors = {pre + "wte.weight": _host(params["wte"], dtype),
                   pre + "ln_f.weight": _host(params["ln_f"], dtype)}
    if not cfg.weight_tying:
        sd[pre + "ff_out.weight"] = _host(params["head"], dtype, True)
    names = (["att_proj", "attn_out", "ff_proj", "ff_out"]
             if cfg.block_type == "sequential"
             else ["q_proj", "k_proj", "v_proj", "attn_out",
                   "ff_proj", "up_proj", "ff_out"])
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        b = f"{pre}blocks.{i}."
        sd[b + "attn_norm.weight"] = _host(blocks["attn_norm"][i], dtype)
        sd[b + "ff_norm.weight"] = _host(blocks["ff_norm"][i], dtype)
        for name in names:
            sd[b + name + ".weight"] = _host(blocks[name][i], dtype, True)
        if cfg.include_qkv_bias:
            if cfg.block_type == "sequential":
                sd[b + "att_proj.bias"] = _host(blocks["att_proj_bias"][i],
                                                dtype)
            else:
                for n in ["q", "k", "v"]:
                    sd[b + f"{n}_proj.bias"] = _host(blocks[f"{n}_bias"][i],
                                                     dtype)
    return sd


def save_llada_checkpoint(ckpt_dir: str, params: Dict[str, Any],
                          cfg: LLaDAConfig, dtype=torch.float32,
                          extra_config: Optional[Dict[str, Any]] = None
                          ) -> None:
    """Write ``model.safetensors`` + ``config.json``, loadable by this
    package, the JAX package and the reference's HF classes."""
    from safetensors.torch import save_file
    os.makedirs(ckpt_dir, exist_ok=True)
    save_file(llada_state_dict_from_params(params, cfg, dtype),
              os.path.join(ckpt_dir, "model.safetensors"))
    config = {
        "d_model": cfg.d_model, "n_heads": cfg.n_heads,
        "n_kv_heads": cfg.n_kv_heads, "n_layers": cfg.n_layers,
        "mlp_hidden_size": cfg.mlp_hidden_size, "mlp_ratio": cfg.mlp_ratio,
        "vocab_size": cfg.vocab_size, "embedding_size": cfg.embedding_size,
        "max_sequence_length": cfg.max_sequence_length,
        "rope": True, "rope_theta": cfg.rope_theta,
        "rope_full_precision": cfg.rope_full_precision,
        "rms_norm_eps": cfg.rms_norm_eps,
        "layer_norm_type": cfg.layer_norm_type,
        "include_bias": cfg.include_bias,
        "include_qkv_bias": cfg.include_qkv_bias,
        "block_type": cfg.block_type,
        "activation_type": cfg.activation_type,
        "weight_tying": cfg.weight_tying,
        "input_emb_norm": cfg.input_emb_norm,
        "scale_logits": cfg.scale_logits,
        "mask_token_id": cfg.mask_token_id,
        "eos_token_id": cfg.eos_token_id,
        "pad_token_id": cfg.pad_token_id,
    }
    if extra_config:
        config.update(extra_config)
    with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)


# ---------------------------------------------------------------------------
# Amused-VQ (diffusers VQModel)
# ---------------------------------------------------------------------------


def _norm_p(tensors, base, dtype):
    return {"scale": tensors[base + ".weight"].to(dtype),
            "bias": tensors[base + ".bias"].to(dtype)}


def _conv_p(tensors, base, dtype):
    return {"w": tensors[base + ".weight"].to(dtype),
            "b": tensors[base + ".bias"].to(dtype)}


def _resnet_p(tensors, base, dtype, shortcut="conv_shortcut"):
    """A resnet block; the 1x1 shortcut is ``conv_shortcut`` in diffusers
    and ``nin_shortcut`` in taming-style (MagViT) checkpoints."""
    p = {"norm1": _norm_p(tensors, base + ".norm1", dtype),
         "conv1": _conv_p(tensors, base + ".conv1", dtype),
         "norm2": _norm_p(tensors, base + ".norm2", dtype),
         "conv2": _conv_p(tensors, base + ".conv2", dtype)}
    if f"{base}.{shortcut}.weight" in tensors:
        p["nin_shortcut"] = _conv_p(tensors, f"{base}.{shortcut}", dtype)
    return p


def _attn_p(tensors, base, dtype):
    """diffusers ``Attention``: group_norm + Linear to_q/to_k/to_v/to_out.0
    folded into 1x1 convs (OIHW ``[out, in, 1, 1]``)."""
    def lin_as_conv(name):
        return {"w": tensors[f"{base}.{name}.weight"].to(dtype)[:, :, None,
                                                               None],
                "b": tensors[f"{base}.{name}.bias"].to(dtype)}
    return {"norm": _norm_p(tensors, base + ".group_norm", dtype),
            "q": lin_as_conv("to_q"), "k": lin_as_conv("to_k"),
            "v": lin_as_conv("to_v"), "proj_out": lin_as_conv("to_out.0")}


def magvit_params_from_torch(tensors: Tensors,
                             cfg: MagvitConfig = MagvitConfig(),
                             dtype=torch.float32) -> Dict[str, Any]:
    """Map the MAGVITv2 state dict (taming-style names: ``encoder.down.{i}.
    block.{j}``, ``nin_shortcut``, conv attention ``q/k/v/proj_out``) to
    params; conv weights stay OIHW."""
    def resnet(base):
        return _resnet_p(tensors, base, dtype, shortcut="nin_shortcut")

    def attn(base):
        return {"norm": _norm_p(tensors, base + ".norm", dtype),
                **{n: _conv_p(tensors, f"{base}.{n}", dtype)
                   for n in ("q", "k", "v", "proj_out")}}

    def mid(base):
        return {"block_1": resnet(base + ".block_1"),
                "attn_1": attn(base + ".attn_1"),
                "block_2": resnet(base + ".block_2")}

    def levels(side, blocks, resample):
        out = []
        for i, n in enumerate(blocks):
            level: Dict[str, Any] = {"block": [
                resnet(f"{side}.{i}.block.{j}") for j in range(n)]}
            conv = f"{side}.{i}.{resample}.conv"
            if conv + ".weight" in tensors:
                level[resample] = {"conv": _conv_p(tensors, conv, dtype)}
            out.append(level)
        return out

    enc = {"conv_in": _conv_p(tensors, "encoder.conv_in", dtype),
           "down": levels("encoder.down", cfg.enc_blocks, "downsample"),
           "mid": mid("encoder.mid"),
           "norm_out": _norm_p(tensors, "encoder.norm_out", dtype),
           "conv_out": _conv_p(tensors, "encoder.conv_out", dtype),
           "quant_conv": _conv_p(tensors, "encoder.quant_conv", dtype)}
    dec = {"post_quant_conv": _conv_p(tensors, "decoder.post_quant_conv",
                                      dtype),
           "conv_in": _conv_p(tensors, "decoder.conv_in", dtype),
           "mid": mid("decoder.mid"),
           "up": levels("decoder.up", cfg.dec_blocks, "upsample"),
           "norm_out": _norm_p(tensors, "decoder.norm_out", dtype),
           "conv_out": _conv_p(tensors, "decoder.conv_out", dtype)}
    return {"encoder": enc, "decoder": dec}


def amused_config_from_hf(config_json: Dict[str, Any]) -> AmusedVQConfig:
    c = config_json
    return AmusedVQConfig(
        block_out_channels=tuple(c["block_out_channels"]),
        layers_per_block=c.get("layers_per_block", 2),
        in_channels=c.get("in_channels", 3),
        out_channels=c.get("out_channels", 3),
        latent_channels=c.get("latent_channels", 64),
        vq_embed_dim=c.get("vq_embed_dim"),
        num_vq_embeddings=c.get("num_vq_embeddings", 8192),
        norm_num_groups=c.get("norm_num_groups", 32),
        mid_attention=c.get("mid_block_add_attention", True),
    )


def amused_params_from_torch(tensors: Tensors,
                             cfg: AmusedVQConfig = AmusedVQConfig(),
                             dtype=torch.float32) -> Dict[str, Any]:
    """Map a diffusers ``VQModel`` state dict to params."""
    nlev = len(cfg.block_out_channels)

    def mid(base):
        m = {"block_1": _resnet_p(tensors, f"{base}.resnets.0", dtype),
             "block_2": _resnet_p(tensors, f"{base}.resnets.1", dtype)}
        if f"{base}.attentions.0.group_norm.weight" in tensors:
            m["attn_1"] = _attn_p(tensors, f"{base}.attentions.0", dtype)
        return m

    down = []
    for i in range(nlev):
        level: Dict[str, Any] = {"block": [
            _resnet_p(tensors, f"encoder.down_blocks.{i}.resnets.{j}", dtype)
            for j in range(cfg.layers_per_block)]}
        conv = f"encoder.down_blocks.{i}.downsamplers.0.conv"
        if conv + ".weight" in tensors:
            level["downsample"] = {"conv": _conv_p(tensors, conv, dtype)}
        down.append(level)
    enc = {"conv_in": _conv_p(tensors, "encoder.conv_in", dtype),
           "down": down, "mid": mid("encoder.mid_block"),
           "norm_out": _norm_p(tensors, "encoder.conv_norm_out", dtype),
           "conv_out": _conv_p(tensors, "encoder.conv_out", dtype)}

    quant = {"quant_conv": _conv_p(tensors, "quant_conv", dtype),
             "embedding": tensors["quantize.embedding.weight"].to(dtype),
             "post_quant_conv": _conv_p(tensors, "post_quant_conv", dtype)}

    up = [None] * nlev
    for k in range(nlev):
        # diffusers up_blocks[0] is the DEEPEST level; ours up[0] shallowest
        level = {"block": [
            _resnet_p(tensors, f"decoder.up_blocks.{k}.resnets.{j}", dtype)
            for j in range(cfg.layers_per_block + 1)]}
        conv = f"decoder.up_blocks.{k}.upsamplers.0.conv"
        if conv + ".weight" in tensors:
            level["upsample"] = {"conv": _conv_p(tensors, conv, dtype)}
        up[nlev - 1 - k] = level
    dec = {"conv_in": _conv_p(tensors, "decoder.conv_in", dtype),
           "mid": mid("decoder.mid_block"), "up": up,
           "norm_out": _norm_p(tensors, "decoder.conv_norm_out", dtype),
           "conv_out": _conv_p(tensors, "decoder.conv_out", dtype)}
    return {"encoder": enc, "quant": quant, "decoder": dec}
