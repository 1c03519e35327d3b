"""Amused-VQ image tokenizer (variant A) in PyTorch.

Counterpart of :mod:`mmada_parallel_tpu.models.amused_vq` (the diffusers
``VQModel`` graph).  The public functions keep the JAX layout: pixels are
NHWC in [0, 1], latents NHWC, codes ``[B, h*w]``; inside, the convolutions
run NCHW (:mod:`~mmada_parallel_torch.models.vqgan_common`).  Run it in fp32
with TF32 off (cuDNN convolutions default to TF32): the pipelines and
servers call it inside ``vqgan_common.vq_precision()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from mmada_parallel_torch.models import vqgan_common as C

__all__ = ["AmusedVQConfig", "init_amused_vq_params", "amused_encode",
           "amused_quantize", "amused_decode_code", "amused_img_span"]


@dataclasses.dataclass(frozen=True)
class AmusedVQConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512, 768)
    layers_per_block: int = 2
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 64
    vq_embed_dim: Optional[int] = None     # None -> latent_channels
    num_vq_embeddings: int = 8192
    norm_num_groups: int = 32
    mid_attention: bool = True
    eps: float = 1e-6

    @property
    def embed_dim(self) -> int:
        return self.vq_embed_dim if self.vq_embed_dim is not None else self.latent_channels

    @property
    def scale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)

    @classmethod
    def tiny(cls) -> "AmusedVQConfig":
        return cls(block_out_channels=(8, 16), layers_per_block=1,
                   latent_channels=8, num_vq_embeddings=32, norm_num_groups=4)


# ---------------------------------------------------------------------------
# Initialization (torch defaults: kaiming-uniform convs, ones/zeros norms)
# ---------------------------------------------------------------------------


def init_amused_vq_params(cfg: AmusedVQConfig, generator: torch.Generator,
                          device=None, dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` on ``device`` (default:
    the generator's device), in the JAX tree's structure."""
    init = C.ParamInit(generator, device, dtype)
    uniform, conv, norm, resnet = init.uniform, init.conv, init.norm, \
        init.resnet

    def mid(c):
        m = {"block_1": resnet(c, c), "block_2": resnet(c, c)}
        if cfg.mid_attention:
            m["attn_1"] = init.attn(c)
        return m

    chans = cfg.block_out_channels
    down = []
    cin = chans[0]
    for i, cout in enumerate(chans):
        level: Dict[str, Any] = {"block": []}
        for _ in range(cfg.layers_per_block):
            level["block"].append(resnet(cin, cout))
            cin = cout
        if i != len(chans) - 1:
            level["downsample"] = {"conv": conv(3, 3, cout, cout)}
        down.append(level)
    enc = {"conv_in": conv(3, 3, cfg.in_channels, chans[0]), "down": down,
           "mid": mid(chans[-1]), "norm_out": norm(chans[-1]),
           "conv_out": conv(3, 3, chans[-1], cfg.latent_channels)}

    ed, n = cfg.embed_dim, cfg.num_vq_embeddings
    quant = {"quant_conv": conv(1, 1, cfg.latent_channels, ed),
             "embedding": uniform((n, ed), 1.0 / n),
             "post_quant_conv": conv(1, 1, ed, cfg.latent_channels)}

    up = [None] * len(chans)
    cin = chans[-1]
    for i in reversed(range(len(chans))):
        cout = chans[i]
        level = {"block": []}
        for _ in range(cfg.layers_per_block + 1):
            level["block"].append(resnet(cin, cout))
            cin = cout
        if i != 0:
            level["upsample"] = {"conv": conv(3, 3, cout, cout)}
        up[i] = level
    dec = {"conv_in": conv(3, 3, cfg.latent_channels, chans[-1]),
           "mid": mid(chans[-1]), "up": up, "norm_out": norm(chans[0]),
           "conv_out": conv(3, 3, chans[0], cfg.out_channels)}
    return {"encoder": enc, "quant": quant, "decoder": dec}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mid(p: Dict[str, Any], x: torch.Tensor, g: int, e: float) -> torch.Tensor:
    x = C.resnet_block(p["block_1"], x, g, e)
    if "attn_1" in p:
        x = C.attn_block(p["attn_1"], x, g, e)
    return C.resnet_block(p["block_2"], x, g, e)


def amused_encode(params: Dict[str, Any], cfg: AmusedVQConfig,
                  pixels: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` in [0, 1] -> pre-quantization latents
    ``[B, h, w, embed_dim]`` (encoder + ``quant_conv``)."""
    g, e = cfg.norm_num_groups, cfg.eps
    p = params["encoder"]
    h = C.conv2d(p["conv_in"], pixels.permute(0, 3, 1, 2))
    for level in p["down"]:
        for bp in level["block"]:
            h = C.resnet_block(bp, h, g, e)
        if "downsample" in level:
            h = C.downsample(level["downsample"], h)
    h = _mid(p["mid"], h, g, e)
    h = C.swish(C.group_norm(p["norm_out"], h, g, e))
    h = C.conv2d(p["conv_out"], h)
    return C.conv2d(params["quant"]["quant_conv"], h).permute(0, 2, 3, 1)


def amused_quantize(params: Dict[str, Any], cfg: AmusedVQConfig,
                    latents: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-codebook quantization: ``(z_q [B, h, w, D], indices
    [B, h*w])`` (argmin of the squared distance, first index on ties)."""
    B, H, W, D = latents.shape
    emb = params["quant"]["embedding"].float()
    z = latents.float().reshape(-1, D)
    d = ((z * z).sum(dim=1, keepdim=True) - 2.0 * z @ emb.T
         + (emb * emb).sum(dim=1)[None, :])
    idx = torch.argmin(d, dim=1)
    z_q = emb[idx].reshape(B, H, W, D).to(latents.dtype)
    # the straight-through form the JAX function returns (same rounding)
    z_q = latents + (z_q - latents)
    return z_q, idx.reshape(B, H * W)


def amused_decode_code(params: Dict[str, Any], cfg: AmusedVQConfig,
                       indices: torch.Tensor,
                       grid_hw: Tuple[int, int]) -> torch.Tensor:
    """Codes ``[B, N]`` -> pixels ``[B, H, W, 3]`` clipped to [0, 1].
    A code outside the codebook raises (the JAX gather would decode NaN)."""
    h, w = grid_hw
    B = indices.shape[0]
    emb = params["quant"]["embedding"]
    if int(indices.min()) < 0 or int(indices.max()) >= emb.shape[0]:
        raise ValueError(f"codes must be in [0, {emb.shape[0]})")
    z_q = emb[indices.reshape(-1).long()].reshape(B, h, w, -1)
    g, e = cfg.norm_num_groups, cfg.eps
    x = C.conv2d(params["quant"]["post_quant_conv"], z_q.permute(0, 3, 1, 2))
    p = params["decoder"]
    x = C.conv2d(p["conv_in"], x)
    x = _mid(p["mid"], x, g, e)
    for i in reversed(range(len(p["up"]))):
        level = p["up"][i]
        for bp in level["block"]:
            x = C.resnet_block(bp, x, g, e)
        if "upsample" in level:
            x = C.upsample(level["upsample"], x)
    x = C.swish(C.group_norm(p["norm_out"], x, g, e))
    x = C.conv2d(p["conv_out"], x)
    return x.clamp(0.0, 1.0).permute(0, 2, 3, 1)


def amused_img_span(encode_fn, cfg: AmusedVQConfig, pixels, tokens):
    """Pixels -> ``[boi] offset-grid-with-newlines [eoi]`` token span.

    ``pixels`` is a ``[1, H, W, 3]`` float array in [0, 1] (the JAX
    counterpart takes the PIL image and converts it itself); ``encode_fn``
    maps it to ``[1, h*w]`` codes."""
    import numpy as np
    from mmada_parallel_torch import tokens as tk

    codes = np.asarray(encode_fn(pixels))[0]
    h = pixels.shape[1] // cfg.scale
    w = pixels.shape[2] // cfg.scale
    grid = [int(c) + tokens.vq_offset for c in codes]
    return [tokens.boi] + tk.add_break_line(grid, h, w, tokens.newline) \
        + [tokens.eoi]
