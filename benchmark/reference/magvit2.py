"""Plain MagViT-v2 encoder and lookup-free quantizer (variant M's image
tokenizer): 5 levels at stride 16, the mid resnet/attention/resnet, 13
latent channels after a 1x1 ``quant_conv``; a code's bit ``i`` is the sign
of channel ``i``, most significant first.  NCHW float32, from the tree the
benchmark made (``weights.magvit_params``)."""

from __future__ import annotations

import torch

from benchmark.reference.vqgan import conv, group_norm, mid, resnet, swish


def encode_latents(params, cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` in [-1, 1] -> latents ``[B, h*w, z_channels]``."""
    g, e = cfg["groups"], cfg["eps"]
    p = params["encoder"]
    h = conv(p["conv_in"], pixels.permute(0, 3, 1, 2).float())
    for level in p["down"]:
        for bp in level["block"]:
            h = resnet(bp, h, g, e)
        if "downsample" in level:
            h = conv(level["downsample"]["conv"], h, stride=2,
                     pad=(0, 1, 0, 1))
    h = mid(p["mid"], h, g, e)
    h = conv(p["conv_out"], swish(group_norm(p["norm_out"], h, g, e)))
    h = conv(p["quant_conv"], h)
    return h.flatten(2).transpose(1, 2)


def code_bits(codes: torch.Tensor, z_channels: int) -> torch.Tensor:
    """Codes ``[..., N]`` -> their bits ``[..., N, z_channels]`` (bool),
    most significant first."""
    shifts = torch.arange(z_channels - 1, -1, -1, device=codes.device)
    return (codes.long()[..., None] >> shifts) & 1 == 1


def bit_gap(latents: torch.Tensor, codes: torch.Tensor) -> float:
    """The widest ``|z|`` of a latent channel whose sign the code's bit
    contradicts (0 when every bit agrees): how far from the sign boundary
    a disagreement lies."""
    wrong = code_bits(codes, latents.shape[-1]) != (latents > 0)
    return float(latents.abs()[wrong].max()) if wrong.any() else 0.0
