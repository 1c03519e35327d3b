"""Plain Amused-VQ (the diffusers ``VQModel`` graph of aMUSEd): encoder,
nearest-code quantizer and decoder, NCHW float32, from the parameter tree
the benchmark made (``weights.amused_vq_params``).  Run it with TF32 off
(the harness turns it off for the process; the control turns it on)."""

from __future__ import annotations

import torch

from benchmark.reference.vqgan import (conv, group_norm, mid, resnet,
                                       swish)


def encode_latents(params, cfg: dict, pixels: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 3]`` in [0, 1] -> latents ``[B*h*w, D]`` before the
    quantizer."""
    g, e = cfg["norm_num_groups"], cfg["eps"]
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
    h = conv(params["quant"]["quant_conv"], h)
    return h.permute(0, 2, 3, 1).reshape(-1, h.shape[1])


def code_distances(params, latents: torch.Tensor) -> torch.Tensor:
    """Squared distance of each latent to each code, ``[N, n_codes]``."""
    emb = params["quant"]["embedding"].float()
    return torch.cdist(latents.double(), emb.double()).square()


def decode(params, cfg: dict, codes: torch.Tensor, grid_hw) -> torch.Tensor:
    """Codes ``[B, h*w]`` -> pixels ``[B, H, W, 3]`` clipped to [0, 1]."""
    g, e = cfg["norm_num_groups"], cfg["eps"]
    h, w = grid_hw
    B = codes.shape[0]
    z = params["quant"]["embedding"].float()[codes.reshape(-1).long()]
    x = z.reshape(B, h, w, -1).permute(0, 3, 1, 2)
    x = conv(params["quant"]["post_quant_conv"], x)
    p = params["decoder"]
    x = mid(p["mid"], conv(p["conv_in"], x), g, e)
    for level in reversed(p["up"]):
        for bp in level["block"]:
            x = resnet(bp, x, g, e)
        if "upsample" in level:
            x = x.repeat_interleave(2, 2).repeat_interleave(2, 3)
            x = conv(level["upsample"]["conv"], x)
    x = conv(p["conv_out"], swish(group_norm(p["norm_out"], x, g, e)))
    return x.clamp(0.0, 1.0).permute(0, 2, 3, 1)
