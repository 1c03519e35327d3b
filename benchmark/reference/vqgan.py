"""Plain VQGAN building blocks (NCHW float32): convolutions, GroupNorm,
swish, the resnet and single-head attention blocks and the mid block, as
the diffusers ``VQModel`` and MagViT-v2 graphs use them."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv(p, x, stride=1, pad=None):
    if pad is not None:
        x = F.pad(x, pad)
        return F.conv2d(x, p["w"], p["b"], stride=stride)
    return F.conv2d(x, p["w"], p["b"], padding="same")


def group_norm(p, x, groups, eps):
    return F.group_norm(x, groups, p["scale"], p["bias"], eps)


def swish(x):
    return x * torch.sigmoid(x)


def resnet(p, x, g, e):
    h = conv(p["conv1"], swish(group_norm(p["norm1"], x, g, e)))
    h = conv(p["conv2"], swish(group_norm(p["norm2"], h, g, e)))
    if "nin_shortcut" in p:
        x = conv(p["nin_shortcut"], x)
    return x + h


def attn(p, x, g, e):
    B, C, H, W = x.shape
    h = group_norm(p["norm"], x, g, e)
    q, k, v = (conv(p[n], h).reshape(B, C, H * W) for n in "qkv")
    probs = torch.softmax(q.transpose(1, 2) @ k * C ** -0.5, dim=-1)
    out = (v @ probs.transpose(1, 2)).reshape(B, C, H, W)
    return x + conv(p["proj_out"], out)


def mid(p, x, g, e):
    x = resnet(p["block_1"], x, g, e)
    if "attn_1" in p:
        x = attn(p["attn_1"], x, g, e)
    return resnet(p["block_2"], x, g, e)
