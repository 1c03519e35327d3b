"""Shared VQGAN conv building blocks in PyTorch.

Counterpart of :mod:`mmada_parallel_tpu.models.vqgan_common`.  Internally
NCHW with OIHW weights (PyTorch's convolution layout); the param dicts keep
the JAX key structure (``{"w", "b"}`` convs, ``{"scale", "bias"}`` norms) so
:mod:`~mmada_parallel_torch.models.from_jax` maps them 1:1 (HWIO -> OIHW).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from mmada_parallel_torch.ops.group_norm import group_norm_swish
from mmada_parallel_torch.utils.spans import count, span

__all__ = ["conv2d", "group_norm", "swish", "norm_swish", "resnet_block",
           "attn_block", "downsample", "upsample", "ParamInit",
           "vq_precision"]


@contextlib.contextmanager
def vq_precision():
    """The tokenizers' convolutions in full f32: cuDNN's TF32 off for the
    scope (it defaults to on), the caller's other cuDNN settings kept, and
    all of them restored on exit.  Also a decorator."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


class ParamInit:
    """Random VQGAN parameters drawn from one generator, in the JAX trees'
    structure: torch's default inits (kaiming-uniform convs with
    ``U(+-sqrt(1/fan_in))`` weight and bias, ones/zeros norms), OIHW convs,
    straight into ``dtype`` on ``device`` (default: the generator's)."""

    def __init__(self, generator: torch.Generator, device=None,
                 dtype=torch.float32):
        self.generator = generator
        self.device = (torch.device(device) if device is not None
                       else generator.device)
        self.dtype = dtype

    def uniform(self, shape, bound: float) -> torch.Tensor:
        return torch.empty(shape, dtype=self.dtype,
                           device=self.device).uniform_(
            -bound, bound, generator=self.generator)

    def conv(self, kh: int, kw: int, cin: int, cout: int):
        bound = math.sqrt(1.0 / (kh * kw * cin))
        return {"w": self.uniform((cout, cin, kh, kw), bound),
                "b": self.uniform((cout,), bound)}

    def norm(self, c: int):
        return {"scale": torch.ones(c, dtype=self.dtype, device=self.device),
                "bias": torch.zeros(c, dtype=self.dtype, device=self.device)}

    def resnet(self, cin: int, cout: int):
        p = {"norm1": self.norm(cin), "conv1": self.conv(3, 3, cin, cout),
             "norm2": self.norm(cout), "conv2": self.conv(3, 3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = self.conv(1, 1, cin, cout)
        return p

    def attn(self, c: int):
        return {"norm": self.norm(c), "q": self.conv(1, 1, c, c),
                "k": self.conv(1, 1, c, c), "v": self.conv(1, 1, c, c),
                "proj_out": self.conv(1, 1, c, c)}


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def conv2d(p: Dict[str, torch.Tensor], x: torch.Tensor, stride: int = 1,
           padding: Any = "same") -> torch.Tensor:
    """NCHW conv with OIHW weights; ``padding`` "same"/"valid" or an
    explicit ``(left, right, top, bottom)`` pad applied before a valid
    conv."""
    w = p["w"].to(x.dtype)
    if isinstance(padding, tuple):
        x = F.pad(x, padding)
        padding = 0
    elif padding == "same" and stride != 1:
        raise ValueError("'same' padding is for stride 1 here")
    return F.conv2d(x, w, p["b"].to(x.dtype), stride=stride, padding=padding)


def group_norm(p: Dict[str, torch.Tensor], x: torch.Tensor, groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NCHW with fp32 statistics (biased variance)."""
    B, C, H, W = x.shape
    og = x.dtype
    xf = x.float().reshape(B, groups, C // groups, H, W)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = xf.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    scale = p["scale"].float()[None, :, None, None]
    bias = p["bias"].float()[None, :, None, None]
    return (xf * scale + bias).to(og)


def norm_swish(p: Dict[str, torch.Tensor], x: torch.Tensor, groups: int = 32,
               eps: float = 1e-6, act: bool = True) -> torch.Tensor:
    """``swish(group_norm(p, x))`` (the bare norm with ``act=False``) in one
    call of :func:`~mmada_parallel_torch.ops.group_norm.group_norm_swish`:
    the fused CUDA kernel on a card, this chain on the CPU.  Each call is a
    ``vq.norm`` span that adds its least bytes (one read of ``x`` and one
    write of the output) to the ``vq.norm_bytes`` counter."""
    with span("vq.norm"):
        count("vq.norm_bytes", 2 * x.numel() * x.element_size())
        return group_norm_swish(x, p["scale"], p["bias"], groups, eps, act)


def resnet_block(p: Dict[str, Any], x: torch.Tensor, groups: int = 32,
                 eps: float = 1e-6) -> torch.Tensor:
    """``x + conv2(swish(norm2(conv1(swish(norm1(x))))))`` with a 1x1
    ``nin_shortcut`` when channels change."""
    h = norm_swish(p["norm1"], x, groups, eps)
    h = conv2d(p["conv1"], h)
    h = norm_swish(p["norm2"], h, groups, eps)
    h = conv2d(p["conv2"], h)
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def attn_block(p: Dict[str, Any], x: torch.Tensor, groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """Single-head conv attention over the H*W positions (fp32 scores)."""
    B, C, H, W = x.shape
    h = norm_swish(p["norm"], x, groups, eps, act=False)
    q = conv2d(p["q"], h).reshape(B, C, H * W)
    k = conv2d(p["k"], h).reshape(B, C, H * W)
    v = conv2d(p["v"], h).reshape(B, C, H * W)
    scores = torch.einsum("bci,bcj->bij", q.float(), k.float()) * C ** -0.5
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bij,bcj->bci", probs, v).reshape(B, C, H, W)
    return x + conv2d(p["proj_out"], out)


def downsample(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Stride-2 conv after the asymmetric pad (left 0, right 1, top 0,
    bottom 1)."""
    return conv2d(p["conv"], x, stride=2, padding=(0, 1, 0, 1))


def upsample(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x, then a 3x3 conv."""
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return conv2d(p["conv"], x)
