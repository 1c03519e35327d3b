"""MagViT-v2 LFQ VQGAN (variant M's image tokenizer) in PyTorch.

Counterpart of :mod:`mmada_parallel_tpu.models.magvit2`: the encoder
(5 levels, stride 16, mid res/attn/res, ``z_channels=13``, 1x1 quant_conv),
the lookup-free quantizer (sign bits packed MSB-first, codebook entries the
+-1 bit patterns) and the mirrored decoder.  The public functions keep the
JAX layout: pixels NHWC in [-1, 1], latents NHWC, codes ``[B, h*w]``; inside,
the convolutions run NCHW (:mod:`~mmada_parallel_torch.models.vqgan_common`).
Run it in fp32 with TF32 off (cuDNN convolutions default to TF32): the
pipelines and servers call it inside ``vqgan_common.vq_precision()``.
:func:`lfq_losses` are the quantizer's training losses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from mmada_parallel_torch.models import vqgan_common as C
from mmada_parallel_torch.utils.spans import span

__all__ = ["MagvitConfig", "init_magvit_params", "magvit_encode",
           "magvit_get_code", "magvit_decode_code", "lfq_quantize",
           "lfq_losses", "lfq_codebook_entry"]


@dataclasses.dataclass(frozen=True)
class MagvitConfig:
    ch: int = 128
    enc_ch_mult: Tuple[int, ...] = (1, 2, 2, 4, 4)
    enc_blocks: Tuple[int, ...] = (4, 3, 4, 3, 4)
    dec_ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    dec_blocks: Tuple[int, ...] = (4, 4, 3, 4, 3)
    z_channels: int = 13
    in_ch: int = 3
    out_ch: int = 3
    groups: int = 32
    eps: float = 1e-6

    @property
    def codebook_size(self) -> int:
        return 2 ** self.z_channels

    @property
    def scale(self) -> int:
        return 2 ** (len(self.enc_ch_mult) - 1)

    @classmethod
    def tiny(cls) -> "MagvitConfig":
        return cls(ch=16, enc_ch_mult=(1, 2), enc_blocks=(1, 1),
                   dec_ch_mult=(1, 2), dec_blocks=(1, 1), z_channels=4,
                   groups=4)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_magvit_params(cfg: MagvitConfig, generator: torch.Generator,
                       device=None, dtype=torch.float32) -> Dict[str, Any]:
    """Random parameters drawn from ``generator`` on ``device`` (default:
    the generator's device), with the JAX tree's names and torch's default
    inits (:class:`~mmada_parallel_torch.models.vqgan_common.ParamInit`)."""
    init = C.ParamInit(generator, device, dtype)
    ch = cfg.ch

    enc: Dict[str, Any] = {"conv_in": init.conv(3, 3, cfg.in_ch, ch)}
    in_mult = (1,) + tuple(cfg.enc_ch_mult)
    down = []
    for i, mult in enumerate(cfg.enc_ch_mult):
        cin, cout = ch * in_mult[i], ch * mult
        level: Dict[str, Any] = {"block": []}
        for _ in range(cfg.enc_blocks[i]):
            level["block"].append(init.resnet(cin, cout))
            cin = cout
        if i != len(cfg.enc_ch_mult) - 1:
            level["downsample"] = {"conv": init.conv(3, 3, cout, cout)}
        down.append(level)
    block_in = ch * cfg.enc_ch_mult[-1]
    enc.update({
        "down": down,
        "mid": {"block_1": init.resnet(block_in, block_in),
                "attn_1": init.attn(block_in),
                "block_2": init.resnet(block_in, block_in)},
        "norm_out": init.norm(block_in),
        "conv_out": init.conv(3, 3, block_in, cfg.z_channels),
        "quant_conv": init.conv(1, 1, cfg.z_channels, cfg.z_channels),
    })

    block_in = ch * cfg.dec_ch_mult[-1]
    dec: Dict[str, Any] = {
        "post_quant_conv": init.conv(1, 1, cfg.z_channels, cfg.z_channels),
        "conv_in": init.conv(3, 3, cfg.z_channels, block_in),
        "mid": {"block_1": init.resnet(block_in, block_in),
                "attn_1": init.attn(block_in),
                "block_2": init.resnet(block_in, block_in)},
    }
    up = [None] * len(cfg.dec_ch_mult)
    cin = block_in
    for i in reversed(range(len(cfg.dec_ch_mult))):
        cout = ch * cfg.dec_ch_mult[i]
        level = {"block": []}
        for _ in range(cfg.dec_blocks[i]):
            level["block"].append(init.resnet(cin, cout))
            cin = cout
        if i != 0:
            level["upsample"] = {"conv": init.conv(3, 3, cout, cout)}
        up[i] = level
    dec.update({"up": up, "norm_out": init.norm(cin),
                "conv_out": init.conv(3, 3, cin, cfg.out_ch)})
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# LFQ
# ---------------------------------------------------------------------------


def _powers(z_channels: int, device) -> torch.Tensor:
    """``2^(C-1) .. 2^0``: bit i of a code is channel i, MSB first."""
    return 2 ** torch.arange(z_channels - 1, -1, -1, device=device)


def lfq_quantize(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lookup-free quantization of ``[B, H, W, C]`` latents: ``(z_q,
    indices [B, H*W])``, ``z_q`` the +-1 binarization (in the
    straight-through form the JAX function returns) and the indices the
    sign bits packed MSB-first."""
    B, H, W, Cc = z.shape
    bits = z > 0
    z_q_hard = 2.0 * bits.to(z.dtype) - 1.0
    z_q = z + (z_q_hard - z)
    indices = (bits.long() * _powers(Cc, z.device)).sum(dim=-1)
    return z_q, indices.reshape(B, H * W)


def lfq_losses(z: torch.Tensor, beta: float = 0.25
               ) -> Dict[str, torch.Tensor]:
    """Entropy and commitment losses of ``[..., C]`` latents, in f32
    (``modeling_magvitv2.py:246-263``): each channel's soft assignment to
    +-1 (logits ``-(z -+ 1)^2``), its mean entropy minus the entropy of the
    batch-mean assignment, and the straight-through commitment ``|sg(z_q) -
    z|^2 + beta |z_q - sg(z)|^2``; ``.detach()`` is JAX's
    ``stop_gradient``."""
    zf = z.float().reshape(-1, z.shape[-1])
    hard = torch.where(zf > 0, 1.0, -1.0)
    z_q = zf + (hard - zf).detach()          # straight-through
    logit = torch.stack([-(zf - 1.0) ** 2, -(zf + 1.0) ** 2], dim=-1)
    logp = torch.log_softmax(logit, dim=-1)
    p = logp.exp()
    entropy = (-(p * logp).sum(-1)).mean()
    mean_p = p.mean(dim=0)
    mean_entropy = (-(mean_p * torch.log(mean_p + 1e-10)).sum(-1)).mean()
    commit = (torch.mean((z_q.detach() - zf) ** 2)
              + beta * torch.mean((z_q - zf.detach()) ** 2))
    return {"entropy_loss": entropy - mean_entropy, "commit_loss": commit}


def lfq_codebook_entry(indices: torch.Tensor, z_channels: int,
                       shape: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """Indices ``[B, N]`` -> +-1 latents ``[B, h, w, C]`` (f32).
    ``shape=(h, w)`` overrides the default square grid ``h = w =
    sqrt(N)``."""
    B, N = indices.shape
    if shape is None:
        h = w = int(round(N ** 0.5))
    else:
        h, w = shape
    if h * w != N:
        raise ValueError(f"grid {h}x{w} != {N} codes")
    bits = (indices.long()[..., None] // _powers(z_channels,
                                                 indices.device)) % 2
    return (bits.float() * 2.0 - 1.0).reshape(B, h, w, z_channels)


# ---------------------------------------------------------------------------
# Forward passes (NCHW inside)
# ---------------------------------------------------------------------------


def _mid(p: Dict[str, Any], h: torch.Tensor, g: int, e: float):
    h = C.resnet_block(p["block_1"], h, g, e)
    h = C.attn_block(p["attn_1"], h, g, e)
    return C.resnet_block(p["block_2"], h, g, e)


def _encoder(p: Dict[str, Any], cfg: MagvitConfig,
             x: torch.Tensor) -> torch.Tensor:
    """NCHW pixels -> NCHW latents (after ``quant_conv``)."""
    g, e = cfg.groups, cfg.eps
    h = C.conv2d(p["conv_in"], x)
    for level in p["down"]:
        for bp in level["block"]:
            h = C.resnet_block(bp, h, g, e)
        if "downsample" in level:
            h = C.downsample(level["downsample"], h)
    h = _mid(p["mid"], h, g, e)
    h = C.norm_swish(p["norm_out"], h, g, e)
    h = C.conv2d(p["conv_out"], h)
    return C.conv2d(p["quant_conv"], h)


def _decoder(p: Dict[str, Any], cfg: MagvitConfig,
             z_q: torch.Tensor) -> torch.Tensor:
    """NCHW +-1 latents -> NCHW pixels."""
    g, e = cfg.groups, cfg.eps
    h = C.conv2d(p["post_quant_conv"], z_q)
    h = C.conv2d(p["conv_in"], h)
    h = _mid(p["mid"], h, g, e)
    for i in reversed(range(len(p["up"]))):
        level = p["up"][i]
        for bp in level["block"]:
            h = C.resnet_block(bp, h, g, e)
        if "upsample" in level:
            h = C.upsample(level["upsample"], h)
    h = C.norm_swish(p["norm_out"], h, g, e)
    return C.conv2d(p["conv_out"], h)


def magvit_encode(params: Dict[str, Any], cfg: MagvitConfig,
                  pixels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, H, W, 3]`` pixels in [-1, 1] -> ``(z_q [B, h, w, C],
    indices [B, h*w])``."""
    z = _encoder(params["encoder"], cfg, pixels.permute(0, 3, 1, 2))
    return lfq_quantize(z.permute(0, 2, 3, 1))


def magvit_get_code(params: Dict[str, Any], cfg: MagvitConfig,
                    pixels: torch.Tensor) -> torch.Tensor:
    """``MAGVITv2.get_code``: pixels -> indices ``[B, h*w]``."""
    with span("vq.encode"):
        return magvit_encode(params, cfg, pixels)[1]


def magvit_decode_code(params: Dict[str, Any], cfg: MagvitConfig,
                       indices: torch.Tensor,
                       shape: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """Indices ``[B, N]`` -> pixels ``[B, H, W, 3]`` (about [-1, 1],
    unclipped, as the JAX function returns them)."""
    with span("vq.decode"):
        z_q = lfq_codebook_entry(indices, cfg.z_channels, shape)
        dt = params["decoder"]["conv_in"]["w"].dtype
        x = _decoder(params["decoder"], cfg, z_q.to(dt).permute(0, 3, 1, 2))
        return x.permute(0, 2, 3, 1)
