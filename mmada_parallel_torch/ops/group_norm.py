"""GroupNorm over NCHW with an optional swish in one call: the CUDA kernel
wrapper.

The JAX package has no kernel here (XLA fuses ``vqgan_common.group_norm``
and ``swish``); the port's tokenizers call :func:`group_norm_swish` (through
``vqgan_common.norm_swish``) where they ran ``swish(group_norm(...))``, and
``swish=False`` for the bare norm.  A CPU tensor runs that plain chain,
:func:`group_norm_swish_reference`; a CUDA tensor launches the hand-written
kernel ``csrc/group_norm.cu`` or raises, with no fallback.  The output keeps
the input's layout, as the plain chain's does: a channels-last input (the
tokenizers' convolutions give one after the NHWC pixels' permute) takes the
channels-last route, planned by :func:`channels_last_plan`; any other the
contiguous route, planned by :func:`plan_group_norm`.  Both take a
statistics pass and an apply pass.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mmada_parallel_torch.ops._cuda import KERNEL_DTYPES, sm_count
from mmada_parallel_torch.ops.rope_attention import check_no_grad

__all__ = ["group_norm_swish", "group_norm_swish_reference",
           "plan_group_norm", "channels_last_plan"]

# csrc/group_norm.cu's contiguous-route block; a block's range at most
THREADS = 256
CHUNK_BYTES = 64 * 1024
# blocks an SM the planners fill at least
BLOCKS_PER_SM = 4


class Plan(NamedTuple):
    chunks: int         # blocks a group
    elems: int          # a block's chunk of the group


class ClPlan(NamedTuple):
    threads: int        # (channels / vector width) x rows of pixels
    tiles: int          # blocks an image
    pixels: int         # a block's tile


def plan_group_norm(batch: int, channels: int, hw: int, groups: int,
                    elem_size: int, sm_count: int) -> Plan:
    """The contiguous route's plan for a ``[batch, channels, hw]`` input:
    each group (``channels / groups * hw`` contiguous elements) in chunks
    of at most ``CHUNK_BYTES``, and smaller where the groups are too few to
    give ``BLOCKS_PER_SM`` blocks an SM (down to one 16-byte vector a
    thread); chunks are whole vectors."""
    vec = 16 // elem_size
    group = channels // groups * hw
    chunks = max(math.ceil(group * elem_size / CHUNK_BYTES),
                 math.ceil(BLOCKS_PER_SM * sm_count / (batch * groups)))
    chunks = min(chunks, math.ceil(group / (THREADS * vec)))
    chunk = vec * math.ceil(group / (chunks * vec))
    return Plan(math.ceil(group / chunk), chunk)


def channels_last_plan(batch: int, channels: int, hw: int, groups: int,
                       elem_size: int, sm_count: int) -> Optional[ClPlan]:
    """The channels-last route's plan, or ``None`` where it does not apply
    (a group's channels not whole 16-byte vectors, or more than 1024
    vectors a pixel): blocks of at least ``THREADS`` threads, tiles of
    about ``CHUNK_BYTES``, and smaller where the images are too few to give
    ``BLOCKS_PER_SM`` blocks an SM."""
    vec = 16 // elem_size
    cols = channels // vec
    if (channels // groups) % vec or cols > 1024:
        return None
    rows = max(1, THREADS // cols)
    pixels = max(rows, CHUNK_BYTES // (channels * elem_size))
    want = math.ceil(BLOCKS_PER_SM * sm_count / batch)
    if math.ceil(hw / pixels) < want:
        pixels = max(rows, math.ceil(hw / want))
    return ClPlan(cols * rows, math.ceil(hw / pixels), pixels)


def group_norm_swish_reference(x: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, groups: int, eps: float,
                               swish: bool = True) -> torch.Tensor:
    """The plain chain, ``swish(group_norm(...))`` of ``vqgan_common``: f32
    statistics (biased variance), the normalised value cast to ``x``'s
    type, the swish in that type."""
    B, C, H, W = x.shape
    xf = x.float().reshape(B, groups, C // groups, H, W)
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = xf.var(dim=(2, 3, 4), keepdim=True, unbiased=False)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    y = (xf * scale.float()[None, :, None, None]
         + bias.float()[None, :, None, None]).to(x.dtype)
    return y * torch.sigmoid(y) if swish else y


def _scale_bias(x, scale, bias):
    sc, bi = (t.to(device=x.device, dtype=torch.float32).contiguous()
              for t in (scale, bias))
    if sc.numel() != x.shape[1] or bi.numel() != x.shape[1]:
        raise ValueError(f"group_norm_swish: scale and bias of "
                         f"{x.shape[1]} channels, got {sc.numel()} and "
                         f"{bi.numel()}")
    return sc, bi


def _launch_cl(x, scale, bias, groups: int, eps: float, swish: bool,
               plan: ClPlan):
    from mmada_parallel_torch.ops import _cuda
    if x.data_ptr() % 16:
        raise ValueError("group_norm_swish: the kernel loads 16 bytes at a "
                         "time and needs x 16-byte aligned")
    B, C, H, W = x.shape
    sc, bi = _scale_bias(x, scale, bias)
    part = torch.empty(B * groups * plan.tiles * 3, dtype=torch.float32,
                       device=x.device)
    norms = torch.empty(B * groups * 3, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)                   # channels-last, as x
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.mmada_group_norm_cl(
            x.data_ptr(), out.data_ptr(), part.data_ptr(), norms.data_ptr(),
            sc.data_ptr(), bi.data_ptr(), B, C, H * W, groups, eps,
            int(swish), KERNEL_DTYPES[x.dtype], plan.threads, plan.tiles,
            plan.pixels, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_swish CUDA launch failed: "
                           f"cudaError_t {err}")
    group_norm_swish.launches += 1
    return out


def _launch_nchw(x, scale, bias, groups: int, eps: float, swish: bool):
    from mmada_parallel_torch.ops import _cuda
    if x.data_ptr() % 16:
        raise ValueError("group_norm_swish: the kernel loads 16 bytes at a "
                         "time and needs x 16-byte aligned")
    B, C, H, W = x.shape
    sc, bi = _scale_bias(x, scale, bias)
    plan = plan_group_norm(B, C, H * W, groups, x.element_size(),
                           sm_count(x.device))
    part = torch.empty(B * groups * plan.chunks * 3, dtype=torch.float32,
                       device=x.device)
    out = torch.empty_like(x)
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        err = lib.mmada_group_norm(
            x.data_ptr(), out.data_ptr(), part.data_ptr(), sc.data_ptr(),
            bi.data_ptr(), B, C, H * W, groups, eps, int(swish),
            KERNEL_DTYPES[x.dtype], plan.chunks, plan.elems,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_swish CUDA launch failed: "
                           f"cudaError_t {err}")
    group_norm_swish.launches += 1
    return out


def _launch(x, scale, bias, groups: int, eps: float, swish: bool):
    check_no_grad("group_norm_swish", x, scale, bias)
    if x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"group_norm_swish: the CUDA kernel takes bfloat16 "
                         f"or float32, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"group_norm_swish: x must be NCHW, got shape "
                         f"{list(x.shape)}")
    B, C, H, W = x.shape
    if C % groups:
        raise ValueError(f"group_norm_swish: {C} channels in {groups} groups")
    group = C // groups * H * W
    if group >= 2 ** 24 or B * groups > 65535:
        raise ValueError(f"group_norm_swish: groups of {group} elements "
                         f"(f32 counts are exact below 2**24) and "
                         f"{B * groups} of them (at most 65535)")
    if x.is_contiguous() or not x.is_contiguous(
            memory_format=torch.channels_last):
        return _launch_nchw(x.contiguous(), scale, bias, groups, eps, swish)
    plan = channels_last_plan(B, C, H * W, groups, x.element_size(),
                              sm_count(x.device))
    if plan is not None:
        return _launch_cl(x, scale, bias, groups, eps, swish, plan)
    # groups of channels the route does not take (the tiny Amused-VQ's 2
    # f32 channels a group): through NCHW, and back to the input's layout
    return _launch_nchw(x.contiguous(), scale, bias, groups, eps, swish
                        ).contiguous(memory_format=torch.channels_last)


def group_norm_swish(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, groups: int = 32, eps: float = 1e-6,
                     swish: bool = True) -> torch.Tensor:
    """``swish(group_norm(x))`` over NCHW ``x`` (the bare norm with
    ``swish=False``), per-channel ``scale`` and ``bias``.  A CUDA tensor
    (f32 or bf16, 16-byte aligned, with no gradient wanted) launches the
    kernel and raises on anything it does not take; a CPU tensor runs
    :func:`group_norm_swish_reference`.  The output keeps a contiguous or
    channels-last input's layout, as the plain chain's does.
    ``group_norm_swish.launches`` counts kernel calls."""
    if x.device.type == "cpu":
        return group_norm_swish_reference(x, scale, bias, groups, eps, swish)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_swish runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch(x, scale, bias, groups, eps, swish)


group_norm_swish.launches = 0
