"""The controls: the reference computed one precision below what a
configuration states.

bf16 compute -> fp8: every linear product (block GEMMs and the head) takes
operands rounded to float8 e4m3 with a scale per row of the activations and
per column of the weights, as an fp8 GEMM path would, and accumulates in
f32; in the backward the output gradient is rounded to e5m2 (scaled by
row for dX, by column for dW), as fp8 training recipes do.  f32 with TF32
off -> TF32 (``tf32`` context).
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


E5M2_MAX = 57344.0


def _fp8(t: torch.Tensor, dim: int, fmt=torch.float8_e4m3fn,
         top: float = E4M3_MAX) -> torch.Tensor:
    """``t`` rounded to ``fmt`` with its absolute maximum along ``dim``
    scaled to the format's largest value, returned in f32."""
    t = t.float()
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / top
    return (t / scale).to(fmt).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _fp8(x, -1) @ _fp8(w, 0)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x2, g2 = x.reshape(-1, x.shape[-1]), g.reshape(-1, g.shape[-1])
        dx = _fp8(g2, -1, torch.float8_e5m2, E5M2_MAX) @ _fp8(w, 0).T
        dw = _fp8(x2, 0).T @ _fp8(g2, 0, torch.float8_e5m2, E5M2_MAX)
        return dx.reshape(x.shape), dw


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` from e4m3 operands: ``x`` scaled by row, ``w`` by
    column (and an e5m2 output gradient in the backward)."""
    return _Fp8Matmul.apply(x, w)


@contextlib.contextmanager
def tf32():
    """TF32 on for matmuls and cuDNN convolutions inside the scope."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd
