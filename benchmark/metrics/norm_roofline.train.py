"""The backbone's RMSNorm kernels at their memory bound in a training step:
the least bytes of their forward launches (the program's
``backbone.norm_bytes`` counter: x read, the output written, the weight
once) and of their backward launches (``backbone.norm_bwd_bytes``: x and dy
read, dx written, the weight read and dw written once) at 3.35 TB/s, over
the device seconds of the trace's RMSNorm kernels (``csrc/rms_norm.cu``):
``rms_norm_kernel`` (forward and remat recompute), ``rms_norm_bwd_kernel``
and ``rms_norm_dw_kernel`` (the backward's row pass and its dw sum).
``None`` without the backward counter or the kernels, as from a program
whose training steps run the norms as a chain of PyTorch launches."""

KERNELS = ("rms_norm_kernel", "rms_norm_bwd_kernel", "rms_norm_dw_kernel")


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    counted = spans.counters()
    backward = counted.get("backbone.norm_bwd_bytes")
    spent = sum(s for name, (_, s) in ctx["trace"].by_kernel.items()
                if any(k in name for k in KERNELS))
    if not backward or spent <= 0:
        return None
    moved = counted.get("backbone.norm_bytes", 0) + backward
    return 100.0 * moved / ctx["peak_bytes"] / spent
