"""The backbone's RMSNorm kernel at its memory bound: the bytes its
launches must move at the least (the program's ``backbone.norm_bytes``
counter, ``ops/rms_norm.norm_bytes``: each launch's input read once, its
output written once, the weight once) at 3.35 TB/s, over the device
seconds of the trace's ``rms_norm_kernel`` launches (``csrc/rms_norm.cu``).
``None`` without the counter or the kernel, as from a program that runs
the norms as a chain of PyTorch launches."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    moved = spans.counters().get("backbone.norm_bytes")
    spent = sum(s for name, (_, s) in ctx["trace"].by_kernel.items()
                if "rms_norm_kernel" in name)
    if not moved or spent <= 0:
        return None
    return 100.0 * moved / ctx["peak_bytes"] / spent
