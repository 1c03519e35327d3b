"""The grouped GEMM's share of its roofline: the experts' operations and
least bytes over the window (the program's ``moe.flops`` and ``moe.bytes``
counters, ``ops/moe.count_experts``: 2 x assignments x 3 d m; the touched
experts' weights once, the tokens in, the SwiGLU rows out and in, the f32
weighted rows out), the larger of the two at the bf16 peak and the memory
rate, over the device seconds of the trace's ``grouped_gemm_kernel``
launches (``csrc/moe_grouped_gemm.cu``; the decode forwards run as CUDA
graphs, inside which no span records).  The bound is of the window's
totals, a lower bound of the calls' summed bounds: the prefill's
compute-bound calls count only through the totals.  ``None`` without the
counters or the kernels."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    c = spans.counters()
    flops, moved = c.get("moe.flops"), c.get("moe.bytes")
    spent = sum(s for name, (_, s) in ctx["trace"].by_kernel.items()
                if "grouped_gemm_kernel" in name)
    if not flops or not moved or spent <= 0:
        return None
    bound = max(flops / ctx["peak_flops"], moved / ctx["peak_bytes"])
    return 100.0 * bound / spent
