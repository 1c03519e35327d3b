"""Device milliseconds of the experts a decode forward: the trace's
small-tile ``grouped_gemm_kernel`` launches (``csrc/moe_grouped_gemm.cu``
at 16 rows a tile, which the decode forwards take: the gate/up and down
launches of all 48 layers) over the window's ``mmu.step`` and
``mmu.write`` spans (``samplers/mmu.py``'s block-causal route, one a
decode forward).  ``None`` without those spans or kernels."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    top = spans.summary()
    n = sum(top[name]["n"] for name in ("mmu.step", "mmu.write")
            if name in top)
    spent = sum(s for name, (_, s) in ctx["trace"].by_kernel.items()
                if "grouped_gemm_kernel<16," in name)
    if not n or spent <= 0:
        return None
    return 1e3 * spent / n
