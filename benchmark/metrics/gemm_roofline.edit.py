"""The bf16 GEMMs' share of the tensor cores' peak in the edit: the GEMM
operations the window's forwards need (block GEMMs at every position, the
head's spans), from shapes, at the bf16 peak, over the device time of the
bf16 tensor-core GEMM kernels."""

from benchmark.harness import counts


def read(ctx):
    w, tr = ctx["work"], ctx["trace"]
    spent = tr.class_s("bf16_gemm")
    if not w.get("forwards") or spent <= 0:
        return None
    flops = sum(counts.forward_flops(w["model"], f, attention=False)
                for f in w["forwards"])
    return 100.0 * flops / ctx["peak_flops"] / spent
