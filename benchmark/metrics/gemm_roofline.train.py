"""The bf16 GEMMs' share of the tensor cores' peak in a training step: the
block GEMMs four times (forward, remat's recompute, and the two backward
products) and the head three times, from shapes, at the bf16 peak, over
the device time of the bf16 tensor-core GEMM kernels."""

from benchmark.harness import counts


def read(ctx):
    w, tr = ctx["work"], ctx["trace"]
    spent = tr.class_s("bf16_gemm")
    if not w.get("train") or spent <= 0:
        return None
    f = counts.train_step_flops(w["model"], w["train"])
    passes = 4 if w["train"]["remat"] else 3
    flops = (passes * f["gemm_block"] + 3 * f["gemm_head"]) * w["train"][
        "steps"]
    return 100.0 * flops / ctx["peak_flops"] / spent
