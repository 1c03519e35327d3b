"""Model FLOPs utilisation of a training step: three times the forward
operations of the matmuls at the positions each sees (block GEMMs, the
head), plus attention's forward and its backward at twice the forward,
over the window's wall times the card's bf16 peak.  Remat's recompute and
the tokenizer's encodes are not counted."""

from benchmark.harness import counts


def read(ctx):
    w = ctx["work"]
    if not w.get("train"):
        return None
    f = counts.train_step_flops(w["model"], w["train"])
    flops = 3 * (f["gemm_block"] + f["gemm_head"] + f["attention"])
    return (100.0 * flops * w["train"]["steps"]
            / (ctx["window_s"] * ctx["peak_flops"]))
