"""K1's share of its roofline in a training step: the summed least time of
its forward calls (forward and remat's recompute) and its backward calls
(counted as 10 B H Lq Lk D operations), over the device time of the
attention forward and backward kernels."""

from benchmark.harness import counts


def read(ctx):
    w, tr = ctx["work"], ctx["trace"]
    calls = w.get("attention", ())
    spent = tr.class_s("attention") + tr.class_s("attention_bwd")
    if not w.get("train") or not calls or spent <= 0:
        return None
    bound = sum(counts.attention_bound_s(w["model"], c, ctx["peak_flops"],
                                         ctx["peak_bytes"]) for c in calls)
    return 100.0 * bound / spent
