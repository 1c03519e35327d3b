"""K1's share of its roofline in the edit: the summed least time of the
window's K1 calls (the larger of operations over the bf16 peak and bytes
over the memory rate, by shape) over the device time of the attention
kernels (the rotation pre-pass and the warp-specialised body)."""

from benchmark.harness import counts


def read(ctx):
    w, tr = ctx["work"], ctx["trace"]
    calls = [c for c in w.get("attention", ()) if not c["bwd"]]
    spent = tr.class_s("attention")
    if not calls or spent <= 0:
        return None
    bound = sum(counts.attention_bound_s(w["model"], c, ctx["peak_flops"],
                                         ctx["peak_bytes"]) for c in calls)
    return 100.0 * bound / spent
