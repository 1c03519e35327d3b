"""SDAR's share of the whole step's roofline: the summed least time of the
window's forwards (the prompts' prefill, the blocks' steps and writes,
each the larger of its model operations at the bf16 peak and its least
bytes at the memory rate: ``harness/moe_counts.py``) over the window's
wall.  The steps' and writes' experts are the program's
``moe.experts_touched`` counter less the prefills'.  ``None`` without the
counter (a program without the mixture of experts) or the forwards."""

from benchmark.harness import moe_counts


def read(ctx):
    w = ctx["work"]
    if not w.get("sdar_forwards"):
        return None
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    touched = spans.counters().get("moe.experts_touched")
    if not touched:
        return None
    bound = moe_counts.window_bound_s(w["model"], w["sdar_forwards"],
                                      touched, ctx["peak_flops"],
                                      ctx["peak_bytes"])
    return 100.0 * bound / ctx["window_s"]
