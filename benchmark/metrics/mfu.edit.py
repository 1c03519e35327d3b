"""Model FLOPs utilisation of the edit: the operations of the forwards the
window ran, counted from shapes (block GEMMs, attention, the head's text
and image spans), over the window's wall times the card's bf16 peak."""

from benchmark.harness import counts


def read(ctx):
    w = ctx["work"]
    if not w.get("forwards"):
        return None
    flops = sum(counts.forward_flops(w["model"], f) for f in w["forwards"])
    return 100.0 * flops / (ctx["window_s"] * ctx["peak_flops"])
