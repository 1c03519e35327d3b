"""Device milliseconds of the elementwise class (norms, SwiGLU, casts,
copies, the sampler's updates: every kernel that is no GEMM, attention,
softmax or reduction) per sequence-forward of the edit."""


def read(ctx):
    w, tr = ctx["work"], ctx["trace"]
    n = sum(f["count"] * f["B"] for f in w.get("forwards", ()))
    if not n:
        return None
    return 1e3 * tr.class_s("elementwise") / n
