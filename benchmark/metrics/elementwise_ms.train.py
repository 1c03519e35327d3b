"""Device milliseconds of the elementwise class (norms, SwiGLU, casts,
copies, the optimizer's updates) per training step."""


def read(ctx):
    w, tr = ctx["work"], ctx["trace"]
    if not w.get("train"):
        return None
    return 1e3 * tr.class_s("elementwise") / w["train"]["steps"]
