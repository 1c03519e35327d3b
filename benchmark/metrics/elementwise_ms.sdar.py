"""Device milliseconds of the elementwise class (norms, RoPE's pre-pass
outside the kernels, casts, copies, the router's and the combine's
elementwise work, the sampler's commits: every kernel that is no GEMM,
attention, softmax or reduction) per decode forward of SDAR's block
generation: the window's class time over its steps' and writes' forwards
(``sdar_forwards`` with ``prefill`` false).  The prompts' prefill, one a
unit beside 320 decode forwards, is inside the class time."""


def read(ctx):
    w, tr = ctx["work"], ctx["trace"]
    n = sum(f["count"] for f in w.get("sdar_forwards", ())
            if not f["prefill"])
    if not n:
        return None
    return 1e3 * tr.class_s("elementwise") / n
