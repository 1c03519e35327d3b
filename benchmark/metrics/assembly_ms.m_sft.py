"""Wall milliseconds per step inside ``cli/train_m.assemble_batch`` (the
two MagViT-v2 encodes, the noising and the interleave rows), timed by the
benchmark around the call up to a synchronize in the traced run."""


def read(ctx):
    times = ctx["work"].get("assembly_s")
    if not times:
        return None
    return 1e3 * sum(times) / len(times)
