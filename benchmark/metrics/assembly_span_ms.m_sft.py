"""Host milliseconds per training step inside ``cli/train_m.
assemble_batch``: its ``train_m.assemble`` span (the two MagViT-v2
encodes, the noising, the interleave rows), with no synchronize added,
over the window's ``train.step`` spans.  ``None`` where the program
records no spans."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    s = spans.summary()
    assemble, step = s.get("train_m.assemble"), s.get("train.step")
    if not assemble or not step:
        return None
    return 1e3 * assemble["host_s"] / step["n"]
