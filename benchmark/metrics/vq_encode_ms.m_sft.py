"""Device milliseconds per training step of the MagViT-v2 encodes of the
batch assembly: the CUDA-event intervals of the ``vq.encode`` spans
(``models/magvit2.magvit_get_code``, two a step) over the window's
``train.step`` spans.  ``None`` without device times (on the CPU) or
spans."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    s = spans.summary()
    enc, step = s.get("vq.encode"), s.get("train.step")
    if not enc or not step or enc["device_s"] is None:
        return None
    return 1e3 * enc["device_s"] / step["n"]
