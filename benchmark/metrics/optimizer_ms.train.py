"""Device milliseconds per training step of the update: the CUDA-event
interval of the ``train.update`` span (``training/trainer._finish``: the
non-finite guard, the clip and ``Optimizer.update``) over the window's
``train.step`` spans.  ``None`` without device times (on the CPU) or
spans."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    s = spans.summary()
    update, step = s.get("train.update"), s.get("train.step")
    if not update or not step or update["device_s"] is None:
        return None
    return 1e3 * update["device_s"] / step["n"]
