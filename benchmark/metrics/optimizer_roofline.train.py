"""The update's share of its memory bound: the bytes the window's applied
updates must move at the least (the program's ``train.update_bytes``
counter: a read and a write of each parameter and moment, a read of each
gradient) at 3.35 TB/s, over the device seconds of the ``train.update``
spans (``training/trainer._finish``).  ``None`` without device times (on
the CPU), spans or the counter."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    update = spans.summary().get("train.update")
    moved = spans.counters().get("train.update_bytes")
    if not update or not moved or not update["device_s"]:
        return None
    return 100.0 * moved / ctx["peak_bytes"] / update["device_s"]
