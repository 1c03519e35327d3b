"""The tokenizers' fused GroupNorm + swish at its memory bound: the bytes
its calls must move at the least (the program's ``vq.norm_bytes`` counter:
one read of each input and one write of each output) at 3.35 TB/s, over
the device seconds of the ``vq.norm`` spans
(``models/vqgan_common.norm_swish``, inside the MagViT-v2 encodes of the
batch assembly).  ``None`` without device times (on the CPU), spans or the
counter, as from a program without the fused call."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    norm = spans.summary().get("vq.norm")
    moved = spans.counters().get("vq.norm_bytes")
    if not norm or not moved or not norm["device_s"]:
        return None
    return 100.0 * moved / ctx["peak_bytes"] / norm["device_s"]
