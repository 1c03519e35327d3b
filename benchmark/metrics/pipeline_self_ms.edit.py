"""Host milliseconds per edit of the pipeline's own work: the ``edit``
span of ``pipeline.TI2TIPipeline.__call__`` less its ``edit.sample``
child (the sampler call), which leaves the tokenize, the Amused-VQ encode,
the sequence assembly, the text and VQ decode and the glue between them.
``None`` where the program records no spans."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    s = spans.summary()
    edit, sample = s.get("edit"), s.get("edit.sample")
    if not edit or not sample:
        return None
    return 1e3 * (edit["host_s"] - sample["host_s"]) / edit["n"]
