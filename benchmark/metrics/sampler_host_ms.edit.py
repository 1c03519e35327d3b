"""Host milliseconds per denoising step of the sampler's own updates: the
``ti2ti.text_update`` and ``ti2ti.image_update`` spans
(``samplers/parallel_ti2ti.make_ti2ti_step``) over the window's
``ti2ti.step`` spans.  Above ``sampler_ms.edit``, the updates are bound by
their launches.  ``None`` where the program records no spans."""


def read(ctx):
    try:
        from mmada_parallel_torch.utils import spans
    except ImportError:             # a program without the span store
        return None
    s = spans.summary()
    text, image = s.get("ti2ti.text_update"), s.get("ti2ti.image_update")
    if not s.get("ti2ti.step") or not text:
        return None
    host = text["host_s"] + (image["host_s"] if image else 0.0)
    return 1e3 * host / s["ti2ti.step"]["n"]
