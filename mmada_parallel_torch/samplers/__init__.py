"""Samplers: the variant-A joint text+image denoiser, variant-M interleave
generation, text-to-image (A and M), multimodal understanding and the
streaming stepwise generators."""

from mmada_parallel_torch.samplers.image_gen import (  # noqa: F401
    ImageGenOptions,
    generate_image,
    generate_image_cached,
)
from mmada_parallel_torch.samplers.interleave import (  # noqa: F401
    InterleaveOptions,
    interleave_generate,
)
from mmada_parallel_torch.samplers.mmu import (  # noqa: F401
    MMUOptions,
    mmu_generate,
    mmu_generate_fast,
)
from mmada_parallel_torch.samplers.parallel_ti2ti import (  # noqa: F401
    TI2TIOptions,
    generate_ti2ti,
)
from mmada_parallel_torch.samplers.t2i import (  # noqa: F401
    T2IOptions,
    t2i_generate,
)
