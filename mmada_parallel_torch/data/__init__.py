"""The A trainer's data pipeline: annotation datasets, the length-clustered
sampler and the item processor; and the ParaBench adapter (``parabench``).
Counterpart of :mod:`mmada_parallel_tpu.data`, without its M-side
prompting."""

from mmada_parallel_torch.data.dataset import (  # noqa: F401
    MetaDataset, LengthClusteredSampler)
from mmada_parallel_torch.data.item_processor import AItemProcessor  # noqa: F401
