"""Data pipeline: the A trainer's annotation datasets, length-clustered
sampler and item processor; the M trainer's prompting, tar shards and
tokenizer wrapper; the native tar and token-store readers; and the ParaBench
adapter (``parabench``).  Counterpart of :mod:`mmada_parallel_tpu.data`."""

from mmada_parallel_torch.data.dataset import (  # noqa: F401
    MetaDataset, LengthClusteredSampler)
from mmada_parallel_torch.data.item_processor import AItemProcessor  # noqa: F401
from mmada_parallel_torch.data.prompting import UniversalPrompting  # noqa: F401
