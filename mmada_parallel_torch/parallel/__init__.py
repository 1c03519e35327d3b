"""Meshes, parameter placement and distributed start-up on
``torch.distributed`` (:mod:`.mesh`).  The ring tensor parallelism of
:mod:`.tp_overlap` is imported by its users: it pulls model code, which this
package init must not."""

from mmada_parallel_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    PartitionSpec,
    init_distributed,
    make_mesh,
    shard_params,
)
