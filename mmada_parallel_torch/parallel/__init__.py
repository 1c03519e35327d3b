"""Meshes, parameter and optimizer-state placement and distributed start-up
on ``torch.distributed`` (:mod:`.mesh`); FSDP's collectives in
:mod:`.fsdp`.  The ring tensor parallelism of
:mod:`.tp_overlap` is imported by its users: it pulls model code, which this
package init must not."""

from mmada_parallel_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    PartitionSpec,
    batch_sharding,
    drop_axis,
    init_distributed,
    local_rows,
    make_mesh,
    opt_state_specs,
    replicated,
    shard_opt_state,
    shard_params,
)
