from .mesh import (
    FSDP_MIN_SIZE,
    Mesh,
    fsdp_shard_axis,
    fsdp_state_shardings,
    make_mesh,
    replicate_tree,
    shard_batch,
)
