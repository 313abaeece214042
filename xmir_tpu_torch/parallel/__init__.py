from .mesh import (
    FSDP_MIN_SIZE,
    TP_MIN_DIM,
    Mesh,
    auto_param_shardings,
    fsdp_shard_axis,
    fsdp_state_shardings,
    make_mesh,
    replicate_tree,
    shard_batch,
    tp_shard_axis,
)
