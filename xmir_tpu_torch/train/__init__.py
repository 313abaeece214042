from .optim import (
    GroupedAdam,
    backbone_head_labels,
    build_optimizer,
    label_params,
    unfreeze_last_blocks_predicate,
)
from .state import TrainState
from .steps import (
    LOSS_FNS,
    make_distill_train_step,
    make_dual_branch_train_step,
    make_embed_fn,
    make_embedding_train_step,
    with_grad_accumulation,
)
