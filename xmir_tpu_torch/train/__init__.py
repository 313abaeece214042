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
    ConceptGather,
    dedupe_concept_batch,
    make_ath_train_step,
    make_conceptclip_train_step,
    make_distill_train_step,
    make_dual_branch_train_step,
    make_embed_fn,
    make_embedding_train_step,
    make_it_align_train_step,
    with_grad_accumulation,
)
