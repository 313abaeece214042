from .metric_losses import (
    l2_normalize,
    pairwise_distance,
    batch_all_triplet_loss,
    batch_hard_triplet_loss,
    triplet_margin_loss,
    supcon_loss,
    jaccard_similarity,
    weighted_multilabel_triplet_loss,
    jaccard_supcon_loss,
    asymmetric_loss,
    multilabel_contrastive_loss,
    dual_branch_multilabel_loss,
    triplet_hash_loss,
)
from .align import LOG_SCALE_MAX, conceptclip_loss, it_align_loss, rc_align_loss


def auto_select_loss(dataset: str, model: str | None = None) -> str:
    """Loss auto-selection policy (reference train.py:681-689)."""
    if model == "conceptclip" and dataset == "vindr":
        return "conceptclip"
    if dataset == "nih":
        return "jaccard_supcon"
    if dataset == "vindr":
        return "weighted_multilabel_triplet"
    return "triplet"
