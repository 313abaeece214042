from .retrieval import (  # noqa: F401
    compute_ap,
    compute_classification_metrics,
    compute_map,
    compute_map_multilabel,
    fill_diagonal_neg_inf,
    jaccard_matrix,
    majority_vote,
    multilabel_precision_recall_at_k,
    on_device,
    pairwise_cosine,
    pairwise_neg_l2,
    retrieval_recall_at_k,
    train_eval_multilabel,
    train_eval_single_label,
)
from .anomaly import fpr_at_recall, get_measures  # noqa: F401
from .saliency import auc, clip_scores, saliency_quality  # noqa: F401
