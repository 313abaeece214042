"""Explanations of a retrieval (port of xmir_tpu/xai): SBSM occlusion
saliency and the insertion / deletion causal metrics. SimAtt, SimCAM, the
feature heads and attention rollout come with ROADMAP.md section 1 item 3;
Grad-CAM similarity, the ConceptXAI tools and the saliency variants with
item 7."""
from .causal import (  # noqa: F401
    auto_batch_steps,
    blur_substrate,
    causal_scores,
    causal_scores_batch,
    run_causal_metric,
    run_causal_metric_pairs,
    run_causal_metric_pairs_both,
    saliency_rank,
    zeros_substrate,
)
from .sbsm import generate_masks, sbsm_pair_saliency, sbsm_self_saliency  # noqa: F401
