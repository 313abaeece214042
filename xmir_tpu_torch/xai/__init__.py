"""Explanations of a retrieval (port of xmir_tpu/xai): SBSM occlusion
saliency, the insertion / deletion causal metrics, SimAtt with the feature
heads, SimCAM and attention rollout. Grad-CAM similarity, the ConceptXAI
tools and the saliency variants come with ROADMAP.md section 1 item 7."""
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
from .feature_heads import convnext_head, densenet_head, get_feature_head  # noqa: F401
from .rollout import attention_rollout, rollout_saliency  # noqa: F401
from .sbsm import generate_masks, sbsm_pair_saliency, sbsm_self_saliency  # noqa: F401
from .simatt import simatt_saliency  # noqa: F401
from .simcam import (  # noqa: F401
    point_specific_map,
    simcam_decomposition,
    simcam_maps,
    simcam_vit_maps,
)
