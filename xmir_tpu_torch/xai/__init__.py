"""Explanations of a retrieval (port of xmir_tpu/xai): SBSM occlusion
saliency, the insertion / deletion causal metrics, SimAtt with the feature
heads, SimCAM, attention rollout, Grad-CAM on a similarity, ConceptCLIP's
patch-concept explanations and the saliency variants (masked-query and
feature SBSM, FSal, FSalGrad, SimScoreCAM)."""
from .causal import (  # noqa: F401
    auto_batch_steps,
    blur_substrate,
    causal_scores,
    causal_scores_batch,
    causal_scores_batch_mesh,
    run_causal_metric,
    run_causal_metric_pairs,
    run_causal_metric_pairs_both,
    saliency_rank,
    zeros_substrate,
)
from .feature_heads import convnext_head, densenet_head, get_feature_head  # noqa: F401
from .rollout import attention_rollout, rollout_saliency  # noqa: F401
from .sbsm import (  # noqa: F401
    generate_masks,
    sbsm_pair_saliency,
    sbsm_pair_saliency_mesh,
    sbsm_self_saliency,
    sbsm_self_saliency_mesh,
)
from .simatt import simatt_saliency  # noqa: F401
from .simcam import (  # noqa: F401
    point_specific_map,
    simcam_decomposition,
    simcam_maps,
    simcam_vit_maps,
)
from .variants import (  # noqa: F401
    ProbeClassifier,
    fsal_grad_saliency,
    fsal_saliency,
    gaussian_blur_normed,
    sbsm_feature_saliency,
    sbsm_masked_query_saliency,
    sim_score_cam,
    transform_query,
)
from .gradcam_sim import make_vit_gradcam_fn, vit_gradcam_similarity  # noqa: F401
from .conceptxai import (  # noqa: F401
    attention_heatmap,
    detect_patch_grid,
    explain_retrieval,
    patch_concept_attention,
    text_explanation,
)
