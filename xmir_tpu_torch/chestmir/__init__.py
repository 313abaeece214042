"""ChestMIR (port of xmir_tpu/chestmir): lesion detection by fold x TTA with
WBF, region embeddings and the two-stage lesion rerank; the same exports."""
from .lesions import (
    LESION_ALIAS_TO_CANON,
    VINDR_DETECTOR_CLASSES,
    canonical_lesion_name,
)
from .wbf import (
    hflip_boxes,
    letterbox_image,
    letterbox_params,
    nms,
    scale_boxes_back,
    weighted_boxes_fusion,
    xywh2xyxy,
)
from .inference import (
    bbox_rot90,
    flip_hor_boxes,
    get_tta_pair,
    merge_predictions,
    non_max_suppression,
    predict_image,
    run_detector,
    run_single_tta,
    scale_coords,
)
from .region import crop_box, detections_with_tta_folds, embed_regions
from .two_stage import (
    build_lesion_map,
    evaluate_rankings,
    rerank_with_adaptive_lesion,
    rerank_with_specific_lesion,
    similarity_to_ranks,
    two_stage_eval,
)
from .detection_service import (
    CLASS_ID_TO_VI,
    DiseaseDetectionService,
    draw_detections,
)
