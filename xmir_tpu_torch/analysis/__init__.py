"""Analysis helpers (port of xmir_tpu/analysis): embedding ensembles, late
fusion, dual-model comparison, anomaly and hashing evaluation, zero-shot
classification and the insertion / deletion reports."""
from .ensemble import ensemble_embeddings  # noqa: F401
from .fusion import (  # noqa: F401
    EmbeddingSource,
    align_sources,
    concat_fusion,
    confidence_fusion,
    retrieval_metrics_from_scores,
    run_late_fusion_experiments,
    score_fusion,
    weighted_sum_fusion,
)
from .comparison import (  # noqa: F401
    compare_retrievers,
    export_comparison,
    render_mismatch_html,
)
from .anomaly_eval import anomaly_scores, class_centroids, evaluate_anomaly  # noqa: F401
from .hashing_eval import binarize_codes, hash_retrieval_metrics  # noqa: F401
from .zeroshot import (  # noqa: F401
    build_class_prompts,
    concept_profile_embeddings,
    text_rerank_scores,
    zero_shot_classify,
)
from .reports import (  # noqa: F401
    analyze_insertion_deletion,
    overlay_saliency,
    render_overlays_from_results,
)
