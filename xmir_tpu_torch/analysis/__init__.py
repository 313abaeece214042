"""Analysis helpers (port of the zero-shot module of xmir_tpu/analysis)."""
from .zeroshot import (  # noqa: F401
    build_class_prompts,
    concept_profile_embeddings,
    text_rerank_scores,
    zero_shot_classify,
)
