"""Saliency (insertion / deletion) metric primitives (a copy of the numpy
xmir_tpu/metrics/saliency.py).

Matches reference evaluation.py:41-43 (normalized trapezoid AUC) and the
scoring convention of evaluation.py:100-110 (cosine similarity to the fixed
query embedding, clipped at 0 from below; clip events counted).
"""
from __future__ import annotations

import numpy as np


def auc(arr: np.ndarray) -> float:
    """Normalized trapezoid area under curve (reference evaluation.py:41-43)."""
    arr = np.asarray(arr, dtype=np.float64)
    return float((arr.sum() - arr[0] / 2 - arr[-1] / 2) / (arr.shape[0] - 1))


def clip_scores(scores: np.ndarray):
    """Clip negative similarity scores to 0, returning (clipped, n_clipped)."""
    scores = np.asarray(scores, dtype=np.float64)
    n_clipped = int((scores < 0).sum())
    return np.clip(scores, 0.0, None), n_clipped


def saliency_quality(del_auc: float, ins_auc: float) -> bool:
    """Reference quality heuristic: good = del < 0.6 and ins > 0.7
    (reference evaluate_test_dataset_milvus.py:688-700)."""
    return del_auc < 0.6 and ins_auc > 0.7
