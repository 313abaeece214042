"""Anomaly / OOD evaluation via class-centroid distances (a copy of the JAX
package's numpy module xmir_tpu/analysis/anomaly_eval.py; reference
anomaly/test_anomaly.py:16-77): centroids of the in-distribution
training classes; test score = min distance to any centroid, normalized by
its max; positives = held-out anomaly class -> AUROC / AUPR / FPR@95.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..metrics.anomaly import get_measures


def class_centroids(embeds: np.ndarray, labels: np.ndarray, classes: Sequence[int]):
    return np.stack([embeds[labels == c].mean(axis=0) for c in classes])


def anomaly_scores(test_embeds: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Min euclidean distance to any centroid, normalized to [0, 1]."""
    d = np.linalg.norm(
        test_embeds[:, None, :] - centroids[None, :, :], axis=-1
    ).min(axis=1)
    return d / max(d.max(), 1e-12)


def evaluate_anomaly(
    train_embeds: np.ndarray,
    train_labels: np.ndarray,
    test_embeds: np.ndarray,
    test_labels: np.ndarray,
    anomaly_class: int = 2,
    in_classes: Optional[Sequence[int]] = None,
    recall_level: float = 0.95,
):
    """Returns dict with auroc/aupr/fpr plus the raw scores."""
    if in_classes is None:
        in_classes = sorted(c for c in np.unique(train_labels) if c != anomaly_class)
    centroids = class_centroids(train_embeds, train_labels, in_classes)
    scores = anomaly_scores(test_embeds, centroids)
    pos = scores[test_labels == anomaly_class]
    neg = scores[test_labels != anomaly_class]
    auroc, aupr, fpr = get_measures(pos, neg, recall_level)
    return {
        "auroc": auroc,
        "aupr": aupr,
        f"fpr@{int(recall_level * 100)}": fpr,
        "scores": scores,
        "n_anomaly": int(len(pos)),
        "n_normal": int(len(neg)),
    }
