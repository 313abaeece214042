"""Anomaly / OOD metrics: AUROC, AUPR, FPR@recall (a copy of the JAX
package's numpy module xmir_tpu/metrics/anomaly.py).

Behavioral match to reference anomaly/anomaly.py:27-82 (Hendrycks
outlier-exposure display_results), with sklearn replaced by numpy.
Convention: ``pos`` are the scores of the class to detect (outliers),
``neg`` the in-distribution scores; higher score = more anomalous.
"""
from __future__ import annotations

import numpy as np


def _roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the rank statistic (ties handled by midranks)."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = labels.sum()
    n_neg = (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = scores[order]
    # midranks for ties
    i = 0
    n = len(scores)
    base = np.arange(1, n + 1, dtype=np.float64)
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = base[i : j + 1].mean()
        i = j + 1
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    labels = np.asarray(labels, dtype=np.float64)
    scores = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-scores, kind="mergesort")
    labels = labels[order]
    scores_s = scores[order]
    distinct = np.where(np.diff(scores_s))[0]
    thresh_idx = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[thresh_idx]
    fps = 1 + thresh_idx - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def fpr_at_recall(labels, scores, recall_level=0.95) -> float:
    """FPR at the operating point closest to the given TPR
    (reference anomaly/anomaly.py:27-68)."""
    y_true = np.asarray(labels).astype(bool)
    y_score = np.asarray(scores, dtype=np.float64)
    desc = np.argsort(y_score, kind="mergesort")[::-1]
    y_score = y_score[desc]
    y_true = y_true[desc]
    distinct = np.where(np.diff(y_score))[0]
    thresh_idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[thresh_idx]
    fps = 1 + thresh_idx - tps
    recall = tps / tps[-1]
    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    recall = np.r_[recall[sl], 1]
    fps = np.r_[fps[sl], 0]
    cutoff = int(np.argmin(np.abs(recall - recall_level)))
    return float(fps[cutoff] / np.sum(~y_true))


def get_measures(pos, neg, recall_level=0.95):
    """(AUROC, AUPR, FPR@recall) — reference anomaly/anomaly.py:71-82."""
    pos = np.asarray(pos, dtype=np.float64).reshape(-1)
    neg = np.asarray(neg, dtype=np.float64).reshape(-1)
    scores = np.concatenate([pos, neg])
    labels = np.zeros(len(scores), dtype=np.int32)
    labels[: len(pos)] = 1
    auroc = _roc_auc(labels, scores)
    aupr = _average_precision(labels, scores)
    fpr = fpr_at_recall(labels, scores, recall_level)
    return auroc, aupr, fpr
