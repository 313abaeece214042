"""Retrieval metrics (port of xmir_tpu/metrics/retrieval.py), golden-matched to
the reference implementations:
  - R@K "any hit in top-K"            (reference test.py:38-54)
  - trapezoid AP / mAP / mP@K         (reference test.py:58-146,
                                       cnnimageretrieval-pytorch style)
  - majority-vote classification      (reference test.py:150-223)
  - multi-label Jaccard-threshold mAP (reference test.py:941-985)
  - multi-label P@K / R@K             (reference test.py:1020-1056)
  - train-time eval metrics           (reference train.py:399-487)

The score matrices are torch tensors on the embeddings' device, in float32;
the rank-walking aggregation is numpy on the host, unchanged from the JAX
package (tiny beside the matrix products).

Precision: the matrix products are f32 ``torch.matmul``s, so they follow
PyTorch's TF32 switch, which the CLIs set from ``--score-precision``
(cli/common.py::apply_score_precision: "highest", the default for offline
evaluation, is IEEE f32, as the reference ranks with f32 ``torch.cdist``).
That switch takes the place of the JAX package's ``XMIR_EVAL_PRECISION``.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

# ---------------------------------------------------------------------------
# similarity / distance matrices (device-side)
# ---------------------------------------------------------------------------


def pairwise_cosine(embeds: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """(N, D) -> (N, N) cosine similarity (inputs need not be pre-normalized)."""
    embeds = embeds.float()
    norms = torch.linalg.vector_norm(embeds, dim=1, keepdim=True)
    e = embeds / torch.clamp(norms, min=eps)
    return torch.matmul(e, e.T)


def pairwise_neg_l2(embeds: torch.Tensor) -> torch.Tensor:
    """Negative euclidean distance matrix, matching ``-torch.cdist(e, e)``.

    Reference test.py:1080 uses negative L2 so "higher == more similar".
    """
    embeds = embeds.float()
    sq = torch.sum(embeds * embeds, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * torch.matmul(embeds, embeds.T)
    d = -torch.sqrt(torch.clamp(d2, min=0.0))
    # cancellation can leave a ~eps residual on the diagonal, which the sqrt
    # amplifies; the true self-distance is exactly 0
    return d.masked_fill(torch.eye(embeds.shape[0], dtype=torch.bool, device=d.device), 0.0)


def fill_diagonal_neg_inf(sims: torch.Tensor) -> torch.Tensor:
    """Self-match exclusion (reference test.py:1081 ``fill_diagonal_(-inf)``)."""
    eye = torch.eye(sims.shape[0], dtype=torch.bool, device=sims.device)
    return sims.masked_fill(eye, float("-inf"))


def on_device(embeds, device=None) -> torch.Tensor:
    """``embeds`` as a float32 tensor on ``device``. A tensor may leave the
    device out and stays where it lies; an array names no device of its own,
    and there is no default one (as ShardedGalleryIndex.build has none): the
    caller says ``"cuda"``, or ``"cpu"`` where the CPU is meant."""
    if torch.is_tensor(embeds):
        return embeds.to(device=device, dtype=torch.float32)
    if device is None:
        raise ValueError("embeddings given as an array need a device: 'cuda' to score them on "
                         "the card, 'cpu' to ask for the CPU")
    return torch.as_tensor(np.asarray(embeds), dtype=torch.float32).to(device)


def _cosine_scores(embeds, device=None) -> np.ndarray:
    """The (N, N) cosine matrix with a -inf diagonal, computed on ``device``
    (see on_device), as a numpy array."""
    return fill_diagonal_neg_inf(pairwise_cosine(on_device(embeds, device))).cpu().numpy()


# ---------------------------------------------------------------------------
# single-label metrics (reference test.py)
# ---------------------------------------------------------------------------


def retrieval_recall_at_k(sims: np.ndarray, labels: np.ndarray, topk=(1, 5, 10)):
    """R@K: percentage of queries with >=1 same-label item in top-K.

    ``sims`` is an (N, N) "higher is more similar" matrix with the diagonal
    already set to -inf. Matches reference test.py:38-54 ``retrieval_accuracy``.
    """
    sims = np.asarray(sims)
    labels = np.asarray(labels)
    maxk = max(topk)
    n = labels.shape[0]
    pred = np.argsort(-sims, axis=1, kind="stable")[:, :maxk]  # (N, maxk)
    pred_labels = labels[pred]  # (N, maxk)
    correct = pred_labels == labels[:, None]
    return [float(correct[:, :k].any(axis=1).sum() * 100.0 / n) for k in topk]


def compute_ap(ranks: np.ndarray, nres: int) -> float:
    """Trapezoid average precision from zero-based ranks of positives.

    Matches reference test.py:58-92 (cnnimageretrieval-pytorch compute_ap).
    """
    ranks = np.asarray(ranks)
    nimgranks = len(ranks)
    ap = 0.0
    recall_step = 1.0 / nres
    for j in range(nimgranks):
        rank = ranks[j]
        precision_0 = 1.0 if rank == 0 else float(j) / rank
        precision_1 = float(j + 1) / (rank + 1)
        ap += (precision_0 + precision_1) * recall_step / 2.0
    return ap


def compute_map(ranks: np.ndarray, gnd: np.ndarray, kappas=()):
    """Mean trapezoid AP + precision@kappas.

    ``ranks``: (db_size, n_queries), column i = db indices sorted by similarity
    to query i. ``gnd``: per-item single labels; positives for query i are all
    items sharing its label (including i itself — the reference keeps self in
    the positive set; self is ranked last because of the -inf diagonal).
    Matches reference test.py:95-146.
    """
    ranks = np.asarray(ranks)
    gnd = np.asarray(gnd)
    nq = len(gnd)
    aps = np.zeros(nq)
    kappas = list(kappas)
    pr = np.zeros(len(kappas))
    prs = np.zeros((nq, len(kappas)))
    nempty = 0
    mAP = 0.0
    for i in range(nq):
        qgnd = np.where(gnd == gnd[i])[0]
        if qgnd.shape[0] == 0:
            aps[i] = np.nan
            prs[i, :] = np.nan
            nempty += 1
            continue
        pos = np.arange(ranks.shape[0])[np.isin(ranks[:, i], qgnd)]
        ap = compute_ap(pos, len(qgnd))
        mAP += ap
        aps[i] = ap
        pos = pos + 1  # 1-based
        for j in range(len(kappas)):
            kq = min(np.max(pos), kappas[j])
            prs[i, j] = (pos <= kq).sum() / kq
        pr += prs[i, :]
    denom = max(nq - nempty, 1)
    return mAP / denom, aps, pr / denom, prs


def majority_vote(retrieved_labels):
    """Most common label among retrieved items (reference test.py:150-161)."""
    if len(retrieved_labels) == 0:
        return None
    return Counter(list(retrieved_labels)).most_common(1)[0][0]


def _prf(true_labels, pred_labels, average: str):
    """Macro / weighted precision-recall-F1 with sklearn zero_division=0
    semantics, implemented in numpy (no sklearn dependency)."""
    true_labels = np.asarray(true_labels)
    pred_labels = np.asarray(pred_labels)
    classes = np.unique(np.concatenate([true_labels, pred_labels]))
    precisions, recalls, f1s, supports = [], [], [], []
    for c in classes:
        tp = np.sum((pred_labels == c) & (true_labels == c))
        fp = np.sum((pred_labels == c) & (true_labels != c))
        fn = np.sum((pred_labels != c) & (true_labels == c))
        p = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        r = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
        precisions.append(p)
        recalls.append(r)
        f1s.append(f)
        supports.append(np.sum(true_labels == c))
    precisions = np.array(precisions)
    recalls = np.array(recalls)
    f1s = np.array(f1s)
    supports = np.array(supports, dtype=np.float64)
    if average == "macro":
        return float(precisions.mean()), float(recalls.mean()), float(f1s.mean())
    w = supports / supports.sum()
    return (
        float((precisions * w).sum()),
        float((recalls * w).sum()),
        float((f1s * w).sum()),
    )


def compute_classification_metrics(labels, sims, k_values=(1, 5, 10, 15, 20)):
    """Majority-vote classification P/R/F1/accuracy at several K.

    ``sims``: (N, N), higher = more similar, diagonal -inf. Note the reference
    (test.py:164-223) ranks with ``argsort(dists, dim=0, descending=True)`` and
    then indexes ``ranks[:k, i]`` — i.e. it ranks along axis 0 (treating column
    i as the scores of query i); for symmetric matrices the two conventions
    coincide.
    """
    labels_np = np.asarray(labels)
    sims = np.asarray(sims)
    n = labels_np.shape[0]
    ranks = np.argsort(-sims, axis=0, kind="stable")
    results = {}
    for k in k_values:
        preds = []
        for i in range(n):
            preds.append(majority_vote(labels_np[ranks[:k, i]]))
        preds = np.asarray(preds)
        pm, rm, fm = _prf(labels_np, preds, "macro")
        pw, rw, fw = _prf(labels_np, preds, "weighted")
        acc = float(np.mean(preds == labels_np))
        results[k] = {
            "precision_macro": pm * 100.0,
            "recall_macro": rm * 100.0,
            "f1_macro": fm * 100.0,
            "precision_weighted": pw * 100.0,
            "recall_weighted": rw * 100.0,
            "f1_weighted": fw * 100.0,
            "accuracy": acc * 100.0,
        }
    return results


# ---------------------------------------------------------------------------
# multi-label metrics (reference test.py:941-1062)
# ---------------------------------------------------------------------------


def jaccard_matrix(labels: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """(N, C) multi-hot -> (N, N) Jaccard similarity."""
    labels = np.asarray(labels, dtype=np.float64)
    inter = labels @ labels.T
    sums = labels.sum(axis=1).reshape(-1, 1)
    union = sums + sums.T - inter
    return inter / (union + eps)


def compute_map_multilabel(sims, labels, threshold=0.5):
    """Jaccard-threshold multi-label mAP (reference test.py:941-985).

    AP here is the standard "precision at each hit" AP, not trapezoid.
    """
    sims = np.asarray(sims)
    labels = np.asarray(labels)
    jac = jaccard_matrix(labels)
    ranks = np.argsort(-sims, axis=0, kind="stable")
    aps = []
    nq = labels.shape[0]
    for i in range(nq):
        rel = (jac[i] > threshold).astype(np.float64)
        rel[i] = 0.0
        npos = rel.sum()
        if npos > 0:
            sorted_rel = rel[ranks[:, i]]
            count_pos = 0
            ap = 0.0
            for rank, is_rel in enumerate(sorted_rel):
                if is_rel > 0:
                    count_pos += 1
                    ap += count_pos / (rank + 1)
            aps.append(ap / npos)
    return float(np.mean(aps)) if aps else 0.0


def multilabel_precision_recall_at_k(sims, labels, k_values=(1, 5, 10, 15, 20)):
    """Multi-label P@K (fraction of top-K sharing >=1 label) and R@K (any-hit).

    Matches reference test.py:1020-1056.
    """
    sims = np.asarray(sims)
    labels = np.asarray(labels)
    ranks = np.argsort(-sims, axis=1, kind="stable")
    nq = labels.shape[0]
    out = {}
    for k in k_values:
        total_p, total_r = 0.0, 0.0
        for i in range(nq):
            top_k_labels = labels[ranks[i, :k]]
            matches = (top_k_labels * labels[i]).sum(axis=1) > 0
            nm = matches.sum()
            total_p += nm / k
            if nm > 0:
                total_r += 1.0
        out[k] = {
            "precision": total_p / nq * 100.0,
            "recall": total_r / nq * 100.0,
        }
    return out


# ---------------------------------------------------------------------------
# train-time eval metrics (reference train.py:399-487)
# ---------------------------------------------------------------------------


def train_eval_single_label(embeds, labels, topk=(1, 5, 10), device=None):
    """Cosine-similarity mAP + R@K used during training eval.

    AP = sum over hits of (cum_hits / rank) / (total relevant in gallery);
    queries with no relevant items contribute AP=0 (reference train.py:399-441).
    Arrays need ``device`` named; a tensor is scored where it lies (on_device).
    """
    labels = np.asarray(labels).reshape(-1)
    n = len(labels)
    if n <= 1:
        return {"mAP": 0.0, **{f"R@{k}": 0.0 for k in topk}}
    sims = _cosine_scores(embeds, device)
    # reference train.py:409 ranks only the top n-1 items, so the query itself
    # (forced to the tail by the -inf diagonal) never counts as a hit
    ranked = np.argsort(-sims, axis=1, kind="stable")[:, : max(1, n - 1)]
    ranked_labels = labels[ranked]
    relevant = ranked_labels == labels[:, None]
    relevant_counts = (labels[:, None] == labels[None, :]).sum(axis=1) - 1
    aps = []
    for i in range(n):
        if relevant_counts[i] <= 0:
            aps.append(0.0)
            continue
        rel = relevant[i].astype(np.float64)
        hits = np.nonzero(rel)[0]
        if hits.size == 0:
            aps.append(0.0)
            continue
        cum = np.cumsum(rel)
        precisions = cum[hits] / (hits + 1.0)
        aps.append(precisions.sum() / relevant_counts[i])
    metrics = {"mAP": float(np.mean(aps) * 100.0)}
    for k in topk:
        actual_k = min(k, n - 1)
        metrics[f"R@{k}"] = float(relevant[:, :actual_k].any(axis=1).mean() * 100.0)
    return metrics


def _average_precision_score(y_true, y_score):
    """sklearn.metrics.average_precision_score for binary y_true (numpy)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(-y_score, kind="mergesort")
    y_true = y_true[order]
    y_score = y_score[order]
    distinct = np.where(np.diff(y_score))[0]
    thresh_idx = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true)[thresh_idx]
    fps = 1 + thresh_idx - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    # AP = sum (R_n - R_{n-1}) * P_n  (step interpolation)
    recall_prev = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - recall_prev) * precision))


def train_eval_multilabel(embeds, labels, topk=(1, 5, 10), relevance_threshold=0.4,
                          device=None):
    """Multi-label train-time eval: sklearn-style AP over cosine scores with
    Jaccard>threshold relevance, self excluded (reference train.py:444-487).
    The device as in train_eval_single_label."""
    labels = np.asarray(labels, dtype=np.float64)
    n = labels.shape[0]
    if n <= 1:
        return {"mAP": 0.0, **{f"R@{k}": 0.0 for k in topk}}
    sims = _cosine_scores(embeds, device)
    ranked = np.argsort(-sims, axis=1, kind="stable")
    jac = jaccard_matrix(labels)
    aps = []
    recalls = {k: [] for k in topk}
    for i in range(n):
        rel = (jac[i] > relevance_threshold).astype(np.float64)
        rel[i] = 0.0
        if rel.sum() > 0:
            mask = np.ones(n, dtype=bool)
            mask[i] = False
            aps.append(_average_precision_score(rel[mask], sims[i][mask]))
        ranked_rel = rel[ranked[i]]
        for k in topk:
            actual_k = min(k, n)
            recalls[k].append(float(ranked_rel[:actual_k].any()) if actual_k else 0.0)
    metrics = {"mAP": float(np.mean(aps) * 100.0) if aps else 0.0}
    for k in topk:
        metrics[f"R@{k}"] = float(np.mean(recalls[k]) * 100.0) if recalls[k] else 0.0
    return metrics
