"""Deep-hashing retrieval evaluation (port of
xmir_tpu/analysis/hashing_eval.py; reference test_ath.py:57-200): Hamming
distance on sign-binarised codes (or L2 on real codes) -> mHR@K / mAP@K /
mRR@K / mP@K / R@K / majority accuracy, plus classification accuracy from
the type head.

The (Q, N) scores are one product on ``device`` (ops/distance.py), as the
JAX package computes them outside any Pallas kernel; the ranking is numpy's
stable argsort of them, so tied Hamming distances keep the gallery's order.
"""
from __future__ import annotations

from collections import Counter
from typing import Sequence

import numpy as np
import torch

from ..ops.distance import neg_hamming_scores, neg_l2_scores


def hash_retrieval_metrics(
    query_codes: np.ndarray,
    query_labels: np.ndarray,
    gallery_codes: np.ndarray,
    gallery_labels: np.ndarray,
    query_logits: np.ndarray | None = None,
    topk_values: Sequence[int] = (1, 5, 10),
    binary_codes: bool = True,
    *,
    device,
):
    score_fn = neg_hamming_scores if binary_codes else neg_l2_scores
    q = torch.as_tensor(np.asarray(query_codes, np.float32), device=device)
    g = torch.as_tensor(np.asarray(gallery_codes, np.float32), device=device)
    scores = score_fn(q, g).cpu().numpy()
    sorted_idx = np.argsort(-scores, axis=1, kind="stable")
    q_labels = np.asarray(query_labels)
    g_labels = np.asarray(gallery_labels)
    total_relevant = {
        int(c): int((g_labels == c).sum()) for c in np.unique(q_labels)
    }

    retrieval = {}
    for topk in topk_values:
        hit, ap, rr, vote, p_at_k, r_at_k = [], [], [], [], [], []
        for row in range(len(q_labels)):
            label = int(q_labels[row])
            ranked = g_labels[sorted_idx[row, :topk]]
            matches = (ranked == label).astype(np.int32)
            hit.append(float(matches.any()))
            n_rel = int(matches.sum())
            p_at_k.append(n_rel / topk)
            tot = total_relevant.get(label, 0)
            r_at_k.append(n_rel / tot if tot > 0 else 0.0)
            if n_rel == 0:
                ap.append(0.0)
                rr.append(0.0)
            else:
                first = None
                psum, pos = 0.0, 0
                for rank, m in enumerate(matches, start=1):
                    if m:
                        pos += 1
                        psum += pos / rank
                        if first is None:
                            first = rank
                ap.append(psum / pos)
                rr.append(1.0 / first)
            vote.append(
                float(Counter(ranked.tolist()).most_common(1)[0][0] == label)
            )
        retrieval[topk] = {
            "mhr": float(np.mean(hit)),
            "map": float(np.mean(ap)),
            "mrr": float(np.mean(rr)),
            "mp@k": float(np.mean(p_at_k)),
            "r@k": float(np.mean(r_at_k)),
            "majority_acc": float(np.mean(vote)),
        }
    out = {"retrieval": retrieval}
    if query_logits is not None:
        out["classification_acc"] = float(
            (np.argmax(query_logits, axis=1) == q_labels).mean()
        )
    return out


def binarize_codes(codes: np.ndarray) -> np.ndarray:
    """(code >= 0) binarization to {0, 1} (reference test_ath.py:66). Its
    output does not compose with the Hamming scores, which binarise by
    (code >= 0) again and so put every {0, 1} code at +1: the JAX package's
    behaviour, kept (ROADMAP.md section 3)."""
    return (np.asarray(codes) >= 0).astype(np.float32)
