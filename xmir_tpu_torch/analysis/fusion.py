"""Late fusion of two embedding spaces (port of xmir_tpu/analysis/fusion.py;
reference fusion_eval/ package): embedding fusion (concat / weighted-sum
over alpha grid), score fusion with none/zscore/minmax normalization,
confidence fusion by top1-top2 margin, and the experiment runner producing
per-experiment retrieval metrics (through the port's metrics/retrieval.py).

The (N, N) self-similarity products run on ``device`` in f32 (TF32 as
PyTorch's switch says; the CLI turns it off); everything else is the JAX
package's numpy code on their host copies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def l2_normalize(e: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    n = np.maximum(np.linalg.norm(e, axis=1, keepdims=True), eps)
    return e / n


@dataclasses.dataclass
class EmbeddingSource:
    """An aligned embedding table: image_path -> (embedding, label)."""

    image_paths: List[str]
    labels: np.ndarray
    embeddings: np.ndarray

    @classmethod
    def from_npz(cls, path: str):
        data = np.load(path, allow_pickle=True)
        paths = [str(p) for p in data["paths"]] if "paths" in data else [
            str(p) for p in data.get("image_paths", [])
        ]
        return cls(paths, np.asarray(data["labels"]), np.asarray(data["embeds"]))


def align_sources(a: EmbeddingSource, b: EmbeddingSource):
    """Intersect two sources on image_path, preserving a's order
    (reference fusion_eval/align.py)."""
    b_index = {p: i for i, p in enumerate(b.image_paths)}
    keep_a, keep_b = [], []
    for i, p in enumerate(a.image_paths):
        j = b_index.get(p)
        if j is not None:
            keep_a.append(i)
            keep_b.append(j)
    if not keep_a:
        raise ValueError("no shared image paths between sources")
    paths = [a.image_paths[i] for i in keep_a]
    return (
        EmbeddingSource(paths, a.labels[keep_a], a.embeddings[keep_a]),
        EmbeddingSource(paths, b.labels[keep_b], b.embeddings[keep_b]),
    )


def concat_fusion(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return l2_normalize(np.concatenate([l2_normalize(a), l2_normalize(b)], axis=1))


def weighted_sum_fusion(a: np.ndarray, b: np.ndarray, alpha: float):
    """Returns fused embeddings or None if dims differ
    (reference fusion_eval/fuse.py:35-53)."""
    if a.shape[1] != b.shape[1]:
        return None
    return l2_normalize(alpha * l2_normalize(a) + (1.0 - alpha) * l2_normalize(b))


def _normalize_scores(s: np.ndarray, mode: str) -> np.ndarray:
    if mode == "none":
        return s
    if mode == "zscore":
        mu = s.mean(axis=1, keepdims=True)
        sd = s.std(axis=1, keepdims=True) + 1e-8
        return (s - mu) / sd
    if mode == "minmax":
        lo = s.min(axis=1, keepdims=True)
        hi = s.max(axis=1, keepdims=True)
        return (s - lo) / (hi - lo + 1e-8)
    raise ValueError(f"unknown score normalization {mode!r}")


def _self_sims(embeds: np.ndarray, device) -> np.ndarray:
    e = torch.as_tensor(np.asarray(l2_normalize(embeds), np.float32), device=device)
    return torch.matmul(e, e.T).cpu().numpy()


def score_fusion(sims_a: np.ndarray, sims_b: np.ndarray, alpha: float, norm="none"):
    """s = alpha * s_a + (1-alpha) * s_b (reference run_late_fusion.py)."""
    return alpha * _normalize_scores(sims_a, norm) + (1 - alpha) * _normalize_scores(
        sims_b, norm
    )


def confidence_fusion(sims_a: np.ndarray, sims_b: np.ndarray) -> np.ndarray:
    """Per query pick the ranking of the model with larger top1-top2 margin
    (reference run_late_fusion.py:24-33). Returns fused (N, N) scores built by
    selecting rows."""
    def margins(s):
        masked = s.copy()
        np.fill_diagonal(masked, -np.inf)
        part = np.sort(masked, axis=1)
        return part[:, -1] - part[:, -2]

    choose_a = margins(sims_a) >= margins(sims_b)
    fused = np.where(choose_a[:, None], sims_a, sims_b)
    return fused


def retrieval_metrics_from_scores(sims: np.ndarray, labels: np.ndarray,
                                  kappas=(1, 5, 10)):
    """mAP / mP@K / R@K on a similarity matrix with self excluded
    (reference fusion_eval/metrics.py)."""
    from ..metrics import compute_map, retrieval_recall_at_k

    sims = np.asarray(sims, np.float64).copy()
    np.fill_diagonal(sims, -np.inf)
    recalls = retrieval_recall_at_k(sims, labels, kappas)
    ranks = np.argsort(-sims, axis=1, kind="stable").T
    mAP, _, pr, _ = compute_map(ranks, labels, list(kappas))
    out = {"mAP": mAP * 100.0}
    for k, r, p in zip(kappas, recalls, pr):
        out[f"R@{k}"] = r
        out[f"mP@{k}"] = p * 100.0
    return out


def run_late_fusion_experiments(
    a: EmbeddingSource,
    b: EmbeddingSource,
    alphas: Sequence[float] = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8),
    include_score_fusion: bool = True,
    score_normalization: str = "none",
    include_confidence_fusion: bool = True,
    *,
    device,
) -> Dict[str, dict]:
    """Baselines + all fusion experiments on aligned sources
    (reference fusion_eval/evaluate.py:30-229); the similarity products on
    ``device``."""
    a, b = align_sources(a, b)
    labels = a.labels
    results = {}
    sa, sb = _self_sims(a.embeddings, device), _self_sims(b.embeddings, device)
    results["baseline_a"] = retrieval_metrics_from_scores(sa, labels)
    results["baseline_b"] = retrieval_metrics_from_scores(sb, labels)
    results["concat_fusion"] = retrieval_metrics_from_scores(
        _self_sims(concat_fusion(a.embeddings, b.embeddings), device), labels
    )
    for alpha in alphas:
        fused = weighted_sum_fusion(a.embeddings, b.embeddings, alpha)
        if fused is None:
            results[f"weighted_sum_alpha_{alpha}"] = {
                "skipped": "dimension_mismatch"
            }
        else:
            results[f"weighted_sum_alpha_{alpha}"] = retrieval_metrics_from_scores(
                _self_sims(fused, device), labels
            )
    if include_score_fusion:
        for alpha in alphas:
            results[f"score_fusion_alpha_{alpha}"] = retrieval_metrics_from_scores(
                score_fusion(sa, sb, alpha, score_normalization), labels
            )
    if include_confidence_fusion:
        results["confidence_fusion_top12_margin"] = retrieval_metrics_from_scores(
            confidence_fusion(sa, sb), labels
        )
    return results
