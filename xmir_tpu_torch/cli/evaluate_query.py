"""Offline evaluation of query-results JSON (port of
xmir_tpu/cli/evaluate_query.py, numpy only; reference evaluate_nih_zilliz.py:
ingest -> query -> evaluate from the saved JSON, no model needed).

Single-label: hit = same label. Multi-label: relevance = Jaccard(labels) >
threshold (default 0.4). Reports mAP (sklearn-style AP over result order) and
P@K / R@K at K in {1, 5, 10, 20, 50} (reference evaluate_nih_zilliz.py:34-64).
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _jaccard(a, b, eps=1e-8) -> float:
    a = np.asarray(a, np.float64).reshape(-1)
    b = np.asarray(b, np.float64).reshape(-1)
    inter = float((a * b).sum())
    union = float(np.clip(a + b, 0, 1).sum())
    return inter / (union + eps)


def _ap_from_relevance(rel) -> float:
    """Standard AP over an ordered binary relevance list."""
    rel = np.asarray(rel, np.float64)
    if rel.sum() == 0:
        return 0.0
    cum = np.cumsum(rel)
    precisions = cum[rel > 0] / (np.nonzero(rel)[0] + 1)
    return float(precisions.mean())


def evaluate_query_results(results, jaccard_threshold=0.4, k_values=(1, 5, 10, 20, 50)):
    aps, pk, rk = [], {k: [] for k in k_values}, {k: [] for k in k_values}
    for rec in results:
        q_label = rec["query_label"]
        multilabel = isinstance(q_label, (list, tuple)) and len(np.shape(q_label)) > 0
        rel = []
        for hit in rec["results"]:
            h_label = hit["label"]
            if multilabel:
                rel.append(1.0 if _jaccard(q_label, h_label) > jaccard_threshold else 0.0)
            else:
                rel.append(1.0 if h_label == q_label else 0.0)
        rel = np.asarray(rel)
        if rel.sum() > 0 or True:
            aps.append(_ap_from_relevance(rel))
        for k in k_values:
            kk = min(k, len(rel))
            if kk == 0:
                continue
            pk[k].append(float(rel[:kk].sum() / kk))
            rk[k].append(float(rel[:kk].any()))
    out = {"mAP": float(np.mean(aps) * 100.0) if aps else 0.0}
    for k in k_values:
        if pk[k]:
            out[f"P@{k}"] = float(np.mean(pk[k]) * 100.0)
            out[f"R@{k}"] = float(np.mean(rk[k]) * 100.0)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate saved query results JSON")
    p.add_argument("--results", required=True,
                   help="JSON from xmir_tpu_torch.cli.query")
    p.add_argument("--jaccard-threshold", default=0.4, type=float)
    p.add_argument("--k-values", default="1,5,10,20,50")
    p.add_argument("--output", default="")
    args = p.parse_args(argv)

    results = json.load(open(args.results))
    ks = tuple(int(k) for k in args.k_values.split(","))
    metrics = evaluate_query_results(results, args.jaccard_threshold, ks)
    print(f">> {len(results)} queries")
    print(f">> mAP: {metrics['mAP']:.2f}%")
    for k in ks:
        if f"P@{k}" in metrics:
            print(f"K={k:<4} P@K {metrics[f'P@{k}']:.2f}%   R@K {metrics[f'R@{k}']:.2f}%")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
