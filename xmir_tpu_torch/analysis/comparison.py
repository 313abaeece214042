"""Dual-model retrieval comparison (a copy of the JAX package's numpy module
xmir_tpu/analysis/comparison.py; reference retrieval_analysis/ package):
query two indexes, classify each query into agreement groups
(both_correct / both_wrong / a_correct_b_wrong / b_correct_a_wrong) by
top-1-majority correctness, export JSON/CSV and an HTML mismatch report
(reference comparison.py, export_utils.py, visualize_mismatches.py).
"""
from __future__ import annotations

import csv
import html
import json
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np


def majority_correct(retrieved_labels: Sequence, true_label, k: int = 5) -> bool:
    top = list(retrieved_labels)[:k]
    if not top:
        return False
    vote = Counter(top).most_common(1)[0][0]
    return vote == true_label


def compare_retrievers(
    queries: np.ndarray,
    query_labels: np.ndarray,
    query_paths: Sequence[str],
    index_a,
    index_b,
    k: int = 5,
    names=("model_a", "model_b"),
    queries_b: Optional[np.ndarray] = None,
) -> Dict[str, list]:
    """Returns {group_name: [case dict, ...]} over the four agreement groups.
    ``index_a`` / ``index_b``: anything with ``search_with_metadata``, such
    as a built ShardedGalleryIndex (its searches run K1 on the card).
    ``queries_b``: the same queries embedded by model B, where its space is
    not A's (the JAX CLI's inline copy of this loop; default ``queries``)."""
    hits_a = index_a.search_with_metadata(queries, k=k)
    hits_b = index_b.search_with_metadata(queries if queries_b is None else queries_b, k=k)
    groups: Dict[str, list] = {
        "both_correct": [],
        "both_wrong": [],
        f"{names[0]}_correct_{names[1]}_wrong": [],
        f"{names[1]}_correct_{names[0]}_wrong": [],
    }
    for i in range(len(query_labels)):
        true = query_labels[i].item() if hasattr(query_labels[i], "item") else query_labels[i]
        ca = majority_correct([h["label"] for h in hits_a[i]], true, k)
        cb = majority_correct([h["label"] for h in hits_b[i]], true, k)
        case = {
            "query_path": str(query_paths[i]),
            "query_label": true,
            names[0]: hits_a[i],
            names[1]: hits_b[i],
            f"{names[0]}_correct": ca,
            f"{names[1]}_correct": cb,
        }
        if ca and cb:
            groups["both_correct"].append(case)
        elif not ca and not cb:
            groups["both_wrong"].append(case)
        elif ca:
            groups[f"{names[0]}_correct_{names[1]}_wrong"].append(case)
        else:
            groups[f"{names[1]}_correct_{names[0]}_wrong"].append(case)
    return groups


def export_comparison(groups: Dict[str, list], out_dir: str, names=("model_a", "model_b")):
    """JSON + CSV summary export (reference export_utils.py:18-41)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "comparison_results.json"), "w") as f:
        json.dump(groups, f, indent=2, default=float)
    with open(os.path.join(out_dir, "comparison_results.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["group", "count", "fraction"])
        total = sum(len(v) for v in groups.values()) or 1
        for g, cases in groups.items():
            w.writerow([g, len(cases), len(cases) / total])
    return os.path.join(out_dir, "comparison_results.json")


def render_mismatch_html(
    groups: Dict[str, list],
    out_path: str,
    names=("model_a", "model_b"),
    max_cases: int = 50,
):
    """Case-card HTML report of disagreement groups
    (reference visualize_mismatches.py)."""
    parts = [
        "<html><head><meta charset='utf-8'><style>",
        "body{font-family:sans-serif;margin:2em;}",
        ".case{border:1px solid #ccc;margin:1em 0;padding:1em;border-radius:8px;}",
        ".hits{display:flex;gap:1em;} .model{flex:1;}",
        "img{max-width:120px;max-height:120px;}",
        "table{border-collapse:collapse;} td,th{border:1px solid #ddd;padding:4px;}",
        "</style></head><body><h1>Retrieval disagreement report</h1>",
    ]
    for g, cases in groups.items():
        if "correct_" not in g:
            continue
        parts.append(f"<h2>{html.escape(g)} ({len(cases)} cases)</h2>")
        for case in cases[:max_cases]:
            parts.append("<div class='case'>")
            parts.append(
                f"<b>query</b>: {html.escape(str(case['query_path']))} "
                f"(label {html.escape(str(case['query_label']))})"
            )
            parts.append("<div class='hits'>")
            for name in names:
                parts.append(f"<div class='model'><h4>{html.escape(name)}</h4><table>"
                             "<tr><th>path</th><th>label</th><th>sim</th></tr>")
                for h in case[name]:
                    parts.append(
                        f"<tr><td>{html.escape(str(h['image_path']))}</td>"
                        f"<td>{html.escape(str(h['label']))}</td>"
                        f"<td>{h['similarity']:.4f}</td></tr>"
                    )
                parts.append("</table></div>")
            parts.append("</div></div>")
    parts.append("</body></html>")
    with open(out_path, "w") as f:
        f.write("\n".join(parts))
    return out_path
