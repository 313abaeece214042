"""Result analysis + visualization (a copy of the JAX package's numpy module
xmir_tpu/analysis/reports.py; reference analyze_evaluation_results.py,
draw_overlay_from_json.py): summary statistics and per-class breakdowns of
insertion/deletion JSON results, and saliency-overlay rendering."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Optional, Sequence

import numpy as np


def analyze_insertion_deletion(results_path: str) -> Dict:
    """Aggregate an evaluate_saliency JSON: overall + per-class mean ins/del
    AUC, quality-heuristic pass rate (good = del<0.6 and ins>0.7,
    evaluate_test_dataset_milvus.py:688-700)."""
    payload = json.load(open(results_path))
    results = payload["results"] if "results" in payload else payload
    per_class = defaultdict(lambda: {"del": [], "ins": []})
    all_del, all_ins, good = [], [], 0
    for rec in results:
        label = rec.get("query_label")
        key = str(label)
        d, i = rec["deletion_auc"], rec["insertion_auc"]
        per_class[key]["del"].append(d)
        per_class[key]["ins"].append(i)
        all_del.append(d)
        all_ins.append(i)
        if d < 0.6 and i > 0.7:
            good += 1
    summary = {
        "n_queries": len(results),
        "mean_deletion_auc": float(np.mean(all_del)) if all_del else None,
        "mean_insertion_auc": float(np.mean(all_ins)) if all_ins else None,
        "good_saliency_rate": good / len(results) if results else 0.0,
        "per_class": {
            k: {
                "n": len(v["del"]),
                "mean_deletion_auc": float(np.mean(v["del"])),
                "mean_insertion_auc": float(np.mean(v["ins"])),
            }
            for k, v in sorted(per_class.items())
        },
    }
    return summary


def overlay_saliency(
    image: np.ndarray,
    saliency: np.ndarray,
    alpha: float = 0.5,
    colormap: str = "jet",
) -> np.ndarray:
    """Blend a saliency map over an image (reference
    draw_overlay_from_json.py). image uint8 HWC, saliency (h, w) any scale.
    Returns uint8 HWC."""
    from PIL import Image

    h, w = image.shape[:2]
    sal = np.asarray(saliency, np.float32)
    lo, hi = sal.min(), sal.max()
    sal = (sal - lo) / (hi - lo + 1e-12)
    if sal.shape != (h, w):
        sal = np.asarray(
            Image.fromarray((sal * 255).astype(np.uint8)).resize((w, h)), np.float32
        ) / 255.0
    heat = _apply_colormap(sal, colormap)
    out = (1 - alpha) * image.astype(np.float32) + alpha * heat
    return np.clip(out, 0, 255).astype(np.uint8)


def _apply_colormap(x: np.ndarray, name: str) -> np.ndarray:
    """Minimal jet/viridis-like colormaps, no matplotlib dependency."""
    x = np.clip(x, 0.0, 1.0)
    if name == "jet":
        r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
    elif name == "gray":
        r = g = b = x
    else:
        raise ValueError(f"unknown colormap {name!r}")
    return np.stack([r, g, b], axis=-1) * 255.0


def render_overlays_from_results(
    results_path: str,
    dataset,
    saliency_dir: str,
    out_dir: str,
    limit: int = 20,
):
    """Render saliency overlays for the first `limit` query-retrieval pairs
    referenced by an evaluate_saliency JSON."""
    import os

    from PIL import Image

    payload = json.load(open(results_path))
    results = payload.get("results", payload)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for rec in results[:limit]:
        qi = rec["query_index"]
        for r in rec["retrieved"]:
            sal_path = os.path.join(saliency_dir, f"sal_q{qi:05d}_r{int(r):05d}.npy")
            if not os.path.exists(sal_path):
                continue
            sal = np.load(sal_path)
            img = dataset.load_image(int(r))
            out = overlay_saliency(img, sal)
            path = os.path.join(out_dir, f"overlay_q{qi:05d}_r{int(r):05d}.png")
            Image.fromarray(out).save(path)
            written.append(path)
    return written
