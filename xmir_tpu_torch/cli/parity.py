"""Parity harness (port of xmir_tpu/cli/parity.py): replay an evaluation
artifact through the port's metric stack and check the numbers agree.

The reference's test.py saves ``evaluation_results.npz`` with embeds / labels
/ dists / metrics (test.py:1122-1126), as ``cli.test`` of either package
does. This CLI recomputes every metric from the stored embeddings (or the
stored distance matrix) through the code path of the port's ``cli.test`` and
compares them with the stored ``metrics`` JSON: an artifact made on the
reference stack proves quality parity here without its dataset or weights.

    python -m xmir_tpu_torch.cli.parity --results evaluation_results.npz

The similarity matrix is computed on the CPU in IEEE f32, as ``cli.test``'s
default ``--score-precision highest`` computes it. Exit code 1 when a metric
disagrees.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _flatten(d, prefix=""):
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        elif isinstance(v, (int, float, np.floating, np.integer)):
            out[key] = float(v)
    return out


def compare_metrics(computed: dict, stored: dict, rtol: float = 1e-5, atol: float = 1e-6):
    """Flat numeric comparison. Returns (rows, mismatches)."""
    flat_c, flat_s = _flatten(computed), _flatten(stored)
    rows, mismatches = [], []
    for key in sorted(flat_s):
        if key not in flat_c:
            rows.append((key, None, flat_s[key], "MISSING"))
            mismatches.append(key)
            continue
        c, s = flat_c[key], flat_s[key]
        ok = abs(c - s) <= atol + rtol * abs(s)
        rows.append((key, c, s, "ok" if ok else "FAIL"))
        if not ok:
            mismatches.append(key)
    return rows, mismatches


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch metric parity harness")
    p.add_argument("--results", required=True, help=".npz with embeds/labels[/dists][/metrics]")
    p.add_argument("--multilabel", action="store_true",
                   help="Force the multilabel path (default: labels.ndim > 1)")
    p.add_argument("--use-stored-dists", action="store_true",
                   help="Evaluate from the stored dists matrix instead of recomputing it "
                        "from embeds")
    p.add_argument("--rtol", default=1e-5, type=float)
    p.add_argument("--output", default="", help="Write comparison JSON")
    args = p.parse_args(argv)

    from ..metrics import fill_diagonal_neg_inf, pairwise_cosine, pairwise_neg_l2
    from .common import set_tf32
    from .test import multilabel_metrics, single_label_metrics

    set_tf32(False)
    # object-typed label arrays need pickle; only artifacts of cli.test are read
    data = np.load(args.results, allow_pickle=True)
    labels = np.asarray(data["labels"])
    multilabel = args.multilabel or labels.ndim > 1

    if args.use_stored_dists and "dists" in data:
        dists = np.asarray(data["dists"])
    else:
        embeds = torch.from_numpy(np.asarray(data["embeds"], np.float32))
        sim = pairwise_cosine(embeds) if multilabel else pairwise_neg_l2(embeds)
        dists = fill_diagonal_neg_inf(sim).numpy()

    computed = multilabel_metrics(dists, labels) if multilabel else single_label_metrics(
        dists, labels)

    result = {"computed": computed, "n": int(labels.shape[0]), "multilabel": multilabel}
    status = 0
    if "metrics" in data:
        stored = json.loads(str(data["metrics"]))
        rows, mismatches = compare_metrics(computed, stored, rtol=args.rtol)
        width = max(len(r[0]) for r in rows)
        for key, c, s, ok in rows:
            cs = "-" if c is None else f"{c:12.6f}"
            print(f"{key:<{width}}  computed {cs}  stored {s:12.6f}  [{ok}]")
        if mismatches:
            print(f">> PARITY FAIL: {len(mismatches)} metric(s) disagree: {mismatches}")
            status = 1
        else:
            print(f">> PARITY OK: all {len(rows)} metrics agree (rtol={args.rtol})")
        result["mismatches"] = mismatches
    else:
        print(">> no stored metrics in artifact; computed values:")
        for k, v in _flatten(computed).items():
            print(f"  {k}: {v:.6f}")

    if args.output:
        with open(args.output, "w") as f:
            json.dump(result, f, indent=2, default=float)
    if status:
        sys.exit(status)
    return result


if __name__ == "__main__":
    main()
