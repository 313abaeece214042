"""Late-fusion experiment CLI (port of xmir_tpu/cli/fusion.py; reference
fusion_eval/run_late_fusion.py): two embedding sources (``.npz`` artifacts
with embeds / labels / paths, such as cli.ingest writes), aligned on image
paths, evaluated under baseline / concat / weighted-sum / score / confidence
fusion, the similarity products on ``--device``. JSON config or flags.

    python -m xmir_tpu_torch.cli.fusion --source-a a.npz --source-b b.npz \\
        --device cuda --output late_fusion_results
"""
from __future__ import annotations

import argparse
import csv
import json

from .common import resolve_device, set_tf32


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch late fusion experiments")
    p.add_argument("--config", default="", help="JSON config (reference format)")
    p.add_argument("--source-a", default="", help="npz with embeds/labels/paths")
    p.add_argument("--source-b", default="")
    p.add_argument("--alphas", default="0.2,0.3,0.4,0.5,0.6,0.7,0.8")
    p.add_argument("--score-normalization", default="none",
                   choices=["none", "zscore", "minmax"])
    p.add_argument("--no-score-fusion", action="store_true")
    p.add_argument("--no-confidence-fusion", action="store_true")
    p.add_argument("--output", default="late_fusion_results")
    p.add_argument("--device", default="cuda",
                   help="Torch device of the similarity products (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)

    from ..analysis import EmbeddingSource, run_late_fusion_experiments

    device = resolve_device(args)
    set_tf32(False)  # the similarities in IEEE f32, as the JAX package's numpy products
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
        src_a = cfg["sources"][0]["path"]
        src_b = cfg["sources"][1]["path"]
        alphas = cfg.get("alphas", [float(a) for a in args.alphas.split(",")])
        norm = cfg.get("score_normalization", args.score_normalization)
        inc_score = cfg.get("include_score_fusion", not args.no_score_fusion)
        inc_conf = cfg.get("include_confidence_fusion", not args.no_confidence_fusion)
    else:
        if not (args.source_a and args.source_b):
            p.error("need --config or both --source-a/--source-b")
        src_a, src_b = args.source_a, args.source_b
        alphas = [float(a) for a in args.alphas.split(",")]
        norm = args.score_normalization
        inc_score = not args.no_score_fusion
        inc_conf = not args.no_confidence_fusion

    a = EmbeddingSource.from_npz(src_a)
    b = EmbeddingSource.from_npz(src_b)
    results = run_late_fusion_experiments(
        a, b, alphas=alphas, include_score_fusion=inc_score,
        score_normalization=norm, include_confidence_fusion=inc_conf, device=device,
    )

    print(f"{'experiment':<35} {'mAP':>8} {'R@1':>8} {'R@5':>8} {'R@10':>8}")
    for name, m in results.items():
        if "skipped" in m:
            print(f"{name:<35} skipped: {m['skipped']}")
            continue
        print(f"{name:<35} {m['mAP']:>8.2f} {m.get('R@1', 0):>8.2f} "
              f"{m.get('R@5', 0):>8.2f} {m.get('R@10', 0):>8.2f}")

    with open(args.output + ".json", "w") as f:
        json.dump(results, f, indent=2, default=float)
    with open(args.output + ".csv", "w", newline="") as f:
        w = csv.writer(f)
        keys = ["mAP", "R@1", "R@5", "R@10", "mP@1", "mP@5", "mP@10"]
        w.writerow(["experiment"] + keys)
        for name, m in results.items():
            w.writerow([name] + [m.get(k, "") for k in keys])
    print(f">> wrote {args.output}.json / .csv")
    return results


if __name__ == "__main__":
    main()
