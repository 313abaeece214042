"""ChestMIR two-stage evaluation CLI (reference ChestMIR/chestmir_eval.py:670;
port of xmir_tpu/cli/chestmir_eval.py: numpy on the host, the same artifact
schema, so each package reads the other's .npz).

    python -m xmir_tpu_torch.cli.chestmir_eval --gallery chestmir_gallery.npz \
        --target-lesions "lung opacity" --output chestmir_results.json

Input: a ChestMIR gallery artifact (.npz) holding per-image global vectors,
labels, and region records (lesion label + vector + box), produced by
`xmir_tpu_torch.cli.chestmir_ingest` (or the JAX package's) or converted from
a reference Milvus dump. Runs stage-1 global ranking and stage-2
adaptive/specific lesion reranks with the full metric suite.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def load_chestmir_npz(path: str):
    """Artifact schema: global_vectors (N, D), labels (N,), image_names (N,),
    regions = json list per image of {label, box, vector}."""
    data = np.load(path, allow_pickle=True)
    from ..chestmir import build_lesion_map

    regions = json.loads(str(data["regions_json"]))
    lesion_maps = [build_lesion_map(r) for r in regions]
    return (
        np.asarray(data["global_vectors"], np.float32),
        np.asarray(data["labels"]),
        [str(n) for n in data["image_names"]],
        lesion_maps,
    )


def save_chestmir_npz(path, global_vectors, labels, image_names, regions):
    serializable = [
        [
            {"label": r["label"], "box": list(map(float, r["box"])),
             "vector": np.asarray(r["vector"], np.float32).tolist()}
            for r in rs
        ]
        for rs in regions
    ]
    np.savez(
        path,
        global_vectors=np.asarray(global_vectors, np.float32),
        labels=np.asarray(labels),
        image_names=np.asarray(image_names),
        regions_json=json.dumps(serializable),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description="ChestMIR two-stage evaluation")
    p.add_argument("--gallery", required=True, help="ChestMIR .npz artifact")
    p.add_argument("--rerank-topk", default=50, type=int)
    p.add_argument("--global-weight", default=0.7, type=float)
    p.add_argument(
        "--target-lesions",
        default="consolidation,lung opacity,infiltration,atelectasis,pleural effusion",
        help="Comma-separated lesions for adaptive rerank",
    )
    p.add_argument("--specific-lesions", default="",
                   help="Comma-separated lesions for per-lesion reranks")
    p.add_argument("--output", default="chestmir_results.json")
    args = p.parse_args(argv)

    from ..chestmir import two_stage_eval

    g, labels, names, lesion_maps = load_chestmir_npz(args.gallery)
    print(f">> {len(names)} images, {sum(len(m) for m in lesion_maps)} lesion groups")
    target = [s.strip() for s in args.target_lesions.split(",") if s.strip()]
    specific = [s.strip() for s in args.specific_lesions.split(",") if s.strip()]
    out = two_stage_eval(
        g, labels, lesion_maps, target, specific,
        rerank_topk=args.rerank_topk, global_weight=args.global_weight,
    )
    for stage, payload in out.items():
        rep = payload["report"]
        rk = ", ".join(f"R@{k}: {v:.2f}%" for k, v in rep["R@K"].items())
        print(f"\n=== {stage} ===\n{rk}\nmAP: {rep['mAP']:.2f}%")
        if payload["stats"]:
            s = payload["stats"]
            print(f"reranked {s.get('queries_reranked', 0)}/{s['queries_total']} "
                  f"(fallback {s.get('queries_fallback_global', 0)})")
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2, default=float)
    print(f"\n>> results saved to {args.output}")


if __name__ == "__main__":
    main()
