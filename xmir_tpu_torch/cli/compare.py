"""Dual-model retrieval comparison CLI (port of xmir_tpu/cli/compare.py;
reference retrieval_analysis/run_analysis.py): query two gallery indexes
with the same query set, one exact top-k search each (K1 on the card),
classify the agreement groups, export JSON / CSV and an HTML mismatch
report.

    python -m xmir_tpu_torch.cli.compare --index-a a.npz --index-b b.npz \\
        --queries-a qa.npz --queries-b qb.npz --device cuda --html
"""
from __future__ import annotations

import argparse

from .common import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch dual-model comparison")
    p.add_argument("--index-a", required=True, help="Gallery .npz for model A")
    p.add_argument("--index-b", required=True, help="Gallery .npz for model B")
    p.add_argument("--queries-a", required=True,
                   help="npz with embeds/labels/paths for model A's queries")
    p.add_argument("--queries-b", default="",
                   help="Same queries embedded by model B (defaults to A's)")
    p.add_argument("--name-a", default="model_a")
    p.add_argument("--name-b", default="model_b")
    p.add_argument("--top-k", default=5, type=int)
    p.add_argument("--out-dir", default="./comparison")
    p.add_argument("--html", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="Torch device the galleries are built and searched on")
    args = p.parse_args(argv)

    from ..analysis import compare_retrievers, export_comparison, render_mismatch_html
    from ..analysis.fusion import EmbeddingSource
    from ..index import ShardedGalleryIndex

    device = resolve_device(args)
    idx_a = ShardedGalleryIndex.load(args.index_a, device=device)
    idx_b = ShardedGalleryIndex.load(args.index_b, device=device)
    qa = EmbeddingSource.from_npz(args.queries_a)
    qb = EmbeddingSource.from_npz(args.queries_b) if args.queries_b else qa

    names = (args.name_a, args.name_b)
    groups = compare_retrievers(qa.embeddings, qa.labels, qa.image_paths, idx_a, idx_b,
                                k=args.top_k, names=names, queries_b=qb.embeddings)
    for g, cases in groups.items():
        print(f"{g:<45} {len(cases)}")
    export_comparison(groups, args.out_dir, names)
    if args.html:
        path = render_mismatch_html(
            groups, f"{args.out_dir}/mismatches.html", names
        )
        print(f">> HTML report: {path}")
    return groups


if __name__ == "__main__":
    main()
