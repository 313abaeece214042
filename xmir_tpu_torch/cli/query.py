"""Query CLI (port of xmir_tpu/cli/query.py): load a gallery index artifact,
embed the queries, take the exact top-k through the CUDA top-k kernels, write
JSON results.

    python -m xmir_tpu_torch.cli.query --dataset synthetic --device cuda \
        --index gallery.npz --top-k 10 --output hits.json

``--top-k 0`` asks for the whole gallery ranked (k = ntotal): through the
select route of the top-k kernels (ops/topk_kernels.py) above 32 rows, in the
same order as any k. ``--use-mesh`` shards the index's rows and the query
embedding over a data-parallel world (parallel/mesh.py); rank 0 writes the
results.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from .common import (
    add_dataset_args,
    add_mesh_arg,
    add_model_args,
    add_precision_args,
    apply_score_precision,
    build_dataset,
    build_model,
    data_mesh,
    is_writer,
    resolve_device,
)


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch gallery query")
    add_dataset_args(p)
    add_model_args(p)
    add_precision_args(p)
    p.add_argument("--index", required=True, help="Gallery .npz from an ingest")
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--top-k", default=10, type=int, help="0 = full-gallery ranking")
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--output", default="query_results.json")
    p.add_argument("--path-map", default="",
                   help="OLD=NEW gallery path prefix rewrite (reference "
                        "milvus/path_mapper.py, e.g. /kaggle/input=/data)")
    add_mesh_arg(p)
    args = p.parse_args(argv)
    apply_score_precision(args)

    from ..data.pipeline import embed_dataset
    from ..index import ShardedGalleryIndex
    from ..train import make_embed_fn

    device = resolve_device(args)
    with data_mesh(args, device) as mesh:
        device = mesh.device if mesh else device
        idx = ShardedGalleryIndex.load(args.index, device=device, mesh=mesh)
        if args.path_map:
            old, _, new = args.path_map.partition("=")
            n = idx.remap_paths(old, new)
            print(f">> remapped {n} gallery paths ({old!r} -> {new!r})")
        print(f">> index: {idx.ntotal} vectors, dim={idx.dim}, metric={idx.metric}")

        dataset = build_dataset(args, args.split)
        model, spec = build_model(args, device)
        queries, _ = embed_dataset(dataset, make_embed_fn(model), spec, device=device,
                                   batch_size=args.batch_size, num_workers=args.workers,
                                   mesh=mesh)

        k = args.top_k if args.top_k > 0 else idx.ntotal
        results = []
        for qi, hits in enumerate(idx.search_with_metadata(queries, k=k)):
            results.append({
                "query_path": str(dataset.image_names[qi]),
                "query_label": np.asarray(dataset.labels[qi]).tolist(),
                "results": hits,
            })
        if is_writer(mesh):
            with open(args.output, "w") as f:
                json.dump(results, f, indent=2, default=float)
            print(f">> wrote {len(results)} query results to {args.output}")
        return results


if __name__ == "__main__":
    main()
