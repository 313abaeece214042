"""Gallery ingestion CLI (port of xmir_tpu/cli/ingest.py): embed the gallery
set and save a ShardedGalleryIndex .npz artifact (embeddings + labels +
paths), the format the JAX package writes too.

    python -m xmir_tpu_torch.cli.ingest --dataset synthetic --device cuda \
        --output gallery.npz

``--use-mesh`` embeds over a data-parallel world (rank 0 writes the artifact,
the same file a world of 1 writes); ``--upload-originals`` copies the gallery
images to a store and records the stored URIs as the index paths.
"""
from __future__ import annotations

import argparse
import time

import torch

from .common import (
    add_dataset_args,
    add_mesh_arg,
    add_model_args,
    build_dataset,
    build_model,
    data_mesh,
    is_writer,
    resolve_device,
    set_tf32,
)


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch gallery ingestion")
    add_dataset_args(p)
    add_model_args(p)
    p.add_argument("--split", default="train", choices=["train", "val", "test"])
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--metric", default="cosine", choices=["cosine", "ip", "l2", "hamming"])
    p.add_argument("--output", default="gallery.npz", help="Index artifact path (.npz)")
    p.add_argument("--skip-errors", action="store_true",
                   help="Skip unreadable images instead of failing "
                        "(reference ingest_embeddings.py:293-302)")
    p.add_argument("--upload-originals", default="",
                   help="Upload gallery originals and record the stored URIs as the index "
                        "paths (reference ingest_embeddings.py:319-383): 's3://bucket' for S3 "
                        "(needs boto3 and AWS credentials) or a directory for the local / "
                        "mounted-volume store. Default: record local paths.")
    p.add_argument("--upload-prefix", default="original",
                   help="Key prefix inside the store (S3_ORIGINAL_IMAGES_PREFIX)")
    add_mesh_arg(p)
    args = p.parse_args(argv)
    # the gallery is embedded in IEEE f32, as cli.query embeds its queries
    # under its default --score-precision highest
    set_tf32(False)

    from ..data.pipeline import embed_dataset
    from ..index import ShardedGalleryIndex
    from ..train import make_embed_fn

    device = resolve_device(args)
    with data_mesh(args, device) as mesh:
        device = mesh.device if mesh else device
        dataset = build_dataset(args, args.split)
        model, spec = build_model(args, device)

        t0 = time.perf_counter()
        embeds, labels = embed_dataset(
            dataset, make_embed_fn(model), spec, device=device,
            batch_size=args.batch_size, num_workers=args.workers,
            skip_errors=args.skip_errors, mesh=mesh,
        )
        embeds = embeds.cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        print(f">> embedded {len(dataset)} images in {dt:.1f}s ({len(dataset) / dt:.1f} img/s"
              f" on {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})")

        paths = [str(n) for n in dataset.image_names]
        if args.upload_originals and is_writer(mesh):
            from ..utils.objectstore import resolve_store, upload_originals

            paths = upload_originals(paths, resolve_store(args.upload_originals),
                                     args.upload_prefix)
            print(f">> uploaded {len(paths)} originals -> {args.upload_originals} "
                  f"(sample: {paths[0]})")
        idx = ShardedGalleryIndex(embeds.shape[1], metric=args.metric)
        idx.add(embeds, labels, paths)
        idx.build(device, mesh=mesh)
        if is_writer(mesh):
            idx.save(args.output)
            print(f">> index saved: {args.output} ({idx.ntotal} vectors, "
                  f"dim={embeds.shape[1]}, metric={args.metric})")
        return idx


if __name__ == "__main__":
    main()
