"""ChestMIR gallery ingestion CLI (reference ChestMIR/milvus_embed.py; port of
xmir_tpu/cli/chestmir_ingest.py): global embedding + per-lesion region
embeddings for every gallery image, written to the ChestMIR .npz artifact
that ``cli.chestmir_eval`` (either package's) reads.

Detections come from a JSON file {image_name: [detection dicts]} (produced
offline by any detector) or from a detector plugin module exposing
`build_detectors() -> [callable]` for the 5-fold x TTA WBF path, e.g. one
``chestmir.lesions.detector_fn_from_checkpoint`` a fold:

    python -m xmir_tpu_torch.cli.chestmir_ingest --dataset synthetic --model tiny \\
        --embedding-dim 16 --detector-plugin examples.detector_plugin_example \\
        --raw-detector-outputs --tta 0,4 --device cuda --output chestmir_gallery.npz
"""
from __future__ import annotations

import argparse
import json
import os
import time

from .common import (
    add_dataset_args,
    add_model_args,
    build_dataset,
    build_model,
    resolve_device,
    set_tf32,
)


def main(argv=None):
    p = argparse.ArgumentParser(description="ChestMIR two-stage gallery ingest")
    add_dataset_args(p)
    add_model_args(p)
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--detections", default="",
                   help="JSON {image_basename: [det dicts with class_name/x1..y2]}")
    p.add_argument("--detector-plugin", default="",
                   help="Python module with build_detectors() for live detection")
    p.add_argument("--raw-detector-outputs", action="store_true",
                   help="detector fns return raw YOLO head tensors; decode "
                        "via chestmir.inference (conf gate, class-offset "
                        "NMS, coordinate unscaling)")
    p.add_argument("--tta", default="0,4",
                   help="comma-separated TTA variant ids in 0..7")
    p.add_argument("--batch-size", default=32, type=int)
    p.add_argument("--region-batch-size", default=16, type=int)
    p.add_argument("--score-thres", default=0.1, type=float)
    p.add_argument("--wbf-iou", default=0.25, type=float)
    p.add_argument("--output", default="chestmir_gallery.npz")
    args = p.parse_args(argv)
    # global and region vectors in IEEE f32, as cli.ingest embeds
    set_tf32(False)

    from ..chestmir import detections_with_tta_folds, embed_regions
    from ..data.pipeline import embed_dataset
    from ..train import make_embed_fn
    from .chestmir_eval import save_chestmir_npz

    device = resolve_device(args)
    dataset = build_dataset(args, args.split)
    model, spec = build_model(args, device)
    embed = make_embed_fn(model)

    print(f">> global embeddings for {len(dataset)} images ...")
    t0 = time.perf_counter()
    globals_, labels = embed_dataset(dataset, embed, spec, device=device,
                                     batch_size=args.batch_size)
    globals_ = globals_.cpu().numpy()  # waits for the device
    # "load" is the image files' decode, apart from detection and region embeds
    seconds = {"global": time.perf_counter() - t0, "load": 0.0, "detect": 0.0, "regions": 0.0}

    det_table = {}
    detector_fns = None
    if args.detections:
        with open(args.detections) as f:
            det_table = json.load(f)
    elif args.detector_plugin:
        import importlib

        detector_fns = importlib.import_module(args.detector_plugin).build_detectors()
    else:
        print(">> no detections source: artifact will carry empty region maps "
              "(stage 2 falls back to global ranking)")

    regions_per_image = []
    for i in range(len(dataset)):
        base = os.path.basename(str(dataset.image_names[i]))
        dets = det_table.get(base, [])
        img = None
        if detector_fns is not None or dets:
            t0 = time.perf_counter()
            img = dataset.load_image(i)
            seconds["load"] += time.perf_counter() - t0
        if detector_fns is not None:
            t0 = time.perf_counter()
            dets = detections_with_tta_folds(
                img, detector_fns, wbf_iou=args.wbf_iou,
                raw_outputs=args.raw_detector_outputs,
                tta=tuple(int(t) for t in args.tta.split(",")),
                score_thres=args.score_thres,
            )
            seconds["detect"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        recs = (embed_regions(img, dets, embed, spec, device,
                              batch_size=args.region_batch_size) if dets else [])
        seconds["regions"] += time.perf_counter() - t0
        regions_per_image.append(recs)
        if (i + 1) % 100 == 0:
            print(f">> regions {i + 1}/{len(dataset)}")

    names = [os.path.basename(str(n)) for n in dataset.image_names]
    save_chestmir_npz(args.output, globals_, labels, names, regions_per_image)
    n_regions = sum(len(r) for r in regions_per_image)
    print(f">> wrote {args.output}: {len(names)} images, {n_regions} regions; seconds: "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    return {"images": len(names), "regions": n_regions, "seconds": seconds}


if __name__ == "__main__":
    main()
