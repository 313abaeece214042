"""Single-pair insertion / deletion debug CLI (port of
xmir_tpu/cli/debug_insdel.py; reference debug_insertion_deletion.py,
debug_single_image_pipeline.py): one query-retrieval pair's SBSM map, then
both curves with every step's score printed, the step-level visibility the
reference uses in place of unit tests.

    python -m xmir_tpu_torch.cli.debug_insdel --dataset covid --device cuda \
        --query-index 0 --window-size 24 --stride 5

With ``--retrieved-index -1`` (the default) the pair's second image is the
query's nearest neighbour in the split (the index's top 2, self skipped),
found through the top-k kernel.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .common import (
    add_dataset_args,
    add_model_args,
    add_precision_args,
    apply_score_precision,
    build_dataset,
    build_model,
    resolve_device,
)
from .compute_saliency import image_preprocessor


def main(argv=None):
    p = argparse.ArgumentParser(description="single-pair ins/del debug")
    add_dataset_args(p)
    add_model_args(p)
    add_precision_args(p)
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--query-index", default=0, type=int)
    p.add_argument("--retrieved-index", default=-1, type=int,
                   help="-1 = top-1 neighbor of the query")
    p.add_argument("--window-size", default=24, type=int)
    p.add_argument("--stride", default=5, type=int)
    p.add_argument("--gpu-batch", default=128, type=int)
    p.add_argument("--step", default=1000, type=int)
    p.add_argument("-j", "--workers", default=8, type=int)
    args = p.parse_args(argv)
    apply_score_precision(args)

    from ..data.pipeline import embed_dataset
    from ..index import ShardedGalleryIndex
    from ..metrics.saliency import auc as auc_fn
    from ..train import make_embed_fn
    from ..xai import (
        blur_substrate,
        causal_scores,
        generate_masks,
        saliency_rank,
        sbsm_pair_saliency,
        zeros_substrate,
    )

    device = resolve_device(args)
    dataset = build_dataset(args, args.split)
    model, spec = build_model(args, device)
    embed = make_embed_fn(model)
    prep = image_preprocessor(spec, device)

    qi = args.query_index
    q_img = prep(dataset.load_image(qi)[None])
    q_feat = embed(q_img)[0]
    ri = args.retrieved_index
    if ri < 0:
        embeds, _ = embed_dataset(dataset, embed, spec, device=device, num_workers=args.workers)
        idx = ShardedGalleryIndex(embeds.shape[1])
        idx.add(embeds.cpu().numpy())
        idx.build(device)
        _, ids = idx.search(embeds[qi:qi + 1], k=2)
        ri = int(ids[0, 1])  # skip self
        print(f">> top-1 neighbor of query {qi}: {ri}")
    r_img = prep(dataset.load_image(ri)[None])

    print(f">> SBSM saliency for pair ({qi}, {ri}) ...")
    masks = torch.from_numpy(generate_masks(spec.input_size, args.window_size,
                                            args.stride)).to(device)
    sal = sbsm_pair_saliency(embed, q_img, r_img, masks, chunk=args.gpu_batch)[0, 0]
    s = sal.cpu().numpy()
    print(f"   saliency: min {s.min():.4f} max {s.max():.4f} mean {s.mean():.4f}")

    ranks = saliency_rank(sal)
    result = {"query_index": qi, "retrieved_index": ri, "saliency": s}
    for mode, sub in (("del", zeros_substrate), ("ins", blur_substrate())):
        if mode == "del":
            start, finish = r_img[0], sub(r_img)[0]
        else:
            start, finish = sub(r_img)[0], r_img[0]
        scores = causal_scores(embed, q_feat, start, finish, ranks, args.step,
                               batch_steps=8).cpu().numpy()
        n_steps = len(scores) - 1
        print(f"\n== {mode} (step={args.step} px, {n_steps} steps) ==")
        for i, v in enumerate(scores):
            pct = 100.0 * i / max(n_steps, 1)
            bar = "#" * int(max(v, 0.0) * 40)
            print(f"  {pct:5.1f}%  score {v:+.4f}  {bar}")
        auc = auc_fn(np.clip(scores, 0.0, 1.0))
        print(f"  -> AUC {auc:.4f}, {int((scores < 0).sum())} negative clips")
        result[mode] = {"scores": scores, "auc": auc}
    return result


if __name__ == "__main__":
    main()
