"""Saliency generation CLI (port of xmir_tpu/cli/compute_saliency.py, the
reference compute_saliency.py equivalent).

    python -m xmir_tpu_torch.cli.compute_saliency --dataset covid --device cuda \
        --results results/evaluation_results.npz --top-k 5 --save-dir saliency/

Reference flow (compute_saliency.py:63-129): SBSM occlusion saliency of
every image against its own embedding (``sal_{index:06d}.npy``), or, with
``--results`` (the ``evaluation_results.npz`` of ``cli.test --save-dir``),
of each query's top-k retrieved images against the query
(``sal_q{query:05d}_r{retrieved:05d}.npy``, ranked by the artifact's
``dists``). The masked copies are embedded ``--gpu-batch`` at a time on one
card. The model runs in IEEE f32 unless ``--score-precision default``.

Not ported yet: the other explainers (simatt, simcam, rollout: ROADMAP.md
section 1 item 3; gradcam_sim: item 7) and ``--use-mesh`` (item 11).
"""
from __future__ import annotations

import argparse
import os

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

# the explainers still to port, by the ROADMAP.md item that brings them
WAITING_EXPLAINERS = {"simatt": "section 1 item 3", "simcam": "section 1 item 3",
                      "rollout": "section 1 item 3", "gradcam_sim": "section 1 item 7"}


def refuse_unported(args):
    """Raise for an explainer or option of the JAX CLI not ported yet."""
    if args.explainer in WAITING_EXPLAINERS:
        raise NotImplementedError(
            f"--explainer {args.explainer} is not ported to xmir_tpu_torch yet (ROADMAP.md, "
            f"{WAITING_EXPLAINERS[args.explainer]})")
    if args.use_mesh:
        raise NotImplementedError("--use-mesh (the mask fan-out over several cards) is not "
                                  "ported to xmir_tpu_torch yet (ROADMAP.md, section 1 item 11)")


def image_preprocessor(spec, device):
    """uint8 (B, H, W, 3) numpy images -> the model's f32 input on ``device``."""
    from ..data.transforms import eval_preprocess

    def prep(imgs):
        x = torch.tensor(np.asarray(imgs), device=device)  # a copy: decoded images are read-only
        return eval_preprocess(x, spec.resize_size, spec.input_size, spec.mean, spec.std,
                               method=spec.interpolation)

    return prep


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch saliency computation")
    add_dataset_args(p)
    add_model_args(p)
    add_precision_args(p)
    p.add_argument("--explainer", default="sbsm",
                   choices=["sbsm", "simatt", "simcam", "rollout", "gradcam_sim"])
    p.add_argument("--split", default="test", choices=["train", "val", "test"])
    p.add_argument("--window-size", default=24, type=int)
    p.add_argument("--stride", default=5, type=int)
    p.add_argument("--gpu-batch", default=128, type=int,
                   help="Masked-forward chunk size (reference --gpu-batch)")
    p.add_argument("--eval-batch-size", default=8, type=int)
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--results", default="",
                   help="evaluation_results.npz for pair mode (else self-saliency)")
    p.add_argument("--top-k", default=5, type=int)
    p.add_argument("--save-dir", default="./saliency")
    p.add_argument("--limit", default=0, type=int, help="Max queries (0 = all)")
    p.add_argument("--use-mesh", action="store_true",
                   help="Fan the SBSM mask axis out over several cards (not ported yet)")
    args = p.parse_args(argv)
    refuse_unported(args)
    apply_score_precision(args)

    from ..data.pipeline import batch_iterator
    from ..train import make_embed_fn
    from ..xai import generate_masks, sbsm_pair_saliency, sbsm_self_saliency

    device = resolve_device(args)
    dataset = build_dataset(args, args.split)
    model, spec = build_model(args, device)
    embed = make_embed_fn(model)
    prep = image_preprocessor(spec, device)
    os.makedirs(args.save_dir, exist_ok=True)
    masks = torch.from_numpy(generate_masks(spec.input_size, args.window_size,
                                            args.stride)).to(device)
    print(f">> {masks.shape[0]} occlusion masks (window={args.window_size}, "
          f"stride={args.stride})")
    if not args.results:
        count = 0
        for imgs, _, idxs in batch_iterator(dataset, args.eval_batch_size,
                                            image_size=spec.resize_size,
                                            num_workers=args.workers,
                                            interpolation=spec.interpolation):
            sal = sbsm_self_saliency(embed, prep(imgs), masks, chunk=args.gpu_batch).cpu().numpy()
            for j, gi in enumerate(np.asarray(idxs)):
                np.save(os.path.join(args.save_dir, f"sal_{int(gi):06d}.npy"), sal[j])
            count += imgs.shape[0]
            if args.limit and count >= args.limit:
                break
        print(f">> saved {count} self-saliency maps to {args.save_dir}")
        return count
    dists = np.load(args.results, allow_pickle=True)["dists"]
    ranks = np.argsort(-dists, axis=1, kind="stable")[:, :args.top_k]
    n_q = len(dataset) if not args.limit else min(args.limit, len(dataset))
    for qi in range(n_q):
        q_img = prep(dataset.load_image(qi)[None])
        r_imgs = prep(np.stack([dataset.load_image(int(r)) for r in ranks[qi]]))
        sal = sbsm_pair_saliency(embed, q_img, r_imgs, masks, chunk=args.gpu_batch).cpu().numpy()
        for j, r in enumerate(ranks[qi]):
            np.save(os.path.join(args.save_dir, f"sal_q{qi:05d}_r{int(r):05d}.npy"), sal[0, j])
    print(f">> saved pair saliency for {n_q} queries to {args.save_dir}")
    return n_q


if __name__ == "__main__":
    main()
