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

The other explainers, as the JAX CLI runs them (compute_saliency.py:130-213),
for the first ``--limit`` images (16 by default): ``--explainer simatt``
(a conv backbone with a feature head: densenet121, convnextv2) saves each
anchor's stack of maps, [anchor, its top-k of ``--results``] or the anchor
twice, as ``simatt_q{query:05d}.npy``; ``simcam`` the (2, H, W) query and
retrieval maps of each image against the next as ``simcam_q{query:05d}.npy``;
``rollout`` (a ViT: dinov2) each image's attention rollout as
``rollout_q{query:05d}.npy``; ``gradcam_sim`` (a ViT with the ``token_delta``
tap: medsiglip) the Grad-CAM of cosine(query, retrieved) for each query's
top-k of ``--results``, or the next image, as
``gradcam_q{query:05d}_r{retrieved:05d}.npy``.

``--use-mesh`` splits SBSM's mask axis over a data-parallel world
(parallel/mesh.py; the reference's DataParallel over mask batches); rank 0
writes the maps. The other explainers run on each rank alike.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

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


def image_preprocessor(spec, device):
    """uint8 (B, H, W, 3) numpy images -> the model's f32 input on ``device``."""
    from ..data.transforms import eval_preprocess

    def prep(imgs):
        x = torch.tensor(np.asarray(imgs), device=device)  # a copy: decoded images are read-only
        return eval_preprocess(x, spec.resize_size, spec.input_size, spec.mean, spec.std,
                               method=spec.interpolation)

    return prep


def features_fn(model):
    """x -> the model's last feature map (NHWC), without a graph."""
    def features(x):
        with torch.no_grad():
            return model(x)["features"]

    return features


def rollout_maps(model, x, size: int):
    """Attention rollout of each image of ``x`` on the patch grid, upsampled
    to size x size: the model's attention weights (eager path), the leading
    non-patch tokens (DINOv2's CLS) dropped from the importance."""
    from ..xai import rollout_saliency

    with torch.no_grad():
        out = model(x, output_attentions=True)
    prefix = out["attentions"][0].shape[-1] - out["tokens"].shape[1]
    return rollout_saliency(out["attentions"], (size, size), prefix_tokens=prefix)


def sbsm_fns(embed, masks, chunk: int, mesh):
    """(self saliency, pair saliency) of SBSM: the mask fan-out over
    ``mesh`` where there is one."""
    from ..xai import (
        sbsm_pair_saliency,
        sbsm_pair_saliency_mesh,
        sbsm_self_saliency,
        sbsm_self_saliency_mesh,
    )

    if mesh is None:
        return (lambda x: sbsm_self_saliency(embed, x, masks, chunk=chunk),
                lambda q, r: sbsm_pair_saliency(embed, q, r, masks, chunk=chunk))
    return (lambda x: sbsm_self_saliency_mesh(embed, x, masks, mesh, chunk=chunk),
            lambda q, r: sbsm_pair_saliency_mesh(embed, q, r, masks, mesh, chunk=chunk))


def pair_explainer(args, model, embed, size: int, device, mesh=None):
    """(q_img (1, H, W, C), r_imgs (P, H, W, C)) -> P (H, W) maps over the
    retrieved images, by ``args.explainer`` (the JAX evaluate_saliency's
    inline providers, evaluate_saliency.py:125-153); SBSM's masks fan out
    over ``mesh``."""
    from ..xai import generate_masks, simatt_saliency, simcam_maps

    if args.explainer == "sbsm":
        masks = torch.from_numpy(generate_masks(size, args.window_size, args.stride)).to(device)
        pair = sbsm_fns(embed, masks, args.gpu_batch, mesh)[1]
        return lambda q, r: list(pair(q, r)[0])
    if args.explainer == "simatt":
        from ..xai import get_feature_head

        head_fn, feats = get_feature_head(args.model, model), features_fn(model)
        return lambda q, r: list(simatt_saliency(feats, head_fn, torch.cat([q, r]), n_pos=1)[1:])
    if args.explainer == "simcam":
        feats = features_fn(model)
        # index 1: the retrieval-side map (of the image that is perturbed)
        return lambda q, r: list(simcam_maps(feats(q)[0], feats(r), out_hw=(size, size))[:, 1])
    if args.explainer == "gradcam_sim":
        from ..xai import make_vit_gradcam_fn, vit_gradcam_similarity

        apply_fn = make_vit_gradcam_fn(model)
        return lambda q, r: list(vit_gradcam_similarity(apply_fn, embed(q)[0], r,
                                                        out_hw=(size, size)))
    return lambda q, r: list(rollout_maps(model, r, size))


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
    add_mesh_arg(p)
    args = p.parse_args(argv)
    apply_score_precision(args)
    device = resolve_device(args)
    with data_mesh(args, device) as mesh:
        return _run(args, mesh.device if mesh else device, mesh)


def _run(args, device, mesh):
    from ..data.pipeline import batch_iterator
    from ..train import make_embed_fn
    from ..xai import generate_masks

    dataset = build_dataset(args, args.split)
    model, spec = build_model(args, device)
    embed = make_embed_fn(model)
    prep = image_preprocessor(spec, device)
    os.makedirs(args.save_dir, exist_ok=True)
    if args.explainer == "gradcam_sim":
        return gradcam_maps(args, dataset, model, embed, prep, spec.input_size)
    if args.explainer != "sbsm":
        return other_explainers(args, dataset, model, prep, spec.input_size)
    masks = torch.from_numpy(generate_masks(spec.input_size, args.window_size,
                                            args.stride)).to(device)
    print(f">> {masks.shape[0]} occlusion masks (window={args.window_size}, "
          f"stride={args.stride})")
    self_saliency, pair_saliency = sbsm_fns(embed, masks, args.gpu_batch, mesh)
    write = is_writer(mesh)
    if not args.results:
        count = 0
        for imgs, _, idxs in batch_iterator(dataset, args.eval_batch_size,
                                            image_size=spec.resize_size,
                                            num_workers=args.workers,
                                            interpolation=spec.interpolation):
            sal = self_saliency(prep(imgs)).cpu().numpy()
            for j, gi in enumerate(np.asarray(idxs) if write else ()):
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
        sal = pair_saliency(q_img, r_imgs).cpu().numpy()
        for j, r in enumerate(ranks[qi] if write else ()):
            np.save(os.path.join(args.save_dir, f"sal_q{qi:05d}_r{int(r):05d}.npy"), sal[0, j])
    print(f">> saved pair saliency for {n_q} queries to {args.save_dir}")
    return n_q


def other_explainers(args, dataset, model, prep, size: int):
    """simatt, simcam or rollout maps of the first ``--limit`` images (16 by
    default), saved one file an image. Returns the count."""
    from ..xai import get_feature_head, simatt_saliency, simcam_maps

    n_q = args.limit or min(len(dataset), 16)
    dists = np.load(args.results, allow_pickle=True)["dists"] if args.results else None
    feats = features_fn(model)
    head_fn = get_feature_head(args.model, model) if args.explainer == "simatt" else None
    for qi in range(n_q):
        if args.explainer == "simatt":
            if dists is not None:
                ranks = np.argsort(-dists[qi], kind="stable")[:args.top_k]
                stack = np.stack([dataset.load_image(qi)] +
                                 [dataset.load_image(int(r)) for r in ranks])
            else:
                stack = dataset.load_image(qi)[None].repeat(2, axis=0)
            maps = simatt_saliency(feats, head_fn, prep(stack), n_pos=1)
        elif args.explainer == "simcam":
            maps = simcam_maps(feats(prep(dataset.load_image(qi)[None]))[0],
                               feats(prep(dataset.load_image((qi + 1) % len(dataset))[None])),
                               out_hw=(size, size))
        else:
            maps = rollout_maps(model, prep(dataset.load_image(qi)[None]), size)
        np.save(os.path.join(args.save_dir, f"{args.explainer}_q{qi:05d}.npy"),
                maps.cpu().numpy())
    print(f">> saved {args.explainer} maps for {n_q} images to {args.save_dir}")
    return n_q


def gradcam_maps(args, dataset, model, embed, prep, size: int):
    """Grad-CAM of cosine(query, retrieved) on the ViT tokens (reference
    medsiglip_saliency.py:51-131) for the first ``--limit`` queries (16 by
    default): each query's top-k of ``--results``, or the next image, one
    ``gradcam_q{query:05d}_r{retrieved:05d}.npy`` a pair. Returns the count
    of queries."""
    from ..xai import make_vit_gradcam_fn, vit_gradcam_similarity

    apply_fn = make_vit_gradcam_fn(model)
    dists = np.load(args.results, allow_pickle=True)["dists"] if args.results else None
    n_q = args.limit or min(len(dataset), 16)
    for qi in range(n_q):
        if dists is not None:
            ranks = np.argsort(-dists[qi], kind="stable")[:args.top_k]
        else:
            ranks = np.asarray([(qi + 1) % len(dataset)])
        q_img = prep(dataset.load_image(qi)[None])
        r_imgs = prep(np.stack([dataset.load_image(int(r)) for r in ranks]))
        maps = vit_gradcam_similarity(apply_fn, embed(q_img)[0], r_imgs,
                                      out_hw=(size, size)).cpu().numpy()
        for j, r in enumerate(ranks):
            np.save(os.path.join(args.save_dir, f"gradcam_q{qi:05d}_r{int(r):05d}.npy"), maps[j])
    print(f">> saved grad-CAM similarity maps for {n_q} queries to {args.save_dir}")
    return n_q


if __name__ == "__main__":
    main()
