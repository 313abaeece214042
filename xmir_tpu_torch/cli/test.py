"""Retrieval evaluation CLI (port of xmir_tpu/cli/test.py, the reference
test.py equivalent).

    python -m xmir_tpu_torch.cli.test --dataset covid --model swinv2 \
        --device cuda --save-dir results/

Flow (test.py:1065-1126): embed the test set, build the similarity matrix on
the device (negative L2, diagonal -inf), compute R@K + trapezoid mAP/mP@K +
majority-vote classification metrics, save an .npz artifact with
embeds/labels/dists/metrics. Multi-label datasets use the Jaccard-threshold
evaluation (test.py:941-1062). ``--model biomedclip`` takes the zero-shot
branch (test.py:237-347): class prompts through the BiomedCLIP text tower
against the image embeddings, then the single-label suite on cosine
similarities, saved as ``biomedclip_zeroshot.npz``.

    python -m xmir_tpu_torch.cli.test --dataset covid --model biomedclip \
        --device cuda --vocab vocab.txt --resume biomedclip_open_clip.pt

``--use-mesh`` embeds the test set over a data-parallel world
(parallel/mesh.py); rank 0 writes the artifact.
"""
from __future__ import annotations

import argparse
import json
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
    is_multilabel,
    is_writer,
    resolve_device,
)


def single_label_metrics(dists: np.ndarray, labels: np.ndarray) -> dict:
    """Full single-label metric suite from a (N, N) similarity matrix
    (negative L2, diagonal -inf)."""
    from ..metrics import (
        compute_classification_metrics,
        compute_map,
        retrieval_recall_at_k,
    )

    topk = (1, 5, 10)
    recalls = retrieval_recall_at_k(dists, labels, topk)
    ranks = np.argsort(-dists, axis=1, kind="stable").T  # (db, nq)
    kappas = [1, 5, 10]
    mAP, aps, pr, _ = compute_map(ranks, labels, kappas)
    cls = compute_classification_metrics(labels, dists)

    return {
        **{f"R@{k}": r for k, r in zip(topk, recalls)},
        "mAP": mAP * 100.0,
        **{f"mP@{k}": p * 100.0 for k, p in zip(kappas, pr)},
        "classification": cls,
    }


def evaluate_single_label(embeds, labels: np.ndarray, save_dir=None, device=None):
    """Score ``embeds`` against themselves on ``device`` and report the
    single-label suite. Arrays need the device named; a tensor may leave it
    out and is scored where it lies (metrics.on_device)."""
    from ..metrics import fill_diagonal_neg_inf, on_device, pairwise_neg_l2

    e = on_device(embeds, device)
    dists = fill_diagonal_neg_inf(pairwise_neg_l2(e)).cpu().numpy()
    embeds = e.cpu().numpy() if torch.is_tensor(embeds) else embeds
    metrics = single_label_metrics(dists, labels)
    cls = metrics["classification"]
    print(f">> R@1 {metrics['R@1']:.2f}  R@5 {metrics['R@5']:.2f}  "
          f"R@10 {metrics['R@10']:.2f}")
    print(f">> mAP {metrics['mAP']:.2f}  mP@1 {metrics['mP@1']:.2f}  "
          f"mP@5 {metrics['mP@5']:.2f}  mP@10 {metrics['mP@10']:.2f}")
    for k in (1, 5):
        print(f">> majority-vote@{k}: acc {cls[k]['accuracy']:.2f}  "
              f"f1_macro {cls[k]['f1_macro']:.2f}")
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.savez(
            os.path.join(save_dir, "evaluation_results.npz"),
            embeds=embeds, labels=labels, dists=dists,
            metrics=json.dumps(metrics, default=float),
        )
        print(f">> Results saved to {save_dir}/evaluation_results.npz")
    return metrics


def multilabel_metrics(sims: np.ndarray, labels: np.ndarray) -> dict:
    """Jaccard-threshold multilabel suite from a (N, N) cosine matrix with
    diagonal -inf."""
    from ..metrics import compute_map_multilabel, multilabel_precision_recall_at_k

    metrics = {}
    for t in (0.25, 0.5):
        metrics[f"mAP@jaccard>{t}"] = compute_map_multilabel(sims, labels, t) * 100.0
    pr = multilabel_precision_recall_at_k(sims, labels)
    for k, v in pr.items():
        metrics[f"P@{k}"] = v["precision"]
        metrics[f"R@{k}"] = v["recall"]
    return metrics


def evaluate_multilabel(embeds, labels: np.ndarray, save_dir=None, device=None):
    """The multi-label suite; the device as in evaluate_single_label."""
    from ..metrics import fill_diagonal_neg_inf, on_device, pairwise_cosine

    e = on_device(embeds, device)
    sims = fill_diagonal_neg_inf(pairwise_cosine(e)).cpu().numpy()
    embeds = e.cpu().numpy() if torch.is_tensor(embeds) else embeds
    metrics = multilabel_metrics(sims, labels)
    for t in (0.25, 0.5):
        print(f">> mAP (Jaccard > {t}): {metrics[f'mAP@jaccard>{t}']:.2f}%")
    for key in metrics:
        if key.startswith("P@"):
            k = key[2:]
            print(f"K={k:<3} P@K {metrics[key]:.2f}%  R@K {metrics['R@' + k]:.2f}%")
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        np.savez(
            os.path.join(save_dir, "evaluation_results.npz"),
            embeds=embeds, labels=labels,
            metrics=json.dumps(metrics, default=float),
        )
    return metrics


DATASET_LABEL_NAMES = {
    # reference get_dataset_label_names (test.py:226-234)
    "covid": ["normal", "pneumonia", "COVID-19"],
    "isic": ["nevus", "seborrheic keratosis", "melanoma"],
    "tbx11k": ["tuberculosis", "healthy", "sick but no tuberculosis"],
    "synthetic": ["class 0", "class 1", "class 2"],
}


def evaluate_clip_zeroshot(model, dataset, spec, args, device):
    """BiomedCLIP-style zero-shot classification + image-image retrieval
    (reference evaluate_biomedclip_zeroshot, test.py:237-347) on ``device``:
    prompt-template text features against the image embeddings -> argmax
    predictions, accuracy and macro P/R/F1, then the single-label suite on
    the cosine matrix (diagonal -inf), saved as
    <save_dir>/biomedclip_zeroshot.npz with the JAX CLI's keys."""
    from ..data.pipeline import embed_dataset
    from ..data.wordpiece import build_text_tokenizer
    from ..metrics import fill_diagonal_neg_inf
    from ..metrics.retrieval import _prf
    from ..ops.distance import l2_normalize
    from ..train import make_embed_fn

    class_names = (args.class_names.split(",") if args.class_names
                   else DATASET_LABEL_NAMES[args.dataset])
    prompts = [args.prompt_template.format(label=c) for c in class_names]
    print(f">> zero-shot prompts: {prompts}")
    tok = build_text_tokenizer(args.vocab or None, max_len=64)
    ids, mask = tok.encode_padded(prompts, 64)
    with torch.inference_mode():
        text = model.encode_text(torch.from_numpy(ids).long().to(device),
                                 torch.from_numpy(mask).to(device))
    text = l2_normalize(text.float(), dim=1)

    embeds, labels = embed_dataset(dataset, make_embed_fn(model), spec, device=device,
                                   batch_size=args.eval_batch_size, num_workers=args.workers)
    labels = np.asarray(labels).astype(int)
    preds = torch.argmax(embeds @ text.T, dim=1).cpu().numpy()

    acc = float((preds == labels).mean()) * 100.0
    pm, rm, fm = _prf(labels, preds, "macro")
    print(f">> zero-shot accuracy {acc:.2f}%  macro P/R/F1 "
          f"{pm * 100:.2f}/{rm * 100:.2f}/{fm * 100:.2f}")

    # retrieval on cosine similarity (this reference path uses cosine, not
    # the non-CLIP neg-L2 convention: test.py:299-300)
    sims = fill_diagonal_neg_inf(embeds @ embeds.T).cpu().numpy()
    metrics = single_label_metrics(sims, labels)
    metrics.update({
        "zero_shot_accuracy": acc,
        "zero_shot_precision_macro": pm * 100.0,
        "zero_shot_recall_macro": rm * 100.0,
        "zero_shot_f1_macro": fm * 100.0,
    })
    print(f">> R@1 {metrics['R@1']:.2f}  mAP {metrics['mAP']:.2f}")
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        np.savez(
            os.path.join(args.save_dir, "biomedclip_zeroshot.npz"),
            embeds=embeds.cpu().numpy(), labels=labels, dists=-sims, predictions=preds,
            class_names=np.asarray(class_names), text_prompts=np.asarray(prompts),
            metrics=json.dumps(metrics, default=float),
        )
    return metrics


def build_biomedclip(args, device):
    """(BiomedCLIPModel in eval mode on ``device``, its spec) at the --clip-*
    widths, seeded from --seed; --resume takes an open_clip-layout .pt,
    loaded strictly (models/convert.py::load_torch_checkpoint)."""
    import dataclasses

    from ..models.biomedclip import BiomedCLIPModel
    from ..models.convert import load_torch_checkpoint
    from ..models.registry import get_spec

    spec = get_spec("biomedclip")
    if args.clip_image_size != spec.input_size:
        spec = dataclasses.replace(spec, input_size=args.clip_image_size,
                                   resize_size=args.clip_image_size)
    model = BiomedCLIPModel(img_size=args.clip_image_size, vision_dim=args.clip_dim,
                            vision_depth=args.clip_depth, text_dim=args.clip_dim,
                            text_depth=args.clip_depth,
                            generator=torch.Generator().manual_seed(args.seed))
    if args.resume:
        if not args.resume.endswith((".pt", ".pth")):
            raise ValueError(f"--resume takes a torch .pt/.pth state dict, got {args.resume!r}")
        load_torch_checkpoint(model, args.resume)
    return model.to(device=device, memory_format=torch.channels_last).eval(), spec


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch retrieval evaluation")
    add_dataset_args(p)
    add_model_args(p)
    p.add_argument("--eval-batch-size", default=64, type=int)
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--save-dir", default="", help="Directory for .npz results")
    p.add_argument("--prompt-template", default="this is a medical image of {label}",
                   help="Zero-shot prompt (reference test.py:1511)")
    p.add_argument("--class-names", default="",
                   help="Comma-separated label names for zero-shot prompts")
    p.add_argument("--vocab", default="", help="vocab.txt for WordPiece")
    p.add_argument("--clip-depth", default=12, type=int,
                   help="biomedclip tower depth (reduce for smoke runs)")
    p.add_argument("--clip-dim", default=768, type=int)
    p.add_argument("--clip-image-size", default=224, type=int)
    add_precision_args(p)
    add_mesh_arg(p)
    args = p.parse_args(argv)
    apply_score_precision(args)

    from ..data.pipeline import embed_dataset
    from ..train import make_embed_fn

    device = resolve_device(args)
    dataset = build_dataset(args, "test")
    if args.model == "biomedclip":
        model, spec = build_biomedclip(args, device)
        return evaluate_clip_zeroshot(model, dataset, spec, args, device)
    with data_mesh(args, device) as mesh:
        device = mesh.device if mesh else device
        model, spec = build_model(args, device)
        print(f">> embedding {len(dataset)} images with {args.model} ...")
        embeds, labels = embed_dataset(dataset, make_embed_fn(model), spec, device=device,
                                       batch_size=args.eval_batch_size,
                                       num_workers=args.workers, mesh=mesh)
        embeds, labels = embeds.cpu().numpy(), np.asarray(labels)
        # every rank holds the whole gathered set and scores it alike; rank 0 writes
        save_dir = (args.save_dir or None) if is_writer(mesh) else None
        if is_multilabel(args.dataset):
            return evaluate_multilabel(embeds, labels, save_dir, device)
        return evaluate_single_label(embeds, labels, save_dir, device)


if __name__ == "__main__":
    main()
