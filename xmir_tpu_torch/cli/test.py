"""Retrieval evaluation CLI (port of xmir_tpu/cli/test.py, the reference
test.py equivalent).

    python -m xmir_tpu_torch.cli.test --dataset covid --model swinv2 \
        --device cuda --save-dir results/

Flow (test.py:1065-1126): embed the test set, build the similarity matrix on
the device (negative L2, diagonal -inf), compute R@K + trapezoid mAP/mP@K +
majority-vote classification metrics, save an .npz artifact with
embeds/labels/dists/metrics. Multi-label datasets use the Jaccard-threshold
evaluation (test.py:941-1062). The zero-shot branch (``--model biomedclip``)
waits for the BiomedCLIP towers (ROADMAP item 6).
"""
from __future__ import annotations

import argparse
import json
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
    is_multilabel,
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


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch retrieval evaluation")
    add_dataset_args(p)
    add_model_args(p)
    p.add_argument("--eval-batch-size", default=64, type=int)
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--save-dir", default="", help="Directory for .npz results")
    add_precision_args(p)
    args = p.parse_args(argv)
    apply_score_precision(args)
    if args.model == "biomedclip":
        raise NotImplementedError(
            "the zero-shot evaluation needs the BiomedCLIP towers, which are not ported to "
            "xmir_tpu_torch yet (ROADMAP.md item 6)")

    from ..data.pipeline import embed_dataset
    from ..train import make_embed_fn

    device = resolve_device(args)
    dataset = build_dataset(args, "test")
    model, spec = build_model(args, device)
    print(f">> embedding {len(dataset)} images with {args.model} ...")
    embeds, labels = embed_dataset(dataset, make_embed_fn(model), spec, device=device,
                                   batch_size=args.eval_batch_size, num_workers=args.workers)
    embeds, labels = embeds.cpu().numpy(), np.asarray(labels)
    if is_multilabel(args.dataset):
        return evaluate_multilabel(embeds, labels, args.save_dir or None, device)
    return evaluate_single_label(embeds, labels, args.save_dir or None, device)


if __name__ == "__main__":
    main()
