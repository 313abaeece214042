"""Anomaly / OOD evaluation CLI (port of xmir_tpu/cli/anomaly.py; reference
anomaly/test_anomaly.py): embed the anomaly-free training split and the
whole test split on the device, score each test item by its distance to the
in-distribution class centroids, report AUROC / AUPR / FPR@95.

    python -m xmir_tpu_torch.cli.anomaly --dataset covid --dataset-dir DATA \\
        --model resnet50 --device cuda --save-dir anomaly_out
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .common import (
    add_dataset_args,
    add_model_args,
    build_dataset,
    build_model,
    resolve_device,
    set_tf32,
)


def main(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch anomaly detection eval")
    add_dataset_args(p)
    add_model_args(p)
    p.add_argument("--eval-batch-size", default=64, type=int)
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--anomaly-class", default=2, type=int,
                   help="Held-out class id (COVID-19=2, melanoma=2)")
    p.add_argument("--save-dir", default="")
    args = p.parse_args(argv)
    set_tf32(False)  # embed in IEEE f32, as the JAX CLI's f32 forward

    from ..analysis import evaluate_anomaly
    from ..data.pipeline import embed_dataset
    from ..train import make_embed_fn

    device = resolve_device(args)
    args.anomaly = True  # train split excludes the anomaly class
    train_ds = build_dataset(args, "train")
    args.anomaly = False
    test_ds = build_dataset(args, "test")
    model, spec = build_model(args, device)
    embed = make_embed_fn(model)

    tr_e, tr_l = embed_dataset(train_ds, embed, spec, device=device,
                               batch_size=args.eval_batch_size, num_workers=args.workers)
    te_e, te_l = embed_dataset(test_ds, embed, spec, device=device,
                               batch_size=args.eval_batch_size, num_workers=args.workers)
    res = evaluate_anomaly(tr_e.cpu().numpy(), tr_l, te_e.cpu().numpy(), te_l,
                           anomaly_class=args.anomaly_class)
    print(f"FPR95:\t{100 * res['fpr@95']:.2f}")
    print(f"AUROC:\t{100 * res['auroc']:.2f}")
    print(f"AUPR:\t{100 * res['aupr']:.2f}")
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        np.savez(
            os.path.join(args.save_dir, "anomaly_results.npz"),
            auroc=res["auroc"], aupr=res["aupr"], fpr=res["fpr@95"],
            scores=res["scores"], labels=te_l,
        )
        print(f">> saved to {args.save_dir}/anomaly_results.npz")
    return res


if __name__ == "__main__":
    main()
