"""ATH hashing retrieval evaluation CLI (port of xmir_tpu/cli/test_ath.py;
reference test_ath.py): hash codes of the gallery (train) and query (test)
splits, Hamming (``--binary-codes``) or L2 retrieval, mHR / mAP / mRR / mP@K
/ R@K / majority accuracy per top-K and the type head's classification
accuracy.

    python -m xmir_tpu_torch.cli.test_ath --dataset covid --dataset-dir DATA \\
        --resume ath.pt --binary-codes --device cuda

``--resume`` is a ``.pt`` that cli.train_ath wrote, read strictly:
``--hash-size``, ``--num-classes`` and ``--image-size`` must be the trained
model's (the JAX CLI's non-strict merge keeps mismatched leaves from init).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .common import add_dataset_args, build_dataset, resolve_device, set_tf32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch ATH retrieval eval")
    add_dataset_args(p)
    p.add_argument("--resume", required=True, help="A .pt that cli.train_ath wrote")
    p.add_argument("--hash-size", default=48, type=int)
    p.add_argument("--num-classes", default=3, type=int)
    p.add_argument("--image-size", default=256, type=int)
    p.add_argument("--batch-size", default=64, type=int)
    p.add_argument("--binary-codes", action="store_true")
    p.add_argument("--topk", type=int, nargs="+", default=[1, 5, 10])
    p.add_argument("--save-json", default="")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def extract(model, ds, batch_size: int, image_size: int, device):
    """(codes (N, bits), logits (N, classes), labels (N,)) as numpy, in the
    dataset's order."""
    from ..data.pipeline import batch_iterator
    from ..data.transforms import normalize
    from ..models.embedders import IMAGENET_MEAN, IMAGENET_STD

    codes, logits, labels = [], [], []
    with torch.inference_mode():
        for imgs, labs, _ in batch_iterator(ds, batch_size, image_size=image_size):
            x = normalize(torch.from_numpy(imgs).to(device), IMAGENET_MEAN, IMAGENET_STD)
            out = model(x)
            codes.append(out["hash_codes"].float().cpu().numpy())
            logits.append(out["logits"].float().cpu().numpy())
            labels.extend(np.asarray(labs).tolist())
    return np.concatenate(codes), np.concatenate(logits), np.asarray(labels)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args)
    set_tf32(False)  # the L2 scores in IEEE f32, as the JAX CLI's

    from ..analysis import hash_retrieval_metrics
    from ..models.convert import load_torch_checkpoint
    from ..models.embedders import ATHEmbedder

    model = ATHEmbedder(args.hash_size, args.num_classes, args.image_size,
                        generator=torch.Generator().manual_seed(args.seed))
    load_torch_checkpoint(model, args.resume)
    model = model.to(device=device, memory_format=torch.channels_last).eval()

    gallery = build_dataset(args, "train")
    query = build_dataset(args, "test")
    g_codes, _, g_labels = extract(model, gallery, args.batch_size, args.image_size, device)
    q_codes, q_logits, q_labels = extract(model, query, args.batch_size, args.image_size, device)
    res = hash_retrieval_metrics(
        q_codes, q_labels, g_codes, g_labels, q_logits,
        topk_values=tuple(args.topk), binary_codes=args.binary_codes, device=device,
    )
    print(f"classification acc: {res['classification_acc'] * 100:.2f}%")
    for k, m in res["retrieval"].items():
        print(f"top-{k}: mHR {m['mhr']:.4f}  mAP {m['map']:.4f}  "
              f"mRR {m['mrr']:.4f}  mP@K {m['mp@k']:.4f}  "
              f"majority {m['majority_acc']:.4f}")
    if args.save_json:
        with open(args.save_json, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
