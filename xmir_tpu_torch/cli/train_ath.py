"""ATH deep-hashing trainer CLI (port of xmir_tpu/cli/train_ath.py;
reference train_ath.py): online (anchor, positive, negative) triplet
sampling, TripletHashLoss plus cross entropy on the type head, Adam behind a
global-norm clip of 5.0.

    python -m xmir_tpu_torch.cli.train_ath --dataset covid --dataset-dir DATA \\
        --device cuda --epochs 10 --save ath.pt

The weights are drawn from a torch.Generator seeded with ``--seed``, the
triplets from ``numpy.random.default_rng(--seed)`` as in the JAX CLI, so the
two CLIs see the same images in the same order. ``--save`` writes a train
checkpoint (the model's state dict beside its optimiser's), which
``cli.test_ath --resume`` and ``cli.ingest --model ath --resume`` read
strictly.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .common import add_dataset_args, build_dataset, resolve_device, set_tf32


def sample_triplets(labels: np.ndarray, batch: int, rng: np.random.Generator):
    """Online triplet index sampling (reference OnlineTripletDataset,
    train_ath.py:25-66): per anchor a same-class positive and a
    different-class negative, in the JAX CLI's order of draws."""
    labels = np.asarray(labels)
    n = len(labels)
    anchors = rng.integers(0, n, batch)
    pos, neg = [], []
    for a in anchors:
        same = np.nonzero(labels == labels[a])[0]
        diff = np.nonzero(labels != labels[a])[0]
        pos.append(int(rng.choice(same)))
        neg.append(int(rng.choice(diff)))
    return anchors, np.asarray(pos), np.asarray(neg)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch ATH hashing trainer")
    add_dataset_args(p)
    p.add_argument("--hash-size", default=48, type=int)
    p.add_argument("--num-classes", default=3, type=int)
    p.add_argument("--image-size", default=256, type=int)
    p.add_argument("--batch-size", default=32, type=int)
    p.add_argument("--epochs", default=10, type=int)
    p.add_argument("--steps-per-epoch", default=100, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--margin", default=0.5, type=float)
    p.add_argument("--ce-weight", default=1.0, type=float)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (cuda, cuda:N or cpu)")
    p.add_argument("--save", default="./checkpoints/ath.pt")
    return p.parse_args(argv)


def triplet_batch(ds, labels, batch_size: int, image_size: int, rng, device):
    """One step's input: (images (3B, S, S, 3) normalised f32 on ``device``,
    the anchors' labels (B,) int64)."""
    from ..data.pipeline import _decode_batch
    from ..data.transforms import normalize
    from ..models.embedders import IMAGENET_MEAN, IMAGENET_STD

    a, pos, neg = sample_triplets(labels, batch_size, rng)
    imgs, _, _ = _decode_batch(ds, np.concatenate([a, pos, neg]).tolist(), image_size)
    x = normalize(torch.from_numpy(imgs).to(device), IMAGENET_MEAN, IMAGENET_STD)
    return x, torch.from_numpy(labels[a].astype(np.int64)).to(device)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args)
    # as cli.train: deterministic cuDNN and no TF32, so two runs agree bit for bit
    torch.backends.cudnn.deterministic = True
    set_tf32(False)

    from ..models.embedders import ATHEmbedder
    from ..train import GroupedAdam, TrainState, make_ath_train_step
    from ..utils.checkpoint import save_checkpoint

    ds = build_dataset(args, "train")
    labels = np.asarray(ds.labels)
    model = ATHEmbedder(args.hash_size, args.num_classes, args.image_size,
                        generator=torch.Generator().manual_seed(args.seed))
    model = model.to(device=device, memory_format=torch.channels_last).train()
    # the JAX CLI's optax.chain(clip_by_global_norm(5.0), adam(lr)): one group
    optimizer = GroupedAdam({"all": (list(model.parameters()), args.lr)}, clip_norm=5.0)
    state = TrainState(model, optimizer)
    step = make_ath_train_step(model, args.batch_size, args.margin, args.ce_weight)
    rng = np.random.default_rng(args.seed)
    losses = []
    for epoch in range(1, args.epochs + 1):
        t0 = time.time()
        last = {}
        for _ in range(args.steps_per_epoch):
            x, type_labels = triplet_batch(ds, labels, args.batch_size, args.image_size, rng,
                                           device)
            last = step(state, x, type_labels)
            losses.append(last)
        print(f"epoch {epoch}: loss {float(last['loss']):.4f} "
              f"(hash {float(last['hash']):.4f}, ce {float(last['ce']):.4f}) "
              f"in {time.time() - t0:.1f}s")
    save_checkpoint(args.save, state.state_dict())
    print(f">> saved {args.save}")
    return {"losses": [{k: float(v) for k, v in r.items()} for r in losses],
            "save": args.save}


if __name__ == "__main__":
    main()
