"""Metric-learning training CLI (port of xmir_tpu/cli/train.py), the
reference train.py equivalent.

Reference flow (train.py:645-1260): model select, loss auto-select, PK batch
sampling, Adam + grad-clip 5.0 with backbone / head learning-rate groups,
eval every N epochs with cosine mAP / R@K, best-mAP checkpointing.

    python -m xmir_tpu_torch.cli.train --dataset synthetic --device cuda \
        --model dinov2 --bf16 -p 2 -k 4 --epochs 2 --save-dir checkpoints

Training asks cuDNN for its deterministic algorithms, so that two runs of
the same steps, and a run resumed from a checkpoint, agree bit for bit. It
sets PyTorch's two TF32 switches off (IEEE f32 matmuls and convolutions), as
``cli.test`` and ``cli.ingest`` do by default: a model is trained, and its
best checkpoint picked, in the arithmetic it is then evaluated in.

``--loss-name dual_branch`` trains an NIH dual-head model (``nih_dinov2``,
``nih_convnextv2``) with the contrastive + asymmetric loss and logs both terms
to ``--metrics-log``; a distillation model (``convnextv2_*_distill``) trains
through the embedding step, as in the JAX CLI, on its student alone.

``--use-mesh`` trains data-parallel over a torch.distributed world
(parallel/mesh.py: torchrun's ranks, else a world of 1): rank r decodes and
augments its rows of each global batch with the draws a world of 1 makes for
them, the loss is taken on the gathered global batch, BatchNorm uses the
global batch's statistics, and the gradients are summed across ranks
(parallel/data_parallel.py). ``--fsdp`` also shards the master weights and
both Adam moments of the large leaves; a checkpoint is written whole, in the
world-1 layout, by rank 0. ``--cache-dir`` fills a decoded-image cache during
the first epoch and serves later epochs from it (data/cache.py).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from .common import (
    add_dataset_args,
    add_mesh_arg,
    add_model_args,
    build_dataset,
    build_model,
    data_mesh,
    is_multilabel,
    is_writer,
    resolve_device,
    set_tf32,
)

# the first component of each ported embedder's backbone parameters. The JAX
# package labels by the path prefix "backbone", so a distillation model's
# student (student.convnext.*) and teacher (teacher.*) are "head" there and
# here, and --freeze-backbone freezes nothing on it
BACKBONE_PREFIXES = ("backbone.", "densenet121.", "convnext.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="xmir-tpu-torch embedding learning")
    add_dataset_args(p)
    add_model_args(p)
    p.add_argument("--rand-resize", action="store_true")
    p.add_argument("-p", "--labels-per-batch", default=3, type=int)
    p.add_argument("-k", "--samples-per-label", default=16, type=int)
    p.add_argument("--batch-size", default=None, type=int)
    p.add_argument("--eval-batch-size", default=64, type=int)
    p.add_argument("--epochs", default=20, type=int)
    p.add_argument("--eval-freq", default=2, type=int)
    p.add_argument("-j", "--workers", default=8, type=int)
    p.add_argument("--lr", default=0.0001, type=float)
    p.add_argument("--margin", default=0.2, type=float)
    p.add_argument(
        "--loss-name", default=None,
        choices=["triplet", "triplet_hard", "weighted_multilabel_triplet",
                 "jaccard_supcon", "supcon", "dual_branch"],
    )
    p.add_argument("--supcon-temperature", default=0.07, type=float)
    p.add_argument("--dual-asl-alpha", default=1.0, type=float)
    p.add_argument("--asl-gamma-pos", default=1.0, type=float)
    p.add_argument("--asl-gamma-neg", default=4.0, type=float)
    p.add_argument("--asl-clip", default=0.05, type=float)
    p.add_argument("--print-freq", default=5, type=int)
    p.add_argument("--save-dir", default="./checkpoints")
    p.add_argument("--use-random-sampler", action="store_true")
    p.add_argument("--weight-decay", default=0.0, type=float)
    p.add_argument("--backbone-lr-scale", default=0.1, type=float)
    p.add_argument("--freeze-backbone", action="store_true")
    add_mesh_arg(p)
    p.add_argument("--fsdp", action="store_true",
                   help="With --use-mesh: also shard the large leaves' master weights and "
                        "Adam moments over the ranks (per-rank optimiser state scales "
                        "1 / world)")
    p.add_argument("--metrics-log", default="",
                   help="Append per-step/eval metrics as JSONL (observability)")
    p.add_argument("--cache-dir", default="",
                   help="Write-through decoded-image cache: epoch 1 decodes at pipeline "
                        "speed while filling the memmap; later epochs read it "
                        "(data/cache.py WriteThroughCache)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 mixed precision (AMP equivalent: f32 master params, bf16 compute)")
    p.add_argument("--accum-steps", default=1, type=int,
                   help="Gradient accumulation: update params every N batches")
    p.add_argument("--remat", action="store_true",
                   help="Recompute the forward pass in the backward (gradient checkpointing)")
    p.add_argument("--ckpt-every", default=10, type=int,
                   help="Periodic checkpoint interval in epochs")
    p.add_argument("--eval-initial", action="store_true",
                   help="Eval the untrained model before epoch 1 (logged as epoch 0) so the "
                        "metrics log shows the full learning curve")
    return p.parse_args(argv)


def _log_jsonl(path, record):
    with open(path, "a") as f:
        f.write(json.dumps(record, default=float) + "\n")


def select_loss(args) -> str:
    if args.loss_name:
        return args.loss_name
    from ..losses import auto_select_loss

    return auto_select_loss(args.dataset, args.model)


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    """The augmentation generator of one epoch, derived from (seed, epoch):
    a run resumed at epoch k replays the draws of an uninterrupted one."""
    return torch.Generator().manual_seed(seed * 1_000_003 + epoch)


def build_train_optimizer(model, args):
    """The CLI's optimiser: Adam(W) with the backbone at --backbone-lr-scale
    and, under --freeze-backbone, the backbone's parameters frozen; a
    parameter is the backbone's when its name starts with one of
    BACKBONE_PREFIXES."""
    from ..train import build_optimizer

    return build_optimizer(
        model, lr=args.lr, backbone_lr_scale=args.backbone_lr_scale,
        weight_decay=args.weight_decay, backbone_prefixes=BACKBONE_PREFIXES,
        frozen_predicate=(lambda name: name.startswith(BACKBONE_PREFIXES))
        if args.freeze_backbone else None,
    )


def build_train_step(model, loss_name, args, mesh=None):
    """The step cli.train runs: the dual-branch step for ``dual_branch``,
    else the embedding step with the loss's margin or temperature; the loss
    on the global batch of ``mesh`` where there is one."""
    from ..train import make_dual_branch_train_step, make_embedding_train_step

    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    if loss_name == "dual_branch":
        return make_dual_branch_train_step(
            model, asl_alpha=args.dual_asl_alpha, temperature=args.supcon_temperature,
            gamma_pos=args.asl_gamma_pos, gamma_neg=args.asl_gamma_neg, clip=args.asl_clip,
            compute_dtype=compute_dtype, mesh=mesh)
    kwargs = {}
    if loss_name in ("triplet", "triplet_hard", "weighted_multilabel_triplet"):
        kwargs["margin"] = args.margin
    elif loss_name in ("supcon", "jaccard_supcon"):
        kwargs["temperature"] = args.supcon_temperature
    return make_embedding_train_step(model, loss_name, kwargs, compute_dtype=compute_dtype,
                                     remat=args.remat, mesh=mesh)


def epoch_batches(indices, batch_size: int, mesh=None):
    """The full batches of one epoch's index stream (a partial last batch
    is dropped), each cut to this rank's rows under ``mesh``."""
    world, rank = (1, 0) if mesh is None else (mesh.n_data, mesh.data_rank)
    local = batch_size // world
    return [indices[i + rank * local:i + (rank + 1) * local]
            for i in range(0, len(indices) - batch_size + 1, batch_size)]


def main(argv=None):
    args = parse_args(argv)
    if args.fsdp and not args.use_mesh:
        raise SystemExit("--fsdp shards params over the mesh data axis and requires "
                         "--use-mesh; asked-for ZeRO-3 would otherwise be silently ignored")
    loss_name = select_loss(args)
    device = resolve_device(args)
    with data_mesh(args, device) as mesh:
        return _train(args, loss_name, mesh.device if mesh else device, mesh)


def _train(args, loss_name, device, mesh):
    np.random.seed(args.seed)
    # cuDNN's default backward-filter algorithms add up with atomics, so two
    # runs of the same steps differ in their last bits; a resumed run is to
    # continue exactly, so training takes cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic = True
    set_tf32(False)
    write = is_writer(mesh)

    train_ds = build_dataset(args, "train")
    try:
        val_ds = build_dataset(args, "val")
    except (FileNotFoundError, ValueError):
        val_ds = None
        print(">> no validation manifest found; skipping in-training eval")

    model, spec = build_model(args, device, train=True)
    print(f">> model={args.model} loss={loss_name} dataset={args.dataset} device={device}")

    from ..data.pipeline import decode_batches, embed_dataset
    from ..data.samplers import MultiLabelBalancedBatchSampler, PKSampler
    from ..data.transforms import preprocess_for_spec
    from ..metrics import train_eval_multilabel, train_eval_single_label
    from ..train import TrainState, make_embed_fn, with_grad_accumulation
    from ..utils import BestCheckpointPolicy, checkpoint_name, load_checkpoint, save_checkpoint
    from ..utils.checkpoint import is_train_checkpoint

    if args.cache_dir:
        from ..data.cache import WriteThroughCache

        train_ds = WriteThroughCache(train_ds, args.cache_dir, spec.resize_size,
                                     interpolation=spec.interpolation, mesh=mesh)
        print(f">> decoded-image cache at {args.cache_dir}: "
              + ("complete (memmap reads)" if train_ds.complete
                 else "filling (write-through during epoch 1)"))

    optimizer = build_train_optimizer(model, args)
    if mesh is None:
        state = TrainState(model, optimizer)
    else:
        from ..parallel.data_parallel import MeshTrainState, sync_batch_norm

        sync_batch_norm(model, mesh)
        state = MeshTrainState(model, optimizer, mesh=mesh, fsdp=args.fsdp)
        print(f">> {'FSDP' if args.fsdp else 'data-parallel'} over a world of {mesh.world}"
              + (f" ({len(state.sharded())} leaves sharded)" if args.fsdp else ""))
    if args.accum_steps > 1:
        state = with_grad_accumulation(state, args.accum_steps)
        print(f">> gradient accumulation over {args.accum_steps} microbatches")

    # Full-state resume: build_model already loaded the parameters and
    # buffers; a checkpoint of this CLI also restores the optimiser state,
    # step and epoch, so resume is exact (the reference restarts at epoch 1
    # with a fresh optimiser, train.py:767-778).
    start_epoch = 1
    if args.resume:
        loaded = load_checkpoint(args.resume, unwrap=False)
        if is_train_checkpoint(loaded):
            try:
                state.load_optimizer_state(loaded["optimizer"])
            except (ValueError, KeyError) as exc:
                print(f">> the checkpoint's optimiser state does not match the optimiser "
                      f"({exc}); resuming params only")
            else:
                state.step = int(loaded.get("step", 0))
                start_epoch = int(loaded.get("epoch", 0)) + 1
                print(f">> resumed optimizer state at step {state.step}; continuing from "
                      f"epoch {start_epoch}")

    step = build_train_step(model, loss_name, args, mesh)

    batch_size = args.batch_size or args.labels_per_batch * args.samples_per_label
    world = 1 if mesh is None else mesh.n_data
    if batch_size % world:
        raise ValueError(f"the batch of {batch_size} does not split over {world} ranks")
    multilabel = is_multilabel(args.dataset)
    name_kwargs = dict(dataset=args.dataset, model=args.model, embedding_dim=args.embedding_dim,
                       anomaly=args.anomaly, rand_resize=args.rand_resize, seed=args.seed)
    policy = BestCheckpointPolicy(args.save_dir, name_kwargs, periodic_every=args.ckpt_every,
                                  write=write)
    embed = make_embed_fn(model)

    def evaluate():
        """The validation metrics of the current weights, in eval mode."""
        state.gather_params()
        model.eval()
        try:
            embeds, labels = embed_dataset(val_ds, embed, spec, device=device,
                                           batch_size=args.eval_batch_size,
                                           num_workers=args.workers, mesh=mesh)
            return (train_eval_multilabel(embeds, labels) if multilabel
                    else train_eval_single_label(embeds, labels))
        finally:
            model.train()

    def log_record(record):
        if args.metrics_log and write:
            _log_jsonl(args.metrics_log, record)

    if args.eval_initial and val_ds is not None and start_epoch == 1:
        m = evaluate()
        print(f">> val (untrained): mAP={m['mAP']:.3f}% R@1={m['R@1']:.3f}%")
        log_record({"kind": "eval", "epoch": 0, "time": time.time(), **m})

    shard = (0, 1) if mesh is None else (mesh.data_rank, mesh.n_data)
    for epoch in range(start_epoch, args.epochs + 1):
        generator = epoch_generator(args.seed, epoch)
        if args.use_random_sampler:
            indices = np.random.default_rng(args.seed + epoch).permutation(len(train_ds)).tolist()
        elif multilabel:
            # label-aware batches (reference MultiLabelBalancedBatchSampler,
            # nih_multilabel_retrieval.py:351-411)
            ml_sampler = MultiLabelBalancedBatchSampler(
                np.asarray(train_ds.labels), batch_size=batch_size,
                labels_per_batch=min(8, np.asarray(train_ds.labels).shape[1]),
                samples_per_label=4, seed=args.seed + epoch,
            )
            indices = [i for batch in ml_sampler for i in batch]
        else:
            indices = list(PKSampler(list(train_ds.labels), args.labels_per_batch,
                                     args.samples_per_label, seed=args.seed + epoch))
        t0 = time.time()
        for i, (imgs, labs, _) in enumerate(decode_batches(
                train_ds, epoch_batches(indices, batch_size, mesh), spec.resize_size,
                num_workers=args.workers, interpolation=spec.interpolation)):
            x = preprocess_for_spec(torch.from_numpy(imgs).to(device), spec, train=True,
                                    generator=generator, rand_resize=args.rand_resize,
                                    shard=shard)
            metrics = step(state, x, torch.from_numpy(np.asarray(labs)).to(device))
            if i % args.print_freq == 0:
                loss = float(metrics["loss"])
                # emergency halt on divergence (reference train.py:332-336),
                # checked on every fetched loss rather than every step to
                # avoid a per-step device sync
                if not math.isfinite(loss):
                    print(f"[ERROR] Non-finite loss at iter {i}, epoch {epoch}: {loss}")
                    raise ValueError("Training diverged: non-finite loss detected")
                print(f"epoch {epoch} step {i}: loss {loss:.4f}")
                # the dual-branch step's two terms beside the loss
                terms = {k: float(metrics[k]) for k in ("contrastive", "asl") if k in metrics}
                log_record({"kind": "train", "epoch": epoch, "step": i, "loss": loss, **terms,
                            "time": time.time()})
        if args.cache_dir and mesh is not None:
            train_ds.sync()
        print(f">> epoch {epoch} done in {time.time() - t0:.1f}s")

        ckpt_tree = dict(state.state_dict(), epoch=epoch)
        ran_eval = val_ds is not None and epoch % args.eval_freq == 0
        if epoch % args.ckpt_every == 0 and not ran_eval and write:
            save_checkpoint(
                os.path.join(args.save_dir,
                             checkpoint_name(**name_kwargs, epoch=epoch, is_best=False)),
                ckpt_tree, metadata={"epoch": epoch})
        if ran_eval:
            m = evaluate()
            print(f">> val: mAP={m['mAP']:.3f}% R@1={m['R@1']:.3f}% R@5={m['R@5']:.3f}% "
                  f"R@10={m['R@10']:.3f}%")
            log_record({"kind": "eval", "epoch": epoch, "time": time.time(), **m})
            saved = policy.update(epoch, m["mAP"], ckpt_tree)
            if saved:
                print(f">> new best mAP {m['mAP']:.3f}% -> {saved}")

    print(f">> training complete; best mAP {policy.best_metric:.3f}% "
          f"(epoch {policy.best_epoch})")
    return policy.best_metric


if __name__ == "__main__":
    main()
