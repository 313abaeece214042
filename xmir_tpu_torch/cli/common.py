"""Shared CLI plumbing (port of xmir_tpu/cli/common.py): dataset and model
construction, argparse fragments, the device and score-precision switches."""
from __future__ import annotations

import argparse
import os

import torch


def add_dataset_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset", default="covid",
                   help="Dataset (covid, isic, tbx11k, vindr, nih, synthetic, synthetic_ml)")
    p.add_argument("--dataset-dir", default="./data", help="Dataset directory path")
    p.add_argument("--train-image-list", default="./train_split.txt")
    p.add_argument("--val-image-list", default="./val.txt")
    p.add_argument("--val-dataset-dir", default=None)
    p.add_argument("--test-image-list", default="./test.txt")
    p.add_argument("--mask-dir", default=None)
    p.add_argument("--anomaly", action="store_true",
                   help="Drop the anomaly class (COVID/melanoma) from training")


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--model", default="densenet121")
    p.add_argument("--embedding-dim", default=None, type=int)
    p.add_argument("--image-size", default=None, type=int)
    p.add_argument("--sra-num-heads", default=8, type=int)
    p.add_argument("--sra-lam", default=0.1, type=float)
    p.add_argument("--unfreeze-blocks", default=3, type=int)
    p.add_argument("--num-labels", default=None, type=int,
                   help="Dual-branch classification head size")
    p.add_argument("--resume", default="",
                   help="Checkpoint to load (torch .pt/.pth): a reference / timm state dict, "
                        "or a checkpoint that xmir_tpu_torch.cli.train wrote")
    p.add_argument("--seed", type=int, default=0,
                   help="Seed of the torch.Generator that draws the initial weights")
    p.add_argument("--device", default="cuda",
                   help="Torch device to run on (cuda, cuda:N or cpu)")


def resolve_device(args) -> torch.device:
    """The --device to run on. Asking for CUDA without a usable card raises:
    there is no silent CPU run."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {args.device} asked for CUDA, but torch.cuda.is_available() "
            "is False; pass --device cpu to run on the CPU"
        )
    return device


def build_dataset(args, split: str = "train"):
    from ..data.synthetic import SyntheticImageDataset, SyntheticMultiLabelDataset

    data_dir = args.dataset_dir
    if split == "val" and getattr(args, "val_dataset_dir", None):
        data_dir = args.val_dataset_dir
    manifest = {
        "train": getattr(args, "train_image_list", None),
        "val": getattr(args, "val_image_list", None),
        "test": getattr(args, "test_image_list", None),
    }[split]

    name = args.dataset
    if name == "covid":
        from ..data.datasets import CovidxDataset

        sub = os.path.join(data_dir, split if split != "val" else "train")
        root = sub if os.path.isdir(sub) else data_dir
        return CovidxDataset(
            root, manifest,
            use_covid=not (split == "train" and getattr(args, "anomaly", False)),
            mask_dir=getattr(args, "mask_dir", None),
        )
    if name == "isic":
        from ..data.datasets import ISICDataset

        return ISICDataset(
            data_dir, manifest,
            use_melanoma=not (split == "train" and getattr(args, "anomaly", False)),
        )
    if name == "tbx11k":
        from ..data.datasets import TBX11kDataset

        return TBX11kDataset(data_dir, manifest)
    if name == "vindr":
        from ..data.datasets import VinDrDataset

        return VinDrDataset(data_dir, manifest)
    if name == "nih":
        from ..data.datasets import NIHChestXrayRetrievalDataset

        return NIHChestXrayRetrievalDataset(
            data_dir=data_dir,
            image_list_file=manifest if manifest and os.path.isfile(manifest) else None,
        )
    if name == "synthetic":
        return SyntheticImageDataset(
            n=64 if split == "train" else 32, size=64, seed=0 if split == "train" else 1
        )
    if name == "synthetic_ml":
        return SyntheticMultiLabelDataset(
            n=64 if split == "train" else 32, size=64, seed=0 if split == "train" else 1
        )
    raise ValueError(f"unknown dataset {args.dataset!r}")


def is_multilabel(dataset_name: str) -> bool:
    return dataset_name in ("vindr", "nih", "synthetic_ml")


# models whose output width --embedding-dim does not change
FIXED_WIDTH_MODELS = ("convnextv2_sra", "nih_dinov2", "nih_convnextv2")


def build_model(args, device, train: bool = False):
    """(model on ``device``, spec), in eval mode unless ``train``. Weights
    are drawn from a torch.Generator seeded with --seed, then --resume (a
    torch .pt/.pth state dict) replaces them with a strict load: the whole
    DenseNet121 embedder or open_clip BiomedCLIP model, or a ConvNeXtV2,
    SwinV2, DINOv2, ``nih_dinov2`` or MedSigLIP model's backbone (its fc / SRA
    / PCAM / projection head keeps its init, as the JAX package's
    strict=False merge does), or the whole model from a checkpoint of the
    train CLI (models/convert.py::load_torch_checkpoint). --embedding-dim
    goes to a MedSigLIP model's ``embed_dim``, to every other model's
    ``embedding_dim``."""
    from ..models.convert import load_torch_checkpoint
    from ..models.registry import create_model

    overrides = {"generator": torch.Generator().manual_seed(args.seed)}
    # the SRA and NIH dual-head models' output widths are fixed, as in the
    # reference; a distillation model takes --embedding-dim into its student
    if getattr(args, "embedding_dim", None) and args.model not in FIXED_WIDTH_MODELS:
        overrides["embed_dim" if args.model == "medsiglip" else "embedding_dim"] = (
            args.embedding_dim)
    if getattr(args, "num_labels", None) and args.model == "densenet121":
        overrides["num_labels"] = args.num_labels
    if args.model == "convnextv2_sra":
        overrides.update(num_heads=args.sra_num_heads, lam=args.sra_lam)
    model, spec = create_model(args.model, **overrides)
    resume = getattr(args, "resume", "")
    if resume:
        if not resume.endswith((".pt", ".pth")):
            raise ValueError(f"--resume takes a torch .pt/.pth state dict, got {resume!r}")
        load_torch_checkpoint(model, resume)
    model = model.to(device=device, memory_format=torch.channels_last)
    return model.train(train), spec


def add_precision_args(p: argparse.ArgumentParser):
    p.add_argument(
        "--score-precision", default="highest", choices=["highest", "default"],
        help="'highest' (default for offline eval) runs f32 matmuls and cuDNN "
             "convolutions in IEEE f32 (TF32 off); 'default' lets both use "
             "TF32. The top-k kernel computes f32 scores in IEEE f32 either way.",
    )


def set_tf32(allow: bool):
    """Set PyTorch's two TF32 switches (cuBLAS matmuls, cuDNN convolutions)
    explicitly: cuDNN's default is on, cuBLAS's off."""
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def apply_score_precision(args):
    set_tf32(args.score_precision == "default")
