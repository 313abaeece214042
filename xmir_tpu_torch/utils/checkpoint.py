"""Checkpoint save / load (port of xmir_tpu/utils/checkpoint.py): single
``torch.save`` files with the reference's metadata-encoding filenames
(train.py:622-642) and tolerant loading ({"state_dict"} / {"state-dict"} /
{"model"} unwrapping, train.py:767-778, test.py:1273-1276).

A train checkpoint is ``TrainState.state_dict()`` plus the epoch:
{"state_dict": parameters and BatchNorm buffers, "optimizer": both Adam
moments, the accumulation buffer and the counts, "step", "epoch"}, so a
resumed run continues exactly. Files are read with ``weights_only=True``:
they hold tensors, numbers, strings, lists and dicts only.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch


def checkpoint_name(dataset: str, model: str, embedding_dim: Optional[int] = None,
                    anomaly: bool = False, rand_resize: bool = False, seed: int = 0,
                    epoch: Optional[int] = None, is_best: bool = False) -> str:
    """Reference filename encoding (train.py:622-642), .pt extension."""
    name = f"{dataset}_{model}"
    if embedding_dim:
        name += f"_embed_{embedding_dim}"
    if anomaly:
        name += "_anomaly"
    if rand_resize:
        name += "_randresize"
    name += f"_seed_{seed}"
    name += "_best_ckpt" if is_best else f"_epoch_{epoch}_ckpt"
    return name + ".pt"


def save_checkpoint(path: str, tree: Any, metadata: Optional[dict] = None) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(tree, path)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)
    return path


def unwrap_state_dict(tree: Any) -> Any:
    """The state dict inside a {"state_dict" | "state-dict" | "model": {...}}
    wrapper, else the tree itself."""
    if isinstance(tree, dict):
        for key in ("state_dict", "state-dict", "model"):
            if isinstance(tree.get(key), dict):
                return tree[key]
    return tree


def is_train_checkpoint(tree: Any) -> bool:
    """Whether ``tree`` is what ``cli.train`` saves: a model's whole state
    dict beside its optimiser's."""
    return isinstance(tree, dict) and isinstance(tree.get("state_dict"), dict) and (
        "optimizer" in tree)


def load_checkpoint(path: str, unwrap: bool = True) -> Any:
    """The file's tree on the CPU. With ``unwrap`` a wrapper gives way to the
    state dict inside it (so a train checkpoint yields its model's state
    dict); without, the whole tree comes back (what a resumed training run
    reads)."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return unwrap_state_dict(tree) if unwrap else tree


class BestCheckpointPolicy:
    """best-mAP + every-N-epochs periodic saving (train.py:1227-1244). With
    ``write=False`` (a data-parallel rank other than 0) it keeps the record
    and returns the paths, but writes nothing."""

    def __init__(self, save_dir: str, name_kwargs: dict, periodic_every: int = 10,
                 write: bool = True):
        self.write = write
        self.save_dir = save_dir
        self.name_kwargs = name_kwargs
        self.periodic_every = periodic_every
        self.best_metric = 0.0
        self.best_epoch = 0

    def _path(self, epoch: int, is_best: bool) -> str:
        return os.path.join(self.save_dir,
                            checkpoint_name(**self.name_kwargs, epoch=epoch, is_best=is_best))

    def update(self, epoch: int, metric: float, tree: Any) -> Optional[str]:
        saved = None
        metadata = {"epoch": epoch, "metric": metric}
        save = save_checkpoint if self.write else (lambda path, *_: path)
        if metric > self.best_metric:
            self.best_metric = metric
            self.best_epoch = epoch
            saved = save(self._path(epoch, True), tree, metadata)
        if epoch % self.periodic_every == 0:
            save(self._path(epoch, False), tree, metadata)
        return saved
