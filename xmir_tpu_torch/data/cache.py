"""Decode-once uint8 cache (port of xmir_tpu/data/cache.py): host decode is
paid once, and later passes over the same images read a memory-mapped uint8
artifact.

Artifact layout (directory), the JAX package's byte for byte:
  images.npy   (N, S, S, 3) uint8, C order, memmap-friendly
  meta.json    {"size": S, "n": N, "interpolation": ...}
  labels.npy   the dataset's labels

``WriteThroughCache`` fills the artifact as a side effect of the first
training epoch. Under a data-parallel world (parallel/mesh.py) every rank
writes only the rows it decoded into the one shared memmap; which rows are
done is known per process, so ``sync()`` (called by every rank at an epoch's
end) joins the ranks' records, and rank 0 writes meta.json once every row is
written, after a barrier.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Iterator

import numpy as np
import torch

from .pipeline import batch_iterator


def _write_meta(cache_dir: str, size: int, n: int, interpolation: str):
    with open(os.path.join(cache_dir, "meta.json"), "w") as f:
        json.dump({"size": size, "n": n, "interpolation": interpolation}, f)


def build_decoded_cache(dataset, cache_dir: str, image_size: int, *, batch_size: int = 64,
                        num_workers: int = 8, interpolation: str = "bilinear") -> str:
    """Decode every item once (aspect-preserving resize + crop to
    ``image_size``) into a memmapped uint8 artifact. Returns cache_dir."""
    os.makedirs(cache_dir, exist_ok=True)
    n = len(dataset)
    images = np.lib.format.open_memmap(os.path.join(cache_dir, "images.npy"), mode="w+",
                                       dtype=np.uint8, shape=(n, image_size, image_size, 3))
    labels: list = [None] * n
    for imgs, labs, idxs in batch_iterator(dataset, batch_size, image_size=image_size,
                                           num_workers=num_workers,
                                           interpolation=interpolation):
        images[np.asarray(idxs)] = imgs
        for j, i in enumerate(np.asarray(idxs)):
            labels[int(i)] = labs[j]
    images.flush()
    np.save(os.path.join(cache_dir, "labels.npy"), np.asarray(labels))
    _write_meta(cache_dir, image_size, n, interpolation)
    return cache_dir


class WriteThroughCache:
    """Decode-on-first-use cache: the first epoch runs at pipeline speed
    while the memmap fills; later epochs read it. It is the dataset duck type
    batch_iterator expects (``load_batch_cropped`` / ``load_image`` /
    ``labels``), and writes each freshly decoded batch back from the decode
    threads.

    Without a mesh the artifact is stamped (meta.json) the moment every
    index has been decoded once, as in the JAX package. With a ``mesh``
    (every rank opens the same directory) rank 0 makes the memmap, the ranks
    write their own rows, and ``sync()`` stamps it. A process that dies
    mid-build leaves images.npy without meta.json; the next run decodes on
    demand into the same file (the writes are idempotent)."""

    def __init__(self, dataset, cache_dir: str, image_size: int, *,
                 interpolation: str = "bilinear", mesh=None):
        self.dataset = dataset
        self.cache_dir = cache_dir
        self.size = int(image_size)
        self.interpolation = interpolation
        self.mesh = mesh
        n = len(dataset)
        meta_path = os.path.join(cache_dir, "meta.json")
        img_path = os.path.join(cache_dir, "images.npy")
        complete = os.path.exists(meta_path)
        if complete:
            with open(meta_path) as f:
                meta = json.load(f)
            if meta["size"] != self.size or meta["n"] != n:
                raise ValueError(f"existing cache is ({meta['n']}, {meta['size']}px), "
                                 f"dataset needs ({n}, {self.size}px)")
        if mesh is not None:
            # every rank must see the same state before rank 0 may start a new file
            complete = bool(self._min_over_ranks(int(complete)))
        if complete:
            self.images = np.load(img_path, mmap_mode="r+")
            self._done = np.ones(n, bool)
        else:
            if mesh is None or mesh.rank == 0:
                os.makedirs(cache_dir, exist_ok=True)
                self.images = np.lib.format.open_memmap(
                    img_path, mode="w+", dtype=np.uint8, shape=(n, self.size, self.size, 3))
                self.images.flush()
            if mesh is not None:
                mesh.barrier()
                if mesh.rank != 0:
                    self.images = np.load(img_path, mmap_mode="r+")
            self._done = np.zeros(n, bool)
        self._n_done = int(self._done.sum())
        self._lock = threading.Lock()

    def _min_over_ranks(self, value: int) -> int:
        t = torch.tensor([value], dtype=torch.int64, device=self.mesh.device)
        return int(self.mesh.all_reduce_(t, op=torch.distributed.ReduceOp.MIN).item())

    # ------------------------------------------------- dataset duck type
    def __len__(self) -> int:
        return len(self.dataset)

    @property
    def labels(self):
        return self.dataset.labels

    @property
    def image_names(self):
        return getattr(self.dataset, "image_names", None)

    def load_image(self, index: int) -> np.ndarray:
        """The raw image (callers that need the original resolution)."""
        return self.dataset.load_image(index)

    def _decode_one(self, i: int) -> np.ndarray:
        from .transforms import pil_resize_center_crop

        arr = self.dataset.load_image(i)
        if arr.shape[:2] != (self.size, self.size):
            arr = pil_resize_center_crop(arr, self.size, self.interpolation)
        return arr

    def load_batch_cropped(self, indices, size: int, n_threads: int = 0):
        """The batch_iterator fast path: rows already decoded come from the
        memmap, the rest are decoded (the pipeline's aspect-preserving resize
        + center crop) and written back."""
        if size != self.size:
            raise ValueError(f"cache built at {self.size}px, requested {size}px")
        idx = np.asarray(list(indices))
        out = np.empty((len(idx), self.size, self.size, 3), np.uint8)
        done = self._done[idx]
        if done.any():
            out[done] = self.images[idx[done]]
        missing = idx[~done]
        if missing.size:
            fresh = None
            if hasattr(self.dataset, "load_batch_cropped"):
                try:
                    fresh = self.dataset.load_batch_cropped(list(missing), self.size)
                except ValueError:
                    fresh = None
            if fresh is None:
                fresh = np.stack([self._decode_one(i) for i in missing])
            out[~done] = fresh
            self.images[missing] = fresh  # write-back (idempotent per index)
            with self._lock:
                # recount rather than increment: a sampled batch may repeat an
                # index (PKSampler), and counting it twice would stamp the
                # artifact before every image is decoded
                self._done[missing] = True
                self._n_done = int(self._done.sum())
                if self.mesh is None and self._n_done == len(self) and not os.path.exists(
                        os.path.join(self.cache_dir, "meta.json")):
                    self._finalize_locked()
        return out

    def sync(self) -> bool:
        """Join every rank's record of the rows written (a collective: every
        rank calls it, between epochs); once all rows are written, rank 0
        stamps the artifact after a barrier. Returns ``complete``."""
        if self.mesh is None:
            return self.complete
        self.images.flush()
        with self._lock:
            done = torch.from_numpy(self._done.astype(np.int32)).to(self.mesh.device)
            self.mesh.all_reduce_(done, op=torch.distributed.ReduceOp.MAX)
            self._done = done.cpu().numpy().astype(bool)
            self._n_done = int(self._done.sum())
        if self.complete:
            self.mesh.barrier()  # every rank's rows are flushed
            if self.mesh.rank == 0 and not os.path.exists(
                    os.path.join(self.cache_dir, "meta.json")):
                self._finalize_locked()
            self.mesh.barrier()
        return self.complete

    def finalize(self):
        """Decode every index not yet seen and stamp the artifact (one
        process)."""
        missing = np.nonzero(~self._done)[0]
        for i in range(0, len(missing), 64):
            self.load_batch_cropped(missing[i:i + 64], self.size)
        with self._lock:
            if self._n_done == len(self) and not os.path.exists(
                    os.path.join(self.cache_dir, "meta.json")):
                self._finalize_locked()
        return self.cache_dir

    def _finalize_locked(self):
        self.images.flush()
        np.save(os.path.join(self.cache_dir, "labels.npy"), np.asarray(self.dataset.labels))
        _write_meta(self.cache_dir, self.size, len(self), self.interpolation)

    @property
    def complete(self) -> bool:
        return self._n_done == len(self)


class DecodedCache:
    """A built cache served with the dataset duck type the pipeline
    expects (load_image / labels / the batch fast path)."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.images = np.load(os.path.join(cache_dir, "images.npy"), mmap_mode="r")
        # labels.npy may hold an object array (multi-hot rows of lists); only
        # artifacts this program wrote are read
        self.labels = np.load(os.path.join(cache_dir, "labels.npy"), allow_pickle=True)
        self.size = int(self.meta["size"])

    def __len__(self) -> int:
        return int(self.meta["n"])

    def load_image(self, index: int) -> np.ndarray:
        return np.asarray(self.images[index])

    def load_batch_cropped(self, indices, size: int, n_threads: int = 0):
        """A memmap gather, valid only at the cached size (the pipeline then
        falls back per item)."""
        if size != self.size:
            raise ValueError(f"cache built at {self.size}px, requested {size}px")
        return np.asarray(self.images[np.asarray(indices)])

    def iter_batches(self, batch_size: int, *, indices=None) -> Iterator[tuple]:
        """A sequential batch iterator: the decode is a copy, so no thread
        pool."""
        idx = np.arange(len(self)) if indices is None else np.asarray(list(indices))
        for i in range(0, len(idx), batch_size):
            sel = idx[i:i + batch_size]
            yield np.asarray(self.images[sel]), self.labels[sel], sel
