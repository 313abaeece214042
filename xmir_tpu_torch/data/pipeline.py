"""Host-side input pipeline (port of xmir_tpu/data/pipeline.py): a thread
pool decodes uint8 batches while the device embeds the previous one;
resize/normalise run on the device (data/transforms.py), so host work is file
IO + decode, plus a PIL resize for images not already at the decode size.
``prefetch_to_device`` stages host batches on the card from a side stream;
``embed_dataset(..., mesh=)`` splits each batch over a data-parallel world.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch


def _decode_batch(dataset, indices: Sequence[int], image_size: Optional[int],
                  skip_errors: bool = False, interpolation: str = "bilinear"):
    from .transforms import pil_resize_center_crop

    if image_size is not None and indices and hasattr(dataset, "load_batch_cropped"):
        # a dataset's batch fast path (the NIH native loader, a decoded-image
        # cache): aspect-preserving Resize(short) + CenterCrop, as below
        try:
            imgs = dataset.load_batch_cropped(list(indices), image_size)
            labels = np.asarray([dataset.labels[i] for i in indices])
            return imgs, labels, np.asarray(indices)
        except ValueError:
            if not skip_errors:
                raise
            # fall through to the per-item path, which can skip a bad file
    imgs, kept = [], []
    for i in indices:
        try:
            arr = dataset.load_image(i)
        except (OSError, ValueError) as e:  # PIL's UnidentifiedImageError is an OSError
            if not skip_errors:
                raise
            # skip-corrupt-image robustness (reference ingest_embeddings.py:293-302)
            print(f">> skipping unreadable item {i}: {type(e).__name__}")
            continue
        if image_size is not None and arr.shape[:2] != (image_size, image_size):
            # aspect-preserving short-side resize + center crop (torchvision
            # Resize(int)+CenterCrop, test.py:1330-1333)
            arr = pil_resize_center_crop(arr, image_size, interpolation)
        imgs.append(arr)
        kept.append(i)
    if not imgs:
        shape = (image_size, image_size, 3) if image_size else (1, 1, 3)
        return np.zeros((0,) + shape, np.uint8), np.zeros((0,)), np.zeros((0,), np.int64)
    labels = np.asarray([dataset.labels[i] for i in kept])
    return np.stack(imgs), labels, np.asarray(kept)


def batch_iterator(dataset, batch_size: int, *, indices: Optional[Iterable[int]] = None,
                   image_size: Optional[int] = None, num_workers: int = 8,
                   drop_last: bool = False, skip_errors: bool = False,
                   interpolation: str = "bilinear") -> Iterator[tuple]:
    """Yield (uint8 images (B, S, S, 3), labels, indices) with parallel
    decode. ``image_size`` is the HOST decode size."""
    if indices is None:
        indices = range(len(dataset))
    idx_list = list(indices)
    batches: List[List[int]] = [
        idx_list[i:i + batch_size] for i in range(0, len(idx_list), batch_size)
    ]
    if drop_last and batches and len(batches[-1]) < batch_size:
        batches.pop()
    for imgs, labels, idxs in decode_batches(dataset, batches, image_size, num_workers,
                                             skip_errors, interpolation):
        if imgs.shape[0]:
            yield imgs, labels, idxs


def decode_batches(dataset, batches: Sequence[Sequence[int]], image_size: Optional[int],
                   num_workers: int = 8, skip_errors: bool = False,
                   interpolation: str = "bilinear") -> Iterator[tuple]:
    """(images, labels, indices) of each index list in ``batches``, in order,
    decoded by a thread pool; an empty list (or one whose every image was
    skipped) gives an empty batch."""
    if not batches:
        return
    # bounded in-flight window (~2x workers) so decoded batches cannot pile
    # up on the host when the consumer is slower than the decoders
    window = max(2 * num_workers, 2)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        pending = deque(
            pool.submit(_decode_batch, dataset, b, image_size, skip_errors, interpolation)
            for b in batches[:window]
        )
        next_batch = window
        while pending:
            out = pending.popleft().result()
            if next_batch < len(batches):
                pending.append(pool.submit(_decode_batch, dataset, batches[next_batch],
                                           image_size, skip_errors, interpolation))
                next_batch += 1
            yield out


def _to_device(item, device, non_blocking: bool = False):
    """numpy arrays and tensors of a tuple / list / dict -> tensors on
    ``device`` (pinned first for an asynchronous copy to a card)."""
    if isinstance(item, (tuple, list)):
        return type(item)(_to_device(v, device, non_blocking) for v in item)
    if isinstance(item, dict):
        return {k: _to_device(v, device, non_blocking) for k, v in item.items()}
    if isinstance(item, np.ndarray) and item.dtype != object:
        item = torch.from_numpy(np.ascontiguousarray(item))
    if torch.is_tensor(item):
        if non_blocking and item.device.type == "cpu":
            item = item.pin_memory()
        return item.to(device, non_blocking=non_blocking)
    return item


def _tensors(item):
    if isinstance(item, (tuple, list)):
        return [t for v in item for t in _tensors(v)]
    if isinstance(item, dict):
        return [t for v in item.values() for t in _tensors(v)]
    return [item] if torch.is_tensor(item) else []


def prefetch_to_device(iterator: Iterator, device, size: int = 2) -> Iterator:
    """Stage the iterator's host batches (tuples / lists / dicts of numpy
    arrays or tensors) on ``device`` ahead of use, from a thread. On a card
    each batch is copied from pinned memory on a side stream, and the
    consumer's stream waits on that copy's event before the batch is handed
    over, so no kernel reads it early. Batches come in the iterator's
    order."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    done, failed, stop = object(), object(), threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for item in iterator:
                if stop.is_set():
                    return
                if cuda:
                    with torch.cuda.stream(side):
                        staged = _to_device(item, device, non_blocking=True)
                        event = torch.cuda.Event()
                        event.record(side)
                    put((staged, event))
                else:
                    put((_to_device(item, device), None))
        except BaseException as exc:  # handed to the consumer, which re-raises it
            put((exc, failed))
        finally:
            put((done, None))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item, event = q.get()
            if item is done:
                return
            if event is failed:
                raise item
            if event is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(event)
                for t in _tensors(item):
                    t.record_stream(stream)  # the allocator keeps it until this stream is done
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)


def embed_dataset(dataset, embed_fn, spec, *, device, batch_size: int = 64,
                  num_workers: int = 8, skip_errors: bool = False, mesh=None):
    """Embed every item (the test.py/ingest hot loop): host decode at the
    spec's resize size, device preprocessing, ``embed_fn`` on the device.

    Returns (embeddings (N, D) float32 on ``device``, labels np array). The
    tail batch runs at its own size: nothing here compiles per shape.

    With a ``mesh`` (parallel/mesh.py) the batch is rounded up to a multiple
    of the world and rank r decodes and embeds the r-th slice of each batch;
    the rows are gathered in row order, and every rank returns the same
    array (on the mesh's device)."""
    from .transforms import eval_preprocess

    if mesh is not None:
        return _embed_sharded(dataset, embed_fn, spec, mesh, batch_size, num_workers,
                              skip_errors)
    embeds, labels = [], []
    for imgs, labs, _ in batch_iterator(
        dataset, batch_size, image_size=spec.resize_size, num_workers=num_workers,
        skip_errors=skip_errors, interpolation=spec.interpolation,
    ):
        x = torch.from_numpy(imgs).to(device)
        x = eval_preprocess(x, spec.resize_size, spec.input_size, spec.mean, spec.std,
                            method=spec.interpolation)
        embeds.append(embed_fn(x))
        labels.extend(np.asarray(labs).tolist())
    return torch.cat(embeds, dim=0), np.asarray(labels)


def _embed_sharded(dataset, embed_fn, spec, mesh, batch_size, num_workers, skip_errors):
    """embed_dataset over a mesh. Each rank's slice of a batch is embedded at
    its own size (a world of 1 embeds exactly the batches of the meshless
    path), padded to the slice's full size for the gather, and the gathered
    counts and indices say which rows are real."""
    from .transforms import eval_preprocess

    device = mesh.device
    local = -(-batch_size // mesh.n_data)
    batch_size = local * mesh.n_data
    idx = list(range(len(dataset)))
    mine = [idx[i + mesh.data_rank * local:i + (mesh.data_rank + 1) * local]
            for i in range(0, len(idx), batch_size)]
    embeds, labels = [], []
    for imgs, _, kept in decode_batches(dataset, mine, spec.resize_size, num_workers,
                                        skip_errors, spec.interpolation):
        n = imgs.shape[0]
        e = None
        if n:
            x = eval_preprocess(torch.from_numpy(imgs).to(device), spec.resize_size,
                                spec.input_size, spec.mean, spec.std, method=spec.interpolation)
            e = embed_fn(x).float()
        meta = torch.tensor([n, 0 if e is None else e.shape[1]], device=device)
        counts = mesh.all_gather(meta)  # (n_data, 2): rows and width of each rank's slice
        dim = int(counts[:, 1].max())
        block = torch.zeros((local, dim), device=device)
        ids = torch.full((local,), -1, dtype=torch.int64, device=device)
        if n:
            block[:n] = e
            ids[:n] = torch.from_numpy(np.asarray(kept, np.int64)).to(device)
        rows, all_ids = mesh.all_gather(block), mesh.all_gather(ids).cpu().numpy()
        for r, c in enumerate(counts[:, 0].tolist()):
            if c:
                embeds.append(rows[r, :c])
                labels.extend(np.asarray([dataset.labels[i] for i in all_ids[r, :c]]).tolist())
    if not embeds:
        return torch.zeros((0, 0), device=device), np.asarray(labels)
    return torch.cat(embeds, dim=0), np.asarray(labels)
