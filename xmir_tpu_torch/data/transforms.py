"""Preprocessing on the device (port of xmir_tpu/data/transforms.py).

The host decodes uint8 HWC images; resize + crop + normalise run on the
device in ``eval_preprocess`` and, with the augmentations, in
``train_preprocess``. Semantics are torchvision's: Resize(size) scales the
SHORT side, CenterCrop pads if needed then crops the center.

Training augmentation is split in two: ``draw_train_augment`` draws a
batch's crop offsets, flips and jitter factors from a ``torch.Generator``,
``apply_train_augment`` is the arithmetic on those draws. The random streams
cannot match the JAX package's; the arithmetic does, given the same draws.
The crop's tops and lefts are drawn independently, as torchvision's
RandomCrop draws them.

The device resize is the identity when the input is already at the target
size (as jax.image.resize is), which is the case on the serving path: the host
decode (data/pipeline.py) already resizes to the model's resize size.
Otherwise ``torch.nn.functional.interpolate(..., antialias=True,
align_corners=False)`` stands in for ``jax.image.resize(..., antialias=True)``;
on 0..255 pixel values the two agree within 1e-3 (bilinear and bicubic,
down- and upsampling; tests/test_torch_slice.py holds them to it).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _resized_output_size(h: int, w: int, size: int):
    """torchvision _compute_resized_output_size: short side -> size, long
    side int(size * long / short)."""
    if h <= w:
        return size, max(1, int(size * w / h))
    return max(1, int(size * h / w)), size


def resize_short_side(img, size: int, method: str = "bilinear"):
    """torchvision Resize(int) on a float (B, H, W, C) batch."""
    h, w = img.shape[-3], img.shape[-2]
    nh, nw = _resized_output_size(h, w, size)
    if (nh, nw) == (h, w):
        return img
    mode = {"bilinear": "bilinear", "bicubic": "bicubic"}[method]
    x = F.interpolate(img.permute(0, 3, 1, 2), size=(nh, nw), mode=mode,
                      align_corners=False, antialias=True)
    return x.permute(0, 2, 3, 1)


def pil_resize_center_crop(arr, size: int, method: str = "bilinear"):
    """HOST-side torchvision-exact Resize(short=size)+CenterCrop(size) on a
    uint8 HWC array via PIL. Returns (size, size, 3) uint8."""
    from PIL import Image

    resample = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC}[method]
    img = Image.fromarray(arr)
    w, h = img.size
    nh, nw = _resized_output_size(h, w, size)
    if (nh, nw) != (h, w):
        img = img.resize((nw, nh), resample)
    # torchvision CenterCrop: int(round((n - size) / 2.)) (nearest-even)
    top = int(np.round((nh - size) / 2.0)) if nh > size else 0
    left = int(np.round((nw - size) / 2.0)) if nw > size else 0
    img = img.crop((left, top, left + size, top + size))
    out = np.asarray(img, np.uint8)
    if out.ndim == 2:
        out = np.repeat(out[..., None], 3, axis=2)
    return out


def center_crop(img, size: int):
    h, w = img.shape[-3], img.shape[-2]
    pad_h, pad_w = max(0, size - h), max(0, size - w)
    if pad_h or pad_w:
        img = F.pad(img, (0, 0, pad_w // 2, pad_w - pad_w // 2,
                          pad_h // 2, pad_h - pad_h // 2))
        h, w = img.shape[-3], img.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[..., top:top + size, left:left + size, :]


def normalize(img, mean, std):
    mean = torch.tensor(mean, dtype=torch.float32, device=img.device)
    std = torch.tensor(std, dtype=torch.float32, device=img.device)
    return (img.float() / 255.0 - mean) / std


def eval_preprocess(batch_u8, resize_size: int, crop_size: int, mean, std,
                    method: str = "bilinear"):
    """Validation pipeline: Resize(short) -> CenterCrop -> Normalize.
    batch_u8: (B, H, W, 3) uint8 tensor on the device -> float32 NHWC."""
    x = resize_short_side(batch_u8.float(), resize_size, method)
    x = center_crop(x, crop_size)
    return normalize(x, mean, std)


def draw_train_augment(generator: torch.Generator, b: int, max_top: int = 0, max_left: int = 0):
    """One batch's augmentation draws, made on the generator's device (the
    CPU, so that a seed gives the same draws whatever device applies them):
    ``tops`` in [0, max_top] and ``lefts`` in [0, max_left] (int64), ``flip``
    (bool, p = 0.5), ``brightness`` and ``contrast`` uniform in [0.9, 1.1)."""
    def uniform():
        return 0.9 + 0.2 * torch.rand((b,), generator=generator)

    return {"tops": torch.randint(0, max_top + 1, (b,), generator=generator),
            "lefts": torch.randint(0, max_left + 1, (b,), generator=generator),
            "flip": torch.rand((b,), generator=generator) < 0.5,
            "brightness": uniform(), "contrast": uniform()}


GREY_WEIGHTS = (0.299, 0.587, 0.114)


def apply_train_augment(x, draws, crop_size: int, mean, std, rand_resize: bool = False,
                        jitter: bool = True):
    """The arithmetic of the training pipeline on a resized float (B, H, W, 3)
    batch in 0..255: (pad 4 + crop at the drawn offsets | center crop) ->
    flip -> brightness -> contrast about the per-image grey mean -> clip to
    0..255 -> normalise. ``draws`` as ``draw_train_augment`` returns them, on
    any device."""
    b = x.shape[0]
    draws = {k: v.to(x.device) for k, v in draws.items()}
    if rand_resize:
        x = F.pad(x, (0, 0, 4, 4, 4, 4))
        rows = draws["tops"][:, None] + torch.arange(crop_size, device=x.device)
        cols = draws["lefts"][:, None] + torch.arange(crop_size, device=x.device)
        x = x[torch.arange(b, device=x.device)[:, None, None], rows[:, :, None], cols[:, None, :]]
    else:
        x = center_crop(x, crop_size)
    x = torch.where(draws["flip"][:, None, None, None], x.flip(2), x)
    if jitter:
        x = x * draws["brightness"].to(x.dtype)[:, None, None, None]
        grey = x @ torch.tensor(GREY_WEIGHTS, dtype=x.dtype, device=x.device)
        grey_mean = grey.mean(dim=(1, 2), keepdim=True)[..., None]
        x = (x - grey_mean) * draws["contrast"].to(x.dtype)[:, None, None, None] + grey_mean
        x = torch.clamp(x, 0.0, 255.0)
    return normalize(x, mean, std)


def train_preprocess(generator: torch.Generator, batch_u8, resize_size: int, crop_size: int,
                     mean, std, rand_resize: bool = False, jitter: bool = True,
                     method: str = "bilinear", shard=(0, 1)):
    """Training pipeline (reference train.py:952-983): Resize -> (RandomCrop
    pad 4 | CenterCrop) -> RandomHorizontalFlip -> ColorJitter(0.1, 0.1) ->
    Normalize, over the batch with per-sample draws from ``generator``.
    batch_u8: (B, H, W, 3) uint8 tensor on the device -> float32 NHWC.

    ``shard`` = (r, n): the batch is the r-th of n equal slices of a global
    batch (a data-parallel rank's rows); the draws are made for the whole
    global batch and the slice's are taken, so each row gets the draws a
    world of 1 gives it."""
    x = resize_short_side(batch_u8.float(), resize_size, method)
    h, w = x.shape[1] + 8, x.shape[2] + 8  # after the pad of 4
    rank, world = shard
    b = x.shape[0]
    draws = draw_train_augment(generator, b * world,
                               h - crop_size if rand_resize else 0,
                               w - crop_size if rand_resize else 0)
    if world > 1:
        draws = {k: v[rank * b:(rank + 1) * b] for k, v in draws.items()}
    return apply_train_augment(x, draws, crop_size, mean, std, rand_resize, jitter)


def preprocess_for_spec(batch_u8, spec, train: bool = False, generator=None, rand_resize=False,
                        shard=(0, 1)):
    """Apply the registry ModelSpec's transform (sizes, normalisation,
    interpolation); ``shard`` as in train_preprocess."""
    if train:
        if generator is None:
            raise ValueError("train preprocessing needs a torch.Generator")
        return train_preprocess(generator, batch_u8, spec.resize_size, spec.input_size,
                                spec.mean, spec.std, rand_resize=rand_resize,
                                method=spec.interpolation, shard=shard)
    return eval_preprocess(batch_u8, spec.resize_size, spec.input_size, spec.mean, spec.std,
                           method=spec.interpolation)
