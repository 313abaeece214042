"""Gaussian blur substrate for the insertion metric (port of
xmir_tpu/ops/blur.py; reference evaluation.py:11-24 gkern: a dirac through
scipy's gaussian_filter, klen=51, sigma=sqrt(50))."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=8)
def gkern(klen: int = 51, nsig: float = 50**0.5) -> np.ndarray:
    from scipy.ndimage import gaussian_filter

    inp = np.zeros((klen, klen), np.float32)
    inp[klen // 2, klen // 2] = 1.0
    return gaussian_filter(inp, nsig).astype(np.float32)


def gaussian_blur(images, klen: int = 51, nsig: float = 50**0.5):
    """Depthwise gaussian blur of (B, H, W, C) images in f32 with SAME
    padding (one cuDNN depthwise conv on the images' device), as the
    reference's conv2d(images, gkern, padding=klen // 2). Returns
    (B, H, W, C) float32."""
    c = images.shape[-1]
    k = torch.from_numpy(gkern(klen, nsig)).to(images.device)
    out = F.conv2d(images.float().permute(0, 3, 1, 2), k.expand(c, 1, klen, klen),
                   padding=klen // 2, groups=c)
    return out.permute(0, 2, 3, 1).contiguous()
