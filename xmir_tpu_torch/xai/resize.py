"""Bilinear resizing of saliency maps as ``jax.image.resize(..., "bilinear")``
does it (the JAX explainers' upsampling): half-pixel centres, and at the edges
the triangle kernel's weights renormalised over the pixels inside, which for
an enlargement is the edge pixel's value, as PyTorch's ``align_corners=False``
clamps it. A reduction widens the kernel (JAX's default antialias), as
PyTorch's ``antialias=True`` does."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(maps, out_hw):
    """(..., h, w) float maps -> (..., H, W) float32."""
    *lead, h, w = maps.shape
    x = maps.float().reshape(-1, 1, h, w)
    shrink = out_hw[0] < h or out_hw[1] < w
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear", align_corners=False,
                        antialias=shrink)
    return out.reshape(*lead, *out_hw)
