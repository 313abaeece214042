"""SimCAM: pairwise similarity decomposition saliency (port of
xmir_tpu/xai/simcam.py; reference explanations.py:753-900, the vectorised
form of the O(h^2 w^2) four-loop original at 664-750).

D[n, i, j] = <q_token_i, r_token_j> over the final feature map's tokens; the
query map is sum_j D, the retrieval map sum_i D, both after a per-pair
max-normalisation and a ReLU, bilinearly upsampled. A point-specific
retrieval map interpolates D bilinearly at a query pixel.
"""
from __future__ import annotations

import math

import torch

from .resize import resize_bilinear


def _normalised(d):
    """D over its largest entry per pair (+1e-8), negatives to 0."""
    return (d / (d.amax(dim=(-2, -1), keepdim=True) + 1e-8)).clamp_min(0.0)


def _two_maps(d, side_h, side_w, out_hw):
    d = d.reshape(-1, side_h, side_w, side_h, side_w)
    maps = torch.stack([d.sum(dim=(3, 4)), d.sum(dim=(1, 2))], dim=1)
    return resize_bilinear(maps, out_hw)


def simcam_maps(q_feats, r_feats, out_hw=(224, 224)):
    """q_feats (h, w, C) query features; r_feats (N, h, w, C) retrieved.
    Returns (N, 2, H, W) float32: [query map, retrieval map] per pair."""
    h, w, c = q_feats.shape
    n = r_feats.shape[0]
    d = torch.einsum("qc,nrc->nqr", q_feats.reshape(h * w, c).float(),
                     r_feats.reshape(n, h * w, c).float())
    return _two_maps(_normalised(d), h, w, out_hw)


def simcam_decomposition(q_feats, r_feats_one):
    """The whole (h, w, h, w) decomposition of one pair, for point-specific
    maps."""
    h, w, c = q_feats.shape
    d = q_feats.reshape(-1, c).float() @ r_feats_one.reshape(-1, c).float().T
    return _normalised(d).reshape(h, w, h, w)


def point_specific_map(decom, point, size=(224, 224)):
    """The retrieval map for one query pixel (reference
    explanations.py:768-798): the (h, w, h, w) decomposition replicate-padded
    by one on its query axes and interpolated bilinearly at the pixel's
    coordinate on the feature grid, negatives to 0. (h, w) float32."""
    h = decom.shape[0]
    x = (point[0] + 0.5) / size[0] * h + 0.5
    y = (point[1] + 0.5) / size[1] * h + 0.5
    x_min, y_min = int(math.floor(x)), int(math.floor(y))
    dx, dy = x - x_min, y - y_min

    def padded(i, j):  # the edge-padded decomposition at padded index (i, j)
        return decom[min(max(i - 1, 0), decom.shape[0] - 1),
                     min(max(j - 1, 0), decom.shape[1] - 1)].float()

    interp = (padded(x_min, y_min) * (1 - dx) * (1 - dy)
              + padded(x_min + 1, y_min) * dx * (1 - dy)
              + padded(x_min, y_min + 1) * (1 - dx) * dy
              + padded(x_min + 1, y_min + 1) * dx * dy)
    return interp.clamp_min(0.0)


def simcam_vit_maps(q_tokens, r_tokens, out_hw=(448, 448)):
    """ViT-token SimCAM (reference SimCAM_MedSigLIP, explanations.py:903-976):
    the same decomposition over patch tokens (no CLS). q_tokens (n, D),
    r_tokens (N, n, D) with n a perfect square. Returns (N, 2, H, W)."""
    n_tok = q_tokens.shape[0]
    side = int(round(n_tok ** 0.5))
    if side * side != n_tok:
        raise ValueError(f"patch count {n_tok} is not a perfect square")
    d = torch.einsum("qc,nrc->nqr", q_tokens.float(), r_tokens.float())
    return _two_maps(_normalised(d), side, side, out_hw)
