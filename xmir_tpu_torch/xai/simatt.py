"""SimAtt: similarity-attention triplet saliency (port of
xmir_tpu/xai/simatt.py; reference explanations.py:605-661).

Given an anchor and optional positive / negative images, the weight vector
w = prod_i |e_0 - e_i| (the positives' terms inverted) scores each sample
s_b = |e_b| . w, and Grad-CAM takes the scores against the last feature map:
M_b = relu(mean_spatial(d s / d A_b) . A_b), upsampled to the input size.
The gradients flow through a feature -> embedding head
(xai/feature_heads.py) rather than forward hooks.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.distance import l2_normalize
from .resize import resize_bilinear


def simatt_saliency(features_fn: Callable, head_fn: Callable, x_stack, n_pos: int = 1):
    """x_stack (1 + P + Nn, H, W, C): [anchor, positives..., negatives...],
    the ``n_pos`` positives right after the anchor. features_fn(x) -> (B, h,
    w, C) last feature map; head_fn(features) -> embeddings. Returns (B, H, W)
    float32 maps, one per image of the stack."""
    h_img, w_img = x_stack.shape[1], x_stack.shape[2]
    with torch.no_grad():
        feats = features_fn(x_stack).float()
    with torch.enable_grad():
        leaf = feats.detach().requires_grad_(True)
        emb = head_fn(leaf)
        e_norm = l2_normalize(emb, dim=1).detach()
        w = (e_norm[0] - e_norm[1:]).abs()
        if n_pos > 0:
            w = torch.cat([1.0 - w[:n_pos], w[n_pos:]])
        score = (emb.abs() @ w.prod(dim=0)).sum()
        (grads,) = torch.autograd.grad(score, leaf)
    weights = grads.mean(dim=(1, 2))
    m = torch.einsum("bhwc,bc->bhw", feats, weights).clamp_min(0.0)
    return resize_bilinear(m, (h_img, w_img))
