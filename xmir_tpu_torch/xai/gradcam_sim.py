"""Grad-CAM on a cosine-similarity target for ViT backbones (port of
xmir_tpu/xai/gradcam_sim.py; reference medsiglip_saliency.py:51-131).

The reference hooks the last encoder layer and runs pytorch-grad-cam with a
cosine(query, embedding) target. Here, as in the JAX package, the gradient at
the last encoder layer is taken through a zero ``token_delta`` the backbone
adds to its last layer's tokens (models/siglip.py): the tap is a leaf that
requires grad, and ``torch.autograd.grad`` runs the backward only from the
embedding down to it (no encoder layer's backward, so no K3).

CAM = relu(sum_d mean_patches(dS/dA)_d A_d), max-normalised, upsampled
bilinearly as ``jax.image.resize`` does (xai/resize.py).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..losses.metric_losses import l2_normalize
from .resize import resize_bilinear


def vit_gradcam_similarity(apply_fn: Callable, query_embedding, images,
                           out_hw: Optional[Tuple[int, int]] = None):
    """Saliency of cosine(query, embed(image)) over ViT patch positions.

    apply_fn(x, token_delta) must return a dict with "embedding" (B, D, unit
    rows) and "encoder_tokens" (B, N, D), and ``apply_fn.token_shape(images)``
    give the tokens' shape (where the JAX package asks ``jax.eval_shape``):
    ``make_vit_gradcam_fn`` of a MedSigLIPEmbedder. images (B, H, W, C) ->
    (B, H', W') float32 maps, each max-normalised to [0, 1], at ``out_hw``
    (default the images' size)."""
    b, h_img, w_img = images.shape[0], images.shape[1], images.shape[2]
    out_hw = tuple(out_hw or (h_img, w_img))
    q = l2_normalize(torch.as_tensor(query_embedding, device=images.device).float()[None],
                     dim=1)[0]
    delta = torch.zeros(apply_fn.token_shape(images), dtype=torch.float32,
                        device=images.device, requires_grad=True)
    with torch.enable_grad():
        out = apply_fn(images, delta)
        sims = torch.sum(out["embedding"].float() * q[None], dim=1)  # (B,)
        (grads,) = torch.autograd.grad(torch.sum(sims), delta)
    acts = out["encoder_tokens"].detach().float()
    g = int(round(acts.shape[1] ** 0.5))
    acts = acts.reshape(b, g, g, -1)
    grads = grads.reshape(b, g, g, -1)
    weights = torch.mean(grads, dim=(1, 2))  # (B, D): GAP of the gradients
    cam = torch.clamp(torch.einsum("bhwd,bd->bhw", acts, weights), min=0.0)
    cam = cam / (torch.amax(cam, dim=(1, 2), keepdim=True) + 1e-8)
    return resize_bilinear(cam, out_hw)


def make_vit_gradcam_fn(model):
    """``model`` (a MedSigLIPEmbedder: forward(x, token_delta=...)) as the
    apply_fn ``vit_gradcam_similarity`` takes, with the tap's shape (B, N, D)
    from the patch grid and the tower's width."""
    patch = model.backbone.embeddings.patch_embedding

    def apply_fn(x, delta):
        return model(x, token_delta=delta)

    def token_shape(x):
        ph, pw = patch.kernel_size
        return (x.shape[0], (x.shape[1] // ph) * (x.shape[2] // pw), patch.out_channels)

    apply_fn.token_shape = token_shape
    return apply_fn
