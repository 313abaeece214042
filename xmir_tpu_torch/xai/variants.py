"""More saliency variants (port of xmir_tpu/xai/variants.py; reference
explanations.py:155-602):

  SBSMMask       the QUERY masked or blurred outside a region before the SBSM
                 occlusion of the retrieved image (explanations.py:155-253)
  SBSMFeature    occlusion in feature space: masks over the query's last
                 feature map instead of its pixels (explanations.py:255-387)
  FSal           a classifier probe (scikit-learn) on positive / negative
                 embeddings; saliency = the coverage-weighted drop of its
                 positive probability under occlusion (explanations.py:390-466)
  FSalGrad       Grad-CAM of a logistic-regression probe taken as a linear
                 head on the embedding (explanations.py:469-537)
  SimScoreCAM    Score-CAM for a similarity: each channel's activation map
                 masks the retrieved image, scored by the distance increase
                 (explanations.py:540-602; elementwise masking, as in the JAX
                 package, where the reference's ``torch.matmul`` is a slip)

``embed_fn(x)`` maps (N, H, W, C) images to (N, D) embeddings (as
``train.make_embed_fn``'s function does) and ``features_fn(x)`` to (N, h, w,
C') feature maps, both on the images' device. scikit-learn is imported where
a ``ProbeClassifier`` is made; ``fsal_grad_saliency`` reads only the probe's
``clf.coef_`` and ``clf.intercept_``.
"""
from __future__ import annotations

import math
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

from .resize import resize_bilinear
from .sbsm import _cdist, _masked_embeds

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _gauss_kernel_1d(sigma: float) -> np.ndarray:
    width = math.ceil(4 * sigma)
    xs = np.arange(-width, width + 1, dtype=np.float32)
    return np.exp(-((xs / sigma) ** 2) / 2) / (sigma * math.sqrt(2 * math.pi))


def _resize_channels(feats, hw):
    """(B, h, w, C) -> (B, H, W, C) bilinear, as ``jax.image.resize``."""
    return resize_bilinear(feats.permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)


def gaussian_blur_normed(x, sigma: float = 8.0):
    """Blur a NORMALISED image batch (B, H, W, C) in pixel space: undo the
    ImageNet normalisation, a separable gaussian (half-width ceil(4 sigma),
    each pass's kernel divided by the root of its sum, SAME zero padding),
    normalise again (reference SBSMMask.create_kernel / blur / norm /
    denorm)."""
    k1 = _gauss_kernel_1d(sigma)
    k1 = torch.from_numpy(k1 / k1.sum() ** 0.5).to(x.device)
    c, pad = x.shape[-1], (len(k1) - 1) // 2
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    pix = (x.float() * std + mean).permute(0, 3, 1, 2)
    pix = F.conv2d(pix, k1.reshape(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(pad, 0), groups=c)
    pix = F.conv2d(pix, k1.reshape(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, pad), groups=c)
    return (pix.permute(0, 2, 3, 1) - mean) / std


def transform_query(x_q, region_mask, mode: Literal["mask", "blur"] = "mask",
                    sigma: float = 8.0):
    """A region mask over the query (1 keeps, 0 hides): 'mask' zeroes the
    hidden pixels, 'blur' puts the blurred image there (reference
    SBSMMask.transform)."""
    m = region_mask[..., None] if region_mask.ndim == 3 else region_mask
    if mode == "mask":
        return m * x_q
    if mode == "blur":
        return m * x_q + (1.0 - m) * gaussian_blur_normed(x_q, sigma)
    raise ValueError(f"unsupported mode {mode!r}")


def _excess_map(m_dist, o_dist, masks):
    """The distance increase of each mask spread over the pixels it hides,
    divided by how many masks hide each pixel."""
    excess = torch.clamp(m_dist - o_dist, min=0.0)
    count = masks.shape[0] - torch.sum(masks, dim=0)
    return torch.sum((1.0 - masks) * excess[:, None, None], dim=0) / torch.clamp(count, min=1.0)


def sbsm_masked_query_saliency(embed_fn, x_q, x, masks, region_mask,
                               mode: Literal["mask", "blur"] = "mask", sigma: float = 8.0,
                               chunk: int = 128):
    """SBSMMask: the query masked or blurred outside ``region_mask``, then
    the SBSM occlusion of the retrieved image. x_q, x (1, H, W, C), masks
    (N, H, W) -> (H, W)."""
    q = embed_fn(transform_query(x_q, region_mask, mode, sigma))
    o_dist = _cdist(q, embed_fn(x))[0, 0]
    masks = torch.as_tensor(masks, device=x.device).float()
    me = _masked_embeds(embed_fn, x[0], masks, chunk)
    return _excess_map(torch.linalg.norm(q[0][None] - me, dim=1), o_dist, masks)


def sbsm_feature_saliency(embed_fn, features_fn, x_q, x, masks, chunk: int = 128):
    """SBSMFeature: the query stands for the mask-weighted averages of its
    (upsampled) last feature map; the retrieved image for the average of its
    own (explanations.py:255-298). ``embed_fn`` and ``chunk`` are not used,
    as in the JAX package. x_q, x (1, H, W, C), masks (N, H, W) -> (H, W)."""
    h, w = x_q.shape[1], x_q.shape[2]
    feats = features_fn(x_q).float()  # (1, fh, fw, C)
    feats_up = _resize_channels(feats, (h, w))[0]
    masks = torch.as_tensor(masks, device=x_q.device).float()
    msum = torch.einsum("nhw,hwc->nc", masks, feats_up)
    q_feats = msum / torch.clamp(torch.sum(masks, dim=(1, 2))[:, None], min=1.0)
    r_feats = torch.mean(features_fn(x).float(), dim=(1, 2))  # (1, C)
    full_q = torch.mean(feats, dim=(1, 2))
    o_dist = _cdist(full_q, r_feats)[0, 0]
    return _excess_map(_cdist(q_feats, r_feats)[:, 0], o_dist, masks)


class ProbeClassifier:
    """A scikit-learn probe on embeddings (reference FSal.build_classifier):
    'logistic_reg', 'knn' or 'svm'."""

    def __init__(self, mode: str = "logistic_reg"):
        if mode == "knn":
            from sklearn.neighbors import KNeighborsClassifier

            self.clf = KNeighborsClassifier(n_neighbors=4, weights="distance", algorithm="auto",
                                            leaf_size=50)
        elif mode == "svm":
            from sklearn import svm

            self.clf = svm.NuSVC(probability=True)
        elif mode == "logistic_reg":
            from sklearn.linear_model import LogisticRegression

            self.clf = LogisticRegression(random_state=0)
        else:
            raise ValueError(f"invalid classifier {mode!r}")
        self.mode = mode

    def fit(self, pos_features, neg_features):
        x = np.concatenate([np.asarray(neg_features), np.asarray(pos_features)])
        y = np.concatenate([np.zeros(len(neg_features)), np.ones(len(pos_features))])
        self.clf.fit(x, y)
        return self

    def prob_pos(self, feats) -> np.ndarray:
        return self.clf.predict_proba(np.asarray(feats))[:, 1]


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def fsal_saliency(embed_fn, x, masks, probe: ProbeClassifier, chunk: int = 128):
    """FSal: the drop of the probe's positive probability when regions are
    occluded (explanations.py:416-435). x (B, H, W, C), masks (N, H, W) ->
    (B, H, W) numpy float."""
    masks_t = torch.as_tensor(masks, device=x.device).float()
    pr_o = probe.prob_pos(_host(embed_fn(x)))
    masks_np = _host(masks_t)
    count = masks_np.shape[0] - masks_np.sum(axis=0)
    sals = []
    for b in range(x.shape[0]):
        pr_x = probe.prob_pos(_host(_masked_embeds(embed_fn, x[b], masks_t, chunk)))
        diff = np.clip(pr_o[b] - pr_x, 0.0, None)
        k = (1.0 - masks_np) * diff[:, None, None]
        sals.append(k.sum(0) / np.maximum(count, 1.0))
    return np.stack(sals)


def fsal_grad_saliency(features_fn, head_fn, probe, x):
    """FSalGrad: the probe's logistic-regression weights as a linear head on
    the embedding head_fn(features), Grad-CAM of its logit
    (explanations.py:469-537). x (B, H, W, C) -> (B, H, W) float32."""
    coef = torch.as_tensor(np.asarray(probe.clf.coef_[0]), dtype=torch.float32, device=x.device)
    intercept = torch.as_tensor(np.asarray(probe.clf.intercept_[0]), dtype=torch.float32,
                                device=x.device)
    h_img, w_img = x.shape[1], x.shape[2]
    with torch.no_grad():
        feats = features_fn(x).float()
    f = feats.clone().requires_grad_(True)
    with torch.enable_grad():
        score = torch.sum(head_fn(f).float() @ coef + intercept)
        (grads,) = torch.autograd.grad(score, f)
    weights = torch.mean(grads, dim=(1, 2))
    m = torch.clamp(torch.einsum("bhwc,bc->bhw", feats, weights), min=0.0)
    return resize_bilinear(m, (h_img, w_img))


def sim_score_cam(embed_fn, features_fn, x_q, x, chunk: int = 64):
    """SimScoreCAM: each channel's inverted, min-max normalised activation
    map masks the retrieved image; the masked copies are scored by their
    distance increase to the query, and the saliency is the score-weighted
    mean of the activations (explanations.py:540-602). Channels are embedded
    ``chunk`` at a time, the last chunk padded with zero maps as the JAX
    package pads it. x_q, x (1, H, W, C) -> (H, W)."""
    h, w = x_q.shape[1], x_q.shape[2]
    q = embed_fn(x_q)
    o_dist = _cdist(q, embed_fn(x))[0, 0]
    acts_up = _resize_channels(features_fn(x).float(), (h, w))[0]  # (H, W, C)
    flat = acts_up.reshape(-1, acts_up.shape[-1])
    amin, amax = torch.amin(flat, dim=0), torch.amax(flat, dim=0)
    valid = amax > amin
    denom = torch.where(valid, amax - amin, torch.ones_like(amax))
    norm_inv = torch.where(valid[None, None, :], 1.0 - (acts_up - amin) / denom,
                           torch.zeros_like(acts_up))
    c = acts_up.shape[-1]
    maps = norm_inv.permute(2, 0, 1)  # (C, H, W)
    pad = (-c) % chunk
    if pad:
        maps = torch.cat([maps, maps.new_zeros((pad, h, w))])
    me = torch.cat([embed_fn(mc[..., None] * x[0][None]) for mc in maps.split(chunk)])[:c]
    score = torch.clamp(_cdist(q, me)[0] - o_dist, min=0.0)  # (C,)
    rng = torch.amax(score) - torch.amin(score)
    score = torch.where(rng > 0, (score - torch.amin(score)) / torch.where(
        rng > 0, rng, torch.ones_like(rng)), score)
    score = torch.where(valid, score, torch.zeros_like(score))
    return torch.mean(score[None, None, :] * acts_up, dim=-1)
