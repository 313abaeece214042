"""Retrieval heads (port of SRA, PCAMPool and NIHProjectionHead in
xmir_tpu/models/heads.py; reference model.py:120-163 and :199-247,
nih_multilabel_retrieval.py:170-257). NHWC in, plain tensor code."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.distance import l2_normalize
from .vit import _dense


def _channel_layernorm(v, scale, bias, eps: float = 1e-6):
    """LayerNorm over the last axis with the two-pass variance (jnp.var)."""
    mean = torch.mean(v, dim=-1, keepdim=True)
    var = torch.mean((v - mean) ** 2, dim=-1, keepdim=True)
    return (v - mean) / torch.sqrt(var + eps) * scale + bias


class SRA(nn.Module):
    """Spatial Residual Attention: K 1x1-conv attention heads, softmax over
    H*W, fused as gap + lam * (head-mean of the attended features). With
    ``norm_params`` (the backbone's head LayerNorm) both branches are
    normalised first, as the reference reuses ``convnext.head.norm``."""

    def __init__(self, input_dim: int, num_heads: int = 8, lam: float = 0.1):
        super().__init__()
        self.conv_att = nn.Conv2d(input_dim, num_heads, 1, bias=False)
        self.lam = lam

    def forward(self, x, norm_params: Optional[tuple] = None):
        b, h, w, c = x.shape
        gap = torch.mean(x, dim=(1, 2))
        x_flat = x.reshape(b, h * w, c)
        att = torch.matmul(x_flat, self.conv_att.weight.reshape(-1, c).t().to(x.dtype))
        att = torch.softmax(att, dim=1)  # over the spatial positions
        csra = torch.einsum("bsk,bsc->bkc", att, x_flat).mean(dim=1)
        if norm_params is not None:
            scale, bias = norm_params
            gap = _channel_layernorm(gap, scale, bias)
            csra = _channel_layernorm(csra, scale, bias)
        return gap + self.lam * csra


class PCAMPool(nn.Module):
    """Probabilistic-CAM pooling. Returns (L2-normalised embedding, class
    logits (B, K), CAM probabilities (B, H, W, K)). The 1x1 classifier's
    weight also scores the class-pooled features."""

    def __init__(self, input_dim: int, num_classes: int, lam: float = 0.1,
                 embedding_dim: Optional[int] = None):
        super().__init__()
        self.classifier = nn.Conv2d(input_dim, num_classes, 1)
        self.fc = nn.Linear(input_dim, embedding_dim) if embedding_dim else None
        self.lam = lam

    def forward(self, x, norm_params: Optional[tuple] = None):
        b, h, w, c = x.shape
        gap = torch.mean(x, dim=(1, 2))
        if norm_params is not None:
            scale, bias = norm_params
            gap = _channel_layernorm(gap, scale, bias)
            x = _channel_layernorm(x, scale, bias)
        w_mat = self.classifier.weight.reshape(-1, c).t().to(x.dtype)  # (C, K)
        b_vec = self.classifier.bias.to(x.dtype)
        x_flat = x.reshape(b, h * w, c)
        cam_logits = torch.matmul(x_flat, w_mat) + b_vec
        pcam_probs = torch.sigmoid(cam_logits)
        wgt = pcam_probs / (torch.sum(pcam_probs, dim=1, keepdim=True) + 1e-8)
        class_pooled = torch.einsum("bsk,bsc->bkc", wgt, x_flat)
        class_logits = torch.einsum("bkc,ck->bk", class_pooled, w_mat) + b_vec
        class_weights = torch.softmax(class_logits, dim=1)[:, :, None]
        feat = gap + self.lam * torch.sum(class_weights * class_pooled, dim=1)
        if self.fc is not None:
            feat = self.fc(feat)
        return l2_normalize(feat, dim=1), class_logits, pcam_probs.reshape(b, h, w, -1)


class NIHProjectionHead(nn.Module):
    """Linear(in_dim -> 512) -> exact (erf) GELU -> Linear(512 -> proj_dim),
    and a ``num_labels``-logit classifier on the projection. Returns
    (projection, logits), each in the features' dtype promoted with the
    weights' (flax's ``nn.Dense``)."""

    def __init__(self, in_dim: int, num_labels: int = 14, proj_dim: int = 256):
        super().__init__()
        self.proj_fc1 = nn.Linear(in_dim, 512)
        self.proj_fc2 = nn.Linear(512, proj_dim)
        self.classifier = nn.Linear(proj_dim, num_labels)

    def forward(self, feats):
        projection = _dense(F.gelu(_dense(feats, self.proj_fc1)), self.proj_fc2)
        return projection, _dense(projection, self.classifier)
