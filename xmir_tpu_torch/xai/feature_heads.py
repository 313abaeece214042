"""Differentiable feature -> embedding heads for gradient-based explanations
(port of xmir_tpu/xai/feature_heads.py).

The backbones return their final feature map (``"features"``); these small
functions recompute the embedder's tail (pool, fc, normalise) from the
model's own parameters, so that ``torch.autograd.grad`` of a score of
``head_fn(features)`` gives the feature gradients with no hooks.
"""
from __future__ import annotations

import torch

from ..ops.distance import l2_normalize


def densenet_head(model, features):
    """DenseNet121Embedder's tail: ReLU -> GAP -> optional fc -> normalise
    (features: the post-norm5, pre-ReLU map, NHWC)."""
    return resnet_head(model, torch.clamp_min(features, 0.0))


def resnet_head(model, features):
    """ResNet50Embedder's tail: GAP -> optional fc -> normalise (features:
    the post-ReLU map, NHWC). TinyEmbedder's tail is the same."""
    x = torch.mean(features, dim=(1, 2))
    if model.fc is not None:
        x = model.fc(x)
    return l2_normalize(x, dim=1)


def convnext_head(model, features):
    """ConvNeXtV2Embedder's tail: GAP -> head LayerNorm -> optional fc ->
    normalise."""
    x = model.convnext.head.norm(torch.mean(features, dim=(1, 2)))
    if model.fc is not None:
        x = model.fc(x)
    return l2_normalize(x, dim=1)


FEATURE_HEADS = {"densenet121": densenet_head, "resnet50": resnet_head,
                 "convnextv2": convnext_head, "tiny": resnet_head}


def get_feature_head(model_name: str, model):
    """head_fn(features) -> embeddings for ``model`` (an embedder of the
    registry's ``model_name``)."""
    if model_name not in FEATURE_HEADS:
        raise ValueError(f"no feature head for {model_name!r}; options: "
                         f"{sorted(FEATURE_HEADS)}")
    head = FEATURE_HEADS[model_name]
    return lambda features: head(model, features)
