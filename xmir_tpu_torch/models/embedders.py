"""Embedding models (port of DenseNet121Embedder, the ConvNeXtV2 embedders,
SwinV2Embedder and DinoV2Embedder in xmir_tpu/models/embedders.py).

A convolutional or Swin embedder maps NHWC images to {"embedding": (B, D)
L2-normalised, "features": NHWC map, "logits": ... when a classification
head is set}; the ViT embedder to {"embedding", "tokens", "attentions"}.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.distance import l2_normalize
from . import convnext, swin, vit
from .densenet import DenseNetBackbone, init_weights_
from .heads import PCAMPool, SRA


class DenseNet121Embedder(nn.Module):
    """The reference's DenseNet121 module (model.py:42-84): torchvision
    features + ReLU + global average pooling, an optional ``fc`` projection
    and an optional ``classification_head``.

    State-dict keys are those of
    xmir_tpu/models/export.py::export_densenet121_embedder:
    ``densenet121.0.<backbone>``, ``fc.*``, ``classification_head.*``. The
    backbone widths default to DenseNet121's; narrower ones are for tests.
    """

    def __init__(self, embedding_dim: Optional[int] = None,
                 num_labels: Optional[int] = None, *, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        backbone = DenseNetBackbone(growth_rate, block_config, num_init_features)
        self.densenet121 = nn.Sequential(backbone)
        feat = backbone.num_features
        self.fc = nn.Linear(feat, embedding_dim) if embedding_dim else None
        if embedding_dim:
            feat = embedding_dim
        self.classification_head = nn.Linear(feat, num_labels) if num_labels else None
        if generator is not None:
            init_weights_(self, generator)

    def forward(self, x):
        out = self.densenet121[0](x)
        feat = out["pooled"]
        if self.fc is not None:
            feat = self.fc(feat)
        result = {"embedding": l2_normalize(feat, dim=1), "features": out["features"]}
        if self.classification_head is not None:
            result["logits"] = self.classification_head(feat)
        return result


CONVNEXTV2_BASE = dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024))


def _normal_(weight, generator, std):
    with torch.no_grad():
        weight.copy_(torch.randn(weight.shape, generator=generator) * std)


def _init_head_linear_(linear: Optional[nn.Linear], generator):
    """N(0, 1/fan_in) weight, zero bias (the DenseNet embedder's fc init)."""
    if linear is not None:
        _normal_(linear.weight, generator, linear.in_features ** -0.5)
        with torch.no_grad():
            linear.bias.zero_()


class ConvNeXtV2Embedder(nn.Module):
    """timm num_classes=0 semantics: GAP -> head LayerNorm -> optional ``fc``
    (reference model.py:87-117). Keys: ``convnext.<timm backbone>``,
    ``fc.*``. The backbone widths default to ConvNeXtV2-Base's; narrower
    ones are for tests."""

    def __init__(self, embedding_dim: Optional[int] = None, *,
                 depths: Sequence[int] = CONVNEXTV2_BASE["depths"],
                 dims: Sequence[int] = CONVNEXTV2_BASE["dims"],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convnext = convnext.ConvNeXtV2Backbone(depths, dims)
        self.fc = nn.Linear(dims[-1], embedding_dim) if embedding_dim else None
        if generator is not None:
            convnext.init_weights_(self.convnext, generator)
            _init_head_linear_(self.fc, generator)

    def forward(self, x):
        out = self.convnext(x)
        feat = out["pooled_norm"]
        if self.fc is not None:
            feat = self.fc(feat)
        return {"embedding": l2_normalize(feat, dim=1), "features": out["features"]}


class ConvNeXtV2SRAEmbedder(nn.Module):
    """Backbone features -> SRA (sharing the head LayerNorm) -> normalise
    (reference model.py:165-196). Keys: ``convnext.*``, ``sra.conv_att.weight``."""

    def __init__(self, num_heads: int = 8, lam: float = 0.1, *,
                 depths: Sequence[int] = CONVNEXTV2_BASE["depths"],
                 dims: Sequence[int] = CONVNEXTV2_BASE["dims"],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convnext = convnext.ConvNeXtV2Backbone(depths, dims)
        self.sra = SRA(dims[-1], num_heads, lam)
        if generator is not None:
            convnext.init_weights_(self.convnext, generator)
            _normal_(self.sra.conv_att.weight, generator, 1e-4)  # the JAX init

    def forward(self, x):
        out = self.convnext(x)
        feat = self.sra(out["features"], out["head_norm"])
        return {"embedding": l2_normalize(feat, dim=1), "features": out["features"]}


class ConvNeXtV2PCAMEmbedder(nn.Module):
    """Backbone features -> PCAM pooling (reference model.py:249-278). Keys:
    ``convnext.*``, ``pcam.classifier.*``, ``pcam.fc.*``. In training mode
    the output also holds ``class_logits`` and the CAM maps ``pcam_maps``, as
    the JAX module's does with ``train=True``."""

    def __init__(self, num_classes: int = 3, lam: float = 0.1,
                 embedding_dim: Optional[int] = None, *,
                 depths: Sequence[int] = CONVNEXTV2_BASE["depths"],
                 dims: Sequence[int] = CONVNEXTV2_BASE["dims"],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convnext = convnext.ConvNeXtV2Backbone(depths, dims)
        self.pcam = PCAMPool(dims[-1], num_classes, lam, embedding_dim)
        if generator is not None:
            convnext.init_weights_(self.convnext, generator)
            _normal_(self.pcam.classifier.weight, generator, dims[-1] ** -0.5)
            with torch.no_grad():
                self.pcam.classifier.bias.zero_()
            _init_head_linear_(self.pcam.fc, generator)

    def forward(self, x):
        out = self.convnext(x)
        embedding, class_logits, pcam_maps = self.pcam(out["features"], out["head_norm"])
        result = {"embedding": embedding, "features": out["features"]}
        if self.training:
            result.update({"class_logits": class_logits, "pcam_maps": pcam_maps})
        return result


class SwinV2Embedder(nn.Module):
    """SwinV2 embedder (reference model.py:418-445): backbone -> mean over the
    final-norm map -> optional ``fc`` -> normalise. Keys: ``backbone.<timm
    SwinV2>``, ``fc.*``. The backbone widths default to
    swinv2_base_window12to24_192to384's; narrower ones are for tests."""

    def __init__(self, embedding_dim: Optional[int] = None, *, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 24,
                 pretrained_window: Sequence[int] = (12, 12, 12, 6),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = swin.SwinV2Backbone(embed_dim, depths, num_heads, window,
                                            pretrained_window)
        self.fc = (nn.Linear(self.backbone.num_features, embedding_dim) if embedding_dim
                   else None)
        if generator is not None:
            swin.init_weights_(self.backbone, generator)
            _init_head_linear_(self.fc, generator)

    def forward(self, x):
        out = self.backbone(x)
        feat = out["pooled"]
        if self.fc is not None:
            feat = vit._dense(feat, self.fc)
        return {"embedding": l2_normalize(feat, dim=1), "features": out["features"]}


class DinoV2Embedder(nn.Module):
    """DINOv2 CLS-token embedder (reference model.py:448-494): ViT backbone
    -> CLS -> optional ``fc`` -> normalise. Keys: ``backbone.<timm ViT>``,
    ``fc.*``. Returns {"embedding": (B, D), "tokens": (B, N, C) patch tokens,
    "attentions": None or per-block (B, H, N + 1, N + 1)}. The backbone
    widths default to ViT-B/14's; narrower ones are for tests."""

    def __init__(self, embedding_dim: Optional[int] = None, *, img_size: int = 518,
                 patch_size: int = 14, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 use_layerscale: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = vit.ViTBackbone(img_size, patch_size, dim, depth, num_heads,
                                        use_layerscale=use_layerscale)
        self.fc = nn.Linear(dim, embedding_dim) if embedding_dim else None
        if generator is not None:
            vit.init_weights_(self.backbone, generator)
            _init_head_linear_(self.fc, generator)

    def forward(self, x, output_attentions: bool = False):
        out = self.backbone(x, output_attentions)
        feat = out["cls"]
        if self.fc is not None:
            feat = vit._dense(feat, self.fc)
        return {"embedding": l2_normalize(feat, dim=1), "tokens": out["tokens"],
                "attentions": out["attentions"]}
