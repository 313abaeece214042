"""Embedding models (port of DenseNet121Embedder, the ConvNeXtV2 embedders,
SwinV2Embedder, DinoV2Embedder, MedSigLIPEmbedder, DistillEmbedder,
NIHDualHeadModel and ConceptCLIPModel in xmir_tpu/models/embedders.py).

A convolutional or Swin embedder maps NHWC images to {"embedding": (B, D)
L2-normalised, "features": NHWC map, "logits": ... when a classification
head is set}; the ViT embedder to {"embedding", "tokens", "attentions"}; the
NIH dual-head model to {"cls_embedding" or "backbone_embedding",
"projection", "embedding", "logits"}; the MedSigLIP embedder to {"embedding",
"tokens", "encoder_tokens", "attentions"} and ConceptCLIP to {"embedding",
"tokens"}.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.distance import l2_normalize
from . import convnext, siglip, swin, vit
from .bert import BertTextBackbone
from .densenet import DenseNetBackbone, init_weights_
from .heads import MedSigLIPProjection, NIHProjectionHead, PCAMPool, SRA


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


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RAD_DINO_MEAN, RAD_DINO_STD = 0.5307, 0.2583


def teacher_input(x, size: int, rad_dino_norm: bool = False):
    """The teacher's view of the student's NHWC input: resized bilinearly to
    ``size`` (``jax.image.resize``'s "bilinear": half-pixel centres,
    antialiased when shrinking, no effect when growing). With
    ``rad_dino_norm`` the ImageNet normalisation is undone first and the
    image clipped to [0, 1], and RAD-DINO's applied after the resize
    (reference model.py:371-380). The ImageNet constants are f32 tensors, as
    the JAX module's are, so a bf16 input leaves that path in f32."""
    if rad_dino_norm:
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = torch.clamp(x * std + mean, 0.0, 1.0)
    shrink = size < x.shape[1] or size < x.shape[2]
    # PyTorch's antialiased resize takes f32 (not bf16) on the CPU: a shrink
    # runs in f32 and rounds once to x's dtype
    dt = torch.float32 if shrink else x.dtype
    y = F.interpolate(x.permute(0, 3, 1, 2).to(dt), size=(size, size), mode="bilinear",
                      align_corners=False, antialias=shrink).permute(0, 2, 3, 1).to(x.dtype)
    if rad_dino_norm:
        y = (y - RAD_DINO_MEAN) / RAD_DINO_STD
    return y


class DistillEmbedder(nn.Module):
    """ConvNeXtV2 student + ViT teacher (DINOv2 or RAD-DINO style), reference
    model.py:281-415. Keys: ``student.<ConvNeXtV2Embedder>`` (``convnext.*``,
    ``fc.*``) and ``teacher.<timm ViT>``. The student's widths default to
    ConvNeXtV2-Base's and the teacher's to ViT-B/14's; narrower ones are for
    tests.

    forward(x) returns the student's {"embedding", "features"}. In training,
    ``with_teacher=True`` adds "teacher_embedding": the teacher's
    L2-normalised CLS on ``teacher_input(x)``, under ``torch.no_grad()``
    unless ``teacher_trainable``. The JAX module computes the teacher in every
    training call and the embedding step discards it (XLA drops the dead
    work); here only the distillation step asks for it."""

    def __init__(self, embedding_dim: Optional[int] = None, teacher_img_size: int = 518,
                 teacher_trainable: bool = False, rad_dino_norm: bool = False, *,
                 depths: Sequence[int] = CONVNEXTV2_BASE["depths"],
                 dims: Sequence[int] = CONVNEXTV2_BASE["dims"], teacher_patch_size: int = 14,
                 teacher_dim: int = 768, teacher_depth: int = 12, teacher_num_heads: int = 12,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.teacher_img_size = teacher_img_size
        self.teacher_trainable = teacher_trainable
        self.rad_dino_norm = rad_dino_norm
        self.student = ConvNeXtV2Embedder(embedding_dim, depths=depths, dims=dims,
                                          generator=generator)
        self.teacher = vit.ViTBackbone(teacher_img_size, teacher_patch_size, teacher_dim,
                                       teacher_depth, teacher_num_heads)
        if generator is not None:
            vit.init_weights_(self.teacher, generator)

    def teacher_embedding(self, x):
        tx = teacher_input(x, self.teacher_img_size, self.rad_dino_norm)
        grad = contextlib.nullcontext() if self.teacher_trainable else torch.no_grad()
        with grad:
            return l2_normalize(self.teacher(tx)["cls"], dim=1)

    def forward(self, x, with_teacher: bool = False):
        out = self.student(x)
        result = {"embedding": out["embedding"], "features": out["features"]}
        if self.training and with_teacher:
            result["teacher_embedding"] = self.teacher_embedding(x)
        return result


class NIHDualHeadModel(nn.Module):
    """NIH multi-label dual-head retrieval model (reference
    nih_multilabel_retrieval.py:170-257): ``backbone`` "dinov2" (a ViT-B/14
    at 518, its CLS) or "convnextv2" (ConvNeXtV2-Base, its head-normed
    pooled features), then NIHProjectionHead. Keys: ``backbone.<timm ViT or
    ConvNeXtV2>`` and ``head.{proj_fc1,proj_fc2,classifier}.*``, the JAX
    tree's first components. The backbone widths default to the reference's;
    narrower ones are for tests."""

    def __init__(self, backbone: str = "dinov2", num_labels: int = 14, *, img_size: int = 518,
                 patch_size: int = 14, dim: int = 768, depth: int = 12, num_heads: int = 12,
                 depths: Sequence[int] = CONVNEXTV2_BASE["depths"],
                 dims: Sequence[int] = CONVNEXTV2_BASE["dims"],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kind = backbone
        if backbone == "dinov2":
            self.backbone = vit.ViTBackbone(img_size, patch_size, dim, depth, num_heads)
            width, init = dim, vit.init_weights_
        elif backbone == "convnextv2":
            self.backbone = convnext.ConvNeXtV2Backbone(depths, dims)
            width, init = dims[-1], convnext.init_weights_
        else:
            raise ValueError(f"unknown NIH backbone {backbone!r}")
        self.head = NIHProjectionHead(width, num_labels)
        if generator is not None:
            init(self.backbone, generator)
            for linear in (self.head.proj_fc1, self.head.proj_fc2, self.head.classifier):
                _init_head_linear_(linear, generator)

    def forward(self, x):
        out = self.backbone(x)
        if self.kind == "dinov2":
            feat = out["cls"]
            extra = {"cls_embedding": feat}
        else:
            feat = out["pooled_norm"]
            extra = {"backbone_embedding": feat}
        projection, logits = self.head(feat)
        return {**extra, "projection": projection,
                "embedding": l2_normalize(projection, dim=1), "logits": logits}


class MedSigLIPEmbedder(nn.Module):
    """SigLIP vision tower + trainable projection head (reference
    model.py:536-634). Keys: ``backbone.<HF SiglipVisionTransformer>`` and
    ``projection.{fc1,ln,fc2}.*``. forward(x, output_attentions, token_delta)
    returns {"embedding": (B, embed_dim) L2-normalised, "tokens",
    "encoder_tokens", "attentions"}. The backbone widths default to
    google/medsiglip-448's; narrower ones are for tests."""

    def __init__(self, embed_dim: int = 512, *, img_size: int = 448, patch_size: int = 14,
                 dim: int = 1152, depth: int = 27, num_heads: int = 16,
                 intermediate: int = 4304, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.backbone = siglip.SiglipVisionBackbone(img_size, patch_size, dim, depth, num_heads,
                                                    intermediate)
        self.projection = MedSigLIPProjection(dim, embed_dim)
        if generator is not None:
            siglip.init_weights_(self, generator)

    def forward(self, x, output_attentions: bool = False, token_delta=None):
        out = self.backbone(x, output_attentions, token_delta)
        emb = self.projection(out["pooled"])
        return {"embedding": l2_normalize(emb, dim=1), "tokens": out["tokens"],
                "encoder_tokens": out["encoder_tokens"], "attentions": out["attentions"]}


class ConceptCLIPModel(nn.Module):
    """Dual-encoder ConceptCLIP-style model (reference model.py:636-761): a
    SigLIP SO400M image tower (``visual.``), a BERT text tower (``text.``),
    ``text_projection`` to the image width, a learned ``logit_scale`` (ln 10)
    and ``logit_bias`` (-10), and an optional ``fc`` (``embedding_dim``).
    The widths follow the JAX module's rules: 16 heads (or the largest of 8,
    4, 2, 1 dividing ``dim``), intermediate 4304 at dim 1152 (else
    max(4 dim, 64)), a 768-wide text tower at dim 1152 (else ``dim`` wide)
    with 12 heads (or fewer, dividing it)."""

    def __init__(self, embedding_dim: Optional[int] = None, img_size: int = 384,
                 dim: int = 1152, depth: int = 27, text_depth: int = 12,
                 text_vocab: int = 30522, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        num_heads = next(h for h in (16, 8, 4, 2, 1) if dim % h == 0)
        self.visual = siglip.SiglipVisionBackbone(
            img_size=img_size, patch_size=14, dim=dim, depth=depth, num_heads=num_heads,
            intermediate=4304 if dim == 1152 else max(4 * dim, 64))
        text_dim = 768 if dim == 1152 else dim
        text_heads = next(h for h in (12, 8, 4, 2, 1) if text_dim % h == 0)
        self.text = BertTextBackbone(vocab_size=text_vocab, dim=text_dim, depth=text_depth,
                                     num_heads=text_heads, intermediate=4 * text_dim)
        self.text_projection = nn.Linear(text_dim, dim)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(10.0)))
        self.logit_bias = nn.Parameter(torch.tensor(-10.0))
        self.fc = nn.Linear(dim, embedding_dim) if embedding_dim else None
        if generator is not None:
            siglip.init_weights_(self, generator)

    def encode_image(self, pixel_values):
        out = self.visual(pixel_values)
        return out["pooled"], out["tokens"]

    def encode_text(self, input_ids, attention_mask=None):
        return vit._dense(self.text(input_ids, attention_mask)["cls"], self.text_projection)

    def forward_clip(self, pixel_values, input_ids, attention_mask=None):
        img_feat, img_tokens = self.encode_image(pixel_values)
        return {"image_features": img_feat,
                "text_features": self.encode_text(input_ids, attention_mask),
                "image_token_features": img_tokens, "logit_scale": self.logit_scale,
                "logit_bias": self.logit_bias}

    def forward(self, pixel_values):
        img_feat, img_tokens = self.encode_image(pixel_values)
        if self.fc is not None:
            img_feat = vit._dense(img_feat, self.fc)
        return {"embedding": l2_normalize(img_feat, dim=1), "tokens": img_tokens}
