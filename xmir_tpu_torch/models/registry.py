"""Model registry (port of xmir_tpu/models/registry.py): one spec per
backbone with its input size, resize size, embedding width and
normalisation, for every model of the JAX package's registry: DenseNet121,
ResNet50, the three ConvNeXtV2 embedders, the SwinV2-Base embedder, the
DINOv2 ViT-B/14 embedder, the two ConvNeXtV2-student distillation models,
the two NIH dual-head models, the three CLIP-family models (MedSigLIP,
ConceptCLIP, BiomedCLIP), the ATH hashing model and the tiny debug model."""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

from .biomedclip import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD, BiomedCLIPModel
from .embedders import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ATHEmbedder,
    ConceptCLIPModel,
    ConvNeXtV2Embedder,
    ConvNeXtV2PCAMEmbedder,
    ConvNeXtV2SRAEmbedder,
    DenseNet121Embedder,
    DinoV2Embedder,
    DistillEmbedder,
    MedSigLIPEmbedder,
    NIHDualHeadModel,
    ResNet50Embedder,
    SwinV2Embedder,
    TinyEmbedder,
)

SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    builder: Callable
    input_size: int
    resize_size: int  # val-transform resize before center crop
    embed_dim: int  # default embedding dim (no fc override)
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    kwargs: tuple = ()  # default builder kwargs as sorted (k, v) pairs
    interpolation: str = "bilinear"


# sizes follow the reference transforms (train.py:928-993, test.py:1286-1332)
_SPECS = {
    "densenet121": ModelSpec("densenet121", DenseNet121Embedder, 224, 256, 1024),
    "resnet50": ModelSpec("resnet50", ResNet50Embedder, 224, 256, 2048),
    "convnextv2": ModelSpec("convnextv2", ConvNeXtV2Embedder, 384, 432, 1024),
    "convnextv2_sra": ModelSpec("convnextv2_sra", ConvNeXtV2SRAEmbedder, 384, 432, 1024),
    "convnextv2_pcam": ModelSpec("convnextv2_pcam", ConvNeXtV2PCAMEmbedder, 384, 432, 1024),
    "swinv2": ModelSpec("swinv2", SwinV2Embedder, 384, 432, 1024),
    "dinov2": ModelSpec("dinov2", DinoV2Embedder, 518, 518, 768, interpolation="bicubic"),
    "medsiglip": ModelSpec("medsiglip", MedSigLIPEmbedder, 448, 512, 512, SIGLIP_MEAN,
                           SIGLIP_STD),
    "conceptclip": ModelSpec("conceptclip", ConceptCLIPModel, 384, 432, 1152, SIGLIP_MEAN,
                             SIGLIP_STD),
    "convnextv2_dino_distill": ModelSpec("convnextv2_dino_distill", DistillEmbedder, 384, 432,
                                         1024),
    "convnextv2_raddino_distill": ModelSpec("convnextv2_raddino_distill", DistillEmbedder, 384,
                                            432, 1024, kwargs=(("rad_dino_norm", True),)),
    "nih_dinov2": ModelSpec("nih_dinov2", NIHDualHeadModel, 518, 518, 256,
                            kwargs=(("backbone", "dinov2"),)),
    "nih_convnextv2": ModelSpec("nih_convnextv2", NIHDualHeadModel, 384, 432, 256,
                                kwargs=(("backbone", "convnextv2"),)),
    # open_clip BiomedCLIP (reference test.py:1218-1240): CLIP normalisation, 224 px
    "biomedclip": ModelSpec("biomedclip", BiomedCLIPModel, 224, 224, 512, OPENAI_CLIP_MEAN,
                            OPENAI_CLIP_STD),
    "ath": ModelSpec("ath", ATHEmbedder, 256, 256, 48),
    # the JAX package's debug model (not in the reference)
    "tiny": ModelSpec("tiny", TinyEmbedder, 64, 64, 64),
}


def get_spec(name: str) -> ModelSpec:
    try:
        return _SPECS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; options: {sorted(_SPECS)}") from None


def list_models():
    return sorted(_SPECS)


def create_model(name: str, **overrides):
    """(model, spec) by registry name; ``overrides`` go to the builder (e.g.
    embedding_dim, num_labels, generator)."""
    spec = get_spec(name)
    kwargs = dict(spec.kwargs)
    kwargs.update(overrides)
    return spec.builder(**kwargs), spec
