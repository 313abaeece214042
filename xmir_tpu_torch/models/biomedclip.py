"""BiomedCLIP dual encoder in PyTorch (port of xmir_tpu/models/biomedclip.py;
open_clip ``hf-hub:microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224``).

The reference loads this tower through open_clip for its zero-shot
classification and image-image retrieval path (test.py:1218-1240, 237-347):
a timm ViT-B/16 at 224 px (CLS pooling, no LayerScale) with a bias-free
projection to 512, and an HF PubMedBERT text tower with CLS pooling and
open_clip's two-layer projection (768 -> 640 -> 512, erf GELU); a learned
``logit_scale`` initialised to ln(1 / 0.07). Names follow open_clip's layout
(``visual.trunk.<timm ViT>``, ``visual.head.proj``, ``text.transformer.<HF
BertModel>``, ``text.proj.0``, ``text.proj.2``, ``logit_scale``), so an
open_clip state dict loads strictly (models/convert.py). The image tower is
the port's ViT: K7 and K2 under its gates.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.distance import l2_normalize
from . import siglip, vit
from .bert import BertTextBackbone

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class BiomedCLIPModel(nn.Module):
    """forward(images (B, H, W, 3)) -> {"embedding": (B, embed_dim)
    L2-normalised image embedding} (the registry's embedder contract);
    ``encode_image`` / ``encode_text`` give the unnormalised features. The
    widths default to BiomedCLIP's; narrower ones are for tests (heads: the
    largest of 12, 8, 4, 2, 1 dividing the width, as in the JAX module)."""

    def __init__(self, embed_dim: int = 512, img_size: int = 224, vision_dim: int = 768,
                 vision_depth: int = 12, text_dim: int = 768, text_depth: int = 12,
                 text_vocab: int = 30522, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        heads = next(h for h in (12, 8, 4, 2, 1) if vision_dim % h == 0)
        trunk = vit.ViTBackbone(img_size=img_size, patch_size=16, dim=vision_dim,
                                depth=vision_depth, num_heads=heads, use_layerscale=False)
        self.visual = vit.holder(trunk=trunk,
                                 head=vit.holder(proj=nn.Linear(vision_dim, embed_dim, bias=False)))
        t_heads = next(h for h in (12, 8, 4, 2, 1) if text_dim % h == 0)
        transformer = BertTextBackbone(vocab_size=text_vocab, dim=text_dim, depth=text_depth,
                                       num_heads=t_heads, intermediate=4 * text_dim)
        hidden = (text_dim + embed_dim) // 2
        self.text = vit.holder(transformer=transformer, proj=nn.Sequential(
            nn.Linear(text_dim, hidden), nn.GELU(), nn.Linear(hidden, embed_dim)))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))
        if generator is not None:
            vit.init_weights_(self.visual.trunk, generator)
            siglip.init_weights_(self.visual.head, generator)
            siglip.init_weights_(self.text, generator)

    def encode_image(self, pixel_values):
        return vit._dense(self.visual.trunk(pixel_values)["cls"], self.visual.head.proj)

    def encode_text(self, input_ids, attention_mask=None):
        cls = self.text.transformer(input_ids, attention_mask)["cls"]
        h = F.gelu(vit._dense(cls, self.text.proj[0]))
        return vit._dense(h, self.text.proj[2])

    def forward(self, pixel_values):
        return {"embedding": l2_normalize(self.encode_image(pixel_values), dim=1)}
