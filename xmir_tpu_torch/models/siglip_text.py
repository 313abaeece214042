"""SigLIP text tower and the MedSigLIP dual encoder in PyTorch (port of
xmir_tpu/models/siglip_text.py).

HF ``SiglipTextTransformer`` graph and names (``embeddings.token_embedding``,
``embeddings.position_embedding``, ``encoder.layers.{i}``,
``final_layer_norm``, ``head``): token + position embeddings, the vision
tower's pre-norm encoder layers (so they take K2, and K7 under the same gate),
full attention with no mask (HF SigLIP right-pads and pools the last token),
the final LayerNorm, and ``head`` over the last token. The dual encoder
follows HF ``SiglipModel`` (``vision_model.``, ``text_model.``,
``logit_scale``, ``logit_bias``), so its state dict loads strictly.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .convnext import LayerNorm
from .siglip import SiglipVisionBackbone, init_weights_, siglip_encoder
from .vit import _dense, holder


class SiglipTextBackbone(nn.Module):
    """forward(input_ids (B, N), attention_mask ignored) -> {"tokens": (B, N, D),
    "pooled": (B, D)}."""

    def __init__(self, vocab_size: int = 256000, dim: int = 1152, depth: int = 27,
                 num_heads: int = 16, intermediate: int = 4304, max_position: int = 64):
        super().__init__()
        self.embeddings = holder(token_embedding=nn.Embedding(vocab_size, dim),
                                 position_embedding=nn.Embedding(max_position, dim))
        self.encoder = siglip_encoder(dim, depth, num_heads, intermediate)
        self.final_layer_norm = LayerNorm(dim)
        self.head = nn.Linear(dim, dim)

    def forward(self, input_ids, attention_mask=None):
        n = input_ids.shape[1]
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[None, :n]
        for layer in self.encoder.layers:
            x, _ = layer(x)
        x = self.final_layer_norm(x)
        return {"tokens": x, "pooled": _dense(x[:, -1], self.head)}


class MedSigLIPDualEncoder(nn.Module):
    """The full SigLIP dual encoder (vision + text + learned logit scale and
    bias) for MedSigLIP fine-tuning and zero-shot prompts; image-only
    retrieval goes through MedSigLIPEmbedder. The widths default to
    google/medsiglip-448's; narrower ones are for tests."""

    def __init__(self, img_size: int = 448, text_vocab: int = 256000, dim: int = 1152,
                 depth: int = 27, num_heads: int = 16, intermediate: int = 4304, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.vision_model = SiglipVisionBackbone(img_size=img_size, patch_size=14, dim=dim,
                                                 depth=depth, num_heads=num_heads,
                                                 intermediate=intermediate)
        self.text_model = SiglipTextBackbone(vocab_size=text_vocab, dim=dim, depth=depth,
                                             num_heads=num_heads, intermediate=intermediate)
        self.logit_scale = nn.Parameter(torch.full((1,), math.log(10.0)))
        self.logit_bias = nn.Parameter(torch.full((1,), -10.0))
        if generator is not None:
            init_weights_(self.vision_model, generator)
            init_weights_(self.text_model, generator)

    def get_image_features(self, pixel_values):
        return self.vision_model(pixel_values)["pooled"]

    def get_text_features(self, input_ids, attention_mask=None):
        return self.text_model(input_ids, attention_mask)["pooled"]

    def forward(self, pixel_values, input_ids, attention_mask=None):
        return {"image_features": self.get_image_features(pixel_values),
                "text_features": self.get_text_features(input_ids, attention_mask),
                "logit_scale": self.logit_scale[0], "logit_bias": self.logit_bias[0]}


COVIDX_LABEL_TO_TEXT = {
    0: "A chest X-ray showing no evidence of pneumonia or COVID-19 infection.",
    1: "A chest X-ray showing findings consistent with pneumonia.",
    2: "A chest X-ray showing findings consistent with COVID-19 pneumonia.",
}
