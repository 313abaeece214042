"""SigLIP vision tower in PyTorch (port of xmir_tpu/models/siglip.py): the
MedSigLIP backbone and the ConceptCLIP image encoder; its encoder layers also
make the SigLIP text tower (models/siglip_text.py).

HF ``SiglipVisionTransformer`` graph and names (``embeddings.patch_embedding``,
``embeddings.position_embedding``, ``encoder.layers.{i}.{layer_norm1,
self_attn.{q,k,v,out}_proj, layer_norm2, mlp.fc1, mlp.fc2}``,
``post_layernorm``, ``head.{probe, attention.in_proj_weight,
attention.in_proj_bias, attention.out_proj, layernorm, mlp}``), so an HF
``SiglipVisionModel`` state dict (``vision_model.`` stripped) loads strictly.
Images are NHWC, as in the JAX module. A VALID patch convolution, no CLS
token, learned positions (resized bilinearly where the grid differs),
pre-norm layers with the tanh GELU (HF ``gelu_pytorch_tanh``, in every
dtype), LayerNorm eps 1e-6 with flax's fast variance, post-LayerNorm and a
multihead-attention pooling head with a learned probe.

Which path a layer takes follows the JAX package. With the input's dtype
passing ``fused_ln_enabled`` and ``plain_flash_enabled`` (bf16 on CUDA, or the
``XMIR_FUSED_LN`` / ``XMIR_FLASH_ATTN`` switches) at a width
``ln_qkv_eligible`` takes, layer_norm1 folds into the packed q | k | v
projection (K7, unless ``XMIR_FUSED_LN_QKV=0``) and attention runs fused
(K2). At SO400M's head width of 72 ``ln_qkv_eligible`` holds only under
``XMIR_FUSED_LN_QKV72=1``, as in the JAX package: by default the layer
takes one batched head-major projection into K2 wherever the compute dtype
(the input's promoted with the weights') passes ``plain_flash_enabled``.
Otherwise the eager path, which alone returns attention weights.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ln_dense import fused_ln_enabled, ln_qkv_eligible, ln_qkv_fused
from ..ops.plain_attn import flash_attention_plain, plain_flash_enabled
from .convnext import LayerNorm, _conv_nhwc
from .vit import _dense, holder, resize_positions


def _heads(t, b, n, h):
    """(B, N, C) -> (B, H, N, C / H)."""
    return t.reshape(b, n, h, -1).transpose(1, 2)


class SiglipAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def _packed(self, dt):
        """The three projections as one (3C, C) weight, rows q | k | v with
        the heads inside each (the layout K7 splits head-major), and its
        (3C,) bias."""
        projs = (self.q_proj, self.k_proj, self.v_proj)
        return (torch.cat([p.weight.to(dt) for p in projs]),
                torch.cat([p.bias for p in projs]))

    def forward(self, x, output_attentions: bool = False, ln=None):
        """x (B, N, C) -> (out (B, N, C), attention weights (B, H, N, N) f32
        or None). ``ln`` = (weight, bias) of layer_norm1 to fold into the
        projection: the caller passes it only when the gate of
        SiglipEncoderLayer holds."""
        b, n, c = x.shape
        h, hd = self.num_heads, self.dim // self.num_heads
        # flax's nn.Dense promotion: compute in the wider of x's and the
        # weights' dtypes, and gate the kernels on it (f32 parameters over
        # bf16 activations keep the eager path)
        dt = torch.promote_types(x.dtype, self.q_proj.weight.dtype)
        x = x.to(dt)

        if ln is not None:
            w3, b3 = self._packed(dt)
            q, k, v = ln_qkv_fused(x, ln[0], ln[1], w3, b3, h)
            out = flash_attention_plain(q, k, v, hd ** -0.5)
            return _dense(out.transpose(1, 2).reshape(b, n, self.dim), self.out_proj), None

        if not output_attentions and plain_flash_enabled(dt, n, x.device):
            # one batched projection, its output split head-major for K2
            w3, b3 = self._packed(dt)
            qkv = F.linear(x, w3, b3.to(dt)).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
            out = flash_attention_plain(qkv[0].contiguous(), qkv[1].contiguous(),
                                        qkv[2].contiguous(), hd ** -0.5)
            return _dense(out.transpose(1, 2).reshape(b, n, self.dim), self.out_proj), None

        # eager: f32 scores and softmax, the probabilities in v's dtype
        q, k, v = (_heads(_dense(x, p), b, n, h) for p in (self.q_proj, self.k_proj, self.v_proj))
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        out = _dense(out.transpose(1, 2).reshape(b, n, self.dim), self.out_proj)
        return out, (attn if output_attentions else None)


class SiglipMlp(nn.Module):
    def __init__(self, dim: int, intermediate: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, intermediate)
        self.fc2 = nn.Linear(intermediate, dim)

    def forward(self, x):
        # the tanh form in every dtype (HF gelu_pytorch_tanh), not adaptive_gelu
        return _dense(F.gelu(_dense(x, self.fc1), approximate="tanh"), self.fc2)


class SiglipEncoderLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.layer_norm1 = LayerNorm(dim)
        self.self_attn = SiglipAttention(dim, num_heads)
        self.layer_norm2 = LayerNorm(dim)
        self.mlp = SiglipMlp(dim, intermediate)

    def forward(self, x, output_attentions: bool = False):
        fuse_qkv = (
            not output_attentions
            and fused_ln_enabled(x.dtype, x.device)
            and ln_qkv_eligible(self.dim, self.dim // self.num_heads)
            and plain_flash_enabled(x.dtype, x.shape[1], x.device)
            and os.environ.get("XMIR_FUSED_LN_QKV", "1") != "0"
        )
        if fuse_qkv:
            h, attn = self.self_attn(x, output_attentions,
                                     ln=(self.layer_norm1.weight, self.layer_norm1.bias))
        else:
            h, attn = self.self_attn(self.layer_norm1(x), output_attentions)
        x = x + h
        return x + self.mlp(self.layer_norm2(x)), attn


class SiglipPoolingAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s parameters (packed in-projection,
    out-projection), so the HF head's ``attention.*`` tensors load by name."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


class SiglipPoolingHead(nn.Module):
    """Multihead attention pooling with a learned probe token: (B, N, D) ->
    (B, D)."""

    def __init__(self, dim: int, num_heads: int, intermediate: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.probe = nn.Parameter(torch.zeros(1, 1, dim))
        self.attention = SiglipPoolingAttention(dim)
        self.layernorm = LayerNorm(dim)
        self.mlp = SiglipMlp(dim, intermediate)

    def forward(self, tokens):
        b, n, d = tokens.shape
        h, hd = self.num_heads, self.dim // self.num_heads
        w, bias = self.attention.in_proj_weight, self.attention.in_proj_bias
        # the packed in-projection splits q | k | v, as the JAX converter does
        wq, wk, wv = w[:d], w[d:2 * d], w[2 * d:]
        bq, bk, bv = bias[:d], bias[d:2 * d], bias[2 * d:]

        def dense(t, wt, bt):
            dt = torch.promote_types(t.dtype, wt.dtype)
            return F.linear(t.to(dt), wt.to(dt), bt.to(dt))

        probe = self.probe.expand(b, 1, d)
        q = _heads(dense(probe, wq, bq), b, 1, h)
        k, v = _heads(dense(tokens, wk, bk), b, n, h), _heads(dense(tokens, wv, bv), b, n, h)
        a = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        a = torch.softmax(a, dim=-1)
        o = torch.matmul(a.to(v.dtype), v).transpose(1, 2).reshape(b, 1, d)
        o = _dense(o, self.attention.out_proj)
        return (o + self.mlp(self.layernorm(o)))[:, 0]


class SiglipVisionEmbeddings(nn.Module):
    def __init__(self, img_size: int, patch_size: int, dim: int):
        super().__init__()
        self.patch_embedding = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.position_embedding = nn.Embedding((img_size // patch_size) ** 2, dim)

    def forward(self, x):
        x = _conv_nhwc(x, self.patch_embedding)  # (B, gh, gw, D)
        b, gh, gw, d = x.shape
        x = x.reshape(b, gh * gw, d)
        return x + resize_positions(self.position_embedding.weight, gh, gw)[None]


def siglip_encoder(dim: int, depth: int, num_heads: int, intermediate: int) -> nn.Module:
    """HF's ``encoder.layers.{i}``."""
    return holder(layers=nn.ModuleList(SiglipEncoderLayer(dim, num_heads, intermediate)
                                       for _ in range(depth)))


class SiglipVisionBackbone(nn.Module):
    """forward(x (B, H, W, 3)) -> {"pooled": (B, D) MAP-head output (None
    without the head), "tokens": (B, N, D) post-layernorm patch tokens,
    "encoder_tokens": the last layer's output (plus ``token_delta``, the
    grad-CAM tap, where given), "attentions": None or a list of
    (B, H, N, N) f32 per layer}."""

    def __init__(self, img_size: int = 448, patch_size: int = 14, dim: int = 1152,
                 depth: int = 27, num_heads: int = 16, intermediate: int = 4304,
                 use_head: bool = True):
        super().__init__()
        self.embeddings = SiglipVisionEmbeddings(img_size, patch_size, dim)
        self.encoder = siglip_encoder(dim, depth, num_heads, intermediate)
        self.post_layernorm = LayerNorm(dim)
        self.head = SiglipPoolingHead(dim, num_heads, intermediate) if use_head else None

    def forward(self, x, output_attentions: bool = False, token_delta=None):
        x = self.embeddings(x)
        attentions = [] if output_attentions else None
        for layer in self.encoder.layers:
            x, attn = layer(x, output_attentions)
            if output_attentions:
                attentions.append(attn)
        # zeros leave the forward unchanged; the gradient at token_delta is
        # the gradient at the last layer's output
        if token_delta is not None:
            x = x + token_delta
        tokens = self.post_layernorm(x)
        pooled = self.head(tokens) if self.head is not None else None
        return {"pooled": pooled, "tokens": tokens, "encoder_tokens": x,
                "attentions": attentions}


def init_weights_(module: nn.Module, generator: torch.Generator):
    """The JAX modules' init, drawn from ``generator``: linear and conv
    weights (and the pooling head's packed in-projection) N(0, 1 / fan_in),
    biases 0, token tables N(0, 1 / width) (flax's ``nn.Embed``), learned
    positions and the probe N(0, 0.02^2), LayerNorm 1 / 0. Deterministic for
    a seeded CPU generator, whatever device the module later moves to."""
    def normal_(t, std):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    with torch.no_grad():
        for name, m in module.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                normal_(m.weight, m.weight[0].numel() ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal_(m.weight, 0.02 if name.endswith("position_embedding")
                        else m.weight.shape[1] ** -0.5)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, SiglipPoolingAttention):
                normal_(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
                m.in_proj_bias.zero_()
            elif isinstance(m, SiglipPoolingHead):
                normal_(m.probe, 0.02)
    return module


def medsiglip_448_vision(generator: Optional[torch.Generator] = None) -> SiglipVisionBackbone:
    """google/medsiglip-448 vision tower (So400m: 1152 / 27 / 16 / 4304, patch 14)."""
    model = SiglipVisionBackbone(img_size=448, patch_size=14, dim=1152, depth=27, num_heads=16,
                                 intermediate=4304)
    return init_weights_(model, generator) if generator is not None else model


def conceptclip_vision_384(generator: Optional[torch.Generator] = None) -> SiglipVisionBackbone:
    """ConceptCLIP image encoder: SigLIP-ViT-SO400M-14 at 384 (729 patches)."""
    model = SiglipVisionBackbone(img_size=384, patch_size=14, dim=1152, depth=27, num_heads=16,
                                 intermediate=4304)
    return init_weights_(model, generator) if generator is not None else model
