"""Vision Transformer backbone (DINOv2 / RAD-DINO style) in PyTorch (port of
xmir_tpu/models/vit.py).

Pre-norm blocks with LayerScale, a CLS token and learned position embeddings,
patch 14. Parameter names are timm's (``cls_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.N.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,
mlp.fc1,mlp.fc2,ls2.gamma}``, ``norm``), so a timm
``vit_base_patch14_dinov2`` checkpoint loads by name. Images are NHWC, as in
the JAX module. Attention weights are first-class outputs
(``output_attentions=True``).

Which path a block takes follows the JAX package. A block whose input dtype
passes ``fused_ln_enabled`` and ``plain_flash_enabled`` (bf16 on CUDA, or the
``XMIR_FUSED_LN`` / ``XMIR_FLASH_ATTN`` switches) at an eligible width folds
norm1 into the qkv projection (K7, unless ``XMIR_FUSED_LN_QKV=0``) and runs
the fused attention (K2); with ``XMIR_FUSED_LN_MLP=1`` it also folds norm2
into fc1 with the tanh-GELU (K8; in bf16 the LayerNorm pre-pass and a
persistent wgmma product whose two warpgroups take turns, one's GELU
epilogue under the other's products; off by default, as in the JAX package).
Otherwise attention alone takes K2 when its compute dtype (the input's
promoted with the qkv weight's) passes ``plain_flash_enabled``; else the
eager path, which is also the only one that returns attention weights.

Training changes nothing in the graph (no dropout, no drop-path, as in the
JAX module), and the gates read the compute dtype: an f32 master model run
on bf16 copies of its parameters (train/steps.py) takes K7 and K2, whose
backwards are ``ln_qkv_backward`` and K3.

The patch convolution has no padding (timm's): at an image size that is not
a multiple of the patch the JAX module (flax's SAME padding) pads and this
one does not.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.ln_dense import fused_ln_enabled, ln_dense_fused, ln_qkv_eligible, ln_qkv_fused
from ..ops.plain_attn import flash_attention_plain, plain_flash_enabled
from .activations import adaptive_gelu
from .convnext import LayerNorm, _conv_nhwc


def _dense(x, linear: nn.Linear):
    """``linear`` on x in x's dtype promoted with the weight's (flax's
    ``nn.Dense`` promotion)."""
    dt = torch.promote_types(x.dtype, linear.weight.dtype)
    bias = None if linear.bias is None else linear.bias.to(dt)
    return F.linear(x.to(dt), linear.weight.to(dt), bias)


class MultiHeadAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, output_attentions: bool = False, ln=None):
        """x (B, N, C) -> (out (B, N, C), attention weights (B, H, N, N) f32
        or None). ``ln`` = (weight, bias) of the pre-LayerNorm to fold into
        the projection: the caller passes it only when the fused paths are
        enabled and the width is eligible."""
        b, n, c = x.shape
        h = self.num_heads
        head_dim = self.dim // h
        dt = torch.promote_types(x.dtype, self.qkv.weight.dtype)
        x = x.to(dt)
        w = self.qkv.weight.to(dt)  # rows q | k | v, heads inside each
        bias = self.qkv.bias

        if ln is not None:
            q, k, v = ln_qkv_fused(x, ln[0], ln[1], w, bias, h)
            out = flash_attention_plain(q, k, v, head_dim ** -0.5)
            return _dense(out.transpose(1, 2).reshape(b, n, self.dim), self.proj), None

        qkv = F.linear(x, w, None if bias is None else bias.to(dt))
        qkv = qkv.reshape(b, n, 3, h, head_dim).permute(2, 0, 3, 1, 4)  # (3, B, H, N, hd)
        if not output_attentions and plain_flash_enabled(dt, n, x.device):
            out = flash_attention_plain(qkv[0].contiguous(), qkv[1].contiguous(),
                                        qkv[2].contiguous(), head_dim ** -0.5)
            return _dense(out.transpose(1, 2).reshape(b, n, self.dim), self.proj), None

        # eager: f32 scores and softmax, the probabilities in v's dtype
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * head_dim ** -0.5
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        out = _dense(out.transpose(1, 2).reshape(b, n, self.dim), self.proj)
        return out, (attn if output_attentions else None)


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x):
        return x * self.gamma


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, ln=None):
        """fc1 -> GELU -> fc2. With ``ln`` = (weight, bias) of the
        pre-LayerNorm, x is the un-normalised input and norm, fc1 and the
        tanh-GELU run fused (K8)."""
        if ln is not None:
            b, n, c = x.shape
            h = ln_dense_fused(x.reshape(b * n, c), ln[0], ln[1], self.fc1.weight.to(x.dtype),
                               self.fc1.bias, 1e-6, "gelu")
            return _dense(h.reshape(b, n, -1), self.fc2)
        return _dense(adaptive_gelu(_dense(x, self.fc1)), self.fc2)


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_layerscale: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.ls1 = LayerScale(dim) if use_layerscale else nn.Identity()
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, self.hidden)
        self.ls2 = LayerScale(dim) if use_layerscale else nn.Identity()

    def forward(self, x, output_attentions: bool = False):
        fuse_ln = (
            not output_attentions
            and fused_ln_enabled(x.dtype, x.device)
            and ln_qkv_eligible(self.dim, self.dim // self.num_heads)
            and self.hidden % 128 == 0
            and plain_flash_enabled(x.dtype, x.shape[1], x.device)
        )
        fuse_qkv = fuse_ln and os.environ.get("XMIR_FUSED_LN_QKV", "1") != "0"
        fuse_mlp = fuse_ln and os.environ.get("XMIR_FUSED_LN_MLP", "0") == "1"
        if fuse_qkv:
            h, attn = self.attn(x, output_attentions, ln=(self.norm1.weight, self.norm1.bias))
        else:
            h, attn = self.attn(self.norm1(x), output_attentions)
        x = x + self.ls1(h)
        if fuse_mlp:
            h = self.mlp(x, ln=(self.norm2.weight, self.norm2.bias))
        else:
            h = self.mlp(self.norm2(x))
        return x + self.ls2(h), attn


def resize_positions(pos, gh: int, gw: int):
    """(P, C) square-grid position embeddings at a (gh, gw) grid: unchanged
    where P = gh gw, else resampled bilinearly with half-pixel centres,
    antialiased when shrinking (``jax.image.resize``'s "bilinear")."""
    if pos.shape[0] == gh * gw:
        return pos
    g_old = int(round(pos.shape[0] ** 0.5))
    grid = pos.reshape(1, g_old, g_old, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", antialias=True,
                         align_corners=False)
    return grid.permute(0, 2, 3, 1).reshape(gh * gw, -1)


def interpolate_pos_embed(pos_embed, num_patches_new: int, num_prefix_tokens: int = 1):
    """The grid position embeddings of (1, P + G^2, C) resized to a new
    square patch count (``resize_positions``); the prefix tokens' kept."""
    g_new = int(round(num_patches_new ** 0.5))
    if pos_embed.shape[1] - num_prefix_tokens == g_new * g_new:
        return pos_embed
    grid = resize_positions(pos_embed[0, num_prefix_tokens:], g_new, g_new)
    return torch.cat([pos_embed[:, :num_prefix_tokens], grid[None]], dim=1)


def holder(**children) -> nn.Module:
    """A module that only holds ``children`` under their names: a
    checkpoint's nesting (HF's ``attention.output.dense``, open_clip's
    ``visual.head.proj``) without a class for each level."""
    module = nn.Module()
    for name, child in children.items():
        module.add_module(name, child)
    return module


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class ViTBackbone(nn.Module):
    """DINOv2-style ViT. forward(x (B, H, W, 3)) -> {"cls": (B, D) final-norm
    CLS token, "tokens": (B, N, D) final-norm patch tokens, "attentions":
    None or a list of (B, H, N + 1, N + 1) f32 per block}."""

    def __init__(self, img_size: int = 518, patch_size: int = 14, dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 use_layerscale: bool = True):
        super().__init__()
        self.dim = dim
        self.patch_embed = PatchEmbed(patch_size, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, (img_size // patch_size) ** 2 + 1, dim))
        self.blocks = nn.ModuleList(ViTBlock(dim, num_heads, mlp_ratio, use_layerscale)
                                    for _ in range(depth))
        self.norm = LayerNorm(dim)

    def forward(self, x, output_attentions: bool = False):
        x = _conv_nhwc(x, self.patch_embed.proj)  # (B, gh, gw, D)
        b, gh, gw, _ = x.shape
        x = x.reshape(b, gh * gw, self.dim)
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, 1, self.dim), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, gh * gw)
        attentions = [] if output_attentions else None
        for block in self.blocks:
            x, attn = block(x, output_attentions)
            if output_attentions:
                attentions.append(attn)
        x = self.norm(x)
        return {"cls": x[:, 0], "tokens": x[:, 1:], "attentions": attentions}


def init_weights_(module: nn.Module, generator: torch.Generator):
    """The JAX module's init, drawn from ``generator``: conv and linear
    weights N(0, 1 / fan_in), biases 0, CLS N(0, 1e-6^2), position embeddings
    N(0, 0.02^2), LayerNorm 1 / 0, LayerScale 1e-5. Deterministic for a
    seeded CPU generator, whatever device the module later moves to."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * fan_in ** -0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, LayerScale):
                m.gamma.fill_(1e-5)
            elif isinstance(m, ViTBackbone):
                m.cls_token.copy_(torch.randn(m.cls_token.shape, generator=generator) * 1e-6)
                m.pos_embed.copy_(torch.randn(m.pos_embed.shape, generator=generator) * 0.02)
    return module


def vit_base_patch14_dinov2(generator: Optional[torch.Generator] = None) -> ViTBackbone:
    model = ViTBackbone(img_size=518, patch_size=14, dim=768, depth=12, num_heads=12)
    return init_weights_(model, generator) if generator is not None else model


def rad_dino_backbone(generator: Optional[torch.Generator] = None) -> ViTBackbone:
    """microsoft/rad-dino is a DINOv2 ViT-B/14 at 518."""
    return vit_base_patch14_dinov2(generator)
