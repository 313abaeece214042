"""ConvNeXtV2 backbone in PyTorch (port of xmir_tpu/models/convnext.py).

The fcmae ConvNeXtV2 graph: a 4x4/4 stem conv + LayerNorm, stages of blocks
(7x7 depthwise conv -> LayerNorm -> pw1 (4x) -> GELU -> GRN -> pw2 ->
+ residual), LayerNorm + 2x2/2 conv downsampling between stages, and the head
LayerNorm after global average pooling. Parameter names are timm's
(``stem.0/1``, ``stages.i.downsample.0/1``,
``stages.i.blocks.j.{conv_dw,norm,mlp.fc1,mlp.grn,mlp.fc2}``, ``head.norm``),
so timm checkpoints load by name. Activations are NHWC, as in the JAX module;
the convolutions see them as NCHW views in channels_last memory.

Which path a block takes follows the JAX package. The block computes in
``dt``, its input's dtype promoted with its parameters' (flax promotes the
same way, so f32 parameters keep every block in f32 whatever the image's
dtype). ``fused_mlp_enabled(dt, device)`` then picks the fused block (K9
forward, K10 backward) or the plain path, in training only where
``fused_train_wins`` holds as well (``self.training`` stands for flax's
``train``); bf16 autocast does not change ``dt``, since the LayerNorms here
are written out (not ``F.layer_norm``) and keep the promoted dtype.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.convnext_block import (
    convnext_block_fused,
    dwconv,
    fused_mlp_enabled,
    fused_train_wins,
    layer_norm,
)
from .activations import adaptive_gelu


class LayerNorm(nn.Module):
    """LayerNorm over the last (channel) axis with flax's fast variance, eps
    1e-6 unless given (BERT's 1e-12, the MedSigLIP projection's 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class GlobalResponseNorm(nn.Module):
    """GRN over the spatial axes of an NHWC tensor (timm ``mlp.grn``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        gx = torch.sqrt(torch.sum(x * x, dim=(1, 2), keepdim=True) + 1e-12)
        nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
        return self.weight * (x * nx) + self.bias + x


class GlobalResponseNormMlp(nn.Module):
    """pw1 -> GELU -> GRN -> pw2 (timm ``mlp``), in the input's dtype."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.grn = GlobalResponseNorm(hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, h):
        h = F.linear(h, self.fc1.weight.to(h.dtype), self.fc1.bias.to(h.dtype))
        h = self.grn(adaptive_gelu(h))
        return F.linear(h, self.fc2.weight.to(h.dtype), self.fc2.bias.to(h.dtype))


def _conv_nhwc(x, conv: nn.Conv2d):
    """``conv`` on NHWC x in x's dtype promoted with the weight's. A layer
    that is not an ``nn.Conv2d`` (one split over a model axis) computes
    itself, promoting alike."""
    if not isinstance(conv, nn.Conv2d):
        dt = torch.promote_types(x.dtype, conv.dtype)
        return conv(x.to(dt).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    dt = torch.promote_types(x.dtype, conv.weight.dtype)
    y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt),
                 stride=conv.stride)
    return y.permute(0, 2, 3, 1)


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.mlp = GlobalResponseNormMlp(dim, 4 * dim)

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.conv_dw.weight.dtype)
        x = x.to(dt)
        mlp = self.mlp
        dim = self.norm.weight.shape[0]
        if fused_mlp_enabled(dt, x.device) and (
                not self.training or fused_train_wins(x.shape[1] * x.shape[2], dim, 4 * dim)):
            return convnext_block_fused(
                x, self.conv_dw.weight, self.conv_dw.bias, self.norm.weight, self.norm.bias,
                mlp.fc1.weight.to(dt), mlp.fc1.bias, mlp.fc2.weight.to(dt), mlp.fc2.bias,
                mlp.grn.weight, mlp.grn.bias,
            )
        # plain path: the JAX block's XLA path
        h = dwconv(x, self.conv_dw.weight, self.conv_dw.bias)
        return x + mlp(layer_norm(h, self.norm.weight, self.norm.bias).to(dt))


class ConvNeXtV2Stage(nn.Module):
    def __init__(self, cin: int, dim: int, depth: int, downsample: bool):
        super().__init__()
        self.downsample = (nn.ModuleList([LayerNorm(cin), nn.Conv2d(cin, dim, 2, stride=2)])
                           if downsample else None)
        self.blocks = nn.ModuleList([ConvNeXtV2Block(dim) for _ in range(depth)])

    def forward(self, x):
        if self.downsample is not None:
            norm, conv = self.downsample
            x = _conv_nhwc(norm(x), conv)
        for block in self.blocks:
            x = block(x)
        return x


class ConvNeXtV2Backbone(nn.Module):
    """forward(x (B, H, W, 3)) -> {"features": (B, H/32, W/32, C) pre-pool
    map, "pooled": (B, C) GAP, "pooled_norm": (B, C) after the head
    LayerNorm, "head_norm": its (weight, bias), which the SRA/PCAM heads
    reuse}."""

    def __init__(self, depths: Sequence[int] = (3, 3, 27, 3),
                 dims: Sequence[int] = (128, 256, 512, 1024)):
        super().__init__()
        self.stem = nn.ModuleList([nn.Conv2d(3, dims[0], 4, stride=4), LayerNorm(dims[0])])
        self.stages = nn.ModuleList(
            ConvNeXtV2Stage(dims[max(i - 1, 0)], dims[i], depth, downsample=i > 0)
            for i, depth in enumerate(depths)
        )
        self.head = nn.Module()
        self.head.norm = LayerNorm(dims[-1])

    def forward(self, x):
        conv, norm = self.stem
        x = norm(_conv_nhwc(x, conv))
        for stage in self.stages:
            x = stage(x)
        pooled = torch.mean(x, dim=(1, 2))
        return {
            "features": x,
            "pooled": pooled,
            "pooled_norm": self.head.norm(pooled),
            "head_norm": (self.head.norm.weight, self.head.norm.bias),
        }


def init_weights_(module: nn.Module, generator: torch.Generator):
    """timm's ConvNeXt init, drawn from ``generator``: conv and linear weights
    N(0, 0.02^2), biases 0, LayerNorm weight 1 / bias 0, GRN 0. Deterministic
    for a seeded CPU generator, whatever device the module later moves to."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, GlobalResponseNorm):
                m.weight.zero_()
                m.bias.zero_()
    return module


def convnextv2_base(generator: Optional[torch.Generator] = None) -> ConvNeXtV2Backbone:
    model = ConvNeXtV2Backbone(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024))
    return init_weights_(model, generator) if generator is not None else model


def convnextv2_tiny(generator: Optional[torch.Generator] = None) -> ConvNeXtV2Backbone:
    model = ConvNeXtV2Backbone(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768))
    return init_weights_(model, generator) if generator is not None else model
