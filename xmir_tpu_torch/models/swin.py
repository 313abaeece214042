"""SwinV2 backbone in PyTorch (port of xmir_tpu/models/swin.py), NHWC.

The timm ``swinv2_base_window12to24_192to384`` graph: post-norm residual
blocks, cosine attention with a learnable per-head temperature, a log-spaced
continuous relative position bias (a 2-layer MLP), shifted windows, and
SwinV2-order patch merging (reduce -> norm). Parameter names are timm's
(``patch_embed.{proj,norm}``, ``layers.N.blocks.M.{attn.{qkv.weight,q_bias,
v_bias,logit_scale,cpb_mlp.0,cpb_mlp.2,proj},norm1,norm2,mlp.fc1,mlp.fc2}``,
``layers.N.downsample.{reduction,norm}``, ``norm``), so a timm checkpoint
loads by name; timm's buffers (``relative_coords_table``,
``relative_position_index``, ``attn_mask``) are recomputed here from the
map's size at each call, as the JAX module does, and are no part of the state.

Which path a block's attention takes follows the JAX package: where
``fused_attention_enabled`` passes the compute dtype (bf16 on CUDA, or
``XMIR_FUSED_ATTN=1``) it runs the grouped-bias cosine kernel (K4), rows
folded (head, window, image) so that the rows of one bias slice are
neighbours; with ``XMIR_SWIN_KERNEL=v1`` the v1 kernel (K6), which takes q
and k normalised outside; else the eager path, which is also the only one
that returns attention weights.

The patch convolution has no padding (timm's): at an image size that is not a
multiple of 4 the JAX module (flax's SAME padding) pads and this one does not.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.vit_attn import biased_attention_fused
from ..ops.window_attn import fused_attention_enabled, window_attention_fused
from .activations import adaptive_gelu
from .convnext import _conv_nhwc
from .vit import _dense


@functools.lru_cache(maxsize=64)
def _rel_coords_table(win: int, pretrained_win: int):
    """Log-spaced relative coordinate table, (2W-1, 2W-1, 2) float32."""
    coords = np.arange(-(win - 1), win, dtype=np.float32)
    table = np.stack(np.meshgrid(coords, coords, indexing="ij"), axis=-1)
    table = table / max(pretrained_win - 1, 1) * 8.0
    table = np.sign(table) * np.log2(1.0 + np.abs(table)) / np.log2(8.0)
    return table.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _rel_position_index(win: int):
    """(W², W²) index into the flattened (2W-1)² table (timm's
    ``relative_position_index``)."""
    coords = np.stack(
        np.meshgrid(np.arange(win), np.arange(win), indexing="ij"), axis=0
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (win - 1)
    return (rel[..., 0] * (2 * win - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _offset_onehot(win: int):
    """(W^2, 2W-1) float32: row (i, j) is one at i - j + W - 1, the 1-D
    relative offset of positions i and j along one axis of a window."""
    i, j = np.meshgrid(np.arange(win), np.arange(win), indexing="ij")
    onehot = np.zeros((win, win, 2 * win - 1), np.float32)
    onehot[i, j, i - j + win - 1] = 1.0
    return onehot.reshape(win * win, 2 * win - 1)


class _RelBiasGather(torch.autograd.Function):
    """table (2W-1, 2W-1, H) -> bias (H, W^2, W^2) with
    bias[h, (yi, xi), (yj, xj)] = table[yi - yj + W - 1, xi - xj + W - 1, h].
    The forward is one index_select. Its backward adds each offset's
    gradients with two matrix products against ``_offset_onehot`` (a fixed
    order): index_select's own backward adds them with atomics on CUDA, so two
    runs of a train step, and a resumed run against an uninterrupted one,
    would differ in their last bits."""

    @staticmethod
    def forward(ctx, table, window):
        ctx.window = window
        index = _on_device(_rel_position_index, (window,), table.device)
        n = window * window
        return torch.index_select(table.reshape(-1, table.shape[-1]).t(), 1,
                                  index.reshape(-1)).reshape(-1, n, n)

    @staticmethod
    def backward(ctx, g):
        w = ctx.window
        heads = g.shape[0]
        onehot = _on_device(_offset_onehot, (w,), g.device)
        # (H, (yi, xi), (yj, xj)) -> (H, (yi, yj), (xi, xj))
        g = g.reshape(heads, w, w, w, w).permute(0, 1, 3, 2, 4).reshape(heads, w * w, w * w)
        return (onehot.t() @ g @ onehot).permute(1, 2, 0), None


@functools.lru_cache(maxsize=64)
def _shift_attn_mask(grid: int, win: int, shift: int):
    """(num_windows, W², W²) additive mask for shifted-window attention:
    -100 between tokens of different regions, not -inf."""
    if shift == 0:
        return None
    img = np.zeros((grid, grid), np.int32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(grid // win, win, grid // win, win)
    wins = wins.transpose(0, 2, 1, 3).reshape(-1, win * win)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _on_device(make, args, device):
    """``make(*args)`` (a cached numpy constant) as a tensor on ``device``,
    made once per device, and never as an inference tensor: a constant first
    made under ``torch.inference_mode`` would refuse to be saved for a later
    training step's backward. Under tracing (``torch.export``, whose tensors
    are fake) it is made anew and not cached: a cached fake tensor would
    stand in for the constant in every later eager call; the program records
    the constant itself."""
    if torch._guards.detect_fake_mode() is not None:
        return torch.from_numpy(np.ascontiguousarray(make(*args))).to(device)
    return _cached_on_device(make, args, device)


@functools.lru_cache(maxsize=256)
def _cached_on_device(make, args, device):
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(make(*args))).to(device)


def window_partition(x, win: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win * win, c)


def window_reverse(x, win: int, h: int, w: int):
    b = x.shape[0] // ((h // win) * (w // win))
    x = x.reshape(b, h // win, w // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, eps 1e-5, in x's dtype promoted with the
    weight's (f32 statistics inside PyTorch's one fused kernel: no kernel of
    this model needs the LayerNorm's roundings to be at stated points)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.weight.shape, self.weight.to(dt), self.bias.to(dt),
                            1e-5)


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


class WindowAttentionV2(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512), nn.ReLU(),
                                     nn.Linear(512, num_heads, bias=False))
        self.proj = nn.Linear(dim, dim)

    def position_bias(self, window: int, pretrained_window: int, device):
        """16 sigmoid(cpb_mlp(table)) gathered to (H, W², W²), float32."""
        table = _on_device(_rel_coords_table, (window, pretrained_window), device)
        hidden = F.relu(_dense(table, self.cpb_mlp[0]))
        t2 = 16.0 * torch.sigmoid(_dense(hidden, self.cpb_mlp[2])).float()  # (2W-1, 2W-1, H)
        return _RelBiasGather.apply(t2, window)

    def forward(self, x, window: int, pretrained_window: int, num_windows: int = 1, mask=None,
                output_attentions: bool = False):
        """x (num_windows * B, W², C) -> (out of the same shape, attention
        weights (num_windows * B, H, W², W²) f32 or None). ``mask``
        (num_windows, W², W²) is the shift mask."""
        bw, n, _ = x.shape
        nh, hd = self.num_heads, self.dim // self.num_heads
        dt = torch.promote_types(x.dtype, self.qkv.weight.dtype)
        qkv_bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias]).to(dt)
        qkv = F.linear(x.to(dt), self.qkv.weight.to(dt), qkv_bias)
        qkv = qkv.reshape(bw, n, 3, nh, hd).permute(2, 0, 3, 1, 4)  # (3, BW, H, N, hd)
        q, k, v = qkv[0], qkv[1], qkv[2]
        # cosine attention with a learnable per-head temperature, at most 100
        scale = torch.exp(torch.clamp(self.logit_scale, max=math.log(100.0)))
        bias = self.position_bias(window, pretrained_window, x.device)

        if not output_attentions and fused_attention_enabled(dt, x.device):
            nw, b_img = num_windows, bw // num_windows
            # the kept-for-comparison v1 kernel (K6) has no backward: a module
            # in training mode takes K4 + K5, as the JAX package does
            if os.environ.get("XMIR_SWIN_KERNEL", "") == "v1" and not self.training:
                qs = (_unit(q) * scale[None]).to(dt)
                total = bias[None]  # (1, H, N, N)
                if mask is not None:
                    total = total + mask[:, None]  # (nw, H, N, N)

                def to_wbhnd(t):
                    return t.reshape(b_img, nw, nh, n, hd).permute(1, 0, 2, 3, 4).contiguous()

                out = window_attention_fused(to_wbhnd(qs), to_wbhnd(_unit(k)), to_wbhnd(v),
                                             total.contiguous())
                # (nw, B, H, N, hd) -> (B, nw, N, H, hd) -> (BW, N, C)
                out = out.permute(1, 0, 3, 2, 4).reshape(bw, n, self.dim)
                return _dense(out, self.proj), None

            # fold (head, window, image): without a shift mask the (H, N, N)
            # bias slice is shared by all nw * B rows of a head; with one, the
            # (H * nw, N, N) slice by the B rows of a (head, window) pair
            scale_h = scale.reshape(nh).float()
            if mask is not None:
                total = (bias[:, None] + mask[None]).reshape(-1, n, n)
                scale_g, g_size = scale_h.repeat_interleave(nw), b_img
            else:
                total, scale_g, g_size = bias, scale_h, nw * b_img

            # one copy folds q, k and v: (3, BW, H, N, hd) -> (3, H * nw * B, N, hd)
            folded = qkv.reshape(3, b_img, nw, nh, n, hd).permute(0, 3, 2, 1, 4, 5).reshape(
                3, -1, n, hd).contiguous()
            out = biased_attention_fused(folded[0], folded[1], folded[2], total, scale_g,
                                         g_size, True)
            out = out.reshape(nh, nw, b_img, n, hd).permute(2, 1, 3, 0, 4).reshape(bw, n, self.dim)
            return _dense(out, self.proj), None

        # eager: f32 logits and softmax, the probabilities in v's dtype
        attn = torch.matmul(_unit(q).float(), _unit(k).float().transpose(-1, -2)) * scale
        attn = attn + bias[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(bw // nw, nw, nh, n, n) + mask[None, :, None]
            attn = attn.reshape(bw, nh, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        out = _dense(out.transpose(1, 2).reshape(bw, n, self.dim), self.proj)
        return out, (attn if output_attentions else None)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return _dense(adaptive_gelu(_dense(x, self.fc1)), self.fc2)


class SwinV2Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 pretrained_window: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.window, self.shift, self.pretrained_window = window, shift, pretrained_window
        self.attn = WindowAttentionV2(dim, num_heads)
        self.norm1 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm2 = LayerNorm(dim)

    def forward(self, x, output_attentions: bool = False):
        """x (B, H, W, C); post-norm residuals (SwinV2). The window is cut to
        the map, and a window that covers the map is not shifted."""
        b, h, w, c = x.shape
        win = min(self.window, h, w)
        shift = 0 if win >= h else self.shift

        shortcut = x
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = None if shift == 0 else _on_device(_shift_attn_mask, (h, win, shift), x.device)
        xw, attn = self.attn(window_partition(x, win), win, min(self.pretrained_window, win),
                             (h // win) * (w // win), mask, output_attentions)
        x = window_reverse(xw, win, h, w)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + self.norm1(x)
        return x + self.norm2(self.mlp(x)), attn


class PatchMerging(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * in_dim, out_dim, bias=False)
        self.norm = LayerNorm(out_dim)

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c)
        # timm order: [0::2, 0::2], [1::2, 0::2], [0::2, 1::2], [1::2, 1::2]
        x = torch.cat([x[:, :, 0, :, 0], x[:, :, 1, :, 0], x[:, :, 0, :, 1], x[:, :, 1, :, 1]],
                      dim=-1)
        return self.norm(_dense(x, self.reduction))


class SwinV2Stage(nn.Module):
    def __init__(self, in_dim: Optional[int], dim: int, depth: int, num_heads: int, window: int,
                 pretrained_window: int):
        super().__init__()
        self.downsample = nn.Identity() if in_dim is None else PatchMerging(in_dim, dim)
        self.blocks = nn.ModuleList(
            SwinV2Block(dim, num_heads, window, 0 if j % 2 == 0 else window // 2,
                        pretrained_window) for j in range(depth))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 4, stride=4)
        self.norm = LayerNorm(dim)


class SwinV2Backbone(nn.Module):
    """forward(x (B, H, W, 3)) -> {"features": (B, h, w, C) final-norm map,
    "pooled": (B, C) its mean over the map, "attentions": None or a list of
    (windows * B, heads, W², W²) f32 per block}."""

    def __init__(self, embed_dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 24,
                 pretrained_window: Sequence[int] = (12, 12, 12, 6)):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim)
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.layers = nn.ModuleList(
            SwinV2Stage(None if i == 0 else dims[i - 1], dims[i], depth, num_heads[i], window,
                        pretrained_window[i]) for i, depth in enumerate(depths))
        self.norm = LayerNorm(dims[-1])
        self.num_features = dims[-1]

    def forward(self, x, output_attentions: bool = False):
        x = self.patch_embed.norm(_conv_nhwc(x, self.patch_embed.proj))
        attentions = [] if output_attentions else None
        for stage in self.layers:
            x = stage.downsample(x)
            for block in stage.blocks:
                x, attn = block(x, output_attentions)
                if output_attentions:
                    attentions.append(attn)
        x = self.norm(x)
        return {"features": x, "pooled": x.mean(dim=(1, 2)), "attentions": attentions}


def init_weights_(module: nn.Module, generator: torch.Generator):
    """The JAX module's init, drawn from ``generator``: conv and linear
    weights N(0, 1 / fan_in), biases 0 (q_bias and v_bias too), LayerNorm
    1 / 0, logit_scale log 10. Deterministic for a seeded CPU generator,
    whatever device the module later moves to."""
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
            elif isinstance(m, WindowAttentionV2):
                m.q_bias.zero_()
                m.v_bias.zero_()
                m.logit_scale.fill_(math.log(10.0))
    return module


def swinv2_base_window12to24_192to384(
        generator: Optional[torch.Generator] = None) -> SwinV2Backbone:
    model = SwinV2Backbone(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32),
                           window=24, pretrained_window=(12, 12, 12, 6))
    return init_weights_(model, generator) if generator is not None else model
