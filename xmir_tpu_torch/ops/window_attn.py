"""The v1 fused SwinV2 window attention (K6): the CUDA kernel's wrapper, its
plain PyTorch version, and the gate both Swin attention kernels share.

Port of ``xmir_tpu/ops/window_attn_pallas.py``. ``window_attention_fused``
takes windows on the leading axis, q already cosine-normalised and scaled and
k normalised, and a combined bias (CPB + shift mask); it launches
``csrc/window_attn.cu`` (the source K4 shares, with the v1 arithmetic
switched on at compile time) for CUDA tensors and counts each call in its
``launches``. A tensor on the CPU takes ``window_attention_plain`` instead;
any other device raises. There is no fallback from the kernel to the plain
version, and no backward: inference only, as in the JAX package. The call is
the custom op ``xmir::window_attention`` (see ops/convnext_block.py for what
its parts are).

The v1 arithmetic differs from K4's in where it rounds: natural exp, and the
weights p = e / sum(e) are normalised BEFORE they are rounded to v's dtype
for the value product, whose f32 result is rounded once. (The kernel takes a
weight below 2^-126 as 0, which the plain version computes as a denormal:
the two differ by less than 1e-38 there.)
"""
from __future__ import annotations

import os

import torch

from .convnext_block import same_shapes
from .vit_attn import launch_window_attention


def window_attention_plain(q_scaled, k_norm, v, bias):
    """Plain version of K6 (``_kernel`` of the TPU file): q_scaled, k_norm, v
    (NW, B, H, N, D); bias (NWB, H, N, N) f32, NWB in {1, NW}. f32 scores
    plus bias, p = exp(s - max) / sum in f32, rounded to v's dtype for the
    value product, accumulated in f32, one rounding. Returns v's dtype."""
    s = torch.matmul(q_scaled.float(), k_norm.float().transpose(-1, -2))
    s = s + bias.float()[:, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(v.dtype)


@torch.library.custom_op("xmir::window_attention", mutates_args=(), device_types="cuda")
def window_attention_op(q_scaled: torch.Tensor, k_norm: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """K6 on CUDA tensors (``launch_window_attention``, mode 2), counted in
    ``window_attention_fused.launches``."""
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    nw, b, h, n, d = q_scaled.shape
    # row i = (window * B + image) * H + head uses slice window * H + head
    out = launch_window_attention(
        q_scaled.reshape(-1, n, d), k_norm.reshape(-1, n, d), v.reshape(-1, n, d), bias, None,
        2, (b * h, bias.shape[0], h, 1, h, 1))
    window_attention_fused.launches += 1
    return out.reshape(nw, b, h, n, d)


@window_attention_op.register_kernel("cpu")
def _window_attention_cpu(q_scaled, k_norm, v, bias):
    return window_attention_plain(q_scaled, k_norm, v, bias)


@window_attention_op.register_fake
def _window_attention_fake(q_scaled, k_norm, v, bias):
    torch._check(q_scaled.dim() == 5 and bias.dim() == 4)
    same_shapes(q_scaled, k_norm, v)
    _, _, h, n, _ = q_scaled.shape
    torch._check(bias.shape[1] == h and bias.shape[2] == n and bias.shape[3] == n)
    return torch.empty_like(v)


def window_attention_fused(q_scaled, k_norm, v, bias):
    """K6: softmax(q_scaled k_norm^T + bias) v per (window, head), fused.
    q_scaled, k_norm, v (NW, B, H, N, D) of one shape and dtype (float32 or
    bfloat16); bias (NWB, H, N, N) float32 with NWB == NW (per-window shift
    masks folded in) or 1 (no shift). Returns (NW, B, H, N, D) in v's dtype.
    On CUDA: contiguous, 16-byte aligned, D a multiple of 8 up to 64, one
    window's K and V within a block's shared memory."""
    if q_scaled.dim() != 5 or k_norm.shape != q_scaled.shape or v.shape != q_scaled.shape:
        raise ValueError(f"need q, k and v of one (NW, B, H, N, D) shape, got "
                         f"{tuple(q_scaled.shape)}, {tuple(k_norm.shape)} and {tuple(v.shape)}")
    if k_norm.dtype != q_scaled.dtype or v.dtype != q_scaled.dtype:
        raise TypeError(f"q, k and v must be of one dtype, got {q_scaled.dtype}, "
                        f"{k_norm.dtype} and {v.dtype}")
    nw, b, h, n, d = q_scaled.shape
    nwb = bias.shape[0]
    if nwb not in (1, nw) or bias.shape != (nwb, h, n, n):
        raise ValueError(f"need bias (1 or {nw}, {h}, {n}, {n}), got {tuple(bias.shape)}")
    if q_scaled.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q_scaled.device}")
    return window_attention_op(q_scaled, k_norm, v, bias)


window_attention_fused.launches = 0


def fused_attention_enabled(dtype, device) -> bool:
    """Whether window attention in compute dtype ``dtype`` on ``device`` takes
    a fused kernel: bf16 on CUDA (the JAX package: bf16 on the TPU; f32, the
    checkpoint-parity configuration, keeps the eager path). ``XMIR_FUSED_ATTN``
    = 0 or 1 overrides, as in the JAX package."""
    flag = os.environ.get("XMIR_FUSED_ATTN", "")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return dtype == torch.bfloat16 and torch.device(device).type == "cuda"
