"""Fused attention for the plain (non-windowed) ViT towers (port of
xmir_tpu/ops/plain_attn.py): the head-major entry to K2 and its gate."""
from __future__ import annotations

import os

import torch

from .vit_attn import vit_attention_fused


def flash_attention_plain(q, k, v, sm_scale: float):
    """softmax(q k^T sm_scale) v, fused (K2). q, k, v (B, H, N, hd),
    contiguous. Returns (B, H, N, hd) in v's dtype."""
    b, h, n, d = q.shape
    out = vit_attention_fused(q.reshape(b * h, n, d), k.reshape(b * h, n, d),
                              v.reshape(b * h, n, d), sm_scale)
    return out.reshape(b, h, n, d)


def plain_flash_enabled(dtype, n: int, device) -> bool:
    """Whether attention over ``n`` tokens in compute dtype ``dtype`` on
    ``device`` takes K2: bf16 on CUDA (the JAX package: bf16 on the TPU; f32
    keeps the eager path). ``XMIR_FLASH_ATTN`` = 0 or 1 overrides, as in the
    JAX package. The kernel streams its keys, so unlike the TPU kernel's no
    ``n`` is too long for it; the argument stays for the callers' sake."""
    flag = os.environ.get("XMIR_FLASH_ATTN", "")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return dtype == torch.bfloat16 and torch.device(device).type == "cuda"
