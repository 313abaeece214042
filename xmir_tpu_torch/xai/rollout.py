"""Attention rollout saliency (Abnar & Zuidema) with head fusion,
row sparsification and optional query-guided reweighting (port of
xmir_tpu/xai/rollout.py; reference explanations.py:979-1147,
AttentionRolloutMedSigLIP).

The models return their attention weights (``output_attentions=True``, the
eager attention path), so no attention surgery is needed.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops.distance import l2_normalize
from .resize import resize_bilinear


def _fuse_heads(attn, mode: str):
    if mode == "mean":
        return attn.mean(dim=1)
    if mode == "max":
        return attn.amax(dim=1)
    if mode == "min":
        return attn.amin(dim=1)
    raise ValueError(f"Unknown head_fusion mode: {mode!r}")


def attention_rollout(attentions: Sequence[torch.Tensor], head_fusion: str = "mean",
                      discard_ratio: float = 0.9):
    """attentions: per layer (B, heads, N, N) -> the cumulative rollout
    (B, N, N) float32. Per layer: fuse the heads, zero each row's entries up
    to and including its k-th smallest (k = max(1, int(N discard_ratio)),
    torch.kthvalue's threshold), add the identity residual, normalise the
    rows, chain-multiply."""
    b, _, n, _ = attentions[0].shape
    eye = torch.eye(n, device=attentions[0].device)
    result = eye.expand(b, n, n)
    for attn in attentions:
        a = _fuse_heads(attn.float(), head_fusion)
        if discard_ratio > 0.0:
            k = max(1, int(n * discard_ratio))
            thresh = torch.sort(a, dim=-1).values[..., k - 1]
            a = a * (a > thresh[..., None])
        a = a + eye
        a = a / (a.sum(dim=-1, keepdim=True) + 1e-8)
        result = torch.matmul(a, result)
    return result


def rollout_saliency(attentions: Sequence[torch.Tensor], out_hw, head_fusion: str = "mean",
                     discard_ratio: float = 0.9, query_embedding=None, patch_embeddings=None,
                     prefix_tokens: int = 0):
    """Spatial saliency from the rollout: each token's mean-pooled importance
    (B, N), optionally times the clipped cosine of ``query_embedding`` (D,)
    with ``patch_embeddings`` (B, N, D) (already in the query's space).
    ``prefix_tokens`` leading tokens (a CLS token, registers) are dropped from
    the importance before it is laid out on the patch grid; with 0, as the JAX
    function has it, a model with a CLS token (DINOv2: 1 + 37^2 tokens) has no
    square grid and raises. Returns (B, H, W) float32."""
    importance = attention_rollout(attentions, head_fusion, discard_ratio).mean(dim=1)
    importance = importance[:, prefix_tokens:]
    if query_embedding is not None and patch_embeddings is not None:
        patches = l2_normalize(patch_embeddings.float(), dim=-1)
        q = l2_normalize(query_embedding.float().reshape(1, 1, -1), dim=-1)
        importance = importance * (patches * q).sum(dim=-1).clamp_min(0.0)
    n_patches = importance.shape[1]
    side = int(round(n_patches ** 0.5))
    if side * side != n_patches:
        raise ValueError(f"Number of patches ({n_patches}) is not a perfect square.")
    return resize_bilinear(importance.reshape(-1, side, side), out_hw)
