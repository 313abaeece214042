"""BERT-style text encoder in PyTorch (port of xmir_tpu/models/bert.py): the
PubMedBERT text tower of ConceptCLIP and BiomedCLIP.

HF ``BertModel`` graph and names (``embeddings.{word,position,token_type}_
embeddings``, ``embeddings.LayerNorm``, ``encoder.layer.{i}.attention.self.
{query,key,value}``, ``attention.output.{dense,LayerNorm}``,
``intermediate.dense``, ``output.{dense,LayerNorm}``), so an HF state dict
without its pooler loads strictly. Post-norm layers, LayerNorm eps 1e-12 with
flax's fast variance, the exact (erf) GELU, position ids 0..n-1 and token
types 0 unless given. Attention scores are f32; where ``attention_mask`` is 0
the key gets -1e9 (not -inf, so a fully padded row stays finite, as in the
JAX module). The JAX package computes this attention in einsums outside any
Pallas kernel, so the tower is plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .convnext import LayerNorm
from .vit import _dense, holder

BERT_LN_EPS = 1e-12


class BertSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)

    def forward(self, x, mask=None):
        """x (B, N, C), mask (B, N) bool or None -> (B, N, C)."""
        b, n, c = x.shape
        hd = c // self.num_heads

        def split(t):
            return t.reshape(b, n, self.num_heads, hd).transpose(1, 2)

        q, k, v = split(_dense(x, self.query)), split(_dense(x, self.key)), split(
            _dense(x, self.value))
        a = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        if mask is not None:
            a = a + torch.where(mask[:, None, None, :], 0.0, -1e9)
        a = torch.softmax(a, dim=-1)
        o = torch.matmul(a.to(v.dtype), v)
        return o.transpose(1, 2).reshape(b, n, c)


class BertLayer(nn.Module):
    def __init__(self, dim: int, num_heads: int, intermediate: int):
        super().__init__()
        self.attention = holder(self=BertSelfAttention(dim, num_heads),
                                output=holder(dense=nn.Linear(dim, dim),
                                              LayerNorm=LayerNorm(dim, BERT_LN_EPS)))
        self.intermediate = holder(dense=nn.Linear(dim, intermediate))
        self.output = holder(dense=nn.Linear(intermediate, dim),
                             LayerNorm=LayerNorm(dim, BERT_LN_EPS))

    def forward(self, x, mask=None):
        h = _dense(self.attention.self(x, mask), self.attention.output.dense)
        x = self.attention.output.LayerNorm(x + h)
        h = F.gelu(_dense(x, self.intermediate.dense))
        h = _dense(h, self.output.dense)
        return self.output.LayerNorm(x + h)


class BertTextBackbone(nn.Module):
    """forward(input_ids (B, N), attention_mask (B, N) or None,
    token_type_ids or None) -> {"tokens": (B, N, D), "cls": (B, D), token 0}."""

    def __init__(self, vocab_size: int = 30522, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, intermediate: int = 3072, max_position: int = 512,
                 type_vocab_size: int = 2):
        super().__init__()
        self.embeddings = holder(word_embeddings=nn.Embedding(vocab_size, dim),
                                 position_embeddings=nn.Embedding(max_position, dim),
                                 token_type_embeddings=nn.Embedding(type_vocab_size, dim),
                                 LayerNorm=LayerNorm(dim, BERT_LN_EPS))
        self.encoder = holder(layer=nn.ModuleList(BertLayer(dim, num_heads, intermediate)
                                                  for _ in range(depth)))

    def forward(self, input_ids, attention_mask=None,
                token_type_ids: Optional[torch.Tensor] = None):
        emb = self.embeddings
        n = input_ids.shape[1]
        pos_ids = torch.arange(n, device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (emb.word_embeddings(input_ids) + emb.position_embeddings(pos_ids)
             + emb.token_type_embeddings(token_type_ids))
        x = emb.LayerNorm(x)
        mask = attention_mask.bool() if attention_mask is not None else None
        for layer in self.encoder.layer:
            x = layer(x, mask)
        return {"tokens": x, "cls": x[:, 0]}


def pubmedbert_base() -> BertTextBackbone:
    return BertTextBackbone(vocab_size=30522, dim=768, depth=12, num_heads=12)
