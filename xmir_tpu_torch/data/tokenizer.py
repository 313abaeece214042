"""Deterministic word-hash tokenizer (a copy of xmir_tpu/data/tokenizer.py:
pure Python, numpy and hashlib).

The reference tokenizes text through HF AutoProcessor downloads; without a
vocab file the text paths use a stable hash tokenizer: same word -> same id,
always. Matching texts give matching token sequences, and a real vocabulary
swaps in through ``token_table`` or ``wordpiece.build_text_tokenizer``.
"""
from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+")


class HashWordTokenizer:
    """ids = 2 + (blake2 of word) % (vocab - 2); 0 = PAD, 1 = CLS."""

    PAD = 0
    CLS = 1

    def __init__(self, vocab_size: int = 30000, max_len: int = 64,
                 token_table: Optional[Dict[str, int]] = None):
        self.vocab_size = vocab_size
        self.max_len = max_len
        self.token_table = token_table or {}

    def _word_id(self, word: str) -> int:
        if word in self.token_table:
            return self.token_table[word]
        h = int.from_bytes(hashlib.blake2b(word.encode(), digest_size=4).digest(), "big")
        return 2 + h % (self.vocab_size - 2)

    def encode(self, text: str) -> List[int]:
        words = _WORD_RE.findall(text.lower())
        ids = [self.CLS] + [self._word_id(w) for w in words]
        return ids[: self.max_len]

    def __call__(self, texts: Sequence[str]):
        """Returns (input_ids (B, L) int32, attention_mask (B, L) int32)."""
        encoded = [self.encode(t) for t in texts]
        max_len = min(self.max_len, max((len(e) for e in encoded), default=1))
        ids = np.zeros((len(texts), max_len), np.int32)
        mask = np.zeros((len(texts), max_len), np.int32)
        for i, e in enumerate(encoded):
            e = e[:max_len]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask

    def encode_padded(self, texts: Sequence[str], length: int):
        """Fixed-length variant for jit-stable shapes."""
        ids = np.zeros((len(texts), length), np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for i, t in enumerate(texts):
            e = self.encode(t)[:length]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask
