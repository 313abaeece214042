"""BERT WordPiece tokenizer over a real vocab file (a copy of
xmir_tpu/data/wordpiece.py: pure Python and numpy, which the port may not
import from the JAX package).

A dependency-free BERT tokenization (basic tokenizer + greedy
longest-match WordPiece) whose token ids equal
``transformers.BertTokenizer``'s over the same vocab file. It replaces the
hash tokenizer whenever a vocab file is supplied (CLI ``--vocab``): the
PubMedBERT text towers of BiomedCLIP and ConceptCLIP and the MedSigLIP
zero-shot prompts.
"""
from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_vocab(path: str) -> Dict[str, int]:
    """One token per line, id = line number (BERT vocab.txt format)."""
    vocab: Dict[str, int] = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            token = line.rstrip("\n")
            if token:
                vocab[token] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric printable chars count as punctuation (BERT
    # treats ^ $ ` etc. as punctuation even though unicode does not)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        (0x4E00 <= cp <= 0x9FFF)
        or (0x3400 <= cp <= 0x4DBF)
        or (0x20000 <= cp <= 0x2A6DF)
        or (0x2A700 <= cp <= 0x2B73F)
        or (0x2B740 <= cp <= 0x2B81F)
        or (0x2B820 <= cp <= 0x2CEAF)
        or (0xF900 <= cp <= 0xFAFF)
        or (0x2F800 <= cp <= 0x2FA1F)
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with optional lowercasing and
    accent stripping — BERT's pre-tokenizer."""

    def __init__(self, do_lower_case: bool = True,
                 never_split: Optional[Sequence[str]] = None):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split or ())

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        out: List[str] = []
        for token in text.split():
            if token in self.never_split:
                out.append(token)
                continue
            if self.do_lower_case:
                token = self._strip_accents(token.lower())
            out.extend(self._split_punc(token))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            chars.append(" " if _is_whitespace(ch) else ch)
        return "".join(chars)

    @staticmethod
    def _space_cjk(text: str) -> str:
        chars = []
        for ch in text:
            if _is_cjk(ord(ch)):
                chars.extend((" ", ch, " "))
            else:
                chars.append(ch)
        return "".join(chars)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    def _split_punc(self, token: str) -> List[str]:
        if token in self.never_split:
            return [token]
        pieces: List[List[str]] = []
        start_new = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                start_new = True
            else:
                if start_new:
                    pieces.append([])
                start_new = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]


class WordPiece:
    """Greedy longest-match-first subword split (BERT WordPiece)."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        tokens: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = piece
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            tokens.append(cur)
            start = end
        return tokens


class BertWordPieceTokenizer:
    """Full BERT tokenization pipeline producing the same (input_ids,
    attention_mask) interface as HashWordTokenizer, so it drops into the
    ConceptCLIP/MedSigLIP text paths unchanged."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 max_len: int = 64, cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 unk_token: str = "[UNK]", mask_token: str = "[MASK]"):
        self.vocab = load_vocab(vocab_file)
        self.max_len = max_len
        self.cls_token, self.sep_token = cls_token, sep_token
        self.pad_token, self.unk_token = pad_token, unk_token
        specials = (unk_token, sep_token, pad_token, cls_token, mask_token)
        self.basic = BasicTokenizer(do_lower_case, never_split=specials)
        self.wordpiece = WordPiece(self.vocab, unk_token)
        self.pad_id = self.vocab.get(pad_token, 0)
        self.cls_id = self.vocab[cls_token]
        self.sep_id = self.vocab[sep_token]
        self.vocab_size = max(self.vocab.values()) + 1

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for token in self.basic.tokenize(text):
            if token in self.basic.never_split:
                out.append(token)
            else:
                out.extend(self.wordpiece.tokenize(token))
        return out

    def encode(self, text: str) -> List[int]:
        """[CLS] tokens [SEP], truncated to max_len (keeping [SEP])."""
        ids = [self.vocab.get(t, self.vocab[self.unk_token])
               for t in self.tokenize(text)]
        ids = ids[: self.max_len - 2]
        return [self.cls_id] + ids + [self.sep_id]

    def _pad(self, encoded: List[List[int]], length: int) -> Tuple[np.ndarray, np.ndarray]:
        ids = np.full((len(encoded), length), self.pad_id, np.int32)
        mask = np.zeros((len(encoded), length), np.int32)
        for i, e in enumerate(encoded):
            e = e[:length]
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask

    def __call__(self, texts: Sequence[str]) -> Tuple[np.ndarray, np.ndarray]:
        encoded = [self.encode(t) for t in texts]
        length = min(self.max_len, max((len(e) for e in encoded), default=2))
        return self._pad(encoded, length)

    def encode_padded(self, texts: Sequence[str], length: int):
        """Fixed-length variant for jit-stable shapes."""
        return self._pad([self.encode(t) for t in texts], length)


def build_text_tokenizer(vocab_file: Optional[str] = None,
                         vocab_size: int = 30000, max_len: int = 64,
                         token_table: Optional[dict] = None):
    """WordPiece over a real vocab when one is supplied, otherwise the
    deterministic hash tokenizer (no-network fallback)."""
    if vocab_file:
        return BertWordPieceTokenizer(vocab_file, max_len=max_len)
    from .tokenizer import HashWordTokenizer

    return HashWordTokenizer(vocab_size, max_len, token_table)
