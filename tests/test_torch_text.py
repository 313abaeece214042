"""The port's text side (data/wordpiece.py, data/tokenizer.py, models/bert.py
and its converters) against the JAX package on the same inputs and weights.
Tier 1: CPU only.

Tokenizers: the same ids and masks, exactly. BertTextBackbone: narrow (vocab
100, dim 32, depth 2, 4 heads), f32, within 1e-5 (1 + |jax|) (the two stacks
sum in other orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu.data import tokenizer as jax_tokenizer
from xmir_tpu.data import wordpiece as jax_wordpiece
from xmir_tpu.models import bert as jax_bert
from xmir_tpu.models import convert as jax_convert
from xmir_tpu_torch.data import tokenizer, wordpiece
from xmir_tpu_torch.models import bert, convert

TOL = 1e-5

VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "the", "chest", "x", "-", "ray", "shows", "bilateral", "opacities", "consistent", "with",
    "pneumonia", ",", ".", "no", "pleural", "effusion", "cardi", "##ome", "##gal", "##y",
    "atel", "##ect", "##asis", "un", "##remark", "##able", "findings", "lung", "##s", "are",
    "clear", "in", "right", "lower", "lobe", "of", "a", "and", "resume", "words", "accented",
    "2", "##0", "%", "(", ")", "患", "者", "medical", "image", "this", "is", "covid",
]

TEXTS = [
    "The chest X-ray shows bilateral opacities consistent with pneumonia.",
    "No pleural effusion. Cardiomegaly and atelectasis.",
    "Unremarkable findings, lungs are clear.",
    "Accénted wörds résumé",                 # accents stripped
    "患者 chest x-ray",                       # CJK split
    "supercalifragilisticexpialidocious",   # unknown -> [UNK]
    "(20%) [MASK] [CLS] shows",            # punctuation, specials never split
    "  Weird   spacing\tand\ncontrol\x00chars.",
    " ".join(["chest"] * 80),               # longer than max_len: truncated
    "",
]


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref) - tol * (1 + np.abs(ref))
    assert err.max() <= 0, f"max excess {err.max()}"


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    return str(path)


@pytest.mark.parametrize("max_len", [8, 16, 64])
def test_wordpiece_matches_jax(vocab_file, max_len):
    port = wordpiece.BertWordPieceTokenizer(vocab_file, max_len=max_len)
    ref = jax_wordpiece.BertWordPieceTokenizer(vocab_file, max_len=max_len)
    for text in TEXTS:
        assert port.tokenize(text) == ref.tokenize(text)
        assert port.encode(text) == ref.encode(text)
    for got, want in ((port(TEXTS), ref(TEXTS)),
                      (port.encode_padded(TEXTS, max_len), ref.encode_padded(TEXTS, max_len))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert port.vocab_size == ref.vocab_size and port.pad_id == ref.pad_id
    ids, mask = port.encode_padded(TEXTS, max_len)
    assert ids.shape == (len(TEXTS), max_len) and (mask.sum(1) <= max_len).all()
    assert port.tokenize(TEXTS[5]) == ["[UNK]"] and "患" in port.tokenize(TEXTS[4])


@pytest.mark.parametrize("table", [None, {"chest": 7, "lung": 9}])
def test_hash_tokenizer_matches_jax(table):
    port = tokenizer.HashWordTokenizer(500, 12, table)
    ref = jax_tokenizer.HashWordTokenizer(500, 12, table)
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text)
    for got, want in ((port(TEXTS), ref(TEXTS)),
                      (port.encode_padded(TEXTS, 20), ref.encode_padded(TEXTS, 20))):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("with_vocab", [True, False])
def test_build_text_tokenizer_matches_jax(vocab_file, with_vocab):
    path = vocab_file if with_vocab else None
    port = wordpiece.build_text_tokenizer(path, vocab_size=300, max_len=24)
    ref = jax_wordpiece.build_text_tokenizer(path, vocab_size=300, max_len=24)
    assert type(port).__name__ == type(ref).__name__ == (
        "BertWordPieceTokenizer" if with_vocab else "HashWordTokenizer")
    for g, w in zip(port.encode_padded(TEXTS, 24), ref.encode_padded(TEXTS, 24)):
        np.testing.assert_array_equal(g, w)


BERT = dict(vocab_size=100, dim=32, depth=2, num_heads=4, intermediate=64, max_position=40)


def _randomized(variables, seed):
    """Every leaf redrawn so that LayerNorm scales and biases take part."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(variables)
    out = []
    for leaf in leaves:
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        out.append(1.0 + 0.2 * a if leaf.ndim == 1 else 0.3 * a)
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in out])


def _bert_pair(seed):
    model = jax_bert.BertTextBackbone(**BERT)
    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32)),
                            seed)
    port = bert.BertTextBackbone(**BERT)
    port.load_state_dict(convert.bert_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return model, variables, port.eval()


def _ids_and_mask(seed, b=4, n=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BERT["vocab_size"], (b, n)).astype(np.int32)
    lengths = [n, 7, 1, 0]  # full, padded, one token, fully padded
    mask = (np.arange(n)[None, :] < np.asarray(lengths)[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("masked", [True, False])
def test_bert_backbone_matches_jax(masked):
    """tokens and cls, with padded rows (a fully padded row stays finite: -1e9,
    not -inf, on f32 scores) and without a mask."""
    model, variables, port = _bert_pair(seed=1)
    ids, mask = _ids_and_mask(seed=2)
    jmask = jnp.asarray(mask) if masked else None
    ref = model.apply(variables, jnp.asarray(ids), jmask)
    with torch.inference_mode():
        out = port(torch.from_numpy(ids).long(), torch.from_numpy(mask) if masked else None)
    assert out["tokens"].shape == (4, 12, 32) and torch.isfinite(out["tokens"]).all()
    close(out["tokens"].numpy(), ref["tokens"])
    close(out["cls"].numpy(), ref["cls"])


def test_bert_token_types_match_jax():
    model, variables, port = _bert_pair(seed=3)
    ids, mask = _ids_and_mask(seed=4)
    types = (np.arange(12)[None, :] >= 6).astype(np.int32).repeat(4, 0)
    ref = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(types))
    with torch.inference_mode():
        out = port(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                   torch.from_numpy(types).long())
    close(out["tokens"].numpy(), ref["tokens"])


def _hf_bert_state_dict(seed, depth=2):
    """An HF BertModel state dict of random numpy tensors (no pooler)."""
    rng = np.random.default_rng(seed)
    d, m = BERT["dim"], BERT["intermediate"]

    def r(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    sd = {"embeddings.word_embeddings.weight": r(BERT["vocab_size"], d),
          "embeddings.position_embeddings.weight": r(BERT["max_position"], d),
          "embeddings.token_type_embeddings.weight": r(2, d),
          "embeddings.LayerNorm.weight": 1 + r(d), "embeddings.LayerNorm.bias": r(d)}
    for i in range(depth):
        pre = f"encoder.layer.{i}"
        for name in ("query", "key", "value"):
            sd[f"{pre}.attention.self.{name}.weight"] = r(d, d)
            sd[f"{pre}.attention.self.{name}.bias"] = r(d)
        sd.update({f"{pre}.attention.output.dense.weight": r(d, d),
                   f"{pre}.attention.output.dense.bias": r(d),
                   f"{pre}.attention.output.LayerNorm.weight": 1 + r(d),
                   f"{pre}.attention.output.LayerNorm.bias": r(d),
                   f"{pre}.intermediate.dense.weight": r(m, d),
                   f"{pre}.intermediate.dense.bias": r(m),
                   f"{pre}.output.dense.weight": r(d, m), f"{pre}.output.dense.bias": r(d),
                   f"{pre}.output.LayerNorm.weight": 1 + r(d),
                   f"{pre}.output.LayerNorm.bias": r(d)})
    return sd


def test_hf_bert_layout_loads_strictly_and_matches_jax():
    """An HF BertModel state dict through the JAX converter (convert_bert)
    and, unchanged, into the port by a strict load: the same outputs."""
    sd = _hf_bert_state_dict(seed=5)
    model = jax_bert.BertTextBackbone(**BERT)
    variables = jax_convert.convert_bert(sd, depth=2)
    port = bert.BertTextBackbone(**BERT)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    ids, mask = _ids_and_mask(seed=6)
    ref = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        out = port.eval()(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    close(out["tokens"].numpy(), ref["tokens"])
