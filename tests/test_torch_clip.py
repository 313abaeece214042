"""The port's CLIP-family serving path (ConceptCLIPModel, BiomedCLIPModel,
their converters and layouts, analysis/zeroshot.py, cli.test's zero-shot
branch, cli.zeroshot, and ingest -> query with --model medsiglip | conceptclip
| biomedclip) against the JAX package on the same numpy inputs and weights.
Tier 1: CPU only; narrow towers, full width runs on the card (chip_smoke.py).

Tolerances: f32, within 1e-5 (1 + |jax|) (the stacks sum in other orders);
zero-shot metrics (percent) within 1e-4, predictions equal."""
import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu.analysis import zeroshot as jax_zeroshot
from xmir_tpu.cli import test as jax_test_cli
from xmir_tpu.models import biomedclip as jax_biomedclip
from xmir_tpu.models import embedders as jax_embedders
from xmir_tpu.models import registry as jax_registry
from xmir_tpu_torch.analysis import zeroshot
from xmir_tpu_torch.cli import common, ingest, query
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.cli import zeroshot as zeroshot_cli
from xmir_tpu_torch.data import synthetic
from xmir_tpu_torch.models import convert, registry
from xmir_tpu_torch.models.biomedclip import BiomedCLIPModel
from xmir_tpu_torch.models.embedders import ConceptCLIPModel
from xmir_tpu_torch.models.siglip_text import MedSigLIPDualEncoder

TOL = 1e-5
FLAGS = ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_QKV72",
         "XMIR_FUSED_LN_MLP")


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) - tol * (1 + np.abs(ref))
    assert err.max() <= 0, f"max excess {err.max()}"


def _randomized(variables, seed):
    """Every leaf redrawn: matrices 0.1 N(0, 1), vectors (LN scales, biases)
    0.5 + 0.3 N(0, 1), scalars (logit scale and bias) 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(variables)
    out = []
    for leaf in leaves:
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        out.append(0.5 + 0.3 * a if leaf.ndim == 1 else 0.1 * a)
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in out])


def _np(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _images(b, size, seed):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _ids_and_mask(seed, vocab, b=3, n=10):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(np.int32)
    mask = (np.arange(n)[None, :] < np.asarray([n, 6, 2])[:b, None]).astype(np.int32)
    return ids, mask


@pytest.fixture
def clean_flags(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


CONCEPT = dict(img_size=56, dim=288, depth=2, text_depth=2, text_vocab=100)


@pytest.mark.parametrize("embedding_dim", [None, 24])
def test_conceptclip_matches_jax(clean_flags, embedding_dim):
    """encode_image, encode_text, forward_clip and the embedder call, with and
    without the fc (dim 288: 16 heads of 18, a 288-wide BERT of 12 heads)."""
    model = jax_embedders.ConceptCLIPModel(embedding_dim=embedding_dim, **CONCEPT)
    x = _images(2, 56, seed=1)
    ids, mask = _ids_and_mask(2, 100)

    def touch(m, x, ids):
        return m(x), m.forward_clip(x, ids)

    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ids),
                                       method=touch), seed=3)
    port = ConceptCLIPModel(embedding_dim, **CONCEPT)
    port.load_state_dict(convert.conceptclip_state_dict_from_jax(_np(variables)), strict=True)
    port.eval()
    ref = model.apply(variables, jnp.asarray(x))
    ref_clip = model.apply(variables, jnp.asarray(x), jnp.asarray(ids), jnp.asarray(mask),
                           method=jax_embedders.ConceptCLIPModel.forward_clip)
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
        clip = port.forward_clip(torch.from_numpy(x), torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask))
        txt = port.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        img, tokens = port.encode_image(torch.from_numpy(x))
    assert out["embedding"].shape == (2, embedding_dim or 288)
    close(out["embedding"].numpy(), ref["embedding"])
    close(out["tokens"].numpy(), ref["tokens"])
    for key in ("image_features", "text_features", "image_token_features", "logit_scale",
                "logit_bias"):
        close(clip[key].detach().numpy(), ref_clip[key])
    assert torch.equal(txt, clip["text_features"]) and torch.equal(img, clip["image_features"])
    assert torch.equal(tokens, out["tokens"])


BIOMED = dict(img_size=64, vision_dim=64, vision_depth=2, text_dim=64, text_depth=2,
              text_vocab=120)


def _biomedclip_pair(seed):
    model = jax_biomedclip.BiomedCLIPModel(**BIOMED)
    variables = _randomized(model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 8), jnp.int32),
        method=jax_biomedclip.BiomedCLIPModel.init_towers), seed)
    port = BiomedCLIPModel(**BIOMED)
    port.load_state_dict(convert.biomedclip_state_dict_from_jax(_np(variables)), strict=True)
    return model, variables, port.eval()


def test_biomedclip_matches_jax(clean_flags):
    model, variables, port = _biomedclip_pair(seed=4)
    x = _images(3, 64, seed=5)
    ids, mask = _ids_and_mask(6, 120)
    ref = model.apply(variables, jnp.asarray(x))
    ref_img = model.apply(variables, jnp.asarray(x),
                          method=jax_biomedclip.BiomedCLIPModel.encode_image)
    ref_txt = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                          method=jax_biomedclip.BiomedCLIPModel.encode_text)
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
        img = port.encode_image(torch.from_numpy(x))
        txt = port.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    assert out["embedding"].shape == (3, 512) and txt.shape == (3, 512)
    close(out["embedding"].numpy(), ref["embedding"])
    close(img.numpy(), ref_img)
    close(txt.numpy(), ref_txt)


def _open_clip_state_dict(seed):
    """An open_clip BiomedCLIP state dict of random numpy tensors (timm ViT
    trunk without LayerScale, HF BERT with the position_ids buffer older
    transformers save, the MLP projection)."""
    rng = np.random.default_rng(seed)
    d, e, depth = 64, 512, 2
    hidden = (d + e) // 2

    def r(*shape, base=0.0, sc=0.1):
        return (base + sc * rng.standard_normal(shape)).astype(np.float32)

    sd = {"visual.trunk.cls_token": r(1, 1, d), "visual.trunk.pos_embed": r(1, 17, d),
          "visual.trunk.patch_embed.proj.weight": r(d, 3, 16, 16),
          "visual.trunk.patch_embed.proj.bias": r(d),
          "visual.trunk.norm.weight": r(d, base=1.0), "visual.trunk.norm.bias": r(d),
          "visual.head.proj.weight": r(e, d),
          "text.transformer.embeddings.word_embeddings.weight": r(120, d),
          "text.transformer.embeddings.position_embeddings.weight": r(512, d),
          "text.transformer.embeddings.token_type_embeddings.weight": r(2, d),
          "text.transformer.embeddings.LayerNorm.weight": r(d, base=1.0),
          "text.transformer.embeddings.LayerNorm.bias": r(d),
          "text.transformer.embeddings.position_ids": np.arange(512)[None],
          "text.proj.0.weight": r(hidden, d), "text.proj.0.bias": r(hidden),
          "text.proj.2.weight": r(e, hidden), "text.proj.2.bias": r(e),
          "logit_scale": np.asarray(np.log(1 / 0.07), np.float32)}
    for i in range(depth):
        pre = f"visual.trunk.blocks.{i}"
        sd.update({f"{pre}.norm1.weight": r(d, base=1.0), f"{pre}.norm1.bias": r(d),
                   f"{pre}.attn.qkv.weight": r(3 * d, d), f"{pre}.attn.qkv.bias": r(3 * d),
                   f"{pre}.attn.proj.weight": r(d, d), f"{pre}.attn.proj.bias": r(d),
                   f"{pre}.norm2.weight": r(d, base=1.0), f"{pre}.norm2.bias": r(d),
                   f"{pre}.mlp.fc1.weight": r(4 * d, d), f"{pre}.mlp.fc1.bias": r(4 * d),
                   f"{pre}.mlp.fc2.weight": r(d, 4 * d), f"{pre}.mlp.fc2.bias": r(d)})
        pre = f"text.transformer.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            sd[f"{pre}.attention.self.{name}.weight"] = r(d, d)
            sd[f"{pre}.attention.self.{name}.bias"] = r(d)
        sd.update({f"{pre}.attention.output.dense.weight": r(d, d),
                   f"{pre}.attention.output.dense.bias": r(d),
                   f"{pre}.attention.output.LayerNorm.weight": r(d, base=1.0),
                   f"{pre}.attention.output.LayerNorm.bias": r(d),
                   f"{pre}.intermediate.dense.weight": r(4 * d, d),
                   f"{pre}.intermediate.dense.bias": r(4 * d),
                   f"{pre}.output.dense.weight": r(d, 4 * d), f"{pre}.output.dense.bias": r(d),
                   f"{pre}.output.LayerNorm.weight": r(d, base=1.0),
                   f"{pre}.output.LayerNorm.bias": r(d)})
    return sd


def test_open_clip_layout_loads_strictly_and_matches_jax(clean_flags, tmp_path):
    """An open_clip BiomedCLIP state dict through the JAX converter
    (convert_biomedclip) and, unchanged, into the port by --resume's strict
    loader: the same image and text features."""
    sd = _open_clip_state_dict(seed=7)
    model = jax_biomedclip.BiomedCLIPModel(**BIOMED)
    variables = jax_biomedclip.convert_biomedclip(sd)
    pt = str(tmp_path / "open_clip.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, pt)
    port = convert.load_torch_checkpoint(BiomedCLIPModel(**BIOMED), pt).eval()
    x = _images(2, 64, seed=8)
    ids, mask = _ids_and_mask(9, 120)
    ref_img = model.apply(variables, jnp.asarray(x),
                          method=jax_biomedclip.BiomedCLIPModel.encode_image)
    ref_txt = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                          method=jax_biomedclip.BiomedCLIPModel.encode_text)
    with torch.inference_mode():
        close(port.encode_image(torch.from_numpy(x)).numpy(), ref_img)
        close(port.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy(),
              ref_txt)


def test_conceptclip_checkpoints(tmp_path):
    """A ConceptCLIP .pt loads only whole, from the train CLI (no converter is
    wired, as in the JAX package)."""
    gen = torch.Generator().manual_seed(0)
    src = ConceptCLIPModel(16, **CONCEPT, generator=gen)
    dst = ConceptCLIPModel(16, **CONCEPT, generator=torch.Generator().manual_seed(1))
    bare, train = str(tmp_path / "bare.pt"), str(tmp_path / "train.pt")
    torch.save(src.state_dict(), bare)
    torch.save({"state_dict": src.state_dict(), "optimizer": {}}, train)
    with pytest.raises(ValueError, match="ConceptCLIP"):
        convert.load_torch_checkpoint(dst, bare)
    convert.load_torch_checkpoint(dst, train)
    assert all(torch.equal(v, dst.state_dict()[k]) for k, v in src.state_dict().items())


def test_zeroshot_analysis_matches_jax():
    rng = np.random.default_rng(10)
    img = rng.standard_normal((20, 16)).astype(np.float32)
    txt = rng.standard_normal((4, 16)).astype(np.float32)
    labels = rng.integers(0, 4, 20)
    for scale, bias in ((1.0, 0.0), (np.log(10.0), -2.5)):
        preds, probs = zeroshot.zero_shot_classify(torch.from_numpy(img), txt, scale, bias)
        rp, rprobs = jax_zeroshot.zero_shot_classify(img, txt, scale, bias)
        np.testing.assert_array_equal(preds, rp)
        close(probs, rprobs)
        close(zeroshot.concept_profile_embeddings(img, txt, scale, bias, device="cpu"),
              jax_zeroshot.concept_profile_embeddings(img, txt, scale, bias))
    its = rng.standard_normal((20, 4))
    np.testing.assert_array_equal(zeroshot.text_rerank_scores(img, labels, its, 5, 0.6),
                                  jax_zeroshot.text_rerank_scores(img, labels, its, 5, 0.6))
    names = ["normal", "pneumonia"]
    assert zeroshot.build_class_prompts(names) == jax_zeroshot.build_class_prompts(names)
    assert zeroshot.build_class_prompts(names, "x {}") == ["x normal", "x pneumonia"]
    with pytest.raises(ValueError, match="need a device"):
        zeroshot.zero_shot_classify(img, txt)


PROMPT_WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "this", "is", "a", "medical",
                "image", "of", "class", "0", "1", "2", "chest", "x", "-", "ray", "showing",
                "no", "evidence", "pneumonia", "or", "covid", "19", "infection", ".",
                "findings", "consistent", "with"]


@pytest.fixture
def vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(PROMPT_WORDS) + "\n")
    return str(path)


def test_evaluate_clip_zeroshot_matches_jax(clean_flags, tmp_path, vocab_file):
    """The port's and the JAX package's evaluate_clip_zeroshot on the same
    narrow BiomedCLIP weights, synthetic dataset and args: metrics within
    1e-4, the artifacts' keys and predictions equal."""
    model, variables, port = _biomedclip_pair(seed=11)
    args = argparse.Namespace(dataset="synthetic", dataset_dir="", class_names="",
                              vocab=vocab_file,
                              prompt_template="this is a medical image of {label}",
                              eval_batch_size=16, workers=2, save_dir="")
    dataset = common.build_dataset(args, "test")
    spec = dataclasses.replace(registry.get_spec("biomedclip"), input_size=64, resize_size=64)
    jspec = dataclasses.replace(jax_registry.get_spec("biomedclip"), input_size=64,
                                resize_size=64)
    args.save_dir = str(tmp_path / "port")
    got = test_cli.evaluate_clip_zeroshot(port, dataset, spec, args, "cpu")
    args.save_dir = str(tmp_path / "jax")
    want = jax_test_cli.evaluate_clip_zeroshot(model, dict(variables), dataset, jspec, args)
    flat = {k: v for k, v in want.items() if k != "classification"}
    for key, v in flat.items():
        assert abs(got[key] - v) <= 1e-4, (key, got[key], v)
    for k in (1, 5):
        for m, v in want["classification"][k].items():
            assert abs(got["classification"][k][m] - v) <= 1e-4, (k, m)
    a = np.load(str(tmp_path / "port" / "biomedclip_zeroshot.npz"))
    b = np.load(str(tmp_path / "jax" / "biomedclip_zeroshot.npz"))
    assert a.files == b.files
    for key in ("labels", "predictions", "class_names", "text_prompts"):
        np.testing.assert_array_equal(a[key], b[key])
    close(a["embeds"], b["embeds"])


def test_cli_test_biomedclip_with_open_clip_resume(clean_flags, tmp_path, vocab_file):
    """python -m xmir_tpu_torch.cli.test --model biomedclip at narrow
    --clip-* widths with an open_clip --resume: the artifact's predictions
    are argmax(embeds . text), its dists the negated cosines (diagonal +inf),
    its embeddings the loaded model's."""
    sd = _open_clip_state_dict(seed=12)
    sd["text.transformer.embeddings.word_embeddings.weight"] = np.random.default_rng(13).normal(
        0, 0.1, (30522, 64)).astype(np.float32)
    pt = str(tmp_path / "biomedclip.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, pt)
    out = str(tmp_path / "res")
    metrics = test_cli.main(["--dataset", "synthetic", "--model", "biomedclip", "--device", "cpu",
                             "--clip-dim", "64", "--clip-depth", "2", "--clip-image-size", "64",
                             "--vocab", vocab_file, "--resume", pt, "-j", "2",
                             "--save-dir", out])
    art = np.load(f"{out}/biomedclip_zeroshot.npz")
    assert art["embeds"].shape == (32, 512) and list(art["class_names"]) == [
        "class 0", "class 1", "class 2"]
    model = convert.load_torch_checkpoint(BiomedCLIPModel(img_size=64, vision_dim=64,
                                                          vision_depth=2, text_dim=64,
                                                          text_depth=2), pt).eval()
    from xmir_tpu_torch.data.wordpiece import build_text_tokenizer
    ids, mask = build_text_tokenizer(vocab_file).encode_padded(
        [f"this is a medical image of class {i}" for i in range(3)], 64)
    with torch.inference_mode():
        txt = model.encode_text(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    txt = (txt / txt.norm(dim=1, keepdim=True)).numpy()
    np.testing.assert_array_equal(art["predictions"], np.argmax(art["embeds"] @ txt.T, axis=1))
    assert np.isposinf(np.diag(art["dists"])).all()
    acc = 100.0 * np.mean(art["predictions"] == art["labels"])
    assert metrics["zero_shot_accuracy"] == pytest.approx(acc)
    assert json.loads(str(art["metrics"]))["R@1"] == pytest.approx(metrics["R@1"])


NARROW_SIGLIP = dict(img_size=56, patch_size=14, dim=288, depth=2, num_heads=4,
                     intermediate=576)


@pytest.fixture
def narrow_clip_models(monkeypatch):
    """--model medsiglip | conceptclip | biomedclip with narrow towers at 56 /
    64 px through the registry (the CLI paths are the same; full width runs
    on the card, in chip_smoke.py)."""
    for name, size, kwargs in (
            ("medsiglip", 56, NARROW_SIGLIP),
            ("conceptclip", 56, CONCEPT),
            ("biomedclip", 64, dict(BIOMED, text_vocab=30522))):
        spec = dataclasses.replace(registry.get_spec(name), input_size=size, resize_size=64,
                                   kwargs=tuple(sorted(kwargs.items())))
        monkeypatch.setitem(registry._SPECS, name, spec)


@pytest.mark.parametrize("name,dim", [("medsiglip", 24), ("conceptclip", 24),
                                      ("biomedclip", None)])
def test_cli_ingest_then_query(clean_flags, tmp_path, narrow_clip_models, name, dim):
    """The real ingest -> query CLIs through the registry; --embedding-dim
    goes to the MedSigLIP projection's embed_dim and ConceptCLIP's fc; each
    image finds itself first."""
    img_dir, manifest = synthetic.write_synthetic_covidx(str(tmp_path / "data"), n=4, size=48)
    args = ["--dataset", "covid", "--dataset-dir", img_dir, "--train-image-list", manifest,
            "--test-image-list", manifest, "--model", name, "--device", "cpu", "-j", "2",
            "--batch-size", "2"] + (["--embedding-dim", str(dim)] if dim else [])
    gal, out = str(tmp_path / "g.npz"), str(tmp_path / "h.json")
    idx = ingest.main(args + ["--output", gal])
    assert idx.ntotal == 4 and idx.dim == (dim or 512)
    results = query.main(args + ["--index", gal, "--top-k", "3", "--output", out])
    assert json.load(open(out)) == results
    assert all(r["results"][0]["image_path"] == r["query_path"] for r in results)


def test_medsiglip_resume_of_an_hf_tower(clean_flags, tmp_path, narrow_clip_models):
    """--resume of an HF SiglipVisionModel .pt replaces the backbone; the
    projection keeps the seeded init."""
    src = registry.create_model("medsiglip", generator=torch.Generator().manual_seed(5))[0]
    pt = str(tmp_path / "hf.pt")
    torch.save({f"vision_model.{k}": v for k, v in src.backbone.state_dict().items()}, pt)
    ns = argparse.Namespace(model="medsiglip", embedding_dim=None, seed=0, resume=pt)
    model, _ = common.build_model(ns, torch.device("cpu"))
    seeded, _ = common.build_model(argparse.Namespace(
        model="medsiglip", embedding_dim=None, seed=0, resume=""), torch.device("cpu"))
    assert all(torch.equal(v, model.backbone.state_dict()[k])
               for k, v in src.backbone.state_dict().items())
    assert all(torch.equal(v, model.projection.state_dict()[k])
               for k, v in seeded.projection.state_dict().items())


def test_cli_zeroshot_class_embeds_and_dual_checkpoint(clean_flags, tmp_path, vocab_file,
                                                      narrow_clip_models, capsys):
    """cli.zeroshot --model medsiglip twice on the same images: class text
    embeddings from a MedSigLIPDualEncoder .pt's text tower over the COVIDx
    prompts (--dual-checkpoint + --vocab), then the same embeddings from an
    npz (--class-embeds): the same accuracy, P/R/F1 and confusion, and the
    predictions the JAX zero_shot_classify gives on those features."""
    img_dir, manifest = synthetic.write_synthetic_covidx(str(tmp_path / "data"), n=9, size=48)
    text_kw = dict(dim=288, depth=2)
    dual = MedSigLIPDualEncoder(img_size=56, text_vocab=len(PROMPT_WORDS), **text_kw,
                                generator=torch.Generator().manual_seed(3)).eval()
    pt = str(tmp_path / "dual.pt")
    torch.save(dual.state_dict(), pt)
    base = ["--dataset", "covid", "--dataset-dir", img_dir, "--test-image-list", manifest,
            "--model", "medsiglip", "--device", "cpu", "--eval-batch-size", "4",
            "--embedding-dim", "288"]  # the image embedding at the text features' width
    from_dual = zeroshot_cli.main(base + [
        "--dual-checkpoint", pt, "--vocab", vocab_file, "--text-dim", "288", "--text-depth",
        "2", "--text-vocab-size", str(len(PROMPT_WORDS)), "--output", str(tmp_path / "a.json")])
    printed = capsys.readouterr().out
    preds = json.loads(printed.split(">> predictions: ")[1].splitlines()[0])

    from xmir_tpu_torch.data.wordpiece import BertWordPieceTokenizer
    from xmir_tpu_torch.models.siglip_text import COVIDX_LABEL_TO_TEXT
    ids, mask = BertWordPieceTokenizer(vocab_file).encode_padded(
        [COVIDX_LABEL_TO_TEXT[i] for i in range(3)], 64)
    with torch.inference_mode():
        txt = dual.get_text_features(torch.from_numpy(ids).long()).numpy()
    npz = str(tmp_path / "class.npz")
    np.savez(npz, text_embeds=txt, class_names=np.asarray(["0", "1", "2"]))
    from_npz = zeroshot_cli.main(base + ["--class-embeds", npz])
    assert from_npz["confusion"] == from_dual["confusion"]
    for key in ("accuracy", "precision_macro", "recall_macro", "f1_macro"):
        assert from_npz[key] == pytest.approx(from_dual[key])
    assert json.load(open(tmp_path / "a.json")) == from_dual

    model, spec = common.build_model(argparse.Namespace(
        model="medsiglip", embedding_dim=288, seed=0, resume=""), torch.device("cpu"))
    from xmir_tpu_torch.data.pipeline import embed_dataset
    from xmir_tpu_torch.train import make_embed_fn
    ns = argparse.Namespace(dataset="covid", dataset_dir=img_dir, test_image_list=manifest)
    emb, labels = embed_dataset(common.build_dataset(ns, "test"), make_embed_fn(model), spec,
                                device="cpu", batch_size=4)
    jp, _ = jax_zeroshot.zero_shot_classify(emb.numpy(), txt, np.log(10.0), 0.0)
    np.testing.assert_array_equal(preds, jp)
    confusion = np.zeros((3, 3), int)
    np.add.at(confusion, (labels.astype(int), jp), 1)
    assert confusion.tolist() == from_dual["confusion"]
    with pytest.raises(SystemExit):
        zeroshot_cli.main(base)
