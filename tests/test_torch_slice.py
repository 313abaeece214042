"""The ported slice end to end: synthetic images -> host decode -> device
preprocessing -> narrow DenseNet embedding -> gallery index -> top-k hits,
held against the JAX package's same chain on the same weights; plus the
port's data modules, its CLIs on the CPU and its import boundary (no jax).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_topk_match
from torch_parity_models import NARROW, JaxNarrowEmbedder, randomized
from xmir_tpu.data import pipeline as jax_pipeline
from xmir_tpu.data import synthetic as jax_synthetic
from xmir_tpu.data import transforms as jax_transforms
from xmir_tpu.data.datasets import CovidxDataset as JaxCovidx
from xmir_tpu.index import ShardedGalleryIndex as JaxIndex
from xmir_tpu.models.registry import ModelSpec as JaxSpec
from xmir_tpu.train import make_embed_fn as jax_make_embed_fn
from xmir_tpu_torch.cli import common, ingest, query
from xmir_tpu_torch.data import pipeline, synthetic, transforms
from xmir_tpu_torch.data.datasets import CovidxDataset
from xmir_tpu_torch.index import ShardedGalleryIndex
from xmir_tpu_torch.models.convert import densenet_state_dict_from_jax
from xmir_tpu_torch.models.embedders import DenseNet121Embedder
from xmir_tpu_torch.models.registry import ModelSpec
from xmir_tpu_torch.train import make_embed_fn

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HIT_KEYS = {"id", "image_path", "label", "distance", "similarity"}


def test_slice_matches_jax(monkeypatch):
    """Narrow net -> embed -> index -> search_with_metadata, both stacks."""
    monkeypatch.setenv("XMIR_GALLERY_PALLAS", "interpret")
    gallery = synthetic.SyntheticImageDataset(n=40, size=64, seed=0)
    queries = synthetic.SyntheticImageDataset(n=6, size=64, seed=1)
    jax_model = JaxNarrowEmbedder(embedding_dim=16)
    variables = randomized(
        jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3))), seed=4)
    jax_spec = JaxSpec("narrow", JaxNarrowEmbedder, 56, 64, 16)
    jax_embed = jax.jit(jax_make_embed_fn(jax_model))
    ref_g, ref_labels = jax_pipeline.embed_dataset(gallery, jax_embed, variables, jax_spec,
                                                   batch_size=16, num_workers=2)
    ref_q, _ = jax_pipeline.embed_dataset(queries, jax_embed, variables, jax_spec,
                                          batch_size=16, num_workers=2)

    model = DenseNet121Embedder(16, 3, **NARROW)
    model.load_state_dict(densenet_state_dict_from_jax(variables), strict=True)
    spec = ModelSpec("narrow", DenseNet121Embedder, 56, 64, 16)
    embed = make_embed_fn(model.eval())
    g, labels = pipeline.embed_dataset(gallery, embed, spec, device="cpu", batch_size=16,
                                       num_workers=2)
    q, _ = pipeline.embed_dataset(queries, embed, spec, device="cpu", batch_size=16,
                                  num_workers=2)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), ref_q, rtol=1e-4, atol=1e-4)

    paths = [str(n) for n in gallery.image_names]
    jidx = JaxIndex(16)
    jidx.add(ref_g, ref_labels, paths)
    jidx.build()
    tidx = ShardedGalleryIndex(16)
    tidx.add(g.numpy(), labels, paths)
    tidx.build("cpu")
    ref_hits = jidx.search_with_metadata(ref_q, k=5)
    hits = tidx.search_with_metadata(q, k=5)
    true_s = ref_q.astype(np.float64) @ ref_g.astype(np.float64).T  # unit rows: cosine
    as_arrays = lambda hs, key: np.array([[h[key] for h in row] for row in hs])  # noqa: E731
    assert_topk_match(as_arrays(hits, "similarity"), as_arrays(hits, "id"),
                      as_arrays(ref_hits, "similarity"), as_arrays(ref_hits, "id"),
                      true_s, atol=1e-5)
    for row in hits:
        for h in row:
            assert set(h) == HIT_KEYS and h["image_path"] == paths[h["id"]]
            assert h["label"] == labels[h["id"]]


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("hw", [(64, 64), (80, 96), (96, 72), (40, 50)])
def test_eval_preprocess_matches_jax(hw, method):
    """Identity at the resize size; otherwise the antialiased torch resize
    stands in for jax.image.resize within 1e-3 of a 0..255 pixel."""
    x = np.random.default_rng(0).integers(0, 256, (2, *hw, 3)).astype(np.uint8)
    ref = np.asarray(jax_transforms.resize_short_side(jnp.asarray(x, jnp.float32), 64, method))
    out = transforms.resize_short_side(torch.from_numpy(x).float(), 64, method).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    ref = np.asarray(jax_transforms.eval_preprocess(jnp.asarray(x), 64, 56, mean, std, method))
    out = transforms.eval_preprocess(torch.from_numpy(x), 64, 56, mean, std, method).numpy()
    assert out.dtype == np.float32 and out.shape == (2, 56, 56, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)  # 1e-3 / 255 / min(std)
    if hw == (64, 64):  # no resize: only the normalisation's rounding differs
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_center_crop_pads_small_inputs():
    x = np.arange(2 * 5 * 7 * 3, dtype=np.float32).reshape(2, 5, 7, 3)
    ref = np.asarray(jax_transforms.center_crop(jnp.asarray(x), 8))
    np.testing.assert_array_equal(transforms.center_crop(torch.from_numpy(x), 8).numpy(), ref)


@pytest.mark.parametrize("hw", [(300, 300), (320, 400), (48, 48)])
def test_pil_resize_center_crop_matches_jax(hw):
    arr = np.random.default_rng(1).integers(0, 256, (*hw, 3)).astype(np.uint8)
    np.testing.assert_array_equal(transforms.pil_resize_center_crop(arr, 256),
                                  jax_transforms.pil_resize_center_crop(arr, 256))


@pytest.mark.parametrize("cls", ["SyntheticImageDataset", "SyntheticMultiLabelDataset"])
def test_synthetic_copy_makes_the_same_images(cls):
    a = getattr(synthetic, cls)(n=9, size=32, seed=3)
    b = getattr(jax_synthetic, cls)(n=9, size=32, seed=3)
    np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(b.labels))
    assert a.image_names == b.image_names
    for i in range(9):
        np.testing.assert_array_equal(a.load_image(i), b.load_image(i))


def test_covidx_dataset_matches_jax(tmp_path):
    img_dir, manifest = synthetic.write_synthetic_covidx(str(tmp_path), n=6, size=24)
    a, b = CovidxDataset(img_dir, manifest), JaxCovidx(img_dir, manifest)
    assert a.image_names == b.image_names and a.labels == b.labels
    np.testing.assert_array_equal(a.load_image(4), b.load_image(4))
    assert len(CovidxDataset(img_dir, manifest, use_covid=False)) == len(
        JaxCovidx(img_dir, manifest, use_covid=False))


def test_batch_iterator_order_and_skip_errors():
    class Flaky(synthetic.SyntheticImageDataset):
        def load_image(self, index):
            if index == 3:
                raise OSError("unreadable")
            return super().load_image(index)

    ds = Flaky(n=10, size=16)
    batches = list(pipeline.batch_iterator(ds, 4, image_size=16, num_workers=2,
                                           skip_errors=True))
    assert [b[2].tolist() for b in batches] == [[0, 1, 2], [4, 5, 6, 7], [8, 9]]
    with pytest.raises(OSError):
        list(pipeline.batch_iterator(ds, 4, image_size=16, num_workers=2))


def test_cli_ingest_then_query_densenet121(tmp_path):
    gal, out = str(tmp_path / "gallery.npz"), str(tmp_path / "hits.json")
    common_args = ["--dataset", "synthetic", "--model", "densenet121", "--embedding-dim", "32",
                   "--device", "cpu", "-j", "2"]
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
    ingest.main(common_args + ["--split", "train", "--output", gal])
    assert not torch.backends.cudnn.allow_tf32  # the gallery embeds in IEEE f32
    query.main(common_args + ["--index", gal, "--top-k", "3", "--output", out])
    results = json.load(open(out))
    assert len(results) == 32
    assert all(len(r["results"]) == 3 for r in results)
    assert set(results[0]["results"][0]) == HIT_KEYS
    assert set(results[0]) == {"query_path", "query_label", "results"}
    assert JaxIndex.load(gal).ntotal == 64  # the artifact is the JAX package's format


def test_cli_covid_full_ranking_with_host_resize(tmp_path):
    """A COVIDx manifest of 32 px PNGs: the host decode resizes them to 256
    with PIL; --top-k 0 ranks the whole gallery."""
    img_dir, manifest = synthetic.write_synthetic_covidx(str(tmp_path / "data"), n=6, size=32)
    gal, out = str(tmp_path / "g.npz"), str(tmp_path / "h.json")
    args = ["--dataset", "covid", "--dataset-dir", img_dir, "--train-image-list", manifest,
            "--test-image-list", manifest, "--embedding-dim", "8", "--device", "cpu",
            "-j", "2"]
    ingest.main(args + ["--metric", "l2", "--output", gal])
    results = query.main(args + ["--index", gal, "--top-k", "0", "--output", out])
    assert len(results) == 6 and all(len(r["results"]) == 6 for r in results)
    assert results[0]["results"][0]["id"] == 0  # each image finds itself first
    assert results[0]["results"][0]["distance"] == pytest.approx(0.0, abs=1e-3)


def test_cli_full_ranking_of_a_gallery_above_1024_rows(tmp_path):
    """--top-k 0 on a gallery of 1100 rows, which the kernel of k <= 1024 used
    to refuse: the whole gallery, ranked as a stable sort of the scores."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((1100, 8)).astype(np.float32)
    g[[7, 500, 1099]] = g[2]  # ties: the lower row first
    idx = ShardedGalleryIndex(8, metric="ip")
    idx.add(g, np.arange(1100) % 3, [f"g{n}" for n in range(1100)])
    idx.build("cpu")
    gal, out = str(tmp_path / "g.npz"), str(tmp_path / "h.json")
    idx.save(gal)
    results = query.main(["--dataset", "synthetic", "--embedding-dim", "8", "--device", "cpu",
                          "-j", "2", "--index", gal, "--top-k", "0", "--output", out])
    assert len(results) == 32 and all(len(r["results"]) == 1100 for r in results)
    for r in results[:4]:
        ids = [h["id"] for h in r["results"]]
        sims = np.array([h["similarity"] for h in r["results"]])
        assert sorted(ids) == list(range(1100)) and (np.diff(sims) <= 0).all()
        tied = [i for i in ids if i in (2, 7, 500, 1099)]
        assert tied == [2, 7, 500, 1099]


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = common.argparse.Namespace(device="cuda")
    with pytest.raises(RuntimeError, match="no silent CPU run|is_available"):
        common.resolve_device(args)
    assert common.resolve_device(common.argparse.Namespace(device="cpu")).type == "cpu"


def test_unported_dataset_raises():
    """Every dataset of the JAX package is ported; an unknown name raises as
    the JAX package's build_dataset does."""
    args = common.argparse.Namespace(dataset="nope", dataset_dir=".", train_image_list=None)
    with pytest.raises(ValueError, match="unknown dataset 'nope'"):
        common.build_dataset(args, "train")


def test_score_precision_sets_both_tf32_switches():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        common.apply_score_precision(common.argparse.Namespace(score_precision="highest"))
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        common.apply_score_precision(common.argparse.Namespace(score_precision="default"))
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_port_imports_no_jax():
    """Every module of the port imports without jax, flax, optax, pandas or xmir_tpu."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "xmir_tpu_torch").rglob("*.py")
    )
    assert {"xmir_tpu_torch.ops.vit_attn", "xmir_tpu_torch.ops.plain_attn",
            "xmir_tpu_torch.ops.ln_dense", "xmir_tpu_torch.models.vit",
            "xmir_tpu_torch.ops.window_attn", "xmir_tpu_torch.models.swin",
            "xmir_tpu_torch.metrics.retrieval", "xmir_tpu_torch.cli.test",
            "xmir_tpu_torch.cli.evaluate_query", "xmir_tpu_torch.cli.train",
            "xmir_tpu_torch.losses.metric_losses", "xmir_tpu_torch.train.optim",
            "xmir_tpu_torch.train.state", "xmir_tpu_torch.utils.checkpoint",
            "xmir_tpu_torch.data.samplers"} <= set(modules)
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'pandas', 'xmir_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(" + repr(modules) + "))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == len(modules) >= 25
