"""The port's analysis tools against the JAX package's on the same arrays:
the anomaly metrics and centroid evaluation (numpy copies: exactly equal),
embedding ensembles (within 1e-6), late fusion (the whole
run_late_fusion_experiments dict; the similarity products in torch f32
against numpy f32, on embeddings whose rankings hold no near-tie: the
metrics equal to 1e-9 relative), the dual-model comparison (groups, hits
and exported files; similarities within 1e-6) and the insertion / deletion
reports (exactly equal), then the fusion, compare and anomaly CLIs on the
CPU against the JAX CLIs.
"""
import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu import analysis as jax_analysis
from xmir_tpu.metrics import anomaly as jax_anomaly
from xmir_tpu_torch import analysis
from xmir_tpu_torch.index import ShardedGalleryIndex
from xmir_tpu_torch.metrics import anomaly

torch.set_num_threads(1)


def _source(n=40, d=16, seed=0, order=None):
    rng = np.random.default_rng(seed)
    paths = [f"img_{i:03d}.png" for i in range(n)]
    labels = np.arange(n) % 3
    embeds = rng.standard_normal((n, d)).astype(np.float32)
    if order is not None:
        paths, labels, embeds = [paths[i] for i in order], labels[order], embeds[order]
    return paths, labels, embeds


def _close(got, want, rel=1e-9, abs_=1e-6):
    """Equal structure; floats within ``rel`` relative or ``abs_`` absolute."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for key in want:
            _close(got[key], want[key], rel, abs_)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rel, abs_)
    elif isinstance(want, (float, np.floating)):
        assert got == pytest.approx(want, rel=rel, abs=abs_)
    elif isinstance(want, np.ndarray):
        np.testing.assert_allclose(got, want, rtol=rel, atol=abs_)
    else:
        assert got == want


@pytest.mark.parametrize("recall_level", [0.95, 0.8])
def test_anomaly_measures_equal_jax(recall_level):
    rng = np.random.default_rng(1)
    pos = np.round(rng.normal(1.0, 1.0, 37), 1)  # rounded: ties across the classes
    neg = np.round(rng.normal(0.0, 1.0, 80), 1)
    assert anomaly.get_measures(pos, neg, recall_level) == jax_anomaly.get_measures(
        pos, neg, recall_level)
    labels = np.r_[np.ones(37), np.zeros(80)]
    scores = np.r_[pos, neg]
    assert anomaly.fpr_at_recall(labels, scores, recall_level) == jax_anomaly.fpr_at_recall(
        labels, scores, recall_level)


def test_evaluate_anomaly_equal_jax():
    rng = np.random.default_rng(2)
    tr_e, tr_l = rng.standard_normal((60, 8)), np.arange(60) % 2
    te_e, te_l = rng.standard_normal((30, 8)), np.arange(30) % 3
    got = analysis.evaluate_anomaly(tr_e, tr_l, te_e, te_l, anomaly_class=2)
    want = jax_analysis.evaluate_anomaly(tr_e, tr_l, te_e, te_l, anomaly_class=2)
    assert list(got) == list(want)
    np.testing.assert_array_equal(got.pop("scores"), want.pop("scores"))
    assert got == want
    np.testing.assert_array_equal(analysis.class_centroids(tr_e, tr_l, [0, 1]),
                                  jax_analysis.class_centroids(tr_e, tr_l, [0, 1]))


@pytest.mark.parametrize("method", ["average", "concatenate", "weighted"])
def test_ensemble_matches_jax(method):
    rng = np.random.default_rng(3)
    embs = [rng.standard_normal((10, 8)).astype(np.float32) for _ in range(3)]
    got = analysis.ensemble_embeddings(embs, method, device="cpu")
    want = jax_analysis.ensemble_embeddings([jnp.asarray(e) for e in embs], method)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Unknown ensemble method"):
        analysis.ensemble_embeddings(embs, "median", device="cpu")


def _fusion_sources(d_b):
    a = _source(d=16, seed=4)
    # b holds a's images in another order, without the first five
    order = np.random.default_rng(5).permutation(40)[5:]
    b = _source(d=d_b, seed=6, order=order)
    return a, b


@pytest.mark.parametrize("norm", ["none", "zscore", "minmax"])
@pytest.mark.parametrize("d_b", [16, 24], ids=["same-width", "widths-differ"])
def test_late_fusion_experiments_match_jax(norm, d_b):
    (pa, la, ea), (pb, lb, eb) = _fusion_sources(d_b)
    want = jax_analysis.run_late_fusion_experiments(
        jax_analysis.EmbeddingSource(pa, la, ea), jax_analysis.EmbeddingSource(pb, lb, eb),
        score_normalization=norm)
    got = analysis.run_late_fusion_experiments(
        analysis.EmbeddingSource(pa, la, ea), analysis.EmbeddingSource(pb, lb, eb),
        score_normalization=norm, device="cpu")
    assert ("skipped" in got["weighted_sum_alpha_0.5"]) == (d_b != 16)
    _close(got, want)


def test_align_sources_matches_jax():
    (pa, la, ea), (pb, lb, eb) = _fusion_sources(16)
    got = analysis.align_sources(analysis.EmbeddingSource(pa, la, ea),
                                 analysis.EmbeddingSource(pb, lb, eb))
    want = jax_analysis.align_sources(jax_analysis.EmbeddingSource(pa, la, ea),
                                      jax_analysis.EmbeddingSource(pb, lb, eb))
    for g, w in zip(got, want):
        assert g.image_paths == w.image_paths
        np.testing.assert_array_equal(g.embeddings, w.embeddings)
    with pytest.raises(ValueError, match="no shared image paths"):
        analysis.align_sources(analysis.EmbeddingSource(["x"], la[:1], ea[:1]),
                               analysis.EmbeddingSource(["y"], lb[:1], eb[:1]))


def _write_gallery(path, paths, labels, embeds):
    idx = ShardedGalleryIndex(embeds.shape[1])
    idx.add(embeds, list(labels), paths)
    idx.save(path)
    return path


@pytest.fixture
def two_galleries(tmp_path):
    """Galleries and query sets of two models (widths 16 and 24) as .npz."""
    files = {}
    for name, d, seed in (("a", 16, 7), ("b", 24, 8)):
        files[f"index_{name}"] = _write_gallery(str(tmp_path / f"g_{name}.npz"),
                                                *_source(n=40, d=d, seed=seed))
        qp, ql, qe = _source(n=12, d=d, seed=seed + 10)
        files[f"queries_{name}"] = _write_gallery(str(tmp_path / f"q_{name}.npz"),
                                                  [f"q_{p}" for p in qp], ql, qe)
    return files


def test_compare_retrievers_matches_jax(two_galleries, tmp_path):
    from xmir_tpu.index import ShardedGalleryIndex as JaxIndex

    qa = analysis.EmbeddingSource.from_npz(two_galleries["queries_a"])
    qb = analysis.EmbeddingSource.from_npz(two_galleries["queries_b"])
    names = ("resnet", "densenet")
    port = [ShardedGalleryIndex.load(two_galleries[f"index_{x}"], device="cpu") for x in "ab"]
    ref = [JaxIndex.load(two_galleries[f"index_{x}"]) for x in "ab"]
    got = analysis.compare_retrievers(qa.embeddings, qa.labels, qa.image_paths, *port, k=5,
                                      names=names, queries_b=qb.embeddings)
    # the JAX package's compare_retrievers takes one query set: its CLI's
    # inline loop, which the port's queries_b folds in, is the reference
    want = {g: [] for g in got}
    hits_a = ref[0].search_with_metadata(qa.embeddings, k=5)
    hits_b = ref[1].search_with_metadata(qb.embeddings, k=5)
    for i, label in enumerate(qa.labels):
        true = label.item()
        ca = jax_analysis.comparison.majority_correct([h["label"] for h in hits_a[i]], true, 5)
        cb = jax_analysis.comparison.majority_correct([h["label"] for h in hits_b[i]], true, 5)
        key = ("both_correct" if ca and cb else "both_wrong" if not (ca or cb) else
               "resnet_correct_densenet_wrong" if ca else "densenet_correct_resnet_wrong")
        want[key].append({"query_path": qa.image_paths[i], "query_label": true,
                          "resnet": hits_a[i], "densenet": hits_b[i],
                          "resnet_correct": ca, "densenet_correct": cb})
    _close(got, want, rel=1e-6)
    assert sum(len(v) for v in got.values()) == 12
    same = analysis.compare_retrievers(qa.embeddings, qa.labels, qa.image_paths, port[0],
                                       port[0], k=5)
    assert len(same["both_correct"]) + len(same["both_wrong"]) == 12
    for pkg, out in ((analysis, tmp_path / "port"), (jax_analysis, tmp_path / "jax")):
        pkg.export_comparison(got, str(out), names)
        pkg.render_mismatch_html(got, str(out / "mismatches.html"), names)
    for name in ("comparison_results.csv", "comparison_results.json", "mismatches.html"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()


def _insdel_results(path):
    rng = np.random.default_rng(9)
    results = [{"query_index": i, "query_label": int(i % 3), "retrieved": [i + 1, i + 2],
                "deletion_auc": float(rng.uniform()), "insertion_auc": float(rng.uniform())}
               for i in range(7)]
    with open(path, "w") as f:
        json.dump({"results": results}, f)
    return results


class _Images:
    def load_image(self, index):
        return np.random.default_rng(index).integers(0, 256, (20, 24, 3), dtype=np.uint8)


def test_reports_match_jax(tmp_path):
    path = str(tmp_path / "insdel.json")
    results = _insdel_results(path)
    assert analysis.analyze_insertion_deletion(path) == \
        jax_analysis.analyze_insertion_deletion(path)
    img = _Images().load_image(0)
    sal = np.random.default_rng(10).uniform(size=(5, 6))
    np.testing.assert_array_equal(analysis.overlay_saliency(img, sal),
                                  jax_analysis.overlay_saliency(img, sal))
    np.testing.assert_array_equal(analysis.overlay_saliency(img, sal, 0.3, "gray"),
                                  jax_analysis.overlay_saliency(img, sal, 0.3, "gray"))
    sal_dir = tmp_path / "sal"
    sal_dir.mkdir()
    for rec in results[:3]:
        np.save(sal_dir / f"sal_q{rec['query_index']:05d}_r{rec['retrieved'][0]:05d}.npy",
                np.random.default_rng(rec["query_index"]).uniform(size=(20, 24)))
    written = {}
    for name, pkg in (("port", analysis), ("jax", jax_analysis)):
        written[name] = pkg.render_overlays_from_results(path, _Images(), str(sal_dir),
                                                         str(tmp_path / name), limit=5)
    assert len(written["port"]) == 3
    for a, b in zip(written["port"], written["jax"]):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_fusion_cli_matches_jax(tmp_path):
    from xmir_tpu.cli import fusion as jax_fusion
    from xmir_tpu_torch.cli import fusion

    (pa, la, ea), (pb, lb, eb) = _fusion_sources(16)
    src = [_write_gallery(str(tmp_path / f"{x}.npz"), p, lab, e)
           for x, p, lab, e in (("a", pa, la, ea), ("b", pb, lb, eb))]
    with open(tmp_path / "cfg.json", "w") as f:
        json.dump({"sources": [{"path": src[0]}, {"path": src[1]}], "alphas": [0.3, 0.5],
                   "score_normalization": "zscore"}, f)
    for argv in (["--source-a", src[0], "--source-b", src[1], "--alphas", "0.4,0.6"],
                 ["--config", str(tmp_path / "cfg.json"), "--no-confidence-fusion"]):
        want = jax_fusion.main(argv + ["--output", str(tmp_path / "jax")])
        got = fusion.main(argv + ["--device", "cpu", "--output", str(tmp_path / "port")])
        _close(got, want)
        with open(tmp_path / "port.json") as f, open(tmp_path / "jax.json") as g:
            _close(json.load(f), json.load(g))
        with open(tmp_path / "port.csv") as f, open(tmp_path / "jax.csv") as g:
            rows = list(csv.reader(f)), list(csv.reader(g))
        assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]


def test_compare_cli_matches_jax(two_galleries, tmp_path):
    from xmir_tpu.cli import compare as jax_compare
    from xmir_tpu_torch.cli import compare

    argv = ["--index-a", two_galleries["index_a"], "--index-b", two_galleries["index_b"],
            "--queries-a", two_galleries["queries_a"], "--queries-b",
            two_galleries["queries_b"], "--top-k", "5", "--html"]
    want = jax_compare.main(argv + ["--out-dir", str(tmp_path / "jax")])
    got = compare.main(argv + ["--device", "cpu", "--out-dir", str(tmp_path / "port")])
    _close(got, want, rel=1e-6)
    for name in ("comparison_results.csv", "mismatches.html"):
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    with open(tmp_path / "port" / "comparison_results.json") as f, \
            open(tmp_path / "jax" / "comparison_results.json") as g:
        _close(json.load(f), json.load(g), rel=1e-6)


def test_anomaly_cli_matches_jax(tmp_path):
    """--model tiny from a .pt of the JAX CLI's own init: AUROC, AUPR and
    FPR@95 within 1e-6 and the scores within 1e-5 (embeddings within
    1e-5, as tests/test_torch_resnet.py holds the tiny model)."""
    from test_torch_resnet import _tiny_pt
    from xmir_tpu.cli import anomaly as jax_anomaly_cli
    from xmir_tpu_torch.cli import anomaly as anomaly_cli

    pt = _tiny_pt(tmp_path)
    common = ["--dataset", "synthetic", "--model", "tiny", "--embedding-dim", "16",
              "--eval-batch-size", "16"]
    want = jax_anomaly_cli.main(common + ["--save-dir", str(tmp_path / "jax")])
    got = anomaly_cli.main(common + ["--device", "cpu", "--resume", pt, "--save-dir",
                                     str(tmp_path / "port")])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
    for key in ("auroc", "aupr", "fpr@95"):
        assert got[key] == pytest.approx(want[key], abs=1e-6), key
    saved = np.load(tmp_path / "port" / "anomaly_results.npz")
    assert sorted(saved.files) == sorted(np.load(tmp_path / "jax" / "anomaly_results.npz").files)
