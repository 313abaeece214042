"""The port's retrieval metrics (xmir_tpu_torch/metrics/retrieval.py, a torch +
numpy copy, since the original imports jax), its evaluation suites
(cli/test.py) and its offline evaluator (cli/evaluate_query.py) against the
JAX package's on seeded inputs, and against the goldens the reference
repository's own code produced (tests/fixtures/reference_*), read the way
tests/test_reference_parity.py reads them. Tier 1: CPU only.

Tolerances: score matrices within 1e-6 (f32 products summed in another
order); the numpy half is the same code, so its numbers are equal; goldens at
the tolerances of tests/test_reference_parity.py.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu.cli import evaluate_query as jax_evaluate_query
from xmir_tpu.cli import test as jax_test_cli
from xmir_tpu.cli.parity import compare_metrics
from xmir_tpu.metrics import retrieval as jm
from xmir_tpu_torch.cli import evaluate_query
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.metrics import retrieval as tm

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _single_label(n=60, seed=12345):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((3, 32)).astype(np.float32) * 2.5
    labels = np.arange(n) % 3
    embeds = centers[labels] + rng.standard_normal((n, 32)).astype(np.float32) * 0.8
    embeds /= np.linalg.norm(embeds, axis=1, keepdims=True)
    return embeds, labels.astype(np.int64)


def _multilabel(n=48, c=14, seed=777):
    rng = np.random.default_rng(seed)
    labels = (rng.random((n, c)) < 0.18).astype(np.float32)
    labels[np.arange(n), rng.integers(0, c, n)] = 1.0
    proto = rng.standard_normal((c, 32)).astype(np.float32)
    embeds = labels @ proto + rng.standard_normal((n, 32)).astype(np.float32) * 0.6
    return embeds.astype(np.float32), labels


def _sims(embeds, kind):
    """(port's, JAX package's) score matrix with a -inf diagonal, as numpy."""
    t = torch.from_numpy(embeds)
    j = jnp.asarray(embeds)
    if kind == "cosine":
        return (tm.fill_diagonal_neg_inf(tm.pairwise_cosine(t)).numpy(),
                np.asarray(jm.fill_diagonal_neg_inf(jm.pairwise_cosine(j))))
    return (tm.fill_diagonal_neg_inf(tm.pairwise_neg_l2(t)).numpy(),
            np.asarray(jm.fill_diagonal_neg_inf(jm.pairwise_neg_l2(j))))


@pytest.mark.parametrize("kind", ["cosine", "neg_l2"])
@pytest.mark.parametrize("scale", [1.0, 7.5])
def test_score_matrices_match_jax(kind, scale):
    embeds = _multilabel()[0] * scale  # rows not normalised
    out, ref = _sims(embeds, kind)
    assert out.dtype == np.float32 and out.shape == (48, 48)
    assert np.isneginf(np.diag(out)).all()
    off = ~np.eye(48, dtype=bool)
    np.testing.assert_allclose(out[off], ref[off], atol=1e-6 * max(1.0, scale), rtol=1e-6)
    fn = tm.pairwise_cosine if kind == "cosine" else tm.pairwise_neg_l2
    plain = fn(torch.from_numpy(embeds)).numpy()
    np.testing.assert_allclose(np.diag(plain), 1.0 if kind == "cosine" else 0.0, atol=1e-6)
    assert fn(torch.from_numpy(embeds).double()).dtype == torch.float32


def test_pairwise_cosine_takes_zero_rows():
    e = torch.zeros(3, 4)
    e[1, 0] = 2.0
    out = tm.pairwise_cosine(e)
    assert torch.isfinite(out).all() and out[1, 1] == 1.0 and out[0, 0] == 0.0


NUMPY_HALF = ["retrieval_recall_at_k", "compute_ap", "compute_map", "majority_vote", "_prf",
              "compute_classification_metrics", "jaccard_matrix", "compute_map_multilabel",
              "multilabel_precision_recall_at_k", "_average_precision_score"]


@pytest.mark.parametrize("name", NUMPY_HALF)
def test_numpy_half_equals_jax_package(name):
    """Each host-side function on the same inputs: equal results."""
    emb_s, lab_s = _single_label()
    emb_m, lab_m = _multilabel()
    sims_s = _sims(emb_s, "neg_l2")[1]
    sims_m = _sims(emb_m, "cosine")[1]
    ranks = np.argsort(-sims_s, axis=1, kind="stable").T
    rng = np.random.default_rng(0)
    args = {
        "retrieval_recall_at_k": (sims_s, lab_s, (1, 5, 10)),
        "compute_ap": (np.array([0, 2, 3, 9]), 6),
        "compute_map": (ranks, lab_s, [1, 5, 10]),
        "majority_vote": ([2, 1, 2, 0, 1, 2],),
        "_prf": (lab_s, np.roll(lab_s, 7) % 2, "weighted"),
        "compute_classification_metrics": (lab_s, sims_s),
        "jaccard_matrix": (lab_m,),
        "compute_map_multilabel": (sims_m, lab_m, 0.25),
        "multilabel_precision_recall_at_k": (sims_m, lab_m),
        "_average_precision_score": ((rng.random(40) < 0.3), rng.random(40)),
    }[name]
    out, ref = getattr(tm, name)(*args), getattr(jm, name)(*args)

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (tuple, list)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    same(out, ref)
    if name == "majority_vote":
        assert tm.majority_vote([]) is None and out == 2


@pytest.mark.parametrize("kind", ["single", "multilabel"])
def test_train_eval_matches_jax_and_reference_golden(kind):
    with open(os.path.join(FIXTURES, "reference_train_eval_golden.json")) as f:
        golden = json.load(f)[kind]
    if kind == "single":
        emb, lab = _single_label()
        out = tm.train_eval_single_label(emb, lab, device="cpu")
        ref = jm.train_eval_single_label(emb, lab)
        tiny = tm.train_eval_single_label(emb[:1], lab[:1], device="cpu")
    else:
        emb, lab = _multilabel()
        out = tm.train_eval_multilabel(emb, lab, device="cpu")
        ref = jm.train_eval_multilabel(emb, lab)
        tiny = tm.train_eval_multilabel(emb[:1], lab[:1], device="cpu")
    assert out.keys() == ref.keys() == {"mAP", "R@1", "R@5", "R@10"}
    for k, v in golden.items():
        np.testing.assert_allclose(out[k], v, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-6, err_msg=k)
    assert tiny == {"mAP": 0.0, "R@1": 0.0, "R@5": 0.0, "R@10": 0.0}
    # a tensor is scored where it lies and needs no device
    again = (tm.train_eval_single_label if kind == "single" else tm.train_eval_multilabel)(
        torch.from_numpy(emb), lab)
    assert again == out


@pytest.mark.parametrize("stored_dists", [False, True])
def test_single_label_suite_matches_reference_golden(stored_dists):
    """R@K, mAP, mP@K and all 35 majority-vote numbers of the artifact the
    reference's evaluate() wrote, from its embeddings or from its own
    distance matrix; and the self-pinned golden shares them."""
    data = np.load(os.path.join(FIXTURES, "reference_single_label_golden.npz"), allow_pickle=True)
    labels = np.asarray(data["labels"])
    if stored_dists:
        dists = np.array(data["dists"], dtype=np.float32)
        np.fill_diagonal(dists, -np.inf)
    else:
        dists = tm.fill_diagonal_neg_inf(
            tm.pairwise_neg_l2(torch.from_numpy(np.asarray(data["embeds"])))).numpy()
    computed = test_cli.single_label_metrics(dists, labels)
    _, mismatches = compare_metrics(computed, json.loads(str(data["metrics"])))
    assert mismatches == []
    assert len(computed["classification"]) == 5
    pin = np.load(os.path.join(FIXTURES, "parity_golden.npz"), allow_pickle=True)
    pinned = json.loads(str(pin["metrics"]))
    for k in ("mAP", "R@1", "R@5", "R@10", "mP@1", "mP@5", "mP@10"):
        np.testing.assert_allclose(computed[k], pinned[k], rtol=1e-6, err_msg=k)


def test_multilabel_suite_matches_reference_golden():
    data = np.load(os.path.join(FIXTURES, "reference_multilabel_golden.npz"), allow_pickle=True)
    stored = json.loads(str(data["metrics"]))
    sims = tm.fill_diagonal_neg_inf(
        tm.pairwise_cosine(torch.from_numpy(np.asarray(data["embeds"])))).numpy()
    computed = test_cli.multilabel_metrics(sims, np.asarray(data["labels"]))
    for t in (0.25, 0.5):
        np.testing.assert_allclose(computed[f"mAP@jaccard>{t}"], stored[f"mAP@jaccard>{t}"],
                                   rtol=1e-6)
    for k in (1, 5, 10, 15, 20):
        np.testing.assert_allclose(computed[f"P@{k}"], stored[f"P@{k}"], atol=5.1e-3)
        np.testing.assert_allclose(computed[f"R@{k}"], stored[f"R@{k}"], atol=5.1e-3)


@pytest.mark.parametrize("kind", ["single", "multilabel"])
def test_evaluate_suites_match_jax_cli(tmp_path, kind):
    """evaluate_single_label / evaluate_multilabel: the same metrics and the
    same artifact as the JAX package's."""
    emb, lab = _single_label() if kind == "single" else _multilabel()
    name = "evaluate_single_label" if kind == "single" else "evaluate_multilabel"
    out = getattr(test_cli, name)(emb, lab, str(tmp_path / "a"), device="cpu")
    ref = getattr(jax_test_cli, name)(emb, lab, str(tmp_path / "b"))
    _, mismatches = compare_metrics(out, ref)
    assert mismatches == [] and json.dumps(out, default=float, sort_keys=True)
    a = np.load(str(tmp_path / "a" / "evaluation_results.npz"))
    b = np.load(str(tmp_path / "b" / "evaluation_results.npz"))
    assert set(a.files) == set(b.files)
    np.testing.assert_array_equal(a["embeds"], b["embeds"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    if kind == "single":
        off = ~np.eye(len(lab), dtype=bool)
        np.testing.assert_allclose(a["dists"][off], b["dists"][off], atol=1e-6)
    # no save_dir: no artifact needed; a CPU tensor names its own device
    assert getattr(test_cli, name)(torch.from_numpy(emb), lab) == out
    (tmp_path / "c").mkdir()
    getattr(test_cli, name)(torch.from_numpy(emb), lab, str(tmp_path / "c"))
    np.testing.assert_array_equal(np.load(str(tmp_path / "c" / "evaluation_results.npz"))["embeds"],
                                  a["embeds"])


@pytest.mark.parametrize("name", ["evaluate_single_label", "evaluate_multilabel",
                                  "train_eval_single_label", "train_eval_multilabel"])
def test_arrays_need_a_device(name):
    """There is no default device: an array with no device raises rather than
    being scored on the CPU beside an idle card; 'cpu' asks for the CPU."""
    multilabel = name.endswith("multilabel")
    emb, lab = _multilabel() if multilabel else _single_label()
    fn = getattr(test_cli if name.startswith("evaluate") else tm, name)
    with pytest.raises(ValueError, match="need a device"):
        fn(emb, lab)
    with pytest.raises(ValueError, match="need a device"):
        tm.on_device(emb)
    assert tm.on_device(emb, "cpu").dtype == torch.float32
    t = torch.from_numpy(emb).double()
    assert tm.on_device(t).device == t.device and tm.on_device(t).dtype == torch.float32
    assert fn(emb, lab, device="cpu") == fn(torch.from_numpy(emb), lab)


def _query_results(multilabel, seed=0):
    rng = np.random.default_rng(seed)
    results = []
    for _ in range(12):
        if multilabel:
            label = lambda: (rng.random(6) < 0.4).astype(float).tolist()  # noqa: E731
        else:
            label = lambda: int(rng.integers(0, 3))  # noqa: E731
        results.append({"query_path": "q", "query_label": label(),
                        "results": [{"id": i, "label": label()} for i in range(25)]})
    return results


@pytest.mark.parametrize("multilabel", [False, True])
def test_evaluate_query_equals_jax_package(tmp_path, multilabel):
    results = _query_results(multilabel)
    out = evaluate_query.evaluate_query_results(results, 0.3, (1, 5, 10, 20, 50))
    assert out == jax_evaluate_query.evaluate_query_results(results, 0.3, (1, 5, 10, 20, 50))
    path, dst = str(tmp_path / "r.json"), str(tmp_path / "m.json")
    json.dump(results, open(path, "w"))
    cli = evaluate_query.main(["--results", path, "--k-values", "1,5", "--output", dst])
    assert cli == jax_evaluate_query.main(["--results", path, "--k-values", "1,5"])
    assert json.load(open(dst)) == cli and set(cli) == {"mAP", "P@1", "R@1", "P@5", "R@5"}
