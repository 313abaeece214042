"""The port's losses (xmir_tpu_torch/losses) against the JAX package's on the
same numpy inputs, values and gradients with respect to the embeddings, and
against the reference's own numbers in
tests/fixtures/reference_losses_golden.json (as tests/test_reference_parity.py
reads them). Tier 1: CPU only, f32.

Tolerances: values and gradients 1e-5 (absolute plus relative: the two stacks
sum in other orders); the golden values at the JAX tests' own 2e-5 relative.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu import losses as jl
from xmir_tpu_torch import losses as tl

TOL = 1e-5
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "reference_losses_golden.json")


def _single(n=24, d=16, seed=0, classes=3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, d)).astype(np.float32) * 0.5
    labels = (np.arange(n) % classes).astype(np.int64)
    return centers[labels] + rng.standard_normal((n, d)).astype(np.float32) * 0.8, labels


def _multi(n=24, c=10, d=16, seed=1):
    rng = np.random.default_rng(seed)
    labels = (rng.random((n, c)) < 0.2).astype(np.float32)
    labels[np.arange(n), rng.integers(0, c, n)] = 1.0
    labels[3] = 0.0  # an anchor with no label at all: no positive, all negatives
    return rng.standard_normal((n, d)).astype(np.float32), labels


def _scalar(out):
    """The loss of a (loss, aux) pair or of a bare loss."""
    return out[0] if isinstance(out, tuple) else out


# name -> (port function, JAX function, inputs kind, kwargs)
CASES = {
    "batch_all": (tl.batch_all_triplet_loss, jl.batch_all_triplet_loss, "single",
                  dict(margin=0.5)),
    "batch_all_p1": (tl.batch_all_triplet_loss, jl.batch_all_triplet_loss, "single",
                     dict(margin=0.5, p=1.0)),
    "batch_hard": (tl.batch_hard_triplet_loss, jl.batch_hard_triplet_loss, "single",
                   dict(margin=0.5)),
    "supcon_single": (tl.supcon_loss, jl.supcon_loss, "single", dict(temperature=0.1)),
    "supcon_multi": (tl.supcon_loss, jl.supcon_loss, "multi", {}),
    "weighted_multilabel_triplet": (tl.weighted_multilabel_triplet_loss,
                                    jl.weighted_multilabel_triplet_loss, "multi",
                                    dict(margin=0.3)),
    "jaccard_supcon": (tl.jaccard_supcon_loss, jl.jaccard_supcon_loss, "multi", {}),
    "multilabel_contrastive": (tl.multilabel_contrastive_loss, jl.multilabel_contrastive_loss,
                               "multi", {}),
    "multilabel_contrastive_unweighted": (
        tl.multilabel_contrastive_loss, jl.multilabel_contrastive_loss, "multi",
        dict(use_jaccard_weight=False)),
    "asymmetric": (tl.asymmetric_loss, jl.asymmetric_loss, "logits", {}),
    "asymmetric_no_focus": (tl.asymmetric_loss, jl.asymmetric_loss, "logits",
                            dict(gamma_pos=0.0, gamma_neg=0.0, clip=0.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradient_match_jax(name):
    port_fn, jax_fn, kind, kw = CASES[name]
    if kind == "single":
        x, labels = _single()
    else:
        x, labels = _multi(d=10 if kind == "logits" else 16)
    want, want_grad = jax.value_and_grad(
        lambda e: _scalar(jax_fn(e, jnp.asarray(labels), **kw)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port_fn(xt, torch.from_numpy(labels), **kw)
    got = _scalar(out)
    got.backward()
    assert float(want) != 0.0
    np.testing.assert_allclose(got.item(), float(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), atol=TOL, rtol=TOL)
    if isinstance(out, tuple):
        np.testing.assert_allclose(out[1].item(), float(jax_fn(jnp.asarray(x), jnp.asarray(labels),
                                                               **kw)[1]), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("p", [2.0, 1.0, 3.0])
def test_pairwise_distance_and_helpers_match_jax(p):
    x, labels = _multi()
    got = tl.pairwise_distance(torch.from_numpy(x), p).numpy()
    want = np.asarray(jl.pairwise_distance(jnp.asarray(x), p))
    off = ~np.eye(len(x), dtype=bool)
    np.testing.assert_allclose(got[off], want[off], atol=TOL, rtol=TOL)
    # p = 2 takes |a|^2 + |b|^2 - 2 a.b: on the diagonal an f32 residue of a
    # few 1e-6 (or exactly 0, by the sums' order) stands under the root
    assert np.abs(np.diag(got)).max() <= 5e-3 and np.abs(np.diag(want)).max() <= 5e-3
    np.testing.assert_allclose(tl.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.l2_normalize(jnp.asarray(x))), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tl.jaccard_similarity(torch.from_numpy(labels)).numpy(),
                               np.asarray(jl.jaccard_similarity(jnp.asarray(labels))), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("name", ["batch_all", "batch_hard", "weighted_multilabel_triplet"])
def test_duplicate_rows_give_finite_gradients(name):
    """Two equal embeddings are at distance 0, where sqrt has no gradient:
    the safe sqrt gives 0 there, not NaN, and the result is the JAX
    package's."""
    port_fn, jax_fn, kind, kw = CASES[name]
    x, labels = _single() if kind == "single" else _multi()
    x[5] = x[2]
    x[7] = x[2]
    xt = torch.from_numpy(x).requires_grad_(True)
    _scalar(port_fn(xt, torch.from_numpy(labels), **kw)).backward()
    assert torch.isfinite(xt.grad).all()
    want = jax.grad(lambda e: _scalar(jax_fn(e, jnp.asarray(labels), **kw)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_no_valid_anchor_gives_zero():
    """One label for every sample: no negative, no valid triplet or anchor."""
    x, _ = _single()
    labels = torch.zeros(24, dtype=torch.int64)
    multi = torch.ones((24, 3))
    xt = torch.from_numpy(x)
    assert tl.batch_all_triplet_loss(xt, labels)[0].item() == 0.0
    assert tl.weighted_multilabel_triplet_loss(xt, multi)[0].item() == 0.0
    assert tl.supcon_loss(xt, torch.arange(24)).item() == 0.0
    assert tl.jaccard_supcon_loss(xt, torch.eye(24)).item() == 0.0
    assert tl.multilabel_contrastive_loss(xt, torch.eye(24)).item() == 0.0


def test_dual_branch_and_hash_match_jax():
    x, labels = _multi()
    logits = np.random.default_rng(5).standard_normal(labels.shape).astype(np.float32)
    want, want_parts = jl.dual_branch_multilabel_loss(
        {"embedding": jnp.asarray(x), "logits": jnp.asarray(logits)}, jnp.asarray(labels),
        alpha=0.7)
    got, parts = tl.dual_branch_multilabel_loss(
        {"embedding": torch.from_numpy(x), "logits": torch.from_numpy(logits)},
        torch.from_numpy(labels), alpha=0.7)
    np.testing.assert_allclose(got.item(), float(want), atol=TOL, rtol=TOL)
    for key in ("contrastive", "asl"):
        np.testing.assert_allclose(parts[key].item(), float(want_parts[key]), atol=TOL, rtol=TOL)
    a, p, n = (np.random.default_rng(s).standard_normal((8, 48)).astype(np.float32)
               for s in (6, 7, 8))
    np.testing.assert_allclose(
        tl.triplet_hash_loss(*(torch.from_numpy(t) for t in (a, p, n)), margin=0.5).item(),
        float(jl.triplet_hash_loss(*(jnp.asarray(t) for t in (a, p, n)), margin=0.5)),
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dataset,model,want", [
    ("covid", None, "triplet"), ("nih", "densenet121", "jaccard_supcon"),
    ("vindr", "dinov2", "weighted_multilabel_triplet"), ("vindr", "conceptclip", "conceptclip")])
def test_auto_select_loss_matches_jax(dataset, model, want):
    assert tl.auto_select_loss(dataset, model) == jl.auto_select_loss(dataset, model) == want


# --- the reference's own numbers ---------------------------------------------


def _golden_inputs():
    """The inputs of tests/test_reference_parity.py::TestLossParity."""
    rng = np.random.default_rng(12345)
    centers = rng.standard_normal((3, 32)).astype(np.float32) * 2.5
    lab_s = np.arange(60) % 3
    emb_s = centers[lab_s] + rng.standard_normal((60, 32)).astype(np.float32) * 0.8
    emb_s /= np.linalg.norm(emb_s, axis=1, keepdims=True)
    rng = np.random.default_rng(777)
    lab_m = (rng.random((24, 14)) < 0.18).astype(np.float32)
    lab_m[np.arange(24), rng.integers(0, 14, 24)] = 1.0
    proto = rng.standard_normal((14, 32)).astype(np.float32)
    emb_m = (lab_m @ proto + rng.standard_normal((24, 32)).astype(np.float32) * 0.6)
    rng = np.random.default_rng(99)
    logits = rng.standard_normal((24, 14)).astype(np.float32)
    # the align losses' inputs, drawn there between the logits and the hashes
    for shape in [(6, 16), (6, 16), (6, 49, 16)] + [(w, 16) for w in (3, 2, 5, 1, 4)]:
        rng.standard_normal(shape)
    hashes = [rng.standard_normal((8, 48)).astype(np.float32) for _ in range(3)]
    t = torch.from_numpy
    return dict(emb_s=t(emb_s[:24] * 3.0), lab_s=t(lab_s[:24].astype(np.int64)),
                emb_m=t(emb_m.astype(np.float32)), lab_m=t(lab_m), logits=t(logits),
                hashes=[t(h) for h in hashes])


GOLDEN = {
    "triplet_batch_all": lambda i: tl.triplet_margin_loss(i["emb_s"], i["lab_s"], margin=1.0)[0],
    "triplet_batch_all_aux": lambda i: tl.triplet_margin_loss(i["emb_s"], i["lab_s"],
                                                              margin=1.0)[1],
    "triplet_batch_hard": lambda i: tl.triplet_margin_loss(i["emb_s"], i["lab_s"], margin=1.0,
                                                           mining="batch_hard")[0],
    "supcon_single": lambda i: tl.supcon_loss(i["emb_s"], i["lab_s"]),
    "supcon_multilabel": lambda i: tl.supcon_loss(i["emb_m"], i["lab_m"]),
    "weighted_multilabel_triplet": lambda i: tl.weighted_multilabel_triplet_loss(
        i["emb_m"], i["lab_m"], margin=0.3)[0],
    "jaccard_supcon": lambda i: tl.jaccard_supcon_loss(i["emb_m"], i["lab_m"]),
    "asymmetric": lambda i: tl.asymmetric_loss(i["logits"], i["lab_m"]),
    "multilabel_contrastive": lambda i: tl.multilabel_contrastive_loss(i["emb_m"], i["lab_m"]),
    "dual_branch": lambda i: tl.dual_branch_multilabel_loss(
        {"embedding": i["emb_m"], "logits": i["logits"]}, i["lab_m"])[0],
    "triplet_hash": lambda i: tl.triplet_hash_loss(*i["hashes"], margin=0.5),
}


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_loss_matches_reference_golden(key):
    """The values the reference's loss.py computed on the same inputs."""
    if not os.path.exists(FIXTURE):
        pytest.skip("missing committed fixture reference_losses_golden.json")
    with open(FIXTURE) as f:
        want = json.load(f)["values"][key]
    np.testing.assert_allclose(float(GOLDEN[key](_golden_inputs())), want, rtol=2e-5, atol=1e-6)
