"""The port's saliency variants (xai/variants.py: the masked-query and
feature SBSM, the probes and FSal, FSalGrad, SimScoreCAM) against the JAX
package's on the same numpy inputs, through the narrow DenseNet121 of
tests/test_torch_xai.py at 64 px. Tier 1: CPU only; a full-width MedSigLIP
tower runs them on the card (chip_smoke.py).

Tolerances: maps within 1e-5 of their largest magnitude, or for maps of
distance increases of the size of the vectors compared (f32; the stacks sum
in other orders); SimScoreCAM within 1e-4 of its largest value (its weights
are min-max normalised distance increases); the probes' probabilities equal
(both are scikit-learn's)."""
from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_siglip_xai import _close
from test_torch_xai import _embed_fns, _images
from test_torch_xai_explainers import _fns
from xmir_tpu.xai import variants as jax_variants
from xmir_tpu.xai.sbsm import generate_masks
from xmir_tpu_torch.xai import variants

# --- the saliency variants ----------------------------------------------------


SIZE = 64
MASKS = generate_masks(SIZE, 24, 12)
# one narrow DenseNet121 pair for the module: the JAX functions compile once
_embed_pair = functools.lru_cache(maxsize=None)(lambda: _embed_fns("densenet121"))
_feature_pair = functools.lru_cache(maxsize=None)(lambda: _fns("densenet121"))


def test_gaussian_blur_and_transform_query_match_jax():
    x = _images(2, seed=6)
    region = (np.random.default_rng(7).random((2, SIZE, SIZE)) > 0.5).astype(np.float32)
    for sigma in (8.0, 2.5):
        _close(variants.gaussian_blur_normed(torch.from_numpy(x), sigma),
               jax_variants.gaussian_blur_normed(jnp.asarray(x), sigma))
    for mode in ("mask", "blur"):
        _close(variants.transform_query(torch.from_numpy(x), torch.from_numpy(region), mode, 4.0),
               jax_variants.transform_query(jnp.asarray(x), jnp.asarray(region), mode, 4.0))
    with pytest.raises(ValueError, match="unsupported mode"):
        variants.transform_query(torch.from_numpy(x), torch.from_numpy(region), "other")


@pytest.mark.parametrize("mode", ["mask", "blur"])
def test_sbsm_masked_query_saliency_matches_jax(mode):
    jax_embed, jvars, embed = _embed_pair()
    xq, x = _images(1, seed=8), _images(1, seed=9)
    region = np.zeros((1, SIZE, SIZE), np.float32)
    region[:, 8:40, 16:56] = 1.0
    want = jax_variants.sbsm_masked_query_saliency(jax_embed, jvars, jnp.asarray(xq),
                                                   jnp.asarray(x), jnp.asarray(MASKS),
                                                   jnp.asarray(region), mode, 4.0, chunk=16)
    got = variants.sbsm_masked_query_saliency(embed, torch.from_numpy(xq), torch.from_numpy(x),
                                              torch.from_numpy(MASKS), torch.from_numpy(region),
                                              mode, 4.0, chunk=16)
    _close(got, want, scale=1.0)  # distances of unit embeddings


def test_sbsm_feature_saliency_and_sim_score_cam_match_jax():
    """SBSMFeature and SimScoreCAM on the narrow DenseNet121's last feature
    map (chunks of 16 channels, the last padded); SimScoreCAM's weights are
    min-max normalised distance increases, so it is held to 1e-4 of its
    largest value."""
    jax_embed, jvars, embed = _embed_pair()
    jax_features, _, features, _, _ = _feature_pair()
    xq, x = _images(1, seed=10), _images(1, seed=11)
    want = jax_variants.sbsm_feature_saliency(jax_embed, jvars, jax_features, jnp.asarray(xq),
                                              jnp.asarray(x), jnp.asarray(MASKS))
    got = variants.sbsm_feature_saliency(embed, features, torch.from_numpy(xq),
                                         torch.from_numpy(x), torch.from_numpy(MASKS))
    # distances of mean feature vectors, each a mean over 4096 pixels
    _close(got, want, scale=float(np.linalg.norm(np.asarray(jax_features(jnp.asarray(xq))).mean(
        axis=(1, 2)))))
    want = jax_variants.sim_score_cam(jax_embed, jvars, jax_features, jnp.asarray(xq),
                                      jnp.asarray(x), chunk=16)
    got = variants.sim_score_cam(embed, features, torch.from_numpy(xq), torch.from_numpy(x),
                                 chunk=16)
    # the channels' distance increases, min-max normalised: 1e-4 of the map
    _close(got, want, tol=1e-4)
    assert (got >= 0).all()


def _probe_data(seed, d=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((10, d)) + 0.5).astype(np.float32), \
        (rng.standard_normal((10, d)) - 0.5).astype(np.float32)


@pytest.mark.parametrize("mode", ["logistic_reg", "knn", "svm"])
def test_probe_and_fsal_match_jax(mode):
    """The probes are scikit-learn's in both packages: equal probabilities;
    FSal's maps within 1e-5 (the probabilities of embeddings within ~1e-6)."""
    pos, neg = _probe_data(12)
    probe, jprobe = variants.ProbeClassifier(mode), jax_variants.ProbeClassifier(mode)
    for p in (probe, jprobe):
        np.random.seed(0)  # NuSVC's probability calibration draws from numpy's global state
        p.fit(pos, neg)
    assert np.array_equal(probe.prob_pos(pos), jprobe.prob_pos(pos))
    jax_embed, jvars, embed = _embed_pair()
    x = _images(2, seed=13)
    with torch.no_grad():
        feats = embed(torch.from_numpy(x)).numpy()
    # a probe whose positives lie near the images' own embeddings
    rng = np.random.default_rng(14)
    probe.fit(feats[:1] + 0.01 * rng.standard_normal((6, feats.shape[1])),
              feats[1:] + 0.3 * rng.standard_normal((6, feats.shape[1])))
    want = jax_variants.fsal_saliency(jax_embed, jvars, jnp.asarray(x), MASKS, probe, chunk=16)
    got = variants.fsal_saliency(embed, torch.from_numpy(x), torch.from_numpy(MASKS), probe,
                                 chunk=16)
    assert got.shape == (2, SIZE, SIZE)
    _close(got, want)
    with pytest.raises(ValueError, match="invalid classifier"):
        variants.ProbeClassifier("tree")


def test_fsal_grad_saliency_matches_jax():
    """FSalGrad through the narrow DenseNet121's feature head, with a fitted
    scikit-learn logistic regression and with a seeded stand-in that carries
    only coef_ and intercept_ (the card's machine has no scikit-learn)."""
    jax_features, jax_head, features, head, _ = _feature_pair()
    x = _images(2, seed=15)
    with torch.no_grad():
        emb = head(features(torch.from_numpy(x))).numpy()
    rng = np.random.default_rng(16)
    probe = variants.ProbeClassifier().fit(emb + 0.1 * rng.standard_normal(emb.shape),
                                           -emb + 0.1 * rng.standard_normal(emb.shape))
    stand_in = type("Probe", (), {})()
    stand_in.clf = type("Clf", (), {"coef_": rng.standard_normal((1, emb.shape[1])),
                                    "intercept_": np.asarray([0.3])})()
    for p in (probe, stand_in):
        want = jax_variants.fsal_grad_saliency(jax_features, jax_head, p, jnp.asarray(x))
        got = variants.fsal_grad_saliency(features, head, p, torch.from_numpy(x))
        _close(got, want)
