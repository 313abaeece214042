"""Main-path step 4 in the port (SBSM saliency, insertion / deletion) against
the JAX package: the blur, the masks, the ranks, the metric primitives, SBSM
and the causal scores on a narrow DenseNet121 and a narrow ConvNeXtV2, the
reference's insertion / deletion golden, and the two saliency CLIs on
synthetic data and the same weights. Inputs are made with numpy from a
seed."""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_models import (
    NARROW,
    NARROW_CONVNEXT,
    JaxNarrowConvNeXt,
    JaxNarrowEmbedder,
    randomized,
)
from xmir_tpu.cli import common as jax_common
from xmir_tpu.cli import compute_saliency as jax_compute_saliency
from xmir_tpu.cli import evaluate_saliency as jax_evaluate_saliency
from xmir_tpu.metrics import saliency as jax_saliency
from xmir_tpu.models import registry as jax_registry
from xmir_tpu.ops import blur as jax_blur
from xmir_tpu.xai import causal as jax_causal
from xmir_tpu.xai import sbsm as jax_sbsm
from xmir_tpu_torch.cli import compute_saliency, evaluate_saliency
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.metrics import saliency
from xmir_tpu_torch.models import convert, registry
from xmir_tpu_torch.models.embedders import ConvNeXtV2Embedder, DenseNet121Embedder
from xmir_tpu_torch.ops import blur
from xmir_tpu_torch.train import make_embed_fn
from xmir_tpu_torch.xai import causal, sbsm

torch.set_num_threads(1)

TOL = 1e-5  # the port against the JAX functions, f32 (maps, scores, AUCs)
SIZE = 64


def _images(b, seed, size=SIZE):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("klen,nsig", [(51, 50 ** 0.5), (11, 2.0)])
def test_blur_matches_jax(klen, nsig):
    """gkern equal to the original; the blur of preprocessed (unit-scale)
    images within 1e-6 of their largest magnitude (2601 terms a sum, in
    another order)."""
    np.testing.assert_array_equal(blur.gkern(klen, nsig), jax_blur.gkern(klen, nsig))
    x = _images(2, seed=1, size=40) + 0.5
    want = np.asarray(jax_blur.gaussian_blur(jnp.asarray(x), klen, nsig))
    got = blur.gaussian_blur(torch.from_numpy(x), klen, nsig)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * np.abs(x).max(), rtol=0)


@pytest.mark.parametrize("size,window,stride", [(64, 16, 8), (224, 24, 5), ((30, 40), 7, 3)])
def test_generate_masks_equal_the_original(size, window, stride):
    np.testing.assert_array_equal(sbsm.generate_masks(size, window, stride),
                                  jax_sbsm.generate_masks(size, window, stride))


@pytest.mark.parametrize("kind", ["ties", "floats", "constant"])
def test_saliency_rank_is_bit_equal(kind):
    """The stable ascending sort reversed: among ties the highest flat index
    ranks first, as the JAX function (and the reference's argsort + flip)."""
    rng = np.random.default_rng(3)
    e = {"ties": rng.integers(0, 5, (12, 13)).astype(np.float32),
         "floats": rng.standard_normal((16, 16)).astype(np.float32),
         "constant": np.zeros((7, 9), np.float32)}[kind]
    got = causal.saliency_rank(torch.from_numpy(e))
    want = np.asarray(jax_causal.saliency_rank(jnp.asarray(e)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert sorted(got.tolist()) == list(range(e.size))


def test_metric_primitives_equal_the_original():
    rng = np.random.default_rng(4)
    for _ in range(5):
        arr = rng.standard_normal(int(rng.integers(2, 60)))
        assert saliency.auc(arr) == jax_saliency.auc(arr)
        got, n = saliency.clip_scores(arr)
        want, wn = jax_saliency.clip_scores(arr)
        np.testing.assert_array_equal(got, want)
        assert n == wn
    for d, i in ((0.5, 0.8), (0.7, 0.8), (0.5, 0.6)):
        assert saliency.saliency_quality(d, i) == jax_saliency.saliency_quality(d, i)


def _densenet_pair():
    model = JaxNarrowEmbedder()
    variables = randomized(model.init(jax.random.PRNGKey(2), jnp.zeros((1, SIZE, SIZE, 3))), 5)
    port = DenseNet121Embedder(12, 3, **NARROW)
    port.load_state_dict(convert.densenet_state_dict_from_jax(variables), strict=True)
    return model, variables, port.eval()


def _convnext_pair():
    model = JaxNarrowConvNeXt(kind="plain", embedding_dim=16)
    variables = randomized(model.init(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 3))), 6)
    port = ConvNeXtV2Embedder(16, **NARROW_CONVNEXT)
    port.load_state_dict(convert.convnextv2_state_dict_from_jax(variables), strict=True)
    return model, variables, port.eval()


PAIRS = {"densenet121": _densenet_pair, "convnextv2": _convnext_pair}


def _embed_fns(name):
    """(JAX embed_fn(variables, x), its variables, the port's embed_fn(x))."""
    model, variables, port = PAIRS[name]()

    def jax_embed(v, x):
        return model.apply(v, x)["embedding"]

    return jax_embed, variables, make_embed_fn(port)


@pytest.mark.parametrize("name", list(PAIRS))
def test_sbsm_matches_jax(name):
    """Self and pair SBSM maps within 1e-5 of the JAX functions (81 masks of a
    16-pixel window at stride 8, chunks of 32: the last one padded)."""
    jembed, variables, embed = _embed_fns(name)
    x = _images(2, seed=7)
    xq = _images(1, seed=8)
    masks = sbsm.generate_masks(SIZE, 16, 8)
    want = np.asarray(jax_sbsm.sbsm_self_saliency(jembed, variables, jnp.asarray(x),
                                                  jnp.asarray(masks), chunk=32))
    got = sbsm.sbsm_self_saliency(embed, torch.from_numpy(x), torch.from_numpy(masks), chunk=32)
    assert got.shape == (2, SIZE, SIZE) and (got >= 0).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    want = np.asarray(jax_sbsm.sbsm_pair_saliency(jembed, variables, jnp.asarray(xq),
                                                  jnp.asarray(x), jnp.asarray(masks), chunk=32))
    got = sbsm.sbsm_pair_saliency(embed, torch.from_numpy(xq), torch.from_numpy(x),
                                  torch.from_numpy(masks), chunk=32)
    assert got.shape == (1, 2, SIZE, SIZE)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name", list(PAIRS))
def test_causal_scores_match_jax(name):
    """causal_scores and causal_scores_batch within 1e-5 of the JAX
    functions (17 reveal slots of 256 pixels, chunks that pad); the
    both-curves run's AUCs within 1e-5 and its zero-clip counts equal."""
    jembed, variables, embed = _embed_fns(name)
    rng = np.random.default_rng(9)
    r = _images(2, seed=10)
    q = _images(1, seed=11)[0]
    expl = rng.random((2, SIZE, SIZE)).astype(np.float32)
    sub = blur.gaussian_blur(torch.from_numpy(r)).numpy()
    ranks = np.stack([np.asarray(jax_causal.saliency_rank(jnp.asarray(e))) for e in expl])
    q_feat = np.asarray(jembed(variables, jnp.asarray(q[None]))[0])
    want = np.asarray(jax_causal.causal_scores(
        jembed, variables, jnp.asarray(q_feat), jnp.asarray(r[0]), jnp.asarray(sub[0]),
        jnp.asarray(ranks[0]), 256, 5))
    got = causal.causal_scores(embed, torch.from_numpy(q_feat), torch.from_numpy(r[0]),
                               torch.from_numpy(sub[0]), torch.from_numpy(ranks[0]), 256, 5)
    assert got.shape == (17,)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    want = np.asarray(jax_causal.causal_scores_batch(
        jembed, variables, jnp.asarray(q_feat), jnp.asarray(sub), jnp.asarray(r),
        jnp.asarray(ranks), 256, 3))
    got = causal.causal_scores_batch(embed, torch.from_numpy(q_feat), torch.from_numpy(sub),
                                     torch.from_numpy(r), torch.from_numpy(ranks), 256, 3)
    assert got.shape == (2, 17)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    subs = (jax_causal.zeros_substrate, jax_causal.blur_substrate())
    jd, ji = jax_causal.run_causal_metric_pairs_both(
        jembed, variables, jnp.asarray(q), jnp.asarray(r), list(expl), *subs, step=256)
    td, ti = causal.run_causal_metric_pairs_both(
        embed, torch.from_numpy(q), torch.from_numpy(r), list(expl), causal.zeros_substrate,
        causal.blur_substrate(), step=256)
    for (a, za), (b, zb) in zip(td + ti, jd + ji):
        assert abs(a - b) <= TOL and za == zb and 0.0 <= a <= 1.0


def test_auto_batch_steps_keeps_the_rule():
    for hw, step, p_n in ((50176, 1000, 10), (50176, 224, 2), (4096, 256, 3), (100, 7, 1),
                          (50176, 1000, 13)):
        assert causal.auto_batch_steps(hw, step, p_n) == jax_causal.auto_batch_steps(hw, step,
                                                                                      p_n)


def test_insdel_golden_replayed():
    """run_causal_metric against the reference CausalMetric.single_run's AUC
    and zero-clip count on a fixed linear embedder, replayed as
    tests/test_reference_parity.py replays it for the JAX package."""
    with open("tests/fixtures/reference_insdel_golden.json") as f:
        golden = json.load(f)
    size, step = golden["inputs"]["size"], golden["inputs"]["step"]
    rng = np.random.default_rng(golden["inputs"]["seed"])
    w = rng.standard_normal((8, 3 * size * size)).astype(np.float32) * 0.1
    query = rng.standard_normal((1, 3, size, size)).astype(np.float32)
    retrieved = 0.8 * query + 0.35 * rng.standard_normal((1, 3, size, size)).astype(np.float32)
    sal = rng.random((1, size, size)).astype(np.float32)
    wt = torch.from_numpy(w)

    def embed_fn(imgs):  # the reference flattens channel-first
        return imgs.permute(0, 3, 1, 2).reshape(imgs.shape[0], -1) @ wt.T

    q = torch.from_numpy(np.transpose(query[0], (1, 2, 0)).copy())
    r = torch.from_numpy(np.transpose(retrieved[0], (1, 2, 0)).copy())
    for mode, substrate in (("del", causal.zeros_substrate),
                            ("ins", causal.blur_substrate(golden["inputs"]["klen"],
                                                          golden["inputs"]["nsig"]))):
        auc_val, zeros, _ = causal.run_causal_metric(embed_fn, q, r, sal[0], mode, substrate,
                                                     step=step)
        np.testing.assert_allclose(auc_val, golden["results"][mode]["auc"], rtol=1e-5,
                                   err_msg=mode)
        assert zeros == golden["results"][mode]["zero_clips"], mode


# --- the CLIs ------------------------------------------------------------------------


@pytest.fixture
def narrow_densenet(monkeypatch):
    """--model densenet121 with the narrow backbone at 64 px in both packages,
    and the JAX gallery search on its interpret path."""
    spec = dataclasses.replace(registry.get_spec("densenet121"), input_size=SIZE,
                               resize_size=SIZE, kwargs=tuple(sorted(NARROW.items())))
    monkeypatch.setitem(registry._SPECS, "densenet121", spec)
    jax_registry.get_spec("densenet121")  # fills the JAX registry's cache
    jax_spec = dataclasses.replace(jax_registry.get_spec("densenet121"),
                                   builder=JaxNarrowEmbedder, input_size=SIZE, resize_size=SIZE)
    monkeypatch.setitem(jax_registry._SPEC_CACHE, "densenet121", jax_spec)
    monkeypatch.setenv("XMIR_GALLERY_PALLAS", "interpret")
    return monkeypatch


def _jax_weights_as_pt(path):
    """The weights the JAX CLIs draw for this model and --seed 0, as a .pt the
    port's --resume loads."""
    args = jax_common.argparse.Namespace(model="densenet121", embedding_dim=12, seed=0,
                                         resume="", num_labels=3, image_size=None)
    _, _, variables = jax_common.build_model(args)
    torch.save(convert.densenet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                           variables)), path)


# the CLIs run each package's narrow DenseNet121 at the JAX init, whose
# embeddings the two stacks compute within ~1e-4 (ROADMAP.md section 3); a map
# is a difference of distances (4.4e-5 apart seen) and an AUC a mean of
# cosines (1.4e-4 seen)
CLI_TOL = 2e-4


def test_saliency_clis_match_the_jax_clis(tmp_path, narrow_densenet):
    """cli.test --save-dir, then cli.compute_saliency --results (pair mode)
    and cli.evaluate_saliency --saliency-dir, against the JAX package's
    compute_saliency and evaluate_saliency on the same artifact, synthetic
    data and weights: maps within CLI_TOL, and from the same maps the same
    retrieved ids, AUCs within CLI_TOL, the same keys; the port's inline
    maps give its saved maps' AUCs; its self mode writes one map an image;
    --skip-existing resumes."""
    pt = str(tmp_path / "w.pt")
    _jax_weights_as_pt(pt)
    common = ["--dataset", "synthetic", "--model", "densenet121", "--embedding-dim", "12",
              "--num-labels", "3", "--seed", "0"]
    xai = ["--window-size", "16", "--stride", "8", "--gpu-batch", "32", "--top-k", "3",
           "--limit", "2"]
    port = common + ["-j", "2", "--device", "cpu", "--resume", pt]
    test_cli.main(port + ["--save-dir", str(tmp_path / "res"), "--eval-batch-size", "32"])
    results = str(tmp_path / "res" / "evaluation_results.npz")
    jmaps, maps = tmp_path / "jmaps", tmp_path / "maps"
    jax_compute_saliency.main(common + ["-j", "2"] + xai + ["--results", results,
                                                           "--save-dir", str(jmaps)])
    assert compute_saliency.main(port + xai + ["--results", results,
                                               "--save-dir", str(maps)]) == 2
    names = sorted(p.name for p in jmaps.iterdir())
    assert len(names) == 6 and names == sorted(p.name for p in maps.iterdir())
    for n in names:
        got, want = np.load(maps / n), np.load(jmaps / n)
        assert got.shape == (SIZE, SIZE) and (got >= 0).all()
        np.testing.assert_allclose(got, want, atol=CLI_TOL, rtol=0)

    ins = ["--step", "256", "--top-k", "3", "--limit", "2"]
    jout, out, inline = (str(tmp_path / f"{n}.json") for n in ("j", "p", "inline"))
    jax_evaluate_saliency.main(common + ins + ["--saliency-dir", str(jmaps), "--output", jout])
    got = evaluate_saliency.main(port + ins + ["--saliency-dir", str(jmaps), "--output", out])
    with open(jout) as f:
        want = json.load(f)
    with open(out) as f:
        assert json.load(f) == got
    assert got.keys() == want.keys() == {"results", "summary"}
    assert got["summary"].keys() == want["summary"].keys()
    assert len(got["results"]) == len(want["results"]) == 2
    for r, w in zip(got["results"], want["results"]):
        assert r.keys() == w.keys() and r["retrieved"] == w["retrieved"]
        assert r["query_label"] == w["query_label"]
        for key in ("deletion_auc", "insertion_auc"):
            assert abs(r[key] - w[key]) <= CLI_TOL and 0 <= r[key] <= 1
        np.testing.assert_allclose(r["per_pair_del"] + r["per_pair_ins"],
                                   w["per_pair_del"] + w["per_pair_ins"], atol=CLI_TOL, rtol=0)
    own = evaluate_saliency.main(port + ins + ["--saliency-dir", str(maps),
                                               "--output", str(tmp_path / "own.json")])
    # inline saliency (the default explainer, computed on the fly) equals the saved maps'
    evaluate_saliency.main(port + ins + xai[:6] + ["--output", inline])
    with open(inline) as f:
        on_the_fly = json.load(f)["results"]
    for r, s in zip(own["results"], on_the_fly):
        np.testing.assert_allclose(r["per_pair_del"] + r["per_pair_ins"],
                                   s["per_pair_del"] + s["per_pair_ins"], atol=1e-6, rtol=0)
    # --skip-existing keeps the evaluated queries and adds the rest
    again = evaluate_saliency.main(port + xai[:6] + ["--step", "256", "--top-k", "3",
                                                     "--limit", "3", "--output", inline,
                                                     "--skip-existing"])
    assert [r["query_index"] for r in again["results"]] == [0, 1, 2]
    assert again["results"][:2] == on_the_fly

    # self mode: one map an image of the split, up to --limit
    count = compute_saliency.main(port + ["--window-size", "16", "--stride", "8",
                                          "--gpu-batch", "32", "--eval-batch-size", "4",
                                          "--limit", "4", "--save-dir", str(tmp_path / "self")])
    assert count == 4
    assert sorted(p.name for p in (tmp_path / "self").iterdir()) == [
        f"sal_{i:06d}.npy" for i in range(4)]


@pytest.mark.parametrize("flag,match", [(["--explainer", "simatt"], "item 3"),
                                        (["--explainer", "gradcam_sim"], "item 7"),
                                        (["--use-mesh"], "item 11")])
def test_saliency_clis_refuse_what_waits(flag, match):
    for main in (compute_saliency.main, evaluate_saliency.main):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md, section 1 {match}"):
            main(["--dataset", "synthetic", "--device", "cpu", *flag])
