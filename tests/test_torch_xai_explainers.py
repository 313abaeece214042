"""The rest of main-path step 4 in the port against the JAX package: the
feature heads, SimAtt and SimCAM on a narrow DenseNet121 and a narrow
ConvNeXtV2, attention rollout on a narrow DINOv2, both saliency CLIs with the
new explainers and cli.debug_insdel against the JAX CLIs on the same weights,
``split_txt`` against the original, and the end-to-end demo on the CPU.
Inputs are made with numpy from a seed.

Tolerances: 1e-5 of each map's largest magnitude for the functions (f32 on
both sides, sums in other orders); the CLIs within test_torch_xai.py's
CLI_TOL, where the two narrow DenseNets' embeddings already differ by ~1e-4.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import NARROW_VIT, _dinov2_pair
from test_torch_xai import (  # noqa: F401  (narrow_densenet: a fixture)
    CLI_TOL,
    SIZE,
    _convnext_pair,
    _densenet_pair,
    _images,
    _jax_weights_as_pt,
    narrow_densenet,
)
from xmir_tpu.cli import compute_saliency as jax_compute_saliency
from xmir_tpu.cli import debug_insdel as jax_debug_insdel
from xmir_tpu.cli import evaluate_saliency as jax_evaluate_saliency
from xmir_tpu.data import datasets as jax_datasets
from xmir_tpu.xai import feature_heads as jax_heads
from xmir_tpu.xai import rollout as jax_rollout
from xmir_tpu.xai import simatt as jax_simatt
from xmir_tpu.xai import simcam as jax_simcam
from xmir_tpu_torch import demo_end_to_end
from xmir_tpu_torch.cli import common, compute_saliency, debug_insdel, evaluate_saliency
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.data import datasets
from xmir_tpu_torch.models import convert, registry
from xmir_tpu_torch.xai import feature_heads, resize, rollout, simatt, simcam

torch.set_num_threads(1)

TOL = 1e-5
PAIRS = {"densenet121": _densenet_pair, "convnextv2": _convnext_pair}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol * (np.abs(want).max() or 1.0), rtol=0)


def _fns(name):
    model, variables, port = PAIRS[name]()
    port = port.eval()

    def jax_features(xs):
        return model.apply(variables, xs)["features"]

    def features(xs):
        with torch.no_grad():
            return port(xs)["features"]

    return (jax_features, jax_heads.get_feature_head(name, variables["params"]),
            features, feature_heads.get_feature_head(name, port), port)


@pytest.mark.parametrize("name", list(PAIRS))
def test_feature_heads_match_jax(name):
    """The head of the model's own feature map is the model's embedding, and
    the JAX head's within 1e-5."""
    jax_features, jax_head, features, head, port = _fns(name)
    x = _images(3, seed=20)
    f = features(torch.from_numpy(x))
    got = head(f)
    with torch.no_grad():
        _close(got.detach(), port(torch.from_numpy(x))["embedding"])
    _close(got.detach(), jax_head(jnp.asarray(f.numpy())))


def test_feature_heads_refuse_what_waits():
    """Nothing waits since the ResNet50 and tiny heads landed
    (tests/test_torch_resnet.py holds them to the JAX heads); a model
    without a feature head raises."""
    assert not hasattr(feature_heads, "WAITING_HEADS")
    assert sorted(feature_heads.FEATURE_HEADS) == ["convnextv2", "densenet121", "resnet50",
                                                   "tiny"]
    with pytest.raises(ValueError, match="no feature head"):
        feature_heads.get_feature_head("swinv2", None)


@pytest.mark.parametrize("name", list(PAIRS))
@pytest.mark.parametrize("n_pos", [1, 0])
def test_simatt_matches_jax(name, n_pos):
    """One map per image of [anchor, positive, two negatives], upsampled from
    the 2 x 2 feature map to 64 x 64, within 1e-5 of the JAX function."""
    jax_features, jax_head, features, head, _ = _fns(name)
    x = _images(4, seed=21)
    want = jax_simatt.simatt_saliency(jax_features, jax_head, jnp.asarray(x), n_pos=n_pos)
    got = simatt.simatt_saliency(features, head, torch.from_numpy(x), n_pos=n_pos)
    assert got.shape == (4, SIZE, SIZE) and (got >= 0).all()
    _close(got, want)


@pytest.mark.parametrize("name", list(PAIRS))
def test_simcam_matches_jax(name):
    """simcam_maps, simcam_decomposition and point_specific_map on the same
    feature maps within 1e-5 of the JAX functions."""
    _, _, features, _, _ = _fns(name)
    f = features(torch.from_numpy(_images(3, seed=22)))
    q, r = f[0], f[1:]
    want = jax_simcam.simcam_maps(jnp.asarray(q.numpy()), jnp.asarray(r.numpy()),
                                  out_hw=(SIZE, SIZE))
    got = simcam.simcam_maps(q, r, out_hw=(SIZE, SIZE))
    assert got.shape == (2, 2, SIZE, SIZE) and (got >= 0).all()
    _close(got, want)
    decom = simcam.simcam_decomposition(q, r[0])
    _close(decom, jax_simcam.simcam_decomposition(jnp.asarray(q.numpy()),
                                                  jnp.asarray(r[0].numpy())))
    for point in ((0, 0), (10, 50), (63, 63), (31, 5)):
        _close(simcam.point_specific_map(decom, point, (SIZE, SIZE)),
               jax_simcam.point_specific_map(jnp.asarray(decom.numpy()), point, (SIZE, SIZE)))


def test_simcam_vit_maps_match_jax():
    rng = np.random.default_rng(23)
    q, r = rng.standard_normal((16, 8)).astype(np.float32), rng.standard_normal(
        (3, 16, 8)).astype(np.float32)
    _close(simcam.simcam_vit_maps(torch.from_numpy(q), torch.from_numpy(r), (28, 28)),
           jax_simcam.simcam_vit_maps(jnp.asarray(q), jnp.asarray(r), (28, 28)))
    with pytest.raises(ValueError, match="perfect square"):
        simcam.simcam_vit_maps(torch.from_numpy(q[:15]), torch.from_numpy(r[:, :15]))


@pytest.mark.parametrize("out_hw", [(64, 64), (50, 30), (3, 5)])
def test_resize_matches_jax_image_resize(out_hw):
    m = np.random.default_rng(24).random((2, 7, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(m), (2, *out_hw), "bilinear")
    _close(resize.resize_bilinear(torch.from_numpy(m), out_hw), want,
           tol=TOL if out_hw[0] >= 7 and out_hw[1] >= 5 else 2e-2)


def _dinov2_attentions():
    model, variables, port, _ = _dinov2_pair(seed=25)
    x = _images(2, seed=26, size=56)
    jout = model.apply(variables, jnp.asarray(x), output_attentions=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x), output_attentions=True)
    return jout, out


@pytest.mark.parametrize("fusion", ["mean", "max", "min"])
@pytest.mark.parametrize("discard", [0.9, 0.0])
def test_rollout_matches_jax_on_a_narrow_dinov2(fusion, discard):
    """attention_rollout of each stack's own attention weights within 1e-5;
    the saliency with DINOv2's CLS token dropped against the JAX functions
    composed the same way; the JAX rollout_saliency itself refuses the CLS
    model's 1 + 4^2 tokens (no square grid), which the port's
    ``prefix_tokens`` default keeps."""
    jout, out = _dinov2_attentions()
    jatt = [jnp.asarray(a) for a in jout["attentions"]]
    want = jax_rollout.attention_rollout(jatt, fusion, discard)
    got = rollout.attention_rollout(out["attentions"], fusion, discard)
    assert got.shape == (2, 17, 17)
    _close(got, want)
    sal = rollout.rollout_saliency(out["attentions"], (56, 56), fusion, discard, prefix_tokens=1)
    imp = jnp.mean(want, axis=1)[:, 1:].reshape(2, 4, 4)
    _close(sal, jax.image.resize(imp, (2, 56, 56), "bilinear"))
    with pytest.raises(ValueError, match="not a perfect square"):
        jax_rollout.rollout_saliency(jatt, (56, 56), fusion, discard)
    with pytest.raises(ValueError, match="not a perfect square"):
        rollout.rollout_saliency(out["attentions"], (56, 56), fusion, discard)


def test_rollout_saliency_matches_jax_with_query_reweighting():
    """On square token grids (no CLS), with and without the query-guided
    reweighting, against the JAX function."""
    rng = np.random.default_rng(27)
    att = [rng.random((2, 3, 25, 25)).astype(np.float32) for _ in range(3)]
    att = [a / a.sum(-1, keepdims=True) for a in att]
    q, patches = rng.standard_normal(8).astype(np.float32), rng.standard_normal(
        (2, 25, 8)).astype(np.float32)
    for kwargs in ({}, {"query_embedding": q, "patch_embeddings": patches}):
        want = jax_rollout.rollout_saliency([jnp.asarray(a) for a in att], (40, 40),
                                            **{k: jnp.asarray(v) for k, v in kwargs.items()})
        got = rollout.rollout_saliency([torch.from_numpy(a) for a in att], (40, 40),
                                       **{k: torch.from_numpy(v) for k, v in kwargs.items()})
        _close(got, want)


COMMON = ["--dataset", "synthetic", "--model", "densenet121", "--embedding-dim", "12",
          "--num-labels", "3", "--seed", "0"]


@pytest.mark.parametrize("explainer", ["simatt", "simcam"])
def test_saliency_clis_match_the_jax_clis(tmp_path, narrow_densenet, explainer):
    """cli.compute_saliency (with --results for SimAtt's stacks) and
    cli.evaluate_saliency's inline maps with the new explainers against the
    JAX CLIs on the same weights and synthetic data: the same files, maps
    and AUCs within CLI_TOL."""
    pt = str(tmp_path / "w.pt")
    _jax_weights_as_pt(pt)
    port = COMMON + ["-j", "2", "--device", "cpu", "--resume", pt]
    test_cli.main(port + ["--save-dir", str(tmp_path / "res"), "--eval-batch-size", "32"])
    xai = ["--explainer", explainer, "--top-k", "2", "--limit", "2"]
    if explainer == "simatt":
        xai += ["--results", str(tmp_path / "res" / "evaluation_results.npz")]
    jmaps, maps = tmp_path / "jmaps", tmp_path / "maps"
    jax_compute_saliency.main(COMMON + ["-j", "2"] + xai + ["--save-dir", str(jmaps)])
    assert compute_saliency.main(port + xai + ["--save-dir", str(maps)]) == 2
    names = sorted(p.name for p in jmaps.iterdir())
    assert names == sorted(p.name for p in maps.iterdir()) == [
        f"{explainer}_q{i:05d}.npy" for i in range(2)]
    for n in names:
        got, want = np.load(maps / n), np.load(jmaps / n)
        assert got.shape == want.shape and np.isfinite(got).all() and (got >= 0).all()
        np.testing.assert_allclose(got, want, atol=CLI_TOL * max(1.0, np.abs(want).max()), rtol=0)

    ins = ["--explainer", explainer, "--step", "256", "--top-k", "2", "--limit", "2"]
    jout, out = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jax_evaluate_saliency.main(COMMON + ins + ["--output", jout])
    got = evaluate_saliency.main(port + ins + ["--output", out])
    with open(jout) as f:
        want = json.load(f)
    assert got["summary"].keys() == want["summary"].keys()
    for r, w in zip(got["results"], want["results"]):
        assert r["retrieved"] == w["retrieved"]
        np.testing.assert_allclose(r["per_pair_del"] + r["per_pair_ins"],
                                   w["per_pair_del"] + w["per_pair_ins"], atol=CLI_TOL, rtol=0)
        assert all(0 <= a <= 1 for a in r["per_pair_del"] + r["per_pair_ins"])


def test_rollout_clis_on_a_narrow_dinov2(tmp_path, monkeypatch):
    """--explainer rollout through both CLIs on a narrow DINOv2 (56 px): the
    saved maps are the rollout of the model's own attention with the CLS
    token dropped, as the JAX functions compute it on the same weights; the
    inline evaluation's AUCs lie in [0, 1]. (The JAX CLIs refuse any model
    with a CLS token: see test_rollout_matches_jax_on_a_narrow_dinov2.)"""
    spec = dataclasses.replace(registry.get_spec("dinov2"), input_size=56, resize_size=56,
                               kwargs=tuple(sorted(dict(NARROW_VIT, img_size=56).items())))
    monkeypatch.setitem(registry._SPECS, "dinov2", spec)
    for flag in ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_MLP"):
        monkeypatch.delenv(flag, raising=False)
    model, variables, _, _ = _dinov2_pair(seed=28)
    pt = str(tmp_path / "vit.pt")
    torch.save(convert.vit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables)),
               pt)
    args = ["--dataset", "synthetic", "--model", "dinov2", "--embedding-dim", "16", "--device",
            "cpu", "--resume", pt, "-j", "2", "--explainer", "rollout", "--limit", "2"]
    assert compute_saliency.main(args + ["--save-dir", str(tmp_path / "maps")]) == 2
    got = np.load(tmp_path / "maps" / "rollout_q00001.npy")
    assert got.shape == (1, 56, 56) and np.isfinite(got).all() and (got >= 0).all()
    # the same image through the JAX model and the JAX functions
    p = argparse.ArgumentParser()
    common.add_dataset_args(p)
    dataset = common.build_dataset(p.parse_args(["--dataset", "synthetic"]), "test")
    x = compute_saliency.image_preprocessor(spec, torch.device("cpu"))(
        dataset.load_image(1)[None]).numpy()
    jatt = model.apply(variables, jnp.asarray(x), output_attentions=True)["attentions"]
    imp = jnp.mean(jax_rollout.attention_rollout(jatt), axis=1)[:, 1:].reshape(1, 4, 4)
    np.testing.assert_allclose(got, np.asarray(jax.image.resize(imp, (1, 56, 56), "bilinear")),
                               atol=1e-5 * np.abs(got).max(), rtol=0)
    res = evaluate_saliency.main(args + ["--top-k", "2", "--step", "512", "--output",
                                         str(tmp_path / "r.json")])
    aucs = [a for r in res["results"] for a in r["per_pair_del"] + r["per_pair_ins"]]
    assert len(aucs) == 8 and all(0 <= a <= 1 for a in aucs)


def test_debug_insdel_matches_the_jax_cli(tmp_path, narrow_densenet, capsys):
    """One pair, the query's nearest neighbour found through the index: the
    same neighbour, and every printed step score and both AUCs within the
    print's 1e-4 (plus CLI_TOL) of the JAX CLI's."""
    pt = str(tmp_path / "w.pt")
    _jax_weights_as_pt(pt)
    xai = ["--query-index", "1", "--window-size", "16", "--stride", "8", "--gpu-batch", "32",
           "--step", "256"]
    jax_debug_insdel.main(COMMON + xai)
    jax_text = capsys.readouterr().out
    got = debug_insdel.main(COMMON + xai + ["--device", "cpu", "--resume", pt, "-j", "2"])
    text = capsys.readouterr().out

    def parse(t):
        return ([float(v) for v in re.findall(r"score ([+-]\d\.\d{4})", t)],
                [float(v) for v in re.findall(r"AUC (\d\.\d{4})", t)],
                re.findall(r"top-1 neighbor of query \d+: (\d+)", t))

    (js, ja, jn), (ps, pa, pn) = parse(jax_text), parse(text)
    assert jn == pn == [str(got["retrieved_index"])]
    assert len(js) == len(ps) == 2 * 17 and len(ja) == len(pa) == 2
    np.testing.assert_allclose(ps, js, atol=1e-4 + CLI_TOL, rtol=0)
    np.testing.assert_allclose(pa, ja, atol=1e-4 + CLI_TOL, rtol=0)
    np.testing.assert_allclose([got["del"]["auc"], got["ins"]["auc"]], pa, atol=1e-4, rtol=0)
    assert got["saliency"].shape == (SIZE, SIZE) and (got["saliency"] >= 0).all()


@pytest.mark.parametrize("fraction,seed", [(0.25, 42), (0.1, 7), (0.5, 0)])
def test_split_txt_equals_the_original(tmp_path, fraction, seed):
    lines = [f"p{i} img{i}.png {['normal', 'COVID-19'][i % 2]}" for i in range(37)]
    src = tmp_path / "m.txt"
    src.write_text("\n".join(lines[:20]) + "\n\n" + "\n".join(lines[20:]) + "\n")
    a = datasets.split_txt(str(src), str(tmp_path / "tr"), str(tmp_path / "va"), fraction, seed)
    b = jax_datasets.split_txt(str(src), str(tmp_path / "jtr"), str(tmp_path / "jva"), fraction,
                               seed)
    assert a == b
    for mine, theirs in (("tr", "jtr"), ("va", "jva")):
        assert (tmp_path / mine).read_text() == (tmp_path / theirs).read_text()


def test_demo_runs_on_the_cpu(tmp_path):
    """One epoch of the demo on the CPU: every stage's artifact, and a
    summary.json with the JAX demo's keys (tests/fixtures/demo_chip_run),
    finite mAPs and AUCs in [0, 1]."""
    summary = demo_end_to_end.main(["--workdir", str(tmp_path), "--device", "cpu",
                                    "--epochs", "1"])
    with open("tests/fixtures/demo_chip_run/summary.json") as f:
        keys = list(json.load(f))
    with open(tmp_path / "summary.json") as f:
        assert list(json.load(f)) == keys == list(summary)
    assert summary["platform"] == "cpu" and len(summary["eval_mAP_by_epoch"]) == 2
    assert all(np.isfinite(m) for m in summary["eval_mAP_by_epoch"])
    aucs = [a for r in summary["insdel"]["results"] for a in r["per_pair_del"] + r["per_pair_ins"]]
    assert aucs and all(0 <= a <= 1 for a in aucs)
    for name in ("gallery.npz", "hits.json", "evaluation_results.npz", "insdel.json"):
        assert (tmp_path / name).is_file()
    # --use-mesh (a world of 1 here): the saliency stage through the sharded
    # index and the fan-outs gives the same evaluation
    mesh = demo_end_to_end.main(["--workdir", str(tmp_path / "mesh"), "--device", "cpu",
                                 "--epochs", "1", "--use-mesh"])
    assert mesh["use_mesh"] is True and mesh["insdel"]["summary"]["mesh_devices"] == 1
    for r, m in zip(summary["insdel"]["results"], mesh["insdel"]["results"]):
        assert r["retrieved"] == m["retrieved"]
        np.testing.assert_allclose(r["per_pair_del"] + r["per_pair_ins"],
                                   m["per_pair_del"] + m["per_pair_ins"], atol=1e-6, rtol=0)
