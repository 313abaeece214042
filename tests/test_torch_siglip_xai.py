"""The port's SigLIP-family XAI (xai/gradcam_sim.py, xai/conceptxai.py, the
gradcam_sim branches of cli/compute_saliency.py and cli/evaluate_saliency.py,
cli/xai_conceptclip.py) against the JAX package on the same numpy inputs and
weights; the saliency variants are in tests/test_torch_siglip_variants.py.
Tier 1: CPU only, narrow models (a 288-wide two-layer SigLIP tower at 56
px, a 64-wide ConceptCLIP at 28 px); full width runs on the card
(chip_smoke.py).

Tolerances: maps within 1e-5 of their largest magnitude (f32; the stacks
sum in other orders); the CLIs' maps within 1e-4 and AUCs within 2e-4 (each
stack preprocesses the images by its own resize, as tests/test_torch_xai.py
says); conceptxai.py, a numpy copy, equal to the original bit for bit."""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_siglip import IMG, NARROW, _np, _randomized
from test_torch_xai import _images
from xmir_tpu.cli import common as jax_common
from xmir_tpu.cli import compute_saliency as jax_compute_saliency
from xmir_tpu.cli import evaluate_saliency as jax_evaluate_saliency
from xmir_tpu.cli import xai_conceptclip as jax_xai_conceptclip
from xmir_tpu.models import embedders as jax_embedders
from xmir_tpu.models import registry as jax_registry
from xmir_tpu.models import siglip as jax_siglip
from xmir_tpu.xai import conceptxai as jax_conceptxai
from xmir_tpu.xai import gradcam_sim as jax_gradcam
from xmir_tpu_torch.cli import compute_saliency, evaluate_saliency, xai_conceptclip
from xmir_tpu_torch.data import synthetic
from xmir_tpu_torch.models import convert, registry
from xmir_tpu_torch.models.embedders import MedSigLIPEmbedder
from xmir_tpu_torch.xai import conceptxai, gradcam_sim

TOL = 1e-5
CLI_TOL = 1e-4
# AUCs: means of cosines of each stack's own preprocessing (tests/test_torch_xai.py)
AUC_TOL = 2e-4
FLAGS = ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_QKV72",
         "XMIR_FUSED_LN_MLP")


def _close(got, want, tol=TOL, scale=None):
    """Within tol of ``scale``: by default the map's largest magnitude; for a
    map of distance increases the size of the vectors whose distances it
    subtracts (the increases are small beside them, and f32 sums in another
    order move each distance by ~1e-7 of it)."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = scale or np.abs(want).max() or 1.0
    np.testing.assert_allclose(got, want, atol=tol * scale, rtol=0)


@pytest.fixture
def narrow_medsiglip(monkeypatch):
    """--model medsiglip with the narrow tower at 56 px (64 px decode) in
    both packages (the JAX embedder's tower swapped, as
    tests/test_torch_siglip.py swaps it), the flags unset, and the JAX
    gallery search on its interpret path."""
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)

    def narrow(**kwargs):
        return jax_siglip.SiglipVisionBackbone(img_size=IMG, name=kwargs["name"], **NARROW)

    monkeypatch.setattr(jax_embedders, "SiglipVisionBackbone", narrow)
    spec = dataclasses.replace(registry.get_spec("medsiglip"), input_size=IMG, resize_size=64,
                               kwargs=tuple(sorted(dict(NARROW, img_size=IMG).items())))
    monkeypatch.setitem(registry._SPECS, "medsiglip", spec)
    jax_registry.get_spec("medsiglip")  # fills the JAX registry's cache
    jax_spec = dataclasses.replace(jax_registry.get_spec("medsiglip"), input_size=IMG,
                                   resize_size=64)
    monkeypatch.setitem(jax_registry._SPEC_CACHE, "medsiglip", jax_spec)
    monkeypatch.setenv("XMIR_GALLERY_PALLAS", "interpret")
    return monkeypatch


def _medsiglip_pair(seed, embed_dim=24):
    model = jax_embedders.MedSigLIPEmbedder(embed_dim=embed_dim)
    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))),
                            seed)
    port = MedSigLIPEmbedder(embed_dim, img_size=IMG, **NARROW)
    port.load_state_dict(convert.medsiglip_state_dict_from_jax(_np(variables)), strict=True)
    return model, variables, port.eval()


# --- Grad-CAM on a similarity ----------------------------------------------------


@pytest.mark.parametrize("out_hw", [None, (40, 72)], ids=["input-size", "other-size"])
def test_gradcam_similarity_matches_jax(narrow_medsiglip, out_hw):
    """vit_gradcam_similarity of a narrow MedSigLIPEmbedder through the zero
    token_delta tap: maps within 1e-5, in [0, 1], the largest 1 where a map
    is not all 0; the tap's shape from the patch grid equals the tokens'."""
    model, variables, port = _medsiglip_pair(seed=3)
    x = _images(3, seed=4, size=IMG)
    q = np.random.default_rng(5).standard_normal(24).astype(np.float32)
    want = jax_gradcam.vit_gradcam_similarity(jax_gradcam.make_vit_gradcam_fn(model), variables,
                                              jnp.asarray(q), jnp.asarray(x), out_hw=out_hw)
    apply_fn = gradcam_sim.make_vit_gradcam_fn(port)
    got = gradcam_sim.vit_gradcam_similarity(apply_fn, torch.from_numpy(q),
                                             torch.from_numpy(x), out_hw=out_hw)
    _close(got, want)
    assert got.min() >= 0 and got.max() <= 1 + 1e-6
    with torch.no_grad():
        tokens = port(torch.from_numpy(x))["encoder_tokens"]
    assert apply_fn.token_shape(torch.from_numpy(x)) == tuple(tokens.shape)


def _jax_weights_as_train_pt(path):
    """The weights the JAX CLIs draw for --model medsiglip --embedding-dim 24
    --seed 0, as a train checkpoint the port's --resume loads whole."""
    args = jax_common.argparse.Namespace(model="medsiglip", embedding_dim=24, seed=0, resume="",
                                         num_labels=None, image_size=None)
    _, _, variables = jax_common.build_model(args)
    torch.save({"state_dict": convert.medsiglip_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), "optimizer": {}}, path)


def test_gradcam_clis_match_the_jax_clis(tmp_path, narrow_medsiglip):
    """--explainer gradcam_sim through both saliency CLIs of both packages on
    the same weights and images: compute_saliency's maps (each image against
    the next) within 1e-4; evaluate_saliency's inline maps give the same
    retrieved ids and AUCs within 2e-4 of the JAX CLI's."""
    pt = str(tmp_path / "w.pt")
    _jax_weights_as_train_pt(pt)
    img_dir, manifest = synthetic.write_synthetic_covidx(str(tmp_path / "data"), n=6, size=64)
    data = ["--dataset", "covid", "--dataset-dir", img_dir, "--test-image-list", manifest,
            "--model", "medsiglip", "--embedding-dim", "24", "--seed", "0",
            "--explainer", "gradcam_sim", "--limit", "2"]
    port = data + ["--device", "cpu", "--resume", pt]
    jmaps, maps = tmp_path / "jmaps", tmp_path / "maps"
    jax_compute_saliency.main(data + ["-j", "2", "--save-dir", str(jmaps)])
    assert compute_saliency.main(port + ["-j", "2", "--save-dir", str(maps)]) == 2
    names = sorted(p.name for p in jmaps.iterdir())
    assert names == ["gradcam_q00000_r00001.npy", "gradcam_q00001_r00002.npy"]
    assert names == sorted(p.name for p in maps.iterdir())
    for n in names:
        got, want = np.load(maps / n), np.load(jmaps / n)
        assert got.shape == (IMG, IMG) and (got >= 0).all()
        np.testing.assert_allclose(got, want, atol=CLI_TOL, rtol=0)

    ins = ["--step", "256", "--top-k", "2"]
    jout, out = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    jax_evaluate_saliency.main(data + ins + ["--output", jout])
    got = evaluate_saliency.main(port + ins + ["--output", out])
    with open(jout) as f:
        want = json.load(f)
    assert len(got["results"]) == len(want["results"]) == 2
    for r, w in zip(got["results"], want["results"]):
        assert r["retrieved"] == w["retrieved"]
        for key in ("deletion_auc", "insertion_auc"):
            assert 0 <= r[key] <= 1
            np.testing.assert_allclose(r[key], w[key], atol=AUC_TOL, rtol=0)


# --- ConceptXAI ----------------------------------------------------------------


def _concept_inputs(seed, p=16, d=8, c=22, k=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, d)).astype(np.float32),
            rng.standard_normal((k, p, d)).astype(np.float32),
            rng.standard_normal((c, d)).astype(np.float32))


def test_conceptxai_equals_the_original(tmp_path):
    """The numpy copy against the original on the same inputs: attention,
    top concepts, grids, heatmaps, the retrieval record and its report, bit
    for bit; both render a figure."""
    q, r, concepts = _concept_inputs(17)
    for a, b in zip(conceptxai.patch_concept_attention(r, concepts, 4),
                    jax_conceptxai.patch_concept_attention(r, concepts, 4)):
        assert np.array_equal(a, b)
    for n in (729, 1024, 16, 12, 7, 1):
        assert conceptxai.detect_patch_grid(n) == jax_conceptxai.detect_patch_grid(n)
    att = np.random.default_rng(18).random(16).astype(np.float32)
    assert np.array_equal(conceptxai.attention_heatmap(att, image_size=40),
                          jax_conceptxai.attention_heatmap(att, image_size=40))
    names = [f"concept {i}" for i in range(22)]
    args = (q, r, concepts, names, [0.9, 0.8, 0.7], ["a", "b", "c"], "query", 5)
    got, want = conceptxai.explain_retrieval(*args), jax_conceptxai.explain_retrieval(*args)
    assert got.keys() == want.keys()
    for key in got:
        if key.endswith("attention"):
            assert np.array_equal(got[key], want[key])
        else:
            assert got[key] == want[key]
    assert conceptxai.text_explanation(got) == jax_conceptxai.text_explanation(want)
    images = [np.full((40, 40, 3), 100 + 20 * i, np.uint8) for i in range(4)]
    for mod, name in ((conceptxai, "port.png"), (jax_conceptxai, "jax.png")):
        mod.render_retrieval_explanation(got, images[0], images[1:], str(tmp_path / name))
        assert (tmp_path / name).stat().st_size > 0


CONCEPT_CLI = ["--dim", "64", "--depth", "2", "--text-depth", "2", "--image-size", "28",
               "--seq-len", "16", "--vocab-size", "60", "--top-k", "3", "--top-k-concepts", "4",
               "--num-query-samples", "2", "--batch-size", "4", "--seed", "0"]


def test_xai_conceptclip_cli_matches_the_jax_cli(tmp_path):
    """Both CLIs on the same generated images and the weights the JAX CLI
    draws for --seed 0 (converted to a .pt the port loads strictly): the same
    queries, retrieved ids, concept names and shared findings, scores and
    similarities within 1e-4, the same files."""
    img_dir, manifest = synthetic.write_synthetic_covidx(str(tmp_path / "data"), n=7, size=40)
    model = jax_embedders.ConceptCLIPModel(img_size=28, dim=64, depth=2, text_depth=2,
                                           text_vocab=60)
    variables = jax.jit(lambda key: model.init(
        key, jnp.zeros((1, 28, 28, 3)), jnp.zeros((1, 16), jnp.int32), None,
        method=model.forward_clip))(jax.random.PRNGKey(0))
    pt = str(tmp_path / "cc.pt")
    torch.save({"state_dict": convert.conceptclip_state_dict_from_jax(_np(variables))}, pt)
    data = ["--dataset", "covid", "--dataset-dir", img_dir, "--test-image-list", manifest]
    want = jax_xai_conceptclip.main(data + CONCEPT_CLI + ["--out-dir", str(tmp_path / "j")])
    got = xai_conceptclip.main(data + CONCEPT_CLI + ["--out-dir", str(tmp_path / "p"),
                                                     "--device", "cpu", "--checkpoint", pt,
                                                     "--render"])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g["query_id"] == w["query_id"]
        pairs = [(g["query_top_concepts"], w["query_top_concepts"])] + [
            (a["top_concepts"], b["top_concepts"]) for a, b in zip(g["retrieved"], w["retrieved"])]
        for a, b in pairs:
            assert [c["name"] for c in a] == [c["name"] for c in b]
            np.testing.assert_allclose([c["score"] for c in a], [c["score"] for c in b],
                                       atol=CLI_TOL, rtol=0)
        for a, b in zip(g["retrieved"], w["retrieved"]):
            assert a["id"] == b["id"] and a["shared_findings"] == b["shared_findings"]
            np.testing.assert_allclose(a["similarity"], b["similarity"], atol=CLI_TOL, rtol=0)
    jfiles = sorted(p.name for p in (tmp_path / "j").iterdir())
    pfiles = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert pfiles == sorted(jfiles + [n.replace(".json", ".png") for n in jfiles
                                      if n.endswith(".json")])
