"""The NIH dual-head models in the port against the JAX package:
NIHProjectionHead, NIHDualHeadModel at full width on small images (weights
carried across by ``convert.nih_dual_head_state_dict_from_jax``), the
registry specs, the checkpoint loader's dispatch, three dual-branch train
steps of narrow models in both stacks (f32 and bf16), and ``cli.train
--dataset nih --loss-name dual_branch`` -> ``cli.test`` -> ``cli.ingest`` ->
``cli.query`` on a generated NIH tree. CPU only; each tolerance is stated
where it is used."""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_datasets import write_nih_tree
from test_torch_train import NARROW_VIT, _compare_states, _images, _records
from torch_parity_models import NARROW_CONVNEXT
from xmir_tpu.losses.metric_losses import l2_normalize as jax_l2_normalize
from xmir_tpu.models import embedders as jax_embedders
from xmir_tpu.models import heads as jax_heads
from xmir_tpu.models import registry as jax_registry
from xmir_tpu.models.convnext import ConvNeXtV2Backbone as JaxConvNeXt
from xmir_tpu.models.vit import ViTBackbone as JaxViT
from xmir_tpu.train import optim as jax_optim
from xmir_tpu.train import state as jax_state
from xmir_tpu.train import steps as jax_steps
from xmir_tpu_torch.cli import common, ingest, query
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.cli import train as train_cli
from xmir_tpu_torch.models import convert, registry
from xmir_tpu_torch.models import vit as port_vit
from xmir_tpu_torch.models.embedders import NIHDualHeadModel
from xmir_tpu_torch.models.heads import NIHProjectionHead
from xmir_tpu_torch.train import TrainState, build_optimizer, make_dual_branch_train_step
from xmir_tpu_torch.utils import checkpoint

torch.set_num_threads(2)


def random_variables(shapes, seed):
    """Weights for a tree of shapes (``jax.eval_shape`` of an init, which
    skips the init's compile): kernels N(0, 1 / fan_in), LayerNorm scales
    1 + 0.1 N, biases and GRN betas 0.1 N, LayerScale / GRN gammas
    0.1 + 0.05 N, CLS and position embeddings 0.02 N. Every tensor is
    nonzero, so every one of the conversion matters."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return a / math.sqrt(int(np.prod(leaf.shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * a
        if name == "gamma":
            return 0.1 + 0.05 * a
        if name in ("cls_token", "pos_embed"):
            return 0.02 * a
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_variables(model, x, seed, **init_kw):
    shapes = jax.eval_shape(lambda r, v: model.init(r, v, **init_kw), jax.random.PRNGKey(0), x)
    return random_variables(shapes, seed)


def assert_close(got, want, rtol_abs):
    """|got - want| <= tol (1 + |want|) elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bad = np.abs(got - want) > rtol_abs * (1 + np.abs(want))
    assert not bad.any(), (np.abs(got - want).max(), int(bad.sum()))


def test_projection_head_matches_jax():
    """Input width 64, f32: projection and logits within 1e-5 (1 + |jax|)."""
    x = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    head = jax_heads.NIHProjectionHead(num_labels=14)
    variables = random_variables(
        jax.eval_shape(head.init, jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    want = head.apply(variables, jnp.asarray(x))
    port = NIHProjectionHead(64, 14)
    params = jax.device_get(variables["params"])
    port.load_state_dict({f"{name}.{torch_key}": torch.from_numpy(
        np.array(p[jax_key].T if jax_key == "kernel" else p[jax_key]))
        for name, p in params.items()
        for torch_key, jax_key in (("weight", "kernel"), ("bias", "bias"))}, strict=True)
    got = port(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert_close(g.detach().numpy(), w, 1e-5)
    assert got[0].shape == (5, 256) and got[1].shape == (5, 14)


@pytest.fixture(scope="module", params=[("dinov2", 70), ("convnextv2", 64)],
                ids=["dinov2", "convnextv2"])
def full_width_pair(request):
    """(backbone name, images, JAX outputs, the port's model with the same
    weights): the reference widths (ViT-B/14 at 518, ConvNeXtV2-Base) on
    two small images, as tests/test_models.py runs them."""
    name, size = request.param
    model = jax_embedders.NIHDualHeadModel(backbone=name)
    x = _images(2, size, seed=4)
    variables = jax_variables(model, jnp.asarray(x), seed=5)
    want = jax.jit(model.apply)(variables, jnp.asarray(x))
    port = NIHDualHeadModel(name)
    port.load_state_dict(convert.nih_dual_head_state_dict_from_jax(
        jax.device_get(variables), name), strict=True)
    return name, x, jax.device_get(want), port.eval()


def test_dual_head_model_matches_jax_at_full_width(full_width_pair):
    """f32: projection and logits within 1e-4 (1 + |jax|), the unit
    embedding within 1e-5, the backbone feature within 1e-4 (1 + |jax|);
    the output keys are the JAX module's."""
    name, x, want, port = full_width_pair
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert set(got) == set(want)
    extra = "cls_embedding" if name == "dinov2" else "backbone_embedding"
    for key, tol in (("projection", 1e-4), ("logits", 1e-4), (extra, 1e-4)):
        assert_close(got[key].numpy(), want[key], tol)
    np.testing.assert_allclose(got["embedding"].numpy(), want["embedding"], atol=1e-5, rtol=0)
    assert got["embedding"].shape == (2, 256) and got["logits"].shape == (2, 14)


def test_state_dict_names_keep_the_jax_first_components(full_width_pair):
    name, _, _, port = full_width_pair
    firsts = {key.split(".")[0] for key in port.state_dict()}
    assert firsts == {"backbone", "head"}
    with pytest.raises(ValueError, match="unknown NIH backbone"):
        NIHDualHeadModel("swinv2")


@pytest.mark.parametrize("name", ["nih_dinov2", "nih_convnextv2"])
def test_registry_spec_matches_jax(name):
    spec, ref = registry.get_spec(name), jax_registry.get_spec(name)
    for field in ("name", "input_size", "resize_size", "embed_dim", "mean", "std", "kwargs",
                  "interpolation"):
        assert getattr(spec, field) == getattr(ref, field), field
    assert spec.embed_dim == 256 and spec.builder is NIHDualHeadModel
    assert name in registry.list_models()


def test_build_model_ignores_embedding_dim_and_seeds(monkeypatch):
    """--embedding-dim does not change an NIH model's fixed widths, as in
    the JAX package; --seed draws the weights."""
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    narrow = dict(img_size=28, dim=32, depth=1, num_heads=2)
    spec = dataclasses.replace(registry.get_spec("nih_dinov2"),
                               kwargs=tuple(sorted({"backbone": "dinov2", **narrow}.items())))
    monkeypatch.setitem(registry._SPECS, "nih_dinov2", spec)
    args = p.parse_args(["--model", "nih_dinov2", "--embedding-dim", "8", "--device", "cpu",
                         "--seed", "3"])
    model, _ = common.build_model(args, torch.device("cpu"))
    again, _ = common.build_model(args, torch.device("cpu"))
    assert model.head.proj_fc2.out_features == 256 and not model.training
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in model.state_dict().items())


def _timm_vit(path, dim=32, depth=1, heads=2, img=28):
    backbone = port_vit.ViTBackbone(img, 14, dim, depth, heads)
    port_vit.init_weights_(backbone, torch.Generator().manual_seed(8))
    sd = {f"model.{k}": v for k, v in backbone.state_dict().items()}
    sd["head.weight"] = torch.zeros(3, dim)
    torch.save(sd, path)
    return backbone.state_dict()


def test_checkpoint_loader_dispatch(tmp_path):
    """nih_dinov2 takes a timm ViT into its backbone strictly (the head
    keeps its init); nih_convnextv2 has no timm layout wired (the JAX
    package raises too); a train-CLI checkpoint loads whole."""
    narrow = dict(img_size=28, dim=32, depth=1, num_heads=2)
    pt = str(tmp_path / "vit.pt")
    timm = _timm_vit(pt)
    model = NIHDualHeadModel("dinov2", **narrow, generator=torch.Generator().manual_seed(1))
    head = {k: v.clone() for k, v in model.head.state_dict().items()}
    convert.load_torch_checkpoint(model, pt)
    assert all(torch.equal(v, timm[k]) for k, v in model.backbone.state_dict().items())
    assert all(torch.equal(v, head[k]) for k, v in model.head.state_dict().items())
    conv = NIHDualHeadModel("convnextv2", depths=(1, 1, 1, 1), dims=(8, 16, 32, 64))
    with pytest.raises(ValueError, match="backbone 'convnextv2'"):
        convert.load_torch_checkpoint(conv, pt)
    whole = str(tmp_path / "train.pt")
    other = NIHDualHeadModel("convnextv2", depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
                             generator=torch.Generator().manual_seed(9))
    torch.save({"state_dict": other.state_dict(), "optimizer": {}, "step": 1, "epoch": 1}, whole)
    convert.load_torch_checkpoint(conv, whole)
    assert all(torch.equal(v, other.state_dict()[k]) for k, v in conv.state_dict().items())


# --- three dual-branch train steps in both stacks ---------------------------------


class JaxNarrowNIH(fnn.Module):
    """xmir_tpu's NIHDualHeadModel with a narrow backbone: the same
    __call__ body."""

    backbone: str = "dinov2"

    @fnn.compact
    def __call__(self, x, train: bool = False):
        if self.backbone == "dinov2":
            out = JaxViT(img_size=56, **NARROW_VIT, name="backbone")(x, train)
            feat, extra = out["cls"], {"cls_embedding": out["cls"]}
        else:
            out = JaxConvNeXt(**NARROW_CONVNEXT, name="backbone")(x, train)
            feat, extra = out["pooled_norm"], {"backbone_embedding": out["pooled_norm"]}
        projection, logits = jax_heads.NIHProjectionHead(14, name="head")(feat)
        return {**extra, "projection": projection,
                "embedding": jax_l2_normalize(projection, axis=1), "logits": logits}


NARROW_PORT = {"dinov2": dict(img_size=56, **NARROW_VIT), "convnextv2": NARROW_CONVNEXT}
SIZES = {"dinov2": 56, "convnextv2": 64}
LR = 1e-4


def multi_hot(b, seed, p=0.25):
    """(b, 14) multi-hot labels, every row with a positive."""
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=(b, 14)) < p).astype(np.float32)
    y[np.arange(b), rng.integers(0, 14, b)] = 1.0
    return y


def narrow_pair(name, seed=3):
    model = JaxNarrowNIH(backbone=name)
    x = jnp.zeros((1, SIZES[name], SIZES[name], 3))
    variables = jax_variables(model, x, seed)
    port = NIHDualHeadModel(name, **NARROW_PORT[name])
    port.load_state_dict(convert.nih_dual_head_state_dict_from_jax(
        jax.device_get(variables), name), strict=True)
    return model, dict(variables), port.train()


def run_dual_branch(name, compute, steps=3):
    """``steps`` dual-branch steps (alpha 0.7) in both stacks from the same
    weights on the same batches. Returns (JAX metrics, port metrics, JAX
    final state dict, port final state dict, port start state dict)."""
    model, variables, port = narrow_pair(name)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    tx = jax_optim.build_optimizer(variables["params"], lr=LR)
    jstate = jax_state.create_train_state(model, jax.random.PRNGKey(0), None, tx,
                                          variables=variables)
    state = TrainState(port, build_optimizer(port, lr=LR,
                                             backbone_prefixes=train_cli.BACKBONE_PREFIXES))
    kw = dict(asl_alpha=0.7, temperature=0.1, gamma_pos=1.0, gamma_neg=3.0, clip=0.05)
    jstep = jax.jit(jax_steps.make_dual_branch_train_step(
        model, **kw, compute_dtype=jnp.bfloat16 if compute == "bf16" else jnp.float32))
    step = make_dual_branch_train_step(
        port, **kw, compute_dtype=torch.bfloat16 if compute == "bf16" else torch.float32)
    jm_all, tm_all = [], []
    for i in range(steps):
        x, y = _images(8, SIZES[name], seed=30 + i), multi_hot(8, seed=40 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tm = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert set(tm) == {"loss", "contrastive", "asl"} and not tm["loss"].requires_grad
        jm_all.append({k: float(v) for k, v in jm.items()})
        tm_all.append({k: v.item() for k, v in tm.items()})
    want = convert.nih_dual_head_state_dict_from_jax(
        jax.device_get({"params": jstate.params}), name)
    return jm_all, tm_all, want, port.state_dict(), start


@pytest.mark.parametrize("name", ["dinov2", "convnextv2"])
def test_three_dual_branch_steps_match_jax_f32(name):
    """loss, contrastive and asl of each step within 1e-5; the parameters
    after the third as tests/test_torch_train.py::_compare_states holds
    them, and the backbone moved (its own learning-rate group)."""
    jm, tm, want, got, start = run_dual_branch(name, "f32")
    for a, b in zip(jm, tm):
        for key in ("loss", "contrastive", "asl"):
            assert abs(a[key] - b[key]) <= 1e-5, (key, a, b)
    assert _compare_states(want, got, start) > 1e-6
    assert any(not torch.equal(v, start[k]) for k, v in got.items() if k.startswith("backbone."))


@pytest.mark.parametrize("name", ["dinov2", "convnextv2"])
def test_three_dual_branch_steps_bf16_keep_f32_masters(name):
    """bf16 compute on f32 master weights: each term within 2e-2 of the JAX
    package's bf16 run, and the port's bf16 losses no further from its own
    f32 run than 1.25 x the JAX bf16 run is from JAX f32 (plus 2e-3)."""
    jm16, tm16, _, got16, _ = run_dual_branch(name, "bf16")
    jm32, tm32, _, _, _ = run_dual_branch(name, "f32")
    for a, b in zip(jm16, tm16):
        for key in ("loss", "contrastive", "asl"):
            assert abs(a[key] - b[key]) <= 2e-2, (key, a, b)
    ours = max(abs(a["loss"] - b["loss"]) for a, b in zip(tm16, tm32))
    theirs = max(abs(a["loss"] - b["loss"]) for a, b in zip(jm16, jm32))
    assert ours <= 1.25 * theirs + 2e-3, (ours, theirs)
    assert all(v.dtype == torch.float32 for v in got16.values())


# --- the CLIs on a generated NIH tree --------------------------------------------


@pytest.fixture
def narrow_nih(monkeypatch):
    """--model nih_dinov2 at a narrow width and 56 px (the CLI path is the
    same; full width runs on the card, in chip_smoke.py)."""
    kw = dict(NARROW_PORT["dinov2"], backbone="dinov2")
    spec = dataclasses.replace(registry.get_spec("nih_dinov2"), input_size=56, resize_size=56,
                               kwargs=tuple(sorted(kw.items())))
    monkeypatch.setitem(registry._SPECS, "nih_dinov2", spec)
    for flag in ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_MLP"):
        monkeypatch.delenv(flag, raising=False)
    return monkeypatch


def write_nih_split(root, n, seed):
    """``n`` NIH files (a multiple of the 18 of write_nih_tree's sets)."""
    paths = []
    for i in range(n // 18):
        paths += write_nih_tree(root / f"part{i}", seed=seed + i)
    return str(root)


def test_cli_dual_branch_train_test_ingest_query(tmp_path, narrow_nih):
    """cli.train --dataset nih --loss-name dual_branch (two epochs, the
    multi-label sampler, evaluation each epoch, contrastive and asl in the
    metrics log, exact --resume), then cli.test on its checkpoint (the
    multi-label suite equals the one recomputed from its artifact), then
    cli.ingest -> cli.query: a 256-d gallery, hits of each query sorted and
    equal to the exact top-k of the artifact's embeddings.

    The images decode through PIL, as when this test was written: the
    narrow model's similarities lie within 0.998-1.0, where the float64
    recomputation meets f32 near-ties on other image bytes. The native
    reader, the dataset's default, is held to the JAX package's in
    tests/test_torch_data_tools.py."""
    from xmir_tpu_torch.data import datasets

    narrow_nih.setattr(datasets.NIHChestXrayRetrievalDataset, "__init__",
                       functools.partialmethod(datasets.NIHChestXrayRetrievalDataset.__init__,
                                               use_native=False))
    train_dir, val_dir = write_nih_split(tmp_path / "tr", 36, 1), write_nih_split(
        tmp_path / "va", 18, 7)
    base = ["--dataset", "nih", "--dataset-dir", train_dir, "--val-dataset-dir", val_dir,
            "--train-image-list", "", "--val-image-list", "", "--device", "cpu", "--model",
            "nih_dinov2", "--loss-name", "dual_branch", "-p", "2", "-k", "4", "-j", "2",
            "--print-freq", "1", "--eval-freq", "1", "--ckpt-every", "1", "--lr", "1e-3",
            "--dual-asl-alpha", "0.5", "--embedding-dim", "32"]
    whole, first, second = (str(tmp_path / d) for d in ("whole", "first", "second"))
    logs = [str(tmp_path / f"{n}.jsonl") for n in ("w", "1", "2")]
    train_cli.main(base + ["--epochs", "2", "--save-dir", whole, "--metrics-log", logs[0]])
    train_cli.main(base + ["--epochs", "1", "--save-dir", first, "--metrics-log", logs[1]])
    name1 = checkpoint.checkpoint_name("nih", "nih_dinov2", 32, epoch=1)
    train_cli.main(base + ["--epochs", "2", "--save-dir", second, "--metrics-log", logs[2],
                           "--resume", f"{first}/{name1}"])
    rec = [[(r["epoch"], r["step"], r["loss"], r["contrastive"], r["asl"])
            for r in _records(log) if r["kind"] == "train"] for log in logs]
    assert len(rec[0]) == 2 * (36 // 8) and rec[0] == rec[1] + rec[2] and rec[2][0][0] == 2
    for _, _, loss, contrastive, asl in rec[0]:
        assert math.isfinite(loss) and abs(loss - contrastive - 0.5 * asl) < 1e-5
    evals = [r for r in _records(logs[0]) if r["kind"] == "eval"]
    assert [r["epoch"] for r in evals] == [1, 2] and all(0 <= r["mAP"] <= 100 for r in evals)
    name2 = checkpoint.checkpoint_name("nih", "nih_dinov2", 32, epoch=2)
    a = checkpoint.load_checkpoint(f"{whole}/{name2}")
    b = checkpoint.load_checkpoint(f"{second}/{name2}")
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    start = NIHDualHeadModel("dinov2", **NARROW_PORT["dinov2"],
                             generator=torch.Generator().manual_seed(0)).state_dict()
    assert all(not torch.equal(v, start[k]) for k, v in a.items())  # every tensor moved

    serve = ["--dataset", "nih", "--device", "cpu", "--model", "nih_dinov2", "-j", "2",
             "--resume", f"{whole}/{name2}"]
    metrics = test_cli.main(serve + ["--dataset-dir", val_dir, "--save-dir",
                                     str(tmp_path / "res")])
    art = np.load(str(tmp_path / "res" / "evaluation_results.npz"))
    e = art["embeds"].astype(np.float64)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    sims = e @ e.T
    np.fill_diagonal(sims, -np.inf)
    again = test_cli.multilabel_metrics(sims, art["labels"])
    assert art["embeds"].shape == (18, 256) and art["labels"].shape == (18, 14)
    for key, v in again.items():
        assert abs(metrics[key] - v) <= 1e-3, key
    gal = str(tmp_path / "g.npz")
    ingest.main(serve + ["--dataset-dir", train_dir, "--split", "train", "--output", gal])
    hits = query.main(serve + ["--dataset-dir", val_dir, "--index", gal, "--top-k", "5",
                               "--output", str(tmp_path / "hits.json")])
    g = np.load(gal)
    assert g["embeds"].shape == (36, 256)
    gn = g["embeds"] / np.linalg.norm(g["embeds"], axis=1, keepdims=True)
    qn = art["embeds"] / np.linalg.norm(art["embeds"], axis=1, keepdims=True)
    exact = qn.astype(np.float64) @ gn.T.astype(np.float64)
    for qi, r in enumerate(hits):
        sims_q = [h["similarity"] for h in r["results"]]
        assert sims_q == sorted(sims_q, reverse=True) and len(sims_q) == 5
        best = np.sort(exact[qi])[::-1][:5]
        np.testing.assert_allclose(sims_q, best, atol=1e-5)
        assert len(r["query_label"]) == 14
    assert json.loads((tmp_path / "hits.json").read_text())[0]["query_path"].endswith(".npy")
