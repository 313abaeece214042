"""The port's ResNet50 and tiny debug model (backbones, embedders, weight
conversion, the .pt layouts, registry, feature heads, the CLIs) against the
JAX package.

A ResNetBackbone of one bottleneck a stage (full widths, 2048 channels out)
keeps the forward cheap on the CPU; its JAX weights, with random BatchNorm
statistics (torch_parity_models.randomized), go through
resnet50_state_dict_from_jax into the port, and both forwards see the same
numpy images at 64 px: within rtol / atol 1e-4, as DenseNet's. Full
ResNet-50 is checked by its state-dict names and shapes, built from
jax.eval_shape so nothing compiles. The tiny model is small enough to run
whole, at 64 px and at odd sizes (flax's SAME padding), within 1e-5.
"""
import json
from typing import Optional

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_models import randomized
from xmir_tpu.losses.metric_losses import l2_normalize as jax_l2_normalize
from xmir_tpu.models import registry as jax_registry
from xmir_tpu.models.embedders import ResNet50Embedder as JaxResNet50Embedder
from xmir_tpu.models.embedders import TinyEmbedder as JaxTiny
from xmir_tpu.models.export import export_resnet50_backbone
from xmir_tpu.models.resnet import ResNetBackbone as JaxBackbone
from xmir_tpu.xai import feature_heads as jax_heads
from xmir_tpu_torch.models import registry
from xmir_tpu_torch.models.convert import (
    load_torch_checkpoint,
    resnet50_backbone_state_dict_from_torch,
    resnet50_state_dict_from_jax,
    tiny_state_dict_from_jax,
)
from xmir_tpu_torch.models.embedders import ResNet50Embedder, TinyEmbedder
from xmir_tpu_torch.models.resnet import ResNetBackbone, resnet50
from xmir_tpu_torch.xai import feature_heads

torch.set_num_threads(1)

NARROW_LAYERS = (1, 1, 1, 1)
TOL = dict(rtol=1e-4, atol=1e-4)  # 2048-channel f32 maps, as DenseNet's
TINY_TOL = dict(rtol=1e-5, atol=1e-5)


def _images(n=3, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


class JaxNarrowResNet(fnn.Module):
    """xmir_tpu's ResNet50Embedder with one bottleneck a stage: the same
    __call__ body."""

    embedding_dim: Optional[int] = 12
    num_labels: Optional[int] = 3

    @fnn.compact
    def __call__(self, x, train: bool = False):
        out = JaxBackbone(layers=NARROW_LAYERS, name="backbone")(x, train)
        feat = out["pooled"]
        if self.embedding_dim:
            feat = fnn.Dense(self.embedding_dim, name="fc")(feat)
        result = {"embedding": jax_l2_normalize(feat, axis=1), "features": out["features"]}
        if self.num_labels:
            result["logits"] = fnn.Dense(self.num_labels, name="classification_head")(feat)
        return result


def _narrow_pair(seed=0, **kw):
    model = JaxNarrowResNet(**kw)
    x = _images(seed=seed)
    variables = randomized(model.init(jax.random.PRNGKey(seed), jnp.asarray(x)), seed=seed + 1)
    port = ResNet50Embedder(kw.get("embedding_dim", 12), kw.get("num_labels", 3),
                            layers=NARROW_LAYERS)
    port.load_state_dict(resnet50_state_dict_from_jax(variables), strict=True)
    return model, variables, port.eval(), x


def test_narrow_backbone_matches_jax():
    model = JaxBackbone(layers=NARROW_LAYERS)
    x = _images()
    variables = randomized(model.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    ref = model.apply(variables, jnp.asarray(x))
    port = ResNetBackbone(NARROW_LAYERS)
    port.load_state_dict(resnet50_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    assert out["features"].shape == (3, 2, 2, 2048)
    for key in ("features", "pooled"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL)


def test_narrow_embedder_matches_jax():
    model, variables, port, x = _narrow_pair(seed=2)
    ref = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    for key in ("embedding", "features", "logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TOL)
    np.testing.assert_allclose(torch.linalg.norm(out["embedding"], dim=1).numpy(), 1.0,
                               atol=1e-6)


def test_narrow_embedder_train_mode_matches_jax():
    """Training mode: the batch statistics normalise, and the running
    buffers move as flax's (momentum 0.9, biased variance)."""
    model, variables, port, x = _narrow_pair(seed=4)
    ref, updates = model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port.train()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out["embedding"].numpy(), np.asarray(ref["embedding"]), **TOL)
    moved = resnet50_state_dict_from_jax({"params": variables["params"],
                                          "batch_stats": updates["batch_stats"]})
    for key, value in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), moved[key].numpy(), **TOL)


@pytest.mark.parametrize("embedding_dim,num_labels", [(None, None), (32, 3)])
def test_resnet50_names_match_export(embedding_dim, num_labels):
    model = JaxResNet50Embedder(embedding_dim=embedding_dim, num_labels=num_labels)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    exported = export_resnet50_backbone(zeros["params"]["backbone"],
                                        zeros["batch_stats"]["backbone"])
    port = ResNet50Embedder(embedding_dim, num_labels)
    backbone = port.backbone.state_dict()
    assert sorted(backbone) == sorted(exported)
    for key, value in exported.items():
        assert tuple(backbone[key].shape) == value.shape, key
    converted = resnet50_state_dict_from_jax(zeros)
    assert sorted(converted) == sorted(port.state_dict())
    port.load_state_dict(converted, strict=True)
    assert port.backbone.layer4[2].conv3.weight.shape == (2048, 512, 1, 1)
    assert port.backbone.layer2[0].conv2.stride == (2, 2)  # v1.5: stride on the 3x3


def test_resnet50_full_width_forward_shapes():
    model = resnet50(torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(_images(n=2, size=64)))
    assert out["pooled"].shape == (2, 2048) and out["features"].shape == (2, 2, 2, 2048)
    assert torch.isfinite(out["pooled"]).all()


_SEQ_INDEX = {"conv1": "0", "bn1": "1", "layer1": "4", "layer2": "5", "layer3": "6",
              "layer4": "7"}


def _layouts(backbone):
    """The checkpoint layouts a user may hold for the same backbone."""
    counters = {k.replace("running_var", "num_batches_tracked"): torch.tensor(7)
                for k in backbone if k.endswith("running_var")}
    torchvision = {**backbone, **counters, "fc.weight": torch.zeros(1000, 2048),
                   "fc.bias": torch.zeros(1000)}
    reference = {}
    for key, value in backbone.items():
        head, rest = key.split(".", 1)
        reference[f"module.resnet50.{_SEQ_INDEX[head]}.{rest}"] = value
    reference["module.fc.weight"] = torch.zeros(16, 2048)  # the reference's projection
    return {"torchvision": torchvision, "reference": reference,
            "wrapped": {"state_dict": torchvision}}


@pytest.mark.parametrize("layout", ["torchvision", "reference", "wrapped"])
def test_torch_checkpoint_loads_strict(layout, tmp_path):
    """Both layouts load the backbone strictly; the fc / classification head
    keeps its init, as the JAX CLI's merge of convert_resnet50's output."""
    src = ResNet50Embedder(12, layers=NARROW_LAYERS, generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / f"{layout}.pt")
    torch.save(_layouts(src.backbone.state_dict())[layout], path)
    dst = ResNet50Embedder(12, layers=NARROW_LAYERS, generator=torch.Generator().manual_seed(6))
    head = {k: v.clone() for k, v in dst.state_dict().items() if k.startswith("fc.")}
    load_torch_checkpoint(dst, path)
    for key, value in src.backbone.state_dict().items():
        assert torch.equal(dst.backbone.state_dict()[key], value), key
    for key, value in head.items():
        assert torch.equal(dst.state_dict()[key], value), key


def test_torch_checkpoint_with_missing_keys_fails():
    port = ResNet50Embedder(layers=NARROW_LAYERS)
    sd = resnet50_backbone_state_dict_from_torch(
        {k: v for k, v in port.backbone.state_dict().items() if k != "layer3.0.bn2.weight"})
    with pytest.raises(RuntimeError, match="Missing"):
        port.backbone.load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="unexpected tensor"):
        resnet50_backbone_state_dict_from_torch({"resnet50.9.weight": torch.zeros(1)})


@pytest.mark.parametrize("name", ["resnet50", "tiny", "ath"])
def test_registry_spec_matches_jax(name):
    spec, ref = registry.get_spec(name), jax_registry.get_spec(name)
    for field in ("name", "input_size", "resize_size", "embed_dim", "mean", "std",
                  "interpolation"):
        assert getattr(spec, field) == getattr(ref, field), field
    assert spec.builder.__name__ == ref.builder.__name__
    assert registry.list_models() == jax_registry.list_models()


@pytest.mark.parametrize("size", [64, 37])
@pytest.mark.parametrize("embedding_dim,num_labels", [(None, None), (8, 3)])
def test_tiny_matches_jax(size, embedding_dim, num_labels):
    """flax's SAME padding: 0 before and 1 after at stride 2 on an even map,
    1 and 1 on an odd one; nn.Conv2d(padding=1) would shift the even map's
    windows."""
    model = JaxTiny(embedding_dim=embedding_dim, num_labels=num_labels)
    x = _images(size=size, seed=7)
    variables = randomized(model.init(jax.random.PRNGKey(3), jnp.asarray(x)), seed=8)
    ref = model.apply(variables, jnp.asarray(x))
    port = TinyEmbedder(embedding_dim, num_labels)
    port.load_state_dict(tiny_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), **TINY_TOL)


def test_tiny_generator_init_is_deterministic():
    a = TinyEmbedder(8, generator=torch.Generator().manual_seed(0)).state_dict()
    b = TinyEmbedder(8, generator=torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone_conv0.weight"],
                           TinyEmbedder(8, generator=torch.Generator().manual_seed(1))
                           .state_dict()["backbone_conv0.weight"])


@pytest.mark.parametrize("name", ["resnet50", "tiny"])
def test_feature_heads_match_jax(name):
    """The head of the model's own feature map is the model's embedding, and
    the JAX head's (xai/feature_heads.py::resnet_head) within the models'
    tolerance."""
    if name == "resnet50":
        model, variables, port, x = _narrow_pair(seed=9, num_labels=None)
        tol = TOL
    else:
        model = JaxTiny(embedding_dim=8)
        x = _images(seed=10)
        variables = randomized(model.init(jax.random.PRNGKey(4), jnp.asarray(x)), seed=11)
        port = TinyEmbedder(8)
        port.load_state_dict(tiny_state_dict_from_jax(variables), strict=True)
        port, tol = port.eval(), TINY_TOL
    head = feature_heads.get_feature_head(name, port)
    jax_head = jax_heads.get_feature_head(name, variables["params"])
    with torch.no_grad():
        out = port(torch.from_numpy(x))
        got = head(out["features"])
    np.testing.assert_allclose(got.numpy(), out["embedding"].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_head(jnp.asarray(
        out["features"].numpy()))), **tol)


def _tiny_pt(tmp_path, seed=0, embedding_dim=16):
    """The JAX CLI's tiny weights (PRNGKey(seed) init at the registry's 64
    px) as a port .pt, so both CLIs run one model."""
    model = JaxTiny(embedding_dim=embedding_dim)
    variables = jax.jit(lambda r, x: model.init(r, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((2, 64, 64, 3), jnp.float32))
    path = str(tmp_path / "tiny.pt")
    torch.save(dict(tiny_state_dict_from_jax(jax.device_get(variables))), path)
    return path


def test_tiny_cli_test_and_ingest_query_match_jax(tmp_path):
    """cli.test --save-dir and ingest -> query with --model tiny: the port on
    the CPU from a .pt of the JAX CLI's own init, against the JAX CLIs. The
    embeddings within 1e-5, the metrics within 1e-6, the hits' ids equal."""
    from xmir_tpu.cli import ingest as jax_ingest
    from xmir_tpu.cli import query as jax_query
    from xmir_tpu.cli import test as jax_test
    from xmir_tpu_torch.cli import ingest, query
    from xmir_tpu_torch.cli import test as port_test

    pt = _tiny_pt(tmp_path)
    common = ["--dataset", "synthetic", "--model", "tiny", "--embedding-dim", "16",
              "--batch-size", "16"]
    port_args = ["--device", "cpu", "--resume", pt]
    jax_test.main(common[:-2] + ["--save-dir", str(tmp_path / "jax")])
    port_test.main(common[:-2] + port_args + ["--save-dir", str(tmp_path / "port")])
    ref = np.load(tmp_path / "jax" / "evaluation_results.npz")
    got = np.load(tmp_path / "port" / "evaluation_results.npz")
    np.testing.assert_allclose(got["embeds"], ref["embeds"], **TINY_TOL)
    ref_m, got_m = json.loads(str(ref["metrics"])), json.loads(str(got["metrics"]))
    for key in ("R@1", "R@5", "R@10", "mAP", "mP@1", "mP@5", "mP@10"):
        assert got_m[key] == pytest.approx(ref_m[key], rel=1e-6), key
    hits = {}
    for name, ing, qry, extra in (("jax", jax_ingest, jax_query, []),
                                  ("port", ingest, query, port_args)):
        gal = str(tmp_path / f"g_{name}.npz")
        ing.main(common + extra + ["--split", "train", "--output", gal])
        out = str(tmp_path / f"h_{name}.json")
        qry.main(common + extra + ["--index", gal, "--top-k", "5", "--output", out])
        with open(out) as f:
            hits[name] = json.load(f)
    assert [[h["id"] for h in r["results"]] for r in hits["port"]] == [
        [h["id"] for h in r["results"]] for r in hits["jax"]]
