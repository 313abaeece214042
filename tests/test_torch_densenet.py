"""The port's DenseNet (backbone, embedder, weight conversion, registry,
embedding step) against the JAX package.

A narrow DenseNet (growth 8, blocks (2, 2, 2, 2), 16 initial features) keeps
the forward cheap on the CPU; its JAX weights, with random BatchNorm
statistics, go through densenet_state_dict_from_jax into the port, and both
forwards see the same numpy images. Full DenseNet121 is checked by its
state-dict names and shapes, built from jax.eval_shape so nothing compiles.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu.models import registry as jax_registry
from torch_parity_models import NARROW, JaxNarrowEmbedder, randomized
from xmir_tpu.models.densenet import DenseNetBackbone as JaxBackbone
from xmir_tpu.models.embedders import DenseNet121Embedder as JaxEmbedder
from xmir_tpu.models.export import export_densenet121_embedder
from xmir_tpu_torch.models import registry
from xmir_tpu_torch.models.convert import (
    densenet_state_dict_from_jax,
    embedder_state_dict_from_torch,
    load_torch_checkpoint,
)
from xmir_tpu_torch.models.densenet import DenseNetBackbone, densenet121
from xmir_tpu_torch.models.embedders import DenseNet121Embedder
from xmir_tpu_torch.train import make_embed_fn

torch.set_num_threads(1)

def _images(n=3, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def test_narrow_backbone_matches_jax():
    model = JaxBackbone(**NARROW)
    x = _images()
    variables = randomized(model.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=1)
    ref = model.apply(variables, jnp.asarray(x))
    port = DenseNetBackbone(**NARROW)
    port.load_state_dict(densenet_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    assert out["features"].shape == (3, 2, 2, port.num_features)
    for key in ("features", "pooled"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4)


def test_narrow_embedder_matches_jax():
    model = JaxNarrowEmbedder()
    x = _images(seed=2)
    variables = randomized(model.init(jax.random.PRNGKey(1), jnp.asarray(x)), seed=3)
    ref = model.apply(variables, jnp.asarray(x))
    port = DenseNet121Embedder(12, 3, **NARROW)
    port.load_state_dict(densenet_state_dict_from_jax(variables), strict=True)
    with torch.no_grad():
        out = port.eval()(torch.from_numpy(x))
    for key in ("embedding", "features", "logits"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(torch.linalg.norm(out["embedding"], dim=1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("embedding_dim,num_labels", [(None, None), (32, 3)])
def test_densenet121_names_match_export(embedding_dim, num_labels):
    model = JaxEmbedder(embedding_dim=embedding_dim, num_labels=num_labels)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    exported = export_densenet121_embedder(zeros)
    port = DenseNet121Embedder(embedding_dim, num_labels)
    sd = port.state_dict()
    assert sorted(sd) == sorted(exported)
    for key, value in exported.items():
        assert tuple(sd[key].shape) == value.shape, key
    converted = densenet_state_dict_from_jax(zeros)
    assert sorted(converted) == sorted(exported)
    port.load_state_dict(converted, strict=True)
    assert sd["densenet121.0.conv0.weight"].shape == (64, 3, 7, 7)


def test_densenet121_full_width_forward_shapes():
    model = densenet121(torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(_images(n=2, size=32)))
    assert out["pooled"].shape == (2, 1024) and out["features"].shape == (2, 1, 1, 1024)
    assert torch.isfinite(out["pooled"]).all()


def _reference_layouts(sd):
    """The checkpoint layouts a user may hold for the same weights."""
    backbone = {k[len("densenet121.0."):]: v for k, v in sd.items() if k.startswith("densenet121.0.")}
    heads = {k: v for k, v in sd.items() if not k.startswith("densenet121.0.")}
    counters = {k.replace("running_var", "num_batches_tracked"): torch.tensor(7)
                for k in backbone if k.endswith("running_var")}
    torchvision = {f"features.{k}": v for k, v in {**backbone, **counters}.items()}
    torchvision.update({"classifier.weight": torch.zeros(2, 4), "classifier.bias": torch.zeros(2)})
    chexnet = {f"module.densenet121.features.{k}": v for k, v in backbone.items()}
    chexnet["module.densenet121.classifier.0.weight"] = torch.zeros(2, 4)
    return {
        "torchvision": {**torchvision, **heads},
        "chexnet": {**chexnet, **{f"module.{k}": v for k, v in heads.items()}},
        "wrapped": {"state_dict": dict(sd)},
    }


@pytest.mark.parametrize("layout", ["torchvision", "chexnet", "wrapped"])
def test_torch_checkpoint_loads_strict(layout, tmp_path):
    src = DenseNet121Embedder(12, **NARROW, generator=torch.Generator().manual_seed(5))
    sd = src.state_dict()
    path = str(tmp_path / f"{layout}.pt")
    torch.save(_reference_layouts(sd)[layout], path)
    dst = DenseNet121Embedder(12, **NARROW, generator=torch.Generator().manual_seed(6))
    load_torch_checkpoint(dst, path)
    for key, value in dst.state_dict().items():
        assert torch.equal(value, sd[key]), key


def test_torch_checkpoint_with_missing_keys_fails():
    port = DenseNet121Embedder(12, **NARROW)
    sd = embedder_state_dict_from_torch(
        {k: v for k, v in port.state_dict().items() if not k.endswith("norm5.weight")})
    with pytest.raises(RuntimeError, match="Missing"):
        port.load_state_dict(sd, strict=True)


def test_generator_init_is_deterministic():
    a = DenseNet121Embedder(8, **NARROW, generator=torch.Generator().manual_seed(0)).state_dict()
    b = DenseNet121Embedder(8, **NARROW, generator=torch.Generator().manual_seed(0)).state_dict()
    c = DenseNet121Embedder(8, **NARROW, generator=torch.Generator().manual_seed(1)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["densenet121.0.conv0.weight"], c["densenet121.0.conv0.weight"])


def test_registry_spec_matches_jax():
    spec, ref = registry.get_spec("densenet121"), jax_registry.get_spec("densenet121")
    for field in ("name", "input_size", "resize_size", "embed_dim", "mean", "std", "interpolation"):
        assert getattr(spec, field) == getattr(ref, field), field
    model, spec = registry.create_model("densenet121", embedding_dim=16)
    assert isinstance(model, DenseNet121Embedder) and model.fc.out_features == 16
    assert registry.list_models() == [
        "ath", "biomedclip", "conceptclip", "convnextv2", "convnextv2_dino_distill",
        "convnextv2_pcam", "convnextv2_raddino_distill", "convnextv2_sra", "densenet121",
        "dinov2", "medsiglip", "nih_convnextv2", "nih_dinov2", "resnet50", "swinv2", "tiny"]


@pytest.mark.parametrize("name", ["biomedclip", "conceptclip", "medsiglip", "resnet50", "nope"])
def test_registry_other_models_are_not_ported(name):
    """The CLIP-family and ResNet50 specs equal the JAX package's; every
    model of the JAX registry is ported now, and an unknown name raises as
    the JAX package's get_spec does."""
    if name == "nope":
        with pytest.raises(ValueError, match="unknown model"):
            registry.get_spec(name)
        return
    spec, ref = registry.get_spec(name), jax_registry.get_spec(name)
    for field in ("name", "input_size", "resize_size", "embed_dim", "mean", "std", "interpolation"):
        assert getattr(spec, field) == getattr(ref, field), field
    assert spec.builder.__name__ == ref.builder.__name__


def test_embed_fn_returns_f32_without_grad():
    model = DenseNet121Embedder(12, **NARROW, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(_images(n=2))
    e = make_embed_fn(model)(x)
    assert e.dtype == torch.float32 and e.shape == (2, 12) and not e.requires_grad
    e16 = make_embed_fn(model, compute_dtype=torch.bfloat16)(x)
    assert e16.dtype == torch.float32
    np.testing.assert_allclose(e16.numpy(), e.numpy(), atol=5e-2)
