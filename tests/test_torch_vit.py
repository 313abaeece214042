"""The port's ViT (models/vit.py, DinoV2Embedder, its converters, registry
spec and CLIs) against the JAX package on the same numpy inputs and weights.
Tier 1: CPU only. Models are narrow (dim 128, 2 heads, depth 2); the full
ViT-B/14 runs on the card, in chip_smoke.py.

Tolerances: f32 throughout. Eager branch 2e-5 absolute on unit embeddings,
normalised tokens and attention probabilities (the two stacks sum in other
orders). Fused branches, the JAX side running its Pallas kernels in interpret
mode: 5e-5 on tokens (K8's tanh-GELU is shared by both sides; the attention's
exp2 softmax adds a few f32 roundings). Images are multiples of the patch
size: at other sizes flax's SAME padding pads and timm's convolution (the
port's) does not.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu.models import embedders as jax_embedders
from xmir_tpu.models import registry as jax_registry
from xmir_tpu.models import vit as jax_vit
from xmir_tpu.ops import ln_dense_pallas as jln
from xmir_tpu.ops import plain_attn as jpa
from xmir_tpu.ops.vit_attn_pallas import vit_attention_fused as jax_attention_fused
from xmir_tpu_torch.cli import ingest, query
from xmir_tpu_torch.data import synthetic
from xmir_tpu_torch.models import convert, registry, vit
from xmir_tpu_torch.models.embedders import DinoV2Embedder
from xmir_tpu_torch.ops import ln_dense as ld
from xmir_tpu_torch.ops import vit_attn as va

NARROW = dict(dim=128, depth=2, num_heads=2)
EAGER_ATOL, FUSED_ATOL = 2e-5, 5e-5


def _randomized(variables, seed):
    """Every leaf redrawn: weights ~ N(0, 0.1^2) scaled by fan-in-free 0.1,
    vectors (LN scale, LayerScale, biases) away from their 1 / 0 / 1e-5 init
    so that each takes part."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(variables)
    out = []
    for leaf in leaves:
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        out.append(0.5 + 0.3 * a if leaf.ndim == 1 else 0.1 * a)
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in out])


def _backbone_pair(patch, layerscale, img_size, seed):
    model = jax_vit.ViTBackbone(img_size=img_size, patch_size=patch, mlp_ratio=4.0,
                                use_layerscale=layerscale, **NARROW)
    x0 = jnp.zeros((1, img_size, img_size, 3), jnp.float32)
    variables = _randomized(model.init(jax.random.PRNGKey(0), x0), seed)
    port = vit.ViTBackbone(img_size=img_size, patch_size=patch, use_layerscale=layerscale,
                           **NARROW)
    sd = convert.vit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    port.load_state_dict(sd, strict=True)
    return model, variables, port.eval()


def _images(b, size, seed):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


@pytest.fixture
def clean_flags(monkeypatch):
    for name in ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_MLP"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("patch,layerscale", [(14, True), (16, False), (14, False), (16, True)])
@pytest.mark.parametrize("grid", ["reference", "larger", "smaller"])
def test_backbone_eager_matches_jax(clean_flags, patch, layerscale, grid):
    """cls, tokens and every block's attention weights, at the reference grid
    (4 x 4) and at another (the position embeddings resized up to 5 x 5 and
    down to 3 x 3)."""
    size = patch * {"reference": 4, "larger": 5, "smaller": 3}[grid]
    model, variables, port = _backbone_pair(patch, layerscale, patch * 4, seed=patch)
    x = _images(2, size, seed=1)
    ref = model.apply(variables, jnp.asarray(x), output_attentions=True)
    with torch.inference_mode():
        out = port(torch.from_numpy(x), output_attentions=True)
    n = (size // patch) ** 2 + 1
    assert out["tokens"].shape == (2, n - 1, 128) and len(out["attentions"]) == 2
    np.testing.assert_allclose(out["cls"].numpy(), np.asarray(ref["cls"]), atol=EAGER_ATOL, rtol=0)
    np.testing.assert_allclose(out["tokens"].numpy(), np.asarray(ref["tokens"]), atol=EAGER_ATOL,
                               rtol=0)
    for a, r in zip(out["attentions"], ref["attentions"]):
        assert a.shape == (2, 2, n, n) and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=EAGER_ATOL, rtol=0)
    with torch.inference_mode():
        assert port(torch.from_numpy(x))["attentions"] is None


@pytest.mark.parametrize("g_new", [3, 5, 9])
def test_interpolate_pos_embed_matches_jax(g_new):
    """Growing and shrinking (antialiased) from a 6 x 6 grid: 1e-6, f32."""
    pos = np.random.default_rng(g_new).standard_normal((1, 37, 8)).astype(np.float32)
    ref = np.asarray(jax_vit.interpolate_pos_embed(jnp.asarray(pos), g_new * g_new))
    out = vit.interpolate_pos_embed(torch.from_numpy(pos), g_new * g_new)
    assert out.shape == (1, g_new * g_new + 1, 8)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(vit.interpolate_pos_embed(torch.from_numpy(pos), 36).numpy(), pos)


@pytest.fixture
def jax_interpret_kernels(monkeypatch):
    """The JAX ViT's fused branches on the CPU: its gates opened and its
    Pallas kernels in interpret mode (as tests/test_ln_dense.py wires them),
    the attention through the Pallas kernel as well."""
    monkeypatch.setattr(jln, "fused_ln_enabled", lambda dtype: True)
    monkeypatch.setattr(jpa, "plain_flash_enabled", lambda dtype, n=256: True)

    def attention(q, k, v, scale):
        b, h, n, d = q.shape
        out = jax_attention_fused(q.reshape(b * h, n, d), k.reshape(b * h, n, d),
                                  v.reshape(b * h, n, d), scale, True)
        return out.reshape(b, h, n, d)

    monkeypatch.setattr(jpa, "flash_attention_plain", attention)
    monkeypatch.setattr(jax_vit, "ln_qkv_fused",
                        lambda x, s, bb, w, bias, h: jln.ln_qkv_fused(x, s, bb, w, bias, h, 1e-6,
                                                                      32, True))
    monkeypatch.setattr(jax_vit, "ln_dense_fused",
                        lambda x, s, bb, w, bias, eps, act: jln.ln_dense_fused(
                            x, s, bb, w, bias, eps, act, 32, True))


def _count(fn):
    """Calls of ``fn`` (a wrapper on CPU tensors takes its plain version and
    does not count a launch, so the test counts the calls)."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)

    return counted, calls


@pytest.mark.parametrize("mlp", ["0", "1"])
@pytest.mark.parametrize("qkv", ["1", "0"])
def test_backbone_fused_branches_match_jax(clean_flags, jax_interpret_kernels, qkv, mlp):
    """XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1 with the LN -> qkv fusion on / off
    and the LN -> fc1 fusion on / off: the same branch on both sides, and the
    wrappers each branch must call."""
    clean_flags.setenv("XMIR_FLASH_ATTN", "1")
    clean_flags.setenv("XMIR_FUSED_LN", "1")
    clean_flags.setenv("XMIR_FUSED_LN_QKV", qkv)
    clean_flags.setenv("XMIR_FUSED_LN_MLP", mlp)
    model, variables, port = _backbone_pair(14, True, 56, seed=3)
    x = _images(2, 70, seed=2)
    ref = model.apply(variables, jnp.asarray(x))
    counted = {}
    for mod, name in ((vit, "ln_qkv_fused"), (vit, "ln_dense_fused"),
                      (vit, "flash_attention_plain")):
        fn, counted[name] = _count(getattr(mod, name))
        clean_flags.setattr(mod, name, fn)
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert {k: len(v) for k, v in counted.items()} == {
        "ln_qkv_fused": 2 * (qkv == "1"), "ln_dense_fused": 2 * (mlp == "1"),
        "flash_attention_plain": 2}
    np.testing.assert_allclose(out["cls"].numpy(), np.asarray(ref["cls"]), atol=FUSED_ATOL, rtol=0)
    np.testing.assert_allclose(out["tokens"].numpy(), np.asarray(ref["tokens"]), atol=FUSED_ATOL,
                               rtol=0)


def test_output_attentions_never_takes_a_kernel(clean_flags):
    _, _, port = _backbone_pair(14, True, 56, seed=4)
    clean_flags.setenv("XMIR_FLASH_ATTN", "1")
    clean_flags.setenv("XMIR_FUSED_LN", "1")
    for name in ("ln_qkv_fused", "ln_dense_fused", "flash_attention_plain"):
        clean_flags.setattr(vit, name, lambda *a, **k: pytest.fail("a kernel wrapper was called"))
    with torch.inference_mode():
        out = port(torch.from_numpy(_images(1, 56, seed=0)), output_attentions=True)
    assert out["attentions"][0].shape == (1, 2, 17, 17)
    np.testing.assert_allclose(out["attentions"][1].sum(-1).numpy(), 1.0, atol=1e-5)


def test_block_path_follows_dtype_and_flags(clean_flags):
    """f32 keeps the eager path; bf16 on the CPU too (the kernels' default
    gate opens only on CUDA); an ineligible width (head_dim 16) takes the
    fused attention but not the fused LayerNorms."""
    block = vit.ViTBlock(128, 2).eval()
    slim = vit.ViTBlock(128, 8).eval()  # head_dim 16: not ln_qkv_eligible
    counted = {}
    for name in ("ln_qkv_fused", "flash_attention_plain"):
        fn, counted[name] = _count(getattr(vit, name))
        clean_flags.setattr(vit, name, fn)
    x = torch.randn(1, 5, 128, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        block(x)
        block.bfloat16()(x.bfloat16())
        assert not counted["ln_qkv_fused"] and not counted["flash_attention_plain"]
        clean_flags.setenv("XMIR_FLASH_ATTN", "1")
        block.float()(x)
        assert len(counted["flash_attention_plain"]) == 1 and not counted["ln_qkv_fused"]
        clean_flags.setenv("XMIR_FUSED_LN", "1")
        block(x)
        assert len(counted["flash_attention_plain"]) == 2 and len(counted["ln_qkv_fused"]) == 1
        slim(x)
        assert len(counted["flash_attention_plain"]) == 3 and len(counted["ln_qkv_fused"]) == 1


@pytest.mark.parametrize("embedding_dim", [None, 16])
def test_dinov2_embedder_matches_jax(clean_flags, embedding_dim):
    model = jax_embedders.DinoV2Embedder(embedding_dim=embedding_dim, img_size=56, **NARROW)
    x = _images(3, 56, seed=5)
    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=6)
    port = DinoV2Embedder(embedding_dim, img_size=56, **NARROW).eval()
    port.load_state_dict(convert.vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    ref = model.apply(variables, jnp.asarray(x), output_attentions=True)
    with torch.inference_mode():
        out = port(torch.from_numpy(x), output_attentions=True)
    assert out["embedding"].shape == (3, embedding_dim or 128)
    np.testing.assert_allclose(out["embedding"].norm(dim=1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(out["embedding"].numpy(), np.asarray(ref["embedding"]),
                               atol=EAGER_ATOL, rtol=0)
    np.testing.assert_allclose(out["tokens"].numpy(), np.asarray(ref["tokens"]), atol=EAGER_ATOL,
                               rtol=0)
    np.testing.assert_allclose(out["attentions"][-1].numpy(), np.asarray(ref["attentions"][-1]),
                               atol=EAGER_ATOL, rtol=0)


@pytest.mark.parametrize("flags", [{}, {"XMIR_FLASH_ATTN": "1", "XMIR_FUSED_LN": "1"}],
                         ids=["eager", "fused"])
def test_train_mode_changes_nothing_and_gradients_flow(clean_flags, flags):
    """The ViT has no dropout and no drop-path: ``train()`` gives the eval
    forward bit for bit, on the eager and on the fused path, and every
    parameter gets a finite gradient through either."""
    _, _, port = _backbone_pair(14, True, 56, seed=9)
    for k, v in flags.items():  # after the pair: the JAX side initialises on its eager path
        clean_flags.setenv(k, v)
    x = torch.from_numpy(_images(2, 56, seed=10))
    with torch.no_grad():
        want = port.eval()(x)["tokens"]
    out = port.train()(x)
    assert torch.equal(out["tokens"], want)
    (out["cls"].square().sum() + out["tokens"].square().sum()).backward()
    for name, p in port.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


def test_fused_mlp_moves_f32_outputs_only_by_the_gelu_form(clean_flags):
    """K8 is always the tanh GELU while the f32 eager Mlp uses erf, so
    XMIR_FUSED_LN_MLP=1 moves f32 tokens by ~1e-3 and no more."""
    _, _, port = _backbone_pair(14, True, 56, seed=7)
    x = torch.from_numpy(_images(2, 56, seed=8))
    clean_flags.setenv("XMIR_FLASH_ATTN", "1")
    clean_flags.setenv("XMIR_FUSED_LN", "1")
    with torch.inference_mode():
        base = port(x)["tokens"]
        clean_flags.setenv("XMIR_FUSED_LN_MLP", "1")
        moved = port(x)["tokens"]
    d = (moved - base).abs().max().item()
    assert 1e-6 < d < 5e-3, d


def test_init_is_seeded_and_follows_the_jax_init():
    a = DinoV2Embedder(16, img_size=56, generator=torch.Generator().manual_seed(1), **NARROW)
    b = DinoV2Embedder(16, img_size=56, generator=torch.Generator().manual_seed(1), **NARROW)
    c = DinoV2Embedder(16, img_size=56, generator=torch.Generator().manual_seed(2), **NARROW)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.blocks.0.attn.qkv.weight"],
                           sc["backbone.blocks.0.attn.qkv.weight"])
    assert sa["backbone.blocks.1.ls2.gamma"].eq(1e-5).all()
    assert sa["backbone.cls_token"].abs().max() < 1e-4
    assert 0.01 < sa["backbone.pos_embed"].std() < 0.03
    assert abs(sa["backbone.blocks.0.mlp.fc2.weight"].std().item() - 512 ** -0.5) < 0.005
    keys = set(vit.vit_base_patch14_dinov2().state_dict())
    assert {"cls_token", "pos_embed", "patch_embed.proj.weight", "blocks.11.attn.qkv.bias",
            "blocks.0.ls1.gamma", "blocks.5.mlp.fc1.weight", "norm.bias"} <= keys
    assert vit.rad_dino_backbone().pos_embed.shape == (1, 1370, 768)


# -- checkpoints, registry, CLIs -------------------------------------------------

def _timm_checkpoint(seed):
    """A narrow backbone's state dict in timm's layout with random nonzero
    LN / LayerScale / biases, wrapped as checkpoints wrap it, plus head keys
    the loader must ignore."""
    src = vit.ViTBackbone(img_size=518, **NARROW)
    vit.init_weights_(src, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in src.named_parameters():
            if p.dim() == 1:
                p.copy_(0.5 + 0.3 * torch.randn(p.shape, generator=gen))
    sd = {f"module.backbone.{k}": v for k, v in src.state_dict().items()}
    sd["module.backbone.cls_token"] = sd["module.backbone.cls_token"].reshape(1, -1)
    sd.update({"module.head.weight": torch.zeros(10, 128), "module.fc.weight": torch.ones(4, 128)})
    return src, sd


def test_timm_checkpoint_loads_strictly(tmp_path):
    src, sd = _timm_checkpoint(seed=9)
    pt = str(tmp_path / "vit.pt")
    torch.save({"state_dict": sd}, pt)
    model = DinoV2Embedder(4, img_size=518, generator=torch.Generator().manual_seed(0), **NARROW)
    fc_before = model.fc.weight.clone()
    convert.load_torch_checkpoint(model, pt)
    for k, v in src.state_dict().items():
        assert torch.equal(model.backbone.state_dict()[k], v), k
    assert torch.equal(model.fc.weight, fc_before)  # the head keeps its init
    bad = dict(sd)
    bad["module.backbone.blocks.0.attn.q_norm.weight"] = torch.ones(64)
    torch.save(bad, pt)
    with pytest.raises(RuntimeError, match="q_norm"):
        convert.load_torch_checkpoint(model, pt)
    missing = {k: v for k, v in sd.items() if "blocks.1.ls2" not in k}
    torch.save(missing, pt)
    with pytest.raises(RuntimeError, match="ls2"):
        convert.load_torch_checkpoint(model, pt)


def test_registry_spec_matches_jax():
    spec, ref = registry.get_spec("dinov2"), jax_registry.get_spec("dinov2")
    for field in ("name", "input_size", "resize_size", "embed_dim", "mean", "std",
                  "interpolation"):
        assert getattr(spec, field) == getattr(ref, field), field
    assert spec.interpolation == "bicubic" and "dinov2" in registry.list_models()
    model, _ = registry.create_model("dinov2", embedding_dim=8, img_size=56, **NARROW)
    assert isinstance(model, DinoV2Embedder) and model.fc.out_features == 8
    assert registry.get_spec("medsiglip").mean == jax_registry.get_spec("medsiglip").mean
    assert registry.get_spec("resnet50").embed_dim == jax_registry.get_spec("resnet50").embed_dim
    with pytest.raises(ValueError, match="unknown model"):
        registry.get_spec("resnet18")


@pytest.fixture
def narrow_dinov2(monkeypatch):
    """--model dinov2 with the narrow backbone at the registry's 518 px (the
    CLI path is the same; full width runs on the card, in chip_smoke.py)."""
    spec = registry.get_spec("dinov2")
    narrow = dataclasses.replace(spec, kwargs=tuple(sorted(NARROW.items())))
    monkeypatch.setitem(registry._SPECS, "dinov2", narrow)
    return narrow


@pytest.mark.parametrize("flags", [{}, {"XMIR_FLASH_ATTN": "1", "XMIR_FUSED_LN": "1"}],
                         ids=["eager", "fused"])
def test_cli_ingest_then_query_dinov2_with_timm_resume(tmp_path, clean_flags, narrow_dinov2,
                                                       flags):
    """The real ingest -> query CLIs with --model dinov2 (518-pixel bicubic
    host decode, 1370 tokens), --resume of a wrapped timm-layout .pt and
    --embedding-dim; each image finds itself first."""
    for k, v in flags.items():
        clean_flags.setenv(k, v)
    img_dir, manifest = synthetic.write_synthetic_covidx(str(tmp_path / "data"), n=4, size=48)
    _, sd = _timm_checkpoint(seed=11)
    pt = str(tmp_path / "timm.pt")
    torch.save(sd, pt)
    args = ["--dataset", "covid", "--dataset-dir", img_dir, "--train-image-list", manifest,
            "--test-image-list", manifest, "--model", "dinov2", "--device", "cpu",
            "--embedding-dim", "24", "-j", "2", "--batch-size", "2"]
    gal, out = str(tmp_path / "g.npz"), str(tmp_path / "h.json")
    idx = ingest.main(args + ["--resume", pt, "--output", gal])
    assert idx.ntotal == 4 and idx.dim == 24
    results = query.main(args + ["--resume", pt, "--index", gal, "--top-k", "3",
                                 "--output", out])
    assert json.load(open(out)) == results
    assert len(results) == 4 and all(len(r["results"]) == 3 for r in results)
    assert all(r["results"][0]["image_path"] == r["query_path"] for r in results)
    plain = ingest.main(args + ["--output", str(tmp_path / "g0.npz")])
    assert not np.allclose(np.concatenate(plain._staged), np.concatenate(idx._staged), atol=1e-3)


def test_kernel_wrappers_are_what_the_model_calls():
    assert vit.ln_qkv_fused is ld.ln_qkv_fused and vit.ln_dense_fused is ld.ln_dense_fused
    from xmir_tpu_torch.ops import plain_attn
    assert vit.flash_attention_plain is plain_attn.flash_attention_plain
    assert plain_attn.vit_attention_fused is va.vit_attention_fused
