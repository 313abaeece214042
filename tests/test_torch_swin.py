"""The port's SwinV2 (models/swin.py, SwinV2Embedder, its converters, registry
spec and CLIs) against the JAX package on the same numpy inputs and weights.
Tier 1: CPU only. Models are narrow (embed 16, depths (2, 2, 2), heads
(2, 4, 8), window 4), run at 32 px and 64 px so that shifted, unshifted and
clamped-window blocks all occur; the full SwinV2-Base runs on the card, in
chip_smoke.py.

Tolerances: f32. Eager path 1e-4 absolute on the normalised map, the pooled
vector and the unit embedding (the two stacks sum in other orders), 2e-5 on
attention probabilities. Fused branches, the JAX side running its Pallas
kernels in interpret mode and the port its plain versions: 1e-4 as well.
bf16 (weights and input): 0.05 on one attention module, the JAX package's own
bound for its bf16 kernels; the whole bf16 model against both stacks' distance
from f32. Images are multiples of 4 x window: at other sizes flax's SAME
padding pads the patch convolution and timm's (the port's) does not.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_models import NARROW_SWIN, JaxNarrowSwin
from xmir_tpu.cli import common as jax_common
from xmir_tpu.cli import ingest as jax_ingest
from xmir_tpu.cli import query as jax_query
from xmir_tpu.cli import test as jax_test_cli
from xmir_tpu.models import registry as jax_registry
from xmir_tpu.models import swin as jax_swin
from xmir_tpu.ops import vit_attn_pallas as jva
from xmir_tpu.ops import window_attn_pallas as jwa
from xmir_tpu_torch.cli import ingest, query
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.models import convert, registry, swin
from xmir_tpu_torch.models.embedders import SwinV2Embedder
from xmir_tpu_torch.ops import vit_attn as va
from xmir_tpu_torch.ops import window_attn as wa

torch.set_num_threads(1)

ATOL = 1e-4


def _randomized(variables, seed):
    """Every vector redrawn away from its init (LN scale 1 / bias 0, q / v
    bias 0, logit_scale log 10) so that each takes part; matrices keep their
    init. Logit scales stay below 33: at the clamp of 100 the softmax is so
    sharp that either f32 stack lies 2e-4 to 4e-4 from a float64 run of the
    same weights; the clamp has a test of its own."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        if name == "logit_scale":
            return rng.uniform(1.0, 3.5, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        if leaf.ndim == 1:
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)

    return jax.tree_util.tree_map_with_path(fill, jax.device_get(variables))


def _backbone_pair(seed, size=32):
    model = jax_swin.SwinV2Backbone(**NARROW_SWIN)
    variables = _randomized(
        model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)), seed)
    port = swin.SwinV2Backbone(**NARROW_SWIN)
    port.load_state_dict(convert.swinv2_state_dict_from_jax(variables), strict=True)
    return model, variables, port.eval()


def _images(b, size, seed):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


@pytest.fixture
def clean_flags(monkeypatch):
    for name in ("XMIR_FUSED_ATTN", "XMIR_SWIN_KERNEL"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture
def jax_interpret_kernels(monkeypatch):
    """The JAX Swin's two Pallas kernels in interpret mode (as
    tests/test_window_attn.py wires them)."""
    real_v1, real_biased = jwa.window_attention_fused, jva.biased_attention_fused
    monkeypatch.setattr(jwa, "window_attention_fused",
                        lambda q, k, v, bias, interpret=False: real_v1(q, k, v, bias,
                                                                       interpret=True))
    monkeypatch.setattr(jva, "biased_attention_fused",
                        lambda q, k, v, bias, scale, g_size=1, cosine=False, interpret=False:
                        real_biased(q, k, v, bias, scale, g_size, cosine, True))


def _count(fn):
    calls = []

    def counted(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)

    return counted, calls


@pytest.mark.parametrize("size", [32, 64])
def test_backbone_eager_matches_jax(clean_flags, size):
    model, variables, port = _backbone_pair(seed=size, size=size)
    x = _images(2, size, seed=1)
    ref = model.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    side = size // 16
    assert out["features"].shape == (2, side, side, 64) and out["pooled"].shape == (2, 64)
    assert out["attentions"] is None
    np.testing.assert_allclose(out["features"].numpy(), np.asarray(ref["features"]), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(out["pooled"].numpy(), np.asarray(ref["pooled"]), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("kernel", ["", "v1"], ids=["K4", "K6"])
def test_backbone_fused_branches_match_jax(clean_flags, jax_interpret_kernels, kernel, size):
    """XMIR_FUSED_ATTN=1 (the grouped-bias kernel's plain version) and with
    XMIR_SWIN_KERNEL=v1 (the v1 kernel's) against the JAX model under the same
    switches; every block calls the wrapper its switch names, shifted blocks
    with a bias slice per (head, window)."""
    clean_flags.setenv("XMIR_FUSED_ATTN", "1")
    clean_flags.setenv("XMIR_SWIN_KERNEL", kernel)
    model, variables, port = _backbone_pair(seed=3 + size, size=size)
    x = _images(2, size, seed=2)
    ref = model.apply(variables, jnp.asarray(x))
    k4, k4_calls = _count(swin.biased_attention_fused)
    k6, k6_calls = _count(swin.window_attention_fused)
    clean_flags.setattr(swin, "biased_attention_fused", k4)
    clean_flags.setattr(swin, "window_attention_fused", k6)
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert (len(k4_calls), len(k6_calls)) == ((0, 6) if kernel == "v1" else (6, 0))
    np.testing.assert_allclose(out["features"].numpy(), np.asarray(ref["features"]), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(out["pooled"].numpy(), np.asarray(ref["pooled"]), atol=ATOL,
                               rtol=0)
    windows = (size // 16) ** 2  # of the first stage, whose second block shifts
    if kernel == "v1":
        assert k6_calls[0][3].shape[0] == 1 and k6_calls[1][3].shape[0] == windows
        assert k6_calls[0][0].shape == (windows, 2, 2, 16, 8)
    else:
        assert k4_calls[0][3].shape[0] == 2 and k4_calls[1][3].shape[0] == 2 * windows
        assert k4_calls[0][5] == 2 * windows and k4_calls[1][5] == 2  # g_size
        assert k4_calls[0][0].shape == (2 * windows * 2, 16, 8)
        assert k4_calls[-1][0].shape[1] == (4 if size == 32 else 16)  # the window cut to the map


@pytest.mark.parametrize("path", ["eager", "K4", "K6"])
def test_bf16_matches_jax(clean_flags, jax_interpret_kernels, path):
    """bf16 weights and input on both sides. One shifted block's attention
    module (the kernels' site): within 0.05. The whole model: six post-norm
    blocks amplify every rounding, and the JAX bf16 model itself lies up to
    0.3 from the f32 model; the port's bf16 model is held to lie no further
    from the f32 JAX model than 1.25 times that, at worst and on average."""
    if path != "eager":
        clean_flags.setenv("XMIR_FUSED_ATTN", "1")
        clean_flags.setenv("XMIR_SWIN_KERNEL", "v1" if path == "K6" else "")
    model, variables, port = _backbone_pair(seed=11)

    def as_bf16(tree):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)

    xw = np.random.default_rng(0).standard_normal((8, 16, 16)).astype(np.float32)
    mask = swin._shift_attn_mask(8, 4, 2)
    ref, _ = jax_swin.WindowAttentionV2(16, 2, 4, 4, num_windows=4).apply(
        {"params": as_bf16(variables["params"]["stage0_block1"]["attn"])},
        jnp.asarray(xw, jnp.bfloat16), jnp.asarray(mask))
    port = port.bfloat16()
    with torch.inference_mode():
        out, _ = port.layers[0].blocks[1].attn(torch.from_numpy(xw).bfloat16(), 4, 4, 4,
                                               torch.from_numpy(mask))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=0.05, rtol=0)

    x = _images(2, 32, seed=3)
    f32 = np.asarray(model.apply(variables, jnp.asarray(x))["features"])
    ref = np.asarray(model.apply(as_bf16(variables), jnp.asarray(x, jnp.bfloat16))["features"],
                     np.float32)
    with torch.inference_mode():
        out = port(torch.from_numpy(x).bfloat16())
    assert out["pooled"].dtype == torch.bfloat16
    d, d_ref = np.abs(out["features"].float().numpy() - f32), np.abs(ref - f32)
    assert d.max() <= 1.25 * d_ref.max() and d.mean() <= 1.25 * d_ref.mean()


def test_output_attentions_stay_on_the_eager_path(clean_flags):
    """Attention weights per block, equal to the JAX attention module's, and
    no kernel wrapper even with the fused switch on."""
    model, variables, port = _backbone_pair(seed=5)
    clean_flags.setenv("XMIR_FUSED_ATTN", "1")
    for name in ("biased_attention_fused", "window_attention_fused"):
        clean_flags.setattr(swin, name, lambda *a, **k: pytest.fail("a kernel wrapper was called"))
    x = _images(2, 32, seed=4)
    with torch.inference_mode():
        out = port(torch.from_numpy(x), output_attentions=True)
    shapes = [tuple(a.shape) for a in out["attentions"]]
    assert shapes == [(8, 2, 16, 16)] * 2 + [(2, 4, 16, 16)] * 2 + [(2, 8, 4, 4)] * 2
    for a in out["attentions"]:
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, atol=1e-5)
    # the first block's attention module alone, on the same windows
    patch = port.patch_embed.norm(swin._conv_nhwc(torch.from_numpy(x), port.patch_embed.proj))
    xw = swin.window_partition(patch, 4)
    attn_params = {"params": variables["params"]["stage0_block0"]["attn"]}
    _, ref = jax_swin.WindowAttentionV2(16, 2, 4, 4, num_windows=4).apply(
        attn_params, jnp.asarray(xw.detach().numpy()), None, output_attentions=True)
    np.testing.assert_allclose(out["attentions"][0].numpy(), np.asarray(ref), atol=2e-5, rtol=0)


def test_logit_scale_is_clamped_at_log_100(clean_flags):
    """A logit_scale of 5 (exp 5 = 148) acts as log 100 on every path, and
    the attention module matches the JAX module's there."""
    _, variables, port = _backbone_pair(seed=8)
    attn = port.layers[0].blocks[0].attn
    xw = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 16, 16)).astype(np.float32))
    params = jax.tree_util.tree_map(np.array, variables["params"]["stage0_block0"]["attn"])
    outs = []
    for value in (5.0, float(np.log(100.0))):
        with torch.no_grad():
            attn.logit_scale.fill_(value)
        params["logit_scale"][:] = value
        ref, _ = jax_swin.WindowAttentionV2(16, 2, 4, 4, num_windows=4).apply(
            {"params": params}, jnp.asarray(xw.numpy()), None)
        with torch.inference_mode():
            eager = attn(xw, 4, 4, 4)[0]
            clean_flags.setenv("XMIR_FUSED_ATTN", "1")
            fused = attn(xw, 4, 4, 4)[0]
            clean_flags.setenv("XMIR_SWIN_KERNEL", "v1")
            v1 = attn(xw, 4, 4, 4)[0]
            clean_flags.delenv("XMIR_FUSED_ATTN")
            clean_flags.delenv("XMIR_SWIN_KERNEL")
        for out in (eager, fused, v1):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
        outs.append((eager, fused, v1))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_shifted_block_masks_across_the_seam(clean_flags):
    """The -100 mask: in a shifted block a token gives (almost) no weight to
    a token of another region of its window."""
    _, _, port = _backbone_pair(seed=6)
    with torch.inference_mode():
        out = port(torch.from_numpy(_images(1, 32, seed=5)), output_attentions=True)
    mask = torch.from_numpy(swin._shift_attn_mask(8, 4, 2))  # (4, 16, 16)
    attn = out["attentions"][1]  # (4 windows, 2 heads, 16, 16), shifted
    assert (mask == -100).any() and (mask[0] == 0).all()
    assert attn[:, 0][mask == -100].max() < 1e-20


@pytest.mark.parametrize("win,pre", [(24, 12), (12, 6), (4, 4), (2, 2)])
def test_constants_match_jax(win, pre):
    table = swin._rel_coords_table(win, pre)
    assert table.dtype == np.float32 and table.shape == (2 * win - 1, 2 * win - 1, 2)
    ref = jax_swin._rel_coords_table(win, pre)  # float64 under numpy 2; the model casts it
    np.testing.assert_array_equal(table, np.asarray(jnp.asarray(ref)))
    np.testing.assert_array_equal(swin._rel_position_index(win), jax_swin._rel_position_index(win))
    grid, shift = 4 * win, win // 2
    np.testing.assert_array_equal(swin._shift_attn_mask(grid, win, shift),
                                  jax_swin._shift_attn_mask(grid, win, shift))
    assert swin._shift_attn_mask(grid, win, 0) is None
    x = np.arange(2 * grid * grid * 3, dtype=np.float32).reshape(2, grid, grid, 3)
    parts = swin.window_partition(torch.from_numpy(x), win)
    np.testing.assert_array_equal(parts.numpy(),
                                  np.asarray(jax_swin.window_partition(jnp.asarray(x), win)))
    np.testing.assert_array_equal(swin.window_reverse(parts, win, grid, grid).numpy(), x)


def test_position_bias_is_the_jax_one_hot_expansion():
    """The gather by timm's relative_position_index gives the numbers of the
    JAX module's one-hot einsums."""
    attn = swin.WindowAttentionV2(16, 2)
    swin.init_weights_(attn, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        bias = attn.position_bias(4, 4, "cpu")
        t2 = 16 * torch.sigmoid(attn.cpb_mlp(torch.from_numpy(swin._rel_coords_table(4, 4))))
    oh = jnp.asarray(jax_swin._axis_onehot(4))
    g1 = jnp.einsum("ykd,dch->ykch", oh, jnp.asarray(t2.numpy()))
    ref = jnp.einsum("ykch,xlc->hyxkl", g1, oh).reshape(2, 16, 16)
    assert bias.shape == (2, 16, 16) and bias.dtype == torch.float32
    np.testing.assert_allclose(bias.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("embedding_dim", [None, 12])
def test_swinv2_embedder_matches_jax(clean_flags, embedding_dim):
    model = JaxNarrowSwin(embedding_dim=embedding_dim)
    x = _images(3, 32, seed=6)
    variables = _randomized(model.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=7)
    port = SwinV2Embedder(embedding_dim, **NARROW_SWIN).eval()
    port.load_state_dict(convert.swinv2_state_dict_from_jax(variables), strict=True)
    ref = model.apply(variables, jnp.asarray(x))
    with torch.inference_mode():
        out = port(torch.from_numpy(x))
    assert out["embedding"].shape == (3, embedding_dim or 64)
    np.testing.assert_allclose(out["embedding"].norm(dim=1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(out["embedding"].numpy(), np.asarray(ref["embedding"]), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(out["features"].numpy(), np.asarray(ref["features"]), atol=ATOL,
                               rtol=0)


def test_init_is_seeded_and_follows_the_jax_init():
    a = SwinV2Embedder(8, generator=torch.Generator().manual_seed(1), **NARROW_SWIN)
    b = SwinV2Embedder(8, generator=torch.Generator().manual_seed(1), **NARROW_SWIN)
    c = SwinV2Embedder(8, generator=torch.Generator().manual_seed(2), **NARROW_SWIN)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    key = "backbone.layers.0.blocks.0.attn.qkv.weight"
    assert not torch.equal(sa[key], sc[key])
    assert sa["backbone.layers.1.blocks.1.attn.logit_scale"].eq(np.float32(np.log(10.0))).all()
    assert sa["backbone.layers.1.blocks.1.attn.q_bias"].eq(0).all()
    assert abs(sa["backbone.layers.2.blocks.0.mlp.fc2.weight"].std().item() - 256 ** -0.5) < 0.01
    keys = set(swin.swinv2_base_window12to24_192to384().state_dict())
    assert len(keys) == len(set(sa) - {"fc.weight", "fc.bias"}) + (24 - 6) * 17 + 3
    assert {"patch_embed.proj.weight", "patch_embed.norm.bias", "layers.0.blocks.1.attn.v_bias",
            "layers.2.blocks.17.attn.cpb_mlp.2.weight", "layers.3.downsample.reduction.weight",
            "layers.3.blocks.1.mlp.fc1.bias", "norm.weight"} <= keys
    assert not any("relative" in k or "attn_mask" in k or "k_bias" in k for k in keys)
    full = swin.swinv2_base_window12to24_192to384()
    assert full.layers[3].blocks[0].attn.num_heads == 32 and full.num_features == 1024
    assert full.layers[2].blocks[1].shift == 12 and full.layers[3].blocks[0].pretrained_window == 6


# -- checkpoints, registry, CLIs -------------------------------------------------

def _timm_checkpoint(seed):
    """A narrow backbone's state dict in timm's layout with random nonzero
    vectors, wrapped as checkpoints wrap it, plus timm's buffers and head keys
    the loader must drop."""
    src = swin.SwinV2Backbone(**NARROW_SWIN)
    swin.init_weights_(src, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in src.named_parameters():
            if name.endswith("logit_scale"):
                p.copy_(1.0 + 2.0 * torch.rand(p.shape, generator=gen))
            elif p.dim() == 1:
                p.copy_(0.5 + 0.3 * torch.randn(p.shape, generator=gen))
    sd = {f"module.swinv2.{k}": v for k, v in src.state_dict().items()}
    pre = "module.swinv2.layers.0.blocks.1.attn"
    sd.update({f"{pre}.relative_coords_table": torch.zeros(1, 7, 7, 2),
               f"{pre}.relative_position_index": torch.zeros(16, 16, dtype=torch.long),
               "module.swinv2.layers.0.blocks.1.attn_mask": torch.zeros(4, 16, 16),
               "module.swinv2.head.fc.weight": torch.zeros(10, 64),
               "module.fc.weight": torch.ones(4, 64)})
    return src, sd


def test_timm_checkpoint_loads_strictly(tmp_path):
    src, sd = _timm_checkpoint(seed=9)
    pt = str(tmp_path / "swin.pt")
    torch.save({"state_dict": sd}, pt)
    model = SwinV2Embedder(4, generator=torch.Generator().manual_seed(0), **NARROW_SWIN)
    fc_before = model.fc.weight.clone()
    convert.load_torch_checkpoint(model, pt)
    for k, v in src.state_dict().items():
        assert torch.equal(model.backbone.state_dict()[k], v), k
    assert torch.equal(model.fc.weight, fc_before)  # the head keeps its init
    bad = dict(sd)
    bad["module.swinv2.layers.0.blocks.0.attn.k_norm.weight"] = torch.ones(8)
    torch.save(bad, pt)
    with pytest.raises(RuntimeError, match="k_norm"):
        convert.load_torch_checkpoint(model, pt)
    missing = {k: v for k, v in sd.items() if "blocks.1.attn.logit_scale" not in k}
    torch.save(missing, pt)
    with pytest.raises(RuntimeError, match="logit_scale"):
        convert.load_torch_checkpoint(model, pt)


def test_timm_keys_are_the_jax_converters_keys():
    """The state dict made from a JAX tree converts back through the JAX
    package's own timm converter to the same tree."""
    from xmir_tpu.models.convert import convert_swinv2_timm

    _, variables, port = _backbone_pair(seed=12)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_swinv2_timm(sd, depths=NARROW_SWIN["depths"])["params"]
    flat_a = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf))


def test_registry_spec_matches_jax():
    spec, ref = registry.get_spec("swinv2"), jax_registry.get_spec("swinv2")
    for field in ("name", "input_size", "resize_size", "embed_dim", "mean", "std",
                  "interpolation"):
        assert getattr(spec, field) == getattr(ref, field), field
    assert (spec.input_size, spec.resize_size, spec.embed_dim) == (384, 432, 1024)
    assert "swinv2" in registry.list_models()
    model, _ = registry.create_model("swinv2", embedding_dim=8, **NARROW_SWIN)
    assert isinstance(model, SwinV2Embedder) and model.fc.out_features == 8


@pytest.fixture
def narrow_swinv2(monkeypatch):
    """--model swinv2 with the narrow backbone at 64 px in both packages (the
    CLI paths are the same; full width runs on the card, in chip_smoke.py)."""
    spec = dataclasses.replace(registry.get_spec("swinv2"), input_size=64, resize_size=64,
                               embed_dim=64, kwargs=tuple(sorted(NARROW_SWIN.items())))
    monkeypatch.setitem(registry._SPECS, "swinv2", spec)
    jax_registry.get_spec("swinv2")  # fills the JAX registry's cache
    jax_spec = dataclasses.replace(jax_registry.get_spec("swinv2"), builder=JaxNarrowSwin,
                                   input_size=64, resize_size=64, embed_dim=64)
    monkeypatch.setitem(jax_registry._SPEC_CACHE, "swinv2", jax_spec)
    return spec


def _jax_weights_as_pt(path):
    """The weights the JAX CLIs draw for --model swinv2 --seed 0, as a .pt the
    port's --resume loads."""
    args = jax_common.argparse.Namespace(model="swinv2", embedding_dim=None, seed=0, resume="",
                                         num_labels=None, image_size=None)
    _, _, variables = jax_common.build_model(args)
    sd = convert.swinv2_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    torch.save(sd, path)


@pytest.mark.parametrize("flags", [{}, {"XMIR_FUSED_ATTN": "1"},
                                   {"XMIR_FUSED_ATTN": "1", "XMIR_SWIN_KERNEL": "v1"}],
                         ids=["eager", "K4", "K6"])
def test_cli_slice_matches_the_jax_clis(tmp_path, clean_flags, narrow_swinv2,
                                        jax_interpret_kernels, flags):
    """cli.ingest -> cli.query and cli.test with --model swinv2 on the CPU
    against the JAX package's CLIs on the same synthetic dataset and weights:
    hit ids equal outside near-ties, scores within 1e-4, every metric of
    evaluation_results.npz within 1e-3 (percent)."""
    for k, v in flags.items():
        clean_flags.setenv(k, v)
    clean_flags.setenv("XMIR_GALLERY_PALLAS", "interpret")
    pt = str(tmp_path / "jax_init.pt")
    _jax_weights_as_pt(pt)
    base = ["--dataset", "synthetic", "--model", "swinv2", "--seed", "0", "-j", "2"]
    jgal, jout = str(tmp_path / "jg.npz"), str(tmp_path / "jh.json")
    jax_ingest.main(base + ["--split", "train", "--output", jgal, "--batch-size", "32"])
    jax_query.main(base + ["--index", jgal, "--top-k", "5", "--output", jout, "--batch-size", "32"])
    ref_metrics = jax_test_cli.main(base + ["--save-dir", str(tmp_path / "jres"),
                                            "--eval-batch-size", "32"])

    port = base + ["--device", "cpu", "--resume", pt]
    gal, out = str(tmp_path / "g.npz"), str(tmp_path / "h.json")
    idx = ingest.main(port + ["--split", "train", "--output", gal, "--batch-size", "32"])
    assert idx.ntotal == 64 and idx.dim == 64
    results = query.main(port + ["--index", gal, "--top-k", "5", "--output", out,
                                 "--batch-size", "32"])
    metrics = test_cli.main(port + ["--save-dir", str(tmp_path / "res"),
                                    "--eval-batch-size", "32"])

    ref_results = json.load(open(jout))
    assert len(results) == len(ref_results) == 32
    ref_gallery = np.load(jgal)["embeds"]
    ref_queries = np.load(str(tmp_path / "jres" / "evaluation_results.npz"))["embeds"]
    exact = ref_queries.astype(np.float64) @ ref_gallery.astype(np.float64).T
    for qi, (r, rr) in enumerate(zip(results, ref_results)):
        assert r["query_path"] == rr["query_path"] and r["query_label"] == rr["query_label"]
        ranked = np.sort(exact[qi])[::-1]
        for pos, (h, rh) in enumerate(zip(r["results"], rr["results"])):
            assert abs(h["similarity"] - rh["similarity"]) <= 1e-4
            gap = min(ranked[pos - 1] - ranked[pos] if pos else np.inf,
                      ranked[pos] - ranked[pos + 1])
            if gap > 2e-4:  # outside near-ties the ids are equal
                assert h["id"] == rh["id"] and h["label"] == rh["label"]

    art = np.load(str(tmp_path / "res" / "evaluation_results.npz"))
    ref_art = np.load(str(tmp_path / "jres" / "evaluation_results.npz"))
    assert set(art.files) == set(ref_art.files) == {"embeds", "labels", "dists", "metrics"}
    np.testing.assert_allclose(art["embeds"], ref_art["embeds"], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(art["labels"], ref_art["labels"])
    finite = np.isfinite(ref_art["dists"])
    assert np.array_equal(np.isfinite(art["dists"]), finite)
    np.testing.assert_allclose(art["dists"][finite], ref_art["dists"][finite], atol=5e-4, rtol=0)
    assert json.loads(str(art["metrics"])) == json.loads(json.dumps(metrics, default=float))

    def flat(m, prefix=""):
        for k, v in m.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v

    got, want = dict(flat(metrics)), dict(flat(ref_metrics))
    assert got.keys() == want.keys() and len(got) == 7 + 5 * 7
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])


def test_cli_test_multilabel_and_biomedclip(tmp_path, clean_flags, narrow_swinv2):
    """The multi-label branch writes its artifact without a dists matrix; the
    zero-shot branch names the ROADMAP item it waits for; --device defaults to
    cuda and raises without a card."""
    args = ["--dataset", "synthetic_ml", "--model", "swinv2", "-j", "2"]
    metrics = test_cli.main(args + ["--device", "cpu", "--save-dir", str(tmp_path)])
    art = np.load(str(tmp_path / "evaluation_results.npz"))
    assert set(art.files) == {"embeds", "labels", "metrics"} and art["labels"].ndim == 2
    assert {"mAP@jaccard>0.25", "mAP@jaccard>0.5", "P@1", "R@20"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 6"):
        test_cli.main(["--model", "biomedclip", "--device", "cpu"])
    clean_flags.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        test_cli.main(args)


def test_kernel_wrappers_are_what_the_model_calls():
    assert swin.biased_attention_fused is va.biased_attention_fused
    assert swin.window_attention_fused is wa.window_attention_fused
    assert swin.fused_attention_enabled is wa.fused_attention_enabled
