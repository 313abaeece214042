"""The port's ConvNeXtV2 (block tail K9 / K11 plain versions and wrappers,
block, backbone, SRA / PCAM embedders, weight conversion, checkpoint loading,
registry, the slice and its CLIs) against the JAX package on the same numpy
inputs.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
side runs on the CPU, where the wrappers take their plain PyTorch versions.
The CUDA kernels themselves are held against those plain versions on the card
(tests/test_torch_convnext_kernels.py, which imports no JAX, and
chip_smoke.py).

Tolerances: f32 1e-5 for one block tail (summation order only), 1e-4 through
a whole narrow network (as for the narrow DenseNet); bf16 0.05, the JAX
package's own bound for its fused block (tests/test_convnext_fused.py).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import xmir_tpu.ops.convnext_block_pallas as jax_cbp
from torch_parity import assert_topk_match
from torch_parity_models import NARROW_CONVNEXT, JaxNarrowConvNeXt, randomized
from xmir_tpu.data import pipeline as jax_pipeline
from xmir_tpu.index import ShardedGalleryIndex as JaxIndex
from xmir_tpu.models import registry as jax_registry
from xmir_tpu.models.convnext import ConvNeXtV2Block as JaxBlock
from xmir_tpu.models.embedders import ConvNeXtV2Embedder as JaxEmbedder
from xmir_tpu.models.export import export_convnextv2_timm
from xmir_tpu.models.registry import ModelSpec as JaxSpec
from xmir_tpu.train import make_embed_fn as jax_make_embed_fn
from xmir_tpu_torch.cli import ingest, query
from xmir_tpu_torch.data import pipeline, synthetic
from xmir_tpu_torch.index import ShardedGalleryIndex
from xmir_tpu_torch.models import convnext as port_convnext
from xmir_tpu_torch.models import registry
from xmir_tpu_torch.models.activations import adaptive_gelu
from xmir_tpu_torch.models.convert import (
    convnextv2_backbone_state_dict_from_torch,
    convnextv2_state_dict_from_jax,
    load_torch_checkpoint,
)
from xmir_tpu_torch.models.convnext import ConvNeXtV2Block, ConvNeXtV2Backbone
from xmir_tpu_torch.models.embedders import (
    ConvNeXtV2Embedder,
    ConvNeXtV2PCAMEmbedder,
    ConvNeXtV2SRAEmbedder,
)
from xmir_tpu_torch.models.registry import ModelSpec
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.train import make_embed_fn

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 0.05)}
EMBEDDERS = {"plain": (ConvNeXtV2Embedder, dict(embedding_dim=16)),
             "sra": (ConvNeXtV2SRAEmbedder, dict(num_heads=4, lam=0.3)),
             "pcam": (ConvNeXtV2PCAMEmbedder, dict(num_classes=3, lam=0.3, embedding_dim=16))}


def _f32(a):
    return np.array(jnp.asarray(a, jnp.float32))


def _tail_params(c, seed):
    """Random LN, GRN, biases and weights for a block of width c (JAX
    layouts): GRN gamma/beta are zero at init, which would leave GRN
    untested."""
    rng = np.random.default_rng(seed)
    c4 = 4 * c
    arr = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)  # noqa: E731
    return dict(dw_kernel=arr(7, 7, c, scale=0.1), dw_bias=arr(c, scale=0.1),
                ln_scale=1.0 + arr(c, scale=0.2), ln_bias=arr(c, scale=0.1),
                w1=arr(c, c4, scale=c ** -0.5), b1=arr(c4, scale=0.1),
                w2=arr(c4, c, scale=c4 ** -0.5), b2=arr(c, scale=0.1),
                gamma=arr(c4, scale=0.5), beta=arr(c4, scale=0.1))


def _port_tail_args(p, dtype):
    """The same parameters in the port's layouts: (C, 1, 7, 7) conv,
    (out, in) Linear weights in the compute dtype, f32 vectors."""
    t = torch.from_numpy
    return dict(dw_weight=t(np.ascontiguousarray(p["dw_kernel"].transpose(2, 0, 1)[:, None])),
                dw_bias=t(p["dw_bias"]), ln_scale=t(p["ln_scale"]), ln_bias=t(p["ln_bias"]),
                w1=t(p["w1"].T.copy()).to(dtype), b1=t(p["b1"]),
                w2=t(p["w2"].T.copy()).to(dtype), b2=t(p["b2"]),
                gamma=t(p["gamma"]), beta=t(p["beta"]))


# -- K9 / K11 plain versions against the JAX kernels (interpret mode) --------

@pytest.mark.parametrize("hw", [(7, 7), (8, 8)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_tail_matches_jax_kernel(dtype, hw):
    """K9: the port's wrapper (dwconv + plain tail on the CPU) against
    _block_fused_fwd(interpret=True); 7x7 is a ragged row count."""
    tdt, jdt, tol = DTYPES[dtype]
    c = 16
    p = _tail_params(c, seed=0)
    x = np.random.default_rng(1).standard_normal((2, *hw, c)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    ref = jax_cbp._block_fused_fwd(
        xj, jnp.asarray(p["dw_kernel"]), jnp.asarray(p["dw_bias"]), jnp.asarray(p["ln_scale"]),
        jnp.asarray(p["ln_bias"]), jnp.asarray(p["w1"], jdt), jnp.asarray(p["b1"]),
        jnp.asarray(p["w2"], jdt), jnp.asarray(p["b2"]), jnp.asarray(p["gamma"]),
        jnp.asarray(p["beta"]), interpret=True)
    xt = torch.from_numpy(_f32(xj)).to(tdt)
    out = cb.convnext_block_fused(xt, **_port_tail_args(p, tdt))
    assert out.dtype == tdt and out.shape == xt.shape
    np.testing.assert_allclose(out.float().numpy(), _f32(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlp_grn_matches_jax_kernel(dtype):
    """K11: the port's wrapper (plain version on the CPU) against
    convnext_mlp_grn_fused(interpret=True), 49 rows (ragged)."""
    tdt, jdt, tol = DTYPES[dtype]
    c = 16
    p = _tail_params(c, seed=2)
    rng = np.random.default_rng(3)
    y = jnp.asarray(rng.standard_normal((3, 49, c)), jdt)
    x = jnp.asarray(rng.standard_normal((3, 49, c)), jdt)
    ref = jax_cbp.convnext_mlp_grn_fused(
        y, x, jnp.asarray(p["w1"], jdt), jnp.asarray(p["b1"]), jnp.asarray(p["w2"], jdt),
        jnp.asarray(p["b2"]), jnp.asarray(p["gamma"]), jnp.asarray(p["beta"]), interpret=True)
    a = _port_tail_args(p, tdt)
    out = cb.convnext_mlp_grn_fused(
        torch.from_numpy(_f32(y)).to(tdt), torch.from_numpy(_f32(x)).to(tdt), a["w1"], a["b1"],
        a["w2"], a["b2"], a["gamma"], a["beta"])
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), _f32(ref), rtol=tol, atol=tol)


def test_block_tail_reference_is_the_tail_of_the_wrapper():
    """block_tail_reference on the dwconv output is the wrapper's CPU path,
    and equals _tail_reference + b2 + x of the JAX package."""
    c = 8
    p = _tail_params(c, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 5, 6, c)).astype(np.float32)
    a = _port_tail_args(p, torch.float32)
    xt = torch.from_numpy(x)
    h = cb.dwconv(xt, a["dw_weight"], a["dw_bias"])
    out = cb.block_tail_reference(h.reshape(2, 30, c), xt.reshape(2, 30, c), a["ln_scale"],
                                  a["ln_bias"], a["w1"], a["b1"], a["w2"], a["b2"], a["gamma"],
                                  a["beta"])
    hj = jax_cbp._dwconv(jnp.asarray(x), jnp.asarray(p["dw_kernel"]), jnp.asarray(p["dw_bias"]))
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), rtol=1e-5, atol=1e-5)
    tail = jax_cbp._tail_reference(hj.reshape(2, 30, c), *(jnp.asarray(p[k]) for k in (
        "ln_scale", "ln_bias", "w1", "b1", "w2", "gamma", "beta")))
    ref = jnp.asarray(x).reshape(2, 30, c) + tail + p["b2"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    wrapped = cb.convnext_block_fused(xt, **a)
    np.testing.assert_array_equal(wrapped.numpy(), out.reshape(2, 5, 6, c).numpy())


@pytest.mark.parametrize("kernel", ["K9", "K11"])
def test_bf16_plain_versions_round_where_the_jax_kernels_do(kernel):
    """The plain versions accumulate their GEMMs in f32, as the JAX kernels'
    preferred_element_type=f32 does, so in bf16 they meet the JAX kernels
    (interpret mode) within the bounds the CUDA kernels are held to
    (cb.agreement): GEMM products rounded to bf16 before the bias would move
    the mean error past BF16_MEAN_STEPS. K9's tail takes the JAX dwconv's
    own output (the JAX dwconv rounds before its bias, the port's cuDNN conv
    after: a difference outside the kernel)."""
    c, b, hw = 32, 2, 16
    p = _tail_params(c, seed=6)
    a = _port_tail_args(p, torch.bfloat16)
    x = jnp.asarray(np.random.default_rng(7).standard_normal((b, hw, hw, c)), jnp.bfloat16)
    xt = torch.from_numpy(_f32(x)).to(torch.bfloat16)
    w = {k: jnp.asarray(p[k], jnp.bfloat16) for k in ("w1", "w2")}
    if kernel == "K9":
        dw = jnp.asarray(p["dw_kernel"]), jnp.asarray(p["dw_bias"])
        ref = jax_cbp._block_fused_fwd(
            x, *dw, jnp.asarray(p["ln_scale"]), jnp.asarray(p["ln_bias"]), w["w1"],
            jnp.asarray(p["b1"]), w["w2"], jnp.asarray(p["b2"]), jnp.asarray(p["gamma"]),
            jnp.asarray(p["beta"]), interpret=True)
        h = torch.from_numpy(_f32(jax_cbp._dwconv(x, *dw))).to(torch.bfloat16)
        rows = (b, hw * hw, c)
        out = cb.block_tail_reference(h.reshape(rows), xt.reshape(rows), a["ln_scale"],
                                      a["ln_bias"], a["w1"], a["b1"], a["w2"], a["b2"],
                                      a["gamma"], a["beta"])
    else:
        y = jnp.asarray(np.random.default_rng(8).standard_normal((b, hw * hw, c)), jnp.bfloat16)
        x = x.reshape(b, hw * hw, c)
        ref = jax_cbp.convnext_mlp_grn_fused(
            y, x, w["w1"], jnp.asarray(p["b1"]), w["w2"], jnp.asarray(p["b2"]),
            jnp.asarray(p["gamma"]), jnp.asarray(p["beta"]), interpret=True)
        out = cb.convnext_mlp_grn_fused(torch.from_numpy(_f32(y)).to(torch.bfloat16),
                                        xt.reshape(b, hw * hw, c), a["w1"], a["b1"], a["w2"],
                                        a["b2"], a["gamma"], a["beta"])
    e = cb.agreement(out, torch.from_numpy(_f32(ref)).to(torch.bfloat16).reshape(out.shape))
    assert cb.agrees(e), e


def test_agreement_bounds():
    """cb.agreement: per output two bf16 steps of ref plus 2^-7, on average
    0.05 steps; f32 3e-5 (1 + |ref|); NaN agrees with nothing."""
    assert cb.bf16_step(torch.tensor([1.0, 1.5, 0.25, -3.0])).tolist() == [
        2 ** -7, 2 ** -7, 2 ** -9, 2 ** -6]
    ref = torch.linspace(-4, 4, 1001).to(torch.bfloat16)
    one_step = ref.float() + cb.bf16_step(ref.float())
    sparse = torch.where(torch.arange(1001) % 100 == 0, one_step, ref.float()).to(torch.bfloat16)
    assert cb.agrees(cb.agreement(sparse, ref))  # one step on 1% of outputs
    assert not cb.agrees(cb.agreement(one_step.to(torch.bfloat16), ref))  # on all: the mean
    far = ref.float().clone()
    far[700] += 4 * cb.bf16_step(far[700:701]).item() + 2 ** -7
    assert not cb.agrees(cb.agreement(far.to(torch.bfloat16), ref))  # one output past
    nan = ref.clone()
    nan[3] = float("nan")
    assert not cb.agrees(cb.agreement(nan, ref))
    r32 = ref.float()
    assert cb.agrees(cb.agreement(r32 + 2.9e-5 * (1 + r32.abs()), r32))
    assert not cb.agrees(cb.agreement(r32 + 3.1e-5 * (1 + r32.abs()), r32))


# -- the block, both paths ----------------------------------------------------

def _block_state_dict(params):
    """A JAX ConvNeXtV2Block's params -> the port block's state dict."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return {
        "conv_dw.weight": t(np.transpose(params["dwconv"]["kernel"], (3, 2, 0, 1))),
        "conv_dw.bias": t(params["dwconv"]["bias"]),
        "norm.weight": t(params["norm"]["scale"]), "norm.bias": t(params["norm"]["bias"]),
        "mlp.fc1.weight": t(np.asarray(params["pwconv1"]["kernel"]).T),
        "mlp.fc1.bias": t(params["pwconv1"]["bias"]),
        "mlp.fc2.weight": t(np.asarray(params["pwconv2"]["kernel"]).T),
        "mlp.fc2.bias": t(params["pwconv2"]["bias"]),
        "mlp.grn.weight": t(params["grn"]["gamma"]), "mlp.grn.bias": t(params["grn"]["beta"]),
    }


@pytest.fixture
def interpret_kernels(monkeypatch):
    """The JAX block's fused call in Pallas interpret mode (as
    tests/test_convnext_fused.py does)."""
    real = jax_cbp.convnext_block_fused

    def interp(*args, **kw):
        kw["interpret"] = True
        return real(*args, **kw)

    monkeypatch.setattr(jax_cbp, "convnext_block_fused", interp)


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_block_matches_jax(dtype, fused, monkeypatch, interpret_kernels):
    """XMIR_FUSED_MLP=0: the plain path (exact GELU in f32) against the JAX
    block's XLA path; =1: the fused path against the JAX block's Pallas path.
    Fused is compared with fused and plain with plain, never across."""
    tdt, jdt, tol = DTYPES[dtype]
    monkeypatch.setenv("XMIR_FUSED_MLP", fused)
    c = 16
    x = np.random.default_rng(6).standard_normal((2, 7, 7, c)).astype(np.float32)
    blk = JaxBlock(c)
    variables = randomized(blk.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=7)
    vj = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), variables)
    xj = jnp.asarray(x, jdt)
    ref = blk.apply(vj, xj)
    port = ConvNeXtV2Block(c)
    port.load_state_dict(_block_state_dict(variables["params"]), strict=True)
    port = port.to(tdt).eval()  # the JAX block's apply is train=False
    with torch.no_grad():
        out = port(torch.from_numpy(_f32(xj)).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), _f32(ref), rtol=tol, atol=tol)


def test_fused_and_plain_f32_differ_by_the_gelu_form(monkeypatch):
    """In f32 the plain block uses the exact GELU and the fused tail the tanh
    form: they agree to ~1e-3, not to f32 rounding."""
    c = 16
    port = port_convnext.init_weights_(ConvNeXtV2Block(c), torch.Generator().manual_seed(0))
    port.eval()  # inference fuses at any size; training only where fused_train_wins
    with torch.no_grad():
        port.mlp.grn.weight.normal_(0.0, 0.5, generator=torch.Generator().manual_seed(1))
        port.mlp.fc1.weight.mul_(50.0)  # GELU inputs of order 1
    x = torch.randn((2, 6, 6, c), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        monkeypatch.setenv("XMIR_FUSED_MLP", "0")
        plain = port(x)
        monkeypatch.setenv("XMIR_FUSED_MLP", "1")
        fused = port(x)
    diff = (plain - fused).abs().max().item()
    assert 1e-6 < diff < 1e-2


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_adaptive_gelu_matches_jax(dtype):
    from xmir_tpu.models.activations import adaptive_gelu as jax_gelu

    tdt, jdt, _ = DTYPES[dtype]
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ref = _f32(jax_gelu(jnp.asarray(x, jdt)))
    out = adaptive_gelu(torch.from_numpy(x).to(tdt)).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2 ** -7  # one bf16 rounding step at |x| <= 6
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


# -- which path runs ----------------------------------------------------------

@pytest.mark.parametrize("flag", ["", "0", "1"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_dispatch_rule_matches_jax(dtype, flag, monkeypatch):
    """fused_mlp_enabled: the JAX rule with "the TPU" read as "a CUDA card"."""
    tdt, jdt, _ = DTYPES[dtype]
    monkeypatch.setenv("XMIR_FUSED_MLP", flag)
    assert jax.default_backend() == "cpu"
    assert cb.fused_mlp_enabled(tdt, "cpu") == jax_cbp.fused_mlp_enabled(jdt)
    want_cuda = flag == "1" or (flag == "" and tdt == torch.bfloat16)
    assert cb.fused_mlp_enabled(tdt, torch.device("cuda", 0)) == want_cuda
    assert cb.fused_mlp_enabled(tdt, "cuda") == want_cuda


def _recorded_block_dtypes(monkeypatch, run):
    """The dtypes each package's blocks decide on during ``run()``."""
    seen = {"jax": [], "port": []}
    real_jax, real_port = jax_cbp.fused_mlp_enabled, port_convnext.fused_mlp_enabled

    def spy_jax(dtype):
        seen["jax"].append(jnp.dtype(dtype).name)
        return real_jax(dtype)

    def spy_port(dtype, device):
        seen["port"].append(str(dtype).removeprefix("torch."))
        return real_port(dtype, device)

    monkeypatch.setattr(jax_cbp, "fused_mlp_enabled", spy_jax)
    monkeypatch.setattr(port_convnext, "fused_mlp_enabled", spy_port)
    run()
    return seen


@pytest.mark.parametrize("case", ["f32_params_bf16_images", "bf16_params_bf16_images",
                                  "f32_params_autocast"])
def test_blocks_decide_on_the_promoted_dtype(case, monkeypatch):
    """Flax promotes at the stem, so f32 params keep every block in f32 even
    for bf16 images; bf16 params and images keep them in bf16. The port's
    blocks see the same dtypes, under bf16 autocast too."""
    model = JaxNarrowConvNeXt()
    x = np.random.default_rng(8).standard_normal((1, 32, 32, 3)).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = ConvNeXtV2Embedder(**NARROW_CONVNEXT, generator=torch.Generator().manual_seed(0))
    port.eval()
    bf16_params = case == "bf16_params_bf16_images"
    if bf16_params:
        variables = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), variables)
        port = port.to(torch.bfloat16)

    def run():
        model.apply(variables, jnp.asarray(x, jnp.bfloat16))
        xt = torch.from_numpy(x)
        with torch.no_grad():
            if case == "f32_params_autocast":
                with torch.autocast("cpu", dtype=torch.bfloat16):
                    port(xt)
            else:
                port(xt.bfloat16())

    seen = _recorded_block_dtypes(monkeypatch, run)
    assert len(seen["port"]) == 4 and seen["port"] == seen["jax"]
    assert set(seen["port"]) == {"bfloat16" if bf16_params else "float32"}


# -- embedders and weights ----------------------------------------------------

def _narrow_pair(kind, seed):
    """(JAX model, randomised variables, port model with the same weights)."""
    cls, kw = EMBEDDERS[kind]
    model = JaxNarrowConvNeXt(kind=kind, **kw)
    variables = randomized(model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3))),
                           seed=seed + 1)
    port = cls(**kw, **NARROW_CONVNEXT)
    port.load_state_dict(convnextv2_state_dict_from_jax(variables), strict=True)
    return model, variables, port.eval()


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("kind", list(EMBEDDERS))
def test_narrow_embedder_matches_jax(kind, fused, monkeypatch, interpret_kernels):
    monkeypatch.setenv("XMIR_FUSED_MLP", fused)
    model, variables, port = _narrow_pair(kind, seed=10)
    x = np.random.default_rng(11).standard_normal((3, 64, 64, 3)).astype(np.float32)
    ref = model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out["features"].shape == (3, 2, 2, 64)
    for key in ("embedding", "features"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(torch.linalg.norm(out["embedding"], dim=1).numpy(), 1.0,
                               atol=1e-6)


@pytest.mark.parametrize("embedding_dim", [None, 32])
def test_convnextv2_base_names_match_timm_export(embedding_dim):
    """Full ConvNeXtV2-Base: the port's backbone keys and shapes are those of
    export_convnextv2_timm, and the converter gives the embedder's keys
    (built from jax.eval_shape, so nothing compiles)."""
    model = JaxEmbedder(embedding_dim=embedding_dim)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    exported = export_convnextv2_timm(zeros["params"]["backbone"])
    port = ConvNeXtV2Embedder(embedding_dim)
    sd = port.convnext.state_dict()
    assert sorted(sd) == sorted(exported)
    for key, value in exported.items():
        assert tuple(sd[key].shape) == value.shape, key
    port.load_state_dict(convnextv2_state_dict_from_jax(zeros), strict=True)
    assert sd["stages.2.blocks.26.mlp.fc1.weight"].shape == (2048, 512)


def _timm_layouts(sd):
    """The timm-checkpoint layouts a user may hold for one backbone."""
    old_grn = {}
    for k, v in sd.items():
        if ".mlp.grn." in k:
            k = k.replace(".mlp.grn.weight", ".grn.gamma").replace(".mlp.grn.bias", ".grn.beta")
            v = v.reshape(1, 1, 1, -1)
        old_grn[k] = v
    classifier = {"head.fc.weight": torch.zeros(5, 64), "head.fc.bias": torch.zeros(5)}
    return {
        "timm": {**sd, **classifier},
        "grn_gamma_beta": old_grn,
        "wrapped": {"state_dict": {f"module.convnext.{k}": v for k, v in sd.items()}},
        "embedder": {**{f"convnext.{k}": v for k, v in sd.items()},
                     "fc.weight": torch.ones(16, 64), "fc.bias": torch.ones(16)},
    }


@pytest.mark.parametrize("layout", ["timm", "grn_gamma_beta", "wrapped", "embedder"])
def test_timm_export_loads_strict(layout, tmp_path):
    """export_convnextv2_timm of a narrow JAX backbone, in each layout, loads
    into the port's backbone strictly; the embedder's fc keeps its init."""
    _, variables, want = _narrow_pair("plain", seed=12)
    exported = export_convnextv2_timm(variables["params"]["backbone"], depths=(1, 1, 1, 1))
    sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in exported.items()}
    path = str(tmp_path / f"{layout}.pt")
    torch.save(_timm_layouts(sd)[layout], path)
    dst = ConvNeXtV2Embedder(16, **NARROW_CONVNEXT, generator=torch.Generator().manual_seed(0))
    fc_init = dst.fc.weight.clone()
    load_torch_checkpoint(dst, path)
    for key, value in dst.convnext.state_dict().items():
        assert torch.equal(value, want.convnext.state_dict()[key]), key
    assert torch.equal(dst.fc.weight, fc_init)


def test_timm_checkpoint_with_missing_or_unknown_keys_fails(tmp_path):
    """A backbone key missing, or an unknown key inside the backbone, fails
    the strict load; keys outside the backbone (any head) are ignored, as the
    JAX package's converter ignores them."""
    sd = ConvNeXtV2Backbone(**NARROW_CONVNEXT).state_dict()
    port = ConvNeXtV2Embedder(**NARROW_CONVNEXT)
    missing = {k: v for k, v in sd.items() if not k.endswith("head.norm.weight")}
    with pytest.raises(RuntimeError, match="Missing"):
        port.convnext.load_state_dict(convnextv2_backbone_state_dict_from_torch(missing),
                                      strict=True)
    inside = {**sd, "stages.0.blocks.0.mlp.extra.weight": torch.zeros(1)}
    with pytest.raises(RuntimeError, match="Unexpected"):
        port.convnext.load_state_dict(convnextv2_backbone_state_dict_from_torch(inside),
                                      strict=True)
    outside = {**sd, "decoder.proj.weight": torch.zeros(1), "head.fc.weight": torch.zeros(1)}
    assert convnextv2_backbone_state_dict_from_torch(outside).keys() == sd.keys()
    path = str(tmp_path / "other_head.pt")
    torch.save(outside, path)
    load_torch_checkpoint(port, path)
    for key, value in port.convnext.state_dict().items():
        assert torch.equal(value, sd[key]), key


def test_generator_init_is_deterministic():
    make = lambda s: ConvNeXtV2SRAEmbedder(**NARROW_CONVNEXT,  # noqa: E731
                                           generator=torch.Generator().manual_seed(s))
    a, b, c = make(0).state_dict(), make(0).state_dict(), make(1).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convnext.stem.0.weight"], c["convnext.stem.0.weight"])
    assert not a["sra.conv_att.weight"].eq(0).all()
    assert a["convnext.stages.0.blocks.0.mlp.grn.weight"].eq(0).all()  # GRN starts at zero


@pytest.mark.parametrize("name", ["convnextv2", "convnextv2_sra", "convnextv2_pcam"])
def test_registry_spec_matches_jax(name):
    spec, ref = registry.get_spec(name), jax_registry.get_spec(name)
    for field in ("name", "input_size", "resize_size", "embed_dim", "mean", "std", "interpolation"):
        assert getattr(spec, field) == getattr(ref, field), field
    model, _ = registry.create_model(name, **NARROW_CONVNEXT)
    assert isinstance(model.convnext, ConvNeXtV2Backbone)


# -- wrappers -----------------------------------------------------------------

def test_wrappers_raise_on_unsupported_device():
    p = _port_tail_args(_tail_params(8, seed=13), torch.float32)
    meta = {k: v.to("meta") for k, v in p.items()}
    with pytest.raises(ValueError, match="device"):
        cb.convnext_block_fused(torch.zeros((1, 4, 4, 8), device="meta"), **meta)
    with pytest.raises(ValueError, match="device"):
        cb.convnext_mlp_grn_fused(torch.zeros((1, 16, 8), device="meta"),
                                  torch.zeros((1, 16, 8), device="meta"), meta["w1"],
                                  meta["b1"], meta["w2"], meta["b2"], meta["gamma"],
                                  meta["beta"])


def test_wrappers_reject_bad_shapes_and_do_not_count_cpu_calls():
    p = _port_tail_args(_tail_params(8, seed=14), torch.float32)
    y = torch.zeros((1, 16, 8))
    before = (cb.convnext_block_fused.launches, cb.convnext_mlp_grn_fused.launches)
    cb.convnext_block_fused(torch.zeros((1, 4, 4, 8)), **p)
    cb.convnext_mlp_grn_fused(y, y, p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"], p["beta"])
    assert (cb.convnext_block_fused.launches, cb.convnext_mlp_grn_fused.launches) == before
    with pytest.raises(ValueError, match="w1"):
        cb.convnext_mlp_grn_fused(y, y, p["w2"], p["b1"], p["w1"], p["b2"], p["gamma"],
                                  p["beta"])
    with pytest.raises(ValueError, match="gamma"):
        cb.convnext_mlp_grn_fused(y, y, p["w1"], p["b1"], p["w2"], p["b2"], p["b2"], p["beta"])
    with pytest.raises(ValueError, match="shape"):
        cb.convnext_mlp_grn_fused(y, y[:, :8], p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"],
                                  p["beta"])


# -- the slice: narrow ConvNeXtV2 -> embed -> index -> hits, and the CLIs ----

def test_convnext_slice_matches_jax(monkeypatch, interpret_kernels):
    """Narrow ConvNeXtV2 (fused path, as a bf16 card would take it) -> embed
    -> index -> search_with_metadata, both stacks on the same weights."""
    monkeypatch.setenv("XMIR_FUSED_MLP", "1")
    monkeypatch.setenv("XMIR_GALLERY_PALLAS", "interpret")
    gallery = synthetic.SyntheticImageDataset(n=24, size=64, seed=0)
    queries = synthetic.SyntheticImageDataset(n=5, size=64, seed=1)
    model, variables, port = _narrow_pair("plain", seed=20)
    # a 64 crop: every stage's map is even, so flax's SAME padding of the
    # stride-2 downsample convs adds nothing (timm pads none)
    jax_spec = JaxSpec("narrow", JaxNarrowConvNeXt, 64, 72, 16)
    jax_embed = jax.jit(jax_make_embed_fn(model))
    ref_g, ref_labels = jax_pipeline.embed_dataset(gallery, jax_embed, variables, jax_spec,
                                                   batch_size=8, num_workers=2)
    ref_q, _ = jax_pipeline.embed_dataset(queries, jax_embed, variables, jax_spec,
                                          batch_size=8, num_workers=2)
    spec = ModelSpec("narrow", ConvNeXtV2Embedder, 64, 72, 16)
    embed = make_embed_fn(port)
    g, labels = pipeline.embed_dataset(gallery, embed, spec, device="cpu", batch_size=8,
                                       num_workers=2)
    q, _ = pipeline.embed_dataset(queries, embed, spec, device="cpu", batch_size=8,
                                  num_workers=2)
    np.testing.assert_array_equal(labels, ref_labels)
    np.testing.assert_allclose(g.numpy(), ref_g, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), ref_q, rtol=1e-4, atol=1e-4)
    paths = [str(n) for n in gallery.image_names]
    jidx = JaxIndex(16)
    jidx.add(ref_g, ref_labels, paths)
    jidx.build()
    tidx = ShardedGalleryIndex(16)
    tidx.add(g.numpy(), labels, paths)
    tidx.build("cpu")
    ref_hits = jidx.search_with_metadata(ref_q, k=5)
    hits = tidx.search_with_metadata(q, k=5)
    true_s = ref_q.astype(np.float64) @ ref_g.astype(np.float64).T
    as_arrays = lambda hs, key: np.array([[h[key] for h in row] for row in hs])  # noqa: E731
    assert_topk_match(as_arrays(hits, "similarity"), as_arrays(hits, "id"),
                      as_arrays(ref_hits, "similarity"), as_arrays(ref_hits, "id"),
                      true_s, atol=1e-5)


@pytest.fixture
def narrow_convnextv2(monkeypatch):
    """--model convnextv2 with the narrow backbone (the CLI path is the same;
    full width runs on the card, in chip_smoke.py)."""
    spec = registry.get_spec("convnextv2")
    narrow = dataclasses.replace(spec, kwargs=tuple(sorted(NARROW_CONVNEXT.items())))
    monkeypatch.setitem(registry._SPECS, "convnextv2", narrow)
    return narrow


def test_cli_ingest_then_query_convnextv2_with_timm_resume(tmp_path, narrow_convnextv2):
    """The real ingest -> query CLIs with --model convnextv2 (432-pixel host
    decode, 384 crop) and --resume of a timm-layout .pt with the old GRN
    spelling; each image finds itself first."""
    img_dir, manifest = synthetic.write_synthetic_covidx(str(tmp_path / "data"), n=5, size=48)
    src = ConvNeXtV2Backbone(**NARROW_CONVNEXT)
    port_convnext.init_weights_(src, torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, p in src.named_parameters():
            if "norm" in name or "grn" in name:
                p.normal_(0.5, 0.2, generator=torch.Generator().manual_seed(len(name)))
    pt = str(tmp_path / "timm.pt")
    torch.save(_timm_layouts(src.state_dict())["grn_gamma_beta"], pt)
    args = ["--dataset", "covid", "--dataset-dir", img_dir, "--train-image-list", manifest,
            "--test-image-list", manifest, "--model", "convnextv2", "--device", "cpu",
            "-j", "2", "--batch-size", "2"]
    gal, out = str(tmp_path / "g.npz"), str(tmp_path / "h.json")
    idx = ingest.main(args + ["--resume", pt, "--output", gal])
    assert idx.ntotal == 5 and idx.dim == 64
    results = query.main(args + ["--resume", pt, "--index", gal, "--top-k", "3",
                                 "--output", out])
    assert json.load(open(out)) == results
    assert len(results) == 5 and all(len(r["results"]) == 3 for r in results)
    assert all(r["results"][0]["image_path"] == r["query_path"] for r in results)
    # the loaded weights are the ones embedded: a run without --resume differs
    plain = ingest.main(args + ["--output", str(tmp_path / "g0.npz")])
    assert not np.allclose(np.concatenate(plain._staged), np.concatenate(idx._staged), atol=1e-3)
