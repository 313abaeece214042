"""Model export in the port (xmir_tpu_torch/models/export.py,
xmir_tpu_torch/cli/export.py) against the JAX package's
(xmir_tpu/models/export.py, xmir_tpu/cli/export.py), and the forward kernels'
custom ops (``xmir::*``) that an exported program calls.

  - State dicts: for each of the nine names of the JAX ``export_backbone``, a
    JAX tree (seeded numpy weights, narrow where the JAX exporter takes the
    depth; DenseNet121 and ResNet50 at full width, which the JAX exporter
    assumes) exported by the JAX package, and the same tree carried into the
    port's model by models/convert.py and exported by the port: the same
    keys, shapes, dtypes and values, bit for bit. At full width (names and
    shapes only: JAX trees by ``jax.eval_shape``, the port's models on the
    meta device) the same keys and shapes. The text towers likewise.
  - Round trip: the port's export of each name that has a torch loader, read
    back by ``models/convert.py::load_torch_checkpoint`` (strict) into a
    model of other weights: the backbone bit-equal.
  - Programs: ``export_program`` of the tiny embedder (the JAX test's
    ``test_savedmodel_matches_flax``), a narrow DINOv2 (K7, K2, K8), a narrow
    ConvNeXtV2 (K9) and a narrow SwinV2 (K4; K6 under
    XMIR_SWIN_KERNEL=v1) under the switches that route to the ops: the
    graph names each op once a block, the program loaded from its ``.pt2``
    equals the eager module (the ops' CPU implementations, the kernels' plain
    versions) and the JAX model's ``apply`` within rtol 1e-5 / atol 1e-6 (the
    JAX test's tolerance), the JAX side running its Pallas kernels in
    interpret mode; a dynamic batch runs at two sizes.
  - The ops: ``torch.library.opcheck`` of each of the six on the CPU.
  - The CLI: ``--format torch`` writes the JAX CLI's key set; ``--format
    exported`` writes a loadable ``.pt2``.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity_models import (NARROW_CONVNEXT, NARROW_SWIN, JaxNarrowConvNeXt,
                                 JaxNarrowSwin)
from xmir_tpu.cli import export as jax_export_cli
from xmir_tpu.models import embedders as jax_embedders
from xmir_tpu.models import export as jax_export
from xmir_tpu.models import registry as jax_registry
from xmir_tpu.models.bert import BertTextBackbone as JaxBert
from xmir_tpu.models.siglip import SiglipVisionBackbone as JaxSiglipVision
from xmir_tpu.models.siglip_text import SiglipTextBackbone as JaxSiglipText
from xmir_tpu_torch.cli import export as export_cli
from xmir_tpu_torch.models import convert, export
from xmir_tpu_torch.models.bert import BertTextBackbone
from xmir_tpu_torch.models.convert import load_torch_checkpoint
from xmir_tpu_torch.models.registry import create_model
from xmir_tpu_torch.models.siglip_text import SiglipTextBackbone
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.ops import ln_dense as ld
from xmir_tpu_torch.ops import vit_attn as va
from xmir_tpu_torch.ops import window_attn as wa

torch.set_num_threads(2)

NAMES = ["densenet121", "resnet50", "convnextv2", "convnextv2_sra", "convnextv2_pcam",
         "swinv2", "dinov2", "medsiglip", "conceptclip"]
# narrow widths: the tower the JAX exporter reads takes its depth as a kwarg
NARROW_VIT = dict(img_size=28, dim=32, depth=2, num_heads=4)
NARROW_SIGLIP = dict(img_size=28, patch_size=14, dim=32, depth=2, num_heads=4, intermediate=64)
# ConceptCLIP's text tower at the 12 layers the JAX export_bert assumes
NARROW_CONCEPTCLIP = dict(img_size=28, dim=32, depth=2, text_depth=12, text_vocab=50)
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6  # tests/test_export.py::test_savedmodel_matches_flax's


def random_variables(shapes, seed):
    """Seeded numpy weights for a tree of shapes: kernels N(0, 1 / fan_in),
    LayerNorm / BatchNorm scales 1 + 0.1 N, running variances in [0.5, 1.5],
    everything else 0.1 N; every tensor nonzero, so that each counts."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = getattr(path[-1], "key", "")
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "kernel":
            return a / math.sqrt(max(int(np.prod(leaf.shape[:-1])), 1))
        if name == "scale":
            return 1.0 + 0.1 * a
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return 0.1 * a

    return jax.tree_util.tree_map_with_path(fill, shapes)


def jax_tree(model, *args, seed=0, method=None):
    shapes = jax.eval_shape(lambda r: model.init(r, *args, method=method), jax.random.PRNGKey(0))
    return random_variables(shapes, seed)


def _images(b, size, seed=0):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _ids():
    return jnp.zeros((1, 8), jnp.int32)


def export_case(name, seed=0):
    """(the JAX package's export of a seeded tree, the port's model holding
    the same tree through models/convert.py)."""
    if name == "densenet121":
        v = jax_tree(jax_embedders.DenseNet121Embedder(embedding_dim=16, num_labels=3),
                     jnp.zeros((1, 32, 32, 3)), seed=seed)
        model = create_model(name, embedding_dim=16, num_labels=3)[0]
        model.load_state_dict(convert.densenet_state_dict_from_jax(v), strict=True)
        return jax_export.export_backbone(name, v), model
    if name == "resnet50":
        v = jax_tree(jax_embedders.ResNet50Embedder(embedding_dim=8),
                     jnp.zeros((1, 64, 64, 3)), seed=seed)
        model = create_model(name, embedding_dim=8)[0]
        model.load_state_dict(convert.resnet50_state_dict_from_jax(v), strict=True)
        return jax_export.export_backbone(name, v), model
    if name.startswith("convnextv2"):
        kind = {"convnextv2": "plain", "convnextv2_sra": "sra", "convnextv2_pcam": "pcam"}[name]
        v = jax_tree(JaxNarrowConvNeXt(kind=kind), jnp.zeros((1, 64, 64, 3)), seed=seed)
        model = create_model(name, **NARROW_CONVNEXT)[0]
        model.load_state_dict(convert.convnextv2_state_dict_from_jax(v), strict=True)
        return jax_export.export_backbone(name, v, depths=NARROW_CONVNEXT["depths"]), model
    if name == "swinv2":
        v = jax_tree(JaxNarrowSwin(), jnp.zeros((1, 32, 32, 3)), seed=seed)
        model = create_model(name, **NARROW_SWIN)[0]
        model.load_state_dict(convert.swinv2_state_dict_from_jax(v), strict=True)
        return jax_export.export_backbone(name, v, depths=NARROW_SWIN["depths"]), model
    if name == "dinov2":
        v = jax_tree(jax_embedders.DinoV2Embedder(**NARROW_VIT), jnp.zeros((1, 28, 28, 3)),
                     seed=seed)
        model = create_model(name, patch_size=14, **NARROW_VIT)[0]
        model.load_state_dict(convert.vit_state_dict_from_jax(v), strict=True)
        return jax_export.export_backbone(name, v, depth=2), model
    if name == "medsiglip":
        # the JAX MedSigLIPEmbedder is full width only: its exporter reads
        # params["backbone"], a SiglipVisionBackbone, and the projection beside it
        v = jax_tree(JaxSiglipVision(**NARROW_SIGLIP), jnp.zeros((1, 28, 28, 3)), seed=seed)
        model = create_model(name, embed_dim=16, **NARROW_SIGLIP)[0]
        model.backbone.load_state_dict(convert.siglip_vision_state_dict_from_jax(v), strict=True)
        return jax_export.export_backbone(name, {"params": {"backbone": v["params"]}},
                                          depth=2), model
    if name == "conceptclip":
        jm = jax_embedders.ConceptCLIPModel(**NARROW_CONCEPTCLIP)
        v = jax_tree(jm, jnp.zeros((1, 28, 28, 3)), _ids(), seed=seed,
                     method=jax_embedders.ConceptCLIPModel.forward_clip)
        model = create_model(name, **NARROW_CONCEPTCLIP)[0]
        model.load_state_dict(convert.conceptclip_state_dict_from_jax(v), strict=True)
        return jax_export.export_backbone(name, v, depth=2), model
    raise ValueError(name)


def assert_state_dicts_equal(got, want):
    assert set(got) == set(want), (sorted(set(got) - set(want))[:5],
                                   sorted(set(want) - set(got))[:5])
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, np.ndarray) and g.shape == np.shape(w), key
        assert g.dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_export_equals_jax(name):
    want, model = export_case(name)
    assert_state_dicts_equal(export.export_backbone(name, model), want)


# -------------------------------------------------------------- full width
def _full_width_jax(name):
    """The JAX package's export of the registry model at its real shapes,
    every leaf a zero-stride numpy view (nothing is drawn or copied)."""
    model, spec = jax_registry.create_model(name)
    x = jnp.zeros((1, spec.input_size, spec.input_size, 3))
    if name == "conceptclip":
        init = lambda r: model.init(r, x, _ids(),  # noqa: E731
                                    method=jax_embedders.ConceptCLIPModel.forward_clip)
    else:
        init = lambda r: model.init(r, x)  # noqa: E731
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape),
                                   shapes)
    return jax_export.export_backbone(name, zeros)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_export_names_at_full_width(name):
    want = _full_width_jax(name)
    with torch.device("meta"):
        model = create_model(name)[0]
    sd = model.state_dict()
    names = export.export_names(name, model)
    assert set(names) == set(want)
    for key, src in names.items():
        assert tuple(sd[src].shape) == want[key].shape, key
        assert sd[src].dtype == torch.float32 and want[key].dtype == np.float32, key


def test_unknown_name_raises():
    with pytest.raises(ValueError, match="no exporter"):
        export.export_backbone("nope", torch.nn.Linear(2, 2))
    with pytest.raises(ValueError):
        jax_export.export_backbone("nope", {"params": {}})


def test_bf16_tensors_go_out_as_f32():
    model = torch.nn.Module()
    model.backbone = torch.nn.Linear(4, 3).to(torch.bfloat16)
    sd = export.export_backbone("dinov2", model)
    assert sd["weight"].dtype == np.float32
    np.testing.assert_array_equal(sd["weight"], model.backbone.weight.float().detach().numpy())


# names whose exported layout the port's --resume path reads
LOADABLE = [n for n in NAMES if n != "conceptclip"]


@pytest.mark.parametrize("name", LOADABLE)
def test_round_trip_through_the_loader(name, tmp_path):
    _, model = export_case(name)
    path = export.save_torch_state_dict(export.export_backbone(name, model),
                                        str(tmp_path / f"{name}.pt"))
    _, fresh = export_case(name, seed=1)
    load_torch_checkpoint(fresh, path)
    src, got = model.state_dict(), fresh.state_dict()
    for key in export.export_names(name, model).values():
        assert torch.equal(got[key], src[key]), key


def test_conceptclip_export_has_no_loader(tmp_path):
    """As in the JAX package, no torch-checkpoint loader reads ConceptCLIP's
    layout back: the port's loader raises on it."""
    _, model = export_case("conceptclip")
    path = export.save_torch_state_dict(export.export_backbone("conceptclip", model),
                                        str(tmp_path / "cc.pt"))
    with pytest.raises(ValueError, match="ConceptCLIP"):
        load_torch_checkpoint(model, path)


@pytest.mark.parametrize("tower", ["siglip_text", "bert"])
def test_text_towers_equal_jax(tower):
    if tower == "siglip_text":
        kw = dict(vocab_size=50, dim=32, depth=2, num_heads=4, intermediate=64, max_position=16)
        v = jax_tree(JaxSiglipText(**kw), jnp.zeros((1, 8), jnp.int32), seed=3)
        port = SiglipTextBackbone(**kw)
        port.load_state_dict(convert._to_torch(convert._siglip_text_state_dict(v["params"])),
                             strict=True)
        want, got = jax_export.export_siglip_text(v["params"], depth=2), export.export_siglip_text(
            port)
    else:
        kw = dict(vocab_size=50, dim=32, depth=2, num_heads=4, intermediate=64)
        v = jax_tree(JaxBert(**kw), jnp.zeros((1, 8), jnp.int32), seed=4)
        port = BertTextBackbone(**kw)
        port.load_state_dict(convert.bert_state_dict_from_jax(v), strict=True)
        want, got = jax_export.export_bert(v["params"], depth=2), export.export_bert(port)
    assert_state_dicts_equal(got, want)


@pytest.mark.parametrize("suffix", [".npz", ".pt"])
def test_save_torch_state_dict(tmp_path, suffix):
    sd = {"a.weight": np.random.default_rng(0).standard_normal((2, 3)).astype(np.float32),
          "b.bias": np.arange(4, dtype=np.float32)}
    path = export.save_torch_state_dict(sd, str(tmp_path / f"sd{suffix}"))
    if suffix == ".npz":
        back = {k: v for k, v in np.load(path).items()}
    else:
        back = {k: v.numpy() for k, v in torch.load(path).items()}
    assert_state_dicts_equal(back, sd)


# ------------------------------------------------------------------ programs
FLAGS = ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_MLP",
         "XMIR_FUSED_MLP", "XMIR_FUSED_ATTN", "XMIR_SWIN_KERNEL")


@pytest.fixture
def clean_flags(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture
def jax_interpret_kernels(monkeypatch):
    """The JAX models' Pallas kernels on the CPU in interpret mode, as the
    JAX package's own tests run them: the ViT's fused branches with their
    gates opened (tests/test_torch_vit.py), the ConvNeXt block's fused call
    and the Swin's two attention kernels."""
    import xmir_tpu.ops.convnext_block_pallas as jax_cbp
    from xmir_tpu.models import vit as jax_vit
    from xmir_tpu.ops import ln_dense_pallas as jln
    from xmir_tpu.ops import plain_attn as jpa
    from xmir_tpu.ops import vit_attn_pallas as jva
    from xmir_tpu.ops import window_attn_pallas as jwa

    monkeypatch.setattr(jln, "fused_ln_enabled", lambda dtype: True)
    monkeypatch.setattr(jpa, "plain_flash_enabled", lambda dtype, n=256: True)

    def attention(q, k, v, scale):
        b, h, n, d = q.shape
        out = jva.vit_attention_fused(q.reshape(b * h, n, d), k.reshape(b * h, n, d),
                                      v.reshape(b * h, n, d), scale, True)
        return out.reshape(b, h, n, d)

    monkeypatch.setattr(jpa, "flash_attention_plain", attention)
    monkeypatch.setattr(jax_vit, "ln_qkv_fused",
                        lambda x, s, bb, w, bias, h: jln.ln_qkv_fused(x, s, bb, w, bias, h, 1e-6,
                                                                      32, True))
    monkeypatch.setattr(jax_vit, "ln_dense_fused",
                        lambda x, s, bb, w, bias, eps, act: jln.ln_dense_fused(
                            x, s, bb, w, bias, eps, act, 32, True))
    real_block = jax_cbp.convnext_block_fused
    monkeypatch.setattr(jax_cbp, "convnext_block_fused",
                        lambda *a, **kw: real_block(*a, **{**kw, "interpret": True}))
    real_v1, real_biased = jwa.window_attention_fused, jva.biased_attention_fused
    monkeypatch.setattr(jwa, "window_attention_fused",
                        lambda q, k, v, bias, interpret=False: real_v1(q, k, v, bias,
                                                                       interpret=True))
    monkeypatch.setattr(jva, "biased_attention_fused",
                        lambda q, k, v, bias, scale, g_size=1, cosine=False, interpret=False:
                        real_biased(q, k, v, bias, scale, g_size, cosine, True))


NARROW_DINO = dict(img_size=56, dim=128, depth=2, num_heads=4)  # K7's widths: C = 128, hd = 32
# case -> (switches, the ops each block calls, the image size)
PROGRAMS = {
    "tiny": ({}, {}, 32),
    "dinov2": ({"XMIR_FLASH_ATTN": "1", "XMIR_FUSED_LN": "1", "XMIR_FUSED_LN_MLP": "1"},
               {"ln_qkv": 2, "vit_attention": 2, "ln_dense": 2}, 56),
    "convnextv2": ({"XMIR_FUSED_MLP": "1"}, {"convnext_tail": 4}, 64),
    "swinv2": ({"XMIR_FUSED_ATTN": "1"}, {"biased_attention": 6}, 32),
    "swinv2_v1": ({"XMIR_FUSED_ATTN": "1", "XMIR_SWIN_KERNEL": "v1"},
                  {"window_attention": 6}, 32),
}


def program_pair(case):
    """(JAX model, its variables, the port's embedder with the same weights,
    in eval mode)."""
    if case == "tiny":
        jm = jax_embedders.TinyEmbedder(embedding_dim=8)
        v = jax_tree(jm, jnp.zeros((1, 32, 32, 3)), seed=5)
        port = create_model("tiny", embedding_dim=8)[0]
        port.load_state_dict(convert.tiny_state_dict_from_jax(v), strict=True)
    elif case == "dinov2":
        jm = jax_embedders.DinoV2Embedder(**NARROW_DINO)
        v = jax_tree(jm, jnp.zeros((1, 56, 56, 3)), seed=6)
        port = create_model("dinov2", patch_size=14, **NARROW_DINO)[0]
        port.load_state_dict(convert.vit_state_dict_from_jax(v), strict=True)
    elif case == "convnextv2":
        jm = JaxNarrowConvNeXt(kind="plain")
        v = jax_tree(jm, jnp.zeros((1, 64, 64, 3)), seed=7)
        port = create_model("convnextv2", **NARROW_CONVNEXT)[0]
        port.load_state_dict(convert.convnextv2_state_dict_from_jax(v), strict=True)
    else:
        jm = JaxNarrowSwin()
        v = jax_tree(jm, jnp.zeros((1, 32, 32, 3)), seed=8)
        # logit scales below 33, as tests/test_torch_swin.py keeps them
        v = jax.tree_util.tree_map_with_path(
            lambda p, a: np.full(a.shape, 1.5, np.float32)
            if getattr(p[-1], "key", "") == "logit_scale" else a, v)
        port = create_model("swinv2", **NARROW_SWIN)[0]
        port.load_state_dict(convert.swinv2_state_dict_from_jax(v), strict=True)
    return jm, v, port.eval()


@pytest.mark.parametrize("case", list(PROGRAMS))
def test_program_export(case, tmp_path, clean_flags, jax_interpret_kernels):
    flags, want_ops, size = PROGRAMS[case]
    for k, val in flags.items():
        clean_flags.setenv(k, val)
    jm, v, port = program_pair(case)
    path = str(tmp_path / f"{case}.pt2")
    dynamic = case == "tiny"
    ep = export.export_program(port, path, (2, size, size, 3), dynamic_batch=dynamic)
    assert export.xmir_op_counts(ep) == want_ops
    for k in flags:  # the program keeps the route it was traced with
        clean_flags.delenv(k)
    loaded = torch.export.load(path).module()
    for b in ((2, 3) if dynamic else (2,)):
        x = _images(b, size, seed=b)
        with torch.no_grad():
            got = loaded(torch.from_numpy(x))
            for k, val in flags.items():
                clean_flags.setenv(k, val)
            eager = port(torch.from_numpy(x))["embedding"]
            for k in flags:
                clean_flags.delenv(k)
        assert got.shape == eager.shape
        torch.testing.assert_close(got, eager, rtol=0, atol=0)
        for k, val in flags.items():
            clean_flags.setenv(k, val)
        want = np.asarray(jm.apply(v, jnp.asarray(x))["embedding"])
        for k in flags:
            clean_flags.delenv(k)
        np.testing.assert_allclose(got.numpy(), want, rtol=JAX_RTOL, atol=JAX_ATOL)


def test_program_loads_from_a_fresh_process(tmp_path):
    """``torch.export.load`` in a process that imports ``xmir_tpu_torch.ops``
    first finds the ops; the file names the op it calls."""
    import subprocess
    import sys

    _, _, port = program_pair("convnextv2")
    path = str(tmp_path / "c.pt2")
    with pytest.MonkeyPatch.context() as m:
        m.setenv("XMIR_FUSED_MLP", "1")
        export.export_program(port, path, (1, 64, 64, 3))
    code = ("import torch, xmir_tpu_torch.ops; "
            f"m = torch.export.load({path!r}).module(); "
            "print(m(torch.zeros(1, 64, 64, 3)).shape)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "torch.Size([1, 64])" in out.stdout


# -------------------------------------------------------------------- the ops
def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    q, k, v = r(6, 9, 16), r(6, 9, 16), r(6, 9, 16)
    bias, scale = r(2, 9, 9), torch.rand(2, generator=g) * 3 + 1
    x = r(2, 5, 64)
    return {
        "vit_attention": [(va.vit_attention_op, (q, k, v, 0.25, False)),
                          (va.vit_attention_op, (q, k, v, 0.25, True))],
        "biased_attention": [(va.biased_attention_op, (q, k, v, bias, scale, 3, True)),
                             (va.biased_attention_op, (q, k, v, bias, scale, 1, False))],
        "window_attention": [(wa.window_attention_op, (r(2, 3, 2, 9, 8), r(2, 3, 2, 9, 8),
                                                       r(2, 3, 2, 9, 8), r(1, 2, 9, 9)))],
        "ln_qkv": [(ld.ln_qkv_op, (x, r(64), r(64), r(192, 64), r(192), 4, 1e-6)),
                   (ld.ln_qkv_op, (r(1, 1, 64), r(64), r(64), r(192, 64), None, 1, 1e-6))],
        "ln_dense": [(ld.ln_dense_op, (r(7, 64), r(64), r(64), r(96, 64), r(96), 1e-6, "gelu")),
                     (ld.ln_dense_op, (r(7, 64), r(64), r(64), r(96, 64), None, 1e-6, ""))],
        "convnext_tail": [(cb.convnext_tail_op, (r(2, 9, 16), r(2, 9, 16), r(16), r(16),
                                                 r(64, 16), r(64), r(16, 64), r(16), r(64),
                                                 r(64)))],
    }


@pytest.mark.parametrize("op", ["vit_attention", "biased_attention", "window_attention",
                                "ln_qkv", "ln_dense", "convnext_tail"])
def test_opcheck(op):
    """Schema, the fake implementation against the CPU one (with a dynamic
    batch), and the dispatch of a custom op: no autograd is registered on
    the ops (the wrappers' Functions hold the backward)."""
    for fn, args in _op_cases()[op]:
        result = torch.library.opcheck(fn, args)
        assert all(v == "SUCCESS" for v in result.values()), result


def test_ops_are_registered_for_cpu_and_cuda_only():
    from torch._C import _dispatch_has_kernel_for_dispatch_key as has

    for op in ("vit_attention", "biased_attention", "window_attention", "ln_qkv", "ln_dense",
               "convnext_tail"):
        name = f"xmir::{op}"
        assert has(name, "CPU") and has(name, "CUDA"), name
        assert not has(name, "MPS") and not has(name, "XPU"), name


# ---------------------------------------------------------------------- CLI
def test_cli_torch_writes_the_jax_cli_key_set(tmp_path):
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    export_cli.main(["--model", "resnet50", "--format", "torch", "--output", ours,
                     "--device", "cpu"])
    jax_export_cli.main(["--model", "resnet50", "--output", theirs])
    got, want = np.load(ours), np.load(theirs)
    assert set(got.files) == set(want.files)
    for key in want.files:
        assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key


def test_cli_exported_writes_a_loadable_program(tmp_path):
    out = str(tmp_path / "tiny.pt2")
    export_cli.main(["--model", "tiny", "--format", "exported", "--batch", "0", "--output", out,
                     "--device", "cpu"])
    program = torch.export.load(out).module()
    model = create_model("tiny", generator=torch.Generator().manual_seed(0))[0].eval()
    for b in (1, 3):
        x = torch.from_numpy(_images(b, 64, seed=b))
        with torch.no_grad():
            torch.testing.assert_close(program(x), model(x)["embedding"], rtol=0, atol=0)
