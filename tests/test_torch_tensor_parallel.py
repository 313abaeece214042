"""Tensor parallelism in the port (xmir_tpu_torch/parallel/mesh.py
``auto_param_shardings``, parallel/tensor_parallel.py) against the JAX
package's.

  - The rule: the port's axis of every leaf equals the JAX rule's
    (xmir_tpu/parallel/mesh.py ``auto_param_shardings`` on the conftest's 8
    devices) mapped to the torch layout, on the JAX TP test's two-Dense MLP,
    a narrow ViT and the full-width ViT-B/14 tree (built by shape only), at
    meshes (4, 2), (2, 4), (1, 8) and (8, 1). The JAX axis is carried to
    the torch layout by the converter itself: each sharded JAX leaf holds its
    index along the sharded axis, and the converted tensor varies along one
    axis only.
  - The split models on spawned gloo worlds (tests/torch_mesh_workers.py
    ``tp_worker``): the MLP at (4, 2), 8 ranks, against the replicated
    ``model.apply`` and the port at world 1 (1e-5); a narrow ViT (dim 256, 4
    heads of 64, 2 blocks, 56 px, random nonzero LayerScale) at (1, 2) and
    (2, 2) on the eager path against the JAX forward and world 1, and on the
    fused path (K8 and K2's plain versions on the CPU) against world 1,
    forward within 1e-5 and every gradient within 1e-5 of the largest
    magnitude of world 1's; the tiny model's convolutions and fc split by
    the rule (columns, fc by rows), and narrowing convolutions (rows, the
    head by columns).
  - In one process (LocalAxis): depthwise, grouped and pointwise
    convolutions and a weight read whole; the Megatron ViT block's qkv
    pieces (head-major) and its attention maps.
  - The layout: rank r at (r // model, r % model), its row and column
    groups; the default shape (world, 1).
"""
from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_mesh_workers import (TwoDense, run_world, tp_model, tp_piece_grad, tp_piece_leaves,
                                tp_worker)
from xmir_tpu.models import vit as jax_vit
from xmir_tpu.parallel import mesh as jax_mesh
from xmir_tpu_torch.models import convert
from xmir_tpu_torch.parallel import Mesh, auto_param_shardings, shard_batch, tp_shard_axis
from xmir_tpu_torch.parallel import tensor_parallel as tpm

MESHES = [(4, 2), (2, 4), (1, 8), (8, 1)]
NARROW_VIT = dict(img_size=56, patch_size=14, dim=256, depth=2, num_heads=4)
FUSED = {"XMIR_FUSED_LN": "1", "XMIR_FLASH_ATTN": "1", "XMIR_FUSED_LN_MLP": "1"}
TOL = 1e-5


class M(fnn.Module):
    """The JAX TP test's model (tests/test_train.py ``TestTensorParallel``)."""

    @fnn.compact
    def __call__(self, x, train=False):
        h = fnn.Dense(512, name="wide1")(x)
        h = fnn.relu(h)
        h = fnn.Dense(512, name="wide2")(h)
        return {"embedding": h}


def mlp_state_dict(params):
    return {f"{k}.{n}": torch.from_numpy(np.array(np.transpose(v[
        "kernel"]) if n == "weight" else v["bias"], dtype=np.float32))
        for k, v in params.items() for n in ("weight", "bias")}


def vit_state_dict(params):
    return convert.vit_state_dict_from_jax({"params": params})


def jax_rule_axes(params, shape):
    """The JAX rule's sharded axis of each leaf (the ``model`` entry of its
    spec), or None."""
    mesh = jax_mesh.make_mesh(shape)
    specs = jax_mesh.auto_param_shardings(params, mesh)
    return jax.tree_util.tree_map(
        lambda s: tuple(s.spec).index("model") if "model" in tuple(s.spec) else None,
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))


def varying_axis(name, a):
    """The one axis along which a converted tag array varies (None for a
    constant one). A tag the converter only transposed or reshaped is still
    numpy's broadcast view, whose constant axes have stride 0: only the
    others are compared, so a full-width tree costs no copy."""
    a = np.asarray(a)
    varying = [d for d in range(a.ndim) if a.shape[d] > 1 and a.strides[d] != 0
               and not np.array_equal(a.take(0, axis=d), a.take(1, axis=d))]
    assert len(varying) <= 1, name
    if not varying:
        return None
    d = varying[0]
    line = a[tuple(slice(None) if i == d else 0 for i in range(a.ndim))]
    assert np.array_equal(line, np.arange(a.shape[d])), name
    return d


def torch_axes_of(params, axes, to_state_dict, monkeypatch):
    """The JAX rule carried to the torch layout by the converter: each leaf
    sharded at JAX axis a holds its index along a; the converted tensor's
    varying axis is the torch axis (None for a constant one). The
    converters' last step, a float32 copy into torch, is skipped (their
    numpy dict is read), so that the tags stay views. Returns (name -> the
    torch axis, name -> a meta tensor of the converted shape)."""
    def tag(leaf, a):
        if a is None:
            return np.broadcast_to(np.int16(0), leaf.shape)
        idx = np.arange(leaf.shape[a], dtype=np.int16).reshape(
            [-1 if i == a else 1 for i in range(len(leaf.shape))])
        return np.broadcast_to(idx, leaf.shape)

    with monkeypatch.context() as m:
        m.setattr(convert, "_to_torch", dict)
        sd = to_state_dict(jax.tree_util.tree_map(tag, params, axes))
    return ({name: varying_axis(name, t) for name, t in sd.items()},
            {name: torch.empty(np.shape(t), device="meta") for name, t in sd.items()})


def _shapes_to_state_dict(to_state_dict, variables_of):
    """A converter of a params tree that also needs the model's
    ``batch_stats`` (zeros: the JAX rule reads params only)."""
    def convert_tree(params):
        return to_state_dict(variables_of(params))
    return convert_tree


def _registry_tree(name):
    """(params at the registry model's real shapes by ``jax.eval_shape``, a
    converter of a params tree to the port's state dict) for a registry
    model the converters of models/convert.py cover."""
    from xmir_tpu.models import registry as jax_registry

    model, spec = jax_registry.create_model(name)
    x = jnp.zeros((1, spec.input_size, spec.input_size, 3))
    ids = jnp.zeros((1, 8), jnp.int32)
    init = {
        "conceptclip": lambda r: model.init(r, x, ids, method=type(model).forward_clip),
        "biomedclip": lambda r: model.init(r, x, ids, method=type(model).init_towers),
    }.get(name, lambda r: model.init(r, x, train=True))
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    stats = jax.tree_util.tree_map(lambda leaf: np.zeros(leaf.shape, np.int16),
                                   shapes.get("batch_stats", {}))
    to_sd = {
        "densenet121": convert.densenet_state_dict_from_jax,
        "resnet50": convert.resnet50_state_dict_from_jax,
        "convnextv2": convert.convnextv2_state_dict_from_jax,
        "convnextv2_sra": convert.convnextv2_state_dict_from_jax,
        "convnextv2_pcam": convert.convnextv2_state_dict_from_jax,
        "swinv2": convert.swinv2_state_dict_from_jax,
        "dinov2": convert.vit_state_dict_from_jax,
        "nih_dinov2": lambda v: convert.nih_dual_head_state_dict_from_jax(v, "dinov2"),
        "nih_convnextv2": lambda v: convert.nih_dual_head_state_dict_from_jax(v, "convnextv2"),
        "ath": convert.ath_state_dict_from_jax,
        "tiny": convert.tiny_state_dict_from_jax,
        "medsiglip": convert.medsiglip_state_dict_from_jax,
        "conceptclip": convert.conceptclip_state_dict_from_jax,
        "biomedclip": convert.biomedclip_state_dict_from_jax,
        "convnextv2_dino_distill": convert.distill_state_dict_from_jax,
        "convnextv2_raddino_distill": convert.distill_state_dict_from_jax,
    }[name]
    return shapes["params"], _shapes_to_state_dict(
        to_sd, lambda params: {"params": params, "batch_stats": stats})


# every registry tree a converter of models/convert.py covers
REGISTRY_TREES = ["densenet121", "resnet50", "convnextv2", "convnextv2_sra", "convnextv2_pcam",
                  "swinv2", "dinov2", "nih_dinov2", "nih_convnextv2", "ath", "tiny", "medsiglip",
                  "conceptclip", "biomedclip", "convnextv2_dino_distill",
                  "convnextv2_raddino_distill"]
_TREES = {}


def rule_tree(name):
    """(params, converter), built once a module run."""
    if name not in _TREES:
        if name == "mlp":
            mlp = M().init(jax.random.PRNGKey(0), jnp.zeros((16, 64), jnp.float32))["params"]
            _TREES[name] = (mlp, mlp_state_dict)
        elif name == "narrow_vit":
            narrow = jax_vit.ViTBackbone(**NARROW_VIT).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3)))["params"]
            _TREES[name] = (narrow, vit_state_dict)
        elif name == "vit_b14":
            base = jax.eval_shape(jax_vit.vit_base_patch14_dinov2().init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, 518, 518, 3)))["params"]
            _TREES[name] = (base, vit_state_dict)
        else:
            _TREES[name] = _registry_tree(name)
    return _TREES[name]


def port_module(name):
    """The port's registry model of ``name`` on the meta device (names and
    shapes only)."""
    from xmir_tpu_torch.models.registry import create_model

    with torch.device("meta"):
        return create_model(name)[0]


@pytest.mark.parametrize("tree", ["mlp", "narrow_vit", "vit_b14"] + REGISTRY_TREES)
@pytest.mark.parametrize("shape", MESHES)
def test_rule_equals_jax(tree, shape, monkeypatch):
    params, to_sd = rule_tree(tree)
    want, sd = torch_axes_of(params, jax_rule_axes(params, shape), to_sd, monkeypatch)
    mesh = Mesh(world=8, rank=0, device=torch.device("cpu"), shape=shape)
    assert auto_param_shardings(sd, mesh) == want
    if tree == "mlp":
        assert auto_param_shardings(TwoDense(), mesh) == want
    if tree == "narrow_vit":
        module, _ = tp_model("vit", NARROW_VIT)
        assert auto_param_shardings(module, mesh) == want
    if tree in REGISTRY_TREES:
        # the module's parameters (its BatchNorm statistics are buffers)
        got = auto_param_shardings(port_module(tree), mesh)
        assert set(got) <= set(want)
        assert got == {k: want[k] for k in got}
    if tree == "vit_b14" and shape[1] > 1:
        # the layouts that decide Megatron's split of the block
        block = {k.split(".", 2)[-1]: v for k, v in want.items() if k.startswith("blocks.0.")}
        assert (block["attn.qkv.weight"], block["attn.proj.weight"],
                block["mlp.fc1.weight"], block["mlp.fc2.weight"]) == (0, 1, 0, 1)
        assert want["pos_embed"] == (1 if shape[1] == 2 else None)  # 1370 % 4 = 2
    if tree in ("medsiglip", "conceptclip") and shape[1] > 1:
        # the pooling head's packed q | k | v in-projection splits by its input, as
        # the JAX rule splits each of attn_q / attn_k / attn_v
        key = ("visual." if tree == "conceptclip" else "backbone.") + (
            "head.attention.in_proj_weight")
        assert want[key] == 1


def test_rule_ties_go_to_the_first_jax_axis():
    # proj (768, 768): JAX splits its input, which is torch's axis 1
    assert tp_shard_axis((768, 768), "linear", 2) == 1
    assert tp_shard_axis((768, 768), "same", 2) == 0
    # HWIO (14, 14, 3, 768) -> OIHW (768, 3, 14, 14): the output channels
    assert tp_shard_axis((768, 3, 14, 14), "conv", 4) == 0
    assert tp_shard_axis((255, 64), "linear", 2) is None  # under min_dim
    assert tp_shard_axis((768,), "same", 2) is None  # fewer than 2 axes
    assert tp_shard_axis((2304, 768), "linear", 1) is None  # a model axis of 1


# ------------------------------------------------------------------ spawned worlds
def _vit_case(seed=0):
    """The narrow ViT's JAX variables with random nonzero LayerScale,
    LayerNorm and biases; the port's state dict; inputs and cotangent."""
    rng = np.random.default_rng(seed)
    model = jax_vit.ViTBackbone(**NARROW_VIT)
    x = rng.standard_normal((4, 56, 56, 3)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(seed),
                                                            jnp.asarray(x[:1]))["params"])

    def randomize(path, v):
        name = jax.tree_util.keystr(path)
        if "gamma" in name:
            return (0.5 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        if "bias" in name:
            return (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        if "norm" in name and "scale" in name:
            return (1 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        return v

    params = jax.tree_util.tree_map_with_path(randomize, params)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x))["cls"])
    cot = rng.standard_normal(ref.shape).astype(np.float32)
    return vit_state_dict(params), torch.from_numpy(x), torch.from_numpy(cot), ref


def _tiny_case(seed=1, kind="tiny"):
    kwargs = dict(embedding_dim=16, generator=torch.Generator().manual_seed(seed))
    model, _ = tp_model(kind, kwargs if kind == "tiny" else {})
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.randn((4, 32, 32, 3), generator=gen)
    return model.state_dict(), x, torch.randn((4, 16 if kind == "tiny" else 32), generator=gen)


def world_one(kind, kwargs, state_dict, x, cot, env, monkeypatch):
    """The port's unsplit output and gradients."""
    for flag in ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_MLP"):
        monkeypatch.delenv(flag, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    model, key = tp_model(kind, kwargs)
    model.load_state_dict(state_dict)
    y = model(x)[key]
    (y * cot).sum().backward()
    return y.detach(), {k: p.grad for k, p in model.named_parameters()}


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def check_grads(rec, grads):
    """Every replicated gradient against world 1's, every piece's against its
    slice of world 1's, relative to the largest magnitude of world 1's."""
    for name, g in rec["grads"].items():
        assert _rel(g, grads[name]) <= TOL, name
    for name, (dim, rows, g) in rec["pieces"].items():
        full = grads[name]
        assert _rel(g, full.index_select(dim, rows)) <= TOL, name
    assert set(rec["grads"]) | set(rec["pieces"]) == set(grads)


@pytest.fixture(scope="module")
def vit_case():
    return _vit_case()


@pytest.fixture(scope="module")
def tiny_case():
    return _tiny_case()


@pytest.fixture(scope="module")
def narrowing_case():
    return _tiny_case(2, "narrowing")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, vit_case, tiny_case, narrowing_case):
    """Each mesh's spawned world, run once for the module's tests."""
    sd, x, cot, _ = vit_case
    tsd, tx, tcot = tiny_case
    nsd, nx, ncot = narrowing_case
    vit = [{"model": ("vit", NARROW_VIT), "state_dict": sd, "x": x, "cotangent": cot, "env": env}
           for env in ({}, FUSED)]
    tiny_kwargs = dict(embedding_dim=16)
    tiny = [{"model": ("tiny", tiny_kwargs), "state_dict": tsd, "x": tx, "cotangent": tcot,
             "min_dim": 16},
            {"model": ("narrowing", {}), "state_dict": nsd, "x": nx, "cotangent": ncot,
             "min_dim": 16}]
    rng = np.random.default_rng(0)
    mx = jnp.asarray(rng.standard_normal((16, 64)), jnp.float32)
    variables = M().init(jax.random.PRNGKey(0), mx)
    mlp_ref = np.asarray(M().apply(variables, mx)["embedding"])
    msd = mlp_state_dict(jax.tree_util.tree_map(np.asarray, variables["params"]))
    mcot = torch.from_numpy(rng.standard_normal(mlp_ref.shape).astype(np.float32))
    mlp = [{"model": ("mlp", {}), "state_dict": msd, "x": torch.from_numpy(np.array(mx)),
            "cotangent": mcot}]
    out = {}
    for shape, cases in (((1, 2), vit + tiny), ((2, 2), vit), ((4, 2), mlp)):
        tmp = tmp_path_factory.mktemp(f"tp{shape[0]}x{shape[1]}")
        out[shape] = run_world(tp_worker, shape[0] * shape[1], tmp, shape, cases)
    out["mlp"] = (msd, torch.from_numpy(np.array(mx)), mcot, mlp_ref)
    return out


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (4, 2)])
def test_mesh_layout(worlds, shape):
    d, m = shape
    for rank, rec in enumerate(worlds[shape]):
        assert rec["coords"] == (rank // m, rank % m)
        assert rec["row"] == list(range((rank // m) * m, (rank // m + 1) * m))
        assert rec["column"] == list(range(rank % m, d * m, m))


def test_default_mesh_shape_is_data_only():
    mesh = Mesh(world=3, rank=2, device=torch.device("cpu"))
    assert (mesh.shape, mesh.n_data, mesh.n_model, mesh.data_rank, mesh.model_rank) == (
        (3, 1), 3, 1, 2, 0)
    # a model axis of 1 shards nothing, and the transform leaves the model as it is
    module, _ = tp_model("vit", NARROW_VIT)
    assert all(v is None for v in auto_param_shardings(module, mesh).values())
    before = {k: v.clone() for k, v in module.state_dict().items()}
    assert tpm.tensor_parallel(module, tp=1) is module
    assert module.state_dict().keys() == before.keys()
    # the ranks of one data row take the same rows
    x = torch.arange(6.0)[:, None]
    rows = [shard_batch(x, Mesh(world=4, rank=r, device=torch.device("cpu"), shape=(2, 2)))[0]
            for r in range(4)]
    assert torch.equal(rows[0], rows[1]) and torch.equal(rows[2], rows[3])
    assert torch.equal(torch.cat([rows[0], rows[2]]), x)
    with pytest.raises(ValueError):
        Mesh(world=4, rank=0, device=torch.device("cpu"), shape=(3, 2))


def test_mlp_at_4x2_matches_jax(worlds, monkeypatch):
    msd, mx, mcot, ref = worlds["mlp"]
    one, grads = world_one("mlp", {}, msd, mx, mcot, {}, monkeypatch)
    assert np.abs(one.numpy() - ref).max() <= TOL
    for rec in worlds[(4, 2)]:
        case = rec["cases"][0]
        assert np.abs(case["out"].numpy() - ref).max() <= TOL
        assert (case["out"] - one).abs().max() <= TOL
        check_grads(case, grads)
        # wide1 by its outputs, wide2 by its inputs: nothing gathered whole
        assert {k: v[0] for k, v in case["pieces"].items()} == {"wide1.weight": 0,
                                                               "wide2.weight": 1}
        assert case["gathers"] == {}


@pytest.mark.parametrize("path", ["eager", "fused"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_narrow_vit(worlds, vit_case, monkeypatch, shape, path):
    sd, x, cot, ref = vit_case
    env = FUSED if path == "fused" else {}
    one, grads = world_one("vit", NARROW_VIT, sd, x, cot, env, monkeypatch)
    if path == "eager":
        assert np.abs(one.numpy() - ref).max() <= TOL
    for rec in worlds[shape]:
        case = rec["cases"][0 if path == "eager" else 1]
        assert (case["out"] - one).abs().max() <= TOL
        if path == "eager":
            assert np.abs(case["out"].numpy() - ref).max() <= TOL
        check_grads(case, grads)
        # every kind of leaf is split; only pos_embed and cls_token are gathered whole
        assert {k.split(".")[-2] if k.startswith("blocks") else k: v[0]
                for k, v in case["pieces"].items()} == {
            "qkv": 0, "proj": 1, "fc1": 0, "fc2": 1, "cls_token": 2, "pos_embed": 2,
            "patch_embed.proj.weight": 0}
        assert case["gathers"] == {"cls_token": 1, "pos_embed": 1}


@pytest.mark.parametrize("split", ["rule", "rows"])
def test_tiny_convolutions(worlds, tiny_case, narrowing_case, monkeypatch, split):
    """The rule at min_dim 16: the tiny model's widening convolutions by
    their outputs and its fc by rows ("rule"); narrowing convolutions by
    their inputs, 1x1 and 3x3 with padding, and a widening head by its
    outputs ("rows")."""
    if split == "rule":
        (tsd, tx, tcot), kind, kwargs = tiny_case, "tiny", dict(embedding_dim=16)
    else:
        (tsd, tx, tcot), kind, kwargs = narrowing_case, "narrowing", {}
    one, grads = world_one(kind, kwargs, tsd, tx, tcot, {}, monkeypatch)
    for rec in worlds[(1, 2)]:
        case = rec["cases"][2 if split == "rule" else 3]
        assert (case["out"] - one).abs().max() <= TOL
        check_grads(case, grads)
        want = ({"backbone_conv0.weight": 0, "backbone_conv1.weight": 0,
                 "backbone_conv2.weight": 0, "fc.weight": 1} if split == "rule" else
                {"conv0.weight": 0, "conv1.weight": 1, "conv2.weight": 1, "fc.weight": 0})
        assert {k: v[0] for k, v in case["pieces"].items()} == want
        assert case["gathers"] == {}


class _Convs(torch.nn.Module):
    """A depthwise and a grouped convolution, a narrowing pointwise one, and
    a head whose weight is read whole (as a kernel that takes its weight
    reads it). At min_dim 4 the rule splits the first two by their outputs
    and the last two by their inputs."""

    def __init__(self):
        super().__init__()
        self.dw = torch.nn.Conv2d(8, 8, 3, padding=1, groups=8)
        self.grouped = torch.nn.Conv2d(8, 8, 3, padding=1, groups=2)
        self.pw = torch.nn.Conv2d(8, 4, 1)
        self.head = torch.nn.Linear(4, 2)

    def forward(self, x):
        h = self.pw(torch.relu(self.grouped(self.dw(x))))
        return torch.nn.functional.linear(h.mean(dim=(2, 3)), self.head.weight, self.head.bias)


@pytest.mark.parametrize("tp", [2, 4])
def test_local_axis_groups_and_gathers_at_use(tp):
    """Every rank's pieces in one process (LocalAxis): a depthwise split by
    output channels takes its groups' inputs; a grouped convolution whose
    groups a split would cut (tp = 4: 2 channels of a group of 4) and a
    weight read whole are gathered at use and counted; the pointwise one
    split by rows. Outputs and gradients against the unsplit module."""
    torch.manual_seed(0)
    ref = _Convs()
    with torch.no_grad():
        for p in ref.parameters():
            p.add_(0.1 * torch.randn_like(p))
    model = _Convs()
    model.load_state_dict(ref.state_dict())
    tpm.tensor_parallel(model, tp=tp, min_dim=4)
    assert {m.name: m.dim for m in model.modules() if isinstance(m, tpm.ShardedLeaf)} == {
        "dw.weight": 0, "grouped.weight": 0, "pw.weight": 1, "head.weight": 1}
    x = torch.randn(3, 8, 6, 6)
    tpm.GATHERS.clear()
    out, want = model(x), ref(x)
    assert (out - want).abs().max() <= TOL
    assert tpm.GATHERS == ({"head.weight": 1, "grouped.weight": 1} if tp == 4
                           else {"head.weight": 1})
    out.sum().backward()
    want.sum().backward()
    grads = {k: p.grad for k, p in ref.named_parameters()}
    for name, module in model.named_modules():
        if isinstance(module, tpm.ShardedLeaf):
            for r in range(tp):
                lo, hi = module.bounds(r)
                assert _rel(module.piece(r).grad, grads[module.name].narrow(
                    module.dim, lo, hi - lo)) <= TOL, module.name
    for name, p in model.named_parameters():
        if ".pieces." not in name:
            assert _rel(p.grad, grads[name]) <= TOL, name


def test_local_vit_block_is_head_major():
    """Every rank's pieces of the narrow ViT at tp = 2 in one process: each
    block a ShardedViTBlock whose qkv piece r is rank r's heads' q | k | v
    (the rule's rows, permuted), read back whole in qkv's own order; the
    embeddings, the attention maps (ViTBlock's path on the gathered weights)
    and every gradient against the unsplit model."""
    sd, x, cot, ref = _vit_case(3)
    one, _ = tp_model("vit", NARROW_VIT)
    one.load_state_dict(sd)
    model, _ = tp_model("vit", NARROW_VIT)
    model.load_state_dict(sd)
    tpm.tensor_parallel(model, tp=2)
    assert all(isinstance(b, tpm.ShardedViTBlock) for b in model.blocks)
    hd, c = 64, NARROW_VIT["dim"]
    want = [torch.cat([torch.arange(i * c + r * 2 * hd, i * c + (r + 1) * 2 * hd)
                       for i in range(3)]) for r in range(2)]
    qkv = model.blocks[0].attn.qkv
    for r in range(2):
        assert torch.equal(qkv.shards.rows(r), want[r])
        assert torch.equal(qkv.piece(r), sd["blocks.0.attn.qkv.weight"][want[r]])
    assert torch.equal(qkv.weight, sd["blocks.0.attn.qkv.weight"])
    tpm.GATHERS.clear()
    out, want_out = model(x), one(x)
    assert (out["cls"] - want_out["cls"]).abs().max() <= TOL
    assert np.abs(out["cls"].detach().numpy() - ref).max() <= TOL
    assert tpm.GATHERS == {"cls_token": 1, "pos_embed": 1}
    maps, want_maps = model(x, True)["attentions"], one(x, True)["attentions"]
    assert all((a - b).abs().max() <= TOL for a, b in zip(maps, want_maps))
    (out["cls"] * cot).sum().backward()
    (want_out["cls"] * cot).sum().backward()
    grads = {k: p.grad for k, p in one.named_parameters()}
    leaves = tp_piece_leaves(model)
    for name, p in model.named_parameters():
        if name in leaves:
            leaf, dim, rows = leaves[name]
            assert _rel(tp_piece_grad(name, p.grad, dim),
                        grads[leaf].index_select(dim, rows)) <= TOL, name
        else:
            assert _rel(p.grad, grads[name]) <= TOL, name
