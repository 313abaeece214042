"""Distillation in the port against the JAX package: DistillEmbedder at full
width on small images (student eval output; the train-mode teacher embedding
at teacher_img_size 28 with and without the RAD-DINO normalisation; weights
carried across by ``convert.distill_state_dict_from_jax``), the teacher's
resize against ``jax.image.resize``, the registry specs and the checkpoint
loader, three distillation train steps of narrow models in both stacks (f32,
bf16, weight decay), the embedding step on a distillation model (which
runs no teacher here), every parameter's optimiser group for the four models
of this slice against the JAX optimiser's, and ``cli.train`` with a
distillation model -> ``cli.ingest`` -> ``cli.query``. CPU only; each
tolerance is stated where it is used."""
from __future__ import annotations

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_nih import assert_close, jax_variables
from test_torch_train import LABELS, _compare_states, _images, _records
from torch_parity_models import NARROW_CONVNEXT, JaxNarrowConvNeXt
from xmir_tpu.losses.metric_losses import l2_normalize as jax_l2_normalize
from xmir_tpu.models import embedders as jax_embedders
from xmir_tpu.models import registry as jax_registry
from xmir_tpu.models.vit import ViTBackbone as JaxViT
from xmir_tpu.train import optim as jax_optim
from xmir_tpu.train import state as jax_state
from xmir_tpu.train import steps as jax_steps
from xmir_tpu_torch.cli import ingest, query
from xmir_tpu_torch.cli import train as train_cli
from xmir_tpu_torch.models import convert, registry
from xmir_tpu_torch.models.embedders import DistillEmbedder, teacher_input
from xmir_tpu_torch.train import (
    TrainState,
    build_optimizer,
    make_distill_train_step,
    make_embedding_train_step,
)
from xmir_tpu_torch.utils import checkpoint

torch.set_num_threads(2)


@pytest.mark.parametrize("shape,size", [((2, 384, 384, 3), 518), ((2, 64, 64, 3), 28),
                                        ((1, 30, 30, 3), 30)], ids=["grow", "shrink", "same"])
@pytest.mark.parametrize("rad", [False, True], ids=["dino", "raddino"])
def test_teacher_input_matches_jax(shape, size, rad):
    """The teacher's view of the input against the JAX module's lines
    (clip, jax.image.resize "bilinear", RAD-DINO normalisation): within
    1e-5 (1 + |jax|) over every row and column, the edge ones included. The
    input spans normalised values past the [0, 1] clip."""
    x = (2.5 * np.random.default_rng(1).standard_normal(shape)).astype(np.float32)
    tx = jnp.asarray(x)
    if rad:
        mean, std = jnp.asarray([0.485, 0.456, 0.406]), jnp.asarray([0.229, 0.224, 0.225])
        tx = jnp.clip(tx * std + mean, 0.0, 1.0)
    tx = jax.image.resize(tx, (shape[0], size, size, shape[3]), "bilinear")
    if rad:
        tx = (tx - 0.5307) / 0.2583
    got = teacher_input(torch.from_numpy(x), size, rad).numpy()
    assert_close(got, np.asarray(tx), 1e-5)
    for edge in (got[:, 0], got[:, -1], got[:, :, 0], got[:, :, -1]):
        assert np.isfinite(edge).all()


@pytest.fixture(scope="module")
def full_width_distill():
    """(images, JAX variables, the port's model with the same weights): a
    ConvNeXtV2-Base student and a ViT-B/14 teacher at teacher_img_size 28,
    on two 64 x 64 images."""
    x = _images(2, 64, seed=6)
    model = jax_embedders.DistillEmbedder(teacher_img_size=28)
    variables = jax_variables(model, jnp.asarray(x), seed=7, train=True)
    port = DistillEmbedder(teacher_img_size=28)
    port.load_state_dict(convert.distill_state_dict_from_jax(jax.device_get(variables)),
                         strict=True)
    return x, variables, port


def test_student_eval_output_matches_jax(full_width_distill):
    """Eval mode: the student's embedding and features only, within 1e-4
    (1 + |jax|)."""
    x, variables, port = full_width_distill
    want = jax.jit(lambda v, i: jax_embedders.DistillEmbedder(teacher_img_size=28).apply(v, i))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x), with_teacher=True)
    assert set(got) == set(want) == {"embedding", "features"}
    for key in want:
        assert_close(got[key].numpy(), want[key], 1e-4)
    assert {k.split(".")[0] for k in port.state_dict()} == {"student", "teacher"}


@pytest.mark.parametrize("rad", [False, True], ids=["dino", "raddino"])
def test_train_mode_teacher_embedding_matches_jax(full_width_distill, rad):
    """Train mode with the teacher: the teacher embedding (its input resized
    to 28, RAD-DINO-normalised or not) and the student's embedding within
    1e-4 (1 + |jax|); the teacher's carries no gradient."""
    x, variables, port = full_width_distill
    model = jax_embedders.DistillEmbedder(teacher_img_size=28, rad_dino_norm=rad)
    want = jax.jit(lambda v, i: model.apply(v, i, train=True))(variables, jnp.asarray(x))
    port.rad_dino_norm = rad
    try:
        got = port.train()(torch.from_numpy(x), with_teacher=True)
    finally:
        port.rad_dino_norm = False
    assert set(got) == set(want)
    for key in ("teacher_embedding", "embedding"):
        assert_close(got[key].detach().numpy(), want[key], 1e-4)
    assert not got["teacher_embedding"].requires_grad and got["embedding"].requires_grad
    assert set(port.train()(torch.from_numpy(x))) == {"embedding", "features"}


@pytest.mark.parametrize("name", ["convnextv2_dino_distill", "convnextv2_raddino_distill"])
def test_registry_spec_matches_jax(name):
    spec, ref = registry.get_spec(name), jax_registry.get_spec(name)
    for field in ("name", "input_size", "resize_size", "embed_dim", "mean", "std", "kwargs",
                  "interpolation"):
        assert getattr(spec, field) == getattr(ref, field), field
    model, _ = registry.create_model(name, embedding_dim=8, depths=(1, 1, 1, 1),
                                     dims=(8, 16, 32, 64), teacher_img_size=28, teacher_dim=32,
                                     teacher_depth=1, teacher_num_heads=2)
    assert isinstance(model, DistillEmbedder) and model.student.fc.out_features == 8
    assert model.rad_dino_norm == (name == "convnextv2_raddino_distill")


NARROW_STUDENT = dict(depths=NARROW_CONVNEXT["depths"], dims=NARROW_CONVNEXT["dims"])
# the student's embedding is as wide as the teacher's CLS: the distillation
# term is their inner product
NARROW_TEACHER = dict(teacher_dim=32, teacher_depth=2, teacher_num_heads=2)
NARROW_EMBED = 32


def narrow_port(**kw):
    return DistillEmbedder(NARROW_EMBED, 28, **kw, **NARROW_STUDENT, **NARROW_TEACHER)


def test_checkpoint_loader_raises_on_a_timm_layout(tmp_path):
    """A timm .pt does not load into a distillation model (the JAX package
    merges it into params["backbone"], which the model lacks, so it loads
    nothing): the loader raises and names the layout. A train-CLI
    checkpoint loads whole."""
    pt = str(tmp_path / "timm.pt")
    torch.save({"stem.0.weight": torch.zeros(8, 3, 4, 4)}, pt)
    model = narrow_port()
    with pytest.raises(ValueError, match=r"student\.convnext.*params\['backbone'\]"):
        convert.load_torch_checkpoint(model, pt)
    other = narrow_port(generator=torch.Generator().manual_seed(2))
    whole = str(tmp_path / "train.pt")
    torch.save({"state_dict": other.state_dict(), "optimizer": {}, "step": 1, "epoch": 1}, whole)
    convert.load_torch_checkpoint(model, whole)
    assert all(torch.equal(v, other.state_dict()[k]) for k, v in model.state_dict().items())


# --- three distillation train steps in both stacks --------------------------------


class JaxNarrowDistill(fnn.Module):
    """xmir_tpu's DistillEmbedder with a narrow student and teacher: the same
    __call__ body."""

    rad_dino_norm: bool = False

    @fnn.compact
    def __call__(self, x, train: bool = False):
        student = JaxNarrowConvNeXt(embedding_dim=NARROW_EMBED, name="student")(x, train)
        result = {"embedding": student["embedding"], "features": student["features"]}
        if train:
            tx = x
            if self.rad_dino_norm:
                mean = jnp.asarray([0.485, 0.456, 0.406])
                std = jnp.asarray([0.229, 0.224, 0.225])
                tx = jnp.clip(tx * std + mean, 0.0, 1.0)
            tx = jax.image.resize(tx, (x.shape[0], 28, 28, x.shape[3]), "bilinear")
            if self.rad_dino_norm:
                tx = (tx - 0.5307) / 0.2583
            t_out = JaxViT(img_size=28, dim=32, depth=2, num_heads=2, name="teacher")(tx)
            result["teacher_embedding"] = jax.lax.stop_gradient(
                jax_l2_normalize(t_out["cls"], axis=1))
        return result


LR = 1e-4


def run_distill(compute="f32", steps=3, weight_decay=0.0, embedding_step=False, rad=False):
    """``steps`` distillation steps (triplet, distill_weight 0.5) or
    embedding steps in both stacks from the same weights on the same
    batches. Returns (JAX metrics, port metrics, JAX final state dict, port
    final state dict, port start state dict, teacher forwards in the
    port)."""
    model = JaxNarrowDistill(rad_dino_norm=rad)
    variables = dict(jax_variables(model, jnp.zeros((1, 64, 64, 3)), seed=9, train=True))
    port = narrow_port(rad_dino_norm=rad)
    port.load_state_dict(convert.distill_state_dict_from_jax(jax.device_get(variables)),
                         strict=True)
    port.train()
    forwards = []
    port.teacher.register_forward_hook(lambda *a: forwards.append(1))
    start = {k: v.clone() for k, v in port.state_dict().items()}
    tx = jax_optim.build_optimizer(variables["params"], lr=LR, weight_decay=weight_decay)
    jstate = jax_state.create_train_state(model, jax.random.PRNGKey(0), None, tx,
                                          variables=variables)
    state = TrainState(port, build_optimizer(port, lr=LR, weight_decay=weight_decay,
                                             backbone_prefixes=train_cli.BACKBONE_PREFIXES))
    jdt = jnp.bfloat16 if compute == "bf16" else jnp.float32
    tdt = torch.bfloat16 if compute == "bf16" else torch.float32
    if embedding_step:
        jstep = jax_steps.make_embedding_train_step(model, "triplet", {"margin": 0.2},
                                                    compute_dtype=jdt)
        step = make_embedding_train_step(port, "triplet", {"margin": 0.2}, compute_dtype=tdt)
    else:
        jstep = jax_steps.make_distill_train_step(model, "triplet", 0.5, {"margin": 0.2},
                                                  compute_dtype=jdt)
        step = make_distill_train_step(port, "triplet", 0.5, {"margin": 0.2}, compute_dtype=tdt)
    jstep = jax.jit(jstep)
    jm_all, tm_all = [], []
    for i in range(steps):
        x = _images(8, 64, seed=50 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(LABELS))
        tm = step(state, torch.from_numpy(x), torch.from_numpy(LABELS))
        assert not tm["loss"].requires_grad
        jm_all.append({k: float(v) for k, v in jm.items()})
        tm_all.append({k: v.item() for k, v in tm.items()})
    want = convert.distill_state_dict_from_jax(jax.device_get({"params": jstate.params}))
    return jm_all, tm_all, want, port.state_dict(), start, len(forwards)


def _teacher(sd):
    return {k: v for k, v in sd.items() if k.startswith("teacher.")}


@pytest.mark.parametrize("rad", [False, True], ids=["dino", "raddino"])
def test_three_distill_steps_match_jax_f32(rad):
    """loss, aux and distill of each step within 1e-5, distill in [0, 2];
    the student's parameters after the third as
    tests/test_torch_train.py::_compare_states holds them; the teacher
    bit-equal to its start in both stacks (weight decay 0), after one
    teacher forward a step and no backward through it."""
    jm, tm, want, got, start, forwards = run_distill(rad=rad)
    assert set(tm[0]) == {"loss", "aux", "distill"}
    for a, b in zip(jm, tm):
        for key in ("loss", "aux", "distill"):
            assert abs(a[key] - b[key]) <= 1e-5, (key, a, b)
        assert 0.0 <= b["distill"] <= 2.0
    student = lambda sd: {k: v for k, v in sd.items() if k.startswith("student.")}  # noqa: E731
    assert _compare_states(student(want), student(got), student(start)) > 1e-6
    for key, v in _teacher(got).items():
        assert torch.equal(v, start[key]) and torch.equal(want[key], start[key]), key
    assert forwards == 3


def test_distill_weight_decay_moves_the_teacher_as_optax_does():
    """Under AdamW the JAX package's frozen teacher is decayed (its zero
    gradients leave Adam's update at 0, the decay is added after): the
    port's teacher after three steps equals JAX's within one f32 rounding
    (2^-23 relative) and moved; the student as _compare_states holds it."""
    jm, tm, want, got, start, _ = run_distill(weight_decay=0.05)
    for a, b in zip(jm, tm):
        assert abs(a["loss"] - b["loss"]) <= 1e-5
    for key, v in _teacher(got).items():
        np.testing.assert_allclose(v.numpy(), want[key].numpy(), rtol=2 ** -23, atol=0)
        assert not torch.equal(v, start[key]) or not start[key].any(), key


def test_three_distill_steps_bf16_keep_f32_masters():
    """bf16 compute on f32 master weights: each term within 2e-2 of the JAX
    package's bf16 run; the teacher bit-equal to its start; every tensor
    f32."""
    jm, tm, _, got, start, _ = run_distill("bf16")
    for a, b in zip(jm, tm):
        for key in ("loss", "aux", "distill"):
            assert abs(a[key] - b[key]) <= 2e-2, (key, a, b)
    assert all(torch.equal(v, start[k]) for k, v in _teacher(got).items())
    assert all(v.dtype == torch.float32 for v in got.values())


def test_embedding_step_on_a_distill_model_runs_no_teacher():
    """The JAX CLI trains a distillation model through the embedding step,
    which computes the teacher and discards it. Here the teacher does not
    run (no forward), and the result is the same: losses within 1e-5 and
    the parameters as _compare_states holds them, the teacher bit-equal."""
    jm, tm, want, got, start, forwards = run_distill(embedding_step=True)
    assert forwards == 0
    for a, b in zip(jm, tm):
        assert abs(a["loss"] - b["loss"]) <= 1e-5, (a, b)
    _compare_states(want, got, start)
    assert all(torch.equal(v, start[k]) for k, v in _teacher(got).items())


# --- the optimiser's groups against the JAX optimiser's --------------------------------


def jax_cli_labels(params, freeze: bool):
    """{"/"-joined path: group} of the JAX train CLI's optimiser over
    ``params`` (shapes), read from optax's partition state: a leaf is the
    label whose Adam moments hold it, "frozen" if none does."""
    tx = jax_optim.build_optimizer(
        params, frozen_predicate=(lambda p: p.startswith("backbone")) if freeze else None)
    state = jax.eval_shape(tx.init, params)
    labels = {}
    for label, inner in state.inner_states.items():
        adams = [s for s in jax.tree_util.tree_leaves(
            inner, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        if not adams:
            continue
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                adams[0].mu, is_leaf=lambda s: isinstance(s, optax.MaskedNode))[0]:
            if not isinstance(leaf, optax.MaskedNode):
                labels[jax_optim._path_str(path)] = label
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        labels.setdefault(jax_optim._path_str(path), "frozen")
    return labels


GROUP_CODES = {"backbone": 1.0, "head": 2.0, "frozen": 3.0}


@pytest.mark.parametrize("name", ["nih_dinov2", "nih_convnextv2", "convnextv2_dino_distill",
                                  "convnextv2_raddino_distill"])
def test_parameter_groups_match_the_jax_cli(name):
    """Every parameter's group (backbone / head / frozen), with and without
    --freeze-backbone, at full width: the JAX CLI's labels, carried to the
    port's names by this slice's converters (each leaf filled with its
    label's code), equal the groups of cli.train's optimiser. So the NIH
    backbone trains at --backbone-lr-scale, a distillation model's student
    and teacher both fall in "head", and --freeze-backbone freezes nothing
    on it."""
    jax_model, spec = jax_registry.create_model(name)
    size = 28 if name.startswith("nih_dinov2") else 32
    shapes = jax.eval_shape(lambda r, v: jax_model.init(r, v, train=True),
                            jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))["params"]
    for freeze in (False, True):
        labels = jax_cli_labels(shapes, freeze)
        coded = jax.tree_util.tree_map_with_path(
            lambda path, leaf: np.full(leaf.shape, GROUP_CODES[labels[jax_optim._path_str(path)]],
                                       np.float32), shapes)
        if name.startswith("nih_"):
            sd = convert.nih_dual_head_state_dict_from_jax({"params": coded},
                                                           dict(spec.kwargs)["backbone"])
        else:
            sd = convert.distill_state_dict_from_jax({"params": coded})
        want = {key: {t.min().item(), t.max().item()} for key, t in sd.items()}
        with torch.device("meta"):  # names and groups only: no storage, no init
            port, _ = registry.create_model(name)
        args = train_cli.parse_args(["--freeze-backbone"] if freeze else [])
        groups = {id(p): g["name"] for g in train_cli.build_train_optimizer(port, args).param_groups
                  for p in g["params"]}
        got = {key: {GROUP_CODES[groups.get(id(p), "frozen")]}
               for key, p in port.named_parameters()}
        assert got == want
        assert all(p.requires_grad == (id(p) in groups) for p in port.parameters())
        if name.endswith("distill"):
            assert set().union(*got.values()) == {GROUP_CODES["head"]}
        del port, sd, coded
    assert isinstance(jax_model, (jax_embedders.NIHDualHeadModel, jax_embedders.DistillEmbedder))


# --- cli.train with a distillation model ------------------------------------------


@pytest.fixture
def narrow_distill(monkeypatch):
    """--model convnextv2_dino_distill with a narrow student and teacher at
    64 px (the CLI path is the same; full width runs on the card)."""
    kw = dict(**NARROW_STUDENT, teacher_img_size=28, teacher_dim=32, teacher_depth=1,
              teacher_num_heads=2)
    spec = dataclasses.replace(registry.get_spec("convnextv2_dino_distill"), input_size=64,
                               resize_size=64, kwargs=tuple(sorted(kw.items())))
    monkeypatch.setitem(registry._SPECS, "convnextv2_dino_distill", spec)
    calls = []
    real = DistillEmbedder.teacher_embedding
    monkeypatch.setattr(DistillEmbedder, "teacher_embedding",
                        lambda self, x: calls.append(1) or real(self, x))
    return calls


def test_cli_train_distill_model_then_serve(tmp_path, narrow_distill):
    """cli.train --model convnextv2_dino_distill, as the JAX CLI runs it
    (the embedding step): one epoch with evaluation; the teacher never
    runs and its tensors keep their seeded init, every student tensor moved;
    --freeze-backbone freezes nothing on it (the JAX CLI's labels); then
    cli.ingest -> cli.query on the checkpoint with the student."""
    base = ["--dataset", "synthetic", "--device", "cpu", "--model", "convnextv2_dino_distill",
            "--embedding-dim", "16", "-p", "2", "-k", "4", "-j", "2", "--print-freq", "1",
            "--eval-freq", "1", "--ckpt-every", "1", "--lr", "1e-3", "--epochs", "1",
            # on unit embeddings a margin of 2 keeps every triplet active
            "--margin", "2.0"]
    log = str(tmp_path / "log.jsonl")
    train_cli.main(base + ["--save-dir", str(tmp_path / "a"), "--metrics-log", log])
    name = checkpoint.checkpoint_name("synthetic", "convnextv2_dino_distill", 16, epoch=1)
    trained = checkpoint.load_checkpoint(str(tmp_path / "a" / name))
    fresh, _ = registry.create_model("convnextv2_dino_distill", embedding_dim=16,
                                     generator=torch.Generator().manual_seed(0))
    fresh = fresh.state_dict()
    for key, v in trained.items():
        assert torch.equal(v, fresh[key]) == key.startswith("teacher."), key
    train = [r for r in _records(log) if r["kind"] == "train"]
    assert train and all(np.isfinite(r["loss"]) for r in train) and "distill" not in train[0]
    train_cli.main(base + ["--save-dir", str(tmp_path / "f"), "--freeze-backbone"])
    frozen = checkpoint.load_checkpoint(str(tmp_path / "f" / name))
    assert all(not torch.equal(v, fresh[k]) for k, v in frozen.items()
               if k.startswith("student."))
    assert narrow_distill == []  # the teacher never ran
    serve = ["--dataset", "synthetic", "--device", "cpu", "--model", "convnextv2_dino_distill",
             "--embedding-dim", "16", "-j", "2", "--resume", str(tmp_path / "a" / name)]
    gal = str(tmp_path / "g.npz")
    ingest.main(serve + ["--split", "train", "--output", gal])
    hits = query.main(serve + ["--index", gal, "--top-k", "3",
                               "--output", str(tmp_path / "h.json")])
    assert np.load(gal)["embeds"].shape == (64, 16) and len(hits) == 32
    assert json.loads((tmp_path / "h.json").read_text())[0]["results"][0]["similarity"] <= 1.0
