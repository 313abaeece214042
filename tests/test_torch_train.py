"""The port's training stack (samplers, train transforms, train-mode
BatchNorm, optimiser, train step, checkpoints, cli.train) against the JAX
package on the same numpy inputs and converted weights. Tier 1: CPU only;
models are narrow (DINOv2: dim 128, depth 2, 2 heads, 56 px; DenseNet: growth
8, blocks (2, 2, 2, 2)); the full-width training slice runs on the card, in
chip_smoke.py. Each tolerance is stated where it is used.
"""
import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from torch_parity_models import NARROW, JaxNarrowEmbedder, randomized
from xmir_tpu.data import samplers as jax_samplers
from xmir_tpu.data import transforms as jax_transforms
from xmir_tpu.models import embedders as jax_embedders
from xmir_tpu.train import optim as jax_optim
from xmir_tpu.train import state as jax_state
from xmir_tpu.train import steps as jax_steps
from xmir_tpu.utils import checkpoint as jax_checkpoint
from xmir_tpu_torch.cli import train as train_cli
from xmir_tpu_torch.data import samplers, transforms
from xmir_tpu_torch.models import convert, registry
from xmir_tpu_torch.models.densenet import BatchNorm2d
from xmir_tpu_torch.models.embedders import DenseNet121Embedder, DinoV2Embedder
from xmir_tpu_torch.train import (
    TrainState,
    build_optimizer,
    make_embedding_train_step,
    unfreeze_last_blocks_predicate,
    with_grad_accumulation,
)
from xmir_tpu_torch.utils import checkpoint

torch.set_num_threads(2)

NARROW_VIT = dict(dim=128, depth=2, num_heads=2)


# --- samplers: the copy against the original ------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_pk_sampler_streams_equal_the_originals(seed):
    labels = list(np.random.default_rng(seed).integers(0, 5, 90)) + [9]  # 9: dropped, < k
    a, b = samplers.PKSampler(labels, 3, 4, seed=seed), jax_samplers.PKSampler(labels, 3, 4,
                                                                                 seed=seed)
    assert list(a) == list(b) and list(a) == list(b)  # the second epoch too
    assert a.epoch_length() == b.epoch_length()
    assert samplers.create_groups(labels, 4) == jax_samplers.create_groups(labels, 4)
    with pytest.raises(ValueError, match="groups"):
        samplers.PKSampler([0, 0, 1], p=3, k=1)


@pytest.mark.parametrize("base_order", [None, list(range(19, -1, -1))])
def test_hard_mining_sampler_stream_equals_the_originals(base_order):
    scores = np.random.default_rng(1).random(20).tolist()
    kw = dict(num_hard=5, base_order=base_order, batch_size=6, seed=3)
    assert list(samplers.HardMiningSampler(20, scores, **kw)) == list(
        jax_samplers.HardMiningSampler(20, scores, **kw))
    assert len(samplers.HardMiningSampler(20, scores, **kw)) == 20


@pytest.mark.parametrize("drop_last", [True, False])
def test_multilabel_sampler_stream_equals_the_originals(drop_last):
    rng = np.random.default_rng(2)
    labels = (rng.random((50, 6)) < 0.25).astype(np.float32)
    labels[:, 5] = 0  # a label nobody has
    kw = dict(batch_size=12, labels_per_batch=4, samples_per_label=3, drop_last=drop_last, seed=5)
    a = samplers.MultiLabelBalancedBatchSampler(labels, **kw)
    b = jax_samplers.MultiLabelBalancedBatchSampler(labels, **kw)
    assert len(a) == len(b) and list(a) == list(b)


# --- train transforms: the arithmetic on replayed draws ---------------------------

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _jax_draws(key, b, h, w, crop, rand_resize):
    """The draws ``train_preprocess`` makes from ``key`` (:124-146), replayed."""
    k_crop, k_flip, k_bright, k_contrast = jax.random.split(key, 4)
    zeros = np.zeros(b, np.int64)
    return {
        "tops": torch.from_numpy(np.asarray(jax.random.randint(k_crop, (b,), 0, h - crop + 1),
                                            np.int64) if rand_resize else zeros),
        "lefts": torch.from_numpy(np.asarray(jax.random.randint(k_crop, (b,), 0, w - crop + 1),
                                             np.int64) if rand_resize else zeros),
        "flip": torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))),
        "brightness": torch.from_numpy(np.array(
            jax.random.uniform(k_bright, (b,), minval=0.9, maxval=1.1))),
        "contrast": torch.from_numpy(np.array(
            jax.random.uniform(k_contrast, (b,), minval=0.9, maxval=1.1))),
    }


@pytest.mark.parametrize("jitter", [True, False])
@pytest.mark.parametrize("rand_resize", [True, False])
@pytest.mark.parametrize("size,resize,crop,method", [(40, 40, 32, "bilinear"),
                                                     (50, 40, 32, "bilinear"),
                                                     (30, 40, 32, "bicubic")])
def test_apply_train_augment_matches_jax(size, resize, crop, method, rand_resize, jitter):
    """1e-3 on the 0..255 scale where a resize is involved (the two resizes
    agree to that, tests/test_torch_slice.py), 1e-5 on the normalised values
    otherwise."""
    imgs = np.random.default_rng(size).integers(0, 256, (6, size, size + 4, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(size + crop)
    want = np.asarray(jax_transforms.train_preprocess(
        key, jnp.asarray(imgs), resize, crop, MEAN, STD, rand_resize=rand_resize, jitter=jitter,
        method=method))
    x = transforms.resize_short_side(torch.from_numpy(imgs).float(), resize, method)
    draws = _jax_draws(key, 6, x.shape[1] + 8, x.shape[2] + 8, crop, rand_resize)
    got = transforms.apply_train_augment(x, draws, crop, MEAN, STD, rand_resize, jitter).numpy()
    assert got.shape == want.shape == (6, crop, crop, 3)
    atol = 1e-3 / (255 * min(STD)) if size != resize else 1e-5
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_draws_are_seeded_independent_and_in_range():
    draws = transforms.draw_train_augment(torch.Generator().manual_seed(3), 512, 12, 12)
    again = transforms.draw_train_augment(torch.Generator().manual_seed(3), 512, 12, 12)
    assert all(torch.equal(draws[k], again[k]) for k in draws)
    assert draws["tops"].min() == 0 and draws["tops"].max() == 12
    assert not torch.equal(draws["tops"], draws["lefts"])  # the JAX package draws them equal
    assert 0.3 < draws["flip"].float().mean() < 0.7
    for k in ("brightness", "contrast"):
        assert 0.9 <= draws[k].min() and draws[k].max() < 1.1
    spec = registry.get_spec("densenet121")
    imgs = torch.randint(0, 256, (2, 256, 256, 3), dtype=torch.uint8)
    out = transforms.preprocess_for_spec(imgs, spec, train=True, rand_resize=True,
                                         generator=torch.Generator().manual_seed(0))
    assert out.shape == (2, 224, 224, 3) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="Generator"):
        transforms.preprocess_for_spec(imgs, spec, train=True)
    np.testing.assert_array_equal(
        transforms.preprocess_for_spec(imgs, spec).numpy(),
        transforms.eval_preprocess(imgs, 256, 224, spec.mean, spec.std).numpy())


# --- BatchNorm in training mode ----------------------------------------------------


def test_batchnorm_train_mode_matches_flax():
    """Output and both running buffers after three batches: 1e-5, f32. The
    running variance takes the BIASED batch variance, as flax's does."""
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    rng = np.random.default_rng(0)
    batches = [(rng.standard_normal((4, 5, 5, 6)) * 2 + 1).astype(np.float32) for _ in range(3)]
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(batches[0]))
    scale, bias = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.standard_normal(6).astype(
        np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": variables["batch_stats"]}
    port = BatchNorm2d(6).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
    for x in batches:
        want, updates = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": updates["batch_stats"]}
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5)
    assert "num_batches_tracked" not in port.state_dict()
    # what torch's own update would have left: the unbiased variance, n / (n - 1) larger
    theirs = nn.BatchNorm2d(6, momentum=0.1).train()
    for x in batches:
        theirs(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert (theirs.running_var - port.running_var).abs().max() > 1e-3
    # eval mode reads the buffers and leaves them alone
    before = port.running_var.clone()
    port.eval()(torch.from_numpy(batches[0]).permute(0, 3, 1, 2))
    assert torch.equal(port.running_var, before)


def test_batchnorm_train_mode_bf16_keeps_f32_statistics():
    x = torch.randn((4, 6, 5, 5), generator=torch.Generator().manual_seed(0)) * 2 + 1
    a, b = BatchNorm2d(6).train(), BatchNorm2d(6).train()
    out = a(x.bfloat16())
    ref = b(x.bfloat16().float())
    assert out.dtype == torch.bfloat16 and a.running_var.dtype == torch.float32
    assert torch.equal(a.running_mean, b.running_mean) and torch.equal(a.running_var,
                                                                       b.running_var)
    assert torch.equal(out, ref.bfloat16())
    x.requires_grad_(True)
    a(x).sum().backward()  # the buffers' in-place update does not break the graph
    assert torch.isfinite(x.grad).all()


# --- optimiser -----------------------------------------------------------------------

TOY_SHAPES = {("backbone", "frozen", "w"): (4, 3), ("backbone", "a", "w"): (5, 4),
              ("backbone", "a", "b"): (4,), ("fc", "kernel"): (4, 2), ("fc", "bias"): (2,)}


class Toy(nn.Module):
    """Parameters named as TOY_SHAPES' paths joined by dots."""

    def __init__(self, values):
        super().__init__()
        self.backbone = nn.ModuleDict({
            "frozen": nn.ParameterDict({"w": nn.Parameter(values["backbone", "frozen", "w"])}),
            "a": nn.ParameterDict({"w": nn.Parameter(values["backbone", "a", "w"]),
                                   "b": nn.Parameter(values["backbone", "a", "b"])})})
        self.fc = nn.ParameterDict({"kernel": nn.Parameter(values["fc", "kernel"]),
                                    "bias": nn.Parameter(values["fc", "bias"])})


def _toy_tree(values):
    tree = {}
    for path, v in values.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(v)
    return tree


def _toy_grads(rng, step):
    """Gradients whose "backbone" norm is far above the clip of 5 on even
    steps and below it on odd ones, while "head" stays below it throughout
    (one norm over all of them would clip the head too)."""
    gain = {"backbone": 40.0 if step % 2 == 0 else 0.3, "fc": 0.5}
    return {path: (rng.standard_normal(shape) * gain[path[0]]).astype(np.float32)
            for path, shape in TOY_SHAPES.items()}


@pytest.mark.parametrize("weight_decay,mu_dtype,accum", [
    (0.0, None, 1), (0.05, None, 1), (0.0, "bfloat16", 1), (0.0, None, 3), (0.05, "bfloat16", 3)])
def test_optimizer_matches_optax(weight_decay, mu_dtype, accum):
    """Parameters after each of 5 updates (15 micro-batches under
    accumulation) against ``build_optimizer``'s optax transformation on the
    same gradients: 1e-6 at updates of 1e-4 (head) and 1e-5 (backbone)."""
    rng = np.random.default_rng(0)
    values = {p: rng.standard_normal(s).astype(np.float32) for p, s in TOY_SHAPES.items()}
    params = _toy_tree(values)
    tx = jax_optim.build_optimizer(
        params, lr=1e-4, weight_decay=weight_decay,
        frozen_predicate=lambda p: p.startswith("backbone/frozen"),
        mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    opt_state = tx.init(params)
    model = Toy({p: torch.from_numpy(v.copy()) for p, v in values.items()})
    opt = build_optimizer(model, lr=1e-4, weight_decay=weight_decay,
                          frozen_predicate=lambda n: n.startswith("backbone.frozen"),
                          mu_dtype=None if mu_dtype is None else torch.bfloat16)
    state = TrainState(model, opt)
    if accum > 1:
        with_grad_accumulation(state, accum)
    assert not model.backbone["frozen"]["w"].requires_grad
    assert [g["name"] for g in opt.param_groups] == ["backbone", "head"]
    named = dict(model.named_parameters())
    for step in range(5 * accum):
        grads = _toy_grads(rng, step // accum + step)
        updates, opt_state = tx.update(_toy_tree(grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        for path, g in grads.items():
            named[".".join(path)].grad = torch.from_numpy(g.copy())
        state.apply_gradients()
        for path in TOY_SHAPES:
            node = params
            for key in path:
                node = node[key]
            np.testing.assert_allclose(named[".".join(path)].detach().numpy(), np.asarray(node),
                                       atol=1e-6, rtol=0, err_msg=f"step {step} {path}")
    assert state.step == 5 * accum
    assert np.array_equal(named["backbone.frozen.w"].detach().numpy(),
                          values["backbone", "frozen", "w"])
    assert np.abs(named["fc.kernel"].detach().numpy() - values["fc", "kernel"]).max() > 1e-4
    if mu_dtype:
        assert opt.state[named["fc.kernel"]]["mu"].dtype == torch.bfloat16
        assert opt.state[named["fc.kernel"]]["nu"].dtype == torch.float32


def test_optimizer_state_dict_round_trip_is_exact():
    """Moments, counts, the accumulation buffer and the micro-step survive a
    ``torch.save`` / ``weights_only`` load: the next updates are bit-equal."""
    def fresh():
        rng = np.random.default_rng(1)
        model = Toy({p: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                     for p, s in TOY_SHAPES.items()})
        opt = build_optimizer(model, lr=1e-3, weight_decay=0.01, mu_dtype=torch.bfloat16)
        return with_grad_accumulation(TrainState(model, opt), 2)

    def run(state, steps, rng):
        for step in steps:
            for path, g in _toy_grads(rng, step).items():
                dict(state.model.named_parameters())[".".join(path)].grad = torch.from_numpy(g)
            state.apply_gradients()

    a, b = fresh(), fresh()
    run(a, range(3), np.random.default_rng(2))  # stops mid-accumulation
    import io
    buf = io.BytesIO()
    torch.save(a.state_dict(), buf)
    buf.seek(0)
    b.load_state_dict(torch.load(buf, weights_only=True))
    assert b.step == 3 and b.optimizer.mini_step == 1
    assert b.optimizer.state[b.model.fc["bias"]]["mu"].dtype == torch.bfloat16
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    run(a, range(3, 8), rng_a)
    run(b, range(3, 8), rng_b)
    for (name, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), name


def test_labels_and_unfreeze_predicate():
    from xmir_tpu_torch.train import backbone_head_labels

    names = ["backbone.blocks.1.attn.qkv.weight", "backbone.blocks.11.mlp.fc1.bias",
             "backbone.blocks.10.ls1.gamma", "backbone.norm.weight", "backbone.pos_embed",
             "fc.weight", "head.bias"]
    assert backbone_head_labels(names) == {n: "backbone" if n.startswith("backbone") else "head"
                                           for n in names}
    frozen = unfreeze_last_blocks_predicate(12, 2)
    assert [frozen(n) for n in names] == [True, False, False, False, True, False, False]
    # the JAX package's predicate on its own path names says the same
    theirs = jax_optim.unfreeze_last_blocks_predicate(12, 2)
    jax_names = ["backbone/block1/attn/qkv/kernel", "backbone/block11/mlp/fc1/bias",
                 "backbone/block10/ls1", "backbone/norm/scale", "backbone/pos_embed",
                 "fc/kernel", "head/bias"]
    assert [theirs(n) for n in jax_names] == [frozen(n) for n in names]
    # a trainable block 1 does not make blocks 10 and 11 trainable: the
    # port's prefix ends in a dot
    only_1 = unfreeze_last_blocks_predicate(2, 1)
    assert not only_1("backbone.blocks.1.ls1.gamma") and only_1("backbone.blocks.0.ls1.gamma")
    assert only_1("backbone.blocks.10.ls1.gamma") and only_1("backbone.blocks.11.ls1.gamma")


# --- the slice: three train steps in both stacks -------------------------------------


def _images(b, size, seed):
    return np.random.default_rng(seed).standard_normal((b, size, size, 3)).astype(np.float32)


def _randomized_vit(variables, seed):
    """Every leaf redrawn (tests/test_torch_vit.py): vectors away from their
    1 / 0 / 1e-5 init so that each takes part."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(variables)
    out = []
    for leaf in leaves:
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        out.append(0.5 + 0.3 * a if leaf.ndim == 1 else 0.1 * a)
    return jax.tree_util.tree_unflatten(tree, [jnp.asarray(a) for a in out])


def _dinov2_pair(seed):
    model = jax_embedders.DinoV2Embedder(embedding_dim=16, img_size=56, **NARROW_VIT)
    variables = _randomized_vit(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 56, 56, 3))), seed)
    port = DinoV2Embedder(16, img_size=56, **NARROW_VIT)
    port.load_state_dict(convert.vit_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    return model, dict(variables), port.train(), convert.vit_state_dict_from_jax


def _densenet_pair(seed):
    model = JaxNarrowEmbedder()
    variables = randomized(model.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3))), seed)
    port = DenseNet121Embedder(12, 3, **NARROW)
    port.load_state_dict(convert.densenet_state_dict_from_jax(variables), strict=True)
    return model, dict(variables), port.train(), convert.densenet_state_dict_from_jax


PAIRS = {"dinov2": (_dinov2_pair, 56, ("backbone",)),
         "densenet": (_densenet_pair, 64, ("densenet121.",))}
LABELS = np.array([0, 0, 0, 1, 1, 1, 2, 2], np.int64)
LR = 1e-4  # the CLI's default: 1e-4 for the head, 1e-5 for the backbone


def _run_both(name, compute, steps=3, remat=False, accum=1):
    """``steps`` train steps in both stacks from the same weights on the same
    batches. Returns (JAX losses, port losses, JAX final state dict, port
    final state dict)."""
    make, size, prefixes = PAIRS[name]
    model, variables, port, to_state_dict = make(seed=3)
    tx = jax_optim.build_optimizer(variables["params"], lr=LR)
    jstate = jax_state.create_train_state(model, jax.random.PRNGKey(0), None, tx,
                                          variables=variables)
    state = TrainState(port, build_optimizer(port, lr=LR, backbone_prefixes=prefixes))
    if accum > 1:
        jstate = jax_steps.with_grad_accumulation(jstate, accum)
        with_grad_accumulation(state, accum)
    jstep = jax.jit(jax_steps.make_embedding_train_step(
        model, "triplet", {"margin": 0.2},
        compute_dtype=jnp.bfloat16 if compute == "bf16" else jnp.float32, remat=remat))
    step = make_embedding_train_step(
        port, "triplet", {"margin": 0.2},
        compute_dtype=torch.bfloat16 if compute == "bf16" else torch.float32, remat=remat)
    jl, tl = [], []
    for i in range(steps):
        x = _images(8, size, seed=10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(LABELS))
        tm = step(state, torch.from_numpy(x), torch.from_numpy(LABELS))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
        assert tm["loss"].requires_grad is False and tm["aux"].dim() == 0
    final = {"params": jstate.params}
    if jstate.batch_stats:
        final["batch_stats"] = jstate.batch_stats
    assert state.step == steps and int(jstate.step) == steps
    return jl, tl, to_state_dict(jax.tree_util.tree_map(np.asarray, final)), port.state_dict()


def _null_gradient(key):
    """The key bias of an attention block: softmax does not see a shift of
    every key's score, so in exact arithmetic its gradient is 0 and Adam
    normalises rounding noise there. Left out of the comparison."""
    return key.endswith("attn.qkv.bias")


def _compare_states(want, got, start):
    """Every tensor of the two final state dicts. Adam divides a gradient by
    its own size, so on the rare element whose gradient is rounding noise the
    two stacks may step opposite ways, 2 lr apart a step: at most one element
    in 1,000 may lie outside 1e-5, and the mean difference must stay within
    1% of the mean movement. Returns the mean movement."""
    assert sorted(want) == sorted(got)
    moved, apart = [], []
    for key in want:
        w, g, s = want[key].numpy(), got[key].numpy(), start[key].numpy()
        if _null_gradient(key):
            keys = np.s_[g.shape[0] // 3:2 * g.shape[0] // 3]
            w, g, s = (np.delete(t, keys) for t in (w, g, s))
        moved.append(np.abs(w - s).ravel())
        apart.append(np.abs(g - w).ravel())
    moved, apart = np.concatenate(moved), np.concatenate(apart)
    outliers = int((apart > 1e-5).sum())
    assert outliers <= 1e-3 * apart.size, f"{outliers} of {apart.size} elements outside 1e-5"
    assert apart.mean() <= 0.01 * moved.mean(), (apart.mean(), moved.mean())
    return moved.mean()


@pytest.mark.parametrize("name", ["dinov2", "densenet"])
def test_three_train_steps_match_jax_f32(name):
    """Losses of the three steps within 1e-5; parameters and BatchNorm
    buffers after the third as ``_compare_states`` holds them."""
    jl, tl, want, got = _run_both(name, "f32")
    np.testing.assert_allclose(tl, jl, atol=1e-5, rtol=0)
    start = PAIRS[name][0](seed=3)[2].state_dict()
    assert _compare_states(want, got, start) > 1e-5  # the parameters did move
    if name == "densenet":
        key = "densenet121.0.norm0.running_var"
        assert np.abs(got[key].numpy() - start[key].numpy()).max() > 1e-3


@pytest.mark.parametrize("name", ["dinov2", "densenet"])
def test_three_train_steps_bf16_as_close_to_f32_as_jax(name):
    """bf16 compute on f32 master weights: each loss within 2e-2 of the JAX
    package's bf16 run, and the port's bf16 losses no further from its own f32
    run than 1.25 x the JAX bf16 run is from JAX f32 (plus 2e-3: on three
    losses either distance is a handful of bf16 roundings)."""
    jl16, tl16, _, got16 = _run_both(name, "bf16")
    jl32, tl32, _, _ = _run_both(name, "f32")
    np.testing.assert_allclose(tl16, jl16, atol=2e-2, rtol=0)
    ours = np.abs(np.array(tl16) - np.array(tl32)).max()
    theirs = np.abs(np.array(jl16) - np.array(jl32)).max()
    assert ours <= 1.25 * theirs + 2e-3, (ours, theirs)
    assert all(v.dtype == torch.float32 for v in got16.values())  # master weights, buffers


@pytest.mark.parametrize("name", ["dinov2", "densenet"])
def test_remat_and_accumulation_match_jax(name):
    """remat=True with accumulation over 2 micro-batches, 4 calls: losses
    within 1e-5 before the first update and 3e-5 after it (the rare elements
    that step opposite ways, see ``_compare_states``, move a narrow
    DenseNet's loss by 1e-5), parameters and BatchNorm buffers as
    ``_compare_states`` holds them (the buffers move once a call, not
    twice)."""
    jl, tl, want, got = _run_both(name, "f32", steps=4, remat=True, accum=2)
    np.testing.assert_allclose(tl[:2], jl[:2], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tl[2:], jl[2:], atol=3e-5, rtol=0)
    _compare_states(want, got, PAIRS[name][0](seed=3)[2].state_dict())


def test_train_step_takes_the_fused_path_and_its_backward(monkeypatch):
    """Under XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1 a train step of the ViT goes
    through ln_qkv_fused and vit_attention_fused and back through
    ln_qkv_backward and vit_attention_bwd, once a block each; its loss and
    gradients agree with the eager path's (f32, 1e-4 of each gradient's
    largest magnitude)."""
    from xmir_tpu_torch.ops import ln_dense as ld
    from xmir_tpu_torch.ops import vit_attn as va

    calls = {"bwd": 0, "ln_bwd": 0}
    real_bwd, real_ln_bwd = va.vit_attention_bwd, ld.ln_qkv_backward

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    def ln_bwd(*a, **k):
        calls["ln_bwd"] += 1
        return real_ln_bwd(*a, **k)

    monkeypatch.setattr(va, "vit_attention_bwd", bwd)
    monkeypatch.setattr(ld, "ln_qkv_backward", ln_bwd)
    x, labels = torch.from_numpy(_images(8, 56, seed=1)), torch.from_numpy(LABELS)
    grads = {}
    weights = _dinov2_pair(seed=5)[2].state_dict()
    for path, flags in (("eager", {"XMIR_FLASH_ATTN": "0", "XMIR_FUSED_LN": "0"}),
                        ("fused", {"XMIR_FLASH_ATTN": "1", "XMIR_FUSED_LN": "1"})):
        for k, v in flags.items():
            monkeypatch.setenv(k, v)
        port = DinoV2Embedder(16, img_size=56, **NARROW_VIT).train()
        port.load_state_dict(weights)
        state = TrainState(port, build_optimizer(port, lr=0.0))
        out = make_embedding_train_step(port, "triplet", {"margin": 0.2})(state, x, labels)
        grads[path] = (out["loss"].item(), {n: p.grad.clone() for n, p in
                                            port.named_parameters()})
    assert calls == {"bwd": 2, "ln_bwd": 2}
    assert abs(grads["fused"][0] - grads["eager"][0]) <= 1e-5
    for name, g in grads["fused"][1].items():
        ref = grads["eager"][1][name]
        top = ref.abs().max().item() or 1.0
        if not _null_gradient(name):
            assert (g - ref).abs().max().item() <= 1e-4 * top, name


# --- checkpoints and the CLI -----------------------------------------------------------


def test_checkpoint_names_and_policy_follow_jax(tmp_path):
    kw = dict(dataset="covid", model="dinov2", embedding_dim=64, anomaly=True, rand_resize=True,
              seed=3)
    for extra in (dict(epoch=7, is_best=False), dict(epoch=7, is_best=True)):
        assert checkpoint.checkpoint_name(**kw, **extra) == jax_checkpoint.checkpoint_name(
            **kw, **extra).replace(".msgpack", ".pt")
    assert checkpoint.checkpoint_name("nih", "densenet121", epoch=1) == (
        "nih_densenet121_seed_0_epoch_1_ckpt.pt")
    policy = checkpoint.BestCheckpointPolicy(str(tmp_path), dict(dataset="d", model="m"),
                                             periodic_every=2)
    tree = {"state_dict": {"w": torch.ones(2)}, "step": 3, "epoch": 1}
    assert policy.update(1, 10.0, tree).endswith("d_m_seed_0_best_ckpt.pt")
    assert policy.update(2, 5.0, tree) is None  # not better, but periodic
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "d_m_seed_0_best_ckpt.pt", "d_m_seed_0_best_ckpt.pt.json", "d_m_seed_0_epoch_2_ckpt.pt",
        "d_m_seed_0_epoch_2_ckpt.pt.json"]
    assert (policy.best_metric, policy.best_epoch) == (10.0, 1)
    assert json.loads((tmp_path / "d_m_seed_0_best_ckpt.pt.json").read_text()) == {
        "epoch": 1, "metric": 10.0}
    best = str(tmp_path / "d_m_seed_0_best_ckpt.pt")
    assert list(checkpoint.load_checkpoint(best)) == ["w"]  # unwrapped
    assert checkpoint.load_checkpoint(best, unwrap=False)["step"] == 3
    for key in ("state-dict", "model"):
        torch.save({key: {"w": torch.zeros(1)}}, best)
        assert list(checkpoint.load_checkpoint(best)) == ["w"]


@pytest.fixture
def narrow_models(monkeypatch):
    """--model dinov2 and densenet121 at narrow widths and small sizes (the
    CLI path is the same; full width runs on the card, in chip_smoke.py)."""
    for name, kwargs, size in (("dinov2", dict(NARROW_VIT, img_size=56), 56),
                               ("densenet121", NARROW, 64)):
        spec = dataclasses.replace(registry.get_spec(name), kwargs=tuple(sorted(kwargs.items())),
                                   input_size=size, resize_size=size)
        monkeypatch.setitem(registry._SPECS, name, spec)
    for flag in ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_MLP"):
        monkeypatch.delenv(flag, raising=False)
    return monkeypatch


def _cli(tmp_path, model, *extra):
    return ["--dataset", "synthetic", "--device", "cpu", "--model", model, "--embedding-dim",
            "16", "-p", "2", "-k", "4", "-j", "2", "--print-freq", "1", "--eval-freq", "1",
            "--lr", "1e-3", *extra]


def _records(log):
    with open(log) as f:
        return [json.loads(line) for line in f]


def _losses(log):
    return [(r["epoch"], r["step"], r["loss"]) for r in _records(log) if r["kind"] == "train"]


@pytest.mark.parametrize("model,extra", [
    ("dinov2", ("--bf16", "--rand-resize")),
    ("densenet121", ("--weight-decay", "0.01", "--accum-steps", "2")),
    ("dinov2", ("--remat", "--loss-name", "supcon"))], ids=["dinov2-bf16", "densenet", "remat"])
def test_cli_train_resume_is_exact(tmp_path, narrow_models, model, extra):
    """Two epochs in one run against one epoch, then --resume of its
    checkpoint for the second: the second epoch's losses and the final
    checkpoints' tensors are bit-equal."""
    narrow_models.setenv("XMIR_FLASH_ATTN", "1")
    narrow_models.setenv("XMIR_FUSED_LN", "1")
    whole, first, second = (str(tmp_path / d) for d in ("whole", "first", "second"))
    log_w, log_1, log_2 = (str(tmp_path / f"{n}.jsonl") for n in ("w", "1", "2"))
    args = _cli(tmp_path, model, *extra)
    train_cli.main(args + ["--epochs", "2", "--save-dir", whole, "--metrics-log", log_w,
                           "--ckpt-every", "1", "--eval-initial"])
    train_cli.main(args + ["--epochs", "1", "--save-dir", first, "--metrics-log", log_1,
                           "--ckpt-every", "1"])
    rand_resize = "--rand-resize" in extra
    name = checkpoint.checkpoint_name("synthetic", model, 16, rand_resize=rand_resize, epoch=1)
    train_cli.main(args + ["--epochs", "2", "--save-dir", second, "--metrics-log", log_2,
                           "--ckpt-every", "1", "--resume", f"{first}/{name}"])
    lw, l1, l2 = _losses(log_w), _losses(log_1), _losses(log_2)
    assert len(lw) >= 8 and all(np.isfinite(v) for _, _, v in lw)
    assert lw[:len(l1)] == l1 and lw[len(l1):] == l2 and l2[0][0] == 2
    evals = [r for r in _records(log_w) if r["kind"] == "eval"]
    assert [r["epoch"] for r in evals] == [0, 1, 2] and all(0 <= r["mAP"] <= 100 for r in evals)
    last = checkpoint.checkpoint_name("synthetic", model, 16, rand_resize=rand_resize, epoch=2)
    a = checkpoint.load_checkpoint(f"{whole}/{last}", unwrap=False)
    b = checkpoint.load_checkpoint(f"{second}/{last}", unwrap=False)
    assert a["epoch"] == b["epoch"] == 2 and a["step"] == b["step"] == len(lw)
    for key, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][key]), key
    for idx, sa in a["optimizer"]["state"].items():
        for key, v in sa.items():
            assert torch.equal(v, b["optimizer"]["state"][idx][key]), (idx, key)
    start = checkpoint.load_checkpoint(f"{first}/{name}")
    assert any(not torch.equal(v, start[k]) for k, v in a["state_dict"].items())


def test_cli_train_checkpoint_serves_and_freeze_backbone_holds(tmp_path, narrow_models):
    """A train checkpoint loads whole through the serving CLIs' --resume; with
    --freeze-backbone the backbone's tensors do not move and the head's do."""
    from xmir_tpu_torch.cli import common

    save = str(tmp_path / "ck")
    train_cli.main(_cli(tmp_path, "dinov2", "--freeze-backbone") + [
        "--epochs", "1", "--save-dir", save, "--ckpt-every", "1", "--seed", "4"])
    path = f"{save}/{checkpoint.checkpoint_name('synthetic', 'dinov2', 16, seed=4, epoch=1)}"
    trained = checkpoint.load_checkpoint(path)
    fresh = DinoV2Embedder(16, img_size=56, generator=torch.Generator().manual_seed(4),
                           **NARROW_VIT).state_dict()
    for key, v in trained.items():
        assert torch.equal(v, fresh[key]) == key.startswith("backbone."), key
    p = __import__("argparse").ArgumentParser()
    common.add_model_args(p)
    args = p.parse_args(["--model", "dinov2", "--embedding-dim", "16", "--device", "cpu",
                         "--resume", path])
    model, _ = common.build_model(args, torch.device("cpu"))
    assert not model.training
    assert all(torch.equal(v, trained[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("model,kernel", [("swinv2", "K5")])
def test_cli_train_refuses_models_whose_kernel_waits(model, kernel):
    with pytest.raises(NotImplementedError, match=f"{kernel}.*ROADMAP.md"):
        train_cli.main(["--dataset", "synthetic", "--device", "cpu", "--model", model])


def test_cli_train_refusals_and_halt(tmp_path, narrow_models):
    with pytest.raises(NotImplementedError, match="dual_branch.*ROADMAP.md"):
        train_cli.main(["--dataset", "synthetic", "--device", "cpu", "--loss-name",
                        "dual_branch"])
    with pytest.raises(RuntimeError, match="asked for CUDA"):
        train_cli.main(["--dataset", "synthetic", "--model", "densenet121"])
    with pytest.raises(ValueError, match="non-finite loss"):
        train_cli.main(_cli(tmp_path, "densenet121") + ["--lr", "1e30", "--epochs", "1",
                                                        "--save-dir", str(tmp_path / "x")])


def test_cli_train_multilabel_runs(tmp_path, narrow_models):
    best = train_cli.main(["--dataset", "synthetic_ml", "--device", "cpu", "--model",
                           "densenet121", "--embedding-dim", "16", "--batch-size", "16", "-j",
                           "2", "--epochs", "1", "--eval-freq", "1", "--loss-name",
                           "jaccard_supcon", "--save-dir", str(tmp_path / "ml")])
    assert 0.0 <= best <= 100.0
    assert train_cli.select_loss(train_cli.parse_args(["--dataset", "nih"])) == "jaccard_supcon"
