"""The port's SigLIP-family training (losses/align.py, the concept dedupe and
ConceptGather of train/steps.py, the compute dtype of both steps under bf16,
the frozen sets of cli/train_medsiglip.py and cli/train_conceptclip.py,
VinDrConceptCLIPDataset) against the JAX package on the same numpy inputs and
weights, and the align losses against the reference's own numbers
(tests/fixtures/reference_losses_golden.json); the steps' trajectories are in
tests/test_torch_siglip_steps.py. Tier 1: CPU only, narrow towers; full width
runs on the card (chip_smoke.py).

Tolerances: losses and their gradients 1e-5 (absolute plus relative: the
stacks sum in other orders); the golden values at the JAX tests' own 2e-5
relative; ConceptGather's backward 1e-6 of indexing's."""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu import losses as jl
from xmir_tpu.data import datasets as jax_ds
from xmir_tpu.models import embedders as jax_embedders
from xmir_tpu.models import siglip_text as jax_siglip_text
from xmir_tpu.train import steps as jax_steps
from xmir_tpu.train.optim import label_params
from xmir_tpu_torch import losses as tl
from xmir_tpu_torch.cli import train_conceptclip, train_medsiglip
from xmir_tpu_torch.data import datasets as ds
from xmir_tpu_torch.models import convert, siglip
from xmir_tpu_torch.models.embedders import ConceptCLIPModel
from xmir_tpu_torch.models.siglip_text import MedSigLIPDualEncoder
from xmir_tpu_torch.train import (
    ConceptGather,
    dedupe_concept_batch,
    make_conceptclip_train_step,
    make_it_align_train_step,
)

TOL = 1e-5
LR = 1e-3
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "reference_losses_golden.json")
FLAGS = ("XMIR_FLASH_ATTN", "XMIR_FUSED_LN", "XMIR_FUSED_LN_QKV", "XMIR_FUSED_LN_QKV72",
         "XMIR_FUSED_LN_MLP")


@pytest.fixture
def clean_flags(monkeypatch):
    for name in FLAGS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --- the align losses ----------------------------------------------------------


def _align_inputs(seed, b=6, n=12, d=16, widths=(3, 0, 2, 5, 1, 4)):
    rng = np.random.default_rng(seed)
    img, txt = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    tok = rng.standard_normal((b, n, d)).astype(np.float32)
    concepts = np.zeros((b, max(widths), d), np.float32)
    cmask = np.zeros((b, max(widths)), bool)
    for i, w in enumerate(widths):
        concepts[i, :w] = rng.standard_normal((w, d))
        cmask[i, :w] = True
    return img, txt, tok, concepts, cmask


# name -> (port call, JAX call) on (image features, text features, tokens,
# concepts, concept mask, logit scale, logit bias)
ALIGN = {
    "it": (lambda i, t, k, c, m, s, b: tl.it_align_loss(i, t, s, b),
           lambda i, t, k, c, m, s, b: jl.it_align_loss(i, t, s, b)),
    "rc": (lambda i, t, k, c, m, s, b: tl.rc_align_loss(k, c, m, s, b),
           lambda i, t, k, c, m, s, b: jl.rc_align_loss(k, c, m, s, b)),
    "conceptclip": (lambda i, t, k, c, m, s, b: tl.conceptclip_loss(i, t, k, c, m, s, b, 0.3)[0],
                    lambda i, t, k, c, m, s, b: jl.conceptclip_loss(i, t, k, c, m, s, b, 0.3)[0]),
}


@pytest.mark.parametrize("scale", [2.302585, jl.LOG_SCALE_MAX, 5.0, -0.5],
                         ids=["inside", "at-ln100", "above", "below"])
@pytest.mark.parametrize("name", sorted(ALIGN))
def test_align_loss_and_gradients_match_jax(name, scale):
    """Values and gradients in every input, the logit scale and bias
    included, inside the clip and at and beyond its bounds (where the
    gradient is jnp.clip's: halved at a bound, 0 beyond). The padded concept
    slots are zero rows here, as in the reference's parity inputs."""
    port_fn, jax_fn = ALIGN[name]
    img, txt, tok, concepts, cmask = _align_inputs(1)
    floats = [img, txt, tok, concepts, np.float32(scale), np.float32(-0.5)]

    def jfun(i, t, k, c, s, b):
        return jax_fn(i, t, k, c, jnp.asarray(cmask), s, b)

    want, want_grads = jax.value_and_grad(jfun, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in floats))
    leaves = [_t(a).float().requires_grad_(True) for a in floats]
    got = port_fn(*leaves[:4], _t(cmask), *leaves[4:])
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    np.testing.assert_allclose(got.item(), float(want), atol=TOL, rtol=TOL)
    for g, w in zip(grads, want_grads):
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        # at an all-zero (padding) concept row JAX's norm has a NaN gradient,
        # PyTorch's a zero one: compared where JAX's is finite
        finite = np.isfinite(w)
        assert np.isfinite(g).all() and (g[~finite] == 0).all()
        np.testing.assert_allclose(g[finite], w[finite], atol=TOL, rtol=TOL)


def test_align_losses_without_concepts_or_bias_match_jax():
    """No sample with a concept: RC-Align is 0, as JAX's; no logit bias."""
    img, txt, tok, concepts, _ = _align_inputs(2)
    none = np.zeros(concepts.shape[:2], bool)
    rc = tl.rc_align_loss(_t(tok), _t(concepts), _t(none), torch.tensor(2.3))
    assert rc.item() == float(jl.rc_align_loss(tok, concepts, none, 2.3)) == 0.0
    it = tl.it_align_loss(_t(img), _t(txt), torch.tensor(2.3))
    np.testing.assert_allclose(it.item(), float(jl.it_align_loss(img, txt, 2.3)), atol=TOL,
                               rtol=TOL)


def _golden_align_inputs():
    """The align inputs of tests/test_reference_parity.py::TestLossParity,
    drawn there after the logits from the same generator."""
    rng = np.random.default_rng(99)
    rng.standard_normal((24, 14))  # the logits
    d, widths = 16, [3, 0, 2, 5, 1, 4]
    img = rng.standard_normal((6, d)).astype(np.float32)
    txt = rng.standard_normal((6, d)).astype(np.float32)
    tok = rng.standard_normal((6, 49, d)).astype(np.float32)
    concepts = np.zeros((6, max(widths), d), np.float32)
    cmask = np.zeros((6, max(widths)), bool)
    for i, w in enumerate(widths):
        if w:
            concepts[i, :w] = rng.standard_normal((w, d)).astype(np.float32)
            cmask[i, :w] = True
    s, b = torch.tensor(2.302585), torch.tensor(-0.5)
    return [_t(a) for a in (img, txt, tok, concepts, cmask)] + [s, b]


GOLDEN = {
    "it_align": lambda i, t, k, c, m, s, b: tl.it_align_loss(i, t, s, b),
    "rc_align": lambda i, t, k, c, m, s, b: tl.rc_align_loss(k, c, m, s, b),
    "conceptclip_total": lambda *a: tl.conceptclip_loss(*a)[0],
    "conceptclip_it": lambda *a: tl.conceptclip_loss(*a)[1],
    "conceptclip_rc": lambda *a: tl.conceptclip_loss(*a)[2],
}


@pytest.mark.parametrize("key", sorted(GOLDEN))
def test_align_loss_matches_reference_golden(key):
    """The values the reference's loss.py computed on the same inputs."""
    with open(FIXTURE) as f:
        want = json.load(f)["values"][key]
    np.testing.assert_allclose(GOLDEN[key](*_golden_align_inputs()).item(), want, rtol=2e-5,
                               atol=1e-6)


# --- the concept dedupe ----------------------------------------------------------


@pytest.mark.parametrize("with_mask", [True, False])
def test_dedupe_concept_batch_equals_jax(with_mask):
    rng = np.random.default_rng(3)
    rows = rng.integers(1, 40, (4, 6))
    rows[:, 4:] = 0  # [PAD] tails
    cids = rows[rng.integers(0, 4, (5, 3))].astype(np.int32)
    cids[2, 1] = 0  # an empty slot
    mask = cids != 0 if with_mask else None
    got = dedupe_concept_batch(cids, mask)
    want = jax_steps.dedupe_concept_batch(cids, mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    u_ids, _, inverse = got
    assert u_ids.shape[0] % 8 == 0 and np.array_equal(u_ids[inverse], cids)


def test_concept_gather_backward_is_the_slots_sum():
    """ConceptGather's backward adds each row's slots (one reduction, f32),
    as indexing's backward does up to order; bf16 rounds once."""
    rng = np.random.default_rng(4)
    inverse = _t(rng.integers(0, 5, (4, 3)).astype(np.int32))
    for dtype in (torch.float32, torch.bfloat16):
        feats = torch.randn(8, 7, generator=torch.Generator().manual_seed(5)).to(dtype)
        g = torch.randn(4, 3, 7, generator=torch.Generator().manual_seed(6)).to(dtype)
        leaf = feats.clone().requires_grad_(True)
        out = ConceptGather.apply(leaf, inverse)
        assert torch.equal(out, feats[inverse.long()])
        (got,) = torch.autograd.grad(out, leaf, g)
        want = torch.zeros(8, 7).index_add_(0, inverse.reshape(-1).long(), g.float().reshape(-1, 7))
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.to(dtype).float(), atol=1e-6, rtol=0)
        assert torch.equal(got[5:], torch.zeros_like(got[5:]))  # unreferenced rows


# --- the ConceptCLIP step ----------------------------------------------------------


CC = dict(img_size=28, dim=64, depth=3, text_depth=2, text_vocab=50)
B, W, LC, SEQ = 4, 3, 5, 8


def _randomized(shapes, seed):
    """Every leaf of the init's shapes drawn: matrices 0.1 N(0, 1), vectors
    (LN scales, biases) 0.5 + 0.3 N(0, 1); the scalars are the init's logit
    scale ln 10 and bias -10."""
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten_with_path(shapes)
    out = []
    for path, leaf in leaves:
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 0:
            name = str(getattr(path[-1], "key", path[-1]))
            a = np.float32(np.log(10.0) if name == "logit_scale" else -10.0)
        out.append(a if leaf.ndim == 0 else 0.5 + 0.3 * a if leaf.ndim == 1 else 0.1 * a)
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes),
                                        [jnp.asarray(a) for a in out])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _conceptclip_pair(seed, logit_scale=None):
    model = jax_embedders.ConceptCLIPModel(**CC)
    pix0 = jnp.zeros((2, CC["img_size"], CC["img_size"], 3))
    init = jax.jit(lambda key: model.init(key, pix0, jnp.zeros((2, SEQ), jnp.int32), None,
                                          method=model.forward_clip))
    variables = _randomized(jax.eval_shape(init, jax.random.PRNGKey(0)), seed)
    if logit_scale is not None:
        params = dict(variables["params"], logit_scale=jnp.float32(logit_scale))
        variables = {"params": params}
    port = ConceptCLIPModel(**CC)
    port.load_state_dict(convert.conceptclip_state_dict_from_jax(_np(variables)), strict=True)
    return model, variables, port.train()


def _concept_batch(seed):
    """Pixels, caption ids and mask, and concepts drawn from three token rows
    (so that they repeat), padded with [PAD], some slots empty."""
    rng = np.random.default_rng(seed)
    pix = rng.standard_normal((B, CC["img_size"], CC["img_size"], 3)).astype(np.float32)
    ids = rng.integers(1, CC["text_vocab"], (B, SEQ)).astype(np.int32)
    mask = (np.arange(SEQ)[None] < np.asarray([8, 5, 3, 8])[:, None]).astype(np.int32)
    rows = rng.integers(1, CC["text_vocab"], (3, LC))
    rows[0, 3:] = 0
    cids = rows[rng.integers(0, 3, (B, W))].astype(np.int32)
    cmask = np.asarray([[1, 1, 0], [1, 0, 0], [0, 0, 0], [1, 1, 1]], bool)
    return pix, ids, mask, cids, cmask, cids != 0


def _step_args(batch, dedupe, torch_side):
    pix, ids, mask, cids, cmask, ctok = batch
    if dedupe:
        u_ids, u_mask, inverse = dedupe_concept_batch(cids, ctok)
        args = (pix, ids, mask, u_ids, cmask, u_mask, inverse)
    else:
        args = (pix, ids, mask, cids, cmask, ctok)
    if not torch_side:
        return tuple(jnp.asarray(a) for a in args)
    out = [_t(a) for a in args]
    out[1], out[3] = out[1].long(), out[3].long()
    return tuple(out)


def _jax_conceptclip_frozen(nv, nt, uv, ut):
    """The JAX CLI's predicate (xmir_tpu/cli/train_conceptclip.py:117-130)."""
    def frozen(path):
        if path.startswith("visual"):
            for i in range(nv - uv, nv):
                if path.startswith(f"visual/layer{i}"):
                    return False
            return "post_layernorm" not in path and "head" not in path
        if path.startswith("text/"):
            for i in range(nt - ut, nt):
                if path.startswith(f"text/layer{i}"):
                    return False
            return True
        return False
    return frozen


def _jax_medsiglip_frozen(n_layers, unfreeze, freeze_vision=False, freeze_text=False):
    """The JAX CLI's predicate (xmir_tpu/cli/train_medsiglip.py:102-116)."""
    def frozen(path):
        for tower, freeze_all in (("vision", freeze_vision), ("text", freeze_text)):
            if path.startswith(tower):
                if freeze_all:
                    return True
                for i in range(n_layers - unfreeze, n_layers):
                    if path.startswith(f"{tower}/layer{i}"):
                        return False
                if "post_layernorm" in path or "final_layer_norm" in path \
                        or path.startswith(f"{tower}/head"):
                    return False
                return True
        return False
    return frozen


# --- the MedSigLIP step ----------------------------------------------------------


DUAL = dict(img_size=28, text_vocab=50, dim=64, depth=3, num_heads=4, intermediate=128)


def _dual_pair(seed):
    model = jax_siglip_text.MedSigLIPDualEncoder(**DUAL)
    variables = _randomized(jax.eval_shape(lambda key: model.init(
        key, jnp.zeros((1, 28, 28, 3)), jnp.zeros((1, SEQ), jnp.int32)),
        jax.random.PRNGKey(0)), seed)
    port = MedSigLIPDualEncoder(**DUAL)
    port.load_state_dict(convert.medsiglip_dual_state_dict_from_jax(_np(variables)), strict=True)
    return model, variables, port.train()


def _medsiglip_batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 28, 28, 3)).astype(np.float32),
            rng.integers(1, DUAL["text_vocab"], (B, SEQ)).astype(np.int32))


def _counted_attention(monkeypatch):
    """The dtype of every q that reaches the fused attention's entry."""
    seen = []
    real = siglip.flash_attention_plain

    def counted(q, k, v, scale):
        seen.append(q.dtype)
        return real(q, k, v, scale)

    monkeypatch.setattr(siglip, "flash_attention_plain", counted)
    return seen


def test_bf16_means_f32_attention_for_medsiglip_and_bf16_for_conceptclip(clean_flags):
    """The two CLIs' --bf16: train_medsiglip casts the pixels only, and its
    f32 parameters promote every layer back to f32, as flax's nn.Dense /
    nn.Conv do in the JAX CLI (whose image features come out f32); so its
    attention takes the fused path in f32, under XMIR_FLASH_ATTN=1 only.
    train_conceptclip casts every floating parameter: bf16 attention in the
    vision tower, which takes the fused path by default on CUDA."""
    model, variables, port = _dual_pair(seed=10)
    cmodel, cvars, cport = _conceptclip_pair(seed=11)
    pix, ids = _medsiglip_batch(50)
    out = jax.eval_shape(lambda v: model.apply(v, jnp.asarray(pix, jnp.bfloat16),
                                               jnp.asarray(ids)), variables)
    assert out["image_features"].dtype == jnp.float32
    seen = _counted_attention(clean_flags)
    step = make_it_align_train_step(port, torch.bfloat16)
    step.losses(_t(pix), _t(ids).long())
    assert seen == []  # f32 on the CPU: the eager path
    clean_flags.setenv("XMIR_FLASH_ATTN", "1")
    step.losses(_t(pix), _t(ids).long())
    assert seen == [torch.float32] * (2 * DUAL["depth"])

    seen.clear()
    cstep = make_conceptclip_train_step(cport, compute_dtype=torch.bfloat16)
    total, _, _ = cstep.losses(*_step_args(_concept_batch(51), False, True))
    assert seen == [torch.bfloat16] * CC["depth"] and total.dtype == torch.float32
    cast = jax_steps._cast_floating(cvars["params"], jnp.bfloat16)
    clean_flags.setenv("XMIR_FLASH_ATTN", "0")  # the JAX flash path has no CPU lowering
    jout = jax.eval_shape(lambda p: cmodel.apply(
        {"params": p}, jnp.zeros((1, 28, 28, 3), jnp.bfloat16), jnp.ones((1, SEQ), jnp.int32),
        method=cmodel.forward_clip), cast)
    assert jout["image_features"].dtype == jnp.bfloat16


# --- the frozen sets ----------------------------------------------------------


def _trainable_through_converter(params, jfrozen, to_state_dict):
    """Each JAX leaf filled with 0 (frozen) or 1 (trained) by the JAX
    predicate, carried through the converter: {port name: 0 or 1}; a tensor
    that mixes the two fails."""
    labels = label_params(params, lambda path: "frozen" if jfrozen(path) else "train")
    marked = jax.tree_util.tree_map(
        lambda leaf, label: np.full(np.shape(leaf), float(label == "train"), np.float32),
        params, labels)
    out = {}
    for name, t in to_state_dict({"params": marked}).items():
        values = set(t.unique().tolist())
        assert values in ({0.0}, {1.0}), f"{name} mixes frozen and trained leaves"
        out[name] = values == {1.0}
    return out


@pytest.mark.parametrize("unfreeze,fv,ft", [(2, False, False), (1, True, False),
                                            (3, False, True), (0, False, False)])
def test_medsiglip_frozen_set_equals_jax(unfreeze, fv, ft):
    model, variables, port = _dual_pair(seed=12)
    want = _trainable_through_converter(
        variables["params"], _jax_medsiglip_frozen(DUAL["depth"], unfreeze, fv, ft),
        convert.medsiglip_dual_state_dict_from_jax)
    frozen = train_medsiglip.frozen_predicate(DUAL["depth"], unfreeze, fv, ft)
    got = {name: not frozen(name) for name, _ in port.named_parameters()}
    assert got == want and any(got.values()) and not all(got.values())


@pytest.mark.parametrize("uv,ut", [(1, 1), (3, 0), (0, 2)])
def test_conceptclip_frozen_set_equals_jax(uv, ut):
    model, variables, port = _conceptclip_pair(seed=13)
    want = _trainable_through_converter(
        variables["params"], _jax_conceptclip_frozen(CC["depth"], CC["text_depth"], uv, ut),
        convert.conceptclip_state_dict_from_jax)
    frozen = train_conceptclip.frozen_predicate(CC["depth"], CC["text_depth"], uv, ut)
    got = {name: not frozen(name) for name, _ in port.named_parameters()}
    assert got == want and any(got.values()) and not all(got.values())


# --- VinDrConceptCLIPDataset ----------------------------------------------------------


def _vindr_concept_csv(path, seed):
    """Two radiologists a study over every VinDr column, one normal study,
    one with a disease and no concept, one with concepts and no disease."""
    rng = np.random.default_rng(seed)
    cols = list(ds.VINDR_ALL_COLUMNS)
    lines = [",".join(["image_id", "rad_id"] + cols)]
    for i in range(7):
        for r in range(2):
            v = (rng.random(len(cols)) < 0.15).astype(int)
            if i == 0:
                v[:] = 0
                v[cols.index("No finding")] = 1
            elif i == 1:
                v[:len(ds.VINDR_CONCEPT_COLUMNS)] = 0
                v[cols.index("No finding")] = 0
            elif i == 2:
                v[len(ds.VINDR_CONCEPT_COLUMNS):] = 0
            lines.append(",".join([f"img{i:02d}", f"R{r}"] + [str(x) for x in v]))
    path.write_text("\n".join(lines) + "\n")


def test_vindr_conceptclip_dataset_matches_jax(tmp_path):
    csv_path = tmp_path / "vindr.csv"
    _vindr_concept_csv(csv_path, seed=14)
    port = ds.VinDrConceptCLIPDataset(str(tmp_path), str(csv_path))
    ref = jax_ds.VinDrConceptCLIPDataset(str(tmp_path), str(csv_path))
    assert port.image_names == ref.image_names and port.label_columns == ref.label_columns
    assert np.array_equal(port.concept_labels, ref.concept_labels)
    assert np.array_equal(port.disease_labels, ref.disease_labels)
    texts = [port.get_text(i) for i in range(len(port))]
    assert texts == [ref.get_text(i) for i in range(len(ref))]
    assert texts[0] == ("A normal chest X-ray without significant pathological findings.", [])
    assert all(name in ds.VINDR_CONCEPT_COLUMNS for _, names in texts for name in names)
    assert ds.CONCEPT_DESCRIPTIONS == jax_ds.CONCEPT_DESCRIPTIONS
    assert ds.DISEASE_DESCRIPTIONS == jax_ds.DISEASE_DESCRIPTIONS
