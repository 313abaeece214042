"""Three-step trajectories of the port's SigLIP-family training steps
(train/steps.py::make_conceptclip_train_step, every slot and deduped, and
make_it_align_train_step) against the JAX package's from the same weights on
the same batches, and the deduped ConceptCLIP step against the plain one
(tests/test_train.py:383-406). Tier 1: CPU only, narrow towers (helpers in
tests/test_torch_siglip_train.py); full width runs on the card
(chip_smoke.py).

Tolerances: losses within 1e-5 (1 + |loss|; after an update at the clamped
logit scale, where the logits are 100 cosines, 1e-5 + 1e-4 |loss|), the
parameters as ``_compare_states`` holds them (Adam normalises rounding noise
where a gradient is 0 in exact arithmetic); the deduped step against the
plain one at tests/test_train.py's bounds (loss 1e-6 relative, SGD(lr = 1)
updates 5e-3 of each tensor's largest gradient)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_siglip_train import (  # noqa: F401  (clean_flags: a fixture)
    CC,
    DUAL,
    LR,
    TOL,
    _conceptclip_pair,
    _concept_batch,
    _dual_pair,
    _jax_conceptclip_frozen,
    _jax_medsiglip_frozen,
    _medsiglip_batch,
    _np,
    _step_args,
    _t,
    clean_flags,
)
from xmir_tpu import losses as jl
from xmir_tpu.train import build_optimizer as jax_build_optimizer
from xmir_tpu.train import create_train_state
from xmir_tpu.train import steps as jax_steps
from xmir_tpu_torch.cli import train_conceptclip, train_medsiglip
from xmir_tpu_torch.models import convert
from xmir_tpu_torch.train import (
    TrainState,
    build_optimizer,
    dedupe_concept_batch,
    make_conceptclip_train_step,
    make_it_align_train_step,
)


def _null_gradient(key):
    """Softmax does not see a shift of every key's score, so in exact
    arithmetic the key bias's gradient is 0 and Adam normalises rounding
    noise there: the rows of a key bias, left out of the comparison."""
    if key.endswith(("self_attn.k_proj.bias", "attention.self.key.bias")):
        return np.s_[:]
    if key.endswith("head.attention.in_proj_bias"):
        d = CC["dim"]
        return np.s_[d:2 * d]
    return None


def _compare_states(want, got, start):
    """tests/test_torch_train.py's comparison: at most one element in 1,000
    outside 1e-5, the mean difference within 1% of the mean movement.
    Returns the mean movement."""
    assert sorted(want) == sorted(got)
    moved, apart = [], []
    for key in want:
        w, g, s = (t[key].float().numpy().ravel() for t in (want, got, start))
        null = _null_gradient(key)
        if null is not None:
            keep = np.ones(w.size, bool)
            keep[null] = False
            w, g, s = w[keep], g[keep], s[keep]
        moved.append(np.abs(w - s))
        apart.append(np.abs(g - w))
    moved, apart = np.concatenate(moved), np.concatenate(apart)
    outliers = int((apart > 1e-5).sum())
    assert outliers <= 1e-3 * apart.size, f"{outliers} of {apart.size} elements outside 1e-5"
    assert apart.mean() <= 0.01 * moved.mean(), (apart.mean(), moved.mean())
    return moved.mean()


@pytest.mark.parametrize("dedupe", [False, True], ids=["every-slot", "deduped"])
@pytest.mark.parametrize("start_scale", [None, 5.0], ids=["init", "above-ln100"])
def test_conceptclip_three_steps_match_jax(clean_flags, dedupe, start_scale):
    """Three f32 steps of make_conceptclip_train_step in both stacks (AdamW
    with the bf16 first moment and weight decay of the CLI, its frozen set):
    losses, IT and RC terms within 1e-5 (1 + |loss|; after an update at the
    clamped scale 1e-5 + 1e-4 |loss|), the parameters after them as
    ``_compare_states`` holds them, the logit scale within 1e-6 after each. From
    a logit scale of 5 the post-step clamp puts it at ln 100 after the first
    step in both, and the second step starts from that bound (where the clip's
    gradient is halved)."""
    model, variables, port = _conceptclip_pair(seed=7, logit_scale=start_scale)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    jfrozen = _jax_conceptclip_frozen(CC["depth"], CC["text_depth"], 1, 1)
    tx = jax_build_optimizer(variables["params"], lr=LR, backbone_lr_scale=1.0,
                             weight_decay=0.01, frozen_predicate=jfrozen,
                             mu_dtype=jnp.bfloat16)
    jstate = create_train_state(model, jax.random.PRNGKey(0), None, tx, variables=variables)
    jstep = jax.jit(jax_steps.make_conceptclip_train_step(model, alpha=0.5,
                                                          dedupe_concepts=dedupe))
    state = TrainState(port, build_optimizer(
        port, lr=LR, backbone_lr_scale=1.0, weight_decay=0.01, mu_dtype=torch.bfloat16,
        frozen_predicate=train_conceptclip.frozen_predicate(CC["depth"], CC["text_depth"], 1,
                                                            1)))
    step = make_conceptclip_train_step(port, alpha=0.5, dedupe_concepts=dedupe)
    for i in range(3):
        batch = _concept_batch(20 + i)
        jstate, jm = jstep(jstate, *_step_args(batch, dedupe, False))
        tm = step(state, *_step_args(batch, dedupe, True))
        # after an update at the clamped scale the logits are 100 cosines, and
        # Adam's sign-normalised first steps on the gradients that are noise
        # (the key biases) move the losses by up to 3.3e-5 of themselves
        rtol = 1e-4 if start_scale is not None and i > 0 else TOL
        for key in ("loss", "it_loss", "rc_loss"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]), atol=TOL, rtol=rtol)
        if start_scale is not None and i == 0:
            assert port.logit_scale.item() == float(jstate.params["logit_scale"]) == np.float32(
                jl.LOG_SCALE_MAX)
        np.testing.assert_allclose(port.logit_scale.item(), float(jstate.params["logit_scale"]),
                                   atol=1e-6, rtol=0)
    want = convert.conceptclip_state_dict_from_jax({"params": _np(jstate.params)})
    assert _compare_states(want, port.state_dict(), start) > 1e-5


def test_deduped_step_equals_the_plain_step():
    """tests/test_train.py:383-406 for the port: under SGD(lr = 1) the
    update is the gradient, and the deduped step (each distinct concept
    encoded once, ConceptGather's fixed-order sum) gives the plain step's
    loss and update."""
    batch = _concept_batch(30)
    states, metrics = [], []
    for dedupe in (False, True):
        _, _, port = _conceptclip_pair(seed=8)
        before = [p.detach().clone() for p in port.parameters()]
        state = TrainState(port, torch.optim.SGD(port.parameters(), lr=1.0))
        metrics.append(make_conceptclip_train_step(port, dedupe_concepts=dedupe)(
            state, *_step_args(batch, dedupe, True)))
        states.append([b - p.detach() for b, p in zip(before, port.parameters())])
    assert dedupe_concept_batch(batch[3], batch[5])[0].shape[0] == 8  # 3 rows, bucket 8
    np.testing.assert_allclose(metrics[1]["loss"].item(), metrics[0]["loss"].item(), rtol=1e-6)
    gscale = max(g.abs().max().item() for g in states[0])
    for ga, gb in zip(*states):
        tol = max(5e-3 * ga.abs().max().item(), 1e-6 * gscale)
        torch.testing.assert_close(gb, ga, atol=tol, rtol=0)


def _jax_it_align_step(model, dtype):
    """The JAX CLI's inline step (xmir_tpu/cli/train_medsiglip.py:131-143)."""
    def step_fn(state, pixel_values, input_ids):
        def losses(params):
            out = model.apply({"params": params}, pixel_values.astype(dtype), input_ids,
                              train=True)
            return jl.it_align_loss(out["image_features"].astype(jnp.float32),
                                    out["text_features"].astype(jnp.float32),
                                    out["logit_scale"], out["logit_bias"])

        loss, grads = jax.value_and_grad(losses)(state.params)
        return state.apply_gradients(grads), loss
    return jax.jit(step_fn)


def test_medsiglip_three_steps_match_jax(clean_flags):
    """Three f32 IT-Align steps of a dual encoder in both stacks with the
    CLI's Adam and frozen set (the last layer of each tower): losses within
    1e-5, the parameters as ``_compare_states`` holds them; no clamp."""
    model, variables, port = _dual_pair(seed=9)
    start = {k: v.clone() for k, v in port.state_dict().items()}
    tx = jax_build_optimizer(variables["params"], lr=LR, backbone_lr_scale=1.0,
                             frozen_predicate=_jax_medsiglip_frozen(DUAL["depth"], 1))
    jstate = create_train_state(model, jax.random.PRNGKey(0), None, tx, variables=variables)
    jstep = _jax_it_align_step(model, jnp.float32)
    state = TrainState(port, build_optimizer(
        port, lr=LR, backbone_lr_scale=1.0,
        frozen_predicate=train_medsiglip.frozen_predicate(DUAL["depth"], 1)))
    step = make_it_align_train_step(port)
    for i in range(3):
        pix, ids = _medsiglip_batch(40 + i)
        jstate, jloss = jstep(jstate, jnp.asarray(pix), jnp.asarray(ids))
        tm = step(state, _t(pix), _t(ids).long())
        np.testing.assert_allclose(tm["loss"].item(), float(jloss), atol=TOL, rtol=0)
    want = convert.medsiglip_dual_state_dict_from_jax({"params": _np(jstate.params)})
    assert _compare_states(want, port.state_dict(), start) > 1e-5
