"""K10's plain version (ops/convnext_block.py::tail_backward_reference) and
the autograd Function around K9 / K10 against the JAX package: the Pallas
tail backward in interpret mode, jax.vjp of the tail, jax.grad through the
JAX block's custom_vjp, and the TPU kernel's bf16 arithmetic written out in
numpy with f32 sums. Inputs are made with numpy from a seed."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import xmir_tpu.ops.convnext_block_pallas as jax_cbp
from xmir_tpu_torch.models import convnext as port_convnext
from xmir_tpu_torch.models.convnext import ConvNeXtV2Block
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.ops import vit_attn as va

torch.set_num_threads(1)

TAIL_KEYS = ("ln_scale", "ln_bias", "w1", "b1", "w2", "gamma", "beta")
# the JAX package's own bound on its tail backward (tests/test_convnext_fused.py:214-218)
JAX_RTOL = 5e-5


def _params(c, seed):
    """Random LN, GRN, biases and weights of a block of width c, in the JAX
    layouts (dw (7, 7, C), w1 (C, 4C), w2 (4C, C)): GRN's are zero at init,
    which would leave GRN untested."""
    rng = np.random.default_rng(seed)
    c4 = 4 * c

    def arr(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    return dict(dw_kernel=arr(7, 7, c, scale=0.1), dw_bias=arr(c, scale=0.1),
                ln_scale=1.0 + arr(c, scale=0.2), ln_bias=arr(c, scale=0.1),
                w1=arr(c, c4, scale=c ** -0.5), b1=arr(c4, scale=0.1),
                w2=arr(c4, c, scale=c4 ** -0.5), b2=arr(c, scale=0.1),
                gamma=arr(c4, scale=0.5), beta=arr(c4, scale=0.1))


def _port(p, dtype=torch.float32):
    """The port's layouts: (C, 1, 7, 7) conv, (out, in) Linear weights in the
    compute dtype, f32 vectors."""
    t = torch.from_numpy
    return dict(dw_weight=t(np.ascontiguousarray(p["dw_kernel"].transpose(2, 0, 1)[:, None])),
                dw_bias=t(p["dw_bias"]), ln_scale=t(p["ln_scale"]), ln_bias=t(p["ln_bias"]),
                w1=t(p["w1"].T.copy()).to(dtype), b1=t(p["b1"]), w2=t(p["w2"].T.copy()).to(dtype),
                b2=t(p["b2"]), gamma=t(p["gamma"]), beta=t(p["beta"]))


def _rows(b, r, c, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, r, c)).astype(np.float32),
            rng.standard_normal((b, r, c)).astype(np.float32))


def _as_port(jax_grads):
    """JAX's (dacc, dlns, dlnb, dw1 (C, 4C), db1, dw2 (4C, C), dg, dbe) in the
    port's layouts (dw1 (4C, C), dw2 (C, 4C))."""
    out = [np.asarray(g, np.float32) for g in jax_grads]
    out[3], out[5] = out[3].T, out[5].T
    return out


def _assert_within(got, want, rtol):
    for name, a, b in zip(cb.TAIL_GRAD_NAMES, got, want):
        top = float(np.abs(b).max()) or 1.0
        err = float(np.abs(np.asarray(a, np.float32).reshape(b.shape) - b).max())
        assert err <= rtol * top, (name, err, top)


@pytest.mark.parametrize("b,r,c", [(2, 49, 16), (3, 64, 8), (1, 1, 16)])
def test_tail_backward_reference_matches_jax_f32(b, r, c):
    """f32: the plain version against _tail_bwd_pallas(interpret=True) and
    against jax.vjp of _tail_reference, each output within 5e-5 of its
    largest magnitude."""
    p = _params(c, seed=b * 100 + r)
    h, dy = _rows(b, r, c, seed=r)
    a = _port(p)
    got = [t.numpy() for t in cb.tail_backward_reference(
        torch.from_numpy(h), torch.from_numpy(dy), *(a[k] for k in TAIL_KEYS))]
    jp = [jnp.asarray(p[k]) for k in TAIL_KEYS]
    pallas = _as_port(jax_cbp._tail_bwd_pallas(jnp.asarray(h), jnp.asarray(dy), *jp,
                                               interpret=True))
    _, vjp = jax.vjp(jax_cbp._tail_reference, jnp.asarray(h), *jp)
    exact = _as_port(vjp(jnp.asarray(dy)))
    _assert_within(got, pallas, JAX_RTOL)
    _assert_within(got, exact, JAX_RTOL)


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _tpu_bwd_bf16(h, dy, ln_scale, ln_bias, w1, b1, w2, gamma, beta):
    """_bwd_tail_kernel's arithmetic for bf16 inputs written out in numpy:
    every value f32, y, ab, z and dh1 rounded to bf16 before their products,
    the products' f32 sums of exact bf16 x bf16 products (XLA's CPU bf16 dot
    is not such a sum, ROADMAP.md section 3). JAX layouts, image by image, the
    parameter gradients summed over the images in order."""
    k0, k1 = jax_cbp._K0, jax_cbp._K1
    c4 = w1.shape[1]
    grads = [np.zeros(s, np.float32) for s in
             (ln_scale.shape, ln_bias.shape, w1.shape, b1.shape, w2.shape, gamma.shape,
              beta.shape)]
    daccs = []
    for hi, dyi in zip(h, dy):
        mean = hi.mean(-1, keepdims=True)
        var = np.maximum((hi * hi).mean(-1, keepdims=True) - mean * mean, 0.0)
        rstd = (1.0 / np.sqrt(var + np.float32(1e-6))).astype(np.float32)
        xhat = (hi - mean) * rstd
        y = _bf16(xhat * ln_scale + ln_bias)
        h1 = y @ w1 + b1
        t = np.tanh(np.float32(k0) * (h1 + np.float32(k1) * h1 * h1 * h1))
        ab = _bf16(0.5 * h1 * (1.0 + t))
        gx = np.sqrt((ab * ab).sum(0, keepdims=True) + np.float32(1e-12))
        m = gx.mean(-1, keepdims=True) + np.float32(1e-6)
        nx = gx / m
        dz = dyi @ w2.T
        z = _bf16(gamma * (ab * nx) + beta + ab)
        s1 = (dz * ab).sum(0, keepdims=True)
        dnx = gamma * s1
        dgx = dnx / m - (dnx * gx).sum(-1, keepdims=True) / (m * m * np.float32(c4))
        dab = dz * (gamma * nx + 1.0) + ab * (dgx / gx)
        ggrad = 0.5 * (1.0 + t) + 0.5 * h1 * (1.0 - t * t) * np.float32(k0) * (
            1.0 + np.float32(3.0 * k1) * h1 * h1)
        dh1 = (dab * ggrad).astype(np.float32)
        dh1b = _bf16(dh1)
        dyln = dh1b @ w1.T
        dyh = dyln * ln_scale
        daccs.append(_bf16(rstd * (dyh - dyh.mean(-1, keepdims=True)
                                   - xhat * (dyh * xhat).mean(-1, keepdims=True))))
        for g, v in zip(grads, ((dyln * xhat).sum(0), dyln.sum(0), y.T @ dh1b, dh1.sum(0),
                                z.T @ dyi, (s1 * nx)[0], dz.sum(0))):
            g += v.astype(np.float32)
    dlns, dlnb, dw1, db1, dw2, dg, dbe = grads
    return _as_port([np.stack(daccs), dlns, dlnb, dw1, db1, dw2, dg, dbe])


@pytest.mark.parametrize("b,r,c", [(2, 49, 16), (2, 256, 32)])
def test_tail_backward_reference_bf16_matches_tpu_arithmetic(b, r, c):
    """bf16: the plain version against the TPU kernel's arithmetic with f32
    sums, by the bound K10 itself is held to (va.grad_agreement with the
    run's dtype and cb.tail_grad_floors)."""
    p = _params(c, seed=7 + r)
    h, dy = (_bf16(a) for a in _rows(b, r, c, seed=8 + r))
    jp = {k: _bf16(p[k]) if k in ("w1", "w2") else p[k] for k in TAIL_KEYS}
    want = _tpu_bwd_bf16(h, dy, *(jp[k] for k in TAIL_KEYS))
    a = _port(p, torch.bfloat16)
    ht, dyt = torch.from_numpy(h).bfloat16(), torch.from_numpy(dy).bfloat16()
    args = [a[k] for k in TAIL_KEYS]
    got = cb.tail_backward_reference(ht, dyt, *args)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    floors = cb.tail_grad_floors(ht, dyt, *args)
    for name, g, w, floor in zip(cb.TAIL_GRAD_NAMES, got, want, floors):
        e = va.grad_agreement(g, torch.from_numpy(w), floor, torch.bfloat16)
        assert va.grad_agrees(e), (name, e)


def test_grad_agreement_takes_the_runs_dtype():
    """K10's f32 parameter gradients of a bf16 run are held to the bf16
    bounds: grad_agreement's dtype picks them (worst error 2^-7, mean 2^-15
    of the larger of the largest magnitude and the floor; f32 3e-5, 4e-6)."""
    ref = torch.linspace(-2, 2, 1001)
    for dtype, mean in ((torch.float32, 4e-6), (torch.bfloat16, 2 ** -15)):
        assert va.grad_agrees(va.grad_agreement(ref + 0.9 * mean * 2, ref, 0.0, dtype))
        assert not va.grad_agrees(va.grad_agreement(ref + 1.1 * mean * 2, ref, 0.0, dtype))
        # a floor above the largest magnitude widens both bounds
        assert va.grad_agrees(va.grad_agreement(ref + 1.1 * mean * 2, ref, 4.0, dtype))
    near = ref + 2 * 2 ** -15 * 0.9
    assert va.grad_agreement(near, ref)["mean_of_bound"] > 1  # ref's own dtype: f32
    assert va.grad_agrees(va.grad_agreement(near, ref, dtype=torch.bfloat16))


def test_tail_grad_floors_sit_at_or_above_the_outputs():
    """Each floor is 2^-8 of its output's largest sum of |terms|, which no
    output exceeds."""
    p = _params(16, seed=3)
    h, dy = (torch.from_numpy(a) for a in _rows(2, 49, 16, seed=4))
    a = _port(p)
    args = [a[k] for k in TAIL_KEYS]
    outs = cb.tail_backward_reference(h, dy, *args)
    for name, out, floor in zip(cb.TAIL_GRAD_NAMES, outs, cb.tail_grad_floors(h, dy, *args)):
        assert 0 < out.abs().max() <= floor / cb.TAIL_GRAD_FLOOR * (1 + 1e-6), name


BLOCK_ORDER = ("dw_kernel", "dw_bias", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "gamma",
               "beta")


def _jax_grad_as_port(name, g):
    g = np.asarray(g, np.float32)
    if name == "dw_kernel":
        return np.ascontiguousarray(g.transpose(2, 0, 1)[:, None])
    return g.T if name in ("w1", "w2") else g


@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_block_function_grads_match_jax(hw):
    """The Function's eleven gradients (forward and backward on their plain
    versions on the CPU) against jax.grad through the JAX block's custom_vjp
    (the Pallas tail backward in interpret mode), f32: each within 5e-5 of
    its largest magnitude."""
    c = 16
    p = _params(c, seed=11)
    x = np.random.default_rng(12).standard_normal((2, *hw, c)).astype(np.float32)

    def loss_j(*args):
        out = jax_cbp.convnext_block_fused(*args, True)
        return 0.5 * jnp.sum(out.astype(jnp.float32) ** 2)

    jargs = [jnp.asarray(x)] + [jnp.asarray(p[k]) for k in BLOCK_ORDER]
    want = jax.grad(loss_j, argnums=tuple(range(11)))(*jargs)
    a = _port(p)
    leaves = [torch.from_numpy(x).requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in a.values()]
    out = cb.convnext_block_fused(leaves[0], **dict(zip(a, leaves[1:])))
    (0.5 * (out ** 2).sum()).backward()
    for name, leaf, w in zip(("x",) + BLOCK_ORDER, leaves, want):
        ref = _jax_grad_as_port(name, w)
        top = float(np.abs(ref).max()) or 1.0
        err = float(np.abs(leaf.grad.numpy() - ref).max())
        assert err <= JAX_RTOL * top, (name, err, top)


def _block(c, seed):
    blk = port_convnext.init_weights_(ConvNeXtV2Block(c), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # LN, GRN and biases away from their identity init
        for name, prm in blk.named_parameters():
            if prm.dim() == 1:
                prm.copy_(0.5 + 0.3 * torch.randn(prm.shape, generator=gen))
    return blk


def test_training_gate_reaches_the_function(monkeypatch):
    """With fused_train_wins forced open (as the JAX test forces its gate,
    tests/test_convnext_fused.py:86-126), a block in training mode under
    XMIR_FUSED_MLP=1 goes through the Function and back through K10's
    wrapper; its gradients are finite and equal those of autograd through
    the same forward's plain version (f32, 1e-5 of each largest magnitude).
    With the gate closed (8 x 8 rows < 2048) training takes the plain path
    and inference the fused one."""
    calls = []
    real = cb.convnext_tail_bwd

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(cb, "convnext_tail_bwd", spy)
    monkeypatch.setenv("XMIR_FUSED_MLP", "1")
    blk = _block(8, seed=0).train()
    x = torch.randn((2, 8, 8, 8), generator=torch.Generator().manual_seed(2))
    seen = []
    real_fused = port_convnext.convnext_block_fused

    def fused_spy(*args, **kw):
        seen.append(True)
        return real_fused(*args, **kw)

    monkeypatch.setattr(port_convnext, "convnext_block_fused", fused_spy)
    blk(x)
    assert not seen  # the gate is closed at 64 rows in training
    with torch.no_grad():
        blk.eval()(x)
    assert len(seen) == 1  # inference always fuses
    blk.train()
    monkeypatch.setattr(port_convnext, "fused_train_wins", lambda r, c, c4: True)
    xg = x.clone().requires_grad_(True)
    (blk(xg) ** 2).sum().backward()
    assert len(seen) == 2 and calls == [(2, 64, 8)]
    got = {"x": xg.grad.clone(), **{n: q.grad.clone() for n, q in blk.named_parameters()}}
    assert all(torch.isfinite(g).all() for g in got.values())
    blk.zero_grad()
    xr = x.clone().requires_grad_(True)
    h = cb.dwconv(xr, blk.conv_dw.weight, blk.conv_dw.bias).reshape(2, 64, 8)
    m = blk.mlp
    out = cb.block_tail_reference(h, xr.reshape(2, 64, 8), blk.norm.weight, blk.norm.bias,
                                  m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
                                  m.grn.weight, m.grn.bias)
    (out ** 2).sum().backward()
    want = {"x": xr.grad, **{n: q.grad for n, q in blk.named_parameters()}}
    for name, g in got.items():
        assert (g - want[name]).abs().max() <= 1e-5 * want[name].abs().max(), name


def test_fused_train_wins_keeps_the_speed_clause():
    """ConvNeXtV2-Base at 384 px: stages 1 and 2 (9216, 2304 rows) fuse in
    training, stages 3 and 4 (576, 144) do not. The JAX rule agrees where its
    VMEM clause does not bind (stages 2-4) and refuses stage 1 for VMEM."""
    stages = ((9216, 128), (2304, 256), (576, 512), (144, 1024))
    assert [cb.fused_train_wins(r, c, 4 * c) for r, c in stages] == [True, True, False, False]
    assert [jax_cbp.fused_train_wins(r, c, 4 * c) for r, c in stages] == [
        False, True, False, False]


def test_tail_bwd_wrapper_checks_and_counts_no_cpu_call():
    p = _port(_params(8, seed=13))
    h = torch.zeros((1, 16, 8))
    args = [p[k] for k in TAIL_KEYS]
    before = cb.convnext_tail_bwd.launches
    out = cb.convnext_tail_bwd(h, h, *args)
    assert cb.convnext_tail_bwd.launches == before and len(out) == 8
    with pytest.raises(ValueError, match="shape"):
        cb.convnext_tail_bwd(h, h[:, :8], *args)
    with pytest.raises(ValueError, match="w1"):
        cb.convnext_tail_bwd(h, h, p["ln_scale"], p["ln_bias"], p["w2"], p["b1"], p["w1"],
                             p["gamma"], p["beta"])
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="device"):
        cb.convnext_tail_bwd(h.to("meta"), h.to("meta"), *meta)
