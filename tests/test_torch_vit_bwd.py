"""The port's attention backward (K3's plain version and the autograd
Function around K2 / K3) and the K7 / K8 backwards against the JAX package on
the same numpy inputs. Tier 1: CPU only, where the wrappers take their plain
versions; the JAX Pallas kernels run in interpret mode. The CUDA kernel itself
is held to ``attention_bwd_plain`` on the card
(tests/test_torch_vit_bwd_cuda.py, chip_smoke.py).

Tolerances, each relative to the gradient tensor's largest magnitude (a
gradient is a sum of up to N terms of either sign): f32 3e-5, the JAX test's
own bound (tests/test_vit_attn.py); bf16 2^-6, four bf16 steps of the largest
magnitude, since the two sides shift each score row differently by design (the
row max there, its ceiling here), so their t and e round to bf16 at other
places.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xmir_tpu.ops import ln_dense_pallas as jln
from xmir_tpu.ops.vit_attn_pallas import (
    _attention_bwd_pallas,
    _attention_fwd_pallas,
    _attention_reference,
)
from xmir_tpu_torch.ops import ln_dense as ld
from xmir_tpu_torch.ops import plain_attn
from xmir_tpu_torch.ops import vit_attn as va

SHAPES = [(2, 137, 64), (3, 72, 32), (2, 729, 72)]
F32_RTOL, BF16_RTOL = 3e-5, 2 ** -6


def _inputs(bh, n, d, seed=0, count=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bh, n, d)).astype(np.float32) for _ in range(count)]


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = np.abs(want).max() or 1.0
    err = np.abs(got - want).max() / top
    assert err <= rtol, f"{what}: {err} of the largest magnitude > {rtol}"


@pytest.mark.parametrize("bh,n,d", SHAPES)
def test_bwd_plain_matches_pallas_f32(bh, n, d):
    q, k, v, g = _inputs(bh, n, d)
    sc = d ** -0.5
    o = _attention_fwd_pallas(*(jnp.asarray(t) for t in (q, k, v)), sc, interpret=True)
    want = _attention_bwd_pallas(*(jnp.asarray(t) for t in (q, k, v)), o, jnp.asarray(g), sc,
                                 interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    got = va.attention_bwd_plain(tq, tk, tv, va.attention_plain(tq, tk, tv, sc), tg, sc)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == (bh, n, d) and a.dtype == torch.float32
        _close(a.numpy(), b, F32_RTOL, name)


@pytest.mark.parametrize("bh,n,d", SHAPES)
def test_bwd_plain_matches_pallas_bf16(bh, n, d):
    q, k, v, g = (t.astype(ml_dtypes.bfloat16) for t in _inputs(bh, n, d, seed=1))
    sc = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(t) for t in (q, k, v, g))
    o = _attention_fwd_pallas(jq, jk, jv, sc, interpret=True)
    want = _attention_bwd_pallas(jq, jk, jv, o, jg, sc, interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(t.astype(np.float32)).bfloat16() for t in (q, k, v, g))
    got = va.attention_bwd_plain(tq, tk, tv, va.attention_plain(tq, tk, tv, sc), tg, sc)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        _close(a.float().numpy(), np.asarray(b.astype(jnp.float32)), BF16_RTOL, name)


@pytest.mark.parametrize("bh,n,d", SHAPES + [(2, 1, 16), (1, 65, 8)])
def test_bwd_plain_matches_reference_vjp(bh, n, d):
    """Against the exact vjp of softmax(q k^T s) v on both sides: the JAX
    package's (``_attention_reference``) and the port's
    ``attention_bwd_reference``."""
    q, k, v, g = _inputs(bh, n, d, seed=2)
    sc = d ** -0.5
    _, vjp = jax.vjp(lambda q, k, v: _attention_reference(q, k, v, sc),
                     *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv, tg = (torch.from_numpy(t) for t in (q, k, v, g))
    ref = va.attention_bwd_reference(tq, tk, tv, tg, sc)
    got = va.attention_bwd_plain(tq, tk, tv, va.attention_plain(tq, tk, tv, sc), tg, sc)
    # at N = 1 dq and dk are exactly 0 and the residue of dp - c remains:
    # held to the cotangent's scale there
    for name, a, r, b in zip(("dq", "dk", "dv"), got, ref, want):
        if n == 1 and name != "dv":
            assert a.abs().max() <= 1e-5 and r.abs().max() <= 1e-5
            continue
        _close(r.numpy(), b, F32_RTOL, f"reference {name}")
        _close(a.numpy(), b, F32_RTOL, f"plain {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_backward_is_the_plain_version_on_cpu(dtype):
    """``vit_attention_fused`` and ``flash_attention_plain`` differentiate
    through ``attention_bwd_plain`` on CPU tensors, bit for bit, and count no
    launch."""
    q, k, v, g = (torch.from_numpy(t).to(dtype) for t in _inputs(4, 50, 32, seed=3))
    sc = 32 ** -0.5
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (va.vit_attention_fused.launches, va.vit_attention_bwd.launches)
    out = va.vit_attention_fused(*leaves, sc)
    assert torch.equal(out, va.attention_plain(q, k, v, sc))
    got = torch.autograd.grad(out, leaves, g)
    want = va.attention_bwd_plain(q, k, v, out.detach(), g, sc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    q4, k4, v4 = (t.reshape(2, 2, 50, 32).clone().requires_grad_(True) for t in (q, k, v))
    out4 = plain_attn.flash_attention_plain(q4, k4, v4, sc)
    for a, b in zip(torch.autograd.grad(out4, (q4, k4, v4), g.reshape(2, 2, 50, 32)), want):
        assert torch.equal(a.reshape(4, 50, 32), b)
    assert (va.vit_attention_fused.launches, va.vit_attention_bwd.launches) == before


def test_backward_wrapper_checks_operands():
    q = torch.zeros((2, 8, 16))
    with pytest.raises(ValueError, match="match q's shape"):
        va.vit_attention_bwd(q, q, q, q[:, :4], q, None, 0.25)
    with pytest.raises(ValueError, match="match q's shape"):
        va.vit_attention_bwd(q, q, q, q, q.bfloat16(), None, 0.25)
    with pytest.raises(TypeError, match="one dtype"):
        va.vit_attention_bwd(q, q.bfloat16(), q, q, q, None, 0.25)


def test_grad_agreement_reads_relative_to_the_largest_magnitude():
    ref = torch.tensor([4.0, -0.001, 0.5])
    same = va.grad_agreement(ref.clone(), ref)
    assert same == {"max_abs_err": 0.0, "of_bound": 0.0, "mean_of_bound": 0.0}
    assert va.grad_agrees(same)
    off = va.grad_agreement(ref + torch.tensor([0.0, 0.001, 0.0]), ref)
    assert off["max_abs_err"] == pytest.approx(1e-3)
    assert off["of_bound"] == pytest.approx(1e-3 / (va.GRAD_RTOL[torch.float32] * 4.0), rel=1e-4)
    assert not va.grad_agrees(off)
    assert not va.grad_agrees(va.grad_agreement(ref * float("nan"), ref))
    # a floor above the largest magnitude takes its place
    floored = va.grad_agreement(ref + torch.tensor([0.0, 0.001, 0.0]), ref, floor=400.0)
    assert floored["of_bound"] == pytest.approx(off["of_bound"] / 100, rel=1e-4)
    q, k, v, g = (torch.full((1, 2, 4), x) for x in (1.0, 2.0, 3.0, 0.5))
    fq, fk, fv = va.grad_floors(q, k, v, g, 0.5)
    d = 1.0 * 6.0  # |g row| |v row|
    assert [fq.item(), fk.item(), fv.item()] == pytest.approx(
        [va.GRAD_FLOOR * 0.5 * d * 2.0, va.GRAD_FLOOR * 0.5 * d * 1.0, va.GRAD_FLOOR * 0.5])


def _k3_blocked_model(q, k, v, o, g, sm_scale, unit_keys=128, q_tile=64):
    """csrc/vit_attn_bwd.cu's bf16 design written out in plain PyTorch: qs,
    qz, gz and (m, c) precomputed per row; per (head, unit of 128 keys) the
    query tiles of 64 stream past, s^T and dp^T formed once, dk and dv summed
    in f32 over the tiles, and each unit's dq part t k added to an f32 sum in
    unit order; dq scaled by scale / z and rounded once at the end."""
    dt = q.dtype
    qs = q * torch.tensor(va.scale_constant(sm_scale, dt), dtype=dt)
    s_full = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = torch.ceil(s_full.amax(dim=-1, keepdim=True))  # the forward's shift
    zinv = 1.0 / torch.exp2(s_full - m).sum(dim=-1, keepdim=True)
    c = (g.float() * o.float()).sum(dim=-1, keepdim=True)
    qz = (q.float() * (sm_scale * zinv)).to(dt).float()
    gz = (g.float() * zinv).to(dt).float()
    bh, n, hd = q.shape
    dq_acc = torch.zeros((bh, n, hd))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, n, unit_keys):
        ku, vu = k[:, k0:k0 + unit_keys].float(), v[:, k0:k0 + unit_keys].float()
        dk_u = torch.zeros_like(ku)
        dv_u = torch.zeros_like(vu)
        for q0 in range(0, n, q_tile):
            rows = slice(q0, q0 + q_tile)
            st = torch.matmul(ku, qs[:, rows].float().transpose(-1, -2))
            dpt = torch.matmul(vu, g[:, rows].float().transpose(-1, -2))
            e = torch.exp2(st - m[:, rows].transpose(-1, -2))
            t = (e * (dpt - c[:, rows].transpose(-1, -2))).to(dt).float()
            dv_u += torch.matmul(e.to(dt).float(), gz[:, rows])
            dk_u += torch.matmul(t, qz[:, rows])
            dq_acc[:, rows] = dq_acc[:, rows] + torch.matmul(t.transpose(-1, -2), ku)
        dk[:, k0:k0 + unit_keys], dv[:, k0:k0 + unit_keys] = dk_u.to(dt), dv_u.to(dt)
    return (dq_acc * (sm_scale * zinv)).to(dt), dk, dv


@pytest.mark.parametrize("bh,n,d", [(2, 137, 64), (3, 200, 32), (2, 129, 72), (1, 1, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_blocking_matches_plain_and_pallas(dtype, bh, n, d):
    """The bf16 kernel's blocking (``_k3_blocked_model``) against
    ``attention_bwd_plain`` within ``grad_agreement``'s bounds (the two round
    at the same points; only the order of the f32 sums differs), and against
    the JAX backward in interpret mode at this file's tolerances."""
    q, k, v, g = _inputs(bh, n, d, seed=5)
    if dtype == torch.bfloat16:
        q, k, v, g = (t.astype(ml_dtypes.bfloat16) for t in (q, k, v, g))
    sc = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(t) for t in (q, k, v, g))
    o = _attention_fwd_pallas(jq, jk, jv, sc, interpret=True)
    want = _attention_bwd_pallas(jq, jk, jv, o, jg, sc, interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(np.asarray(t, np.float32)).to(dtype) for t in (q, k, v, g))
    out = va.attention_plain(tq, tk, tv, sc)
    got = _k3_blocked_model(tq, tk, tv, out, tg, sc)
    plain = va.attention_bwd_plain(tq, tk, tv, out, tg, sc)
    floors = va.grad_floors(tq, tk, tv, tg, sc)
    rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
    for name, a, b, w, floor in zip(("dq", "dk", "dv"), got, plain, want, floors):
        assert a.dtype == dtype
        e = va.grad_agreement(a, b, floor)
        assert va.grad_agrees(e), (name, e)
        if n > 1 or name == "dv":  # at N = 1 dq and dk are residues of dp - c
            _close(a.float().numpy(), np.asarray(w, np.float32), rtol, name)


# --- K7 / K8 backwards ---------------------------------------------------------


def _ln_inputs(b, n, c, m, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(x=(rng.standard_normal((b, n, c)) * 2 + 0.5).astype(f),
                lns=(1 + 0.2 * rng.standard_normal(c)).astype(f),
                lnb=(0.1 * rng.standard_normal(c)).astype(f),
                w=(rng.standard_normal((c, m)) * c ** -0.5).astype(f),  # the JAX layout (C, M)
                b=(0.1 * rng.standard_normal(m)).astype(f))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("b,n,c,heads", [(2, 37, 128, 4), (1, 70, 64, 2)])
def test_ln_qkv_backward_matches_jax_vjp(b, n, c, heads, with_bias):
    """dx, dlns, dlnb, dw (transposed: the port's weight is (3C, C)) and db
    against ``jax.vjp`` of the JAX package's ``ln_qkv_fused`` in interpret
    mode (its analytic backward): 1e-5 of each gradient's largest magnitude,
    f32."""
    a = _ln_inputs(b, n, c, 3 * c, seed=c)
    rng = np.random.default_rng(9)
    cot = [rng.standard_normal((b, heads, n, c // heads)).astype(np.float32) for _ in range(3)]
    bias = jnp.asarray(a["b"]) if with_bias else None

    def jax_fn(x, lns, lnb, w, bias):
        return jln.ln_qkv_fused(x, lns, lnb, w, bias, heads, 1e-6, 32, True)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(a["x"]), jnp.asarray(a["lns"]), jnp.asarray(a["lnb"]),
                     jnp.asarray(a["w"]), bias)
    want = vjp(tuple(jnp.asarray(t) for t in cot))
    leaves = [torch.from_numpy(a["x"]), torch.from_numpy(a["lns"]), torch.from_numpy(a["lnb"]),
              torch.from_numpy(np.ascontiguousarray(a["w"].T))]
    if with_bias:
        leaves.append(torch.from_numpy(a["b"]))
    leaves = [t.requires_grad_(True) for t in leaves]
    out = ld.ln_qkv_fused(*leaves[:4], leaves[4] if with_bias else None, heads)
    got = torch.autograd.grad(out, leaves, [torch.from_numpy(t) for t in cot])
    names = ("dx", "dlns", "dlnb", "dw", "db")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w).T if name == "dw" else np.asarray(w)
        assert g.shape == w.shape
        _close(g.numpy(), w, 1e-5, name)
    # and the analytic backward is the gradient of the plain forward
    ref_leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    ref_out = ld.ln_qkv_reference(*ref_leaves[:4], ref_leaves[4] if with_bias else None, heads)
    ref = torch.autograd.grad(ref_out, ref_leaves, [torch.from_numpy(t) for t in cot])
    for name, g, r in zip(names, got, ref):
        _close(g.numpy(), r.numpy(), 1e-5, f"{name} against autograd")


def test_ln_qkv_backward_bf16_rounding_points():
    """bf16: the gradients come back in the inputs' dtypes, and lie within
    bf16's resolution of the f32 gradients on the same values (2^-6 of the
    largest magnitude: y, the cotangent and dw each round to bf16)."""
    a = _ln_inputs(2, 37, 128, 384, seed=3)
    rng = np.random.default_rng(4)
    cot = [torch.from_numpy(rng.standard_normal((2, 4, 37, 32)).astype(np.float32)).bfloat16()
           for _ in range(3)]
    x = torch.from_numpy(a["x"]).bfloat16()
    w = torch.from_numpy(np.ascontiguousarray(a["w"].T)).bfloat16()
    lns, lnb, b = (torch.from_numpy(a[k]) for k in ("lns", "lnb", "b"))
    got = ld.ln_qkv_backward(x, lns, lnb, w, b, *cot)
    want = ld.ln_qkv_backward(x.float(), lns, lnb, w.float(), b, *(t.float() for t in cot))
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.float32]
    for name, g, r in zip(("dx", "dlns", "dlnb", "dw", "db"), got, want):
        _close(g.float().numpy(), r.numpy(), 2 ** -6, name)


@pytest.mark.parametrize("act", ["gelu", ""])
@pytest.mark.parametrize("with_bias", [True, False])
def test_ln_dense_backward_matches_jax_vjp(act, with_bias):
    """K8's backward (the gradient of its plain version on the saved inputs)
    against ``jax.vjp`` of the JAX package's ``ln_dense_fused`` in interpret
    mode: 1e-5 of each gradient's largest magnitude, f32."""
    a = _ln_inputs(1, 45, 64, 128, seed=5)
    rows = a["x"][0]
    cot = np.random.default_rng(6).standard_normal((45, 128)).astype(np.float32)
    bias = jnp.asarray(a["b"]) if with_bias else None

    def jax_fn(x, lns, lnb, w, bias):
        return jln.ln_dense_fused(x, lns, lnb, w, bias, 1e-6, act, 32, True)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(rows), jnp.asarray(a["lns"]), jnp.asarray(a["lnb"]),
                     jnp.asarray(a["w"]), bias)
    want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(rows), torch.from_numpy(a["lns"]), torch.from_numpy(a["lnb"]),
              torch.from_numpy(np.ascontiguousarray(a["w"].T))]
    if with_bias:
        leaves.append(torch.from_numpy(a["b"]))
    leaves = [t.requires_grad_(True) for t in leaves]
    out = ld.ln_dense_fused(*leaves[:4], leaves[4] if with_bias else None, 1e-6, act)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(cot))
    for name, g, w in zip(("dx", "dlns", "dlnb", "dw", "db"), got, want):
        w = np.asarray(w).T if name == "dw" else np.asarray(w)
        _close(g.numpy(), w, 1e-5, name)


def test_ln_dense_backward_only_for_inputs_that_need_it():
    a = _ln_inputs(1, 9, 64, 128, seed=7)
    x = torch.from_numpy(a["x"][0])
    w = torch.from_numpy(np.ascontiguousarray(a["w"].T)).requires_grad_(True)
    out = ld.ln_dense_fused(x, torch.from_numpy(a["lns"]), torch.from_numpy(a["lnb"]), w, None)
    out.sum().backward()
    assert w.grad is not None and x.grad is None
