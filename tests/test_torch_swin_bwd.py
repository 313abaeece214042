"""The port's grouped-bias window attention backward (K5's plain version and
the autograd Function around K4 / K5) against the JAX package on the same
numpy inputs. Tier 1: CPU only, where the wrapper takes its plain version; the
JAX Pallas kernels run in interpret mode. The CUDA kernel itself is held to
``biased_attention_bwd_plain`` on the card
(tests/test_torch_swin_bwd_cuda.py, chip_smoke.py).

Tolerances, each relative to the gradient tensor's largest magnitude: f32
5e-5 for dq, dk, dv and dbias and 5e-4 for dscale, the JAX package's own
bounds on its kernel (tests/test_vit_attn.py: dscale sums many cancelling
terms). bf16: XLA's CPU bf16 product is not a sum of exact products (ROADMAP.md
section 3), so the bf16 plain version is held to the TPU kernel's arithmetic
written out in numpy with f32 sums, within ``va.GRAD_RTOL[bf16]`` (2^-7; ten
times that for dscale), where only the sums' order differs.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from xmir_tpu.ops.vit_attn_pallas import (
    _biased_bwd_pallas,
    _biased_fwd_pallas,
    _biased_reference,
    biased_attention_fused as jax_biased_attention_fused,
)
from xmir_tpu_torch.ops import vit_attn as va

TOLS = {"dq": 5e-5, "dk": 5e-5, "dv": 5e-5, "dbias": 5e-5, "dscale": 5e-4}
# (BH, G, g_size, N, hd, cosine, largest logit scale): the JAX test's cases
CASES = [(8, 2, 4, 144, 32, True, 100.0), (6, 3, 2, 576, 32, True, 60.0),
         (8, 2, 4, 120, 32, False, 4.0)]
IDS = ["swin-like, scale 100", "window 576", "no cosine"]


def _inputs(bh, G, n, d, smax, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((bh, n, d)).astype(np.float32) for _ in range(4))
    bias = rng.standard_normal((G, n, n)).astype(np.float32)
    scale = rng.uniform(smax / 4, smax, (G,)).astype(np.float32)
    return q, k, v, bias, scale, g


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    top = np.abs(want).max() or 1.0
    err = np.abs(got - want).max() / top
    assert err <= tol, f"{what}: {err} of the largest magnitude > {tol}"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("bh,G,gs,n,d,cosine,smax", CASES, ids=IDS)
def test_bwd_plain_matches_the_pallas_kernel_and_the_vjp_f32(bh, G, gs, n, d, cosine, smax):
    """All five gradients against ``_biased_bwd_pallas`` in interpret mode
    and ``jax.vjp(_biased_reference)``, within the JAX package's bounds."""
    q, k, v, bias, scale, g = _inputs(bh, G, n, d, smax, seed=0)
    jin = [jnp.asarray(t) for t in (q, k, v, bias, scale)]
    _, vjp = jax.vjp(lambda *a: _biased_reference(*a, gs, cosine), *jin)
    exact = vjp(jnp.asarray(g))
    o = _biased_fwd_pallas(*jin, gs, cosine, interpret=True)
    pallas = _biased_bwd_pallas(*jin, o, jnp.asarray(g), gs, cosine, interpret=True)
    got = va.biased_attention_bwd_plain(*(_t(t) for t in (q, k, v, bias, scale)), _t(o), _t(g),
                                        gs, cosine)
    shapes = [(bh, n, d)] * 3 + [(G, n, n), (G,)]
    for name, a, p, e, shape in zip(va.BIASED_GRAD_NAMES, got, pallas, exact, shapes):
        assert a.shape == shape and a.dtype == torch.float32
        _close(a.numpy(), p, TOLS[name], f"{name} against the Pallas kernel")
        _close(a.numpy(), e, TOLS[name], f"{name} against the vjp")


def _bf16(a):
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def _tpu_arithmetic_bf16(q, k, v, bias, scale, o, g, gs, cosine):
    """``_bwd_kernel_biased`` (:427-472) for bf16 inputs written out in numpy:
    f32 sums of exact products, rounding to bf16 where the kernel rounds."""
    bh, n, _ = q.shape
    G = bias.shape[0]
    gidx = (np.arange(bh) // gs) % G
    sc = scale[gidx][:, None, None]
    if cosine:
        def inv(x):
            return 1.0 / np.sqrt(np.maximum((x * x).sum(-1, keepdims=True), 1e-24))
        qinv, kinv = inv(q), inv(k)
        qh32, kh32 = q * qinv, k * kinv
        qh, kh = _bf16(qh32), _bf16(kh32)
    else:
        qh32, kh32, qh, kh = q, k, q, k
    log2e = np.float32(1.4426950408889634)
    s2 = (qh @ kh.transpose(0, 2, 1)) * (sc * log2e) + (bias * log2e)[gidx]
    e = np.exp2(s2 - s2.max(-1, keepdims=True))
    zinv = 1.0 / e.sum(-1, keepdims=True)
    c = (g * o).sum(-1, keepdims=True)
    t = e * (g @ v.transpose(0, 2, 1) - c)
    tb = _bf16(t)
    dbias = np.zeros((G, n, n), np.float32)
    for i in range(bh):
        dbias[gidx[i]] += t[i] * zinv[i]
    dqh = (tb @ kh) * (sc * zinv)
    alpha = (dqh * qh32).sum(-1, keepdims=True)
    dq = (dqh - qh32 * alpha) * qinv if cosine else dqh
    dkh = tb.transpose(0, 2, 1) @ _bf16(qh32 * (sc * zinv))
    if cosine:
        dk = (dkh - kh32 * (dkh * kh32).sum(-1, keepdims=True)) * kinv
    else:
        dk = dkh
    dv = _bf16(e).transpose(0, 2, 1) @ _bf16(g * zinv)
    dscale = np.zeros(G, np.float32)
    for i in range(bh):
        dscale[gidx[i]] += alpha[i].sum()
    return _bf16(dq), _bf16(dk), _bf16(dv), dbias, dscale / scale


@pytest.mark.parametrize("bh,G,gs,n,d,cosine,smax", CASES, ids=IDS)
def test_bwd_plain_bf16_matches_the_tpu_arithmetic(bh, G, gs, n, d, cosine, smax):
    q, k, v, bias, scale, g = _inputs(bh, G, n, d, smax, seed=1)
    q, k, v, g = (_bf16(t) for t in (q, k, v, g))
    tq, tk, tv, tg = (_t(a).bfloat16() for a in (q, k, v, g))
    o = va.biased_attention_plain(tq, tk, tv, _t(bias), _t(scale), gs, cosine)
    want = _tpu_arithmetic_bf16(q, k, v, bias, scale, o.float().numpy(), g, gs, cosine)
    got = va.biased_attention_bwd_plain(tq, tk, tv, _t(bias), _t(scale), o, tg, gs, cosine)
    rtol = va.GRAD_RTOL[torch.bfloat16]
    for name, a, b in zip(va.BIASED_GRAD_NAMES, got, want):
        assert a.dtype == (torch.bfloat16 if name in ("dq", "dk", "dv") else torch.float32)
        _close(a.float().numpy(), b, rtol * (va.DSCALE_BOUND_FACTOR if name == "dscale" else 1),
               name)


@pytest.mark.parametrize("cosine", [True, False])
def test_function_grads_match_jax_grad(cosine):
    """The Function's five gradients (K4's and K5's plain versions on the
    CPU) against ``jax.grad`` through ``_biased_reference``, as
    tests/test_vit_attn.py holds the JAX custom_vjp; and against the port's
    own ``biased_attention_bwd_reference``."""
    bh, G, gs, n, d = 8, 2, 4, 96, 16
    q, k, v, bias, scale, _ = _inputs(bh, G, n, d, 30.0 if cosine else 2.0, seed=2)

    def loss(*a):
        return jnp.sum(_biased_reference(*a, gs, cosine) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(t) for t in
                                                      (q, k, v, bias, scale)))
    leaves = [_t(t).requires_grad_(True) for t in (q, k, v, bias, scale)]
    out = va.biased_attention_fused(*leaves, gs, cosine)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    ref = va.biased_attention_bwd_reference(*(_t(t) for t in (q, k, v, bias, scale)), None,
                                            2 * out.detach(), gs, cosine)
    for name, a, r, b in zip(va.BIASED_GRAD_NAMES, got, ref, want):
        _close(a.numpy(), b, TOLS[name], f"Function {name}")
        _close(r.numpy(), b, TOLS[name], f"reference {name}")


def test_jax_custom_vjp_agrees_with_the_port_function():
    """The JAX package's differentiable call (interpret mode, XLA's vjp on
    the CPU) and the port's, on a shifted-window-like fold with a -100 mask."""
    bh, G, gs, n, d = 12, 6, 2, 64, 16
    q, k, v, bias, scale, g = _inputs(bh, G, n, d, 50.0, seed=3)
    bias = bias + np.where(np.random.default_rng(4).random((G, n, n)) < 0.3, -100.0,
                           0.0).astype(np.float32)

    def f(*a):
        return jnp.vdot(jax_biased_attention_fused(*a, gs, True, True), jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(t) for t in
                                                   (q, k, v, bias, scale)))
    leaves = [_t(t).requires_grad_(True) for t in (q, k, v, bias, scale)]
    got = torch.autograd.grad(va.biased_attention_fused(*leaves, gs, True), leaves, _t(g))
    for name, a, b in zip(va.BIASED_GRAD_NAMES, got, want):
        _close(a.numpy(), b, TOLS[name], name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_backward_is_the_plain_version_on_cpu(dtype):
    """``biased_attention_fused`` differentiates through
    ``biased_attention_bwd_plain`` on CPU tensors, bit for bit, in every
    input's dtype and shape, and counts no launch."""
    q, k, v, bias, scale, g = _inputs(8, 4, 64, 16, 40.0, seed=5)
    q, k, v, g = (_t(t).to(dtype) for t in (q, k, v, g))
    bias, scale = _t(bias), _t(scale).reshape(4, 1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v, bias, scale)]
    before = (va.biased_attention_fused.launches, va.biased_attention_bwd.launches)
    out = va.biased_attention_fused(*leaves, 2, True)
    assert torch.equal(out, va.biased_attention_plain(q, k, v, bias, scale, 2, True))
    got = torch.autograd.grad(out, leaves, g)
    want = va.biased_attention_bwd_plain(q, k, v, bias, scale, out.detach(), g, 2, True)
    for a, b, leaf in zip(got, want, leaves):
        assert torch.equal(a, b) and a.shape == leaf.shape and a.dtype == leaf.dtype
    assert (va.biased_attention_fused.launches, va.biased_attention_bwd.launches) == before


def test_bwd_envelope_and_refusals():
    """The TPU kernel's envelope: whole windows up to 768 tokens, N a
    multiple of 8, one run of rows per group; the plain version needs only
    BH == G g_size, which every Swin fold satisfies."""
    assert va.biased_bwd_eligible(576, 512, 16, 32)
    assert va.biased_bwd_eligible(144, 256, 32, 8)
    assert not va.biased_bwd_eligible(140, 24, 6, 4)   # N not a multiple of 8
    assert not va.biased_bwd_eligible(776, 8, 2, 4)    # past the whole-window tile
    assert not va.biased_bwd_eligible(576, 16, 2, 4)   # groups wrap
    q, k, v, bias, scale, g = (_t(t) for t in _inputs(16, 2, 16, 8, 4.0, seed=6))
    with pytest.raises(ValueError, match="BH == G g_size"):
        va.biased_attention_bwd(q, k, v, bias, scale, q, g, 4, True)
    with pytest.raises(ValueError, match="o and g"):
        va.biased_attention_bwd(q, k, v, bias, scale, q[:, :8], g, 8, True)
    # any N on the CPU: a window cut to 2 x 2 tokens
    q, k, v, bias, scale, g = (_t(t) for t in _inputs(8, 2, 4, 8, 4.0, seed=7))
    grads = va.biased_attention_bwd(q, k, v, bias, scale, q, g, 4, True)
    assert all(torch.isfinite(t).all() for t in grads)


def test_floors_and_agreement():
    """``biased_grad_floors`` bound each gradient's terms from above (a
    gradient is a sum of at most ``terms`` of them: N for dq, dk and dv,
    g_size for dbias and dscale), and ``biased_grad_agreement`` gives dscale
    its own, ten times wider bounds."""
    q, k, v, bias, scale, g = (_t(t) for t in _inputs(8, 2, 64, 16, 100.0, seed=8))
    o = va.biased_attention_plain(q, k, v, bias, scale, 4, True)
    grads = va.biased_attention_bwd_plain(q, k, v, bias, scale, o, g, 4, True)
    floors = va.biased_grad_floors(q, k, v, bias, scale, g, 4, True)
    for name, t, f, terms in zip(va.BIASED_GRAD_NAMES, grads, floors, (64, 64, 64, 4, 4)):
        assert 0 < f and t.abs().max() <= terms * f / va.GRAD_FLOOR, name
    noisy = [t + 1e-3 * t.abs().max() for t in grads]
    e = va.biased_grad_agreement(noisy, grads, floors, torch.float32)
    plain = va.grad_agreement(noisy[4], grads[4], floors[4], torch.float32)
    assert e["dscale"]["of_bound"] == pytest.approx(plain["of_bound"] / va.DSCALE_BOUND_FACTOR)
    assert not va.grad_agrees(e["dq"]) and va.grad_agrees(
        va.biased_grad_agreement(grads, grads, floors)["dbias"])


def _k5_blocked_model(q, k, v, bias, scale, o, g, g_size, cosine, unit_keys=128, q_tile=64):
    """csrc/window_attn_bwd.cu's bf16 design written out in plain PyTorch. The
    prep pass: qh, kh; s2 once per (query tile, 64-key tile), each row's
    exact max m and its z along the running max of the key tiles; c, qz, gz.
    The main pass, per (folded row, unit of 128 keys) and query tile of 64:
    s^T and dp^T formed once and shared by dk / dv (summed in f32 over the
    tiles), the unit's dq part t kh (added to an f32 sum in key-unit order,
    the first unit's part stored) and its dbias part t / z (added to dbias in
    the group's row order, the first row's part stored). The finishing pass:
    dqh = (the sum) scale / z, alpha, the cosine chain, one rounding."""
    dt = q.dtype
    bh, n, hd = q.shape
    groups = bias.shape[0]
    gidx = va.group_index(bh, groups, g_size, q.device)
    sc = scale.reshape(-1).float()[gidx][:, None, None]
    qf, kf = q.float(), k.float()
    if cosine:
        qinv, kinv = va.inv_norm(qf), va.inv_norm(kf)
        qh32, kh32 = qf * qinv, kf * kinv
        qh, kh = qh32.to(dt).float(), kh32.to(dt).float()
    else:
        qh32, kh32, qh, kh = qf, kf, qf, kf
    b2 = (bias.float() * va.LOG2E)[gidx]
    m = torch.full((bh, n, 1), float("-inf"))
    z = torch.zeros((bh, n, 1))
    for k0 in range(0, n, 64):  # the prep: z along the running max
        s2 = torch.matmul(qh, kh[:, k0:k0 + 64].transpose(-1, -2)) * (sc * va.LOG2E) + b2[
            :, :, k0:k0 + 64]
        m_new = torch.maximum(m, s2.amax(dim=-1, keepdim=True))
        z = z * torch.exp2(m - m_new) + torch.exp2(s2 - m_new).sum(dim=-1, keepdim=True)
        m = m_new
    zinv = 1.0 / z
    c = (g.float() * o.float()).sum(dim=-1, keepdim=True)
    qz = (qh32 * (sc * zinv)).to(dt).float()
    gz = (g.float() * zinv).to(dt).float()
    dq_sum = torch.zeros((bh, n, hd))
    dbias = torch.zeros((groups, n, n))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for row in range(bh):  # (level, group) order changes no sum: each chain has its own order
        grp, level = row // g_size, row % g_size
        for k0 in range(0, n, unit_keys):
            keys = slice(k0, k0 + unit_keys)
            khu, vu = kh[row, keys], v[row, keys].float()
            dk_u, dv_u = torch.zeros_like(khu), torch.zeros_like(vu)
            for q0 in range(0, n, q_tile):
                rows = slice(q0, q0 + q_tile)
                st = torch.matmul(khu, qh[row, rows].T) * (sc[row] * va.LOG2E) + b2[row, rows,
                                                                                    keys].T
                dpt = torch.matmul(vu, g[row, rows].float().T)
                e = torch.exp2(st - m[row, rows].T)
                t = e * (dpt - c[row, rows].T)
                tb = t.to(dt).float()
                dv_u += torch.matmul(e.to(dt).float(), gz[row, rows])
                dk_u += torch.matmul(tb, qz[row, rows])
                part = torch.matmul(tb.T, khu)
                dq_sum[row, rows] = part if k0 == 0 else dq_sum[row, rows] + part
                tz = (t * zinv[row, rows].T).T
                dbias[grp, rows, keys] = tz if level == 0 else dbias[grp, rows, keys] + tz
            if cosine:
                dk_u = (dk_u - kh32[row, keys] * (dk_u * kh32[row, keys]).sum(-1, keepdim=True)
                        ) * kinv[row, keys]
            dk[row, keys], dv[row, keys] = dk_u.to(dt), dv_u.to(dt)
    dqh = dq_sum * (sc * zinv)
    alpha = (dqh * qh32).sum(dim=-1, keepdim=True)
    dq = ((dqh - qh32 * alpha) * qinv if cosine else dqh).to(dt)
    dscale = va._group_sums(alpha.sum(dim=(1, 2)), groups) / scale.reshape(-1).float()
    return dq, dk, dv, dbias, dscale.reshape(scale.shape).to(scale.dtype)


# (BH, G, g_size, N, hd): one folded row a group; two; eight over a ragged N
# (not a multiple of the 64-row tiles or of the 128-key units)
K5_BLOCKED_CASES = [(4, 4, 1, 64, 32), (8, 4, 2, 136, 32), (16, 2, 8, 72, 16)]


@pytest.mark.parametrize("bh,G,gs,n,d", K5_BLOCKED_CASES)
@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "scaled"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_blocking_matches_plain_and_pallas(dtype, cosine, bh, G, gs, n, d):
    """The bf16 kernel's blocking (``_k5_blocked_model``) against
    ``biased_attention_bwd_plain`` within ``biased_grad_agreement``'s bounds
    (they round at the same points; only the order of the f32 sums and z's
    running rescale differ), and at this file's tolerances against
    ``_biased_bwd_pallas`` in interpret mode (f32) or the TPU kernel's
    arithmetic in numpy (bf16, as the plain version is held)."""
    q, k, v, bias, scale, g = _inputs(bh, G, n, d, 60.0 if cosine else 4.0, seed=bh + n)
    bias = bias + np.where(np.random.default_rng(n).random((G, n, n)) < 0.3, -100.0,
                           0.0).astype(np.float32)
    if dtype == torch.bfloat16:
        q, k, v, g = (_bf16(t) for t in (q, k, v, g))
    tq, tk, tv, tg = (_t(a).to(dtype) for a in (q, k, v, g))
    tb, ts = _t(bias), _t(scale)
    o = va.biased_attention_plain(tq, tk, tv, tb, ts, gs, cosine)
    got = _k5_blocked_model(tq, tk, tv, tb, ts, o, tg, gs, cosine)
    plain = va.biased_attention_bwd_plain(tq, tk, tv, tb, ts, o, tg, gs, cosine)
    floors = va.biased_grad_floors(tq, tk, tv, tb, ts, tg, gs, cosine)
    for name, e in va.biased_grad_agreement(got, plain, floors, dtype).items():
        assert va.grad_agrees(e), (name, e)
    if dtype == torch.float32:
        jin = [jnp.asarray(t) for t in (q, k, v, bias, scale)]
        want = _biased_bwd_pallas(*jin, jnp.asarray(o.numpy()), jnp.asarray(g), gs, cosine,
                                  interpret=True)
        tols = TOLS
    else:
        want = _tpu_arithmetic_bf16(q, k, v, bias, scale, o.float().numpy(), g, gs, cosine)
        rtol = va.GRAD_RTOL[torch.bfloat16]
        tols = {name: rtol * (va.DSCALE_BOUND_FACTOR if name == "dscale" else 1)
                for name in va.BIASED_GRAD_NAMES}
    for name, a, w in zip(va.BIASED_GRAD_NAMES, got, want):
        _close(a.float().numpy(), w, tols[name], name)


@pytest.mark.parametrize("dtype,bh,n,hd,groups", [
    (torch.float32, 512, 576, 32, 4), (torch.bfloat16, 128, 576, 32, 16),
    (torch.bfloat16, 256, 144, 32, 32), (torch.bfloat16, 6, 72, 8, 3)])
def test_k5_workspace_holds_every_part(dtype, bh, n, hd, groups):
    """``biased_bwd_workspace_bytes``: the (BH, N, 4) f32 row statistics the
    wrapper reads alpha from, and in bf16 qh, qz, gz, the f32 dq sums and
    the two tables of int32 counters, one a (row, 64-row tile) and one a
    (group, tile, 128-key unit); in f32 qh and the TF32 small parts of qh
    and g, qz^T and gz^T with their small parts (N padded to 64), the dq
    sums and the counters, one a (row, 32-row tile) and one a (group, tile,
    64-key unit)."""
    got = va.biased_bwd_workspace_bytes(dtype, bh, n, hd, groups)
    stats = bh * n * 4 * 4
    if dtype == torch.float32:
        n_pad, tiles, units = (n + 63) // 64 * 64, (n + 31) // 32, (n + 63) // 64
        rows_part = 4 * bh * n * hd * 4
        transposed = 4 * bh * hd * n_pad * 4
        counters = bh * tiles * 4 + groups * tiles * units * 4
        assert got == stats + rows_part + transposed + counters
        assert (stats + rows_part + transposed) % 16 == 0
        return
    tiles, units = (n + 63) // 64, (n + 127) // 128
    operands = 3 * bh * n * hd * 2 + bh * n * hd * 4
    counters = bh * tiles * 4 + groups * tiles * units * 4
    assert got == stats + operands + counters
    assert stats % 16 == 0 and (stats + operands) % 16 == 0  # each part 16-byte aligned
