"""The plain versions of the Swin attention kernels (K4: ops/vit_attn.py::
biased_attention_fused; K6: ops/window_attn.py::window_attention_fused)
against the JAX package's Pallas kernels in interpret mode, on the same numpy
inputs. Tier 1: CPU only, where the port's wrappers take their plain versions;
the CUDA kernels are held against these plain versions on the card
(chip_smoke.py, tests/test_torch_swin_kernels_cuda.py).

Tolerances. f32: |out - ref| <= 3e-5 (1 + |ref|); both sides round nowhere
and take the exact row max, so only the order of the f32 sums and the
implementations of exp2 and rsqrt differ. bf16 with the cosine normalisation
(what SwinV2 runs): the port's plain version has the TPU kernel's rounding
points, its exact row max and its order of the sums of squares, and the two
agree within 2 bf16 steps + 2^-6 per output and 0.05 of a step on average
(they read bit-equal on most cases). bf16 without it: the kernel rounds
q scale log2(e) to bf16 before the score product, as the TPU's matrix unit
needs; XLA on the CPU keeps that product in f32 (excess precision), so the
interpret-mode kernel is not its own arithmetic there, and the bound is K2's
for the same reason: 1.5 steps on average, four times the per-output bound.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu.ops import vit_attn_pallas as jva
from xmir_tpu.ops import window_attn_pallas as jwa
from xmir_tpu_torch.ops import vit_attn as va
from xmir_tpu_torch.ops import window_attn as wa
from xmir_tpu_torch.ops.convnext_block import bf16_step

F32_RTOL = 3e-5
MASK = -100.0


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _close_f32(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    bound = F32_RTOL * (1 + np.abs(ref))
    worst = np.max(np.abs(out - ref) / bound)
    assert worst <= 1, f"{worst} of the f32 bound"


def _close_bf16(out, ref, of_bound=1.0, mean_steps=0.05):
    """out, ref: torch f32 tensors holding bf16 values."""
    step = bf16_step(ref)
    d = (out - ref).abs()
    worst = (d / (2 * step + 2 ** -6)).max().item()
    assert worst <= of_bound, worst
    big = ref.abs() >= 2 ** -4
    assert (d[big] / step[big]).mean().item() <= mean_steps


def _biased_inputs(seed, bh, n, hd, groups, masked=False, scale_max=30.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bh, n, hd)).astype(np.float32) for _ in range(3))
    bias = (2 * rng.standard_normal((groups, n, n))).astype(np.float32)
    if masked:  # a shift mask: most keys of some rows at -100
        bias += np.where(rng.random((groups, n, n)) < 0.6, MASK, 0.0).astype(np.float32)
    scale = rng.uniform(1.0, scale_max, groups).astype(np.float32)
    return q, k, v, bias, scale


# (BH, N, G, g_size, masked): G = 1; groups that wrap (G < BH / g_size); the
# shifted fold (G = heads x windows, g_size = images); Swin's window sizes
CASES = [
    (4, 16, 1, 1, False),
    (12, 16, 2, 3, False),
    (12, 140, 6, 2, True),
    (4, 144, 2, 2, False),
    (2, 576, 2, 1, True),
]


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "scaled"])
@pytest.mark.parametrize("bh,n,groups,g_size,masked", CASES)
def test_biased_plain_matches_pallas_f32(bh, n, groups, g_size, masked, cosine):
    q, k, v, bias, scale = _biased_inputs(n + bh, bh, n, 32, groups, masked)
    if not cosine:
        scale = scale * 0.02  # raw dot products of 32-wide rows are ~6, not ~1
    ref = jva.biased_attention_fused(_j(q), _j(k), _j(v), _j(bias), _j(scale), g_size, cosine,
                                     True)
    out = va.biased_attention_fused(_t(q), _t(k), _t(v), _t(bias), _t(scale), g_size, cosine)
    assert out.shape == (bh, n, 32) and out.dtype == torch.float32
    _close_f32(out.numpy(), ref)
    # and the TPU file's rounding-free reference, as its own tests hold it
    xla = jva._biased_reference(_j(q), _j(k), _j(v), _j(bias), _j(scale), g_size, cosine)
    plain_ref = va.biased_attention_reference(_t(q), _t(k), _t(v), _t(bias), _t(scale), g_size,
                                              cosine)
    _close_f32(plain_ref.numpy(), xla)
    _close_f32(out.numpy(), xla)


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "scaled"])
@pytest.mark.parametrize("bh,n,groups,g_size,masked", CASES[:4])
def test_biased_plain_matches_pallas_bf16(bh, n, groups, g_size, masked, cosine):
    q, k, v, bias, scale = _biased_inputs(n + bh + 1, bh, n, 32, groups, masked)
    if not cosine:
        scale = scale * 0.02
    bf = jnp.bfloat16
    ref = jva.biased_attention_fused(_j(q, bf), _j(k, bf), _j(v, bf), _j(bias), _j(scale), g_size,
                                     cosine, True)
    tb = torch.bfloat16
    out = va.biased_attention_fused(_t(q, tb), _t(k, tb), _t(v, tb), _t(bias), _t(scale), g_size,
                                    cosine)
    assert out.dtype == torch.bfloat16
    bounds = {} if cosine else dict(of_bound=4.0, mean_steps=1.5)
    _close_bf16(out.float(), _t(np.asarray(ref, np.float32)), **bounds)


def test_biased_scale_at_the_clamp_and_rows_with_few_live_keys():
    """logit_scale at its clamp of 100 (logits +-100 and a -100 mask) and rows
    whose mask leaves one or two live keys: finite, and equal to the Pallas
    kernel."""
    bh, n, hd = 4, 144, 32
    q, k, v, bias, _ = _biased_inputs(7, bh, n, hd, 2)
    bias[:, :, 2:] += MASK  # rows keep keys 0 and 1
    bias[:, 5, 1] += MASK   # row 5 keeps key 0 alone
    scale = np.full(2, 100.0, np.float32)
    ref = jva.biased_attention_fused(_j(q), _j(k), _j(v), _j(bias), _j(scale), 2, True, True)
    out = va.biased_attention_fused(_t(q), _t(k), _t(v), _t(bias), _t(scale), 2, True)
    assert torch.isfinite(out).all()
    _close_f32(out.numpy(), ref)


def test_biased_group_index_and_scale_shapes():
    """Row i uses group (i // g_size) % G; scale may come as (G,) or (G, 1)."""
    q, k, v, bias, scale = _biased_inputs(3, 12, 16, 32, 3)
    out = va.biased_attention_fused(_t(q), _t(k), _t(v), _t(bias), _t(scale), 2, True)
    col = va.biased_attention_fused(_t(q), _t(k), _t(v), _t(bias), _t(scale).reshape(3, 1), 2,
                                    True)
    assert torch.equal(out, col)
    for i in range(12):
        g = (i // 2) % 3
        one = va.biased_attention_fused(_t(q[i:i + 1]), _t(k[i:i + 1]), _t(v[i:i + 1]),
                                        _t(bias[g:g + 1]), _t(scale[g:g + 1]), 1, True)
        np.testing.assert_allclose(out[i].numpy(), one[0].numpy(), atol=1e-6, rtol=0)


def test_biased_wrapper_rejects_bad_operands():
    q, k, v, bias, scale = (_t(a) for a in _biased_inputs(0, 4, 16, 32, 2))
    with pytest.raises(ValueError, match="one .BH, N, hd. shape"):
        va.biased_attention_fused(q, k[:, :8], v, bias, scale)
    with pytest.raises(TypeError, match="one dtype"):
        va.biased_attention_fused(q, k.bfloat16(), v, bias, scale)
    with pytest.raises(ValueError, match="bias"):
        va.biased_attention_fused(q, k, v, bias[:, :8], scale)
    with pytest.raises(ValueError, match="G scales"):
        va.biased_attention_fused(q, k, v, bias, scale[:1])
    with pytest.raises(ValueError, match="g_size"):
        va.biased_attention_fused(q, k, v, bias, scale, 0)
    with pytest.raises(ValueError, match="no attention kernel"):
        va.biased_attention_fused(*(t.to("meta") for t in (q, k, v, bias, scale)))


def test_sum_squares_is_a_sum_of_squares_in_the_kernels_order():
    x = torch.randn(5, 7, 32, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(va.sum_squares(x).numpy(), (x * x).sum(-1, keepdim=True).numpy(),
                               rtol=1e-6)
    odd = torch.randn(3, 12, generator=torch.Generator().manual_seed(1))
    assert torch.equal(va.sum_squares(odd), (odd * odd).sum(-1, keepdim=True))
    # bf16 values: eight in sequence, then pairs of the vectors
    b = torch.randn(4, 24, generator=torch.Generator().manual_seed(2)).bfloat16().float()
    sq = (b * b).reshape(4, 3, 8)
    seq = sq[..., 0]
    for i in range(1, 8):
        seq = seq + sq[..., i]
    want = (seq[:, 0] + seq[:, 1]) + (seq[:, 2] + 0.0)
    assert torch.equal(va.sum_squares(b)[:, 0], want)
    tiny = torch.full((1, 8), 1e-20)
    assert va.inv_norm(tiny).item() == pytest.approx(1e12)  # the 1e-24 clamp on the sum


# -- K6 -----------------------------------------------------------------------------

def _window_inputs(seed, nw, b, h, n, d, nwb):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((nw, b, h, n, d)).astype(np.float32) for _ in range(3))
    q = 10 * q / np.linalg.norm(q, axis=-1, keepdims=True)
    k = k / np.linalg.norm(k, axis=-1, keepdims=True)
    bias = (2 * rng.standard_normal((nwb, h, n, n))).astype(np.float32)
    if nwb > 1:
        bias += np.where(rng.random((nwb, h, n, n)) < 0.5, MASK, 0.0).astype(np.float32)
    return q.astype(np.float32), k.astype(np.float32), v, bias


@pytest.mark.parametrize("nw,b,h,n,nwb", [(4, 2, 3, 64, 4), (4, 2, 3, 64, 1), (1, 2, 4, 144, 1),
                                          (3, 1, 2, 140, 3)])
def test_window_plain_matches_pallas_f32(nw, b, h, n, nwb):
    q, k, v, bias = _window_inputs(n + nwb, nw, b, h, n, 32, nwb)
    ref = jwa.window_attention_fused(_j(q), _j(k), _j(v), _j(bias), interpret=True)
    out = wa.window_attention_fused(_t(q), _t(k), _t(v), _t(bias))
    assert out.shape == (nw, b, h, n, 32) and out.dtype == torch.float32
    _close_f32(out.numpy(), ref)


@pytest.mark.parametrize("nwb", [2, 1], ids=["per_window", "shared"])
def test_window_plain_matches_pallas_bf16(nwb):
    q, k, v, bias = _window_inputs(11 + nwb, 2, 2, 2, 64, 32, nwb)
    bf, tb = jnp.bfloat16, torch.bfloat16
    ref = jwa.window_attention_fused(_j(q, bf), _j(k, bf), _j(v, bf), _j(bias), interpret=True)
    out = wa.window_attention_fused(_t(q, tb), _t(k, tb), _t(v, tb), _t(bias))
    assert out.dtype == torch.bfloat16
    _close_bf16(out.float(), _t(np.asarray(ref, np.float32)))


def test_window_plain_rounds_after_normalising():
    """K6 rounds p = e / z, K4 rounds e and divides after the product: on
    bf16 inputs the two differ, and the plain version is the former."""
    q, k, v, bias = _window_inputs(5, 1, 1, 2, 64, 32, 1)
    tb = torch.bfloat16
    out = wa.window_attention_plain(_t(q, tb), _t(k, tb), _t(v, tb), _t(bias))
    s = torch.matmul(_t(q, tb).float(), _t(k, tb).float().transpose(-1, -2)) + _t(bias)[:, None]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    late = (torch.matmul(e.to(tb).float(), _t(v, tb).float()) / e.sum(-1, keepdim=True)).to(tb)
    early = torch.matmul((e / e.sum(-1, keepdim=True)).to(tb).float(), _t(v, tb).float()).to(tb)
    assert torch.equal(out, early) and not torch.equal(out, late)


def test_window_wrapper_rejects_bad_operands():
    q, k, v, bias = (_t(a) for a in _window_inputs(0, 2, 1, 2, 16, 32, 2))
    with pytest.raises(ValueError, match="one .NW, B, H, N, D. shape"):
        wa.window_attention_fused(q[0], k[0], v[0], bias)
    with pytest.raises(ValueError, match="bias"):
        wa.window_attention_fused(q, k, v, torch.cat([bias, bias[:1]]))
    with pytest.raises(TypeError, match="one dtype"):
        wa.window_attention_fused(q, k, v.bfloat16(), bias)


@pytest.mark.parametrize("flag,bf16_cpu,f32_cpu,bf16_cuda,f32_cuda", [
    (None, False, False, True, False), ("0", False, False, False, False),
    ("1", True, True, True, True), ("", False, False, True, False)])
def test_fused_attention_enabled_table(monkeypatch, flag, bf16_cpu, f32_cpu, bf16_cuda,
                                       f32_cuda):
    """XMIR_FUSED_ATTN: 0 off, 1 on, else bf16 on CUDA only (the JAX
    package's policy with "on TPU" read as "on CUDA")."""
    monkeypatch.delenv("XMIR_FUSED_ATTN", raising=False)
    if flag is not None:
        monkeypatch.setenv("XMIR_FUSED_ATTN", flag)
    got = tuple(wa.fused_attention_enabled(dt, dev) for dev in ("cpu", "cuda:0")
                for dt in (torch.bfloat16, torch.float32))
    assert got == (bf16_cpu, f32_cpu, bf16_cuda, f32_cuda)
    # the JAX gate on its CPU backend agrees wherever the flag decides
    if flag in ("0", "1"):
        assert jwa.fused_attention_enabled(jnp.float32) == f32_cpu


def test_wrappers_count_no_launch_on_the_cpu():
    q, k, v, bias, scale = (_t(a) for a in _biased_inputs(0, 4, 16, 32, 2))
    before = (va.biased_attention_fused.launches, wa.window_attention_fused.launches)
    va.biased_attention_fused(q, k, v, bias, scale, 2, True)
    wa.window_attention_fused(*(_t(a) for a in _window_inputs(0, 2, 1, 2, 16, 32, 1)))
    assert (va.biased_attention_fused.launches, wa.window_attention_fused.launches) == before


def _k6_blocked_model(q_scaled, k_norm, v, bias, key_tile=64):
    """csrc/window_attn.cu's bf16 K6 design written out in plain PyTorch: the
    rows in (window, head, image) order, two images of one bias slice a
    block (the second absent for an odd B); per image pass 1 over the 64-key
    tiles for the exact max m and z along the running max (natural exp),
    pass 2 for p = e / z (weights below 2^-126 taken as 0, as the kernel's
    v1_weight_rcp does), rounded to v's dtype, the value product summed
    in f32 over the key tiles and rounded once."""
    nw, b, h, n, _ = q_scaled.shape
    nwb = bias.shape[0]
    out = torch.empty_like(v)
    for w in range(nw):
        for head in range(h):
            slice_bias = bias[w if nwb > 1 else 0, head].float()
            for b0 in range(0, b, 2):  # a block: images b0 and b0 + 1 of the slice
                for img in range(b0, min(b0 + 2, b)):
                    qi = q_scaled[w, img, head].float()
                    ki, vi = k_norm[w, img, head].float(), v[w, img, head]
                    m = torch.full((n, 1), float("-inf"))
                    z = torch.zeros((n, 1))
                    for k0 in range(0, n, key_tile):
                        s = qi @ ki[k0:k0 + key_tile].T + slice_bias[:, k0:k0 + key_tile]
                        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                        z = z * torch.exp(m - m_new) + torch.exp(s - m_new).sum(-1, keepdim=True)
                        m = m_new
                    acc = torch.zeros((n, vi.shape[-1]))
                    for k0 in range(0, n, key_tile):
                        d = qi @ ki[k0:k0 + key_tile].T + slice_bias[:, k0:k0 + key_tile] - m
                        p = torch.exp(d) / z
                        p = torch.where(p < 2.0 ** -126, 0.0, p)
                        acc += p.to(v.dtype).float() @ vi[k0:k0 + key_tile].float()
                    out[w, img, head] = acc.to(v.dtype)
    return out


@pytest.mark.parametrize("nw,b,h,n,nwb", [(2, 3, 2, 64, 2), (3, 1, 2, 140, 1), (1, 2, 4, 77, 1),
                                          (2, 2, 1, 130, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_blocking_matches_plain_and_pallas(dtype, nw, b, h, n, nwb):
    """The bf16 kernel's two-image pass structure (``_k6_blocked_model``)
    against ``window_attention_plain`` within ``window_agreement``'s bounds
    (the same rounding points; the order of the f32 sums and z's running
    rescale differ), and against the JAX kernel in interpret mode at this
    file's bounds: an odd B, B = 1, NWB = NW and 1, ragged N."""
    q, k, v, bias = _window_inputs(n + b, nw, b, h, n, 32, nwb)
    tq, tk, tv = (_t(a, dtype) for a in (q, k, v))
    got = _k6_blocked_model(tq, tk, tv, _t(bias))
    assert va.agrees(va.window_agreement(got, wa.window_attention_plain(tq, tk, tv, _t(bias))))
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = jwa.window_attention_fused(_j(q, jd), _j(k, jd), _j(v, jd), _j(bias), interpret=True)
    if dtype == torch.float32:
        _close_f32(got.numpy(), ref)
    else:
        _close_bf16(got.float(), _t(np.asarray(ref, np.float32)))


def _rn32(x):
    """A rational rounded to the nearest float32 (ties to even)."""
    from fractions import Fraction

    c = np.float32(float(x))
    near = (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf)))
    return min(near, key=lambda y: (abs(Fraction(float(y)) - x),
                                    int(np.float32(y).view(np.uint32)) & 1))


def test_k6_reciprocal_quotient_is_ieee_division():
    """csrc/window_attn.cu::v1_weight_rcp, written out in exact rational
    arithmetic with one rounding to float32 a step: e 2^64 times the
    correctly rounded 1 / z, one FMA correction, 2^-64, quotients below
    2^-126 taken as 0. It is e / z rounded once, which is the correctly
    rounded e / z (IEEE division) wherever that is at least 2^-126, over the
    kernel's range: weights of shifts d in [-87, 0] (mostly the tail), z in
    [1, 576] and z with every kind of mantissa."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    d = -rng.uniform(0, 87, 3000)
    d[:1200] = -rng.uniform(75, 87, 1200)
    es = np.exp(d).astype(np.float32)
    zs = rng.uniform(1, 576, 3000).astype(np.float32)
    zs[:600] = (1 + rng.integers(0, 2 ** 23, 600) * 2.0 ** -23).astype(np.float32)
    up, down = Fraction(2) ** 64, Fraction(1, 2 ** 64)
    checked = 0
    for e32, z32 in zip(es, zs):
        e, z = Fraction(float(e32)), Fraction(float(z32))
        zr = Fraction(float(_rn32(1 / z)))
        es_ = e * up
        q = Fraction(float(_rn32(es_ * zr)))
        r = Fraction(float(_rn32(es_ - q * z)))
        p = Fraction(float(_rn32(r * zr + q))) * down
        p = 0 if p < Fraction(1, 2 ** 126) else p
        # the quotient rounded once to 24 bits (in the scaled range, so never
        # to a denormal), then taken as 0 below 2^-126
        want = Fraction(float(_rn32(e / z * up))) * down
        want = 0 if want < Fraction(1, 2 ** 126) else want
        assert p == want, (e32, z32)
        if want:  # a normal quotient: that rounding is IEEE division's
            assert want == Fraction(float(_rn32(e / z))), (e32, z32)
            checked += 1
    assert checked > 2000
