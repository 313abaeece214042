"""The plain PyTorch versions of K2 (fused attention), K7 (LN -> qkv) and K8
(LN -> dense) against the JAX package's Pallas kernels (interpret mode) and
references, on the same numpy inputs. Tier 1: CPU only, no card.

Tolerances. f32: 2e-5 absolute (the two stacks sum in other orders; the JAX
tests hold their kernels to their references at the same 2e-5). bf16: the
plain versions round where the TPU kernels round, so against the kernels in
interpret mode K7 / K8 are held to ops/convnext_block.py::agreement (2 bf16
steps + 2^-7 per output, 0.05 steps on average). K2's plain version shifts
each row by ceil(row max) where the TPU kernel shifts by the row max, so e
rounds to bf16 relative to another shift: each e moves by up to 2^-9 of
itself, and an output, a sum of N such terms of either sign, by a like share
of its own size, which is about one bf16 step. So in bf16 K2's plain version
is held to the TPU kernel (in interpret mode, and its arithmetic written out
with exact-product f32 sums) within 8 bf16 steps + 2^-9 per output and 1.5
steps on average, and its distance from the exact (f64) softmax to 1.1 times
the written-out kernel's: both lie ~3 steps from it, for the rounding of
q scale log2(e) to bf16 that they share.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xmir_tpu.ops import ln_dense_pallas as jln
from xmir_tpu.ops import plain_attn as jpa
from xmir_tpu.ops import vit_attn_pallas as jva
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.ops import ln_dense as ld
from xmir_tpu_torch.ops import plain_attn as pa
from xmir_tpu_torch.ops import vit_attn as va

F32_ATOL = 2e-5
K2_BF16_OF_BOUND, K2_BF16_MEAN_STEPS = 4, 1.5  # of va.agreement's 2 steps + 2^-11
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _pair(arr, kind):
    """A numpy array as a (torch, jax) pair in the dtype ``kind`` names."""
    tdt, jdt = DTYPES[kind]
    return torch.from_numpy(arr).to(tdt), jnp.asarray(arr).astype(jdt)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))  # a writable copy


def _as_torch(x, kind):
    return torch.from_numpy(_np(x)).to(DTYPES[kind][0])


# -- K2 -----------------------------------------------------------------------

ATTN_SHAPES = [(3, 256, 64), (2, 300, 64), (2, 343, 32), (1, 728, 16), (1, 729, 16),
               (2, 257, 72)]


def _qkv(shape, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    return q + shift, k, v


@pytest.mark.parametrize("shape", ATTN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_attention_plain_versions_match_jax_f32(shape):
    q, k, v = _qkv(shape, seed=sum(shape))
    scale = shape[2] ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    kernel = _np(jva.vit_attention_fused(jq, jk, jv, scale, True))
    ref = _np(jva._attention_reference(jq, jk, jv, scale))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for fn in (va.attention_plain, va.attention_reference, va.vit_attention_fused):
        out = fn(tq, tk, tv, scale).numpy()
        np.testing.assert_allclose(out, kernel, atol=F32_ATOL, rtol=0, err_msg=fn.__name__)
        np.testing.assert_allclose(out, ref, atol=F32_ATOL, rtol=0, err_msg=fn.__name__)


def _tpu_kernel_arithmetic(q, k, v, scale):
    """``_kernel`` (vit_attn_pallas.py:123-159) on bf16 q, k, v, its two dots
    as exact-product f32 sums (the operands widened to f32 first)."""
    qs = q * jnp.asarray(scale * jva.LOG2E, q.dtype)
    s = jnp.einsum("bqd,bkd->bqk", qs.astype(jnp.float32), k.astype(jnp.float32),
                   precision="highest")
    e = jnp.exp2(s - jnp.max(s, axis=-1, keepdims=True))
    z = jnp.sum(e, axis=-1, keepdims=True)
    o = jnp.einsum("bqk,bkd->bqd", e.astype(v.dtype).astype(jnp.float32),
                   v.astype(jnp.float32), precision="highest")
    return (o / z).astype(v.dtype)


@pytest.mark.parametrize("shape", [(2, 300, 64), (2, 343, 32), (2, 257, 72)],
                         ids=lambda s: "x".join(map(str, s)))
def test_attention_plain_matches_jax_kernel_bf16(shape):
    q, k, v = _qkv(shape, seed=sum(shape) + 1)
    scale = shape[2] ** -0.5
    (tq, jq), (tk, jk), (tv, jv) = (_pair(a, "bf16") for a in (q, k, v))
    out = va.attention_plain(tq, tk, tv, scale)
    assert out.dtype == torch.bfloat16
    written_out = _as_torch(_tpu_kernel_arithmetic(jq, jk, jv, scale), "bf16")
    kernel = _as_torch(jva.vit_attention_fused(jq, jk, jv, scale, True), "bf16")
    for ref in (written_out, kernel):
        e = va.agreement(out, ref)
        assert e["of_bound"] <= K2_BF16_OF_BOUND and e["mean_steps"] <= K2_BF16_MEAN_STEPS, e
    exact = torch.softmax(tq.double() @ tk.double().transpose(-1, -2) * scale, -1) @ tv.double()
    exact = exact.float()
    off = [((o.float() - exact).abs() / cb.bf16_step(exact)).mean().item()
           for o in (out, written_out)]
    assert off[0] <= 1.1 * off[1], off


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_attention_all_negative_and_dominant_logits(kind):
    """Rows whose every score is very negative (q and k of opposite sign: the
    TPU kernel's zero padding would dominate the max there) and rows with one
    dominant score."""
    rng = np.random.default_rng(5)
    q = -np.abs(rng.standard_normal((2, 300, 32))).astype(np.float32) * 3
    k = np.abs(rng.standard_normal((2, 300, 32))).astype(np.float32) * 3
    v = rng.standard_normal((2, 300, 32)).astype(np.float32)
    k[:, 17] *= -4.0  # one key far above the rest for every query
    scale = 32 ** -0.5
    (tq, jq), (tk, jk), (tv, jv) = (_pair(a, kind) for a in (q, k, v))
    kernel = _as_torch(jva.vit_attention_fused(jq, jk, jv, scale, True), kind)
    out = va.attention_plain(tq, tk, tv, scale)
    assert torch.isfinite(out.float()).all()
    if kind == "f32":
        np.testing.assert_allclose(out.numpy(), kernel.numpy(), atol=F32_ATOL, rtol=0)
    else:
        e = va.agreement(out, kernel)
        assert e["of_bound"] <= K2_BF16_OF_BOUND and e["mean_steps"] <= K2_BF16_MEAN_STEPS, e


def test_attention_plain_rounding_points():
    """The constant is rounded to q's dtype, z sums the unrounded e, and the
    shift is an integer: each checked against the formula written out."""
    assert va.scale_constant(0.125, torch.float32) == float(np.float32(0.125 * va.LOG2E))
    c = va.scale_constant(0.125, torch.bfloat16)
    assert c == torch.tensor(0.125 * va.LOG2E).bfloat16().item() != 0.125 * va.LOG2E
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((1, 40, 16), seed=9))
    qs = (q * torch.tensor(c, dtype=torch.bfloat16)).float()
    s = qs @ k.float().transpose(-1, -2)
    m = torch.ceil(s.amax(-1, keepdim=True))
    e = torch.exp2(s - m)
    want = ((e.bfloat16().float() @ v.float()) / e.sum(-1, keepdim=True)).bfloat16()
    assert torch.equal(va.attention_plain(q, k, v, 0.125), want)
    assert torch.equal(m, m.round()) and (e.amax(-1) > 0.5).all() and (e <= 1).all()


def test_attention_wrapper_on_cpu_checks_and_does_not_count():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 9, 16), seed=1))
    before = va.vit_attention_fused.launches
    out = va.vit_attention_fused(q, k, v, 0.25)
    assert va.vit_attention_fused.launches == before
    assert torch.equal(out, va.attention_plain(q, k, v, 0.25))
    out4 = pa.flash_attention_plain(q[None], k[None], v[None], 0.25)
    assert out4.shape == (1, 2, 9, 16) and torch.equal(out4[0], out)
    with pytest.raises(ValueError, match="shape"):
        va.vit_attention_fused(q, k[:, :8], v, 0.25)
    with pytest.raises(TypeError, match="dtype"):
        va.vit_attention_fused(q, k.bfloat16(), v, 0.25)
    with pytest.raises(ValueError, match="device"):
        va.vit_attention_fused(*(t.to("meta") for t in (q, k, v)), 0.25)


def test_flip_allowance_is_the_rows_dominant_term():
    """flip_allowance: one bf16 step of e_max (2^-8 below 1, 2^-7 at 1)
    times |v_dom| / z for every output, v_dom the value row of the row's
    largest score, e and z as attention_plain forms them, against a float64
    reckoning of the same quantities."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((3, 40, 16), seed=5))
    q = q * 4  # some rows with one dominant score
    got = va.flip_allowance(q, k, v, 0.25)
    qs = (q * torch.tensor(va.scale_constant(0.25, q.dtype), dtype=q.dtype)).double()
    s = qs @ k.double().transpose(-1, -2)
    e = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    dom = e.argmax(dim=-1)
    v_dom = torch.stack([v[i].double()[dom[i]] for i in range(3)])
    e_max = e.amax(dim=-1, keepdim=True)
    step = torch.where(e_max < 1, 2.0 ** -8, 2.0 ** -7).double()
    want = step * v_dom.abs() / e.sum(dim=-1, keepdim=True)
    assert got.shape == v.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5, atol=0)
    assert got.max() > va.BF16_ATOL  # the allowance governs somewhere on these rows


@pytest.mark.parametrize("factor,agrees", [(0.9, True), (1.1, False)])
def test_k2_agreement_takes_the_larger_absolute_term(factor, agrees):
    """In bf16 each output's bound is 2 bf16 steps plus the larger of
    BF16_ATOL and its flip allowance: an error of 0.9 of that bound agrees,
    1.1 of it does not; without the allowance the absolute term is
    BF16_ATOL."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv((2, 30, 16), seed=6))
    q = q * 4
    ref = va.attention_plain(q, k, v, 0.25)
    allowance = va.flip_allowance(q, k, v, 0.25)
    bound = cb.BF16_STEPS * cb.bf16_step(ref.float()) + torch.clamp(allowance, min=va.BF16_ATOL)
    i = torch.argmax(allowance)  # one output, where the allowance is largest
    out = ref.float().flatten().clone()
    out[i] += factor * bound.flatten()[i]
    e = va.agreement(out.reshape(ref.shape), ref, allowance)
    assert (e["of_bound"] <= 1) == agrees, e
    plain_bound = (cb.BF16_STEPS * cb.bf16_step(ref.float()) + va.BF16_ATOL).flatten()[i]
    assert va.agreement(out.reshape(ref.shape), ref)["of_bound"] == pytest.approx(
        factor * bound.flatten()[i].item() / plain_bound.item(), rel=1e-3)


# -- K7 / K8 --------------------------------------------------------------------

def _ln_inputs(rows_shape, c, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*rows_shape, c)).astype(np.float32) * 2 + 0.5
    lns = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    lnb = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w = (rng.standard_normal((c, m)) * c ** -0.5).astype(np.float32)  # flax (in, out)
    b = (0.1 * rng.standard_normal(m)).astype(np.float32)
    return x, lns, lnb, w, b


def _held(out, ref, kind, what):
    if kind == "f32":
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_ATOL, rtol=0, err_msg=what)
    else:
        e = cb.agreement(out, ref)
        assert cb.agrees(e), (what, e)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("b,n,c,heads,bias", [(2, 33, 128, 2, True), (1, 70, 128, 4, False),
                                              (2, 40, 256, 2, True)])
def test_ln_qkv_plain_matches_jax(kind, b, n, c, heads, bias):
    x, lns, lnb, w, bv = _ln_inputs((b, n), c, 3 * c, seed=b + n + c)
    (tx, jx), (tw, jw) = _pair(x, kind), _pair(w, kind)
    jb = jnp.asarray(bv) if bias else None
    tb = torch.from_numpy(bv) if bias else None
    kernel = jln.ln_qkv_fused(jx, jnp.asarray(lns), jnp.asarray(lnb), jw, jb, heads, 1e-6, 32,
                              True)
    ref = jln._ln_qkv_reference(jx, jnp.asarray(lns), jnp.asarray(lnb), jw, jb, heads, 1e-6)
    args = (tx, torch.from_numpy(lns), torch.from_numpy(lnb), tw.t().contiguous(), tb, heads)
    for fn in (ld.ln_qkv_reference, ld.ln_qkv_fused):
        out = fn(*args)
        for o, kk, rr, name in zip(out, kernel, ref, "qkv"):
            assert o.shape == (b, heads, n, c // heads) and o.dtype == DTYPES[kind][0]
            _held(o, _as_torch(kk, kind), kind, f"{fn.__name__} {name} vs the kernel")
            _held(o, _as_torch(rr, kind), kind, f"{fn.__name__} {name} vs the reference")


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("act", ["", "gelu"])
@pytest.mark.parametrize("rows,c,m,bias", [(70, 128, 256, True), (33, 256, 384, False),
                                         (1, 128, 512, True), (65, 128, 130, True),
                                         (129, 256, 130, False)])
def test_ln_dense_plain_matches_jax(kind, act, rows, c, m, bias):
    x, lns, lnb, w, bv = _ln_inputs((rows,), c, m, seed=rows + c + m)
    (tx, jx), (tw, jw) = _pair(x, kind), _pair(w, kind)
    jb = jnp.asarray(bv) if bias else None
    tb = torch.from_numpy(bv) if bias else None
    kernel = jln.ln_dense_fused(jx, jnp.asarray(lns), jnp.asarray(lnb), jw, jb, 1e-6, act, 32,
                                True)
    ref = jln._ln_dense_reference(jx, jnp.asarray(lns), jnp.asarray(lnb), jw, jb, 1e-6, act)
    args = (tx, torch.from_numpy(lns), torch.from_numpy(lnb), tw.t().contiguous(), tb, 1e-6, act)
    for fn in (ld.ln_dense_reference, ld.ln_dense_fused):
        out = fn(*args)
        assert out.shape == (rows, m) and out.dtype == DTYPES[kind][0]
        _held(out, _as_torch(kernel, kind), kind, f"{fn.__name__} vs the kernel")
        _held(out, _as_torch(ref, kind), kind, f"{fn.__name__} vs the reference")


def test_ln_qkv_packing_is_q_k_v_with_heads_inside():
    """With LN the identity on a one-hot-like input and a weight whose row j
    is j's own value, each output lane carries its row index of the packed
    weight: a swap of q/k/v or of heads shows."""
    c, heads = 16, 4
    hd = c // heads
    w = torch.zeros(3 * c, c)
    b = torch.arange(3 * c, dtype=torch.float32)  # the bias alone labels the columns
    x = torch.randn(1, 3, c, generator=torch.Generator().manual_seed(0))
    q, k, v = ld.ln_qkv_fused(x, torch.ones(c), torch.zeros(c), w, b, heads)
    for part, t in enumerate((q, k, v)):
        want = (part * c + torch.arange(c, dtype=torch.float32)).reshape(heads, 1, hd)
        assert torch.equal(t[0], want.expand(heads, 3, hd))


def test_ln_wrappers_on_cpu_check_and_do_not_count():
    x, lns, lnb, w, b = (torch.from_numpy(a) for a in _ln_inputs((2, 5), 16, 48, seed=0))
    wt = w.t().contiguous()
    before = (ld.ln_qkv_fused.launches, ld.ln_dense_fused.launches)
    ld.ln_qkv_fused(x, lns, lnb, wt, b, 2)
    ld.ln_dense_fused(x.reshape(10, 16), lns, lnb, wt, b)
    assert (ld.ln_qkv_fused.launches, ld.ln_dense_fused.launches) == before
    with pytest.raises(ValueError, match="w must be"):
        ld.ln_qkv_fused(x, lns, lnb, w, b, 2)  # flax layout (in, out)
    with pytest.raises(ValueError, match="heads"):
        ld.ln_qkv_fused(x, lns, lnb, wt, b, 3)
    with pytest.raises(ValueError, match="b must be"):
        ld.ln_dense_fused(x.reshape(10, 16), lns, lnb, wt, b[:5])
    with pytest.raises(ValueError, match="act"):
        ld.ln_dense_fused(x.reshape(10, 16), lns, lnb, wt, b, 1e-6, "relu")
    with pytest.raises(ValueError, match="device"):
        ld.ln_dense_fused(*(t.to("meta") for t in (x.reshape(10, 16), lns, lnb, wt, b)))


# -- the gates ------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("flag", [None, "0", "1"])
def test_gates_decide_as_the_jax_gates(monkeypatch, kind, flag):
    """On the CPU (JAX's backend here, the port's device argument) both
    stacks decide alike for every dtype and switch; on CUDA the port decides
    as the JAX package does on the TPU: bf16 takes the kernels."""
    tdt, jdt = DTYPES[kind]
    for name in ("XMIR_FUSED_LN", "XMIR_FLASH_ATTN"):
        monkeypatch.delenv(name, raising=False)
        if flag is not None:
            monkeypatch.setenv(name, flag)
    assert ld.fused_ln_enabled(tdt, "cpu") == jln.fused_ln_enabled(jdt)
    assert pa.plain_flash_enabled(tdt, 1370, "cpu") == jpa.plain_flash_enabled(jdt, 1370)
    on_card = flag == "1" or (flag is None and kind == "bf16")
    assert ld.fused_ln_enabled(tdt, "cuda") == on_card
    assert pa.plain_flash_enabled(tdt, 1370, torch.device("cuda", 0)) == on_card


@pytest.mark.parametrize("c,hd", [(768, 64), (128, 64), (1024, 32), (1024, 128), (100, 50),
                                  (96, 32), (768, 48), (1152, 72)])
def test_ln_qkv_eligible_matches_jax(monkeypatch, c, hd):
    monkeypatch.delenv("XMIR_FUSED_LN_QKV72", raising=False)
    assert ld.ln_qkv_eligible(c, hd) == jln.ln_qkv_eligible(c, hd)
