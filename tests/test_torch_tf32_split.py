"""The 3xTF32 split of the f32 backward routes of K3 and K5
(xmir_tpu_torch/csrc/attn_bwd_f32.cuh; the split is wgmma.cuh's
``tf32_small``) emulated in torch on the CPU: the split bit for bit on
hand-made values, its per-product error, and ``attention_bwd_plain`` /
``biased_attention_bwd_plain`` with their dp, dv, dk and dq products taken
through the emulated split on the hard cases of chip_smoke.py's kernel
phases, held to the unchanged f32 bounds (and 1xTF32 held outside them).

The emulation sums exactly (float64) where the tensor cores' own sums round
coarser, so the card's reading decides (chip_smoke.py, chip_faults.py): on
the card dp moved to IEEE FMAs (PERF.md). Nothing here reaches the port's
main path.
"""
import numpy as np
import pytest
import torch

from xmir_tpu_torch.ops import vit_attn as va
from xmir_tpu_torch.ops import window_attn as wa

LOW13 = -8192  # 0xffffe000 as int32: every bit but the 13 a TF32 product does not read


def tf32_split(x):
    """(big, small) of an f32 tensor as ``tf32_small`` writes them: big = x
    with its 13 low mantissa bits cleared (what a TF32 product reads of x),
    small = x - big (exact) rounded to TF32 as cvt.rna does (half of the
    lowest kept bit added to the magnitude, the dropped bits cleared)."""
    big = (x.view(torch.int32) & LOW13).view(torch.float32)
    rest = x - big
    small = ((rest.view(torch.int32) + 0x1000) & LOW13).view(torch.float32)
    return big, small


def tf32_matmul(a, b, terms=3):
    """a @ b with both operands split: big . big, + big . small (terms >= 2),
    + small . big (terms 3), the products summed exactly, rounded to f32 once."""
    (ab, as_), (bb, bs) = tf32_split(a.contiguous()), tf32_split(b.contiguous())
    out = torch.matmul(ab.double(), bb.double())
    if terms >= 2:
        out = out + torch.matmul(ab.double(), bs.double())
    if terms >= 3:
        out = out + torch.matmul(as_.double(), bb.double())
    return out.float()


def _f32(bits):
    return torch.tensor(np.array(bits, dtype=np.uint32).view(np.float32))


@pytest.mark.parametrize("x,big,small", [
    (1.0 + 2 ** -11, 1.0, 2 ** -11),                          # small exact
    (1.0 + 2 ** -11 + 2 ** -22, 1.0, 2 ** -11 + 2 ** -21),    # a tie: away from zero
    (-(1.0 + 2 ** -11 + 2 ** -22), -1.0, -(2 ** -11 + 2 ** -21)),
    (1.0 + 2 ** -11 + 2 ** -23, 1.0, 2 ** -11),               # below the tie: down
    (3.0 - 2 ** -22, 3.0 - 2 ** -9, 2 ** -9),                # small's carry into its exponent
    (0.0, 0.0, 0.0), (-0.0, -0.0, 0.0),                       # -0: big -0, small +0
])
def test_split_bit_for_bit_on_hand_made_values(x, big, small):
    def bits(v):
        return torch.tensor([v], dtype=torch.float32).view(torch.int32).item()

    b, s = tf32_split(torch.tensor([x], dtype=torch.float32))
    assert b.view(torch.int32).item() == bits(big)
    assert s.view(torch.int32).item() == bits(small)


def test_split_of_subnormals_and_the_exponent_carry():
    # a subnormal keeps its top mantissa bits in big and its small part rounds
    # the rest: 0x00020000 (2^-130) is whole in big; 0x00000080 (2^-142) is
    # dropped by big and rounds to 0 in small; 0x00001000 (2^-137) is a tie
    # rounded away from zero to 0x00002000 (2^-136)
    x = _f32([0x00020000, 0x00000080, 0x00001000, 0x00021001])
    big, small = tf32_split(x)
    assert big.view(torch.int32).tolist() == [0x00020000, 0, 0, 0x00020000]
    assert small.view(torch.int32).tolist() == [0, 0, 0x00002000, 0x00002000]
    # small's rounding carries into its exponent: x - big = 2^-10 - 2^-23, a
    # mantissa of twelve ones, rounds up to 2^-10
    x = _f32([0x3f801fff])  # 1 + (2^13 - 1) 2^-23
    big, small = tf32_split(x)
    assert big.item() == 1.0 and small.item() == 2 ** -10


def test_split_products_within_their_bound():
    """A product's three terms miss small . small (below 2^-20 of |x y|:
    each small part is below 2^-10 of its value) and the two small parts'
    roundings (below 2^-21 each): below 2^-19 of |x y| in all, a little over
    2^-20 at worst on random operands."""
    gen = np.random.default_rng(0)
    x = torch.tensor(gen.standard_normal(200_000) * 2.0 ** gen.integers(-60, 60, 200_000),
                     dtype=torch.float32)
    y = torch.tensor(gen.standard_normal(200_000) * 2.0 ** gen.integers(-60, 60, 200_000),
                     dtype=torch.float32)
    (xb, xs), (yb, ys) = tf32_split(x), tf32_split(y)
    exact = x.double() * y.double()
    three = xb.double() * yb.double() + xb.double() * ys.double() + xs.double() * yb.double()
    assert ((three - exact).abs() / exact.abs()).max().item() <= 2 ** -19
    assert ((xs.double() * ys.double()).abs() / exact.abs()).max().item() <= 2 ** -20
    assert ((xs.double() / x.double()).abs().max().item() <= 2 ** -10 * (1 + 2 ** -11))
    one = xb.double() * yb.double()
    assert ((one - exact).abs() / exact.abs()).max().item() > 2 ** -12  # 1xTF32: 11 bits


def attention_bwd_tf32(q, k, v, o, g, sm_scale, terms=3):
    """``va.attention_bwd_plain``'s f32 arithmetic with dp, dv, dk and dq
    through ``tf32_matmul`` (the scores stay IEEE f32, as on the card)."""
    qs = q * torch.tensor(va.scale_constant(sm_scale, q.dtype), dtype=q.dtype)
    s = torch.matmul(qs, k.transpose(-1, -2))
    e = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    zinv = 1.0 / e.sum(dim=-1, keepdim=True)
    sz = sm_scale * zinv
    c = (g * o).sum(dim=-1, keepdim=True)
    dp = tf32_matmul(g, v.transpose(-1, -2), terms)
    t = e * (dp - c)
    dq = tf32_matmul(t, k, terms) * sz
    dk = tf32_matmul(t.transpose(-1, -2), q * sz, terms)
    dv = tf32_matmul(e.transpose(-1, -2), g * zinv, terms)
    return dq, dk, dv


def _k3_cases():
    """chip_smoke.py phase 17's hard f32 rows at small sizes: random, hd 72,
    N 1, scores scaled up (few dominant keys), every score very negative with
    one dominant key, every shift below -128."""
    gen = torch.Generator().manual_seed(22)

    def r(*shape):
        return torch.randn(shape, generator=gen)

    q, k, v = r(2, 80, 32), r(2, 80, 32), r(2, 80, 32)
    neg_k = k.abs() * 3
    neg_k[:, 70] *= -4.0
    return {
        "random": (r(2, 64, 16), r(2, 64, 16), r(2, 64, 16), 16 ** -0.5),
        "hd 72": (r(2, 96, 72), r(2, 96, 72), r(2, 96, 72), 72 ** -0.5),
        "N 1": (r(2, 1, 64), r(2, 1, 64), r(2, 1, 64), 0.125),
        "few dominant keys": (q * 4, k, v, 0.125),
        "negative scores, one dominant key": (-q.abs() * 3, neg_k, v, 0.125),
        "scores below -128": (-q.abs() * 8, k.abs() * 8, v, 0.125),
    }


K3_CASES = _k3_cases()


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_products_on_3xtf32_stay_within_the_f32_bounds(case):
    q, k, v, sc = K3_CASES[case]
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    o = va.attention_plain(q, k, v, sc)
    want = va.attention_bwd_plain(q, k, v, o, g, sc)
    floors = va.grad_floors(q, k, v, g, sc)
    for a, b, floor in zip(attention_bwd_tf32(q, k, v, o, g, sc, 3), want, floors):
        e = va.grad_agreement(a, b, floor)
        assert va.grad_agrees(e), (case, e)


@pytest.mark.parametrize("case", ["random", "hd 72", "few dominant keys"])
def test_k3_products_on_1xtf32_leave_the_f32_bounds(case):
    q, k, v, sc = K3_CASES[case]
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    o = va.attention_plain(q, k, v, sc)
    want = va.attention_bwd_plain(q, k, v, o, g, sc)
    floors = va.grad_floors(q, k, v, g, sc)
    readings = [va.grad_agreement(a, b, floor)
                for a, b, floor in zip(attention_bwd_tf32(q, k, v, o, g, sc, 1), want, floors)]
    assert not all(va.grad_agrees(e) for e in readings), readings


def biased_bwd_tf32(q, k, v, bias, scale, o, g, g_size, terms=3):
    """``va.biased_attention_bwd_plain``'s f32 arithmetic with the cosine,
    dp, dv, dk and dq through ``tf32_matmul`` (the scores stay IEEE f32)."""
    bh, n, _ = q.shape
    n_groups = bias.shape[0]
    gidx = va.group_index(bh, n_groups, g_size, q.device)
    sc = scale.reshape(-1).float()[gidx][:, None, None]
    qinv, kinv = va.inv_norm(q), va.inv_norm(k)
    qh, kh = q * qinv, k * kinv
    s2 = torch.matmul(qh, kh.transpose(-1, -2)) * (sc * va.LOG2E) + (bias * va.LOG2E)[gidx]
    e = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    zinv = 1.0 / e.sum(dim=-1, keepdim=True)
    c = (g * o).sum(dim=-1, keepdim=True)
    t = e * (tf32_matmul(g, v.transpose(-1, -2), terms) - c)
    tz = (t * zinv).reshape(n_groups, g_size, n, n)
    dbias = tz[:, 0]
    for r in range(1, g_size):
        dbias = dbias + tz[:, r]
    szinv = sc * zinv
    dqh = tf32_matmul(t, kh, terms) * szinv
    alpha = (dqh * qh).sum(dim=-1, keepdim=True)
    dq = (dqh - qh * alpha) * qinv
    dkh = tf32_matmul(t.transpose(-1, -2), qh * szinv, terms)
    dk = (dkh - kh * (dkh * kh).sum(dim=-1, keepdim=True)) * kinv
    dv = tf32_matmul(e.transpose(-1, -2), g * zinv, terms)
    dscale = alpha.sum(dim=(1, 2)).reshape(n_groups, -1).sum(dim=1) / scale.reshape(-1)
    return dq, dk, dv, dbias, dscale.reshape(scale.shape)


def _k5_case(shifted):
    """A Swin fold at small size (4 folded rows, 2 groups, N 64, hd 16),
    CPB-like bias (a -100 shift mask when ``shifted``), every logit scale at
    SwinV2's clamp of 100."""
    gen = torch.Generator().manual_seed(26 + shifted)
    q, k, v, g = (torch.randn((4, 64, 16), generator=gen) for _ in range(4))
    bias = 16 * torch.rand((2, 64, 64), generator=gen)
    if shifted:
        bias += torch.where(torch.rand((2, 64, 64), generator=gen) < 0.4, -100.0, 0.0)
    scale = torch.full((2,), 100.0)
    o = va.biased_attention_plain(q, k, v, bias, scale, 2, True)
    return q, k, v, bias, scale, o, g


@pytest.mark.parametrize("shifted", [False, True])
def test_k5_products_on_3xtf32_stay_within_the_f32_bounds(shifted):
    q, k, v, bias, scale, o, g = _k5_case(shifted)
    want = va.biased_attention_bwd_plain(q, k, v, bias, scale, o, g, 2, True)
    floors = va.biased_grad_floors(q, k, v, bias, scale, g, 2, True)
    got = biased_bwd_tf32(q, k, v, bias, scale, o, g, 2, 3)
    for name, e in va.biased_grad_agreement(got, want, floors, torch.float32).items():
        assert va.grad_agrees(e), (name, e)


def test_k5_products_on_1xtf32_leave_the_f32_bounds():
    q, k, v, bias, scale, o, g = _k5_case(False)
    want = va.biased_attention_bwd_plain(q, k, v, bias, scale, o, g, 2, True)
    floors = va.biased_grad_floors(q, k, v, bias, scale, g, 2, True)
    got = biased_bwd_tf32(q, k, v, bias, scale, o, g, 2, 1)
    readings = va.biased_grad_agreement(got, want, floors, torch.float32)
    assert not all(va.grad_agrees(e) for e in readings.values()), readings


# ---------------------------------------------------------------------------
# The f32 route of the window attention forwards K4 and K6
# (xmir_tpu_torch/csrc/window_attn.cu, wattn_f32_wg): both products through
# the split, held to window_agreement's unchanged f32 bound.

def window_fwd_tf32(s_inputs, v, bias, exp, score_terms=3, value_terms=3, one_pass=False,
                    normalise_first=False):
    """softmax-weighted v of the scores q k^T + bias with both products
    through ``tf32_matmul``: (q, k) = ``s_inputs`` already normalised and
    scaled, ``exp`` torch.exp2 (K4) or torch.exp (K6). Two passes: the exact
    row max, then e, z and the value product (``normalise_first``: p = e / z
    before it, as K6's plain version). One pass (the card's route): per
    64-key tile a running max m that rescales the accumulator and z by
    exp(m_old - m_new), out = acc / z at the end."""
    q, k = s_inputs
    s = tf32_matmul(q, k.transpose(-1, -2), score_terms) + bias
    if not one_pass:
        e = exp(s - s.amax(dim=-1, keepdim=True))
        z = e.sum(dim=-1, keepdim=True)
        if normalise_first:
            return tf32_matmul(e / z, v, value_terms)
        return tf32_matmul(e, v, value_terms) / z
    m = torch.full(s.shape[:-1] + (1,), float("-inf"))
    z = torch.zeros(s.shape[:-1] + (1,))
    acc = torch.zeros(s.shape[:-1] + (v.shape[-1],))
    for k0 in range(0, s.shape[-1], 64):
        tile = s[..., k0:k0 + 64]
        m_new = torch.maximum(m, tile.amax(dim=-1, keepdim=True))
        alpha = exp(m - m_new)
        e = exp(tile - m_new)
        z = z * alpha + e.sum(dim=-1, keepdim=True)
        acc = acc * alpha + tf32_matmul(e, v[..., k0:k0 + 64, :], value_terms)
        m = m_new
    return acc / z


def _window_clamp_case(kernel, n):
    """chip_smoke.py phase 13's clamp case at small size: 3 images a group,
    2 groups, hd 32, every scale at SwinV2's clamp of 100 (K4 without the
    cosine: 1), a CPB-like bias with a -100 shift mask, and rows with one to
    three live keys. Returns (want, the score inputs, v, the bias as added,
    exp, normalise_first): ``want`` the plain version's output."""
    gen = torch.Generator().manual_seed(23 + n)
    q, k, v = (torch.randn((6, n, 32), generator=gen) for _ in range(3))
    bias = 16 * torch.rand((2, n, n), generator=gen)
    bias += torch.where(torch.rand((2, n, n), generator=gen) < 0.4, -100.0, 0.0)
    bias[:, :, 3:] -= 100.0
    bias[:, ::5, 1:] -= 100.0
    gidx = va.group_index(6, 2, 3, q.device)
    if kernel == "K6":  # its operands as the model passes them: q normalised and scaled
        qs, kn = q * va.inv_norm(q) * 100.0, k * va.inv_norm(k)
        want = wa.window_attention_plain(qs[:, None, None], kn[:, None, None], v[:, None, None],
                                         bias[gidx][:, None])[:, 0, 0]
        return want, (qs, kn), v, bias[gidx], torch.exp, True
    cosine = kernel == "K4 cosine"
    scale = torch.full((2,), 100.0 if cosine else 1.0)
    want = va.biased_attention_plain(q, k, v, bias, scale, 3, cosine)
    c = (scale * va.LOG2E)[gidx][:, None, None]
    qs, ks = ((q * va.inv_norm(q)) * c, k * va.inv_norm(k)) if cosine else (q * c, k)
    return want, (qs, ks), v, (bias * va.LOG2E)[gidx], torch.exp2, False


WINDOW_KERNELS = ["K4 cosine", "K4 scaled", "K6"]


@pytest.mark.parametrize("one_pass", [False, True], ids=["two passes", "one pass"])
@pytest.mark.parametrize("n", [144, 576])
@pytest.mark.parametrize("kernel", WINDOW_KERNELS)
def test_window_products_on_3xtf32_stay_within_the_f32_bound(kernel, n, one_pass):
    want, s_inputs, v, bias, exp, first = _window_clamp_case(kernel, n)
    got = window_fwd_tf32(s_inputs, v, bias, exp, 3, 3, one_pass, first and not one_pass)
    e = va.window_agreement(got, want)
    assert va.agrees(e), e


@pytest.mark.parametrize("terms", [(2, 2), (1, 1), (3, 1)],
                         ids=["2xTF32", "1xTF32", "the value product alone on 1xTF32"])
@pytest.mark.parametrize("kernel", WINDOW_KERNELS)
def test_window_products_on_fewer_terms_leave_the_f32_bound(kernel, terms):
    want, s_inputs, v, bias, exp, _ = _window_clamp_case(kernel, 144)
    e = va.window_agreement(window_fwd_tf32(s_inputs, v, bias, exp, *terms, True), want)
    assert not va.agrees(e), e


def truncating_split_product(a, b, acc=None):
    """a @ b as the card's 3xTF32 wgmma forms it: per depth step of 8, the
    exact sum of the step's products and the accumulator rounded toward
    zero to f32 (the tensor cores truncate), big . small steps, then small .
    big, then big . big, into one accumulator (``acc`` to start from)."""
    (ab, as_), (bb, bs) = tf32_split(a.contiguous()), tf32_split(b.contiguous())
    out = torch.zeros(a.shape[0], b.shape[1]) if acc is None else acc.clone()
    for x, y in ((ab, bs), (as_, bb), (ab, bb)):
        for k0 in range(0, a.shape[1], 8):
            exact = out.double() + x[:, k0:k0 + 8].double() @ y[k0:k0 + 8].double()
            near = exact.float()
            out = torch.where(near.double().abs() > exact.abs(),
                              torch.nextafter(near, torch.zeros_like(near)), near)
    return out


def test_window_value_product_summed_per_tile_in_f32():
    """Why the f32 route gives each 64-key tile's e v an accumulator of its
    own and adds it to the rescaled sum in f32: with the tensor cores'
    truncating sums, one accumulator over a window's 72 depth steps drifts
    (it moved the f32 SwinV2 embeddings past their bound on the card,
    PERF.md), the per-tile form stays within a fraction of its error."""
    gen = torch.Generator().manual_seed(9)
    n = 576
    e = torch.exp2(-8 * torch.rand((64, n), generator=gen))
    v = torch.randn((n, 32), generator=gen)
    exact = e.double() @ v.double()
    one = per_tile = None
    for k0 in range(0, n, 64):
        one = truncating_split_product(e[:, k0:k0 + 64], v[k0:k0 + 64], one)
        tile = truncating_split_product(e[:, k0:k0 + 64], v[k0:k0 + 64])
        per_tile = tile if per_tile is None else per_tile + tile
    for stat in (torch.mean, torch.amax):  # the mean error and the check's max-abs one
        err_one = stat((one.double() - exact).abs()).item()
        err_tile = stat((per_tile.double() - exact).abs()).item()
        assert err_tile * 4 < err_one, (stat.__name__, err_tile, err_one)
