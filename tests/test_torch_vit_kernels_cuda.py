"""The ViT kernels K2 (csrc/vit_attn.cu), K7 and K8 (csrc/ln_dense.cu) against
their plain PyTorch versions on the card. Only torch and the port are
imported, so the card's machine (which has no flax) runs this file:

    python -m pytest tests/test_torch_vit_kernels_cuda.py -m cuda -q

On a machine without a card every test here skips.
"""
import pytest
import torch

from xmir_tpu_torch.ops import ln_dense as ld
from xmir_tpu_torch.ops import vit_attn as va

DTYPES = [torch.float32, torch.bfloat16]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _r(gen, *shape, sc=1.0):
    return (torch.randn(shape, generator=gen) * sc).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,hd", [(24, 1370, 64), (3, 1, 64), (2, 7, 16), (2, 197, 32),
                                     (2, 257, 72), (2, 729, 128), (2, 1024, 64), (3, 65, 8),
                                     (2, 127, 64), (2, 128, 64), (2, 129, 64), (2, 255, 64),
                                     (2, 1370, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_matches_plain_on_card(dtype, bh, n, hd):
    _need_card()
    gen = torch.Generator().manual_seed(bh + n + hd)
    q, k, v = (_r(gen, bh, n, hd).to(dtype) for _ in range(3))
    before = va.vit_attention_fused.launches
    with torch.inference_mode():
        out = va.vit_attention_fused(q, k, v, hd ** -0.5)
        torch.cuda.synchronize()
        assert va.vit_attention_fused.launches == before + 1
        e = va.agreement(out, va.attention_plain(q, k, v, hd ** -0.5),
                         va.flip_allowance(q, k, v, hd ** -0.5))
        assert va.agrees(e), e
        assert torch.equal(out, va.vit_attention_fused(q, k, v, hd ** -0.5))
        loose = (out.float() - va.attention_reference(q, k, v, hd ** -0.5).float()).abs().max()
    assert loose <= (2e-5 if dtype == torch.float32 else 2e-2)


# A seed whose (2, 255, 64) draws, in bf16, hold a row where the largest e
# rounds to bf16 one way in K2 and the other in attention_plain (the order
# of the score sums differs): found on an H100 by scanning seeds, since few
# draws hold such a row.
N255_FLIP_SEED = 689


@pytest.mark.cuda
def test_attention_holds_a_flip_case_at_n255_on_card():
    """At BH 2, N = 255, hd 64 in bf16 on N255_FLIP_SEED the kernel reads
    past va.agreement's bound without the flip allowance (so the case holds
    a flip) and within it with each row's allowance."""
    _need_card()
    gen = torch.Generator().manual_seed(N255_FLIP_SEED)
    q, k, v = (_r(gen, 2, 255, 64).to(torch.bfloat16) for _ in range(3))
    with torch.inference_mode():
        out = va.vit_attention_fused(q, k, v, 0.125)
        ref = va.attention_plain(q, k, v, 0.125)
    without = va.agreement(out, ref)
    assert not va.agrees(without), without
    e = va.agreement(out, ref, va.flip_allowance(q, k, v, 0.125))
    assert va.agrees(e), e


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 129, 255, 1370])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_row_statistics_on_card(dtype, n):
    """K2's (m, z) per row, which K3 reads, against a float64 reckoning of
    the same shift: m = ceil(row max) of the scaled scores exactly (except
    where the max lies within f32 reach of an integer), z = the sum of
    exp2(s - m) within 1e-5; the output is the same with and without them.
    Rows of 128-row tiles and ragged key tiles (n = 127 ... 255) included."""
    _need_card()
    gen = torch.Generator().manual_seed(n)
    q, k, v = (_r(gen, 4, n, 64).to(dtype) for _ in range(3))
    sc = 0.125
    with torch.inference_mode():
        out, stats = va.launch_attention_forward(q, k, v, sc, True)
        plain_out, none = va.launch_attention_forward(q, k, v, sc, False)
    assert none is None and torch.equal(out, plain_out)
    assert stats.shape == (4, n, 2) and stats.dtype == torch.float32
    qs = (q * torch.tensor(va.scale_constant(sc, dtype), dtype=dtype, device=q.device)).double()
    s = qs @ k.double().transpose(-1, -2)
    top = s.amax(dim=-1)
    m_k, z_k = stats[..., 0].double(), stats[..., 1].double()
    clear = (top - torch.round(top)).abs() > 1e-4
    assert clear.float().mean() > 0.99
    assert torch.equal(m_k[clear], torch.ceil(top)[clear])
    assert torch.equal(m_k, torch.round(m_k))  # integer-valued everywhere
    z = torch.exp2(s - m_k[..., None]).sum(dim=-1)
    assert ((z_k - z).abs() / z).max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_negative_and_dominant_rows_on_card(dtype):
    """Rows whose every score is very negative and rows with one dominant
    score whose tile comes late: the running max jumps and the sums rescale."""
    _need_card()
    gen = torch.Generator().manual_seed(0)
    q = -_r(gen, 4, 300, 64).abs() * 3
    k = _r(gen, 4, 300, 64).abs() * 3
    v = _r(gen, 4, 300, 64)
    k[:, 290] *= -4.0
    q, k, v = (t.to(dtype) for t in (q, k, v))
    with torch.inference_mode():
        out = va.vit_attention_fused(q, k, v, 0.125)
        ref = va.attention_plain(q, k, v, 0.125)
    assert torch.isfinite(out.float()).all()
    e = va.agreement(out, ref)
    assert va.agrees(e), e


@pytest.mark.cuda
def test_attention_wrapper_raises_on_card():
    _need_card()
    q = torch.zeros((2, 16, 64), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        va.vit_attention_fused(q.transpose(0, 1).contiguous().transpose(0, 1), q, q, 0.125)
    bad = torch.zeros((2, 16, 20), device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        va.vit_attention_fused(bad, bad, bad, 0.125)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        va.vit_attention_fused(q.half(), q.half(), q.half(), 0.125)
    # an input that requires grad is taken: the backward is K3
    leaf = torch.randn((2, 16, 64), device="cuda").requires_grad_()
    before = va.vit_attention_bwd.launches
    va.vit_attention_fused(leaf, q, q, 0.125).sum().backward()
    assert va.vit_attention_bwd.launches == before + 1 and torch.isfinite(leaf.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,c,heads", [(2, 1370, 768, 12), (2, 7, 128, 4), (3, 197, 256, 2),
                                         (1, 1, 128, 1), (2, 257, 384, 12)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_kernels_match_plain_on_card(dtype, b, n, c, heads):
    _need_card()
    gen = torch.Generator().manual_seed(b + n + c)
    x = (_r(gen, b, n, c) * 2 + 0.5).to(dtype)
    lns, lnb = 1 + _r(gen, c, sc=0.2), _r(gen, c, sc=0.1)
    w, bias = _r(gen, 3 * c, c, sc=c ** -0.5).to(dtype), _r(gen, 3 * c, sc=0.1)
    w1, b1 = _r(gen, 4 * c, c, sc=c ** -0.5).to(dtype), _r(gen, 4 * c, sc=0.1)
    before = (ld.ln_qkv_fused.launches, ld.ln_dense_fused.launches)
    with torch.inference_mode():
        out = ld.ln_qkv_fused(x, lns, lnb, w, bias, heads)
        torch.cuda.synchronize()
        for o, r in zip(out, ld.ln_qkv_reference(x, lns, lnb, w, bias, heads)):
            assert o.shape == (b, heads, n, c // heads) and o.is_contiguous()
            e = ld.agreement(o, r)
            assert ld.agrees(e), e
        for o, o2 in zip(out, ld.ln_qkv_fused(x, lns, lnb, w, bias, heads)):
            assert torch.equal(o, o2)
        rows = x.reshape(b * n, c)
        for act in ("gelu", ""):
            for bb in (b1, None):
                o = ld.ln_dense_fused(rows, lns, lnb, w1, bb, 1e-6, act)
                e = ld.agreement(o, ld.ln_dense_reference(rows, lns, lnb, w1, bb, 1e-6, act))
                assert ld.agrees(e), (act, bb is None, e)
    assert (ld.ln_qkv_fused.launches, ld.ln_dense_fused.launches) == (before[0] + 2,
                                                                       before[1] + 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 90, 1370])
@pytest.mark.parametrize("c,heads", [(128, 4), (768, 12), (256, 2)])  # hd 32, 64, 128
@pytest.mark.parametrize("dtype", DTYPES)
def test_ln_qkv_matches_plain_on_card(dtype, c, heads, n):
    """K7 (bf16: the LayerNorm pre-pass and the wgmma product) against
    ln_qkv_reference at the token counts of a ragged 64-row unit (1, 7, 90 =
    64 + 26, 1370 = 21 x 64 + 26), every head width ln_qkv_eligible admits,
    with and without the bias; two runs bit-equal."""
    _need_card()
    gen = torch.Generator().manual_seed(n + c)
    x = (_r(gen, 2, n, c) * 2 + 0.5).to(dtype)
    lns, lnb = 1 + _r(gen, c, sc=0.2), _r(gen, c, sc=0.1)
    w, bias = _r(gen, 3 * c, c, sc=c ** -0.5).to(dtype), _r(gen, 3 * c, sc=0.1)
    with torch.inference_mode():
        for b in (bias, None):
            out = ld.ln_qkv_fused(x, lns, lnb, w, b, heads)
            for o, r in zip(out, ld.ln_qkv_reference(x, lns, lnb, w, b, heads)):
                assert o.shape == (2, heads, n, c // heads)
                e = ld.agreement(o, r)
                assert ld.agrees(e), (b is None, e)
            assert all(torch.equal(o, o2) for o, o2 in
                       zip(out, ld.ln_qkv_fused(x, lns, lnb, w, b, heads)))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 63, 64, 65, 2 * 1370, 16 * 1370])
@pytest.mark.parametrize("c,m", [(768, 3072), (768, 130), (768, 514), (256, 1024)])
def test_ln_dense_bf16_matches_plain_on_card(c, m, rows):
    """bf16 K8 (the LayerNorm pre-pass and the wgmma product whose warpgroups
    take its 64-row by 256-column items in turns) against ln_dense_reference:
    R at the edges of a 64-row unit and the DINOv2 batches of 2 and 16, M =
    4C and M that leave a partial last column tile (130, 514; 4-byte stores),
    GELU and bias each on and off; two runs bit-equal."""
    _need_card()
    gen = torch.Generator().manual_seed(rows + c + m)
    x = (_r(gen, rows, c) * 2 + 0.5).to(torch.bfloat16)
    lns, lnb = 1 + _r(gen, c, sc=0.2), _r(gen, c, sc=0.1)
    w, bias = _r(gen, m, c, sc=c ** -0.5).to(torch.bfloat16), _r(gen, m, sc=0.1)
    with torch.inference_mode():
        for act in ("gelu", ""):
            for b in (bias, None):
                out = ld.ln_dense_fused(x, lns, lnb, w, b, 1e-6, act)
                assert out.shape == (rows, m) and out.dtype == torch.bfloat16
                e = ld.agreement(out, ld.ln_dense_reference(x, lns, lnb, w, b, 1e-6, act))
                assert ld.agrees(e), (act, b is None, e)
                assert torch.equal(out, ld.ln_dense_fused(x, lns, lnb, w, b, 1e-6, act))


@pytest.mark.cuda
def test_ln_dense_gelu_tail_on_card():
    """bf16 K8's GELU over pre-activations from -12 to 12 (the bias, under a
    tiny product): finite, and within the bounds of the tanh form."""
    _need_card()
    gen = torch.Generator().manual_seed(12)
    rows, c, m = 500, 768, 3072
    x = (_r(gen, rows, c) * 2 + 0.5).to(torch.bfloat16)
    lns, lnb = 1 + _r(gen, c, sc=0.2), _r(gen, c, sc=0.1)
    w = _r(gen, m, c, sc=0.02 * c ** -0.5).to(torch.bfloat16)
    b = torch.linspace(-12, 12, m, device="cuda")
    with torch.inference_mode():
        out = ld.ln_dense_fused(x, lns, lnb, w, b, 1e-6, "gelu")
        assert torch.isfinite(out.float()).all()
        e = ld.agreement(out, ld.ln_dense_reference(x, lns, lnb, w, b, 1e-6, "gelu"))
    assert ld.agrees(e), e


@pytest.mark.cuda
def test_ln_wrappers_raise_on_card():
    _need_card()
    x = torch.zeros((2, 8, 64), device="cuda")
    lns, w = torch.ones(64, device="cuda"), torch.zeros((192, 64), device="cuda")
    with pytest.raises(TypeError, match="float32 or both bfloat16"):
        ld.ln_qkv_fused(x, lns, lns, w.bfloat16(), None, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ld.ln_qkv_fused(x.transpose(0, 1).contiguous().transpose(0, 1), lns, lns, w, None, 2)
    with pytest.raises(ValueError, match="eps"):
        ld.ln_qkv_fused(x, lns, lns, w, None, 2, 1e-5)
    # an input that requires grad is taken: the gradient is the plain version's
    rows = torch.randn((16, 64), device="cuda")
    w = torch.randn((192, 64), device="cuda").requires_grad_()
    ld.ln_dense_fused(rows, lns, lns, w, None).sum().backward()
    ref = w.detach().clone().requires_grad_()
    ld.ln_dense_reference(rows, lns, lns, ref, None).sum().backward()
    assert torch.allclose(w.grad, ref.grad, rtol=1e-4, atol=1e-4)
