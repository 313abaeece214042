"""K3 (csrc/vit_attn_bwd.cu) against its plain PyTorch version on the card,
through the autograd Function around K2 / K3. Only torch and the port are
imported, so the card's machine (which has no flax) runs this file:

    python -m pytest tests/test_torch_vit_bwd_cuda.py -m cuda -q

On a machine without a card every test here skips.
"""
import pytest
import torch

from xmir_tpu_torch.ops import vit_attn as va

DTYPES = [torch.float32, torch.bfloat16]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _grads(q, k, v, g, sc):
    """(out, (dq, dk, dv)) through the Function: K2 forward, K3 backward."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = va.vit_attention_fused(*leaves, sc)
    return out.detach(), torch.autograd.grad(out, leaves, g)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,n,hd", [(24, 1370, 64), (4, 729, 72), (6, 64, 32), (2, 1, 64),
                                     (3, 137, 128), (2, 300, 16), (3, 65, 8),
                                     # more (head, 128-key) units than blocks on the card,
                                     # and a last unit whose second half of keys is dead
                                     (140, 200, 64), (133, 129, 32), (5, 640, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_matches_plain_on_card(dtype, bh, n, hd):
    _need_card()
    gen = torch.Generator().manual_seed(bh + n + hd)
    q, k, v, g = (torch.randn((bh, n, hd), generator=gen).to("cuda", dtype) for _ in range(4))
    sc = hd ** -0.5
    before = (va.vit_attention_fused.launches, va.vit_attention_bwd.launches)
    out, got = _grads(q, k, v, g, sc)
    torch.cuda.synchronize()
    assert (va.vit_attention_fused.launches, va.vit_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = va.attention_bwd_plain(q, k, v, out, g, sc)
    floors = va.grad_floors(q, k, v, g, sc)
    for a, b, floor in zip(got, want, floors):
        e = va.grad_agreement(a, b, floor)
        assert va.grad_agrees(e), e
    for a, b in zip(got, _grads(q, k, v, g, sc)[1]):
        assert torch.equal(a, b)
    if dtype == torch.float32:  # and the exact gradient, at the JAX test's bound
        for a, b, floor in zip(got, va.attention_bwd_reference(q, k, v, g, sc), floors):
            assert ((a - b).abs().max() / torch.maximum(b.abs().max(), floor)).item() <= 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_negative_and_dominant_rows_on_card(dtype):
    """Rows whose every score is very negative with one dominant key in the
    last tile, and rows of scaled-up scores with few dominant keys."""
    _need_card()
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn((4, 300, 64), generator=gen).cuda() for _ in range(4))
    hard = (-q.abs() * 3, k.abs() * 3)
    hard[1][:, 290] *= -4.0
    for qq, kk in (hard, (q * 4, k)):
        qq, kk, vv, gg = (t.to(dtype) for t in (qq, kk, v, g))
        out, got = _grads(qq, kk, vv, gg, 0.125)
        for a, b, floor in zip(got, va.attention_bwd_plain(qq, kk, vv, out, gg, 0.125),
                               va.grad_floors(qq, kk, vv, gg, 0.125)):
            assert torch.isfinite(a.float()).all()
            e = va.grad_agreement(a, b, floor)
            assert va.grad_agrees(e), e


# the f32 route's hard rows (3xTF32 dv, dk, dq; s and dp on IEEE FMAs): every
# shift below -128, one dominant key among very negative scores, N 1, and the
# MedSigLIP head width 72 at a ragged N
F32_HARD = {"scores below -128": (4, 300, 64, -8.0),
            "negative, one dominant key": (4, 300, 64, 0.0),
            "N 1": (2, 1, 64, 1.0), "hd 72": (4, 729, 72, 1.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(F32_HARD))
def test_f32_route_hard_rows_on_card(case):
    _need_card()
    bh, n, hd, gain = F32_HARD[case]
    gen = torch.Generator().manual_seed(7)
    q, k, v, g = (torch.randn((bh, n, hd), generator=gen).cuda() for _ in range(4))
    sc = hd ** -0.5 if gain == 1.0 else 0.125
    if gain < 0:
        q, k = q.abs() * gain, k.abs() * -gain
    elif gain == 0.0:
        q, k = -q.abs() * 3, k.abs() * 3
        k[:, n - 10] *= -4.0
    out, got = _grads(q, k, v, g, sc)
    for a, b in zip(got, _grads(q, k, v, g, sc)[1]):
        assert torch.equal(a, b)
    for a, b, floor in zip(got, va.attention_bwd_plain(q, k, v, out, g, sc),
                           va.grad_floors(q, k, v, g, sc)):
        assert torch.isfinite(a).all()
        e = va.grad_agreement(a, b, floor)
        assert va.grad_agrees(e), e


@pytest.mark.cuda
def test_backward_wrapper_raises_on_card():
    _need_card()
    q = torch.zeros((2, 16, 64), device="cuda")
    stats = torch.zeros((2, 16, 2), device="cuda")
    with pytest.raises(ValueError, match="stats"):
        va.vit_attention_bwd(q, q, q, q, q, None, 0.125)
    with pytest.raises(ValueError, match="stats"):
        va.vit_attention_bwd(q, q, q, q, q, stats[:, :8], 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        va.vit_attention_bwd(q, q, q, q, q.transpose(0, 1).contiguous().transpose(0, 1), stats,
                             0.125)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = q.half()
        va.vit_attention_bwd(h, h, h, h, h, stats, 0.125)
