"""K5 (csrc/window_attn_bwd.cu) against its plain PyTorch version on the card,
directly and through the autograd Function around K4 / K5. Only torch and the
port are imported, so the card's machine (which has no flax) runs this file:

    python -m pytest tests/test_torch_swin_bwd_cuda.py -m cuda -q

On a machine without a card every test here skips.
"""
import pytest
import torch

from xmir_tpu_torch.ops import vit_attn as va

DTYPES = [torch.float32, torch.bfloat16]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _inputs(bh, G, n, hd, dtype, shifted, seed, smax=100.0):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, g = (torch.randn((bh, n, hd), generator=gen).to("cuda", dtype) for _ in range(4))
    bias = 16 * torch.rand((G, n, n), generator=gen)
    if shifted:
        bias += torch.where(torch.rand((G, n, n), generator=gen) < 0.4, -100.0, 0.0)
    scale = 1 + (smax - 1) * torch.rand(G, generator=gen)
    return q, k, v, bias.cuda(), scale.cuda(), g


# Swin-B's six folds at B = 8 (BH, G, g_size, N, hd, shifted): stage 1
# unshifted (g_size 128) and shifted, stage 2 unshifted and shifted, stage 3,
# stage 4 (N = 144)
SWIN_B8 = [(512, 4, 128, 576, 32, False), (512, 64, 8, 576, 32, True),
           (256, 8, 32, 576, 32, False), (256, 32, 8, 576, 32, True),
           (128, 16, 8, 576, 32, False), (256, 32, 8, 144, 32, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("bh,G,gs,n,hd,shifted", [
    (128, 4, 32, 576, 32, False), (128, 64, 2, 576, 32, True), (64, 32, 2, 144, 32, False),
    (16, 1, 16, 576, 32, False), (8, 2, 4, 64, 8, True), (12, 3, 4, 96, 64, False),
    # groups of three rows: the prep's blocks take two, so a group's rows are
    # split across blocks, one of them alone; a ragged 72-token window
    (12, 4, 3, 72, 16, True)] + SWIN_B8)
@pytest.mark.parametrize("cosine", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_card(dtype, cosine, bh, G, gs, n, hd, shifted):
    _need_card()
    q, k, v, bias, scale, g = _inputs(bh, G, n, hd, dtype, shifted, seed=bh + n + hd,
                                      smax=100.0 if cosine else 2.0)
    o = va.biased_attention_plain(q, k, v, bias, scale, gs, cosine)
    before = va.biased_attention_bwd.launches
    got = va.biased_attention_bwd(q, k, v, bias, scale, o, g, gs, cosine)
    again = va.biased_attention_bwd(q, k, v, bias, scale, o, g, gs, cosine)
    torch.cuda.synchronize()
    assert va.biased_attention_bwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = va.biased_attention_bwd_plain(q, k, v, bias, scale, o, g, gs, cosine)
    floors = va.biased_grad_floors(q, k, v, bias, scale, g, gs, cosine)
    for name, e in va.biased_grad_agreement(got, want, floors, dtype).items():
        assert va.grad_agrees(e), (name, e)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_function_grads_on_card_match_the_plain_path(dtype):
    """The Function's five gradients on the card (K4 forward, K5 backward)
    against the same Function on the CPU (the plain versions), and, in f32,
    within 5e-5 (dscale 5e-4) of the exact gradient's largest magnitude."""
    _need_card()
    q, k, v, bias, scale, g = _inputs(32, 8, 144, 32, dtype, True, seed=3, smax=30.0)

    def grads(device):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (q, k, v, bias, scale)]
        out = va.biased_attention_fused(*leaves, 4, True)
        return out.detach(), torch.autograd.grad(out, leaves, g.to(device))

    before = (va.biased_attention_fused.launches, va.biased_attention_bwd.launches)
    out, got = grads("cuda")
    torch.cuda.synchronize()
    assert (va.biased_attention_fused.launches, va.biased_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    _, cpu = grads("cpu")
    floors = va.biased_grad_floors(q, k, v, bias, scale, g, 4, True)
    readings = va.biased_grad_agreement(got, [t.to("cuda") for t in cpu], floors, dtype)
    for name, e in readings.items():
        assert va.grad_agrees(e), (name, e)
    if dtype == torch.float32:
        exact = va.biased_attention_bwd_reference(q, k, v, bias, scale, out, g, 4, True)
        for name, a, b, floor in zip(va.BIASED_GRAD_NAMES, got, exact, floors):
            tol = 5e-4 if name == "dscale" else 5e-5
            assert ((a - b).abs().max() / torch.maximum(b.abs().max(), floor)).item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("bh,G,gs,n,shifted", [(32, 16, 2, 576, False), (64, 32, 2, 144, False),
                                               (128, 64, 2, 576, True)])
def test_f32_route_at_the_scale_clamp_on_card(bh, G, gs, n, shifted):
    """K5's f32 route (3xTF32 dv, dk, dq; s and dp on IEEE FMAs) with every
    logit scale at SwinV2's clamp of 100: logits of +-144 in exp2 units."""
    _need_card()
    q, k, v, bias, scale, g = _inputs(bh, G, n, 32, torch.float32, shifted, seed=bh + n)
    scale.fill_(100.0)
    o = va.biased_attention_plain(q, k, v, bias, scale, gs, True)
    got = va.biased_attention_bwd(q, k, v, bias, scale, o, g, gs, True)
    again = va.biased_attention_bwd(q, k, v, bias, scale, o, g, gs, True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = va.biased_attention_bwd_plain(q, k, v, bias, scale, o, g, gs, True)
    floors = va.biased_grad_floors(q, k, v, bias, scale, g, gs, True)
    for name, e in va.biased_grad_agreement(got, want, floors, torch.float32).items():
        assert va.grad_agrees(e), (name, e)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    _need_card()
    q, k, v, bias, scale, g = _inputs(16, 2, 140, 32, torch.bfloat16, False, seed=4)
    with pytest.raises(ValueError, match="whole windows"):
        va.biased_attention_bwd(q, k, v, bias, scale, q, g, 8, True)
    q, k, v, bias, scale, g = _inputs(16, 2, 64, 32, torch.bfloat16, False, seed=5)
    with pytest.raises(ValueError, match="whole windows"):
        va.biased_attention_bwd(q, k, v, bias, scale, q, g, 4, True)
    with pytest.raises(ValueError, match="contiguous"):
        va.biased_attention_bwd(q, k, v, bias, scale, q, g.transpose(1, 2).contiguous()
                                .transpose(1, 2), 8, True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,n,hd,groups", [(512, 576, 32, 4), (256, 144, 32, 32),
                                            (12, 72, 16, 4), (6, 64, 64, 3),
                                            # f32: 32-row query tiles, N padded to 64
                                            (16, 136, 40, 2)])
def test_workspace_size_is_the_kernels(dtype, bh, n, hd, groups):
    """``biased_bwd_workspace_bytes`` (which the wrapper allocates) equals the
    scratch the CUDA source lays out (``xmir_window_attn_bwd_workspace``)."""
    import ctypes

    from xmir_tpu_torch.ops import _build

    _need_card()
    got = ctypes.c_longlong(0)
    assert _build.load().xmir_window_attn_bwd_workspace(
        va.DTYPE_CODES[dtype], bh, n, hd, groups, ctypes.byref(got)) == 0
    assert got.value == va.biased_bwd_workspace_bytes(dtype, bh, n, hd, groups)
