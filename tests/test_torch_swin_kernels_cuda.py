"""The Swin attention kernels K4 and K6 (csrc/window_attn.cu) against their
plain PyTorch versions on the card, and the SwinV2 model through them. Only
torch and the port are imported, so the card's machine (which has no flax)
runs this file:

    python -m pytest tests/test_torch_swin_kernels_cuda.py -m cuda -q

On a machine without a card every test here skips.
"""
import pytest
import torch

from xmir_tpu_torch.models import swin
from xmir_tpu_torch.ops import vit_attn as va
from xmir_tpu_torch.ops import window_attn as wa

DTYPES = [torch.float32, torch.bfloat16]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _r(gen, *shape, sc=1.0):
    return (torch.randn(shape, generator=gen) * sc).cuda()


def _biased(gen, bh, n, hd, groups, dtype, masked, scale_max=100.0):
    q, k, v = (_r(gen, bh, n, hd).to(dtype) for _ in range(3))
    bias = _r(gen, groups, n, n, sc=2.0)
    if masked:
        bias = bias + torch.where(torch.rand((groups, n, n), generator=gen) < 0.5, -100.0,
                                  0.0).cuda()
    scale = (1 + torch.rand(groups, generator=gen) * (scale_max - 1)).cuda()
    return q, k, v, bias, scale


# (BH, N, hd, G, g_size, masked): Swin-B's window sizes, ragged N, groups that
# wrap, one group, other head widths
CASES = [(32, 576, 32, 4, 8, False), (32, 576, 32, 16, 2, True), (64, 144, 32, 32, 2, False),
         (12, 140, 32, 6, 2, True), (6, 16, 32, 1, 1, False), (12, 77, 16, 2, 3, True),
         (4, 200, 64, 2, 1, False), (3, 1, 8, 3, 1, False),
         # bf16 takes two images a block: groups of an odd number of images (the
         # last block of each run has one), a run cut short at the end of the
         # batch, hd 64 at the window size where only one image fits
         (15, 576, 32, 5, 3, True), (10, 100, 16, 2, 5, False), (7, 130, 32, 2, 3, True),
         (6, 320, 64, 3, 2, True), (9, 66, 64, 3, 3, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "scaled"])
@pytest.mark.parametrize("bh,n,hd,groups,g_size,masked", CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_biased_attention_matches_plain_on_card(dtype, bh, n, hd, groups, g_size, masked, cosine):
    _need_card()
    gen = torch.Generator().manual_seed(bh + n + hd)
    q, k, v, bias, scale = _biased(gen, bh, n, hd, groups, dtype, masked)
    if not cosine:
        scale = scale * 0.01
    before = va.biased_attention_fused.launches
    with torch.inference_mode():
        out = va.biased_attention_fused(q, k, v, bias, scale, g_size, cosine)
        torch.cuda.synchronize()
        assert va.biased_attention_fused.launches == before + 1
        e = va.window_agreement(out, va.biased_attention_plain(q, k, v, bias, scale, g_size,
                                                               cosine))
        assert va.agrees(e), e
        assert torch.equal(out, va.biased_attention_fused(q, k, v, bias, scale, g_size, cosine))


@pytest.mark.cuda
@pytest.mark.parametrize("nw,b,h,n,d,nwb", [(16, 2, 4, 576, 32, 16), (4, 2, 8, 576, 32, 1),
                                            (1, 3, 32, 144, 32, 1), (3, 2, 2, 140, 16, 3),
                                            (2, 1, 2, 77, 64, 1),
                                            # a block takes two images of one slice:
                                            # an odd B and B = 1 with a slice per
                                            # window, an odd B with one per head
                                            (4, 3, 8, 576, 32, 4), (16, 1, 4, 576, 32, 16),
                                            (1, 5, 16, 576, 32, 1), (2, 3, 2, 66, 64, 2)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_window_attention_matches_plain_on_card(dtype, nw, b, h, n, d, nwb):
    _need_card()
    gen = torch.Generator().manual_seed(nw + n + d)
    q, k, v = (_r(gen, nw, b, h, n, d) for _ in range(3))
    q = (q * va.inv_norm(q) * 30).to(dtype)
    k = (k * va.inv_norm(k)).to(dtype)
    v = v.to(dtype)
    bias = _r(gen, nwb, h, n, n, sc=2.0)
    if nwb > 1:
        bias = bias + torch.where(torch.rand(bias.shape, generator=gen) < 0.5, -100.0, 0.0).cuda()
    before = wa.window_attention_fused.launches
    with torch.inference_mode():
        out = wa.window_attention_fused(q, k, v, bias)
        torch.cuda.synchronize()
        assert wa.window_attention_fused.launches == before + 1
        e = va.window_agreement(out, wa.window_attention_plain(q, k, v, bias))
        assert va.agrees(e), e
        assert torch.equal(out, wa.window_attention_fused(q, k, v, bias))


@pytest.mark.cuda
def test_tiny_norm_rows_use_the_1e_24_clamp_on_card():
    """Rows of norm 1e-9 are normalised to unit length (the clamp is 1e-24 on
    the sum of squares), rows of norm 1e-14 are not."""
    _need_card()
    gen = torch.Generator().manual_seed(1)
    q, k, v, bias, scale = _biased(gen, 4, 64, 32, 2, torch.float32, False, scale_max=20.0)
    q[:, ::2] *= 1e-9 / 5.6
    k[:, 1::3] *= 1e-14 / 5.6
    with torch.inference_mode():
        out = va.biased_attention_fused(q, k, v, bias, scale, 2, True)
        e = va.window_agreement(out, va.biased_attention_plain(q, k, v, bias, scale, 2, True))
    assert torch.isfinite(out).all() and va.agrees(e), e


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernel_does_not_take():
    _need_card()
    gen = torch.Generator().manual_seed(2)
    q, k, v, bias, scale = _biased(gen, 4, 64, 32, 2, torch.float32, False)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            va.biased_attention_fused(q.transpose(0, 1).contiguous().transpose(0, 1), k, v, bias,
                                      scale, 2, True)
        with pytest.raises(TypeError, match="float32"):
            va.biased_attention_fused(q, k, v, bias.double(), scale, 2, True)
        wide = [_r(gen, 2, 16, 72) for _ in range(3)]
        with pytest.raises(ValueError, match="multiple of 8 up to 64"):
            va.biased_attention_fused(*wide, _r(gen, 1, 16, 16), scale[:1], 1, True)
        # bf16 keeps a window's K and V in shared memory; f32 streams them
        big = [_r(gen, 1, 4096, 32).to(torch.bfloat16) for _ in range(3)]
        with pytest.raises(ValueError, match="shared memory"):
            va.biased_attention_fused(*big, torch.zeros(1, 4096, 4096, device="cuda"), scale[:1])
        big32 = [t.float() for t in big]
        bias32 = _r(gen, 1, 4096, 4096, sc=2.0)
        e = va.window_agreement(va.biased_attention_fused(*big32, bias32, scale[:1], 1, True),
                                va.biased_attention_plain(*big32, bias32, scale[:1], 1, True))
        assert va.agrees(e), e  # 64 key tiles: the ring's phases and the tile walk
        # any other refusal of the launcher is not reported as a size problem
        with pytest.raises(RuntimeError, match="cudaError_t 1"):
            va.launch_window_attention(q, k, v, bias, scale.reshape(-1).contiguous(), 7,
                                       (2, 2, 1, 1, 1, 0))
    q.requires_grad_(True)
    # K4's call is differentiable (its backward is K5); a direct launch of the
    # forward kernel, which K6 also takes, stays forward only
    assert va.biased_attention_fused(q, k, v, bias, scale, 2, True).requires_grad
    with pytest.raises(RuntimeError, match="forward only"):
        va.launch_window_attention(q, k, v, bias, scale.reshape(-1).contiguous(), 1,
                                   (2, 2, 1, 1, 1, 0))


def _f32_route(gen, mode, hd, n, clamp=False):
    """(the kernel's call, its plain version's output) in f32 for one mode:
    three images a bias group (an odd count: each run's last item has one
    image), two groups, a -100 shift mask; K4's scales up to the clamp of 100
    (scaled: up to 1), K6's q normalised and scaled by up to 100. ``clamp``:
    every scale at 100 and rows with one to three live keys."""
    if mode < 2:
        q, k, v, bias, scale = _biased(gen, 6, n, hd, 2, torch.float32, True)
        if clamp:
            scale.fill_(100.0)
        if mode == 0:
            scale = scale * 0.01
    else:
        q, k, v = (_r(gen, 2, 3, 2, n, hd) for _ in range(3))
        per_head = (1 + 99 * torch.rand((1, 1, 2, 1, 1), generator=gen)).cuda()
        q = q * va.inv_norm(q) * (100.0 if clamp else per_head)
        k = k * va.inv_norm(k)
        bias = _r(gen, 2, 2, n, n, sc=2.0)
        bias = bias + torch.where(torch.rand(bias.shape, generator=gen) < 0.5, -100.0, 0.0).cuda()
    if clamp:
        bias[..., 3:] -= 100.0
        bias[..., ::5, 1:] -= 100.0
    if mode < 2:
        return (lambda: va.biased_attention_fused(q, k, v, bias, scale, 3, mode == 1),
                va.biased_attention_plain(q, k, v, bias, scale, 3, mode == 1))
    return (lambda: wa.window_attention_fused(q, k, v, bias),
            wa.window_attention_plain(q, k, v, bias))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [576, 144, 140, 77, 1])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["K4 scaled", "K4 cosine", "K6"])
def test_f32_route_matches_plain_on_card(mode, hd, n):
    """The f32 route (3xTF32 products, one pass with a running max) in each
    mode against its plain version, and two runs bit-equal."""
    _need_card()
    run, want = _f32_route(torch.Generator().manual_seed(100 * mode + hd + n), mode, hd, n)
    with torch.inference_mode():
        out, again = run(), run()
        torch.cuda.synchronize()
    e = va.window_agreement(out, want)
    assert va.agrees(e), e
    assert torch.equal(out, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [576, 144])
@pytest.mark.parametrize("mode", [0, 1, 2], ids=["K4 scaled", "K4 cosine", "K6"])
def test_f32_route_at_the_clamp_on_card(mode, n):
    """Every scale at the clamp of 100, a -100 shift mask and rows with one
    to three live keys: the logits the 3xTF32 scores must hold."""
    _need_card()
    run, want = _f32_route(torch.Generator().manual_seed(7 * mode + n), mode, 32, n, clamp=True)
    with torch.inference_mode():
        out, again = run(), run()
        torch.cuda.synchronize()
    e = va.window_agreement(out, want)
    assert torch.isfinite(out).all() and va.agrees(e), e
    assert torch.equal(out, again)


NARROW = dict(embed_dim=64, depths=(2, 2), num_heads=(2, 4), window=4, pretrained_window=(4, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["", "v1"], ids=["K4", "K6"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_narrow_swin_through_the_kernels_on_card(monkeypatch, dtype, kernel):
    """A narrow SwinV2 (head width 32, shifted and unshifted blocks) with the
    kernels against the same model on the eager path, and the launch counts."""
    _need_card()
    monkeypatch.setenv("XMIR_SWIN_KERNEL", kernel)
    model = swin.SwinV2Backbone(**NARROW)
    swin.init_weights_(model, torch.Generator().manual_seed(0))
    model = model.to("cuda", dtype).eval()
    x = _r(torch.Generator().manual_seed(1), 3, 32, 32, 3).to(dtype)
    with torch.inference_mode():
        monkeypatch.setenv("XMIR_FUSED_ATTN", "0")
        eager = model(x)["pooled"].float()
        monkeypatch.setenv("XMIR_FUSED_ATTN", "1")
        before = (va.biased_attention_fused.launches, wa.window_attention_fused.launches)
        out = model(x)["pooled"].float()
        torch.cuda.synchronize()
    got = (va.biased_attention_fused.launches - before[0],
           wa.window_attention_fused.launches - before[1])
    assert got == ((0, 4) if kernel == "v1" else (4, 0))
    assert (out - eager).abs().max().item() <= (1e-4 if dtype == torch.float32 else 0.1)
