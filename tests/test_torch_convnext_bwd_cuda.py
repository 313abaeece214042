"""K10 (csrc/convnext_block_bwd.cu) against its plain PyTorch version on the
card, and the autograd Function around K9 / K10 (the fused ConvNeXtV2 block).
Only torch and the port are imported, so the card's machine (which has no
flax) runs this file:

    python -m pytest tests/test_torch_convnext_bwd_cuda.py -m cuda -q

On a machine without a card every test here skips.
"""
import pytest
import torch

from xmir_tpu_torch.models.convnext import ConvNeXtV2Block, init_weights_
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.ops import vit_attn as va

DTYPES = [torch.float32, torch.bfloat16]
NAMES = ("dw_weight", "dw_bias", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2", "gamma", "beta")
TAIL_KEYS = ("ln_scale", "ln_bias", "w1", "b1", "w2", "gamma", "beta")
# the Function's gradients against autograd through the plain forward in
# f32, of each gradient's largest magnitude (chip_smoke.py's BLOCK_GRAD_RTOL)
BLOCK_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _inputs(b, hw, c, dtype, seed):
    """A block input (b, hw, hw, c) and random parameters on the card, LN,
    GRN and biases nonzero."""
    gen = torch.Generator().manual_seed(seed)
    c4 = 4 * c

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen) * sc).cuda()

    a = dict(dw_weight=r(c, 1, 7, 7, sc=0.1), dw_bias=r(c, sc=0.1), ln_scale=1 + r(c, sc=0.2),
             ln_bias=r(c, sc=0.1), w1=r(c4, c, sc=c ** -0.5).to(dtype), b1=r(c4, sc=0.1),
             w2=r(c, c4, sc=c4 ** -0.5).to(dtype), b2=r(c, sc=0.1), gamma=r(c4, sc=0.5),
             beta=r(c4, sc=0.1))
    return r(b, hw, hw, c).to(dtype), a


def _plain_block(x, dw_weight, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta):
    b, hh, ww, c = x.shape
    h = cb.dwconv(x, dw_weight, dw_bias).reshape(b, hh * ww, c)
    return cb.block_tail_reference(h, x.reshape(b, hh * ww, c), ln_scale, ln_bias, w1, b1, w2,
                                   b2, gamma, beta).reshape(x.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c", [(2, 7, 96), (2, 1, 96), (2, 48, 256), (3, 12, 128),
                                    (1, 24, 512), (2, 12, 1024), (2, 7, 128), (2, 12, 256),
                                    (2, 24, 512), (2, 7, 1024), (3, 24, 128)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tail_backward_matches_plain_on_card(dtype, b, hw, c):
    """K10's eight outputs within va.grad_agreement's bounds (the run's
    dtype, cb.tail_grad_floors) of tail_backward_reference on the same
    inputs; two runs bit-equal; one launch a call."""
    _need_card()
    x, a = _inputs(b, hw, c, dtype, seed=b + hw + c)
    h = cb.dwconv(x, a["dw_weight"], a["dw_bias"]).reshape(b, hw * hw, c)
    dy = torch.randn(h.shape, generator=torch.Generator().manual_seed(1)).to("cuda", dtype)
    args = [a[k] for k in TAIL_KEYS]
    before = cb.convnext_tail_bwd.launches
    got = cb.convnext_tail_bwd(h, dy, *args)
    again = cb.convnext_tail_bwd(h, dy, *args)
    torch.cuda.synchronize()
    assert cb.convnext_tail_bwd.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    assert got[0].dtype == dtype and all(t.dtype == torch.float32 for t in got[1:])
    ref = cb.tail_backward_reference(h, dy, *args)
    floors = cb.tail_grad_floors(h, dy, *args)
    for name, u, v, floor in zip(cb.TAIL_GRAD_NAMES, got, ref, floors):
        e = va.grad_agreement(u, v, floor, dtype)
        assert va.grad_agrees(e), (name, e)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_block_gradients_reach_every_parameter_on_card(dtype):
    """The fault the Function repairs: K9's output had no grad_fn, so the
    LN, pw1, GRN and pw2 parameters of a fused block got no gradient on the
    card. Now every one of the eleven gradients is nonzero, comes back in its
    input's dtype, and agrees with autograd through the plain forward in f32;
    K9 and K10 launch once each."""
    _need_card()
    x, a = _inputs(2, 48, 256, dtype, seed=5)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(6)).to("cuda", dtype)
    leaves = [t.detach().requires_grad_(True) for t in (x, *a.values())]
    before = (cb.convnext_block_fused.launches, cb.convnext_tail_bwd.launches)
    out = cb.convnext_block_fused(leaves[0], **dict(zip(NAMES, leaves[1:])))
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (cb.convnext_block_fused.launches, cb.convnext_tail_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    f32 = [t.detach().float().requires_grad_(True) for t in (x, *a.values())]
    want = torch.autograd.grad(_plain_block(f32[0], **dict(zip(NAMES, f32[1:]))), f32,
                               g.float())
    for name, u, v, leaf in zip(("x",) + NAMES, got, want, leaves):
        assert u.dtype == leaf.dtype, name
        assert u.abs().max() > 0, name
        assert (u.float() - v).abs().max() <= BLOCK_RTOL[dtype] * v.abs().max(), name


@pytest.mark.cuda
def test_model_block_trains_through_k9_and_k10_where_the_gate_fuses():
    """A bf16 ConvNeXtV2Block in training: at 48 x 48 (2304 rows, the gate
    fuses) the forward launches K9 and the backward K10; at 24 x 24 (576
    rows) neither, while inference there still takes K9."""
    _need_card()
    blk = init_weights_(ConvNeXtV2Block(256), torch.Generator().manual_seed(0))
    blk = blk.to("cuda", torch.bfloat16).train()
    for hw, fused in ((48, True), (24, False)):
        x = torch.randn((2, hw, hw, 256), device="cuda").bfloat16().requires_grad_(True)
        before = (cb.convnext_block_fused.launches, cb.convnext_tail_bwd.launches)
        blk(x).float().square().sum().backward()
        torch.cuda.synchronize()
        n = int(fused)
        assert (cb.convnext_block_fused.launches, cb.convnext_tail_bwd.launches) == (
            before[0] + n, before[1] + n)
        assert blk.mlp.fc1.weight.grad.abs().max() > 0
        blk.zero_grad()
    with torch.no_grad():
        before = cb.convnext_block_fused.launches
        blk.eval()(torch.randn((2, 24, 24, 256), device="cuda").bfloat16())
        assert cb.convnext_block_fused.launches == before + 1


@pytest.mark.cuda
def test_mlp_grn_kernel_refuses_autograd_on_card():
    """K11 has no backward (the JAX kernel has no vjp either): it raises
    where autograd would need its gradient, and runs under no_grad."""
    _need_card()
    x, a = _inputs(2, 8, 64, torch.bfloat16, seed=7)
    y = torch.randn((2, 64, 64), device="cuda").bfloat16()
    args = [a[k] for k in ("w1", "b1", "w2", "b2", "gamma", "beta")]
    w1 = args[0].detach().requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        cb.convnext_mlp_grn_fused(y, x.reshape(2, 64, 64), w1, *args[1:])
    with torch.no_grad():
        out = cb.convnext_mlp_grn_fused(y, x.reshape(2, 64, 64), w1, *args[1:])
    assert out.shape == (2, 64, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c", [(2, 7, 96), (2, 96, 128), (2, 48, 256), (2, 24, 512),
                                    (3, 12, 1024)])
def test_tail_bwd_pass2_forms_ab_as_pass1_on_card(b, hw, c):
    """bf16 K10's pass 2 forms h1 and ab again where pass 1 formed them for
    GRN's norm: by the same instructions in the same order, so its own
    per-unit sums of ab^2 equal pass 1's bit for bit (fused pass 2 at C <=
    256, the split one above). One launch, counted."""
    _need_card()
    x, a = _inputs(b, hw, c, torch.bfloat16, seed=b + hw + c)
    h = cb.dwconv(x, a["dw_weight"], a["dw_bias"]).reshape(b, hw * hw, c)
    dy = torch.randn(h.shape, generator=torch.Generator().manual_seed(2)).to("cuda",
                                                                          torch.bfloat16)
    before = cb.convnext_tail_bwd.launches
    assert cb.tail_bwd_recomputes_ab(h, dy, *[a[k] for k in TAIL_KEYS])
    assert cb.convnext_tail_bwd.launches == before + 1
    with pytest.raises(ValueError, match="bf16"):
        cb.tail_bwd_recomputes_ab(h.float(), dy.float(), *[a[k] for k in TAIL_KEYS])
