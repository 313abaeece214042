"""The ConvNeXtV2 block-tail kernels K9 and K11 (csrc/convnext_block.cu)
against their plain PyTorch versions on the card. Only torch and the port are
imported, so the card's machine (which has no flax) runs this file:

    python -m pytest tests/test_torch_convnext_kernels.py -m cuda -q

On a machine without a card every test here skips.
"""
import pytest
import torch

from xmir_tpu_torch.ops import convnext_block as cb


def _inputs(b, hw, c, dtype, seed, w=None):
    """A block input (b, hw, w or hw, c) and random nonzero parameters."""
    gen = torch.Generator().manual_seed(seed)
    c4 = 4 * c

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen) * sc).cuda()

    a = dict(dw_weight=r(c, 1, 7, 7, sc=0.1), dw_bias=r(c, sc=0.1), ln_scale=1 + r(c, sc=0.2),
             ln_bias=r(c, sc=0.1), w1=r(c4, c, sc=c ** -0.5).to(dtype), b1=r(c4, sc=0.1),
             w2=r(c, c4, sc=c4 ** -0.5).to(dtype), b2=r(c, sc=0.1), gamma=r(c4, sc=0.5),
             beta=r(c4, sc=0.1))
    return r(b, hw, w or hw, c).to(dtype), a


def _assert_close(out, ref):
    """out within the bounds of cb.agreement (the ones chip_smoke.py holds)."""
    e = cb.agreement(out, ref)
    assert cb.agrees(e), e


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c", [(2, 7, 128), (3, 12, 128), (3, 24, 128), (2, 12, 1024),
                                    (2, 25, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dtype, b, hw, c):
    """A ragged row count (49, 625), and 144 / 576 rows, where 128-row tiles
    would straddle images if rows were flattened over the batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, a = _inputs(b, hw, c, dtype, seed=hw + c)
    before = cb.convnext_block_fused.launches
    out = cb.convnext_block_fused(x, **a)
    torch.cuda.synchronize()
    assert cb.convnext_block_fused.launches == before + 1
    h = cb.dwconv(x, a["dw_weight"], a["dw_bias"]).reshape(b, hw * hw, c)
    xr = x.reshape(b, hw * hw, c)
    ref = cb.block_tail_reference(h, xr, a["ln_scale"], a["ln_bias"], a["w1"], a["b1"],
                                  a["w2"], a["b2"], a["gamma"], a["beta"])
    _assert_close(out.reshape(b, hw * hw, c), ref)
    assert torch.equal(out, cb.convnext_block_fused(x, **a))  # no atomics: same bits
    y = cb.layer_norm(h, a["ln_scale"], a["ln_bias"]).to(dtype)
    tail = (a["w1"], a["b1"], a["w2"], a["b2"], a["gamma"], a["beta"])
    before = cb.convnext_mlp_grn_fused.launches
    out11 = cb.convnext_mlp_grn_fused(y, xr, *tail)
    torch.cuda.synchronize()
    assert cb.convnext_mlp_grn_fused.launches == before + 1
    _assert_close(out11, cb.mlp_grn_reference(y, xr, *tail))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hh,ww,c", [(1, 8, 8, 128), (3, 5, 13, 256), (2, 12, 12, 1024),
                                       (3, 24, 24, 512), (2, 48, 48, 256), (1, 96, 96, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_unit_edges_on_card(dtype, b, hh, ww, c):
    """R = 64, 65, 144, 576, 2304 and 9216 rows: one bf16 unit of 64 rows, a
    unit and one live row, 144 rows ending in a ragged unit, ConvNeXtV2-Base's
    stage shapes at 384 px; B = 1 to 3 (an odd number of units leaves a
    block's second warpgroup idle). K9 and K11 within cb.agreement, K9
    twice bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, a = _inputs(b, hh, c, dtype, seed=hh * ww + c, w=ww)
    rows = hh * ww
    before = (cb.convnext_block_fused.launches, cb.convnext_mlp_grn_fused.launches)
    out = cb.convnext_block_fused(x, **a)
    h = cb.dwconv(x, a["dw_weight"], a["dw_bias"]).reshape(b, rows, c)
    xr = x.reshape(b, rows, c)
    tail = (a["w1"], a["b1"], a["w2"], a["b2"], a["gamma"], a["beta"])
    _assert_close(out.reshape(b, rows, c),
                  cb.block_tail_reference(h, xr, a["ln_scale"], a["ln_bias"], *tail))
    assert torch.equal(out, cb.convnext_block_fused(x, **a))
    y = cb.layer_norm(h, a["ln_scale"], a["ln_bias"]).to(dtype)
    _assert_close(cb.convnext_mlp_grn_fused(y, xr, *tail), cb.mlp_grn_reference(y, xr, *tail))
    torch.cuda.synchronize()
    assert (cb.convnext_block_fused.launches, cb.convnext_mlp_grn_fused.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_wrapper_raises_on_non_contiguous_input():
    """A contiguous NCHW tensor permuted to NHWC is not (B, R, C) rows: the
    wrapper raises instead of copying."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    x, a = _inputs(1, 8, 128, torch.bfloat16, seed=0)
    nchw = x.permute(0, 3, 1, 2).contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        cb.convnext_block_fused(nchw.permute(0, 2, 3, 1), **a)
