"""ConvNeXtV2 block tail (K9) and its LN-less form (K11): the CUDA kernels'
wrappers and their plain PyTorch versions.

Port of ``xmir_tpu/ops/convnext_block_pallas.py``. The tail after the 7x7
depthwise conv is LayerNorm -> pw1 -> tanh-GELU -> GRN -> pw2 -> + residual,
per image, with the TPU kernel's rounding points: the LN output and the GELU
output h are rounded to the input dtype, GRN's statistic is taken over the
rounded h in f32, and the residual is added in f32.

``convnext_block_fused`` (K9) and ``convnext_mlp_grn_fused`` (K11) launch
``csrc/convnext_block.cu`` for CUDA tensors and count each call in their
``launches``. A tensor on the CPU takes the plain version instead; any other
device raises. There is no fallback from the kernel to the plain version.

Layouts: activations are NHWC, as in the JAX package, and the kernels read
them as (B, R, C) rows, which a channels_last NCHW tensor permuted to NHWC
already is. Weights are in torch's layout: the depthwise conv (C, 1, 7, 7),
pw1 (4C, C) and pw2 (C, 4C) as ``nn.Linear`` stores them (out, in).
"""
from __future__ import annotations

import ctypes
import os

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_mlp_enabled(dtype, device) -> bool:
    """Whether a block whose compute dtype is ``dtype`` on ``device`` takes
    the fused tail: bf16 on CUDA (the JAX package: bf16 on the TPU; f32 keeps
    the exact-GELU plain path). ``XMIR_FUSED_MLP`` = 0 or 1 overrides, as in
    the JAX package."""
    flag = os.environ.get("XMIR_FUSED_MLP", "")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return dtype == torch.bfloat16 and torch.device(device).type == "cuda"


def dwconv(x, weight, bias):
    """7x7 depthwise conv (padding 3) of NHWC ``x`` with torch's (C, 1, 7, 7)
    weight, in x's dtype (cuDNN; the JAX package runs it outside any Pallas
    kernel). Returns an NHWC view of a channels_last result."""
    h = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), bias.to(x.dtype), padding=3,
                 groups=x.shape[-1])
    return h.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def layer_norm(x, weight, bias, eps: float = LN_EPS):
    """LayerNorm over the last axis with flax's fast variance: f32 statistics,
    var = max(E[x^2] - mean^2, 0), output in x's dtype promoted with the
    weight's."""
    xs = x.float()
    mean = xs.mean(dim=-1, keepdim=True)
    var = torch.clamp((xs * xs).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    y = (xs - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(torch.promote_types(x.dtype, weight.dtype))


def linear_f32(a, w):
    """a @ w.T accumulated and returned in f32, the TPU kernel's
    ``preferred_element_type=f32``: a bf16 CUDA GEMM with an f32 output
    (cuBLAS), else the f32 GEMM of a's and w's values."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a.reshape(-1, a.shape[-1]), w.t(), out_dtype=torch.float32).reshape(
            *a.shape[:-1], w.shape[0])
    return F.linear(a.float(), w.float())


def mlp_grn_reference(y, x, w1, b1, w2, b2, gamma, beta):
    """Plain version of K11 (``_kernel`` of the TPU file): y (B, R, C) the
    normalised input, x (B, R, C) the residual, w1 (4C, C), w2 (C, 4C).
    Returns x + pw2(GRN(GELU(pw1(y)))) in x's dtype.

    The GEMMs accumulate in f32 and everything after them is f32, so the
    only roundings to the input dtype are the kernel's: h, z and the
    output."""
    h = F.gelu(linear_f32(y, w1) + b1.float(), approximate="tanh").to(y.dtype)
    hf = h.float()
    gx = torch.sqrt(torch.sum(hf * hf, dim=1, keepdim=True) + 1e-12)  # (B, 1, 4C)
    nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
    z = gamma.float() * (hf * nx) + beta.float() + hf
    out = linear_f32(z.to(y.dtype), w2) + b2.float()
    return (x.float() + out).to(x.dtype)


def block_tail_reference(h, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta):
    """Plain version of K9 (``_ln_block_kernel``): h (B, R, C) the dwconv
    output, x (B, R, C) the block input. LayerNorm in f32 rounded to h's
    dtype, then ``mlp_grn_reference``."""
    y = layer_norm(h, ln_scale.float(), ln_bias.float()).to(h.dtype)
    return mlp_grn_reference(y, x, w1, b1, w2, b2, gamma, beta)


# How far K9 / K11 may lie from their plain versions, which round where the
# kernels round, so only the f32 summation order differs. f32: per output
# |out - ref| <= F32_RTOL (1 + |ref|). bf16: per output within BF16_STEPS of
# bf16's spacing at ref plus BF16_ATOL (a rounding of z that flips with the
# summation order moves pw2's sum by |w2| times z's spacing, absolute), and
# on average within BF16_MEAN_STEPS of that spacing over |ref| >= 2^-4: the
# kernels are bit-equal on >99% of outputs, while a rounding point moved or
# a GELU swapped moves the average tens of times more (PERF.md).
F32_RTOL = 3e-5
BF16_STEPS, BF16_ATOL, BF16_MEAN_STEPS = 2, 2 ** -7, 0.05


def bf16_step(v):
    """The spacing of bfloat16 numbers at |v| (8 significant bits)."""
    _, e = torch.frexp(v.abs().clamp_min(2.0 ** -100))
    return torch.exp2((e - 8).float())


def agreement(out, ref, atol: float = BF16_ATOL, floor: float = 2 ** -4,
              rtol: float = F32_RTOL):
    """A kernel's ``out`` against its plain version's ``ref`` (same shape and
    dtype): the largest |out - ref|, its largest share of the per-output
    bound (``of_bound``) and, in bf16, the mean error in bf16 steps over
    |ref| >= ``floor`` (``mean_steps``). They agree when of_bound <= 1 and
    mean_steps <= BF16_MEAN_STEPS; NaN agrees with nothing. ``atol`` and
    ``floor`` (bf16) and ``rtol`` (f32) default to K9 / K11's; a kernel whose
    outputs are smaller, or whose scores are larger, states its own."""
    r = ref.float()
    d = (out.float() - r).abs()
    if ref.dtype == torch.float32:
        return {"max_abs_err": d.max().item(),
                "of_bound": (d / (rtol * (1 + r.abs()))).max().item(), "mean_steps": 0.0}
    step = bf16_step(r)
    big = r.abs() >= floor
    return {"max_abs_err": d.max().item(),
            "of_bound": (d / (BF16_STEPS * step + atol)).max().item(),
            "mean_steps": (d[big] / step[big]).mean().item() if big.any() else 0.0}


def agrees(stats) -> bool:
    """Whether an ``agreement`` reading is within the bounds."""
    return stats["of_bound"] <= 1 and stats["mean_steps"] <= BF16_MEAN_STEPS


def _check_tail(y, x, w1, b1, w2, b2, gamma, beta):
    if y.dim() != 3 or x.shape != y.shape:
        raise ValueError(f"need y and x of one (B, R, C) shape, got {tuple(y.shape)} and "
                         f"{tuple(x.shape)}")
    c = y.shape[2]
    c4 = w1.shape[0]
    if w1.shape != (c4, c) or w2.shape != (c, c4):
        raise ValueError(f"need w1 (4C, C) and w2 (C, 4C) for C={c}, got {tuple(w1.shape)} "
                         f"and {tuple(w2.shape)}")
    for name, t, n in (("b1", b1, c4), ("gamma", gamma, c4), ("beta", beta, c4), ("b2", b2, c)):
        if t.shape != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    tensors = (y, x, w1, b1, w2, b2, gamma, beta)
    if any(t.device != y.device for t in tensors):
        raise ValueError(f"all operands must lie on {y.device}")
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ConvNeXt block kernel for device {y.device}")


def _launch(a, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta):
    """The CUDA tail on (B, R, C) ``a`` (the dwconv output when ln_scale is
    given, else the normalised input) and residual ``x``."""
    from . import _build

    if a.dtype not in DTYPE_CODES or any(t.dtype != a.dtype for t in (x, w1, w2)):
        raise TypeError(f"a, x, w1 and w2 must all be float32 or all bfloat16, got "
                        f"{a.dtype}, {x.dtype}, {w1.dtype} and {w2.dtype}")
    bsz, rows, c = a.shape
    c4 = w1.shape[0]
    if c % 8 or c4 % 8:
        raise ValueError(f"the kernel needs C and 4C to be multiples of 8, got {c} and {c4}")
    vecs = [None if t is None else t.float().contiguous()
            for t in (ln_scale, ln_bias, b1, b2, gamma, beta)]
    for t in (a, x, w1, w2, *(v for v in vecs if v is not None)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel's operands must be contiguous and 16-byte aligned "
                             "(a permuted channels_last tensor is; nothing is copied here)")
    lib = _build.load()
    tiles = ctypes.c_int()
    err = lib.xmir_convnext_plan(rows, ctypes.addressof(tiles))
    if err != 0:
        raise ValueError(f"no ConvNeXt tail plan for {rows} rows: cudaError_t {err}")
    h = torch.empty((bsz, rows, c4), dtype=a.dtype, device=a.device)
    part = torch.empty((bsz, tiles.value, c4), dtype=torch.float32, device=a.device)
    nx = torch.empty((bsz, c4), dtype=torch.float32, device=a.device)
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lns, lnb, b1f, b2f, gf, bef = vecs
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.xmir_convnext_tail(
            a.data_ptr(), x.data_ptr(), ptr(lns), ptr(lnb), w1.data_ptr(), b1f.data_ptr(),
            w2.data_ptr(), b2f.data_ptr(), gf.data_ptr(), bef.data_ptr(), DTYPE_CODES[a.dtype],
            bsz, rows, c, c4, h.data_ptr(), part.data_ptr(), nx.data_ptr(), out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"ConvNeXt block tail kernel launch failed: cudaError_t {err}")
    return out


def convnext_mlp_grn_fused(y, x, w1, b1, w2, b2, gamma, beta):
    """K11: x + pw2(GRN(tanh-GELU(pw1(y)))) per image, y (B, R, C) already
    normalised, x (B, R, C) the residual; w1 (4C, C), w2 (C, 4C), b1, gamma,
    beta (4C,), b2 (C,). Returns (B, R, C) in x's dtype."""
    _check_tail(y, x, w1, b1, w2, b2, gamma, beta)
    if y.device.type == "cpu":
        return mlp_grn_reference(y, x, w1, b1, w2, b2, gamma, beta)
    out = _launch(y, x, None, None, w1, b1, w2, b2, gamma, beta)
    convnext_mlp_grn_fused.launches += 1
    return out


def convnext_block_fused(x, dw_weight, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                         beta):
    """K9: the ConvNeXtV2 block, its depthwise conv on cuDNN and everything
    after it (LayerNorm -> pw1 -> tanh-GELU -> GRN -> pw2 -> + x) in the
    kernel. x (B, H, W, C) NHWC is also the residual; dw_weight (C, 1, 7, 7),
    dw_bias, ln_scale, ln_bias (C,); w1 (4C, C), w2 (C, 4C) in x's dtype; b1,
    gamma, beta (4C,), b2 (C,). Returns (B, H, W, C) in x's dtype."""
    b, hh, ww, c = x.shape
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no ConvNeXt block kernel for device {x.device}")
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor (a channels_last NCHW tensor "
                         "permuted to NHWC is); nothing is copied here")
    if ln_scale.shape != (c,) or ln_bias.shape != (c,):
        raise ValueError(f"ln_scale and ln_bias must be ({c},)")
    rows = (b, hh * ww, c)
    h = dwconv(x, dw_weight, dw_bias).reshape(rows)
    x_rows = x.reshape(rows)
    _check_tail(h, x_rows, w1, b1, w2, b2, gamma, beta)
    if x.device.type == "cpu":
        out = block_tail_reference(h, x_rows, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta)
    else:
        out = _launch(h, x_rows, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta)
        convnext_block_fused.launches += 1
    return out.reshape(b, hh, ww, c)


convnext_mlp_grn_fused.launches = 0
convnext_block_fused.launches = 0
