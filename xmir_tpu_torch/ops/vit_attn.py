"""Fused attention for the plain ViT towers (K2) and the grouped-bias cosine
attention of the Swin towers (K4): the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``xmir_tpu/ops/vit_attn_pallas.py``, the two forwards only. K2 first;
K4 (``biased_attention_fused``) is described above its functions below.
``vit_attention_fused(q, k, v, sm_scale)`` on (BH, N, hd) launches
``csrc/vit_attn.cu`` for CUDA tensors and counts each call in its
``launches``. A tensor on the CPU takes ``attention_plain`` instead; any
other device raises. There is no fallback from the kernel to a plain version.
On CUDA the wrapper takes no input that requires grad while grad mode is on:
the backward is not ported yet.

Two plain versions:

``attention_reference``  softmax(q k^T scale) v with an f32 softmax and no
    other rounding (``_attention_reference`` of the TPU file).
``attention_plain``  the kernel's arithmetic, which is the TPU kernel's
    (``_kernel`` :123-159) with one change: q times scale log2(e) in q's
    dtype, the constant itself rounded to that dtype; f32 scores; e =
    exp2(s - m); z the f32 sum of the unrounded e; the value product on e
    rounded to v's dtype, accumulated in f32; (e . v) / z in f32, then one
    rounding. The change: m is ceil(row max), not the row max. The CUDA
    kernel streams key tiles with a running max, and an integer-valued max
    makes every rescale an exact power of two, so the streamed result is this
    single pass up to the order of its f32 sums.
"""
from __future__ import annotations

import torch

from .convnext_block import DTYPE_CODES, agrees  # noqa: F401  (agrees: this module's too)
from .convnext_block import agreement as _agreement

LOG2E = 1.4426950408889634
MAX_HEAD_DIM = 128


def attention_reference(q, k, v, sm_scale: float):
    """softmax(q k^T sm_scale) v on (BH, N, hd): f32 scores and softmax, the
    probabilities rounded to v's dtype for the value product. Returns v's
    dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    p = torch.softmax(s * sm_scale, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def scale_constant(sm_scale: float, dtype) -> float:
    """sm_scale log2(e) rounded to ``dtype``: the factor q is multiplied by."""
    return torch.tensor(sm_scale * LOG2E, dtype=dtype).item()


def attention_plain(q, k, v, sm_scale: float):
    """Plain version of K2 on (BH, N, hd), with the kernel's rounding points
    (module docstring). Returns v's dtype."""
    qs = q * torch.tensor(scale_constant(sm_scale, q.dtype), dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    e = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    z = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    return (o / z).to(v.dtype)


# How far K2 may lie from ``attention_plain``, which rounds where the kernel
# rounds, so only the order of the f32 sums differs (and, through a score
# that moves in its last bit, a rare flip of e's rounding to bf16). f32: per
# output |out - ref| <= F32_RTOL (1 + |ref|) of ops/convnext_block.py. bf16:
# per output within two bf16 steps at ref plus BF16_ATOL, and on average
# within 0.05 of a step (K9's BF16_MEAN_STEPS) over |ref| >= BF16_FLOOR. An
# attention output is a weighted mean of v's rows, so it is smaller than v:
# the floor and the absolute term are K9's divided by 16. A q-scale constant
# left unrounded, or e rounded before the sum z, moves the average past its
# bound on rows with few dominant scores (PERF.md).
BF16_ATOL, BF16_FLOOR = 2 ** -11, 2 ** -8


def agreement(out, ref):
    """K2's ``out`` against ``attention_plain``'s ``ref``: see
    ops/convnext_block.py::agreement, with this module's BF16_ATOL and
    BF16_FLOOR."""
    return _agreement(out, ref, atol=BF16_ATOL, floor=BF16_FLOOR)


def vit_attention_fused(q, k, v, sm_scale: float):
    """K2: softmax(q k^T sm_scale) v per leading index. q, k, v (BH, N, hd)
    of one shape and dtype (float32 or bfloat16). Returns (BH, N, hd) in v's
    dtype. On CUDA: contiguous, 16-byte aligned, hd a multiple of 8 up to
    128, any N >= 1."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q, k and v of one (BH, N, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be of one dtype, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"all operands must lie on {q.device}")
    if q.device.type == "cpu":
        return attention_plain(q, k, v, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    from . import _build

    bh, n, hd = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if bh < 1 or n < 1 or hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel needs BH, N >= 1 and hd a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {tuple(q.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("the attention kernel is forward only: call it under "
                           "torch.inference_mode() or torch.no_grad()")
    for t in (q, k, v):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k and v must be contiguous and 16-byte aligned; nothing is "
                             "copied here")
    out = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _build.load().xmir_vit_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype], bh,
            n, hd, scale_constant(sm_scale, q.dtype),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError_t {err}")
    vit_attention_fused.launches += 1
    return out


vit_attention_fused.launches = 0


# ---------------------------------------------------------------------------
# K4: softmax(norm(q) norm(k)^T scale_g + bias_g) v with a bias slice and a
# logit scale per group of rows (SwinV2's window attention). The kernel
# (csrc/window_attn.cu) keeps a window's K and V in shared memory and finds
# each row's exact max in a first pass, so its arithmetic is the TPU kernel's
# (``_kernel_biased`` :282-312) with no change: ``biased_attention_plain``
# writes it out, rounding where both round. ``biased_attention_reference`` is
# the TPU file's ``_biased_reference``: no rounding but the probabilities'.

MAX_WINDOW_HEAD_DIM = 64


def group_index(bh: int, n_groups: int, g_size: int, device):
    """Row i of the folded (BH, N, hd) batch uses group (i // g_size) % G."""
    return (torch.arange(bh, device=device) // g_size) % n_groups


def sum_squares(x):
    """The f32 sum of squares over the last axis, (..., 1), added up in the
    bf16 kernel's order where the width is a multiple of 8: eight consecutive
    elements in sequence (one 16-byte vector a lane), then a pairwise tree
    over the vectors. A bf16 value's square is exact in f32, so on bf16 inputs
    this is the kernel's sum bit for bit, and no rounding of the normalised
    q and k to bf16 flips between the two."""
    sq = x * x
    if x.shape[-1] % 8:
        return sq.sum(dim=-1, keepdim=True)
    parts = sq.reshape(*x.shape[:-1], -1, 8)
    acc = parts[..., 0]
    for i in range(1, 8):
        acc = acc + parts[..., i]
    while acc.shape[-1] > 1:
        if acc.shape[-1] % 2:
            acc = torch.cat([acc, torch.zeros_like(acc[..., :1])], dim=-1)
        acc = acc[..., 0::2] + acc[..., 1::2]
    return acc


def inv_norm(x):
    """1 / max(||x||, 1e-12) over the last axis of an f32 tensor, as the
    kernels take it: the f32 sum of squares clamped at 1e-24, an IEEE square
    root and an IEEE division."""
    return 1.0 / torch.sqrt(torch.clamp(sum_squares(x), min=1e-24))


def biased_attention_reference(q, k, v, bias, scale, g_size: int = 1, cosine: bool = False):
    """softmax(norm(q) norm(k)^T scale_g + bias_g) v on (BH, N, hd): f32
    scores and softmax, the probabilities rounded to v's dtype for the value
    product. bias (G, N, N), scale (G,) or (G, 1). Returns v's dtype."""
    gidx = group_index(q.shape[0], bias.shape[0], g_size, q.device)
    if cosine:
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
        k = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-12)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    s = s * scale.reshape(-1).float()[gidx][:, None, None] + bias.float()[gidx]
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def biased_attention_plain(q, k, v, bias, scale, g_size: int = 1, cosine: bool = False):
    """Plain version of K4 on (BH, N, hd), with the kernel's rounding points:
    with ``cosine`` q and k times their inverse norms in f32, q times
    scale_g log2(e) (an f32 product) and rounded to the input dtype, k
    rounded to the input dtype; without it q times scale_g log2(e) rounded
    to the input dtype, in that dtype. f32 scores plus bias log2(e) (rounded
    once); e = exp2(s - row max); z the f32 sum of the unrounded e; the value
    product on e rounded to v's dtype, accumulated in f32; (e . v) / z in
    f32, then one rounding. Returns v's dtype."""
    gidx = group_index(q.shape[0], bias.shape[0], g_size, q.device)
    c = (scale.reshape(-1).float() * LOG2E)[gidx][:, None, None]
    if cosine:
        qf, kf = q.float(), k.float()
        qs = ((qf * inv_norm(qf)) * c).to(q.dtype)
        ks = (kf * inv_norm(kf)).to(k.dtype)
    else:
        qs, ks = q * c.to(q.dtype), k
    s = torch.matmul(qs.float(), ks.float().transpose(-1, -2)) + (bias.float() * LOG2E)[gidx]
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    z = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    return (o / z).to(v.dtype)


# How far K4 and K6 may lie from their plain versions, which round where the
# kernels round (and, in bf16, normalise q and k bit for bit alike), so only
# the order of the f32 sums in the scores and in z differs. SwinV2's logits
# are sharp: cosines times a scale of up to 100, so in exp2 space scores reach
# +-144, where one f32 ulp is 1.5e-5 and the sums' order moves a weight by
# that much relatively: f32 per output |out - ref| <= WINDOW_F32_RTOL
# (1 + |ref|). In bf16 a row then has few dominant keys, and where the order
# flips the rounding of one weight to bf16 (a step of at most 2^-8) the
# output moves by up to 2^-8 |v|, whatever its own size: the absolute term is
# 2^-6, for values of unit variance. On average within 0.05 of a step over
# |ref| >= 2^-4, as for K9 (PERF.md has the kernels' and planted faults'
# readings).
WINDOW_F32_RTOL, WINDOW_BF16_ATOL = 1e-4, 2 ** -6


def window_agreement(out, ref):
    """K4's or K6's ``out`` against its plain version's ``ref``: see
    ops/convnext_block.py::agreement, with the bounds stated above."""
    return _agreement(out, ref, atol=WINDOW_BF16_ATOL, rtol=WINDOW_F32_RTOL)


def launch_window_attention(q, k, v, bias, scale, mode: int, groups):
    """Launches csrc/window_attn.cu on (BH, N, hd) CUDA tensors. mode: 0 = K4
    without the cosine normalisation, 1 = K4 with it, 2 = K6. ``groups`` =
    (d1, m1, s1, d2, m2, s2): row i uses bias slice
    (i // d1) % m1 * s1 + (i // d2) % m2 * s2. Checks what the kernel needs
    and raises otherwise; returns the output, (BH, N, hd) in v's dtype."""
    from . import _build

    bh, n, hd = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if bh < 1 or n < 1 or hd % 8 or not 8 <= hd <= MAX_WINDOW_HEAD_DIM:
        raise ValueError(f"the kernel needs BH, N >= 1 and hd a multiple of 8 up to "
                         f"{MAX_WINDOW_HEAD_DIM}, got {tuple(q.shape)}")
    tensors = (q, k, v, bias) if scale is None else (q, k, v, bias, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the window attention kernel is forward only: call it under "
                           "torch.inference_mode() or torch.no_grad()")
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all operands must lie on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k, v, bias and scale must be contiguous and 16-byte aligned; "
                             "nothing is copied here")
    out = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = _build.load().xmir_window_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
            mode, bh, n, hd, *groups, torch.cuda.current_stream(q.device).cuda_stream)
    if err == -1:  # the launcher's own size check, no cudaError_t code
        raise ValueError(f"one window's K and V (N={n}, hd={hd}, {q.dtype}) do not fit a "
                         "block's shared memory, where the window attention kernel keeps them")
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: cudaError_t {err}")
    return out


def biased_attention_fused(q, k, v, bias, scale, g_size: int = 1, cosine: bool = False):
    """K4: softmax(norm(q) norm(k)^T scale_g + bias_g) v, fused. q, k, v
    (BH, N, hd) of one shape and dtype (float32 or bfloat16); bias (G, N, N)
    float32; scale (G,) or (G, 1) logit scales, float32; row i uses group
    (i // g_size) % G. ``cosine`` L2-normalises q and k rows inside the
    kernel (SwinV2's cosine attention, fold order (heads, windows, batch),
    bias = CPB + shift mask). Returns (BH, N, hd) in v's dtype. On CUDA:
    contiguous, 16-byte aligned, hd a multiple of 8 up to 64, one window's K
    and V within a block's shared memory (N = 576 at hd = 32 fits in both
    dtypes)."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q, k and v of one (BH, N, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be of one dtype, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    n = q.shape[1]
    n_groups = bias.shape[0]
    if bias.shape != (n_groups, n, n) or scale.numel() != n_groups:
        raise ValueError(f"need bias (G, {n}, {n}) and G scales, got {tuple(bias.shape)} and "
                         f"{tuple(scale.shape)}")
    if g_size < 1:
        raise ValueError(f"g_size={g_size} must be at least 1")
    if q.device.type == "cpu":
        return biased_attention_plain(q, k, v, bias, scale, g_size, cosine)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    if bias.dtype != torch.float32 or scale.dtype != torch.float32:
        raise TypeError(f"bias and scale must be float32, got {bias.dtype} and {scale.dtype}")
    out = launch_window_attention(q, k, v, bias, scale.reshape(-1), 1 if cosine else 0,
                                  (g_size, n_groups, 1, 1, 1, 0))
    biased_attention_fused.launches += 1
    return out


biased_attention_fused.launches = 0
