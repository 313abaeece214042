"""Fused attention for the plain ViT towers (K2) and the grouped-bias cosine
attention of the Swin towers (K4): the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``xmir_tpu/ops/vit_attn_pallas.py``: K2 with its backward K3 first;
K4 (``biased_attention_fused``, the forward only) is described above its
functions below. ``vit_attention_fused(q, k, v, sm_scale)`` on (BH, N, hd)
launches ``csrc/vit_attn.cu`` for CUDA tensors and counts each call in its
``launches``. A tensor on the CPU takes ``attention_plain`` instead; any
other device raises. There is no fallback from the kernel to a plain version.
The call is differentiable: it is a ``torch.autograd.Function`` whose
backward, ``vit_attention_bwd``, launches ``csrc/vit_attn_bwd.cu`` (K3) for
CUDA tensors, counted in its own ``launches``, and takes
``attention_bwd_plain`` on the CPU.

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


def _check_qkv(q, k, v):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q, k and v of one (BH, N, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be of one dtype, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"all operands must lie on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")


def _check_cuda_operands(q, *others):
    """What both kernels need of (BH, N, hd) CUDA tensors shaped like q."""
    bh, n, hd = q.shape
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if bh < 1 or n < 1 or hd % 8 or not 8 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel needs BH, N >= 1 and hd a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {tuple(q.shape)}")
    for t in (q, *others):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the attention kernels' operands must be contiguous and 16-byte "
                             "aligned; nothing is copied here")


def launch_attention_forward(q, k, v, sm_scale: float, want_stats: bool):
    """Launches K2 on checked CUDA tensors. Returns (out, stats): stats is
    None, or (BH, N, 2) f32 with each query row's shift (the integer-valued
    ceil of its largest score in exp2 space) and the sum z of its e."""
    from . import _build

    _check_cuda_operands(q, k, v)
    bh, n, hd = q.shape
    out = torch.empty_like(v)
    stats = torch.empty((bh, n, 2), dtype=torch.float32, device=q.device) if want_stats else None
    with torch.cuda.device(q.device):
        err = _build.load().xmir_vit_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if stats is None else stats.data_ptr(), DTYPE_CODES[q.dtype], bh, n, hd,
            scale_constant(sm_scale, q.dtype), torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError_t {err}")
    vit_attention_fused.launches += 1
    return out, stats


def attention_bwd_reference(q, k, v, g, sm_scale: float):
    """(dq, dk, dv): ``torch.autograd.grad`` of ``attention_reference`` at
    cotangent g (the vjp of ``_attention_reference`` in the TPU file)."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = attention_reference(q, k, v, sm_scale)
        return torch.autograd.grad(out, (q, k, v), g)


def attention_bwd_plain(q, k, v, o, g, sm_scale: float):
    """Plain version of K3 on (BH, N, hd): (dq, dk, dv) of
    softmax(q k^T sm_scale) v from the saved output o and the cotangent g,
    with the kernel's rounding points, which are the TPU kernel's
    (``_bwd_kernel`` :659-677) with ``attention_plain``'s shift m = ceil(row
    max) in place of the row max: qs = q times scale log2(e) in q's dtype;
    f32 scores, e = exp2(s - m), z their f32 sum; c = rowsum(g o) and
    dp = g v^T in f32; t = e (dp - c) rounded to q's dtype before both of its
    products and e rounded to q's dtype for dv; 1 / z folded into the small
    operands: dq = (t k) (scale / z) in f32, then one rounding, qz = q
    (scale / z) and gz = g / z rounded to the input dtype; dk = t^T qz and
    dv = e^T gz summed in f32 and rounded once."""
    qs = q * torch.tensor(scale_constant(sm_scale, q.dtype), dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    e = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    zinv = 1.0 / e.sum(dim=-1, keepdim=True)
    sz = sm_scale * zinv
    g32 = g.float()
    c = (g32 * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(g32, v.float().transpose(-1, -2))
    t = (e * (dp - c)).to(q.dtype).float()
    dq = (torch.matmul(t, k.float()) * sz).to(q.dtype)
    qz = (q.float() * sz).to(q.dtype)
    gz = (g32 * zinv).to(g.dtype)
    dk = torch.matmul(t.transpose(-1, -2), qz.float()).to(k.dtype)
    dv = torch.matmul(e.to(q.dtype).float().transpose(-1, -2), gz.float()).to(v.dtype)
    return dq, dk, dv


# How far K3 may lie from ``attention_bwd_plain``, which rounds where the
# kernel rounds. dq, dk and dv are sums over up to N terms of either sign, so
# an output can be far smaller than its terms and a bound in steps of the
# output (K2's) says nothing: both bounds are relative to the tensor's
# largest magnitude, the worst output within GRAD_RTOL of it and the mean
# error within GRAD_MEAN_RTOL. Where a gradient all but vanishes (N = 1, or a
# row with one dominant key: p is one-hot and ds = p (dp - c) cancels) the
# f32 residue of dp - c remains, which follows the size of the terms, not of
# the result: the magnitude counts as GRAD_FLOOR of the terms' bound at least
# (``grad_floors``). In f32 only the sums' order differs (3e-5 is also the
# JAX package's own bound on its kernel, tests/test_vit_attn.py; a column of
# residues adds up over its N rows). In bf16 a score
# that moves in its last bit can flip the rounding of a t or an e to bf16, or
# of an output, by one step. A rounding point moved moves most outputs and
# the mean far past its bound (PERF.md has the kernel's and planted faults'
# readings). K10 (ops/convnext_block.py) is held by the same bound: its eight
# outputs are sums over rows, columns or images of terms of either sign, and a
# sum that moves in its last bit can flip the bf16 rounding of a z, an ab or a
# dh1; its f32 parameter gradients of a bf16 run take the bf16 bounds (the
# ``dtype`` of ``grad_agreement``), its floors are ``tail_grad_floors``.
GRAD_RTOL = {torch.float32: 3e-5, torch.bfloat16: 2 ** -7}
GRAD_MEAN_RTOL = {torch.float32: 4e-6, torch.bfloat16: 2 ** -15}
GRAD_FLOOR = 2 ** -8


def grad_floors(q, k, v, g, sm_scale: float):
    """The least magnitudes (for dq, dk, dv) that ``grad_agreement`` measures
    against: GRAD_FLOOR of a bound on each gradient's terms. |dp| and |c| are
    at most D = max|g row| max|v row| (Cauchy-Schwarz); a term of dq is at
    most sm_scale 2 D max|k|, of dk sm_scale 2 D max|q|, of dv max|g|."""
    d = torch.linalg.vector_norm(g.float(), dim=-1).max() * torch.linalg.vector_norm(
        v.float(), dim=-1).max()
    return (GRAD_FLOOR * sm_scale * d * k.float().abs().max(),
            GRAD_FLOOR * sm_scale * d * q.float().abs().max(),
            GRAD_FLOOR * g.float().abs().max())


def grad_agreement(out, ref, floor=0.0, dtype=None):
    """K3's ``out`` against ``attention_bwd_plain``'s ``ref`` (one of dq, dk,
    dv), or one of K10's outputs against ``tail_backward_reference``'s: the
    largest |out - ref|, and the worst and the mean error as shares of their
    bounds (``of_bound``, ``mean_of_bound``), both relative to the larger of
    ref's largest magnitude and ``floor`` (``grad_floors``,
    ``tail_grad_floors``). ``dtype``, the run's compute dtype, picks the
    bounds (default: ref's)."""
    dtype = dtype or ref.dtype
    r = ref.float()
    d = (out.float() - r).abs()
    top = torch.maximum(r.abs().max(), torch.as_tensor(floor, dtype=r.dtype, device=r.device))
    top = top.clamp_min(torch.finfo(torch.float32).tiny)
    return {"max_abs_err": d.max().item(),
            "of_bound": (d.max() / (GRAD_RTOL[dtype] * top)).item(),
            "mean_of_bound": (d.mean() / (GRAD_MEAN_RTOL[dtype] * top)).item()}


def grad_agrees(stats) -> bool:
    """Whether a ``grad_agreement`` reading is within the bounds (NaN is not)."""
    return stats["of_bound"] <= 1 and stats["mean_of_bound"] <= 1


def vit_attention_bwd(q, k, v, o, g, stats, sm_scale: float):
    """K3: (dq, dk, dv) of ``vit_attention_fused`` at cotangent g. q, k, v,
    the saved output o and g are (BH, N, hd) of one dtype; ``stats`` is the
    forward kernel's (BH, N, 2) f32 row statistics (None on the CPU, where
    ``attention_bwd_plain`` finds its own). On CUDA: contiguous, 16-byte
    aligned, hd a multiple of 8 up to 128, any N >= 1."""
    _check_qkv(q, k, v)
    if o.shape != q.shape or g.shape != q.shape or o.dtype != q.dtype or g.dtype != q.dtype:
        raise ValueError(f"o and g must match q's shape {tuple(q.shape)} and dtype {q.dtype}")
    if o.device != q.device or g.device != q.device:
        raise ValueError(f"all operands must lie on {q.device}")
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, g, sm_scale)
    from . import _build

    _check_cuda_operands(q, k, v, o, g)
    bh, n, hd = q.shape
    if (stats is None or stats.shape != (bh, n, 2) or stats.dtype != torch.float32
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"stats must be the forward kernel's ({bh}, {n}, 2) float32 tensor")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    crow = torch.empty((bh, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _build.load().xmir_vit_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            stats.data_ptr(), crow.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            DTYPE_CODES[q.dtype], bh, n, hd, scale_constant(sm_scale, q.dtype), sm_scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError_t {err}")
    vit_attention_bwd.launches += 1
    return dq, dk, dv


vit_attention_bwd.launches = 0


class _VitAttention(torch.autograd.Function):
    """K2 forward, K3 backward; on the CPU their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        if q.device.type == "cpu":
            out, stats = attention_plain(q, k, v, sm_scale), None
        else:
            needs_grad = any(ctx.needs_input_grad[:3])
            out, stats = launch_attention_forward(q, k, v, sm_scale, want_stats=needs_grad)
        ctx.sm_scale = sm_scale
        ctx.save_for_backward(q, k, v, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, stats = ctx.saved_tensors
        # autograd hands the cotangent over in whatever layout the consumer
        # left it: the kernel wants it contiguous
        dq, dk, dv = vit_attention_bwd(q, k, v, out, g.contiguous(), stats, ctx.sm_scale)
        return dq, dk, dv, None


def vit_attention_fused(q, k, v, sm_scale: float):
    """K2: softmax(q k^T sm_scale) v per leading index, differentiable in q,
    k and v (backward: K3). q, k, v (BH, N, hd) of one shape and dtype
    (float32 or bfloat16). Returns (BH, N, hd) in v's dtype. On CUDA:
    contiguous, 16-byte aligned, hd a multiple of 8 up to 128, any N >= 1."""
    _check_qkv(q, k, v)
    return _VitAttention.apply(q, k, v, float(sm_scale))


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
