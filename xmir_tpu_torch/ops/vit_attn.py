"""Fused attention for the plain ViT towers (K2) and the grouped-bias cosine
attention of the Swin towers (K4): the CUDA kernels' wrappers and their plain
PyTorch versions.

Port of ``xmir_tpu/ops/vit_attn_pallas.py``: K2 with its backward K3 first;
K4 (``biased_attention_fused``) with its backward K5 (``biased_attention_bwd``,
csrc/window_attn_bwd.cu) is described above its functions below. ``vit_attention_fused(q, k, v, sm_scale)`` on (BH, N, hd)
launches ``csrc/vit_attn.cu`` for CUDA tensors and counts each call in its
``launches``. A tensor on the CPU takes ``attention_plain`` instead; any
other device raises. There is no fallback from the kernel to a plain version.
The call is differentiable: it is a ``torch.autograd.Function`` whose
backward, ``vit_attention_bwd``, launches ``csrc/vit_attn_bwd.cu`` (K3) for
CUDA tensors, counted in its own ``launches``, and takes
``attention_bwd_plain`` on the CPU. The forwards of K2 and K4 are custom ops,
``xmir::vit_attention`` and ``xmir::biased_attention`` (see
ops/convnext_block.py for what their parts are); a call that wants no
gradient calls its op without the Function, and K2's op then returns no row
statistics.

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

import ctypes
from typing import List

import torch

from .convnext_block import DTYPE_CODES, agrees  # noqa: F401  (agrees: this module's too)
from .convnext_block import bf16_step, grad_wanted, same_shapes
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


def attention_stats_plain(q, k, sm_scale: float):
    """K2's row statistics by ``attention_plain``'s arithmetic: (BH, N, 2)
    f32, each query row's shift ceil(row max) and the sum z of its e."""
    qs = q * torch.tensor(scale_constant(sm_scale, q.dtype), dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = torch.ceil(s.amax(dim=-1, keepdim=True))
    return torch.cat([m, torch.exp2(s - m).sum(dim=-1, keepdim=True)], dim=-1)


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
#
# One flip is not small beside an output: in a row whose sum z is small, the
# row's largest e (in (1/2, 1], the shift being ceil(row max)) rounding to
# bf16 the other way moves every output of the row by one bf16 step of e_max
# (2^-8 below 1, 2^-7 at 1) times |v| / z. So the absolute term of a bf16
# output is the larger of BF16_ATOL and that step times |v_dom| / z
# (``flip_allowance``), v_dom the value row of the largest score; it
# governs only in rows that one score dominates.
BF16_ATOL, BF16_FLOOR = 2 ** -11, 2 ** -8


def flip_allowance(q, k, v, sm_scale: float):
    """bf16_step(e_max) |v_dom| / z for each output of K2 on (BH, N, hd), by
    ``attention_plain``'s arithmetic: the most that one flip of the row's
    largest e moves an output."""
    qs = q * torch.tensor(scale_constant(sm_scale, q.dtype), dtype=q.dtype, device=q.device)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    e = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
    e_max, dom = e.max(dim=-1, keepdim=True)
    v_dom = torch.gather(v.float(), 1, dom.expand(-1, -1, v.shape[-1]))
    return bf16_step(e_max) * v_dom.abs() / e.sum(dim=-1, keepdim=True)


def agreement(out, ref, allowance=None):
    """K2's ``out`` against ``attention_plain``'s ``ref``: see
    ops/convnext_block.py::agreement, with this module's BF16_ATOL and
    BF16_FLOOR; in bf16, with ``allowance`` (``flip_allowance`` of the
    inputs), the absolute term of each output is the larger of the two."""
    atol = BF16_ATOL if allowance is None else torch.clamp(allowance, min=BF16_ATOL)
    return _agreement(out, ref, atol=atol, floor=BF16_FLOOR)


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


@torch.library.custom_op("xmir::vit_attention", mutates_args=(), device_types="cuda")
def vit_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float,
                     want_stats: bool) -> List[torch.Tensor]:
    """K2 on CUDA tensors (``launch_attention_forward``): [out], or
    [out, stats] where ``want_stats``."""
    out, stats = launch_attention_forward(q, k, v, sm_scale, want_stats)
    return [out] if stats is None else [out, stats]


@vit_attention_op.register_kernel("cpu")
def _vit_attention_cpu(q, k, v, sm_scale, want_stats):
    out = attention_plain(q, k, v, sm_scale)
    return [out, attention_stats_plain(q, k, sm_scale)] if want_stats else [out]


@vit_attention_op.register_fake
def _vit_attention_fake(q, k, v, sm_scale, want_stats):
    torch._check(q.dim() == 3)
    same_shapes(q, k, v)
    out = torch.empty_like(v)
    if not want_stats:
        return [out]
    return [out, q.new_empty((q.shape[0], q.shape[1], 2), dtype=torch.float32)]


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
    lib = _build.load()
    nbytes = ctypes.c_longlong()
    if lib.xmir_vit_attn_bwd_workspace(DTYPE_CODES[q.dtype], bh, n, hd, ctypes.byref(nbytes)):
        raise ValueError(f"the backward kernel does not take {tuple(q.shape)} {q.dtype}")
    # the scaled operands (f32: also their TF32 small parts and qz, gz transposed), the
    # f32 dq sums and the order counters
    scratch = torch.empty(nbytes.value, dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.xmir_vit_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            stats.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            DTYPE_CODES[q.dtype], bh, n, hd, scale_constant(sm_scale, q.dtype), sm_scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention backward kernel launch failed: cudaError_t {err}")
    vit_attention_bwd.launches += 1
    return dq, dk, dv


vit_attention_bwd.launches = 0


class _VitAttention(torch.autograd.Function):
    """K2 forward, K3 backward; on the CPU their plain versions. Taken only
    where a gradient is wanted, so K2 keeps its row statistics for K3 (the
    CPU's backward finds its own)."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        want_stats = q.device.type == "cuda"
        res = vit_attention_op(q, k, v, sm_scale, want_stats)
        out, stats = res[0], res[1] if want_stats else None
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
    if grad_wanted(q, k, v):
        return _VitAttention.apply(q, k, v, float(sm_scale))
    return vit_attention_op(q, k, v, float(sm_scale), False)[0]


vit_attention_fused.launches = 0


# ---------------------------------------------------------------------------
# K4: softmax(norm(q) norm(k)^T scale_g + bias_g) v with a bias slice and a
# logit scale per group of rows (SwinV2's window attention). The bf16 kernel
# (csrc/window_attn.cu) keeps a window's K and V in shared memory and finds
# each row's exact max in a first pass, so its arithmetic is the TPU kernel's
# (``_kernel_biased`` :282-312) with no change: ``biased_attention_plain``
# writes it out, rounding where both round. The f32 kernel streams K and V,
# takes one pass with a running max and both products in 3xTF32: in f32
# nothing is rounded to a narrower type, so that moves the output by the
# sums' order and the split's error alone. ``biased_attention_reference`` is
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
# the order of the f32 sums in the scores and in z differs (in f32 also the
# running max's rescales and the 3xTF32 products, below 2^-19 of each
# product: tests/test_torch_tf32_split.py). SwinV2's logits
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
    lib = _build.load()
    nbytes = ctypes.c_longlong()
    err = lib.xmir_window_attn_workspace(DTYPE_CODES[q.dtype], mode, bh, n, hd,
                                         ctypes.byref(nbytes))
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: cudaError_t {err}")
    # the f32 route's k and V^T with their 3xTF32 small parts (none in bf16)
    scratch = (torch.empty(nbytes.value, dtype=torch.uint8, device=q.device) if nbytes.value
               else None)
    with torch.cuda.device(q.device):
        err = lib.xmir_window_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(), DTYPE_CODES[q.dtype],
            mode, bh, n, hd, *groups, None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err == -1:  # the bf16 launcher's own size check, no cudaError_t code
        raise ValueError(f"one window's K and V (N={n}, hd={hd}, {q.dtype}) do not fit a "
                         "block's shared memory, where the bf16 window attention kernel keeps "
                         "them")
    if err != 0:
        raise RuntimeError(f"window attention kernel launch failed: cudaError_t {err}")
    return out


def _check_biased(q, k, v, bias, scale, g_size):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q, k and v of one (BH, N, hd) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must be of one dtype, got {q.dtype}, {k.dtype} and "
                        f"{v.dtype}")
    n, n_groups = q.shape[1], bias.shape[0]
    if bias.shape != (n_groups, n, n) or scale.numel() != n_groups:
        raise ValueError(f"need bias (G, {n}, {n}) and G scales, got {tuple(bias.shape)} and "
                         f"{tuple(scale.shape)}")
    if g_size < 1:
        raise ValueError(f"g_size={g_size} must be at least 1")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    if q.device.type == "cuda" and (bias.dtype != torch.float32 or scale.dtype != torch.float32):
        raise TypeError(f"bias and scale must be float32, got {bias.dtype} and {scale.dtype}")


# ---------------------------------------------------------------------------
# K5: the backward of K4 (``_biased_bwd_pallas`` of the TPU file), for the
# whole-window folds Swin makes (``_biased_bwd_eligible``). The CUDA kernel
# (csrc/window_attn_bwd.cu) recomputes its own row max and sum from its own
# logits, as the TPU kernel does, and rounds where it rounds:
# ``biased_attention_bwd_plain`` writes that arithmetic out.

BIASED_GRAD_NAMES = ("dq", "dk", "dv", "dbias", "dscale")
MAX_BWD_WINDOW = 768


def biased_bwd_eligible(n: int, bh: int, n_groups: int, g_size: int) -> bool:
    """The TPU kernel's envelope (``_biased_bwd_eligible``): whole windows of
    at most 768 tokens, N a multiple of 8, and exactly one contiguous run of
    g_size folded rows per group (BH == G g_size), so that each group's dbias
    is a sum over its own rows in their order."""
    return n <= MAX_BWD_WINDOW and n % 8 == 0 and bh == n_groups * g_size


def biased_bwd_workspace_bytes(dtype, bh: int, n: int, hd: int, n_groups: int) -> int:
    """Bytes of the scratch K5 takes (csrc/window_attn_bwd.cu, ``Workspace``;
    ``xmir_window_attn_bwd_workspace`` gives the same): each query row's
    (m, 1 / z, c, alpha) as (BH, N, 4) f32, and in bf16 then qh, qz, gz
    (BH, N, hd) bf16, the dq sums (BH, N, hd) f32, an int32 counter per
    (row, 64-row query tile) and one per (group, query tile, 128-key unit);
    in f32 then qh and the TF32 small parts of qh and g (BH, N, hd), qz^T
    and gz^T with their small parts (BH, hd, N padded to 64), the dq sums
    (BH, N, hd), an int32 counter per (row, 32-row query tile) and one per
    (group, query tile, 64-key unit)."""
    rows = bh * n
    if dtype == torch.float32:
        n_pad, q_tiles, units = -(-n // 64) * 64, -(-n // 32), -(-n // 64)
        return (rows * 16 + 4 * rows * hd * 4 + 4 * bh * hd * n_pad * 4
                + 4 * q_tiles * (bh + n_groups * units))
    q_tiles, units = -(-n // 64), -(-n // 128)
    return rows * 16 + rows * hd * (3 * 2 + 4) + 4 * q_tiles * (bh + n_groups * units)


def biased_attention_bwd_reference(q, k, v, bias, scale, o_unused, g, g_size: int = 1,
                                   cosine: bool = False):
    """(dq, dk, dv, dbias, dscale): ``torch.autograd.grad`` of
    ``biased_attention_reference`` at cotangent g (the vjp of
    ``_biased_reference`` in the TPU file). ``o_unused`` keeps K5's
    signature."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias, scale)]
        out = biased_attention_reference(*leaves, g_size, cosine)
        return torch.autograd.grad(out, leaves, g)


def _group_sums(rows, n_groups: int):
    """Per-folded-row values (BH,) summed over each group's g_size rows in
    order (BH == G g_size): (G,)."""
    return rows.reshape(n_groups, -1).sum(dim=1)


def biased_attention_bwd_plain(q, k, v, bias, scale, o, g, g_size: int = 1,
                               cosine: bool = False):
    """Plain version of K5 on (BH, N, hd): the TPU kernel's arithmetic
    (``_bwd_kernel_biased`` :427-472), rounding where it rounds. With
    ``cosine`` qh32, kh32 = q, k times ``inv_norm`` in f32 (the sums of
    squares in ``sum_squares``' order, so that in bf16 the kernel normalises
    bit for bit alike), qh, kh those rounded to the input dtype; without it
    qh = q, kh = k. s2 = (qh kh^T) (scale_g log2 e) + bias log2 e in f32; m
    the exact row max, e = exp2(s2 - m), z the f32 sum of e: the backward's
    own statistics from its own s2 (K4 rounds q times scale log2 e before its
    product, this rounds qh alone); c = rowsum(g o), dp = g v^T in f32;
    t = e (dp - c), rounded to the input dtype (tb) before both of its
    products; dbias_g = the sum of t / z over the group's folded rows, in
    their order, f32; dqh = (tb kh) (scale_g / z); alpha = rowsum(dqh qh32);
    dq = (dqh - qh32 alpha) / |q|; qz = qh32 (scale_g / z) rounded,
    dkh = tb^T qz, beta = rowsum(dkh kh32), dk = (dkh - kh32 beta) / |k|;
    gz = g / z rounded, dv = e^T gz on e rounded; dscale_g = the sum of alpha
    over the group's rows, divided by scale_g (no extra pass: rowsum(dqh
    qh32) is scale_g rowsum(ds s_cos)). Returns (dq, dk, dv) in the input
    dtype, dbias (G, N, N) f32 and dscale in scale's shape and dtype. Needs
    ``biased_bwd_eligible``'s BH == G g_size."""
    bh, n, _ = q.shape
    n_groups = bias.shape[0]
    if bh != n_groups * g_size:
        raise ValueError(f"the backward needs BH == G g_size, got BH={bh}, G={n_groups}, "
                         f"g_size={g_size}")
    gidx = group_index(bh, n_groups, g_size, q.device)
    sc = scale.reshape(-1).float()[gidx][:, None, None]
    qf, kf = q.float(), k.float()
    if cosine:
        qinv, kinv = inv_norm(qf), inv_norm(kf)
        qh32, kh32 = qf * qinv, kf * kinv
        qh, kh = qh32.to(q.dtype).float(), kh32.to(k.dtype).float()
    else:
        qh32, kh32, qh, kh = qf, kf, qf, kf
    s2 = torch.matmul(qh, kh.transpose(-1, -2)) * (sc * LOG2E) + (bias.float() * LOG2E)[gidx]
    e = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    zinv = 1.0 / e.sum(dim=-1, keepdim=True)
    g32 = g.float()
    c = (g32 * o.float()).sum(dim=-1, keepdim=True)
    dp = torch.matmul(g32, v.float().transpose(-1, -2))
    t = e * (dp - c)
    tb = t.to(q.dtype).float()
    tz = (t * zinv).reshape(n_groups, g_size, n, n)
    dbias = tz[:, 0]
    for r in range(1, g_size):
        dbias = dbias + tz[:, r]
    szinv = sc * zinv
    dqh = torch.matmul(tb, kh) * szinv
    alpha = (dqh * qh32).sum(dim=-1, keepdim=True)
    dq = (dqh - qh32 * alpha) * qinv if cosine else dqh
    qz = (qh32 * szinv).to(q.dtype).float()
    dkh = torch.matmul(tb.transpose(-1, -2), qz)
    if cosine:
        dk = (dkh - kh32 * (dkh * kh32).sum(dim=-1, keepdim=True)) * kinv
    else:
        dk = dkh
    gz = (g32 * zinv).to(g.dtype).float()
    dv = torch.matmul(e.to(q.dtype).float().transpose(-1, -2), gz)
    dscale = _group_sums(alpha.sum(dim=(1, 2)), n_groups) / scale.reshape(-1).float()
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias,
            dscale.reshape(scale.shape).to(scale.dtype))


def biased_grad_floors(q, k, v, bias, scale, g, g_size: int = 1, cosine: bool = False):
    """The least magnitudes (for dq, dk, dv, dbias, dscale) that
    ``grad_agreement`` measures K5 against: GRAD_FLOOR of a bound on each
    gradient's terms, as ``grad_floors`` gives K3's. With D = max|g row|
    max|v row|, |dp| and |c| are at most D, so a row's ds = t / z sums to at
    most 2 D in magnitude: a term of dbias is at most 2 D; of dq at most
    scale 2 D |kh| / |q| (|kh| = 1 with the cosine, else max|k|), of dk
    likewise; of dv max|g|; of dscale, one folded row's alpha / scale, at most
    N 2 D max|s_cos| (1 with the cosine)."""
    d = torch.linalg.vector_norm(g.float(), dim=-1).max() * torch.linalg.vector_norm(
        v.float(), dim=-1).max()
    qf, kf = q.float(), k.float()
    top = scale.float().abs().max() * 2 * d
    if cosine:
        dq_t, dk_t, smax = top * inv_norm(qf).max(), top * inv_norm(kf).max(), 1.0
    else:
        qm, km = qf.abs().max(), kf.abs().max()
        dq_t, dk_t, smax = top * km, top * qm, qm * km * q.shape[-1]
    return (GRAD_FLOOR * dq_t, GRAD_FLOOR * dk_t, GRAD_FLOOR * g.float().abs().max(),
            GRAD_FLOOR * 2 * d, GRAD_FLOOR * q.shape[1] * 2 * d * smax)


# dscale is a sum over g_size N rows of alpha, whose terms cancel (alpha =
# scale rowsum(ds s_cos) with rowsum(ds) = 0): its bounds are ten times the
# others', as the JAX package's own test gives it ten times theirs
# (tests/test_vit_attn.py: 5e-4 of its largest magnitude against 5e-5).
DSCALE_BOUND_FACTOR = 10.0


def biased_grad_agreement(outs, refs, floors, dtype=None):
    """{name: ``grad_agreement`` reading} for K5's five outputs against its
    plain version's, each relative to the larger of its largest magnitude and
    its ``biased_grad_floors`` entry; dscale's shares are of its own bounds
    (DSCALE_BOUND_FACTOR times the others'). ``dtype``: the run's compute
    dtype (dbias and dscale are f32 in every run)."""
    dtype = dtype or outs[0].dtype
    readings = {}
    for name, out, ref, floor in zip(BIASED_GRAD_NAMES, outs, refs, floors):
        e = grad_agreement(out, ref, floor, dtype)
        if name == "dscale":
            e["of_bound"] /= DSCALE_BOUND_FACTOR
            e["mean_of_bound"] /= DSCALE_BOUND_FACTOR
        readings[name] = e
    return readings


def biased_attention_bwd(q, k, v, bias, scale, o, g, g_size: int = 1, cosine: bool = False):
    """K5: (dq, dk, dv, dbias, dscale) of ``biased_attention_fused`` at
    cotangent g from the saved output o. q, k, v, o, g (BH, N, hd) of one
    dtype; bias (G, N, N) and scale (G,) or (G, 1) float32; BH == G g_size.
    A CPU tensor takes ``biased_attention_bwd_plain`` (any N). On CUDA only
    inside the TPU kernel's envelope (``biased_bwd_eligible``), else it
    raises, as for anything else the kernel does not take: Swin-B's folds
    always satisfy it. On CUDA the operands are contiguous and 16-byte
    aligned, hd a multiple of 8 up to 64. Returns (dq, dk, dv) in the input dtype, dbias
    f32, dscale in scale's shape."""
    _check_biased(q, k, v, bias, scale, g_size)
    if o.shape != q.shape or g.shape != q.shape or o.dtype != q.dtype or g.dtype != q.dtype:
        raise ValueError(f"o and g must match q's shape {tuple(q.shape)} and dtype {q.dtype}")
    bh, n, hd = q.shape
    n_groups = bias.shape[0]
    tensors = (q, k, v, bias, scale, o, g)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"all operands must lie on {q.device}")
    if q.device.type == "cpu":  # the plain version takes any N
        return biased_attention_bwd_plain(q, k, v, bias, scale, o, g, g_size, cosine)
    if not biased_bwd_eligible(n, bh, n_groups, g_size):
        raise ValueError(f"K5 takes whole windows of N <= {MAX_BWD_WINDOW}, N a multiple of 8 and "
                         f"BH == G g_size; got BH={bh}, N={n}, G={n_groups}, g_size={g_size}")
    from . import _build

    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if hd % 8 or not 8 <= hd <= MAX_WINDOW_HEAD_DIM:
        raise ValueError(f"the kernel needs hd a multiple of 8 up to {MAX_WINDOW_HEAD_DIM}, "
                         f"got {hd}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("K5's operands must be contiguous and 16-byte aligned; nothing is "
                             "copied here")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(bias)
    scratch = torch.empty(biased_bwd_workspace_bytes(q.dtype, bh, n, hd, n_groups),
                          dtype=torch.uint8, device=q.device)
    stats = scratch[:bh * n * 16].view(torch.float32).view(bh, n, 4)
    with torch.cuda.device(q.device):
        err = _build.load().xmir_window_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(),
            bias.data_ptr(), scale.data_ptr(), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dbias.data_ptr(), DTYPE_CODES[q.dtype], int(cosine), bh, n, hd,
            n_groups, g_size, torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"window attention backward kernel launch failed: cudaError_t {err}")
    biased_attention_bwd.launches += 1
    # each folded row's alpha total, then each group's in order, over scale_g
    dscale = _group_sums(stats[..., 3].sum(dim=1), n_groups) / scale.reshape(-1)
    return dq, dk, dv, dbias, dscale.reshape(scale.shape)


biased_attention_bwd.launches = 0


@torch.library.custom_op("xmir::biased_attention", mutates_args=(), device_types="cuda")
def biased_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                        scale: torch.Tensor, g_size: int, cosine: bool) -> torch.Tensor:
    """K4 on CUDA tensors (``launch_window_attention``, mode 1 with the
    cosine normalisation, else 0), counted in
    ``biased_attention_fused.launches``."""
    out = launch_window_attention(q, k, v, bias, scale.reshape(-1), 1 if cosine else 0,
                                  (g_size, bias.shape[0], 1, 1, 1, 0))
    biased_attention_fused.launches += 1
    return out


@biased_attention_op.register_kernel("cpu")
def _biased_attention_cpu(q, k, v, bias, scale, g_size, cosine):
    return biased_attention_plain(q, k, v, bias, scale, g_size, cosine)


@biased_attention_op.register_fake
def _biased_attention_fake(q, k, v, bias, scale, g_size, cosine):
    torch._check(q.dim() == 3 and bias.dim() == 3)
    same_shapes(q, k, v)
    n = q.shape[1]
    torch._check(bias.shape[1] == n and bias.shape[2] == n)
    torch._check(scale.numel() == bias.shape[0])
    return torch.empty_like(v)


class _BiasedAttention(torch.autograd.Function):
    """K4 forward, K5 backward; on the CPU their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, g_size, cosine):
        out = biased_attention_op(q, k, v, bias, scale, g_size, cosine)
        ctx.g_size, ctx.cosine = g_size, cosine
        ctx.save_for_backward(q, k, v, bias, scale, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, scale, out = ctx.saved_tensors
        # autograd hands the cotangent over in whatever layout the consumer
        # left it: the kernel wants it contiguous
        grads = biased_attention_bwd(q, k, v, bias, scale, out, g.contiguous(), ctx.g_size,
                                     ctx.cosine)
        return (*grads, None, None)


def biased_attention_fused(q, k, v, bias, scale, g_size: int = 1, cosine: bool = False):
    """K4: softmax(norm(q) norm(k)^T scale_g + bias_g) v, fused, and
    differentiable in q, k, v, bias and scale (backward: K5). q, k, v
    (BH, N, hd) of one shape and dtype (float32 or bfloat16); bias (G, N, N)
    float32; scale (G,) or (G, 1) logit scales, float32; row i uses group
    (i // g_size) % G. ``cosine`` L2-normalises q and k rows inside the
    kernel (SwinV2's cosine attention, fold order (heads, windows, batch),
    bias = CPB + shift mask). Returns (BH, N, hd) in v's dtype. On CUDA:
    contiguous, 16-byte aligned, hd a multiple of 8 up to 64, one window's K
    and V within a block's shared memory (N = 576 at hd = 32 fits in both
    dtypes); the backward takes ``biased_bwd_eligible``'s folds."""
    _check_biased(q, k, v, bias, scale, g_size)
    if grad_wanted(q, k, v, bias, scale):
        return _BiasedAttention.apply(q, k, v, bias, scale, g_size, bool(cosine))
    return biased_attention_op(q, k, v, bias, scale, g_size, bool(cosine))


biased_attention_fused.launches = 0
