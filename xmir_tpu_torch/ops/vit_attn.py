"""Fused attention for the plain ViT towers (K2): the CUDA kernel's wrapper and
its plain PyTorch versions.

Port of ``xmir_tpu/ops/vit_attn_pallas.py``, the unbiased forward only.
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
