"""LayerNorm fused into the following projection (K7: LN -> qkv, head-major;
K8: LN -> dense with an optional tanh-GELU): the CUDA kernels' wrappers and
their plain PyTorch versions.

Port of ``xmir_tpu/ops/ln_dense_pallas.py``. In bf16 both normalise each
row once into a scratch y (``ln_rows``) that a persistent wgmma product
reads by the copy engine (csrc/ln_dense.cu): K7 with both warpgroups on a
pair of 64-row units and stores straight into the heads, K8 with the two
warpgroups taking its items in turns, so that one's GELU epilogue and
row-major stores run under the other's products. In f32 both read a tile of
the residual stream once, normalise it on its way into shared memory and
feed a tile loop from there. Both keep the TPU kernels' rounding points:
LayerNorm in f32 with the fast variance, rounded to x's dtype before the
product; the weight in x's dtype; f32 accumulation; the bias added in f32;
tanh-GELU in f32; one rounding to the output dtype.

``ln_qkv_fused`` (K7) and ``ln_dense_fused`` (K8) launch
``csrc/ln_dense.cu`` for CUDA tensors and count each call in their
``launches``. A tensor on the CPU takes the plain version instead; any other
device raises. There is no fallback from the kernel to the plain version.
Both calls are differentiable (``torch.autograd.Function``s), with the JAX
package's backwards, which are plain tensor code there too: K7's is the
analytic ``ln_qkv_backward`` (two matrix products and the closed-form
LayerNorm chain), K8's differentiates ``ln_dense_reference`` on the saved
inputs. Both forwards are custom ops, ``xmir::ln_qkv`` and ``xmir::ln_dense``
(see ops/convnext_block.py for what their parts are); a call that wants no
gradient calls its op without the Function.

Weights are in torch's ``nn.Linear`` layout (out, in): ``w`` is (3C, C) for
K7, rows ordered q | k | v with the heads inside each (timm's ``qkv.weight``,
the transpose of the JAX package's (C, 3C) kernel), and (M, C) for K8.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from typing import Optional, Tuple

from .convnext_block import (  # noqa: F401  (agreement, agrees: this module's bounds too)
    DTYPE_CODES, LN_EPS, agreement, agrees, grad_wanted, layer_norm, linear_f32, same_shapes)


def fused_ln_enabled(dtype, device) -> bool:
    """Whether a block whose compute dtype is ``dtype`` on ``device`` folds its
    LayerNorms into the projections: bf16 on CUDA (the JAX package: bf16 on
    the TPU). ``XMIR_FUSED_LN`` = 0 or 1 overrides, as in the JAX package."""
    flag = os.environ.get("XMIR_FUSED_LN", "")
    if flag == "0":
        return False
    if flag == "1":
        return True
    return dtype == torch.bfloat16 and torch.device(device).type == "cuda"


def ln_qkv_eligible(c: int, head_dim: int) -> bool:
    """The widths the model sends to K7, the JAX package's rule: a channel
    width that is a multiple of 128 and a head of 32, 64 or 128 (the DINOv2 /
    ViT family); a head of 72 (SigLIP SO400M, C = 1152) only under
    ``XMIR_FUSED_LN_QKV72=1``, off by default as in the JAX package, where the
    fusion lost to the unfused path on the TPU."""
    if head_dim == 72:
        return c % 128 == 0 and os.environ.get("XMIR_FUSED_LN_QKV72") == "1"
    return c % 128 == 0 and head_dim in (32, 64, 128)


def _ln_rows(x, lns, lnb, eps):
    """LayerNorm of x's rows in f32 (fast variance), rounded to x's dtype."""
    return layer_norm(x, lns.float(), lnb.float(), eps).to(x.dtype)


def ln_qkv_reference(x, lns, lnb, w, b, num_heads: int, eps: float = LN_EPS):
    """Plain version of K7 (``_ln_qkv_reference`` of the TPU file): x
    (B, N, C), w (3C, C), b (3C,) or None. Returns q, k, v each
    (B, H, N, hd) in x's dtype."""
    bsz, n, c = x.shape
    qkv = linear_f32(_ln_rows(x, lns, lnb, eps), w.to(x.dtype))
    if b is not None:
        qkv = qkv + b.float()
    qkv = qkv.to(x.dtype).reshape(bsz, n, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    return qkv[0].contiguous(), qkv[1].contiguous(), qkv[2].contiguous()


def ln_dense_reference(x, lns, lnb, w, b, eps: float = LN_EPS, act: str = ""):
    """Plain version of K8 (``_ln_dense_reference``): x (R, C), w (M, C), b
    (M,) or None; ``act`` "" or "gelu" (the tanh form). Returns (R, M) in
    x's dtype."""
    out = linear_f32(_ln_rows(x, lns, lnb, eps), w.to(x.dtype))
    if b is not None:
        out = out + b.float()
    if act == "gelu":
        out = F.gelu(out, approximate="tanh")
    return out.to(x.dtype)


# How far K7 / K8 may lie from their plain versions is K9 / K11's bound
# (``agreement`` and ``agrees`` of ops/convnext_block.py): the plain versions
# round where the kernels round, so only the f32 summation order (and,
# through it, a rare flip of the LayerNorm output's rounding) differs. A
# LayerNorm output left unrounded or an erf GELU for the tanh form moves the
# bf16 average several times past its bound (PERF.md).


def _check(x, lns, lnb, w, b, c, m):
    if lns.shape != (c,) or lnb.shape != (c,):
        raise ValueError(f"lns and lnb must be ({c},), got {tuple(lns.shape)} and "
                         f"{tuple(lnb.shape)}")
    if w.shape != (m, c):
        raise ValueError(f"w must be ({m}, {c}) (torch Linear layout), got {tuple(w.shape)}")
    if b is not None and b.shape != (m,):
        raise ValueError(f"b must be ({m},), got {tuple(b.shape)}")
    tensors = [t for t in (x, lns, lnb, w, b) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"all operands must lie on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LN -> dense kernel for device {x.device}")


def _cuda_operands(x, lns, lnb, w, b):
    """The kernel's view of the operands: dtype, alignment and contiguity
    checked; the f32 vectors made."""
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or both bfloat16, got {x.dtype} and "
                        f"{w.dtype}")
    if x.shape[-1] % 8:
        raise ValueError(f"the kernel needs C to be a multiple of 8, got {x.shape[-1]}")
    vecs = [None if t is None else t.detach().float().contiguous() for t in (lns, lnb, b)]
    for t in (x, w, *(v for v in vecs if v is not None)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the kernel's operands must be contiguous and 16-byte aligned "
                             "(the copy engine reads x's rows and w by 16-byte boxes); nothing "
                             "is copied here")
    return vecs


def _launch_ln_qkv(x, lns, lnb, w, b, num_heads: int, eps: float):
    """Launches K7 on CUDA operands; checks what the kernel needs."""
    from . import _build

    bsz, n, c = x.shape
    if eps != LN_EPS:
        raise ValueError(f"the kernel's eps is {LN_EPS}, got {eps}")
    head_dim = c // num_heads
    if head_dim % 2:
        raise ValueError(f"the kernel needs an even head_dim, got {head_dim}")
    lns32, lnb32, b32 = _cuda_operands(x, lns, lnb, w, b)
    q, k, v = (torch.empty((bsz, num_heads, n, head_dim), dtype=x.dtype, device=x.device)
               for _ in range(3))
    # bf16 normalises each row once into y, which the product reads by the copy engine
    y = torch.empty_like(x) if x.dtype == torch.bfloat16 else None
    with torch.cuda.device(x.device):
        err = _build.load().xmir_ln_qkv(
            x.data_ptr(), lns32.data_ptr(), lnb32.data_ptr(), w.data_ptr(),
            None if b32 is None else b32.data_ptr(), DTYPE_CODES[x.dtype], bsz, n, c,
            num_heads, None if y is None else y.data_ptr(), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"LN -> qkv kernel launch failed: cudaError_t {err}")
    ln_qkv_fused.launches += 1
    return q, k, v


def ln_qkv_backward(x, lns, lnb, w, b, gq, gk, gv, eps: float = LN_EPS):
    """Analytic backward of K7 (``_ln_qkv_bwd`` of the TPU file), plain tensor
    code: (dx, dlns, dlnb, dw, db) from the head-major cotangents gq, gk, gv
    (B, H, N, hd). Two matrix products (dw, dy) and the closed-form LayerNorm
    chain on rows recomputed from the saved x. Rounding points: y is
    recomputed in f32 with the fast variance and rounded to x's dtype before
    dw, the cotangent cast to y's dtype for it; both products accumulate in
    f32; dlns, dlnb and db are summed in f32; dx comes from the f32 dy. w is
    (3C, C), so dw is the transpose of the JAX package's."""
    bsz, n, c = x.shape
    gcat = torch.cat([t.transpose(1, 2).reshape(bsz, n, c) for t in (gq, gk, gv)], dim=-1)
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * inv
    y = (xhat * lns.float() + lnb.float()).to(x.dtype)
    db = None if b is None else gcat.float().sum(dim=(0, 1)).to(b.dtype)
    dw = linear_f32(gcat.to(y.dtype).reshape(-1, 3 * c).t(), y.reshape(-1, c).t()).to(w.dtype)
    dy = linear_f32(gcat, w.to(gcat.dtype).t())
    dlns = (dy * xhat).sum(dim=(0, 1)).to(lns.dtype)
    dlnb = dy.sum(dim=(0, 1)).to(lnb.dtype)
    dxhat = dy * lns.float()
    dx = inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dlns, dlnb, dw, db


@torch.library.custom_op("xmir::ln_qkv", mutates_args=(), device_types="cuda")
def ln_qkv_op(x: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor], num_heads: int,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 on CUDA operands (``_launch_ln_qkv``)."""
    return _launch_ln_qkv(x, lns, lnb, w, b, num_heads, eps)


@ln_qkv_op.register_kernel("cpu")
def _ln_qkv_cpu(x, lns, lnb, w, b, num_heads, eps):
    # an op's outputs may not share storage: q, k and v can be views of one
    # product (where B = N = 1 the head-major split moves no element)
    return tuple(t.clone() for t in ln_qkv_reference(x, lns, lnb, w, b, num_heads, eps))


@ln_qkv_op.register_fake
def _ln_qkv_fake(x, lns, lnb, w, b, num_heads, eps):
    torch._check(x.dim() == 3)
    bsz, n, c = x.shape
    torch._check(c % num_heads == 0)
    torch._check(w.dim() == 2 and w.shape[0] == 3 * c and w.shape[1] == c)
    same_shapes(lns, lnb)
    torch._check(lns.dim() == 1 and lns.shape[0] == c)
    return tuple(x.new_empty((bsz, num_heads, n, c // num_heads)) for _ in range(3))


class _LnQkv(torch.autograd.Function):
    """K7 forward (CPU: its plain version), ``ln_qkv_backward`` backward."""

    @staticmethod
    def forward(ctx, x, lns, lnb, w, b, num_heads, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, lns, lnb, w, b)
        return ln_qkv_op(x, lns, lnb, w, b, num_heads, eps)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        x, lns, lnb, w, b = ctx.saved_tensors
        return (*ln_qkv_backward(x, lns, lnb, w, b, gq, gk, gv, ctx.eps), None, None)


def ln_qkv_fused(x, lns, lnb, w, b, num_heads: int, eps: float = LN_EPS):
    """K7: LayerNorm(x) . w^T + b, stored head-major, differentiable in x,
    lns, lnb, w and b. x (B, N, C); lns, lnb (C,); w (3C, C) in x's dtype; b
    (3C,) or None. Returns q, k, v each (B, H, N, hd) in x's dtype,
    contiguous."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C), got {tuple(x.shape)}")
    c = x.shape[2]
    if num_heads < 1 or c % num_heads:
        raise ValueError(f"C={c} does not split into {num_heads} heads")
    _check(x, lns, lnb, w, b, c, 3 * c)
    if grad_wanted(x, lns, lnb, w, b):
        return _LnQkv.apply(x, lns, lnb, w, b, num_heads, eps)
    return ln_qkv_op(x, lns, lnb, w, b, num_heads, eps)


def _launch_ln_dense(x, lns, lnb, w, b, eps: float, act: str):
    """Launches K8 on CUDA operands; checks what the kernel needs."""
    from . import _build

    rows, c = x.shape
    m = w.shape[0]
    if eps != LN_EPS:
        raise ValueError(f"the kernel's eps is {LN_EPS}, got {eps}")
    if m % 2:
        raise ValueError(f"the kernel needs an even output width, got {m}")
    lns32, lnb32, b32 = _cuda_operands(x, lns, lnb, w, b)
    out = torch.empty((rows, m), dtype=x.dtype, device=x.device)
    # bf16 normalises each row once into y, which the product reads by the copy engine
    y = torch.empty_like(x) if x.dtype == torch.bfloat16 else None
    with torch.cuda.device(x.device):
        err = _build.load().xmir_ln_dense(
            x.data_ptr(), lns32.data_ptr(), lnb32.data_ptr(), w.data_ptr(),
            None if b32 is None else b32.data_ptr(), DTYPE_CODES[x.dtype], rows, c, m,
            int(act == "gelu"), None if y is None else y.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"LN -> dense kernel launch failed: cudaError_t {err}")
    ln_dense_fused.launches += 1
    return out


@torch.library.custom_op("xmir::ln_dense", mutates_args=(), device_types="cuda")
def ln_dense_op(x: torch.Tensor, lns: torch.Tensor, lnb: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor], eps: float, act: str) -> torch.Tensor:
    """K8 on CUDA operands (``_launch_ln_dense``)."""
    return _launch_ln_dense(x, lns, lnb, w, b, eps, act)


@ln_dense_op.register_kernel("cpu")
def _ln_dense_cpu(x, lns, lnb, w, b, eps, act):
    return ln_dense_reference(x, lns, lnb, w, b, eps, act)


@ln_dense_op.register_fake
def _ln_dense_fake(x, lns, lnb, w, b, eps, act):
    torch._check(x.dim() == 2 and w.dim() == 2 and w.shape[1] == x.shape[1])
    same_shapes(lns, lnb)
    torch._check(lns.dim() == 1 and lns.shape[0] == x.shape[1])
    return x.new_empty((x.shape[0], w.shape[0]))


class _LnDense(torch.autograd.Function):
    """K8 forward (CPU: its plain version); the backward differentiates
    ``ln_dense_reference`` on the saved inputs (``_ln_dense_bwd`` of the TPU
    file)."""

    @staticmethod
    def forward(ctx, x, lns, lnb, w, b, eps, act):
        ctx.eps, ctx.act = eps, act
        ctx.save_for_backward(x, lns, lnb, w, b)
        return ln_dense_op(x, lns, lnb, w, b, eps, act)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(True) for t in saved]
            out = ln_dense_reference(*leaves, ctx.eps, ctx.act)
            wanted = [i for i, t in enumerate(leaves)
                      if t is not None and ctx.needs_input_grad[i]]
            grads = torch.autograd.grad(out, [leaves[i] for i in wanted], g)
        full = [None] * 5
        for i, grad in zip(wanted, grads):
            full[i] = grad
        return (*full, None, None)


def ln_dense_fused(x, lns, lnb, w, b, eps: float = LN_EPS, act: str = ""):
    """K8: LayerNorm(x) . w^T + b, then the tanh-GELU when ``act`` is "gelu",
    differentiable in x, lns, lnb, w and b. x (R, C); lns, lnb (C,); w (M, C)
    in x's dtype; b (M,) or None. Returns (R, M) in x's dtype."""
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), got {tuple(x.shape)}")
    if act not in ("", "gelu"):
        raise ValueError(f"act must be '' or 'gelu', got {act!r}")
    _check(x, lns, lnb, w, b, x.shape[1], w.shape[0])
    if grad_wanted(x, lns, lnb, w, b):
        return _LnDense.apply(x, lns, lnb, w, b, eps, act)
    return ln_dense_op(x, lns, lnb, w, b, eps, act)


ln_qkv_fused.launches = 0
ln_dense_fused.launches = 0
