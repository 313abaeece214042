"""Exact fused similarity + top-k (K1): the CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``xmir_tpu/ops/topk_pallas.py::fused_topk_scores``: the exact top-k of
``q @ g.T + bias[row]`` per query, sorted by value descending with ties to the
lower gallery row; slots no row filled are (-inf, 0).

``fused_topk_scores`` takes any 1 <= k <= N. For CUDA tensors it launches
``csrc/topk.cu`` (K1: a sorted per-query buffer in shared memory) for
k <= 1024 and counts the launch in ``fused_topk_scores.launches``; above that
it hands over to ``select_topk_scores`` (K1': ``csrc/topk_select.cu``, 64-bit
keys in device memory, a radix select and a sort per query), which counts in
``select_topk_scores.launches``. Both give the same values and the same
order. A tensor on the CPU takes ``topk_scores_reference`` instead; any other
device raises. There is no fallback from a kernel to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

BUFFER_K = 1024  # the largest k whose per-query buffer fits shared memory (K1)
# K1' keeps 8 bytes per (query, gallery row) and per (query, slot of k rounded
# up to a power of two) in device memory; it walks the queries in chunks so
# that these two allocations stay within SCRATCH_BYTES in all.
SCRATCH_BYTES = 2 ** 31
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def topk_scores_reference(q, g, bias, k: int):
    """Plain version: full (Q, N) scores, a stable descending sort, the first
    k. Products and sums in f32 (bf16 inputs are widened exactly)."""
    s = torch.matmul(q.float(), g.float().T) + bias.float()
    vals, idxs = torch.sort(s, dim=1, descending=True, stable=True)
    vals = vals[:, :k].contiguous()
    idxs = idxs[:, :k].to(torch.int32)
    # the stable sort leaves a masked row's own index in a -inf slot; the
    # kernels report (-inf, 0) there
    idxs = torch.where(torch.isneginf(vals), torch.zeros_like(idxs), idxs)
    return vals, idxs


def launch_plan(n_queries: int, n_rows: int, k: int, n_sms: int):
    """(block_queries, n_splits, rows_per_split) that csrc/topk.cu launches
    for these sizes on a card with n_sms SMs. The plan is made in the CUDA
    source only, so this builds and loads the kernel library."""
    from . import _build

    out = [ctypes.c_int() for _ in range(3)]
    err = _build.load().xmir_topk_plan(n_queries, n_rows, k, n_sms,
                                       *(ctypes.addressof(o) for o in out))
    if err != 0:
        raise ValueError(f"no top-k launch plan for Q={n_queries} N={n_rows} k={k} "
                         f"on {n_sms} SMs: cudaError_t {err}")
    return tuple(o.value for o in out)


def _check(q, g, bias, k: int):
    if q.dim() != 2 or g.dim() != 2 or q.shape[1] != g.shape[1]:
        raise ValueError(f"need q (Q, D) and g (N, D), got {tuple(q.shape)} and {tuple(g.shape)}")
    n = g.shape[0]
    if bias.shape != (n,):
        raise ValueError(f"bias must be ({n},), got {tuple(bias.shape)}")
    if k > n:
        raise ValueError(f"k={k} > gallery size {n}")
    if k < 1:
        raise ValueError(f"k={k} must be at least 1")
    if q.dtype != g.dtype or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q and g must both be float32 or bfloat16, got {q.dtype} and {g.dtype}")
    if bias.dtype != torch.float32:
        raise TypeError(f"bias must be float32, got {bias.dtype}")
    if not (q.device == g.device == bias.device):
        raise ValueError(f"q, g and bias lie on {q.device}, {g.device} and {bias.device}")


def fused_topk_scores(q, g, bias, k: int):
    """Exact top-k of ``q @ g.T + bias`` -> (vals (Q, k) f32, idxs (Q, k) i32).

    q (Q, D) and g (N, D) are both float32 or both bfloat16 (bf16 products are
    accumulated in f32), bias (N,) float32, all on one device; 1 <= k <= N.
    """
    _check(q, g, bias, k)
    if q.device.type == "cpu":
        return topk_scores_reference(q, g, bias, k)
    if q.device.type != "cuda":
        raise ValueError(f"no top-k kernel for device {q.device}")
    if not (q.is_contiguous() and g.is_contiguous() and bias.is_contiguous()):
        raise ValueError("q, g and bias must be contiguous")
    if k > BUFFER_K:
        return select_topk_scores(q, g, bias, k)
    from . import _build

    n_q, n = q.shape[0], g.shape[0]
    vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    idxs = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    if n_q == 0:
        return vals, idxs
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, splits, _ = launch_plan(n_q, n, k, n_sms)
    part_v = torch.empty((n_q, splits, k), dtype=torch.float32, device=q.device)
    part_i = torch.empty((n_q, splits, k), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        qt = q.t().contiguous()  # the kernel reads queries depth-major
        err = _build.load().xmir_topk(
            qt.data_ptr(), g.data_ptr(), bias.data_ptr(), _DTYPE_CODES[q.dtype],
            n_q, n, q.shape[1], k, n_sms,
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idxs.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"top-k kernel launch failed: cudaError_t {err}")
    fused_topk_scores.launches += 1
    return vals, idxs


fused_topk_scores.launches = 0


def select_topk_scores(q, g, bias, k: int):
    """K1': ``fused_topk_scores`` for CUDA tensors at any 1 <= k <= N, meant
    for k above ``BUFFER_K``. Allocates, per chunk of queries, 8 N bytes of
    keys and 8 k' bytes of sort buffer a query (k' the power of two at or
    above k), at most ``SCRATCH_BYTES`` in all; one query must fit."""
    _check(q, g, bias, k)
    if q.device.type != "cuda":
        raise ValueError(f"the select kernel runs on CUDA tensors, got {q.device}")
    if not (q.is_contiguous() and g.is_contiguous() and bias.is_contiguous()):
        raise ValueError("q, g and bias must be contiguous")
    from . import _build

    n_q, n = q.shape[0], g.shape[0]
    vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    idxs = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    if n_q == 0:
        return vals, idxs
    k_pad = max(2, 1 << (k - 1).bit_length())
    chunk = min(n_q, SCRATCH_BYTES // (8 * (n + k_pad)))
    if chunk < 1:
        raise ValueError(f"one query's keys and sort buffer ({8 * (n + k_pad)} bytes at N={n}, "
                         f"k={k}) exceed SCRATCH_BYTES={SCRATCH_BYTES}")
    keys = torch.empty((chunk, n), dtype=torch.int64, device=q.device)
    buf = torch.empty((chunk, k_pad), dtype=torch.int64, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for q0 in range(0, n_q, chunk):
            rows = min(chunk, n_q - q0)
            err = _build.load().xmir_topk_select(
                q[q0:q0 + rows].data_ptr(), g.data_ptr(), bias.data_ptr(),
                _DTYPE_CODES[q.dtype], rows, n, q.shape[1], k, k_pad, keys.data_ptr(),
                buf.data_ptr(), vals[q0:q0 + rows].data_ptr(), idxs[q0:q0 + rows].data_ptr(),
                stream,
            )
            if err != 0:
                raise RuntimeError(f"top-k select kernel launch failed: cudaError_t {err}")
    select_topk_scores.launches += 1
    return vals, idxs


select_topk_scores.launches = 0
