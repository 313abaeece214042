"""Exact fused similarity + top-k (K1, K1'): the CUDA kernels' wrapper and
their plain PyTorch version.

Port of ``xmir_tpu/ops/topk_pallas.py::fused_topk_scores``: the exact top-k of
``q @ g.T + bias[row]`` per query, sorted by value descending with ties to the
lower gallery row; slots no row filled are (-inf, 0).

``fused_topk_scores`` takes any 1 <= k <= N. For CUDA tensors it asks the CUDA
plan (``launch_plan``) for a route: k <= 32 runs ``csrc/topk.cu``'s fused body
(K1: a sorted per-query buffer in shared memory, fed from the score
producer's accumulators), counted in ``fused_topk_scores.launches``; above,
``select_topk_scores`` runs the select route of ``csrc/topk_select.cu`` (K1':
score words, then a radix select and sort, or at k = N a stable sort),
counted in ``select_topk_scores.launches``. Both routes run one score producer
(``csrc/topk_scores.cuh``: bf16 on wgmma, f32 as 3xTF32 on wgmma), so they
give the same values and the same order. A tensor on the CPU takes
``topk_scores_reference`` instead; any other device raises. There is no
fallback from a kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

FUSED_K = 32  # the largest k of the fused route (csrc/topk_scores.cuh: kFusedMaxK)
ROUTE_FUSED, ROUTE_SELECT = 0, 1
# The select route keeps 4 bytes per (query, gallery row) and 16 per (query,
# slot of k) in device memory (_lists_bytes); it walks the queries in chunks
# so that these stay within SCRATCH_BYTES in all.
SCRATCH_BYTES = 2 ** 31
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# f32 scores come from 3xTF32 products (csrc/topk_scores.cuh): each within
# F32_SCORE_C * 2^-22 * sum_d |q_d g_d| (+ 2^-21 |bias|) of the exact score.
# In these units, on random normal rows at D = 1024: IEEE f32 and 3xTF32
# summed in order in f32 read below 2 (numpy, tests/test_torch_topk.py), the
# kernel about 1 (its depth in groups of 128 on the tensor cores, the groups
# added in f32: chip_smoke.py phase 3 on an NVIDIA H100; one accumulator over
# all of D read ~10, worse on near-collinear rows); dropping one cross
# product (2xTF32) reads ~30 at the median and ~170 at the worst in numpy,
# over 1,000 on the card, one TF32 product more (chip_faults.py): C sits
# between.
F32_SCORE_C = 32.0


class TopkPlan(NamedTuple):
    """The CUDA plan for K1 (``xmir_topk_plan`` in csrc/topk.cu)."""
    block_queries: int  # queries a block: 64 per consumer warpgroup
    n_splits: int  # gallery splits, merged in split order
    rows_per_split: int  # a multiple of tile_rows: the splits' edges
    route: int  # ROUTE_FUSED (k <= FUSED_K) or ROUTE_SELECT
    tile_rows: int  # gallery rows a tile (the wgmma's N): 256 bf16, 128 f32
    stages: int  # ring stages of the score producer
    depth: int  # D, or D padded to a row of a multiple of 16 bytes
    smem: int  # dynamic shared memory of the score kernel, bytes
    wgs: int  # consumer warpgroups a block


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


def f32_score_error(q, g, bias, vals, idxs, chunk: int = 256):
    """How far f32 top-k values lie from their exact scores: the largest
    |vals - (q . g[idxs] + bias[idxs])| over its bound F32_SCORE_C 2^-22
    sum_d |q_d g[idxs]_d| + 2^-21 |bias[idxs]|, all in float64 (above 1: past
    the bound), and the largest absolute error. -inf slots count when both
    sides are -inf."""
    worst, worst_abs = 0.0, 0.0
    for q0 in range(0, q.shape[0], chunk):
        ids = idxs[q0:q0 + chunk].long()
        prod = q[q0:q0 + chunk].double()[:, None, :] * g.double()[ids]
        b = bias.double()[ids]
        exact = prod.sum(-1) + b
        v = vals[q0:q0 + chunk].double()
        both_inf = torch.isneginf(v) & torch.isneginf(exact)
        err = torch.where(both_inf, torch.zeros_like(v), (v - exact).abs())
        bound = 2.0 ** -22 * (F32_SCORE_C * prod.abs().sum(-1) + 2 * b.abs().nan_to_num(0, 0, 0))
        ratio = torch.where(err == 0, torch.zeros_like(err), err / bound)
        worst = max(worst, ratio.max().item())
        worst_abs = max(worst_abs, err.max().item())
    return {"of_bound": worst, "max_abs_err": worst_abs}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(n_queries: int, n_rows: int, k: int, n_sms: int, depth: int, dtype) -> TopkPlan:
    """The plan csrc/topk.cu takes for these sizes on a card with n_sms SMs.
    It is made in the CUDA source only, so this builds and loads the kernel
    library."""
    from . import _build

    if dtype not in _DTYPE_CODES:
        raise TypeError(f"no top-k kernel for {dtype}")
    out = (ctypes.c_int * 9)()
    err = _build.load().xmir_topk_plan(n_queries, n_rows, depth, k, _DTYPE_CODES[dtype], n_sms,
                                       ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"no top-k launch plan for Q={n_queries} N={n_rows} D={depth} k={k} "
                         f"on {n_sms} SMs: cudaError_t {err}")
    return TopkPlan(*out)


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


def _scratch(n_q: int, n: int, d: int, depth: int, dtype, device):
    """The score producer's scratch (csrc/topk_scores.cuh, launch_scores): q
    and g with rows padded to ``depth`` where the plan pads D, then in f32
    the queries' small parts (3xTF32)."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = ((n_q + n) * depth * size if depth != d else 0) + (
        n_q * depth * 4 if dtype == torch.float32 else 0)
    if nbytes == 0:
        return None
    return torch.empty((nbytes,), dtype=torch.uint8, device=device)


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
    from . import _build

    n_q, n, d = q.shape[0], g.shape[0], q.shape[1]
    vals = torch.empty((n_q, k), dtype=torch.float32, device=q.device)
    idxs = torch.empty((n_q, k), dtype=torch.int32, device=q.device)
    if n_q == 0:
        return vals, idxs
    n_sms = _sm_count(q.device.index if q.device.index is not None else torch.cuda.current_device())
    plan = launch_plan(n_q, n, k, n_sms, d, q.dtype)
    if plan.route == ROUTE_SELECT:
        select_topk_scores(q, g, bias, k, n_sms, plan.depth, vals, idxs)
        return vals, idxs
    scratch = _scratch(n_q, n, d, plan.depth, q.dtype, q.device)
    part_v, part_i = vals, idxs  # one split: the kernel writes the result
    if plan.n_splits > 1:
        part_v = torch.empty((n_q, plan.n_splits, k), dtype=torch.float32, device=q.device)
        part_i = torch.empty((n_q, plan.n_splits, k), dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.load().xmir_topk(
            q.data_ptr(), g.data_ptr(), bias.data_ptr(), _DTYPE_CODES[q.dtype],
            n_q, n, d, k, n_sms, None if scratch is None else scratch.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), idxs.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"top-k kernel launch failed: cudaError_t {err}")
    fused_topk_scores.launches += 1
    return vals, idxs


fused_topk_scores.launches = 0


def _lists_bytes(n: int, k: int) -> int:
    """A query's sort lists in the select route: two of k (word, row) pairs,
    and for the full ranking (k = n) the digit counts of its 4096-entry
    chunks (csrc/topk_select.cu)."""
    return 16 * k + (256 * 4 * -(-n // 4096) if k == n else 0)


def select_topk_scores(q, g, bias, k: int, n_sms: int, depth: int, vals, idxs):
    """K1', the select route of ``fused_topk_scores`` (csrc/topk_select.cu),
    which checks the arguments and takes the plan's ``depth``: writes the
    top-k into vals / idxs. Walks the queries in chunks whose score words (4 N
    bytes a query) and sort lists (_lists_bytes) stay within SCRATCH_BYTES;
    one query must fit."""
    from . import _build

    if q.device.type != "cuda":
        raise ValueError(f"the select kernel runs on CUDA tensors, got {q.device}")
    n_q, n, d = q.shape[0], g.shape[0], q.shape[1]
    per_query = 4 * n + _lists_bytes(n, k)
    chunk = min(n_q, SCRATCH_BYTES // per_query)
    if chunk < 1:
        raise ValueError(f"one query's words and sort lists ({per_query} bytes at N={n}, "
                         f"k={k}) exceed SCRATCH_BYTES={SCRATCH_BYTES}")
    words = torch.empty((chunk, n), dtype=torch.int32, device=q.device)
    lists = torch.empty((chunk, _lists_bytes(n, k) // 4), dtype=torch.int32, device=q.device)
    scratch = _scratch(chunk, n, d, depth, q.dtype, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        for q0 in range(0, n_q, chunk):
            rows = min(chunk, n_q - q0)
            err = _build.load().xmir_topk_select(
                q[q0:q0 + rows].data_ptr(), g.data_ptr(), bias.data_ptr(),
                _DTYPE_CODES[q.dtype], rows, n, d, k, n_sms,
                None if scratch is None else scratch.data_ptr(), words.data_ptr(),
                lists.data_ptr(), vals[q0:q0 + rows].data_ptr(), idxs[q0:q0 + rows].data_ptr(),
                stream,
            )
            if err != 0:
                raise RuntimeError(f"top-k select kernel launch failed: cudaError_t {err}")
    select_topk_scores.launches += 1


select_topk_scores.launches = 0
