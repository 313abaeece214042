"""Drives the PyTorch port (xmir_tpu_torch) once on an NVIDIA card and checks it.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failure:
  1. device  the card's name and power limit (nvidia-smi)
  2. build   the CUDA kernels, from the sources in this checkout (one nvcc per
             source, all started together)
  3. kernel  K1 (csrc/topk.cu) against its plain PyTorch version on the card:
             f32 and bf16, the slice's own shape (64 x 256 x 1024, k 10) and
             k in {1, 10, 128, 129, 1024}, ragged N, D in {32, 96, 1024},
             valid rows < k; bit-equal on small-integer inputs, within 1e-5
             (f32) / 1e-2 (bf16) on random ones; all four metrics through
             fused_topk
  4. slice   the ingest -> query CLIs with DenseNet121 at full width (224
             crop, 1024-d) on COVIDx-format PNGs, through K1; its hits
             against the plain top-k on the same device embeddings, and the
             built gallery against queries whose scores spread
  5. serving exact top-10 of 1024 queries over 100,000 x 1024, f32 and bf16:
             kernel and plain version timed with CUDA events, in turns
  6. kernel  K9 and K11 (csrc/convnext_block.cu) against their plain versions,
             f32 and bf16, random LN / GRN / biases: ConvNeXtV2-Base's four
             stage shapes at 384 px (B = 2), ragged rows (7x7, 25x25), and 144
             / 576 rows at B = 3 (128-row tiles would straddle images if rows
             were flattened over the batch); within the bounds of
             ops/convnext_block.py::agreement (f32 3e-5 (1 + |ref|); bf16 two
             steps + 2^-7 per output, 0.05 steps on average); two runs
             bit-equal
  7. slice   the ingest -> query CLIs with ConvNeXtV2-Base at full width (432
             decode, 384 crop, 1024-d) under XMIR_FUSED_MLP=1 and --resume of a
             timm-layout .pt with random nonzero LN / GRN tensors: K9 in every
             block of every batch and K11 in none, K1 for the search, the hits
             against the plain top-k, and the query embeddings against the
             same model run with the block tail's plain version
  8. rates   K9 and K11 at the four stage shapes at B = 32, f32 and bf16,
             against their plain versions (held to the bounds of phase 6
             first); ConvNeXtV2-Base bf16 (weights and
             input) batch 32 at 384 px with the kernels, with the tail's plain
             version, and on the plain path, the kernels' embeddings held to
             both; CUDA events, in turns
  9. kernel  K2 (csrc/vit_attn.cu), K7 and K8 (csrc/ln_dense.cu) against their
             plain versions, f32 and bf16: the DINOv2 shape (N = 1370, hd = 64,
             C = 768, 12 heads) at B = 2; ragged and tiny N (1, 7, 197, 257,
             729, 1024); hd in {16, 32, 64, 72, 128} for K2 and {32, 64, 128}
             for K7; K8 with and without GELU and bias; rows whose every score
             is very negative and rows with one dominant score; within the
             bounds of ops/vit_attn.py::agreement and
             ops/convnext_block.py::agreement; two runs bit-equal
 10. slice   the ingest -> query CLIs with DINOv2 ViT-B/14 at full width (518
             px bicubic decode, 1370 tokens, 12 blocks, 768-d) under
             XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1 and --resume of a timm-layout
             .pt with random nonzero LN / LayerScale / biases: K7 and K2 in
             every block of every batch, K8 in none, K1 for the search; then
             again with XMIR_FUSED_LN_MLP=1: K8 in every block too; the hits
             against the plain top-k, and the query embeddings against the
             same model with the kernels' plain versions and on the eager path
 11. rates   K2, K7, K8 at the DINOv2 shape at B = 16, bf16 and f32, against
             their plain versions (held to the bounds of phase 9 first) and,
             for K2, one scaled_dot_product_attention call (timed here, used
             nowhere in the port); DINOv2 ViT-B/14 bf16 (weights and input)
             batch 16 at 518 px with the kernels, with K8 too, with the
             kernels' plain versions, and on the eager path, the kernels'
             embeddings held to the last two; CUDA events, in turns
 12. kernel  K4 and K6 (csrc/window_attn.cu) against their plain versions, f32
             and bf16: every SwinV2-Base shape at 384 px (stages 1-4, shifted
             and unshifted, B = 16), ragged N (140, 77, 1), groups that wrap,
             every logit scale at its clamp of 100 with a -100 mask that
             leaves rows few live keys, rows of tiny norm; within the bounds
             of ops/vit_attn.py::window_agreement; two runs bit-equal
 13. kernel  K1' (csrc/topk_select.cu) against the plain top-k: bit-equal on
             integer inputs for k in {1025, 2048, 4096, N} at N in {4096,
             100,000}, f32 and bf16, and its first 1024 entries against K1's
 14. slice   the ingest -> query CLIs with SwinV2-Base at full width (432
             decode, 384 crop, 24 blocks, 1024-d) under XMIR_FUSED_ATTN=1 and
             --resume of a timm-layout .pt with random nonzero LN / logit_scale
             / cpb / biases: K4 in every block of every batch, K6 in none, K1
             for the search; then cli.test --save-dir on the query set (K4
             again; the artifact's metrics against those recomputed from its
             own embeddings with numpy); then ingest -> query again under
             XMIR_SWIN_KERNEL=v1: K6 in every block, K4 in none; the hits
             against the plain top-k, and the query embeddings against the
             same model with the kernels' plain versions and on the eager path
 15. slice   cli.query --top-k 0 over a DenseNet121 gallery of 2048 rows: K1'
             once, K1 never, the whole gallery ranked as a stable sort
 16. rates   K4 and K6 at the six SwinV2-Base shapes at B = 16, bf16 and f32,
             against their plain versions and one
             scaled_dot_product_attention call on pre-normalised inputs (timed
             here, used nowhere in the port), with the time of the fold and
             unfold copies around K4; K1' at Q = 1024, N = 100,000, D = 1024,
             k = 2048 and at Q = 64, k = N, with K1 at k = 10 in the same
             turns; SwinV2-Base bf16 (weights and input) batch 16 at 384 px
             with K4, with K6, with the kernels' plain versions and on the
             eager path; CUDA events, in turns
 17. kernel  K3 (csrc/vit_attn_bwd.cu) against its plain version through the
             autograd Function around K2 / K3, f32 and bf16: (BH, N, hd) in
             {(24, 1370, 64), (4, 729, 72), (6, 64, 32), (2, 1, 64),
             (3, 137, 128)}, rows of negative scores and rows with few
             dominant keys; within the bounds of
             ops/vit_attn.py::grad_agreement; two runs bit-equal; f32 also
             within 3e-5 of the largest magnitude of the exact gradient; K7's
             analytic backward against autograd through its plain forward
 18. slice   cli.train with DINOv2 ViT-B/14 at full width (518 px, 12 blocks,
             --bf16 -p 2 -k 4: batch 8) on COVIDx-format PNGs: one epoch of
             three steps, the evaluation and a checkpoint: K7 and K2 in every
             block of every forward, K3 in every block of every train step;
             finite losses; parameters moved, and under --freeze-backbone the
             backbone's did not; --resume of the checkpoint continues at epoch
             2 with the losses, bit for bit, of an uninterrupted two-epoch
             run; then three f32 steps with the kernels and with their plain
             versions, the parameters after them held together
 19. slice   cli.train with DenseNet121 (224 px, -p 3 -k 4, f32, no kernel):
             finite losses, running statistics moved, resume exact
 20. rates   K3 at B = 8 and B = 16 (BH = 96 / 192, N = 1370, hd = 64), bf16
             and f32, against its plain version and the backward of one
             scaled_dot_product_attention call (timed here, used nowhere in
             the port); the bf16 DINOv2 train step at batch 8 with the
             kernels, with their plain versions and on the eager path: img/s,
             peak memory, and forward / backward / optimiser shares
 21. kernel  K10 (csrc/convnext_block_bwd.cu) against tail_backward_reference,
             f32 and bf16: ConvNeXtV2-Base's four stage shapes at 384 px
             (B = 2), 49 rows and 1 row at C = 96, 144 rows at B = 3; within
             ops/vit_attn.py::grad_agreement's bounds (the run's dtype, the
             floors of ops/convnext_block.py::tail_grad_floors); two runs
             bit-equal; the fused block's eleven gradients (K9 forward, K10
             backward) against autograd through the plain forward in f32
 22. slice   cli.train with ConvNeXtV2-Base at full width (432 decode, 384
             crop, 36 blocks, --bf16 -p 2 -k 4) and a timm-layout --resume
             with random nonzero LN, GRN and biases: K9 and K10 in the 6
             blocks the training gate fuses, every step, nothing else;
             parameters moved, none of the backbone's under
             --freeze-backbone; --resume bit-exact; three f32 steps under
             XMIR_FUSED_MLP=1 against the plain versions; one epoch each of
             --model convnextv2_sra and convnextv2_pcam, K10 launched
 23. rates   K10 at the four stage shapes at B = 16, bf16 and f32, against
             its plain version and autograd through a plain tail, beside one
             block's forward + backward fused (K9 + K10) and plain: the
             training gate's table; the bf16 ConvNeXtV2-Base train step at
             batch 16, 384 px with the kernels, their plain versions and on
             the eager path
 24. slice   main-path step 4 on DenseNet121 at full width (224 px, f32):
             cli.test --save-dir, cli.compute_saliency --results (2 queries,
             top 5, 2401 masks), cli.evaluate_saliency --saliency-dir (K1
             once) and inline: maps finite and nonnegative, AUCs in [0, 1],
             the saved maps' AUCs equal the inline ones; a narrow model's
             maps and AUCs on the card against the CPU; SBSM images/s and
             insertion / deletion pair-evals/s
``--train-only`` builds and runs phases 17 to 23 alone (no result line).
The launch counts are set to 0 before each slice and read after it. Each
kernel's bound (the least time the card could take: bytes moved once over
3.35 TB/s, or operations over the peak of their type) is reckoned from the
timed shapes. The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from xmir_tpu_torch.cli import common, ingest, query
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.cli import train as train_cli
from xmir_tpu_torch.data.pipeline import embed_dataset
from xmir_tpu_torch.data.synthetic import write_synthetic_covidx
from xmir_tpu_torch.index import ShardedGalleryIndex
from xmir_tpu_torch.models import convnext as convnext_model
from xmir_tpu_torch.models import swin as swin_model
from xmir_tpu_torch.models import vit as vit_model
from xmir_tpu_torch.models.convert import load_torch_checkpoint
from xmir_tpu_torch.models.registry import create_model
from xmir_tpu_torch.ops import _build
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.ops import ln_dense as ld
from xmir_tpu_torch.ops import plain_attn
from xmir_tpu_torch.ops import vit_attn as va
from xmir_tpu_torch.ops import window_attn as wa
from xmir_tpu_torch.ops.distance import l2_normalize
from xmir_tpu_torch.ops.topk_fused import fused_topk
from xmir_tpu_torch.ops.topk_kernels import (
    fused_topk_scores,
    launch_plan,
    select_topk_scores,
    topk_scores_reference,
)
from xmir_tpu_torch.train import (
    TrainState,
    build_optimizer,
    make_embed_fn,
    make_embedding_train_step,
)
from xmir_tpu_torch.utils.checkpoint import checkpoint_name, load_checkpoint

REPO = Path(__file__).resolve().parent
KERNELS = {
    "K1": {"name": "fused_topk_scores", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/topk.cu",
           "replaces": "xmir_tpu/ops/topk_pallas.py:243"},
    "K1'": {"name": "select_topk_scores", "route": "cuda",
            "source": "xmir_tpu_torch/csrc/topk_select.cu",
            "replaces": "xmir_tpu/ops/topk_pallas.py:81"},
    "K2": {"name": "vit_attention_fused", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/vit_attn.cu",
           "replaces": "xmir_tpu/ops/vit_attn_pallas.py:199"},
    "K3": {"name": "vit_attention_bwd", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/vit_attn_bwd.cu",
           "replaces": "xmir_tpu/ops/vit_attn_pallas.py:683"},
    "K4": {"name": "biased_attention_fused", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/window_attn.cu",
           "replaces": "xmir_tpu/ops/vit_attn_pallas.py:320"},
    "K6": {"name": "window_attention_fused", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/window_attn.cu",
           "replaces": "xmir_tpu/ops/window_attn_pallas.py:54"},
    "K7": {"name": "ln_qkv_fused", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/ln_dense.cu",
           "replaces": "xmir_tpu/ops/ln_dense_pallas.py:193"},
    "K8": {"name": "ln_dense_fused", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/ln_dense.cu",
           "replaces": "xmir_tpu/ops/ln_dense_pallas.py:90"},
    "K9": {"name": "convnext_block_fused", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/convnext_block.cu",
           "replaces": "xmir_tpu/ops/convnext_block_pallas.py:124"},
    "K10": {"name": "convnext_tail_bwd", "route": "cuda",
            "source": "xmir_tpu_torch/csrc/convnext_block_bwd.cu",
            "replaces": "xmir_tpu/ops/convnext_block_pallas.py:295"},
    "K11": {"name": "convnext_mlp_grn_fused", "route": "cuda",
            "source": "xmir_tpu_torch/csrc/convnext_block.cu",
            "replaces": "xmir_tpu/ops/convnext_block_pallas.py:45"},
}
METRICS = ("cosine", "ip", "l2", "hamming")
TIE_GAP = 1e-5  # ids may differ only where the exact ranking's gap is below this
# the H100's published peaks (SXM, dense): operations per second by operand
# type (f32 outside the tensor cores) and bytes per second of device memory
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def bound(ops, nbytes, dtype_name):
    """(least ms the card could take, which of the two bounds it): each input
    read once and each output written once over the memory rate, against the
    operations over the peak rate of their type."""
    by_ops, by_bytes = ops / PEAK_OPS[dtype_name] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def ranked_gaps(sorted_vals, k):
    """Gap of each of the first k positions of a descending (Q, >k) ranking
    to its nearest neighbour."""
    s = torch.cat([torch.full_like(sorted_vals[:, :1], float("inf")), sorted_vals], dim=1)
    gaps = torch.minimum(s[:, :k] - s[:, 1:k + 1], s[:, 1:k + 1] - s[:, 2:k + 2])
    return torch.nan_to_num(gaps, nan=float("inf"))


def compare(v, i, rv, ri, atol, sorted_ref=None):
    """Values within atol; ids equal wherever the reference ranking's gap
    (sorted_ref: the reference's first k + 1 values) exceeds TIE_GAP.
    Returns (max |v - rv| over finite slots, ids checked, ids in all)."""
    check(torch.equal(torch.isneginf(v), torch.isneginf(rv)), "-inf slots differ")
    fin = torch.isfinite(rv)
    err = (v[fin].double() - rv[fin].double()).abs().max().item() if fin.any() else 0.0
    check(err <= atol, f"values differ by {err} > {atol}")
    must = torch.ones_like(fin)
    if sorted_ref is not None:
        must = ~fin | (ranked_gaps(sorted_ref.double(), v.shape[1]) > TIE_GAP)
    bad = (i != ri) & must
    check(not bad.any(), f"{int(bad.sum())} ids differ away from near-ties")
    return err, int(must.sum()), must.numel()


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {smi.splitlines()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions score in IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    return smi.splitlines()[0]


def phase_build():
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"[build] {lib.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")


def _int_inputs(gen, q_n, n, d, k, dtype):
    q = torch.randint(-3, 4, (q_n, d), generator=gen).float()
    g = torch.randint(-3, 4, (n, d), generator=gen).float()
    rows = launch_plan(q_n, n, k, torch.cuda.get_device_properties(0).multi_processor_count)[2]
    # duplicates of one row inside a split, on both sides of split
    # boundaries and at the ragged end: ties the kernel must order by row
    dup = [r for r in (3, 5, rows - 1, rows, 2 * rows - 1, 2 * rows, n - 1) if r < n]
    g[dup] = g[3].clone()
    q[0] = g[3]
    return q.to("cuda", dtype), g.to("cuda", dtype)


def _random_inputs(gen, q_n, n, d, dtype):
    q = l2_normalize(torch.randn((q_n, d), generator=gen))
    g = l2_normalize(torch.randn((n, d), generator=gen))
    return q.to("cuda", dtype), g.to("cuda", dtype)


SLICE_SHAPE = (64, 256, 1024, 10)  # what the slice's query hands K1: Q, N, D, k


def phase_kernel():
    gen = torch.Generator().manual_seed(0)
    shapes = [SLICE_SHAPE, (70, 4099, 32, 1), (70, 4099, 96, 10), (33, 4099, 1024, 128),
              (17, 4099, 96, 129), (20, 4099, 32, 1024), (129, 4099, 1024, 10)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[kernel] the slice's shape {SLICE_SHAPE} runs the plan (block queries, "
        f"splits, rows per split) = {launch_plan(*SLICE_SHAPE[:2], SLICE_SHAPE[3], sms)}")
    max_err = 0.0
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for q_n, n, d, k in shapes:
            for valid in (n, k // 2 + 1):
                bias = torch.zeros(n, device="cuda")
                bias[valid:] = float("-inf")
                q, g = _int_inputs(gen, q_n, n, d, k, dtype)
                v, i = fused_topk_scores(q, g, bias, k)
                torch.cuda.synchronize()
                rv, ri = topk_scores_reference(q, g, bias, k)
                check(torch.equal(v, rv) and torch.equal(i, ri),
                      f"integer inputs not bit-equal: {dtype} Q={q_n} N={n} D={d} k={k} valid={valid}")
                q, g = _random_inputs(gen, q_n, n, d, dtype)
                v, i = fused_topk_scores(q, g, bias, k)
                torch.cuda.synchronize()
                rv, ri = topk_scores_reference(q, g, bias, min(k + 1, n))
                err, _, _ = compare(v, i, rv[:, :k], ri[:, :k], atol, rv)
                max_err = max(max_err, err)
            log(f"[kernel] {str(dtype)[6:]:8s} Q={q_n:4d} N={n} D={d:4d} k={k:4d}: "
                f"integer bit-equal, random within {atol} (max err so far {max_err:.3g})")
    for metric in METRICS:  # the metric transforms around K1, against the CPU plain path
        for kind in ("int", "random"):
            if kind == "int":
                q, g = _int_inputs(gen, 70, 4099, 96, 10, torch.float32)
            else:
                q, g = _random_inputs(gen, 70, 4099, 96, torch.float32)
            v, i = fused_topk(q, g, 10, metric)
            torch.cuda.synchronize()
            rv, ri = fused_topk(q.cpu(), g.cpu(), 10, metric)
            if kind == "int" and metric != "cosine":
                check(torch.equal(v.cpu(), rv) and torch.equal(i.cpu(), ri),
                      f"{metric}: integer inputs not bit-equal")
            else:
                srv, _ = fused_topk(q.cpu(), g.cpu(), 11, metric)
                err, _, _ = compare(v.cpu(), i.cpu(), rv, ri, 1e-5, srv)
                max_err = max(max_err, err)
        log(f"[kernel] fused_topk metric={metric}: matches the plain path")
    return max_err


@contextlib.contextmanager
def record_searches(calls):
    """Record each ShardedGalleryIndex.search's queries and gallery tensor."""
    orig = ShardedGalleryIndex.search

    def search(self, queries, k, exclude_ids=None):
        calls.append((self, torch.as_tensor(queries).clone(), k))
        return orig(self, queries, k, exclude_ids)

    ShardedGalleryIndex.search = search
    try:
        yield
    finally:
        ShardedGalleryIndex.search = orig


def check_hits(calls, results, n_gallery, n_queries, dim):
    """The one search of a slice run: shapes, finite hits, the hits against
    the plain top-k on the same device embeddings, and the built gallery
    against queries whose scores spread. Returns the largest value error."""
    check(len(calls) == 1 and len(results) == n_queries,
          f"expected one search of {n_queries} queries")
    idx, queries, k = calls[0]
    check(queries.is_cuda and idx._device_embeds.is_cuda, "the search did not run on the card")
    check(queries.shape == (n_queries, dim) and idx.ntotal == n_gallery,
          f"shapes {tuple(queries.shape)}")
    check(all(torch.isfinite(torch.tensor([h["similarity"] for h in r["results"]])).all()
              and len(r["results"]) == k for r in results), "non-finite or missing hits")
    # the same device embeddings through the plain version
    qn = l2_normalize(queries)
    bias = torch.zeros(idx.ntotal, device="cuda")
    rv, ri = topk_scores_reference(qn, idx._device_embeds, bias, k + 1)
    v = torch.tensor([[h["similarity"] for h in r["results"]] for r in results], device="cuda")
    i = torch.tensor([[h["id"] for h in r["results"]] for r in results], device="cuda",
                     dtype=torch.int32)
    err, checked, total = compare(v, i, rv[:, :k], ri[:, :k], 1e-5, rv)
    exact = (qn.double() @ idx._device_embeds.double().T)
    best = torch.sort(exact, dim=1, descending=True).values[:, :k]
    got = torch.gather(exact, 1, i.long())
    slack = (best - got).abs().max().item()
    # a 1024-term f32 dot product of unit embeddings rounds by up to a few
    # 1e-6, in the kernel and in cuBLAS alike
    check(slack <= TIE_GAP, f"a hit's exact score is {slack} below the exact top-{k}")
    log(f"[slice] hits vs plain: max err {err:.3g}, {checked}/{total} ids outside "
        f"near-ties checked equal; every hit within {slack:.2g} of the exact (f64) top-{k}")
    # Random-weight embeddings are nearly collinear, so the hits above may all
    # sit in near-ties. The same built gallery, searched with the queries'
    # residuals from the gallery mean (which spread the scores), checks ids.
    spread = queries - idx._device_embeds.mean(dim=0)
    sv, si = idx.search(spread, k)
    rv, ri = topk_scores_reference(l2_normalize(spread), idx._device_embeds, bias, k + 1)
    s_err, s_checked, s_total = compare(sv, si, rv[:, :k], ri[:, :k], 1e-5, rv)
    check(s_checked > 0, "no id of the spread queries lies outside near-ties")
    log(f"[slice] the gallery against {n_queries} spread queries: max err {s_err:.3g}, "
        f"{s_checked}/{s_total} ids outside near-ties checked equal")
    top1 = np.mean([r["results"][0]["label"] == r["query_label"] for r in results])
    log(f"[slice] top-1 label agreement {top1:.3f} (random weights)")
    return max(err, s_err)


WRAPPERS = {"K1": fused_topk_scores, "K1'": select_topk_scores, "K2": va.vit_attention_fused,
            "K3": va.vit_attention_bwd, "K4": va.biased_attention_fused, "K6": wa.window_attention_fused,
            "K7": ld.ln_qkv_fused,
            "K8": ld.ln_dense_fused, "K9": cb.convnext_block_fused,
            "K10": cb.convnext_tail_bwd, "K11": cb.convnext_mlp_grn_fused}


def reset_launches():
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def read_launches():
    torch.cuda.synchronize()
    return {key: wrapper.launches for key, wrapper in WRAPPERS.items()}


def phase_slice(workdir: Path):
    t0 = time.perf_counter()
    img_dir, g_manifest = write_synthetic_covidx(str(workdir / "gallery"), n=256, size=256, seed=0)
    q_dir, q_manifest = write_synthetic_covidx(str(workdir / "queries"), n=64, size=256, seed=1)
    log(f"[slice] wrote 256 gallery + 64 query PNGs (256 px) in {time.perf_counter() - t0:.1f} s")
    gal, hits_path = str(workdir / "gallery.npz"), str(workdir / "hits.json")
    model_args = ["--model", "densenet121", "--device", "cuda", "--seed", "0",
                  "--batch-size", "64", "-j", "8"]
    calls = []
    reset_launches()
    with record_searches(calls):
        ingest.main(["--dataset", "covid", "--dataset-dir", img_dir,
                     "--train-image-list", g_manifest, "--split", "train",
                     "--output", gal] + model_args)
        results = query.main(["--dataset", "covid", "--dataset-dir", q_dir,
                              "--test-image-list", q_manifest, "--split", "test",
                              "--index", gal, "--top-k", "10", "--output", hits_path]
                             + model_args)
    launches = read_launches()
    check(launches["K1"] > 0, "the query path did not launch the top-k kernel")
    check(all(n == 0 for key, n in launches.items() if key != "K1"),
          f"DenseNet121 launched another model's kernel: {launches}")
    log(f"[slice] DenseNet121: launches {launches}")
    return launches, check_hits(calls, results, 256, 64, 1024)


def _time_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_embed_rate():
    """Device-only DenseNet121 embedding rate at batch 128, 224 px."""
    model, _ = create_model("densenet121", generator=torch.Generator().manual_seed(0))
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.randn((128, 224, 224, 3), generator=torch.Generator().manual_seed(1)).cuda()
    rates = {}
    for label, dtype, tf32 in (("f32", torch.float32, False), ("tf32", torch.float32, True),
                               ("bf16", torch.bfloat16, False)):
        torch.backends.cudnn.allow_tf32 = tf32
        embed = make_embed_fn(model, compute_dtype=dtype)
        for _ in range(3):
            out = embed(x)
        check(out.shape == (128, 1024) and torch.isfinite(out).all(), "bad embeddings")
        ms = statistics.median(_time_ms(lambda: embed(x), 3) for _ in range(3))
        rates[label] = 128 / ms * 1e3
        log(f"[embed] DenseNet121 {label:4s} batch 128 @224: {ms:.2f} ms/batch, "
            f"{rates[label]:.0f} img/s (device only)")
    torch.backends.cudnn.allow_tf32 = False
    return rates


def phase_serving():
    q_n, n, d, k = 1024, 100_000, 1024, 10
    gen = torch.Generator().manual_seed(2)
    q = l2_normalize(torch.randn((q_n, d), generator=gen)).cuda()
    g = l2_normalize(torch.randn((n, d), generator=gen)).cuda()
    bias = torch.zeros(n, device="cuda")
    out = {}
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        qq, gg = q.to(dtype), g.to(dtype)
        v, i = fused_topk_scores(qq, gg, bias, k)
        rv, ri = topk_scores_reference(qq, gg, bias, k + 1)
        torch.cuda.synchronize()
        err, checked, total = compare(v, i, rv[:, :k], ri[:, :k], atol, rv)
        kern, plain = [], []
        for _ in range(5):  # in turns: plain, kernel, kernel, plain, ...
            plain.append(_time_ms(lambda: topk_scores_reference(qq, gg, bias, k), 3))
            kern.append(_time_ms(lambda: fused_topk_scores(qq, gg, bias, k), 3))
            kern.append(_time_ms(lambda: fused_topk_scores(qq, gg, bias, k), 3))
            plain.append(_time_ms(lambda: topk_scores_reference(qq, gg, bias, k), 3))
        ms, plain_ms = statistics.median(kern), statistics.median(plain)
        name = str(dtype)[6:]
        size = qq.element_size()
        bound_ms, bound_by = bound(2 * q_n * n * d,
                                   (q_n + n) * d * size + n * 4 + q_n * k * 8, name)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "bound_ms": bound_ms,
                     "bound_by": bound_by}
        log(f"[serving] {name:8s} Q={q_n} N={n} D={d} k={k}: kernel {ms:.3f} ms "
            f"({q_n / ms * 1e3:.0f} QPS, {2 * q_n * n * d / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.3f} ms ({q_n / plain_ms * 1e3:.0f} QPS); max err {err:.3g}, "
            f"{checked}/{total} ids checked equal; kernel runs {[round(t, 3) for t in kern]}, "
            f"plain runs {[round(t, 3) for t in plain]}")
    return out


# ConvNeXtV2-Base at 384 px: (H = W, C) of each stage's blocks
STAGES = ((96, 128), (48, 256), (24, 512), (12, 1024))
DEPTH = 36  # ConvNeXtV2-Base blocks per forward: K9 launches per batch


def _tail_inputs(gen, b, hw, c, dtype):
    """A block input (b, hw, hw, c) and random parameters: LN, GRN gamma /
    beta and biases nonzero (at init GRN is zero, which would leave it
    untested)."""
    c4 = 4 * c

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen) * sc).cuda()

    a = dict(dw_weight=r(c, 1, 7, 7, sc=0.1), dw_bias=r(c, sc=0.1), ln_scale=1 + r(c, sc=0.2),
             ln_bias=r(c, sc=0.1), w1=r(c4, c, sc=c ** -0.5).to(dtype), b1=r(c4, sc=0.1),
             w2=r(c, c4, sc=c4 ** -0.5).to(dtype), b2=r(c, sc=0.1), gamma=r(c4, sc=0.5),
             beta=r(c4, sc=0.1))
    return r(b, hw, hw, c).to(dtype), a


def plain_block(x, dw_weight, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta):
    """convnext_block_fused with the tail's plain version: the dwconv, then
    block_tail_reference, on the same device."""
    b, hh, ww, c = x.shape
    h = cb.dwconv(x, dw_weight, dw_bias).reshape(b, hh * ww, c)
    out = cb.block_tail_reference(h, x.reshape(b, hh * ww, c), ln_scale, ln_bias, w1, b1, w2,
                                  b2, gamma, beta)
    return out.reshape(b, hh, ww, c)


def _k11_inputs(x, a):
    """K11's operands for the same block: its normalised dwconv output and
    the residual, as (B, R, C) rows."""
    b, hh, ww, c = x.shape
    h = cb.dwconv(x, a["dw_weight"], a["dw_bias"]).reshape(b, hh * ww, c)
    y = cb.layer_norm(h, a["ln_scale"], a["ln_bias"]).to(x.dtype)
    return y, x.reshape(b, hh * ww, c), (a["w1"], a["b1"], a["w2"], a["b2"], a["gamma"],
                                          a["beta"])


def tail_err(out, ref, what):
    """cb.agreement of a K9 / K11 output with its plain version; raises
    past the bounds stated there."""
    e = cb.agreement(out, ref)
    check(cb.agrees(e), f"{what}: the kernel differs from its plain version past the bounds "
                        f"(F32_RTOL / BF16_STEPS, BF16_ATOL / BF16_MEAN_STEPS): {e}")
    return e


def phase_kernel_convnext():
    gen = torch.Generator().manual_seed(3)
    cases = [(2, hw, c, "stage") for hw, c in STAGES] + [
        (2, 7, 128, "ragged 49 rows"), (2, 25, 256, "ragged 625 rows"),
        (3, 12, 128, "144 rows, B 3"), (3, 24, 128, "576 rows, B 3")]
    err = {"K9": {}, "K11": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for b, hw, c, what in cases:
            x, a = _tail_inputs(gen, b, hw, c, dtype)
            out = cb.convnext_block_fused(x, **a)
            again = cb.convnext_block_fused(x, **a)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"K9 {name} {what}: two runs differ")
            e9 = tail_err(out, plain_block(x, **a), f"K9 {name} B={b} {hw}x{hw} C={c}")
            y, xr, t = _k11_inputs(x, a)
            out11 = cb.convnext_mlp_grn_fused(y, xr, *t)
            torch.cuda.synchronize()
            e11 = tail_err(out11, cb.mlp_grn_reference(y, xr, *t),
                           f"K11 {name} B={b} {hw}x{hw} C={c}")
            for key, e in (("K9", e9), ("K11", e11)):
                seen = err[key].setdefault(name, dict.fromkeys(e, 0.0))
                for k in seen:
                    seen[k] = max(seen[k], e[k])
            log(f"[kernel] K9/K11 {name:8s} B={b} {hw:2d}x{hw:2d} C={c:4d} ({what}): max err "
                f"{e9['max_abs_err']:.3g} / {e11['max_abs_err']:.3g}, {e9['of_bound']:.3g} / "
                f"{e11['of_bound']:.3g} of the bound, mean {e9['mean_steps']:.3g} / "
                f"{e11['mean_steps']:.3g} bf16 steps; K9 twice bit-equal")
    return err


@contextlib.contextmanager
def tail_plain_version():
    """The model's fused-block call pointed at the tail's plain version."""
    orig = convnext_model.convnext_block_fused
    convnext_model.convnext_block_fused = plain_block
    try:
        yield
    finally:
        convnext_model.convnext_block_fused = orig


def write_timm_checkpoint(path, seed):
    """ConvNeXtV2-Base in timm's layout with random nonzero LayerNorm and GRN
    tensors (at init they are 1 / 0 and GRN the identity), plus timm's
    1000-class classifier, which the port's loader drops."""
    backbone = convnext_model.convnextv2_base(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in backbone.modules():
            if isinstance(m, convnext_model.LayerNorm):
                m.weight.copy_(1 + 0.2 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
            elif isinstance(m, convnext_model.GlobalResponseNorm):
                m.weight.copy_(0.5 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
    sd = backbone.state_dict()
    sd.update({"head.fc.weight": torch.zeros(1000, 1024), "head.fc.bias": torch.zeros(1000)})
    torch.save(sd, path)


CONVNEXT_EMBED_TOL = 1e-4  # K9 vs the tail's plain version, f32, unit embeddings


def phase_slice_convnext(workdir: Path):
    t0 = time.perf_counter()
    n_g, n_q, batch = 128, 32, 32
    img_dir, g_manifest = write_synthetic_covidx(str(workdir / "c_gallery"), n=n_g, size=256,
                                                 seed=2)
    q_dir, q_manifest = write_synthetic_covidx(str(workdir / "c_queries"), n=n_q, size=256,
                                               seed=3)
    pt = str(workdir / "convnextv2_timm.pt")
    write_timm_checkpoint(pt, seed=4)
    log(f"[slice] ConvNeXtV2: wrote {n_g} + {n_q} PNGs and a timm-layout .pt in "
        f"{time.perf_counter() - t0:.1f} s")
    gal, hits_path = str(workdir / "c_gallery.npz"), str(workdir / "c_hits.json")
    model_args = ["--model", "convnextv2", "--device", "cuda", "--seed", "0", "--resume", pt,
                  "--batch-size", str(batch), "-j", "8"]
    q_args = ["--dataset", "covid", "--dataset-dir", q_dir, "--test-image-list", q_manifest,
              "--split", "test"] + model_args
    calls = []
    with env_flags(XMIR_FUSED_MLP="1"):  # the f32 CLIs take K9
        reset_launches()
        with record_searches(calls):
            ingest.main(["--dataset", "covid", "--dataset-dir", img_dir,
                         "--train-image-list", g_manifest, "--split", "train",
                         "--output", gal] + model_args)
            results = query.main(q_args + ["--index", gal, "--top-k", "10",
                                           "--output", hits_path])
        launches = read_launches()
        batches = -(-n_g // batch) + -(-n_q // batch)
        check(launches["K9"] == DEPTH * batches,
              f"K9 launched {launches['K9']} times, not {DEPTH} x {batches} batches")
        check(launches["K1"] > 0, "the query path did not launch the top-k kernel")
        # every block takes K9 (LN inside); like the JAX model, none calls K11
        check(all(n == 0 for key, n in launches.items() if key not in ("K1", "K9")),
              f"ConvNeXtV2 launched a kernel that is not on its path: {launches}")
        log(f"[slice] ConvNeXtV2: K9 launches {launches['K9']} ({DEPTH} blocks x {batches} "
            f"batches), K1 launches {launches['K1']}, K11 launches {launches['K11']}")
        err = check_hits(calls, results, n_g, n_q, 1024)
        # the same queries through the same model with the tail's plain version
        p = argparse.ArgumentParser()
        common.add_dataset_args(p)
        common.add_model_args(p)
        args, _ = p.parse_known_args(q_args)
        model, spec = common.build_model(args, torch.device("cuda"))
        with tail_plain_version():
            ref, _ = embed_dataset(common.build_dataset(args, "test"), make_embed_fn(model), spec,
                                   device="cuda", batch_size=batch, num_workers=8)
    emb_err = (calls[0][1] - ref).abs().max().item()
    check(emb_err <= CONVNEXT_EMBED_TOL, f"query embeddings differ from the plain tail's by "
                                         f"{emb_err} > {CONVNEXT_EMBED_TOL}")
    log(f"[slice] ConvNeXtV2 query embeddings vs the tail's plain version: max err "
        f"{emb_err:.3g} (<= {CONVNEXT_EMBED_TOL})")
    return launches, err, emb_err


def _in_turns(fns, rounds=3, reps=3):
    """Median ms of each of fns {name: fn}, timed with CUDA events in turns:
    the order reverses every round (a, b, b, a, ...)."""
    names, times = list(fns), {name: [] for name in fns}
    for fn in fns.values():
        fn()
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            times[name].append(_time_ms(fns[name], reps))
    return {name: statistics.median(t) for name, t in times.items()}, times


# the bf16 model's unit embeddings with the kernels against the same model
# with the tail's plain version and on the plain path: <= 2^-10 seen on two
# input seeds for each (PERF.md); twice that is allowed
EMBED_BF16_TOL = {"tail plain": 2e-3, "plain path": 2e-3}


def phase_convnext_rates():
    gen = torch.Generator().manual_seed(5)
    out = {"K9": {}, "K11": {}}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for hw, c in STAGES:
            x, a = _tail_inputs(gen, 32, hw, c, dtype)
            y, xr, t = _k11_inputs(x, a)
            shape = f"B=32 {hw}x{hw} C={c}"
            e9 = tail_err(cb.convnext_block_fused(x, **a), plain_block(x, **a),
                          f"K9 {name} {shape}")
            e11 = tail_err(cb.convnext_mlp_grn_fused(y, xr, *t), cb.mlp_grn_reference(y, xr, *t),
                           f"K11 {name} {shape}")
            ms, _ = _in_turns({
                "K9": lambda: cb.convnext_block_fused(x, **a),
                "K9 plain": lambda: plain_block(x, **a),
                "K11": lambda: cb.convnext_mlp_grn_fused(y, xr, *t),
                "K11 plain": lambda: cb.mlp_grn_reference(y, xr, *t),
            })
            flop = 4 * 32 * hw * hw * c * 4 * c
            rc, size = 32 * hw * hw * c, x.element_size()
            weights = 8 * c * c * size + 10 * c * 4  # pw1, pw2; b1, gamma, beta, b2
            work = {  # K9: the block with its dwconv and LN; K11 reads y and x
                "K9": (flop + 2 * 49 * rc, 2 * rc * size + weights + (49 + 3) * c * 4),
                "K11": (flop, 3 * rc * size + weights)}
            for k in ("K9", "K11"):
                bound_ms, bound_by = bound(*work[k], name)
                out[k][f"{name} {shape}"] = {"ms": ms[k], "plain_ms": ms[f"{k} plain"],
                                            "bound_ms": bound_ms, "bound_by": bound_by}
            log(f"[rates] {name:8s} {shape}: K9 {ms['K9']:.3f} ms (block incl. dwconv; "
                f"{flop / ms['K9'] / 1e9:.1f} TFLOP/s of GEMM) vs plain {ms['K9 plain']:.3f} ms;"
                f" K11 {ms['K11']:.3f} ms vs plain {ms['K11 plain']:.3f} ms; agreement K9 {e9},"
                f" K11 {e11}")
            del x, a, y, xr, t
    torch.cuda.empty_cache()
    # the whole model in tools/bench_towers.py's configuration: bf16 weights
    # and input, batch 32, 384 px; the default rule sends bf16 blocks to K9
    model, _ = create_model("convnextv2", generator=torch.Generator().manual_seed(6))
    model = model.to("cuda", torch.bfloat16, memory_format=torch.channels_last).eval()
    x = torch.randn((32, 384, 384, 3), generator=torch.Generator().manual_seed(7)).to(
        "cuda", torch.bfloat16)
    embed = make_embed_fn(model)

    def with_plain_tail():
        with tail_plain_version():
            return embed(x)

    def plain_path():
        with env_flags(XMIR_FUSED_MLP="0"):
            return embed(x)

    with env_flags(XMIR_FUSED_MLP=None):
        cb.convnext_block_fused.launches = 0
        e = embed(x)
        torch.cuda.synchronize()
        check(cb.convnext_block_fused.launches == DEPTH, "bf16 blocks did not all take K9")
        ep, epp = with_plain_tail(), plain_path()
        check(e.shape == (32, 1024) and torch.isfinite(e).all(), "bad embeddings")
        diff = {"tail plain": (e - ep).abs().max().item(),
                "plain path": (e - epp).abs().max().item()}
        for k, v in diff.items():
            check(v <= EMBED_BF16_TOL[k], f"bf16 embeddings with the kernels differ from the "
                                          f"{k}'s by {v} > {EMBED_BF16_TOL[k]}")
        ms, runs = _in_turns({"kernels": lambda: embed(x), "tail plain": with_plain_tail,
                              "plain path": plain_path})
    rates = {k: 32 / v * 1e3 for k, v in ms.items()}
    log(f"[rates] ConvNeXtV2-Base bf16 batch 32 @384 (device only): kernels {ms['kernels']:.2f}"
        f" ms = {rates['kernels']:.0f} img/s; tail's plain version {ms['tail plain']:.2f} ms ="
        f" {rates['tail plain']:.0f} img/s; plain path (XMIR_FUSED_MLP=0) "
        f"{ms['plain path']:.2f} ms = {rates['plain path']:.0f} img/s; the kernels' embeddings "
        f"within {diff['tail plain']:.3g} / {diff['plain path']:.3g} of these two's (bounds "
        f"{EMBED_BF16_TOL}); runs {({k: [round(t, 2) for t in v] for k, v in runs.items()})}")
    out["embed_rate"] = rates
    return out


# DINOv2 ViT-B/14 at 518 px: tokens, width, heads, blocks per forward
VIT = dict(n=1370, c=768, heads=12, depth=12)


def _attn_inputs(gen, bh, n, hd, dtype):
    return tuple(torch.randn((bh, n, hd), generator=gen).to("cuda", dtype) for _ in range(3))


def _ln_inputs(gen, b, n, c, m, dtype):
    """x (b, n, c) off-centre, random LN scale / bias, a (m, c) weight and
    its bias."""
    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen) * sc).cuda()

    return ((r(b, n, c) * 2 + 0.5).to(dtype), 1 + r(c, sc=0.2), r(c, sc=0.1),
            r(m, c, sc=c ** -0.5).to(dtype), r(m, sc=0.1))


def _worst(seen, e):
    for k, v in e.items():
        seen[k] = max(seen.get(k, 0.0), v)


def vit_err(out, ref, agreement, what):
    """An agreement reading of a ViT kernel against its plain version; raises
    past the bounds its module states."""
    e = agreement(out, ref)
    check(cb.agrees(e), f"{what}: the kernel differs from its plain version past the bounds: {e}")
    return e


def phase_kernel_vit():
    gen = torch.Generator().manual_seed(8)
    err = {key: {} for key in ("K2", "K7", "K8")}
    attn_cases = [(2 * VIT["heads"], VIT["n"], 64, "DINOv2, B 2")] + [
        (3, n, 64, "ragged N") for n in (1, 7, 197, 257, 729, 1024)] + [
        (2, 300, hd, "head width") for hd in (16, 32, 72, 128)]
    ln_cases = [(2, VIT["n"], VIT["c"], VIT["heads"], "DINOv2, B 2")] + [
        (2, n, 256, 4, "ragged N") for n in (1, 7, 197, 257, 729, 1024)] + [
        (2, 300, c, c // hd, "head width") for c, hd in ((128, 32), (384, 128))]
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            for bh, n, hd, what in attn_cases:
                q, k, v = _attn_inputs(gen, bh, n, hd, dtype)
                out = va.vit_attention_fused(q, k, v, hd ** -0.5)
                again = va.vit_attention_fused(q, k, v, hd ** -0.5)
                torch.cuda.synchronize()
                check(torch.equal(out, again), f"K2 {name} {what}: two runs differ")
                e = vit_err(out, va.attention_plain(q, k, v, hd ** -0.5), va.agreement,
                            f"K2 {name} BH={bh} N={n} hd={hd}")
                _worst(err["K2"].setdefault(name, {}), e)
                log(f"[kernel] K2 {name:8s} BH={bh:2d} N={n:4d} hd={hd:3d} ({what}): {e}; "
                    "twice bit-equal")
            # every score very negative, then one dominant key in the last tile:
            # the running max jumps and every sum rescales
            q, k, v = _attn_inputs(gen, 4, 300, 64, torch.float32)
            q, k = -q.abs() * 3, k.abs() * 3
            k[:, 290] *= -4.0
            q, k, v = (t.to(dtype) for t in (q, k, v))
            out = va.vit_attention_fused(q, k, v, 0.125)
            check(torch.isfinite(out.float()).all(), "K2: non-finite output on negative rows")
            e = vit_err(out, va.attention_plain(q, k, v, 0.125), va.agreement,
                        f"K2 {name} negative rows with one dominant score")
            _worst(err["K2"][name], e)
            log(f"[kernel] K2 {name:8s} negative scores, one dominant key: {e}")
            for b, n, c, heads, what in ln_cases:
                x, lns, lnb, w, bias = _ln_inputs(gen, b, n, c, 3 * c, dtype)
                out = ld.ln_qkv_fused(x, lns, lnb, w, bias, heads)
                no_bias = ld.ln_qkv_fused(x, lns, lnb, w, None, heads)
                ref = ld.ln_qkv_reference(x, lns, lnb, w, bias, heads)
                ref_nb = ld.ln_qkv_reference(x, lns, lnb, w, None, heads)
                check(all(torch.equal(o, o2) for o, o2 in
                          zip(out, ld.ln_qkv_fused(x, lns, lnb, w, bias, heads))),
                      f"K7 {name} {what}: two runs differ")
                e7 = {}
                for o, r in list(zip(out, ref)) + list(zip(no_bias, ref_nb)):
                    _worst(e7, vit_err(o, r, ld.agreement, f"K7 {name} B={b} N={n} C={c}"))
                _worst(err["K7"].setdefault(name, {}), e7)
                _, _, _, w1, b1 = _ln_inputs(gen, 1, 1, c, 4 * c, dtype)
                rows, e8 = x.reshape(b * n, c), {}
                for act in ("gelu", ""):
                    for bb in (b1, None):
                        o = ld.ln_dense_fused(rows, lns, lnb, w1, bb, 1e-6, act)
                        r = ld.ln_dense_reference(rows, lns, lnb, w1, bb, 1e-6, act)
                        _worst(e8, vit_err(o, r, ld.agreement,
                                           f"K8 {name} R={b * n} C={c} act={act!r} "
                                           f"bias={bb is not None}"))
                _worst(err["K8"].setdefault(name, {}), e8)
                log(f"[kernel] K7/K8 {name:8s} B={b} N={n:4d} C={c:3d} H={heads:2d} ({what}): "
                    f"K7 {e7}; K8 (GELU and bias on / off) {e8}; K7 twice bit-equal")
    return err


@contextlib.contextmanager
def env_flags(**flags):
    """Environment switches (the JAX package's) set for the duration; a value
    of None unsets."""
    before = {k: os.environ.get(k) for k in flags}
    try:
        for k, v in flags.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        yield
    finally:
        for k, v in before.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


class PlainAttention(torch.autograd.Function):
    """K2's and K3's plain versions as one differentiable call."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        out = va.attention_plain(q, k, v, sm_scale)
        ctx.sm_scale = sm_scale
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out = ctx.saved_tensors
        return (*va.attention_bwd_plain(q, k, v, out, g.contiguous(), ctx.sm_scale), None)


class PlainLnQkv(torch.autograd.Function):
    """K7's plain version with K7's own (plain tensor code) backward."""

    @staticmethod
    def forward(ctx, x, lns, lnb, w, b, num_heads):
        ctx.save_for_backward(x, lns, lnb, w, b)
        return ld.ln_qkv_reference(x, lns, lnb, w, b, num_heads)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        return (*ld.ln_qkv_backward(*ctx.saved_tensors, gq, gk, gv), None)


@contextlib.contextmanager
def vit_plain_versions():
    """The ViT's kernel calls pointed at the kernels' plain versions, the
    forward's and the backward's."""
    saved = (vit_model.ln_qkv_fused, vit_model.ln_dense_fused, plain_attn.vit_attention_fused)
    vit_model.ln_qkv_fused = PlainLnQkv.apply
    vit_model.ln_dense_fused = ld.ln_dense_reference
    plain_attn.vit_attention_fused = PlainAttention.apply
    try:
        yield
    finally:
        vit_model.ln_qkv_fused, vit_model.ln_dense_fused, plain_attn.vit_attention_fused = saved


def write_vit_checkpoint(path, seed):
    """DINOv2 ViT-B/14 in timm's layout with random nonzero LayerNorm,
    LayerScale and bias tensors (at init LayerScale is 1e-5 and the blocks
    all but vanish), plus a classifier, which the port's loader ignores."""
    backbone = vit_model.vit_base_patch14_dinov2(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in backbone.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(0.5 + 0.2 * torch.randn(p.shape, generator=gen))
            elif name.endswith(".bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif "norm" in name:
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=gen))
    sd = backbone.state_dict()
    sd.update({"head.weight": torch.zeros(1000, 768), "head.bias": torch.zeros(1000)})
    torch.save(sd, path)


# f32 unit embeddings of the DINOv2 slice's queries: the kernels against the
# same model with their plain versions (the f32 sums' order) and against the
# eager path (which also takes exp for exp2): 1.3e-7 and 2.0e-7 seen, 5e-6
# allowed. Under XMIR_FUSED_LN_MLP=1 the eager path's erf GELU stands against
# K8's tanh form: 2.1e-5 seen, which the 5e-6 of the like-for-like
# comparisons would refuse, 2e-4 allowed (PERF.md)
VIT_EMBED_TOL = {"plain versions": 5e-6, "eager": 5e-6, "eager, fused mlp": 2e-4}
FUSED_VIT = {"XMIR_FLASH_ATTN": "1", "XMIR_FUSED_LN": "1", "XMIR_FUSED_LN_QKV": None}


def phase_slice_dinov2(workdir: Path):
    t0 = time.perf_counter()
    n_g, n_q, batch = 32, 16, 16
    img_dir, g_manifest = write_synthetic_covidx(str(workdir / "v_gallery"), n=n_g, size=256,
                                                 seed=4)
    q_dir, q_manifest = write_synthetic_covidx(str(workdir / "v_queries"), n=n_q, size=256,
                                               seed=5)
    pt = str(workdir / "dinov2_timm.pt")
    write_vit_checkpoint(pt, seed=9)
    log(f"[slice] DINOv2: wrote {n_g} + {n_q} PNGs and a timm-layout .pt in "
        f"{time.perf_counter() - t0:.1f} s")
    gal, hits_path = str(workdir / "v_gallery.npz"), str(workdir / "v_hits.json")
    model_args = ["--model", "dinov2", "--device", "cuda", "--seed", "0", "--resume", pt,
                  "--batch-size", str(batch), "-j", "8"]
    q_args = ["--dataset", "covid", "--dataset-dir", q_dir, "--test-image-list", q_manifest,
              "--split", "test"] + model_args
    batches = -(-n_g // batch) + -(-n_q // batch)
    per_path = VIT["depth"] * batches
    p = argparse.ArgumentParser()
    common.add_dataset_args(p)
    common.add_model_args(p)
    args, _ = p.parse_known_args(q_args)

    def reembed():
        model, spec = common.build_model(args, torch.device("cuda"))
        ref, _ = embed_dataset(common.build_dataset(args, "test"), make_embed_fn(model), spec,
                               device="cuda", batch_size=batch, num_workers=8)
        return ref

    out = {}
    for path, mlp in (("dinov2", "0"), ("dinov2_fused_mlp", "1")):
        calls = []
        with env_flags(XMIR_FUSED_LN_MLP=mlp, **FUSED_VIT):  # the f32 CLIs take the kernels
            reset_launches()
            with record_searches(calls):
                t0 = time.perf_counter()
                ingest.main(["--dataset", "covid", "--dataset-dir", img_dir,
                             "--train-image-list", g_manifest, "--split", "train",
                             "--output", gal] + model_args)
                results = query.main(q_args + ["--index", gal, "--top-k", "10",
                                               "--output", hits_path])
                wall = time.perf_counter() - t0
            launches = read_launches()
            want = dict.fromkeys(WRAPPERS, 0)
            want.update({"K1": 1, "K2": per_path, "K7": per_path,
                         "K8": per_path if mlp == "1" else 0})
            check(launches == want, f"{path}: launches {launches}, expected {want} "
                                    f"({VIT['depth']} blocks x {batches} batches)")
            log(f"[slice] {path}: launches {launches} ({VIT['depth']} blocks x {batches} "
                f"batches of {batch}); ingest + query {wall:.1f} s wall")
            err = check_hits(calls, results, n_g, n_q, VIT["c"])
            with vit_plain_versions():
                plain = reembed()
        with env_flags(XMIR_FLASH_ATTN="0", XMIR_FUSED_LN="0"):
            eager = reembed()
        emb = calls[0][1]
        diff = {"plain versions": (emb - plain).abs().max().item(),
                "eager, fused mlp" if mlp == "1" else "eager": (emb - eager).abs().max().item()}
        for k, v in diff.items():
            check(v <= VIT_EMBED_TOL[k], f"{path}: query embeddings differ from the {k}'s by "
                                         f"{v} > {VIT_EMBED_TOL[k]}")
        log(f"[slice] {path}: query embeddings vs the same model's {diff} (bounds "
            f"{VIT_EMBED_TOL})")
        out[path] = {"launches": launches, "err": err, "embedding_max_abs_err": diff}
    return out


def _kernel_bounds(b, dtype):
    """(operations, bytes) of one K2 / K7 / K8 call at the DINOv2 shape."""
    n, c, h = VIT["n"], VIT["c"], VIT["heads"]
    size = torch.empty((), dtype=dtype).element_size()
    return {
        "K2": (4 * b * h * n * n * (c // h), 4 * b * n * c * size),
        "K7": (2 * b * n * c * 3 * c, (4 * b * n * c + 3 * c * c) * size + (2 * c + 3 * c) * 4),
        "K8": (2 * b * n * c * 4 * c, (5 * b * n * c + 4 * c * c) * size + (2 * c + 4 * c) * 4),
    }


# the bf16 model's unit embeddings with the kernels against the same model
# with the kernels' plain versions and on the eager bf16 path: 2^-9 and
# 1.25 x 2^-9 seen (PERF.md); twice that is allowed
VIT_EMBED_BF16_TOL = {"plain versions": 4e-3, "eager": 5e-3}


def phase_vit_rates():
    gen = torch.Generator().manual_seed(10)
    b, n, c, h = 16, VIT["n"], VIT["c"], VIT["heads"]
    out = {key: {} for key in ("K2", "K7", "K8")}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            q, k, v = _attn_inputs(gen, b * h, n, c // h, dtype)
            x, lns, lnb, w, bias = _ln_inputs(gen, b, n, c, 3 * c, dtype)
            _, _, _, w1, b1 = _ln_inputs(gen, 1, 1, c, 4 * c, dtype)
            rows, sc = x.reshape(b * n, c), (c // h) ** -0.5
            q4, k4, v4 = (t.reshape(b, h, n, c // h) for t in (q, k, v))
            fns = {
                "K2": lambda: va.vit_attention_fused(q, k, v, sc),
                "K2 plain": lambda: va.attention_plain(q, k, v, sc),
                "K2 library": lambda: F.scaled_dot_product_attention(q4, k4, v4),
                "K7": lambda: ld.ln_qkv_fused(x, lns, lnb, w, bias, h),
                "K7 plain": lambda: ld.ln_qkv_reference(x, lns, lnb, w, bias, h),
                "K8": lambda: ld.ln_dense_fused(rows, lns, lnb, w1, b1, 1e-6, "gelu"),
                "K8 plain": lambda: ld.ln_dense_reference(rows, lns, lnb, w1, b1, 1e-6, "gelu"),
            }
            errs = {"K2": vit_err(fns["K2"](), fns["K2 plain"](), va.agreement, f"K2 {name} B=16"),
                    "K8": vit_err(fns["K8"](), fns["K8 plain"](), ld.agreement, f"K8 {name} B=16")}
            errs["K7"] = {}
            for o, r in zip(fns["K7"](), fns["K7 plain"]()):
                _worst(errs["K7"], vit_err(o, r, ld.agreement, f"K7 {name} B=16"))
            lib_err = (fns["K2"]().float() - fns["K2 library"]().reshape(q.shape).float()
                       ).abs().max().item()
            ms, _ = _in_turns(fns)
            bounds = _kernel_bounds(b, dtype)
            for key in out:
                ops, nbytes = bounds[key]
                bound_ms, bound_by = bound(ops, nbytes, name)
                out[key][name] = {"ms": ms[key], "plain_ms": ms[f"{key} plain"],
                                  "library_ms": ms.get(f"{key} library"), "bound_ms": bound_ms,
                                  "bound_by": bound_by, "agreement": errs[key]}
                lib = f", library call {ms[f'{key} library']:.3f} ms" if key == "K2" else ""
                log(f"[rates] {key} {name:8s} B=16 N={n} C={c}: {ms[key]:.3f} ms "
                    f"({ops / ms[key] / 1e9:.1f} TFLOP/s; bound {bound_ms:.3f} ms by {bound_by}) "
                    f"vs plain {ms[f'{key} plain']:.3f} ms{lib}; agreement {errs[key]}")
            log(f"[rates] K2 {name} vs scaled_dot_product_attention: max |diff| {lib_err:.3g}")
            del q, k, v, x, w, w1, rows, q4, k4, v4, fns
            torch.cuda.empty_cache()
    # the whole model in tools/bench_towers.py's configuration: bf16 weights
    # and input, batch 16, 518 px; the default rule sends bf16 blocks to K7 + K2
    model, _ = create_model("dinov2", generator=torch.Generator().manual_seed(11))
    with torch.no_grad():  # LayerScale at its 1e-5 init would hide the blocks
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(0.5)
    model = model.to("cuda", torch.bfloat16).eval()
    x = torch.randn((16, 518, 518, 3), generator=torch.Generator().manual_seed(12)).to(
        "cuda", torch.bfloat16)
    embed = make_embed_fn(model)

    def with_fused_mlp():
        with env_flags(XMIR_FUSED_LN_MLP="1"):
            return embed(x)

    def with_plain_versions():
        with vit_plain_versions():
            return embed(x)

    def eager_path():
        with env_flags(XMIR_FLASH_ATTN="0", XMIR_FUSED_LN="0"):
            return embed(x)

    with env_flags(XMIR_FLASH_ATTN=None, XMIR_FUSED_LN=None, XMIR_FUSED_LN_QKV=None,
                   XMIR_FUSED_LN_MLP=None):
        reset_launches()
        e = embed(x)
        launches = read_launches()
        check(launches["K2"] == launches["K7"] == VIT["depth"] and launches["K8"] == 0,
              f"bf16 blocks did not all take K7 and K2 (and no K8): {launches}")
        reset_launches()
        em = with_fused_mlp()
        check(read_launches()["K8"] == VIT["depth"], "XMIR_FUSED_LN_MLP=1 did not take K8")
        ep, ee = with_plain_versions(), eager_path()
        check(e.shape == (16, 768) and torch.isfinite(e).all(), "bad embeddings")
        diff = {"plain versions": (e - ep).abs().max().item(),
                "eager": (e - ee).abs().max().item()}
        for k, v in diff.items():
            check(v <= VIT_EMBED_BF16_TOL[k], f"bf16 embeddings with the kernels differ from "
                                              f"the {k}'s by {v} > {VIT_EMBED_BF16_TOL[k]}")
        mlp_diff = (em - ee).abs().max().item()
        check(mlp_diff <= VIT_EMBED_BF16_TOL["eager"], f"bf16 embeddings with K8 differ from "
                                                       f"the eager path's by {mlp_diff}")
        ms, runs = _in_turns({"kernels": lambda: embed(x), "kernels + K8": with_fused_mlp,
                              "plain versions": with_plain_versions, "eager": eager_path})
    rates = {k: 16 / v * 1e3 for k, v in ms.items()}
    log(f"[rates] DINOv2 ViT-B/14 bf16 batch 16 @518 (device only): "
        + "; ".join(f"{k} {ms[k]:.2f} ms = {rates[k]:.0f} img/s" for k in ms)
        + f"; the kernels' embeddings within {diff} of those paths' (bounds "
        f"{VIT_EMBED_BF16_TOL}), with K8 within {mlp_diff:.3g} of the eager path's; runs "
        f"{({k: [round(t, 2) for t in v] for k, v in runs.items()})}")
    out["embed_rate"] = rates
    return out


# SwinV2-Base at 384 px: (windows per image, heads, tokens per window, shifted,
# blocks of this shape per forward), head width 32 throughout
SWIN_SHAPES = ((16, 4, 576, False, 1), (16, 4, 576, True, 1), (4, 8, 576, False, 1),
               (4, 8, 576, True, 1), (1, 16, 576, False, 18), (1, 32, 144, False, 2))
SWIN_DEPTH = sum(s[4] for s in SWIN_SHAPES)  # 24 blocks: K4 (or K6) launches per batch
SWIN_HD = 32


def _swin_inputs(gen, b, nw, h, n, shifted, dtype, scale_max=100.0):
    """One block's attention operands in K4's fold (head, window, image):
    q, k, v (h nw b, n, 32), the bias (CPB + a random -100 shift mask, one
    slice per (head, window)) or (h, n, n), scales up to the clamp of 100."""
    q, k, v = (torch.randn((h * nw * b, n, SWIN_HD), generator=gen).to("cuda", dtype)
               for _ in range(3))
    groups = h * nw if shifted else h
    bias = (16 * torch.rand((groups, n, n), generator=gen)).cuda()
    if shifted:
        bias += torch.where(torch.rand((groups, n, n), generator=gen) < 0.4, -100.0, 0.0).cuda()
    scale = (1 + (scale_max - 1) * torch.rand(groups, generator=gen)).cuda()
    return q, k, v, bias, scale, (b if shifted else nw * b)


def _v1_inputs(q, k, v, bias, scale, b, nw, h, shifted):
    """The same block's operands as K6 takes them: (nw, b, h, n, 32) with q
    normalised and scaled and k normalised outside, bias (nw or 1, h, n, n)."""
    n = q.shape[1]
    per_head = scale.reshape(h, -1)[:, 0].reshape(1, 1, h, 1, 1)

    def layout(t):
        return t.reshape(h, nw, b, n, SWIN_HD).permute(1, 2, 0, 3, 4).contiguous()

    qf, kf = layout(q).float(), layout(k).float()
    qs = (qf * va.inv_norm(qf) * per_head).to(q.dtype)
    kn = (kf * va.inv_norm(kf)).to(q.dtype)
    b6 = (bias.reshape(h, nw, n, n).permute(1, 0, 2, 3).contiguous() if shifted
          else bias[None].contiguous())
    return qs, kn, layout(v), b6


def window_err(out, ref, what):
    e = va.window_agreement(out, ref)
    check(cb.agrees(e), f"{what}: the kernel differs from its plain version past the bounds of "
                        f"ops/vit_attn.py::window_agreement: {e}")
    return e


def phase_kernel_window():
    gen = torch.Generator().manual_seed(13)
    err = {"K4": {}, "K6": {}}
    cases = [(16, nw, h, n, sh, "Swin-B, B 16") for nw, h, n, sh, _ in SWIN_SHAPES] + [
        (2, 3, 2, 140, True, "ragged N"), (1, 2, 2, 77, True, "odd N"),
        (3, 1, 5, 1, False, "N 1"), (2, 4, 2, 144, False, "N 144")]
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            for b, nw, h, n, shifted, what in cases:
                q, k, v, bias, scale, g_size = _swin_inputs(gen, b, nw, h, n, shifted, dtype)
                shape = f"B={b} windows={nw} H={h} N={n} {'shifted' if shifted else 'unshifted'}"
                e4 = {}
                for cosine, sc in ((True, scale), (False, scale * 0.01)):
                    out = va.biased_attention_fused(q, k, v, bias, sc, g_size, cosine)
                    again = va.biased_attention_fused(q, k, v, bias, sc, g_size, cosine)
                    torch.cuda.synchronize()
                    check(torch.equal(out, again), f"K4 {name} {shape}: two runs differ")
                    _worst(e4, window_err(
                        out, va.biased_attention_plain(q, k, v, bias, sc, g_size, cosine),
                        f"K4 {name} {shape} cosine={cosine}"))
                    del out, again
                ops = _v1_inputs(q, k, v, bias, scale, b, nw, h, shifted)
                out = wa.window_attention_fused(*ops)
                check(torch.equal(out, wa.window_attention_fused(*ops)),
                      f"K6 {name} {shape}: two runs differ")
                e6 = window_err(out, wa.window_attention_plain(*ops), f"K6 {name} {shape}")
                _worst(err["K4"].setdefault(name, {}), e4)
                _worst(err["K6"].setdefault(name, {}), e6)
                log(f"[kernel] K4/K6 {name:8s} {shape} ({what}): K4 (cosine on / off) {e4}; "
                    f"K6 {e6}; each twice bit-equal")
                del q, k, v, bias, scale, ops, out
                torch.cuda.empty_cache()
            # every scale at the clamp, a mask that leaves rows one to three
            # live keys, and rows of tiny norm (1e-9: normalised; 1e-14: below
            # the clamp of 1e-24 on the sum of squares)
            q, k, v, bias, scale, g_size = _swin_inputs(gen, 4, 4, 2, 144, True, torch.float32)
            scale.fill_(100.0)
            bias[:, :, 3:] -= 100.0
            bias[:, ::5, 1:] -= 100.0
            q[:, ::7] *= 1e-9 / 5.6
            k[:, 2::9] *= 1e-14 / 5.6
            q, k, v = (t.to(dtype) for t in (q, k, v))
            out = va.biased_attention_fused(q, k, v, bias, scale, g_size, True)
            check(torch.isfinite(out.float()).all(), "K4: non-finite output at the clamp")
            e = window_err(out, va.biased_attention_plain(q, k, v, bias, scale, g_size, True),
                           f"K4 {name} scale 100, few live keys, tiny rows")
            _worst(err["K4"][name], e)
            log(f"[kernel] K4 {name:8s} scale 100, rows with one to three live keys, rows of "
                f"norm 1e-9 and 1e-14: {e}")
    return err


def phase_kernel_select():
    gen = torch.Generator().manual_seed(14)
    for dtype in (torch.float32, torch.bfloat16):
        for q_n, n, d in ((70, 4096, 96), (64, 100_000, 64)):
            for k in sorted({1025, 2048, 4096, n}):
                q, g = _int_inputs(gen, q_n, n, d, 1024, dtype)
                bias = torch.zeros(n, device="cuda")
                bias[n - 9:] = float("-inf")
                v, i = fused_topk_scores(q, g, bias, k)
                torch.cuda.synchronize()
                rv, ri = topk_scores_reference(q, g, bias, k)
                check(torch.equal(v, rv) and torch.equal(i, ri),
                      f"K1' integer inputs not bit-equal: {dtype} Q={q_n} N={n} D={d} k={k}")
                v1, i1 = fused_topk_scores(q, g, bias, 1024)
                check(torch.equal(v1, v[:, :1024]) and torch.equal(i1, i[:, :1024]),
                      f"K1' and K1 disagree on the first 1024: {dtype} N={n} k={k}")
            log(f"[kernel] K1' {str(dtype)[6:]:8s} Q={q_n} N={n} D={d}: k in 1025, 2048, 4096, N "
                "bit-equal to the plain version on integer inputs (ties across tiles, masked "
                "rows); first 1024 equal to K1's")
    q, g = _random_inputs(gen, 70, 4099, 96, torch.float32)
    bias = torch.zeros(4099, device="cuda")
    v, i = fused_topk_scores(q, g, bias, 2048)
    rv, ri = topk_scores_reference(q, g, bias, 2049)
    err, checked, total = compare(v, i, rv[:, :2048], ri[:, :2048], 1e-5, rv)
    log(f"[kernel] K1' random inputs k=2048: max err {err:.3g}, {checked}/{total} ids outside "
        "near-ties equal")
    return err


@contextlib.contextmanager
def swin_plain_versions():
    """The Swin model's kernel calls pointed at the kernels' plain versions."""
    saved = (swin_model.biased_attention_fused, swin_model.window_attention_fused)
    swin_model.biased_attention_fused = va.biased_attention_plain
    swin_model.window_attention_fused = wa.window_attention_plain
    try:
        yield
    finally:
        swin_model.biased_attention_fused, swin_model.window_attention_fused = saved


def randomize_swin_(backbone, seed):
    """Random nonzero LayerNorm, bias, q / v bias and logit_scale tensors
    (log 3 to log 60, one head of each block above the clamp) in place: at
    init they are 1 / 0 / log 10."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in backbone.named_parameters():
            if name.endswith("logit_scale"):
                p.copy_(1.1 + 3.0 * torch.rand(p.shape, generator=gen))
                p[0] = 5.0
            elif name.endswith((".bias", "q_bias", "v_bias")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif "norm" in name:
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=gen))
    return backbone


def write_swin_checkpoint(path, seed):
    """SwinV2-Base in timm's layout, wrapped in a ``swinv2.`` prefix, with
    timm's buffers and classifier, which the port's loader drops."""
    backbone = randomize_swin_(
        swin_model.swinv2_base_window12to24_192to384(torch.Generator().manual_seed(seed)),
        seed + 1)
    sd = {f"swinv2.{k}": v for k, v in backbone.state_dict().items()}
    sd.update({"swinv2.layers.0.blocks.1.attn_mask": torch.zeros(16, 576, 576),
               "swinv2.layers.0.blocks.0.attn.relative_position_index":
                   torch.zeros(576, 576, dtype=torch.long),
               "swinv2.head.fc.weight": torch.zeros(1000, 1024),
               "swinv2.head.fc.bias": torch.zeros(1000)})
    torch.save(sd, path)


# f32 unit embeddings of the SwinV2 slice's queries: the kernels against the
# same model with their plain versions (the f32 sums' order) and against the
# eager path (which also takes exp for exp2 and normalises q and k before
# the scale): 5.3e-8 and 5.6e-8 seen (PERF.md), 2e-6 allowed, which a
# moved rounding or a wrong bias slice passes by orders of magnitude
SWIN_EMBED_TOL = {"plain versions": 2e-6, "eager": 2e-6}


def phase_slice_swinv2(workdir: Path):
    t0 = time.perf_counter()
    n_g, n_q, batch = 32, 16, 16
    img_dir, g_manifest = write_synthetic_covidx(str(workdir / "s_gallery"), n=n_g, size=256,
                                                 seed=6)
    q_dir, q_manifest = write_synthetic_covidx(str(workdir / "s_queries"), n=n_q, size=256,
                                               seed=7)
    pt = str(workdir / "swinv2_timm.pt")
    write_swin_checkpoint(pt, seed=15)
    log(f"[slice] SwinV2: wrote {n_g} + {n_q} PNGs and a timm-layout .pt in "
        f"{time.perf_counter() - t0:.1f} s")
    gal, hits_path = str(workdir / "s_gallery.npz"), str(workdir / "s_hits.json")
    model_args = ["--model", "swinv2", "--device", "cuda", "--seed", "0", "--resume", pt,
                  "-j", "8"]
    test_args = ["--dataset", "covid", "--dataset-dir", q_dir, "--test-image-list",
                 q_manifest] + model_args
    q_args = test_args + ["--split", "test"]
    batches = -(-n_g // batch) + -(-n_q // batch)
    p = argparse.ArgumentParser()
    common.add_dataset_args(p)
    common.add_model_args(p)
    args, _ = p.parse_known_args(q_args)

    def reembed():
        model, spec = common.build_model(args, torch.device("cuda"))
        ref, _ = embed_dataset(common.build_dataset(args, "test"), make_embed_fn(model), spec,
                               device="cuda", batch_size=batch, num_workers=8)
        return ref

    out = {}
    for path, v1 in (("swinv2", ""), ("swinv2_v1", "v1")):
        calls = []
        kernel, other = ("K6", "K4") if v1 else ("K4", "K6")
        with env_flags(XMIR_FUSED_ATTN="1", XMIR_SWIN_KERNEL=v1):  # the f32 CLIs take the kernels
            reset_launches()
            with record_searches(calls):
                t0 = time.perf_counter()
                ingest.main(["--dataset", "covid", "--dataset-dir", img_dir,
                             "--train-image-list", g_manifest, "--split", "train",
                             "--output", gal, "--batch-size", str(batch)] + model_args)
                results = query.main(q_args + ["--index", gal, "--top-k", "10", "--output",
                                               hits_path, "--batch-size", str(batch)])
                wall = time.perf_counter() - t0
            launches = read_launches()
            want = dict.fromkeys(WRAPPERS, 0)
            want.update({"K1": 1, kernel: SWIN_DEPTH * batches})
            check(launches == want, f"{path}: launches {launches}, expected {want} "
                                    f"({SWIN_DEPTH} blocks x {batches} batches, no {other})")
            log(f"[slice] {path}: launches {launches} ({SWIN_DEPTH} blocks x {batches} batches "
                f"of {batch}); ingest + query {wall:.1f} s wall")
            err = check_hits(calls, results, n_g, n_q, 1024)
            out[path] = {"launches": launches, "err": err}
            if not v1:
                # the evaluation CLI on the query set: K4 again, and its artifact
                reset_launches()
                save_dir = str(workdir / "s_eval")
                metrics = test_cli.main(test_args + ["--save-dir", save_dir,
                                                     "--eval-batch-size", str(batch)])
                launches = read_launches()
                want = dict.fromkeys(WRAPPERS, 0)
                want["K4"] = SWIN_DEPTH * -(-n_q // batch)
                check(launches == want, f"cli.test: launches {launches}, expected {want}")
                out["swinv2_test"] = {"launches": launches, "err": 0.0,
                                      "metrics": check_evaluation(save_dir, metrics, n_q)}
            with swin_plain_versions():
                plain = reembed()
        with env_flags(XMIR_FUSED_ATTN="0"):
            eager = reembed()
        emb = calls[0][1]
        diff = {"plain versions": (emb - plain).abs().max().item(),
                "eager": (emb - eager).abs().max().item()}
        for k, v in diff.items():
            check(v <= SWIN_EMBED_TOL[k], f"{path}: query embeddings differ from the {k}'s by "
                                          f"{v} > {SWIN_EMBED_TOL[k]}")
        log(f"[slice] {path}: query embeddings vs the same model's {diff} (bounds "
            f"{SWIN_EMBED_TOL})")
        out[path]["embedding_max_abs_err"] = diff
    return out


def check_evaluation(save_dir, metrics, n):
    """cli.test's artifact: shapes, finite values, and every metric equal to
    what numpy makes of the artifact's own embeddings and labels."""
    art = np.load(os.path.join(save_dir, "evaluation_results.npz"))
    embeds, labels, dists = art["embeds"], art["labels"], art["dists"]
    check(embeds.shape == (n, 1024) and labels.shape == (n,) and dists.shape == (n, n),
          f"artifact shapes {embeds.shape}, {labels.shape}, {dists.shape}")
    check(np.isfinite(embeds).all() and np.isneginf(np.diag(dists)).all(), "bad artifact")
    e = embeds.astype(np.float64)
    exact = -np.sqrt(np.maximum(((e[:, None] - e[None]) ** 2).sum(-1), 0.0))
    off = ~np.eye(n, dtype=bool)
    d_err = np.abs(dists[off] - exact[off]).max()
    # sqrt(|a|^2 + |b|^2 - 2 a.b) of nearly equal unit rows cancels: an f32
    # residue of 2e-7 under the root is 5e-4 at worst
    check(d_err <= 2e-3, f"the artifact's distances lie {d_err} from numpy's")
    stored = json.loads(str(art["metrics"]))
    check(stored == json.loads(json.dumps(metrics, default=float)), "artifact metrics != returned")
    # R@K and majority vote at K = 1, recomputed from the stored distances
    order = np.argsort(-dists, axis=1, kind="stable")
    hit1 = labels[order[:, 0]] == labels
    check(abs(stored["R@1"] - 100.0 * hit1.mean()) <= 1e-9, "R@1 differs from numpy's")
    for k in (5, 10):
        hit = (labels[order[:, :k]] == labels[:, None]).any(axis=1)
        check(abs(stored[f"R@{k}"] - 100.0 * hit.mean()) <= 1e-9, f"R@{k} differs from numpy's")
    vote1 = labels[np.argsort(-dists, axis=0, kind="stable")[0]] == labels  # ranked by column
    check(abs(stored["classification"]["1"]["accuracy"] - 100.0 * vote1.mean()) <= 1e-9,
          "majority vote at K = 1 differs from numpy's")
    flat = [stored[k] for k in ("R@1", "R@5", "R@10", "mAP", "mP@1", "mP@5", "mP@10")] + [
        v for c in stored["classification"].values() for v in c.values()]
    check(len(flat) == 7 + 35 and np.isfinite(flat).all() and 0 < stored["mAP"] <= 100,
          "missing or non-finite metrics")
    log(f"[slice] cli.test: evaluation_results.npz holds {len(flat)} finite metrics (R@1 "
        f"{stored['R@1']:.2f}, mAP {stored['mAP']:.2f}) equal to numpy's; distances within "
        f"{d_err:.2g}")
    return {k: stored[k] for k in ("R@1", "R@5", "R@10", "mAP")}


def phase_slice_full_ranking(workdir: Path):
    """--top-k 0 over a gallery above 1024 rows: the select kernel's path."""
    t0 = time.perf_counter()
    n_g, n_q = 2048, 16
    img_dir, g_manifest = write_synthetic_covidx(str(workdir / "r_gallery"), n=n_g, size=64,
                                                 seed=8)
    q_dir, q_manifest = write_synthetic_covidx(str(workdir / "r_queries"), n=n_q, size=64, seed=9)
    log(f"[slice] full ranking: wrote {n_g} + {n_q} PNGs (64 px) in "
        f"{time.perf_counter() - t0:.1f} s")
    gal, hits_path = str(workdir / "r_gallery.npz"), str(workdir / "r_hits.json")
    model_args = ["--model", "densenet121", "--device", "cuda", "--seed", "0",
                  "--batch-size", "128", "-j", "8"]
    calls = []
    ingest.main(["--dataset", "covid", "--dataset-dir", img_dir, "--train-image-list",
                 g_manifest, "--split", "train", "--output", gal] + model_args)
    reset_launches()
    with record_searches(calls):
        results = query.main(["--dataset", "covid", "--dataset-dir", q_dir, "--test-image-list",
                              q_manifest, "--split", "test", "--index", gal, "--top-k", "0",
                              "--output", hits_path] + model_args)
    launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want["K1'"] = 1
    check(launches == want, f"--top-k 0: launches {launches}, expected {want}")
    idx, queries, k = calls[0]
    check(k == n_g and all(len(r["results"]) == n_g for r in results), "not the whole gallery")
    ids = torch.tensor([[h["id"] for h in r["results"]] for r in results], device="cuda")
    v = torch.tensor([[h["similarity"] for h in r["results"]] for r in results], device="cuda")
    rv, ri = topk_scores_reference(l2_normalize(queries), idx._device_embeds,
                                   torch.zeros(n_g, device="cuda"), n_g)
    check(torch.equal(ids.sort(dim=1).values, torch.arange(n_g, device="cuda").expand(n_q, -1)),
          "a ranking is no permutation of the gallery")
    err = (v - rv).abs().max().item()
    check(err <= 1e-5 and (v[:, 1:] <= v[:, :-1]).all(), f"ranking values differ by {err}")
    # equal scores keep row order, as a stable sort leaves them
    order_ok = (v[:, 1:] < v[:, :-1]) | (ids[:, 1:] > ids[:, :-1])
    check(order_ok.all(), "equal scores are not in row order")
    gaps = ranked_gaps(torch.cat([rv, rv[:, -1:] - 1], dim=1).double(), n_g)
    agree = ((ids == ri) | (gaps <= TIE_GAP)).all().item()
    check(agree, "ids differ from the stable sort away from near-ties")
    log(f"[slice] --top-k 0 over {n_g} rows: launches {launches}; every ranking a permutation "
        f"in stable order, values within {err:.3g} of the plain version's, "
        f"{int((gaps > TIE_GAP).sum())}/{gaps.numel()} ids outside near-ties equal")
    # Random-weight embeddings are nearly collinear, and with the gallery mean
    # taken out they still lie along a few directions, so few ids above lie
    # outside near-ties. The same embeddings with their spectrum flattened
    # (the residuals' first 64 principal directions, each scaled to unit
    # variance, for rows and queries alike) spread the scores: an index of
    # those, ranked in full, checks most ids of a ranking.
    mean = idx._device_embeds.mean(dim=0)
    u, sing, vh = torch.linalg.svd(idx._device_embeds - mean, full_matrices=False)
    spread_idx = ShardedGalleryIndex(dim=idx.dim, metric="cosine")
    spread_idx.add((u[:, :64] @ vh[:64]).cpu().numpy())
    spread_idx.build("cuda")
    spread = ((queries - mean) @ vh[:64].T / sing[:64]) @ vh[:64]
    check(torch.isfinite(spread).all(), "the flattened queries are not finite")
    before = select_topk_scores.launches
    sv, si = spread_idx.search(spread, n_g)
    check(select_topk_scores.launches == before + 1, "the spread ranking did not launch K1'")
    rv, ri = topk_scores_reference(l2_normalize(spread), spread_idx._device_embeds,
                                   torch.zeros(n_g, device="cuda"), n_g)
    s_err, s_checked, s_total = compare(sv, si, rv, ri, 1e-5,
                                        torch.cat([rv, rv[:, -1:] - 1], dim=1))
    check(2 * s_checked > s_total, f"only {s_checked}/{s_total} ids of the spread rankings lie "
                                   "outside near-ties")
    log(f"[slice] the whole ranking of {n_q} spread queries over the spread gallery: max err "
        f"{s_err:.3g}, {s_checked}/{s_total} ids outside near-ties checked equal")
    return launches, max(err, s_err)


def _window_work(b, nw, h, n, shifted, dtype):
    """(operations, bytes) of one K4 / K6 call: two matrix products per
    score, q / k / v / out once, the bias slices and scales once."""
    size = torch.empty((), dtype=dtype).element_size()
    bh, groups = b * nw * h, (nw * h if shifted else h)
    return 4 * bh * n * n * SWIN_HD, 4 * bh * n * SWIN_HD * size + groups * (n * n + 1) * 4


def phase_window_rates():
    gen = torch.Generator().manual_seed(16)
    b = 16
    out = {"K4": {}, "K6": {}}
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype)[6:]
            total = {key: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
                     for key in out}
            bound_by, fold_ms = set(), 0.0
            for nw, h, n, shifted, count in SWIN_SHAPES:
                q, k, v, bias, scale, g_size = _swin_inputs(gen, b, nw, h, n, shifted, dtype,
                                                            scale_max=30.0)
                ops6 = _v1_inputs(q, k, v, bias, scale, b, nw, h, shifted)
                # the library call on the same pre-normalised operands: heads
                # (and, shifted, windows) on the head axis so the mask broadcasts
                lq, lk, lv = (t.permute(1, 0, 2, 3, 4).reshape(b, -1, n, SWIN_HD) if shifted
                              else t.reshape(b * nw, h, n, SWIN_HD) for t in ops6[:3])
                mask = ops6[3].reshape(1, -1, n, n).to(dtype)
                # the model's copies around K4: three folds of (B, nw, H, N, hd)
                # into (H nw B, N, hd) and one back into (B nw, N, C)
                bw_qkv = q.reshape(h, nw, b, n, SWIN_HD).permute(2, 1, 0, 3, 4).contiguous()

                def folds():
                    for _ in range(3):
                        bw_qkv.permute(2, 1, 0, 3, 4).reshape(-1, n, SWIN_HD).contiguous()
                    q.reshape(h, nw, b, n, SWIN_HD).permute(2, 1, 3, 0, 4).reshape(b * nw, n, -1)

                fns = {
                    "K4": lambda: va.biased_attention_fused(q, k, v, bias, scale, g_size, True),
                    "K4 plain": lambda: va.biased_attention_plain(q, k, v, bias, scale, g_size,
                                                                  True),
                    "K6": lambda: wa.window_attention_fused(*ops6),
                    "K6 plain": lambda: wa.window_attention_plain(*ops6),
                    "library": lambda: F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                                                      scale=1.0),
                    "fold": folds,
                }
                shape = (f"B={b} windows={nw} H={h} N={n} "
                         f"{'shifted' if shifted else 'unshifted'} x{count}")
                e4 = window_err(fns["K4"](), fns["K4 plain"](), f"K4 {name} {shape}")
                e6 = window_err(fns["K6"](), fns["K6 plain"](), f"K6 {name} {shape}")
                lib = fns["library"]()
                lib = (lib.reshape(b, nw, h, n, SWIN_HD).permute(1, 0, 2, 3, 4) if shifted
                       else lib.reshape(nw, b, h, n, SWIN_HD))
                lib_err = (lib.float() - fns["K6"]().float()).abs().max().item()
                ms, _ = _in_turns(fns)
                work = _window_work(b, nw, h, n, shifted, dtype)
                bound_ms, by = bound(*work, name)
                bound_by.add(by)
                fold_ms += count * ms["fold"]
                for key in out:
                    out[key][f"{name} {shape}"] = {
                        "ms": ms[key], "plain_ms": ms[f"{key} plain"], "library_ms": ms["library"],
                        "bound_ms": bound_ms, "bound_by": by}
                    for field, value in (("ms", ms[key]), ("plain_ms", ms[f"{key} plain"]),
                                         ("library_ms", ms["library"]), ("bound_ms", bound_ms)):
                        total[key][field] += count * value
                log(f"[rates] {name:8s} {shape}: K4 {ms['K4']:.3f} ms "
                    f"({work[0] / ms['K4'] / 1e9:.1f} TFLOP/s; bound {bound_ms:.3f} ms by {by}) vs "
                    f"plain {ms['K4 plain']:.3f} ms; K6 {ms['K6']:.3f} ms vs plain "
                    f"{ms['K6 plain']:.3f} ms; library call {ms['library']:.3f} ms (max |diff| to "
                    f"K6 {lib_err:.3g}); K4's fold + unfold copies {ms['fold']:.3f} ms; agreement "
                    f"K4 {e4}, K6 {e6}")
                del q, k, v, bias, scale, ops6, lq, lk, lv, mask, bw_qkv, fns, lib
                torch.cuda.empty_cache()
            for key in out:
                out[key][name] = dict(total[key], bound_by="/".join(sorted(bound_by)))
            log(f"[rates] {name:8s} the {SWIN_DEPTH} calls of one SwinV2-Base forward at B={b}: "
                + "; ".join(f"{key} {total[key]['ms']:.3f} ms (plain {total[key]['plain_ms']:.3f}, "
                            f"library {total[key]['library_ms']:.3f}, bound "
                            f"{total[key]['bound_ms']:.3f})" for key in out)
                + f"; K4's fold + unfold copies {fold_ms:.3f} ms")
            out["K4"][name]["fold_ms"] = fold_ms
    return out


# the bf16 model's unit embeddings with the kernels against the same model
# with the kernels' plain versions and on the eager bf16 path (which rounds
# the normalised q and k to bf16 before the scale, where the kernels round
# after it): 2.9e-3 and 1.3e-2 seen, K6 7.3e-3 from the eager path (PERF.md);
# twice that is allowed
SWIN_EMBED_BF16_TOL = {"plain versions": 6e-3, "eager": 2.6e-2}


def _swin_bf16_model():
    """(embed function, input batch): SwinV2-Base with bf16 weights and a
    bf16 batch of 16 at 384 px, random nonzero vectors."""
    model, _ = create_model("swinv2", generator=torch.Generator().manual_seed(17))
    randomize_swin_(model.backbone, 18)
    model = model.to("cuda", torch.bfloat16).eval()
    x = torch.randn((16, 384, 384, 3), generator=torch.Generator().manual_seed(19)).to(
        "cuda", torch.bfloat16)
    return make_embed_fn(model), x


def profile_swin():
    """Where one bf16 SwinV2-Base batch's time goes (``--profile-swin``): the
    host's wall time per forward beside the device time by kernel name, from
    torch.profiler over three forwards on the default path (K4)."""
    from torch.profiler import ProfilerActivity, profile

    embed, x = _swin_bf16_model()
    for _ in range(3):
        embed(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        embed(x)
    enqueued = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            embed(x)
        torch.cuda.synchronize()
    # the kernels' own rows: an operator's row repeats the time of its kernels
    rows = [(e.key, e.self_device_time_total / 3e3, e.count / 3) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    log(f"[profile] SwinV2-Base bf16 batch 16 @384 with K4: {wall * 1e3:.2f} ms a forward on the "
        f"host's clock ({enqueued * 1e3:.2f} ms to enqueue it), {device_ms:.2f} ms of device "
        f"time in {sum(r[2] for r in rows):.0f} kernels: the device is idle "
        f"{max(0.0, 1 - device_ms / (wall * 1e3)):.0%} of a forward")
    for name, ms, count in rows[:30]:
        log(f"[profile] {ms:8.3f} ms  {count:6.0f} x  {name[:110]}")


def phase_swin_model_rates():
    """SwinV2-Base in tools/bench_towers.py's configuration: bf16 weights and
    input, batch 16, 384 px; the default rule sends bf16 blocks to K4."""
    embed, x = _swin_bf16_model()

    def with_v1():
        with env_flags(XMIR_SWIN_KERNEL="v1"):
            return embed(x)

    def with_plain_versions():
        with swin_plain_versions():
            return embed(x)

    def eager_path():
        with env_flags(XMIR_FUSED_ATTN="0"):
            return embed(x)

    with env_flags(XMIR_FUSED_ATTN=None, XMIR_SWIN_KERNEL=None):
        reset_launches()
        e = embed(x)
        launches = read_launches()
        check(launches["K4"] == SWIN_DEPTH and launches["K6"] == 0,
              f"bf16 blocks did not all take K4: {launches}")
        reset_launches()
        e6 = with_v1()
        launches = read_launches()
        check(launches["K6"] == SWIN_DEPTH and launches["K4"] == 0,
              f"XMIR_SWIN_KERNEL=v1 did not take K6: {launches}")
        ep, ee = with_plain_versions(), eager_path()
        check(e.shape == (16, 1024) and torch.isfinite(e).all(), "bad embeddings")
        diff = {"plain versions": (e - ep).abs().max().item(),
                "eager": (e - ee).abs().max().item()}
        v1_diff = (e6 - ee).abs().max().item()
        for k, v in list(diff.items()) + [("eager", v1_diff)]:
            check(v <= SWIN_EMBED_BF16_TOL[k], f"bf16 embeddings with the kernels differ from "
                                               f"the {k}'s by {v} > {SWIN_EMBED_BF16_TOL[k]}")
        ms, runs = _in_turns({"K4": lambda: embed(x), "K6": with_v1,
                              "plain versions": with_plain_versions, "eager": eager_path})
    rates = {k: 16 / v * 1e3 for k, v in ms.items()}
    log("[rates] SwinV2-Base bf16 batch 16 @384 (device only): "
        + "; ".join(f"{k} {ms[k]:.2f} ms = {rates[k]:.0f} img/s" for k in ms)
        + f"; K4's embeddings within {diff} of those paths' and K6's within {v1_diff:.3g} of the "
        f"eager path's (bounds {SWIN_EMBED_BF16_TOL}); runs "
        f"{({k: [round(t, 2) for t in v] for k, v in runs.items()})}")
    return rates


def phase_select_rates():
    """K1' at the serving gallery with k = 2048 and as a full ranking of 64
    queries, with K1 at k = 10 in the same turns."""
    n, d = 100_000, 1024
    gen = torch.Generator().manual_seed(20)
    q = l2_normalize(torch.randn((1024, d), generator=gen)).cuda()
    g = l2_normalize(torch.randn((n, d), generator=gen)).cuda()
    bias = torch.zeros(n, device="cuda")
    out = {}
    for label, q_n, k in (("Q=1024 k=2048", 1024, 2048), ("Q=64 k=N", 64, n)):
        qq = q[:q_n].contiguous()
        v, i = fused_topk_scores(qq, g, bias, k)
        rv, ri = topk_scores_reference(qq[:64], g, bias, min(k + 1, n))
        torch.cuda.synchronize()
        sorted_ref = rv if k < n else torch.cat([rv, rv[:, -1:] - 1], dim=1)
        err, checked, total = compare(v[:64], i[:64], rv[:, :k], ri[:, :k], 1e-5, sorted_ref)
        # what one K1' call allocates: its result and its scratch, the plain
        # version's Q x N scores and sort left out of the reading
        del v, i, rv, ri, sorted_ref
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        held = fused_topk_scores(qq, g, bias, k)
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        result_mib = sum(t.numel() * t.element_size() for t in held) / 2 ** 20
        del held
        ms, runs = _in_turns({
            "K1'": lambda: fused_topk_scores(qq, g, bias, k),
            "plain": lambda: topk_scores_reference(qq, g, bias, k),
            "K1 k=10": lambda: fused_topk_scores(q, g, bias, 10)}, rounds=3, reps=2)
        bound_ms, bound_by = bound(2 * q_n * n * d, (q_n + n) * d * 4 + n * 4 + q_n * k * 8,
                                   "float32")
        out[label] = {"ms": ms["K1'"], "plain_ms": ms["plain"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "max_abs_err": err, "k1_k10_ms": ms["K1 k=10"],
                      "peak_mib": peak_mib, "result_mib": result_mib}
        sel_ms = ms["K1'"]
        log(f"[rates] K1' float32 {label} N={n} D={d}: {sel_ms:.3f} ms "
            f"({2 * q_n * n * d / sel_ms / 1e9:.1f} TFLOP/s; bound "
            f"{bound_ms:.3f} ms by {bound_by}) vs plain {ms['plain']:.3f} ms; K1 at k=10 in the "
            f"same turns {ms['K1 k=10']:.3f} ms; max err {err:.3g}, {checked}/{total} ids of the "
            f"first 64 queries checked equal; one K1' call alone peaks {peak_mib:.0f} MiB above "
            f"its inputs, {result_mib:.0f} MiB of it the result; runs "
            f"{({k_: [round(t, 2) for t in v_] for k_, v_ in runs.items()})}")
        torch.cuda.empty_cache()
    return out

def grad_err(outs, refs, floors, what):
    """The worst ``va.grad_agreement`` reading over (dq, dk, dv), each with
    its ``va.grad_floors`` entry; raises past the bounds stated in
    ops/vit_attn.py."""
    worst = {}
    for name, out, ref, floor in zip(("dq", "dk", "dv"), outs, refs, floors):
        e = va.grad_agreement(out, ref, floor)
        check(va.grad_agrees(e), f"{what} {name}: K3 differs from its plain version past the "
                                 f"bounds (GRAD_RTOL, GRAD_MEAN_RTOL): {e}")
        _worst(worst, e)
    return worst


def attention_grads(q, k, v, g, sc):
    """(out, (dq, dk, dv)) through the Function: K2 forward, K3 backward."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = va.vit_attention_fused(*leaves, sc)
    return out.detach(), torch.autograd.grad(out, leaves, g)


# f32 K3 against the exact gradient, of the largest magnitude (va.grad_floors at least)
K3_EXACT_RTOL = 3e-5


def phase_kernel_bwd():
    gen = torch.Generator().manual_seed(21)
    err = {"K3": {}, "K7 backward": {}}
    cases = [(24, 1370, 64, "DINOv2, B 2"), (4, 729, 72, "hd 72 as 80"), (6, 64, 32, "one tile"),
             (2, 1, 64, "N 1"), (3, 137, 128, "hd 128")]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        inputs = [(_attn_inputs(gen, bh, n, hd, dtype), _attn_inputs(gen, bh, n, hd, dtype)[0],
                   hd ** -0.5, f"BH={bh} N={n} hd={hd} ({what})") for bh, n, hd, what in cases]
        # every score very negative with one dominant key in the last tile,
        # and scores scaled up so that a row has few dominant keys
        q, k, v = _attn_inputs(gen, 4, 300, 64, torch.float32)
        g = _attn_inputs(gen, 4, 300, 64, dtype)[0]
        qn, kn = -q.abs() * 3, k.abs() * 3
        kn[:, 290] *= -4.0
        inputs.append(((qn.to(dtype), kn.to(dtype), v.to(dtype)), g, 0.125,
                       "negative scores, one dominant key"))
        inputs.append((((q * 4).to(dtype), k.to(dtype), v.to(dtype)), g, 0.125,
                       "few dominant keys"))
        # every shift below -128: 2^-m of an unmasked dead key column would overflow
        inputs.append((((-q.abs() * 8).to(dtype), (k.abs() * 8).to(dtype), v.to(dtype)), g, 0.125,
                       "scores below -128"))
        for (q, k, v), g, sc, what in inputs:
            out, grads = attention_grads(q, k, v, g, sc)
            _, again = attention_grads(q, k, v, g, sc)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(grads, again)),
                  f"K3 {name} {what}: two runs differ")
            check(all(torch.isfinite(t.float()).all() for t in grads), f"K3 {name} {what}: "
                                                                       "non-finite gradients")
            floors = va.grad_floors(q, k, v, g, sc)
            e = grad_err(grads, va.attention_bwd_plain(q, k, v, out, g, sc), floors,
                         f"K3 {name} {what}")
            _worst(err["K3"].setdefault(name, {}), e)
            exact = ""
            # against the exact gradient on the random cases; where the softmax
            # saturates both sides are residues of dp - c
            if dtype == torch.float32 and what.startswith("BH="):
                rel = max(((a - b).abs().max() / torch.maximum(b.abs().max(), floor)).item()
                          for a, b, floor in zip(
                              grads, va.attention_bwd_reference(q, k, v, g, sc), floors))
                check(rel <= K3_EXACT_RTOL, f"K3 f32 {what}: {rel} of the largest magnitude from "
                                            f"the exact gradient > {K3_EXACT_RTOL}")
                exact = f"; within {rel:.2g} of the exact gradient (bound {K3_EXACT_RTOL})"
            log(f"[kernel] K3 {name:8s} {what}: {e}; twice bit-equal{exact}")
        # K7's backward (plain tensor code on the card) against autograd
        # through its plain forward: of each gradient's largest magnitude
        tol = 1e-5 if dtype == torch.float32 else 2 ** -6
        x, lns, lnb, w, bias = _ln_inputs(gen, 2, VIT["n"], VIT["c"], 3 * VIT["c"], dtype)
        cot = [torch.randn((2, VIT["heads"], VIT["n"], 64), generator=gen).to("cuda", dtype)
               for _ in range(3)]
        leaves = [t.detach().requires_grad_(True) for t in (x, lns, lnb, w, bias)]
        got = torch.autograd.grad(ld.ln_qkv_fused(*leaves, VIT["heads"]), leaves, cot)
        f32 = [t.detach().float().requires_grad_(True) for t in (x, lns, lnb, w, bias)]
        ref = torch.autograd.grad(ld.ln_qkv_reference(*f32, VIT["heads"]), f32,
                                  [t.float() for t in cot])
        rel = {n_: ((a.float() - b).abs().max() / b.abs().max()).item()
               for n_, a, b in zip(("dx", "dlns", "dlnb", "dw", "db"), got, ref)}
        check(max(rel.values()) <= tol, f"K7 backward {name}: {rel} of the largest magnitude "
                                        f"from autograd through the plain forward > {tol}")
        err["K7 backward"][name] = rel
        log(f"[kernel] K7 backward {name:8s} B=2 N={VIT['n']} C={VIT['c']}: {rel} of each "
            f"gradient's largest magnitude from the f32 autograd gradient (bound {tol:.3g})")
    return err


def _train_args(img_dir, manifest, val_dir, val_manifest, model, save_dir, log_path, *extra):
    return ["--dataset", "covid", "--dataset-dir", img_dir, "--train-image-list", manifest,
            "--val-dataset-dir", val_dir, "--val-image-list", val_manifest, "--model", model,
            "--device", "cuda", "--seed", "0", "-k", "4", "-j", "8", "--print-freq", "1",
            # on unit embeddings a margin of 2 keeps every triplet active: every
            # step has a gradient, however far apart random weights put the classes
            "--margin", "2.0",
            "--eval-freq", "1", "--ckpt-every", "1", "--eval-batch-size", "8", "--save-dir",
            save_dir, "--metrics-log", log_path, *extra]


def _option(extra, flag, default=None):
    return extra[extra.index(flag) + 1] if flag in extra else default


def make_trainer(workdir, model, data, *common_args):
    """run(name, *extra) -> (losses [(epoch, step, loss)], the last epoch's
    checkpoint path): cli.train.main on ``data`` into ``workdir / name``."""
    def run(name, *extra):
        extra = (*common_args, *extra)
        save, log_path = str(workdir / name), str(workdir / f"{name}.jsonl")
        train_cli.main(_train_args(*data, model, save, log_path, *extra))
        dim = _option(extra, "--embedding-dim")
        path = os.path.join(save, checkpoint_name(
            "covid", model, embedding_dim=dim and int(dim), rand_resize="--rand-resize" in extra,
            seed=0, epoch=int(_option(extra, "--epochs"))))
        check(os.path.isfile(path) and os.path.isfile(path + ".json"), f"no checkpoint {path}")
        records = [json.loads(line) for line in Path(log_path).read_text().splitlines()]
        losses = [(r["epoch"], r["step"], r["loss"]) for r in records if r["kind"] == "train"]
        check(losses and all(np.isfinite(v) for _, _, v in losses),
              f"{name}: non-finite or no losses: {losses}")
        check(all(np.isfinite(r["mAP"]) for r in records if r["kind"] == "eval"),
              f"{name}: non-finite evaluation")
        return losses, path

    return run


def pk_steps(manifest, p, k, epoch, seed=0):
    """Train steps of one epoch: the full batches cli.train's PKSampler
    yields for that (seed, epoch)."""
    from xmir_tpu_torch.data.datasets import COVIDX_LABEL_MAP
    from xmir_tpu_torch.data.samplers import PKSampler

    labels = [COVIDX_LABEL_MAP[line.split()[2]]
              for line in Path(manifest).read_text().splitlines()]
    return len(list(PKSampler(labels, p, k, seed=seed + epoch))) // (p * k)


def check_resume(run, steps, what, *first_args):
    """One epoch (started with ``first_args``), then --resume of its
    checkpoint for a second, against two epochs in one run: the second
    epoch's losses and the final tensors are bit-equal. ``steps``: the train
    steps of epochs 1 and 2. Returns the first epoch's checkpoint."""
    first, ckpt1 = run("first", *first_args, "--epochs", "1")
    whole, ckpt_w = run("whole", *first_args, "--epochs", "2")
    second, ckpt_2 = run("second", "--epochs", "2", "--resume", ckpt1)
    check([len(first), len(whole)] == [steps[0], sum(steps)],
          f"{what}: {len(first)} and {len(whole)} steps, expected {steps}")
    check(whole[:steps[0]] == first, f"{what}: two runs of epoch 1 differ: {whole} {first}")
    check(second and second[0][0] == 2, f"{what}: the resumed run did not continue at epoch 2")
    check(second == whole[steps[0]:],
          f"{what}: the resumed epoch's losses {second} are not the uninterrupted run's "
          f"{whole[steps[0]:]}")
    a, b = load_checkpoint(ckpt_w, unwrap=False), load_checkpoint(ckpt_2, unwrap=False)
    check(a["step"] == b["step"] == sum(steps) and a["epoch"] == b["epoch"] == 2,
          f"{what}: steps {a['step']} / {b['step']}")
    check(all(torch.equal(v, b["state_dict"][key]) for key, v in a["state_dict"].items()),
          f"{what}: the resumed run's final tensors differ from the uninterrupted run's")
    check(all(torch.equal(v, b["optimizer"]["state"][i][key])
              for i, st in a["optimizer"]["state"].items() for key, v in st.items()),
          f"{what}: the resumed run's Adam moments differ")
    log(f"[slice] {what}: --resume continues at epoch 2; its {len(second)} losses and the final "
        f"parameters, buffers and Adam moments equal the uninterrupted run's bit for bit "
        f"(losses {[round(v, 4) for _, _, v in whole]})")
    return ckpt1


# f32 parameters after an epoch's train steps with the kernels against the
# same steps with their plain versions: the mean distance between the two
# runs' parameters as a share of the mean movement. 2.6e-6 to 2.8e-6 seen;
# with the softmax scale left out of dk (chip_faults.py) 0.11 (PERF.md)
TRAIN_F32_MEAN_TOL = 1e-3


def dinov2_train_setup(workdir: Path, p=2, k=4):
    """The training slice's inputs: (data, a timm-layout .pt to start from,
    the model's state dict after loading it, the train steps of epochs 1 and
    2, evaluation batches an epoch)."""
    t0 = time.perf_counter()
    n_train, n_val = 24, 16
    data = (*write_synthetic_covidx(str(workdir / "t_train"), n=n_train, size=256, seed=10),
            *write_synthetic_covidx(str(workdir / "t_val"), n=n_val, size=256, seed=11))
    pt = str(workdir / "dinov2_timm.pt")
    write_vit_checkpoint(pt, seed=25)
    log(f"[slice] train: wrote {n_train} + {n_val} PNGs and a timm-layout .pt in "
        f"{time.perf_counter() - t0:.1f} s")
    start, _ = create_model("dinov2", generator=torch.Generator().manual_seed(0))
    start = load_torch_checkpoint(start, pt).state_dict()
    return data, pt, start, [pk_steps(data[1], p, k, epoch) for epoch in (1, 2)], -(-n_val // 8)


def f32_kernels_against_plain(run, pt, start, steps):
    """An epoch's f32 train steps (under FUSED_VIT) with the kernels, then
    with their plain versions: how far apart the parameters end, as a share
    of how far they moved."""
    reset_launches()
    _, f32_ckpt = run("f32", "--epochs", "1", "--resume", pt)
    check(read_launches()["K3"] == VIT["depth"] * steps, "the f32 steps did not take K3")
    with vit_plain_versions():
        reset_launches()
        _, plain_ckpt = run("f32_plain", "--epochs", "1", "--resume", pt)
        check(not any(read_launches().values()), "the plain versions launched a kernel")
    a, b = load_checkpoint(f32_ckpt), load_checkpoint(plain_ckpt)
    moved = torch.cat([(v - start[key]).abs().flatten() for key, v in b.items()])
    apart = torch.cat([(v - b[key]).abs().flatten() for key, v in a.items()])
    return {"mean_apart_of_mean_moved": (apart.mean() / moved.mean()).item(),
            "max_apart": apart.max().item(), "mean_moved": moved.mean().item(),
            "share_outside_1e-6": (apart > 1e-6).float().mean().item()}


def phase_train_dinov2(workdir: Path):
    p = 2
    data, pt, start, steps, eval_batches = dinov2_train_setup(workdir, p)
    run = make_trainer(workdir, "dinov2", data, "-p", str(p))
    out = {}
    # the bf16 step takes K7 + K2 + K3 by the default rule; the in-training
    # evaluation embeds in f32, which takes K7 + K2 under the switches
    with env_flags(XMIR_FUSED_LN_MLP=None, **FUSED_VIT):
        reset_launches()
        t0 = time.perf_counter()
        losses, ckpt = run("main", "--bf16", "--epochs", "1", "--resume", pt)
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = dict.fromkeys(WRAPPERS, 0)
        forwards = steps[0] + eval_batches
        want.update({"K2": VIT["depth"] * forwards, "K7": VIT["depth"] * forwards,
                     "K3": VIT["depth"] * steps[0]})
        check(launches == want, f"cli.train dinov2: launches {launches}, expected {want} "
                                f"({VIT['depth']} blocks x {steps[0]} steps + {eval_batches} "
                                "evaluation batches)")
        check(len(losses) == steps[0], f"{len(losses)} losses for {steps[0]} steps")
        log(f"[slice] cli.train dinov2 --bf16: launches {launches} ({VIT['depth']} blocks x "
            f"({steps[0]} train steps + {eval_batches} evaluation batches) forwards, x "
            f"{steps[0]} backwards); losses {[round(v, 4) for _, _, v in losses]}; {wall:.1f} s "
            "wall")
        out["launches"] = launches
        trained = load_checkpoint(ckpt)
        still = [key for key, v in trained.items() if torch.equal(v, start[key])]
        check(not still, f"parameters that did not move: {still}")
        check(all(torch.isfinite(v).all() for v in trained.values()), "non-finite parameters")
        reset_launches()
        _, frozen_ckpt = run("frozen", "--bf16", "--epochs", "1", "--resume", pt,
                             "--freeze-backbone", "--embedding-dim", "64")
        frozen_launches = read_launches()
        frozen = load_checkpoint(frozen_ckpt)
        fresh64, _ = create_model("dinov2", embedding_dim=64,
                                  generator=torch.Generator().manual_seed(0))
        fresh64 = dict(fresh64.state_dict(), **start)  # the same backbone, a seeded head
        for key, v in frozen.items():
            check(torch.equal(v, fresh64[key]) == key.startswith("backbone."),
                  f"--freeze-backbone: {key} " + ("moved" if key.startswith("backbone.")
                                                  else "did not move"))
        log(f"[slice] cli.train dinov2: every tensor moved; under --freeze-backbone the "
            f"backbone's {sum(key.startswith('backbone.') for key in frozen)} tensors did not "
            f"and the head's did (the backward stops at the head: launches {frozen_launches})")
        check_resume(make_trainer(workdir, "dinov2", data, "-p", str(p), "--bf16"), steps,
                     "cli.train dinov2 --bf16", "--resume", pt)
        reading = f32_kernels_against_plain(run, pt, start, steps[0])
    check(reading["mean_apart_of_mean_moved"] <= TRAIN_F32_MEAN_TOL,
          f"f32 parameters after {steps[0]} steps with the kernels differ from the plain "
          f"versions' past the bound {TRAIN_F32_MEAN_TOL}: {reading}")
    log(f"[slice] cli.train dinov2 f32, {steps[0]} steps, kernels against their plain versions: "
        f"{reading} (bound on the first {TRAIN_F32_MEAN_TOL})")
    out["f32_vs_plain"] = reading
    return out


def phase_train_densenet(workdir: Path):
    n_train, n_val, p, k = 36, 16, 3, 4
    data = (*write_synthetic_covidx(str(workdir / "d_train"), n=n_train, size=256, seed=12),
            *write_synthetic_covidx(str(workdir / "d_val"), n=n_val, size=256, seed=13))
    steps = [pk_steps(data[1], p, k, epoch) for epoch in (1, 2)]
    run = make_trainer(workdir, "densenet121", data, "-p", str(p), "--rand-resize")
    reset_launches()
    ckpt = check_resume(run, steps, "cli.train densenet121 (f32, no kernel)")
    launches = read_launches()
    check(not any(launches.values()), f"DenseNet121 training launched a kernel: {launches}")
    trained = load_checkpoint(ckpt)
    fresh, _ = create_model("densenet121", generator=torch.Generator().manual_seed(0))
    fresh = fresh.state_dict()
    check(all(not torch.equal(v, fresh[key]) for key, v in trained.items()),
          "a DenseNet121 tensor did not move")
    drift = max((trained[key] - fresh[key]).abs().max().item() for key in trained
                if key.endswith("running_var"))
    check(drift > 1e-3, f"the running variances moved by {drift} only")
    log(f"[slice] cli.train densenet121: every parameter and running statistic moved in "
        f"{steps[0]} steps (running variances by up to {drift:.3g}); launches {launches}")
    return launches


def _bwd_work(bh, n, hd, dtype):
    """(operations, bytes) of one K3 call: five products of 2 n^2 hd a head;
    q, k, v, o, g read and dq, dk, dv written once."""
    size = torch.empty((), dtype=dtype).element_size()
    return 10 * bh * n * n * hd, 8 * bh * n * hd * size


def phase_bwd_rates():
    gen = torch.Generator().manual_seed(22)
    n, hd, h = VIT["n"], VIT["c"] // VIT["heads"], VIT["heads"]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for b in (16, 8):
            bh, sc = b * h, hd ** -0.5
            q, k, v = _attn_inputs(gen, bh, n, hd, dtype)
            g = _attn_inputs(gen, bh, n, hd, dtype)[0]
            o, stats = va.launch_attention_forward(q, k, v, sc, want_stats=True)
            # the library call: one SDPA forward, its graph kept, its backward timed alone
            lq, lk, lv = (t.reshape(b, h, n, hd).detach().requires_grad_(True) for t in (q, k, v))
            lo = F.scaled_dot_product_attention(lq, lk, lv)
            lg = g.reshape(b, h, n, hd)
            fns = {
                "K3": lambda: va.vit_attention_bwd(q, k, v, o, g, stats, sc),
                "K3 plain": lambda: va.attention_bwd_plain(q, k, v, o, g, sc),
                "K3 library": lambda: torch.autograd.grad(lo, (lq, lk, lv), lg,
                                                          retain_graph=True),
                "K2": lambda: va.launch_attention_forward(q, k, v, sc, want_stats=True),
            }
            e = grad_err(fns["K3"](), fns["K3 plain"](), va.grad_floors(q, k, v, g, sc),
                         f"K3 {name} B={b}")
            lib_rel = max(((a.float() - r.reshape(a.shape).float()).abs().max()
                           / a.float().abs().max()).item()
                          for a, r in zip(fns["K3"](), fns["K3 library"]()))
            ms, _ = _in_turns(fns)
            ops, nbytes = _bwd_work(bh, n, hd, dtype)
            bound_ms, bound_by = bound(ops, nbytes, name)
            out[f"{name} B={b}"] = {"ms": ms["K3"], "plain_ms": ms["K3 plain"],
                                    "library_ms": ms["K3 library"], "forward_ms": ms["K2"],
                                    "bound_ms": bound_ms, "bound_by": bound_by, "agreement": e}
            log(f"[rates] K3 {name:8s} B={b} BH={bh} N={n} hd={hd}: {ms['K3']:.3f} ms "
                f"({ops / ms['K3'] / 1e9:.1f} TFLOP/s of the 10 BH N^2 hd it must do; bound "
                f"{bound_ms:.3f} ms by {bound_by}) vs plain {ms['K3 plain']:.3f} ms, library "
                f"backward {ms['K3 library']:.3f} ms, K2 with statistics {ms['K2']:.3f} ms; "
                f"agreement {e}; within {lib_rel:.3g} of the library's gradients' largest "
                "magnitude")
            del q, k, v, g, o, stats, lq, lk, lv, lo, lg, fns
            torch.cuda.empty_cache()
    return out


def phase_train_rates():
    """The bf16 DINOv2 ViT-B/14 train step at batch 8, 518 px (f32 master
    weights, triplet loss): with the kernels, with their plain versions and
    on the eager path, in turns; peak memory of each; and where a step's time
    goes."""
    model, _ = create_model("dinov2", generator=torch.Generator().manual_seed(23))
    with torch.no_grad():  # LayerScale at its 1e-5 init would hide the blocks
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(0.5)
    model = model.to("cuda").train()
    state = TrainState(model, build_optimizer(model, lr=1e-5))
    step = make_embedding_train_step(model, "triplet", {"margin": 0.2},
                                     compute_dtype=torch.bfloat16)
    x = torch.randn((8, 518, 518, 3), generator=torch.Generator().manual_seed(24)).cuda()
    labels = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], device="cuda")

    def with_kernels():
        return step(state, x, labels)

    def with_plain_versions():
        with vit_plain_versions():
            return step(state, x, labels)

    def eager_path():
        with env_flags(XMIR_FLASH_ATTN="0", XMIR_FUSED_LN="0"):
            return step(state, x, labels)

    def forward_only():
        step.loss_and_aux(x, labels)

    def forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        step.loss_and_aux(x, labels)[0].backward()

    paths = {"kernels": with_kernels, "plain versions": with_plain_versions, "eager": eager_path}
    out = {}
    with env_flags(XMIR_FLASH_ATTN=None, XMIR_FUSED_LN=None, XMIR_FUSED_LN_QKV=None,
                   XMIR_FUSED_LN_MLP=None):
        reset_launches()
        loss = with_kernels()["loss"]
        launches = read_launches()
        check(launches["K2"] == launches["K7"] == launches["K3"] == VIT["depth"],
              f"the bf16 step did not take K7, K2 and K3 in every block: {launches}")
        check(torch.isfinite(loss).item(), "non-finite loss")
        peak = {}
        for name, fn in paths.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        ms, runs = _in_turns({**paths, "forward": forward_only,
                              "forward + backward": forward_backward}, rounds=3, reps=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            with_kernels()
        enqueue = (time.perf_counter() - t0) / 3 * 1e3
        torch.cuda.synchronize()
    for name in paths:
        out[name] = {"ms": ms[name], "img_per_s": 8 / ms[name] * 1e3, "peak_gib": peak[name]}
    shares = {"forward": ms["forward"], "backward": ms["forward + backward"] - ms["forward"],
              "optimiser": ms["kernels"] - ms["forward + backward"]}
    out["shares_ms"] = shares
    out["enqueue_ms"] = enqueue
    log("[rates] DINOv2 ViT-B/14 bf16 train step, batch 8 @518 (device time): "
        + "; ".join(f"{k} {v['ms']:.2f} ms = {v['img_per_s']:.1f} img/s, peak {v['peak_gib']:.2f} "
                    "GiB" for k, v in out.items() if isinstance(v, dict) and "ms" in v)
        + f"; with the kernels a step is forward {shares['forward']:.2f} ms + backward "
        f"{shares['backward']:.2f} ms + optimiser {shares['optimiser']:.2f} ms, and the host "
        f"enqueues it in {enqueue:.2f} ms; runs "
        f"{({k: [round(t, 2) for t in v] for k, v in runs.items()})}")
    return out


# --- ConvNeXtV2 training: K10 ------------------------------------------------


def tail_bwd_inputs(gen, b, hw, c, dtype):
    """(x, the block's parameters, h = dwconv(x) as (B, R, C) rows, a
    cotangent dy) for one block of width c at hw x hw."""
    x, a = _tail_inputs(gen, b, hw, c, dtype)
    h = cb.dwconv(x, a["dw_weight"], a["dw_bias"]).reshape(b, hw * hw, c)
    dy = torch.randn(h.shape, generator=gen).to("cuda", dtype)
    return x, a, h, dy


def tail_args(a):
    """K10's parameters (ln_scale, ln_bias, w1, b1, w2, gamma, beta) of a
    block's parameter dict."""
    return tuple(a[k] for k in ("ln_scale", "ln_bias", "w1", "b1", "w2", "gamma", "beta"))


def tail_bwd_err(outs, refs, floors, dtype, what):
    """The worst ``va.grad_agreement`` reading (K10's floors, the run's
    dtype) over K10's eight outputs; raises past the bounds stated in
    ops/vit_attn.py."""
    worst = {}
    for name, out, ref, floor in zip(cb.TAIL_GRAD_NAMES, outs, refs, floors):
        e = va.grad_agreement(out, ref, floor, dtype)
        check(va.grad_agrees(e), f"{what} {name}: K10 differs from its plain version past the "
                                 f"bounds (GRAD_RTOL, GRAD_MEAN_RTOL): {e}")
        _worst(worst, e)
    return worst


def block_grads(fn, x, a, g):
    """The eleven gradients of fn(x, **a) at cotangent g."""
    leaves = [t.detach().requires_grad_(True) for t in (x, *a.values())]
    out = fn(leaves[0], **dict(zip(a, leaves[1:])))
    return torch.autograd.grad(out, leaves, g)


# the Function's eleven gradients (K9 forward, K10 backward) against autograd
# through the plain forward in f32, of each gradient's largest magnitude: f32
# differs by the sums' order; bf16 by its roundings of the block's operands,
# the tail's intermediates and the gradients themselves
BLOCK_GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -5}
# ConvNeXtV2-Base's stage shapes at 384 px (B = 2), ragged rows, one row, and
# the tiny model's width
TAIL_BWD_CASES = [(2, hw, c, f"stage {i + 1}") for i, (hw, c) in enumerate(STAGES)] + [
    (2, 7, 96, "R 49, C 96"), (2, 1, 96, "R 1, C 96"), (3, 12, 128, "144 rows, B 3")]


def phase_kernel_tail_bwd():
    gen = torch.Generator().manual_seed(31)
    err = {"K10": {}, "block": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for b, hw, c, what in TAIL_BWD_CASES:
            x, a, h, dy = tail_bwd_inputs(gen, b, hw, c, dtype)
            p = tail_args(a)
            outs = cb.convnext_tail_bwd(h, dy, *p)
            again = cb.convnext_tail_bwd(h, dy, *p)
            torch.cuda.synchronize()
            check(all(torch.equal(u, v) for u, v in zip(outs, again)),
                  f"K10 {name} {what}: two runs differ")
            check(all(torch.isfinite(t.float()).all() for t in outs),
                  f"K10 {name} {what}: non-finite gradients")
            e = tail_bwd_err(outs, cb.tail_backward_reference(h, dy, *p),
                             cb.tail_grad_floors(h, dy, *p), dtype,
                             f"K10 {name} B={b} {hw}x{hw} C={c}")
            _worst(err["K10"].setdefault(name, {}), e)
            log(f"[kernel] K10 {name:8s} B={b} {hw:2d}x{hw:2d} C={c:4d} ({what}): {e}; twice "
                "bit-equal")
        # the Function's eleven gradients against autograd through the plain
        # forward in f32
        for b, hw, c, what in (TAIL_BWD_CASES[1], TAIL_BWD_CASES[4]):
            x, a, h, dy = tail_bwd_inputs(gen, b, hw, c, dtype)
            g = dy.reshape(x.shape)
            got = block_grads(cb.convnext_block_fused, x, a, g)
            ref = block_grads(plain_block, x.float(), {k: v.float() for k, v in a.items()},
                              g.float())
            rel = {n_: ((u.float() - v).abs().max() / v.abs().max()).item()
                   for n_, u, v in zip(("dx", *a), got, ref)}
            check(all(u.dtype == v.dtype for u, v in zip(got, (x, *a.values()))),
                  "a gradient did not come back in its input's dtype")
            check(max(rel.values()) <= BLOCK_GRAD_RTOL[dtype],
                  f"the Function's gradients {name} {what}: {rel} of the largest magnitude from "
                  f"autograd through the plain forward > {BLOCK_GRAD_RTOL[dtype]}")
            err["block"][f"{name} {what}"] = rel
            log(f"[kernel] K9 + K10 Function {name:8s} B={b} {hw}x{hw} C={c}: each gradient "
                f"within {max(rel.values()):.3g} of its largest magnitude of the f32 autograd "
                f"gradients (bound {BLOCK_GRAD_RTOL[dtype]:.3g}): {rel}")
    return err


def _tail_bwd_work(b, r, c, dtype):
    """(operations, bytes) of one K10 call: five products of 2 R C 4C an
    image; h and dy read and dacc written once, the weights read and their
    f32 gradients written once."""
    size = torch.empty((), dtype=dtype).element_size()
    c4 = 4 * c
    return 10 * b * r * c * c4, 3 * b * r * c * size + 2 * c * c4 * (size + 4) + 10 * c4 * 4


def plain_block_module(dim, a, dtype):
    """A ConvNeXtV2Block with the parameters of ``a`` (its plain path under
    XMIR_FUSED_MLP=0)."""
    blk = convnext_model.ConvNeXtV2Block(dim).to("cuda", dtype)
    names = {"dw_weight": "conv_dw.weight", "dw_bias": "conv_dw.bias", "ln_scale": "norm.weight",
             "ln_bias": "norm.bias", "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias",
             "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias", "gamma": "mlp.grn.weight",
             "beta": "mlp.grn.bias"}
    blk.load_state_dict({names[k]: v.to(dtype) for k, v in a.items()})
    return blk.train()


def torch_tail(h, lns, lnb, w1, b1, w2, gamma, beta):
    """The tail (no residual) in PyTorch's own differentiable operations in
    h's dtype (F.linear, F.gelu): what autograd through a plain tail runs."""
    y = cb.layer_norm(h, lns, lnb).to(h.dtype)
    a = F.gelu(F.linear(y, w1, b1.to(h.dtype)), approximate="tanh").float()
    gx = torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-12)
    nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
    return F.linear((gamma * (a * nx) + beta + a).to(h.dtype), w2)


def phase_tail_bwd_rates():
    """K10 per stage at B = 16 against its plain version and autograd through
    the plain tail; one block of each stage forward + backward under autograd,
    fused (K9 + K10) against the plain block (the training gate's table)."""
    gen = torch.Generator().manual_seed(32)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        for i, (hw, c) in enumerate(STAGES):
            b, r = 16, hw * hw
            x, a, h, dy = tail_bwd_inputs(gen, b, hw, c, dtype)
            p = tail_args(a)
            what = f"stage {i + 1}"
            e = tail_bwd_err(cb.convnext_tail_bwd(h, dy, *p),
                             cb.tail_backward_reference(h, dy, *p),
                             cb.tail_grad_floors(h, dy, *p), dtype, f"K10 {name} B=16 {what}")
            hl = h.detach().requires_grad_(True)
            pl = [t.detach().requires_grad_(True) for t in p]
            tail = torch_tail(hl, *pl)
            g = x.reshape(h.shape)  # any cotangent of the right shape
            blk = plain_block_module(c, a, dtype)
            xg = x.detach().requires_grad_(True)
            ag = {k: v.detach().requires_grad_(True) for k, v in a.items()}

            def fused_block():
                o = cb.convnext_block_fused(xg, **ag)
                return torch.autograd.grad(o, [xg, *ag.values()], g.reshape(x.shape))

            def plain_block_step():
                with env_flags(XMIR_FUSED_MLP="0"):
                    o = blk(xg)
                return torch.autograd.grad(o, [xg, *blk.parameters()], g.reshape(x.shape))

            fns = {"K10": lambda: cb.convnext_tail_bwd(h, dy, *p),
                   "K10 plain": lambda: cb.tail_backward_reference(h, dy, *p),
                   "autograd": lambda: torch.autograd.grad(tail, [hl, *pl], dy, retain_graph=True),
                   "fused block": fused_block, "plain block": plain_block_step}
            ms, _ = _in_turns(fns)
            ws = ctypes.c_longlong()
            _build.load().xmir_convnext_bwd_plan(b, r, c, 4 * c, cb.DTYPE_CODES[dtype],
                                                 ctypes.addressof(ws))
            ops, nbytes = _tail_bwd_work(b, r, c, dtype)
            bound_ms, bound_by = bound(ops, nbytes, name)
            gate = "fused" if cb.fused_train_wins(r, c, 4 * c) else "plain"
            out[f"{name} {what}"] = {
                "ms": ms["K10"], "plain_ms": ms["K10 plain"], "autograd_ms": ms["autograd"],
                "fused_block_ms": ms["fused block"], "plain_block_ms": ms["plain block"],
                "bound_ms": bound_ms, "bound_by": bound_by, "workspace_mib": ws.value / 2 ** 20,
                "agreement": e, "gate": gate}
            log(f"[rates] K10 {name:8s} B=16 {hw}x{hw} C={c} ({what}): {ms['K10']:.3f} ms "
                f"({ops / ms['K10'] / 1e9:.1f} TFLOP/s; bound {bound_ms:.3f} ms by {bound_by}) vs "
                f"plain {ms['K10 plain']:.3f} ms, autograd through the plain tail "
                f"{ms['autograd']:.3f} ms; workspace {ws.value / 2 ** 20:.0f} MiB; one block "
                f"forward + backward: fused (K9 + K10) {ms['fused block']:.3f} ms, plain block "
                f"{ms['plain block']:.3f} ms (gate: {gate}); "
                f"agreement {e}")
            del x, a, h, dy, p, hl, pl, tail, g, blk, xg, ag, fns
            torch.cuda.empty_cache()
    return out


def write_convnext_train_checkpoint(path, seed):
    """write_timm_checkpoint's ConvNeXtV2-Base with every bias random and
    nonzero too (at init they are 0)."""
    write_timm_checkpoint(path, seed)
    sd = torch.load(path)
    gen = torch.Generator().manual_seed(seed + 2)
    for key, v in sd.items():
        if key.endswith(".bias") and "norm" not in key and "grn" not in key:
            sd[key] = 0.1 * torch.randn(v.shape, generator=gen)
    torch.save(sd, path)


@contextlib.contextmanager
def convnext_plain_versions():
    """The fused block's Function with K9 and K10 pointed at their plain
    versions (block_tail_reference, tail_backward_reference) on the card."""
    saved = (cb._block_forward, cb.convnext_tail_bwd)
    cb._block_forward = plain_block
    cb.convnext_tail_bwd = cb.tail_backward_reference
    try:
        yield
    finally:
        cb._block_forward, cb.convnext_tail_bwd = saved


# ConvNeXtV2-Base at 384 px: the blocks the training gate fuses (stages 1
# and 2, 3 blocks each): K9 and K10 launches per train step
FUSED_TRAIN_BLOCKS = sum(d for (hw, _), d in zip(STAGES, (3, 3, 27, 3))
                         if cb.fused_train_wins(hw * hw, 0, 0))


def phase_train_convnext(workdir: Path):
    p, n_train, n_val = 2, 32, 16  # three train steps in epoch 1, two in epoch 2
    t0 = time.perf_counter()
    data = (*write_synthetic_covidx(str(workdir / "ct_train"), n=n_train, size=256, seed=14),
            *write_synthetic_covidx(str(workdir / "ct_val"), n=n_val, size=256, seed=15))
    pt = str(workdir / "convnextv2_train_timm.pt")
    write_convnext_train_checkpoint(pt, seed=26)
    steps = [pk_steps(data[1], p, 4, epoch) for epoch in (1, 2)]
    log(f"[slice] ConvNeXtV2 train: wrote {n_train} + {n_val} PNGs and a timm-layout .pt in "
        f"{time.perf_counter() - t0:.1f} s; {steps} train steps in epochs 1, 2")
    start, _ = create_model("convnextv2", generator=torch.Generator().manual_seed(0))
    start = load_torch_checkpoint(start, pt).state_dict()
    run = make_trainer(workdir, "convnextv2", data, "-p", str(p))
    out = {}
    # bf16 takes K9 + K10 in the blocks the gate fuses; the evaluation embeds
    # in f32, which keeps the plain path
    with env_flags(XMIR_FUSED_MLP=None):
        reset_launches()
        t0 = time.perf_counter()
        losses, ckpt = run("main", "--bf16", "--epochs", "1", "--resume", pt)
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = dict.fromkeys(WRAPPERS, 0)
        want.update({"K9": FUSED_TRAIN_BLOCKS * steps[0], "K10": FUSED_TRAIN_BLOCKS * steps[0]})
        check(launches == want, f"cli.train convnextv2: launches {launches}, expected {want} "
                                f"({FUSED_TRAIN_BLOCKS} fused blocks x {steps[0]} steps)")
        check(len(losses) == steps[0], f"{len(losses)} losses for {steps[0]} steps")
        log(f"[slice] cli.train convnextv2 --bf16: launches {launches} ({FUSED_TRAIN_BLOCKS} fused "
            f"blocks x {steps[0]} steps, forward and backward); losses "
            f"{[round(v, 4) for _, _, v in losses]}; {wall:.1f} s wall")
        out["launches"] = launches
        trained = load_checkpoint(ckpt)
        still = [key for key, v in trained.items() if torch.equal(v, start[key])]
        check(not still, f"parameters that did not move: {still}")
        check(all(torch.isfinite(v).all() for v in trained.values()), "non-finite parameters")
        reset_launches()
        _, frozen_ckpt = run("frozen", "--bf16", "--epochs", "1", "--resume", pt,
                             "--freeze-backbone", "--embedding-dim", "64")
        frozen_launches = read_launches()
        check(frozen_launches["K10"] == 0, "the frozen backbone's blocks ran their backward")
        frozen = load_checkpoint(frozen_ckpt)
        fresh64, _ = create_model("convnextv2", embedding_dim=64,
                                  generator=torch.Generator().manual_seed(0))
        fresh64 = dict(fresh64.state_dict(), **start)
        for key, v in frozen.items():
            check(torch.equal(v, fresh64[key]) == key.startswith("convnext."),
                  f"--freeze-backbone: {key} " + ("moved" if key.startswith("convnext.")
                                                  else "did not move"))
        log(f"[slice] cli.train convnextv2: every tensor moved; under --freeze-backbone the "
            f"backbone's {sum(key.startswith('convnext.') for key in frozen)} tensors did not and "
            f"the head's did (launches {frozen_launches})")
        check_resume(make_trainer(workdir, "convnextv2", data, "-p", str(p), "--bf16"), steps,
                     "cli.train convnextv2 --bf16", "--resume", pt)
        for model in ("convnextv2_sra", "convnextv2_pcam"):
            reset_launches()
            losses, _ = make_trainer(workdir, model, data, "-p", str(p))(
                f"{model}_bf16", "--bf16", "--epochs", "1", "--resume", pt)
            got = read_launches()
            check(got["K9"] == got["K10"] == FUSED_TRAIN_BLOCKS * steps[0],
                  f"cli.train {model} --bf16: launches {got}")
            log(f"[slice] cli.train {model} --bf16: {steps[0]} steps, losses "
                f"{[round(v, 4) for _, _, v in losses]}, launches K9 {got['K9']}, K10 {got['K10']}")
    # f32 under XMIR_FUSED_MLP=1: the fused blocks take K9 + K10 in f32
    with env_flags(XMIR_FUSED_MLP="1"):
        reset_launches()
        _, f32_ckpt = run("f32", "--epochs", "1", "--resume", pt)
        check(read_launches()["K10"] == FUSED_TRAIN_BLOCKS * steps[0],
              "the f32 steps did not take K10")
        with convnext_plain_versions():
            reset_launches()
            _, plain_ckpt = run("f32_plain", "--epochs", "1", "--resume", pt)
            check(not any(read_launches().values()), "the plain versions launched a kernel")
    a, b = load_checkpoint(f32_ckpt), load_checkpoint(plain_ckpt)
    moved = torch.cat([(v - start[key]).abs().flatten() for key, v in b.items() if key in start])
    apart = torch.cat([(v - b[key]).abs().flatten() for key, v in a.items() if key in start])
    reading = {"mean_apart_of_mean_moved": (apart.mean() / moved.mean()).item(),
               "max_apart": apart.max().item(), "mean_moved": moved.mean().item(),
               "share_outside_1e-6": (apart > 1e-6).float().mean().item()}
    check(reading["mean_apart_of_mean_moved"] <= TRAIN_F32_MEAN_TOL,
          f"f32 parameters after {steps[0]} steps with K9 + K10 differ from the plain versions' "
          f"past the bound {TRAIN_F32_MEAN_TOL}: {reading}")
    log(f"[slice] cli.train convnextv2 f32 (XMIR_FUSED_MLP=1), {steps[0]} steps, K9 + K10 against "
        f"their plain versions: {reading} (bound on the first {TRAIN_F32_MEAN_TOL})")
    out["f32_vs_plain"] = reading
    return out


def phase_convnext_train_rates():
    """The bf16 ConvNeXtV2-Base train step at batch 16, 384 px (f32 master
    weights, triplet loss): with the kernels (K9 + K10 in the blocks the
    gate fuses), with their plain versions and on the eager path (every
    block plain), in turns; peak memory of each; and where a step's time
    goes."""
    model, _ = create_model("convnextv2", generator=torch.Generator().manual_seed(27))
    model = model.to("cuda", memory_format=torch.channels_last).train()
    state = TrainState(model, build_optimizer(model, lr=1e-5, backbone_prefixes=("convnext.",)))
    step = make_embedding_train_step(model, "triplet", {"margin": 2.0},
                                     compute_dtype=torch.bfloat16)
    x = torch.randn((16, 384, 384, 3), generator=torch.Generator().manual_seed(28)).cuda()
    labels = torch.tensor([0] * 8 + [1] * 8, device="cuda")

    def with_kernels():
        return step(state, x, labels)

    def with_plain_versions():
        with convnext_plain_versions():
            return step(state, x, labels)

    def eager_path():
        with env_flags(XMIR_FUSED_MLP="0"):
            return step(state, x, labels)

    def forward_only():
        step.loss_and_aux(x, labels)

    def forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        step.loss_and_aux(x, labels)[0].backward()

    paths = {"kernels": with_kernels, "plain versions": with_plain_versions, "eager": eager_path}
    out = {}
    with env_flags(XMIR_FUSED_MLP=None):
        reset_launches()
        loss = with_kernels()["loss"]
        launches = read_launches()
        check(launches["K9"] == launches["K10"] == FUSED_TRAIN_BLOCKS,
              f"the bf16 step did not take K9 and K10 in the fused blocks: {launches}")
        check(torch.isfinite(loss).item(), "non-finite loss")
        peak = {}
        for name, fn in paths.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak[name] = torch.cuda.max_memory_allocated() / 2 ** 30
        ms, runs = _in_turns({**paths, "forward": forward_only,
                              "forward + backward": forward_backward}, rounds=3, reps=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            with_kernels()
        enqueue = (time.perf_counter() - t0) / 3 * 1e3
        torch.cuda.synchronize()
    for name in paths:
        out[name] = {"ms": ms[name], "img_per_s": 16 / ms[name] * 1e3, "peak_gib": peak[name]}
    shares = {"forward": ms["forward"], "backward": ms["forward + backward"] - ms["forward"],
              "optimiser": ms["kernels"] - ms["forward + backward"]}
    out["shares_ms"] = shares
    out["enqueue_ms"] = enqueue
    log("[rates] ConvNeXtV2-Base bf16 train step, batch 16 @384 (device time): "
        + "; ".join(f"{k} {v['ms']:.2f} ms = {v['img_per_s']:.1f} img/s, peak {v['peak_gib']:.2f} "
                    "GiB" for k, v in out.items() if isinstance(v, dict) and "ms" in v)
        + f"; with the kernels a step is forward {shares['forward']:.2f} ms + backward "
        f"{shares['backward']:.2f} ms + optimiser {shares['optimiser']:.2f} ms, and the host "
        f"enqueues it in {enqueue:.2f} ms; runs "
        f"{({k: [round(t, 2) for t in v] for k, v in runs.items()})}")
    del model, state, step, x
    torch.cuda.empty_cache()
    return out


# the same narrow DenseNet121 SBSM and insertion / deletion on the card and on
# the CPU: both IEEE f32, only the sums' order differs
SALIENCY_CPU_TOL = 1e-5


def _narrow_saliency(device):
    """Pair SBSM maps and both curves' AUCs of one query and two retrieved
    images through a narrow DenseNet121 on ``device``: (maps, AUCs)."""
    from xmir_tpu_torch.models.embedders import DenseNet121Embedder
    from xmir_tpu_torch.xai import (
        blur_substrate,
        generate_masks,
        run_causal_metric_pairs_both,
        sbsm_pair_saliency,
        zeros_substrate,
    )

    model = DenseNet121Embedder(12, 3, growth_rate=8, block_config=(2, 2, 2, 2),
                                num_init_features=16,
                                generator=torch.Generator().manual_seed(29))
    embed = make_embed_fn(model.to(device).eval())
    gen = torch.Generator().manual_seed(30)
    q, r = (torch.randn((n, 64, 64, 3), generator=gen).to(device) for n in (1, 2))
    masks = torch.from_numpy(generate_masks(64, 16, 8)).to(device)
    maps = sbsm_pair_saliency(embed, q, r, masks, chunk=32)
    d, i = run_causal_metric_pairs_both(embed, q[0], r, list(maps[0]), zeros_substrate,
                                        blur_substrate(), step=256)
    return maps.cpu(), np.array([a for a, _ in d + i])


def write_whitened_densenet(path, img_dir, manifest, dim=32):
    """DenseNet121 with its seeded random backbone and an fc head that
    whitens the pooled features of the images in ``manifest``: their first
    ``dim`` principal directions about the mean, at unit variance. Random
    weights give nearly collinear embeddings, where cli.test's -L2 ranking
    and the index's cosine ranking of the same gallery part at near-ties;
    whitened ones rank alike."""
    model, spec = create_model("densenet121", embedding_dim=dim,
                               generator=torch.Generator().manual_seed(0))
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    p = argparse.ArgumentParser()
    common.add_dataset_args(p)
    args = p.parse_args(["--dataset", "covid", "--dataset-dir", img_dir,
                         "--test-image-list", manifest])

    def pooled(x):
        with torch.inference_mode():
            return model.densenet121[0](x)["pooled"].float()

    feats, _ = embed_dataset(common.build_dataset(args, "test"), pooled, spec, device="cuda",
                             num_workers=8)
    mean = feats.mean(dim=0)
    _, sv, vh = torch.linalg.svd(feats - mean, full_matrices=False)
    w = vh[:dim] / (sv[:dim, None] / (feats.shape[0] - 1) ** 0.5)
    with torch.no_grad():
        model.fc.weight.copy_(w)
        model.fc.bias.copy_(-w @ mean)
    torch.save({k: v.cpu().contiguous() for k, v in model.state_dict().items()}, path)


def phase_saliency(workdir: Path):
    """Main-path step 4 on DenseNet121 at full width (224 px, f32; a head
    that whitens the gallery's features, ``write_whitened_densenet``):
    cli.test --save-dir, cli.compute_saliency --results on 2 queries (top 5,
    window 24, stride 5: 2401 masks), cli.evaluate_saliency --saliency-dir
    and the same inline; then the rates of SBSM and of the curves."""
    from xmir_tpu_torch.cli import compute_saliency, evaluate_saliency
    from xmir_tpu_torch.xai import (
        blur_substrate,
        generate_masks,
        run_causal_metric_pairs_both,
        sbsm_pair_saliency,
        zeros_substrate,
    )

    n, n_q, top_k = 64, 2, 5
    img_dir, manifest = write_synthetic_covidx(str(workdir / "sal"), n=n, size=256, seed=16)
    pt = str(workdir / "densenet121_whitened.pt")
    write_whitened_densenet(pt, img_dir, manifest)
    common = ["--dataset", "covid", "--dataset-dir", img_dir, "--test-image-list", manifest,
              "--model", "densenet121", "--embedding-dim", "32", "--resume", pt,
              "--device", "cuda", "--seed", "0", "-j", "8"]
    res, maps = workdir / "sal_res", workdir / "sal_maps"
    test_cli.main(common + ["--save-dir", str(res)])
    xai = ["--window-size", "24", "--stride", "5", "--gpu-batch", "128", "--top-k", str(top_k),
           "--limit", str(n_q)]
    reset_launches()
    t0 = time.perf_counter()
    compute_saliency.main(common + xai + ["--results", str(res / "evaluation_results.npz"),
                                          "--save-dir", str(maps)])
    sbsm_wall = time.perf_counter() - t0
    check(not any(read_launches().values()), "SBSM on DenseNet121 launched a kernel")
    saved = sorted(maps.iterdir())
    check(len(saved) == n_q * top_k, f"{len(saved)} maps for {n_q} queries x top {top_k}")
    for path in saved:
        m = np.load(path)
        check(m.shape == (224, 224) and np.isfinite(m).all() and (m >= 0).all(),
              f"{path.name}: not a finite nonnegative 224 x 224 map")
    reset_launches()
    ins = ["--step", "1000", "--top-k", str(top_k), "--limit", str(n_q)]
    saved_out = evaluate_saliency.main(common + ins + ["--saliency-dir", str(maps), "--output",
                                                       str(workdir / "insdel.json")])
    launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want["K1"] = 1
    check(launches == want, f"cli.evaluate_saliency: launches {launches}, expected K1 once")
    inline = evaluate_saliency.main(common + ins + xai[:6] + ["--output",
                                                             str(workdir / "inline.json")])
    aucs = []
    for r, s in zip(saved_out["results"], inline["results"]):
        got = r["per_pair_del"] + r["per_pair_ins"]
        aucs += got
        check(all(0.0 <= a <= 1.0 for a in got), f"AUCs outside [0, 1]: {got}")
        check(np.allclose(got, s["per_pair_del"] + s["per_pair_ins"], atol=1e-6, rtol=0),
              f"the saved maps' AUCs {got} differ from the inline maps' {s}")
    log(f"[slice] saliency DenseNet121 @224 f32: {len(saved)} SBSM maps ({n_q} queries x top "
        f"{top_k}, 2401 masks) in {sbsm_wall:.1f} s wall through cli.compute_saliency; "
        f"cli.evaluate_saliency launches {launches}; mean deletion AUC "
        f"{saved_out['summary']['mean_deletion_auc']:.4f}, insertion "
        f"{saved_out['summary']['mean_insertion_auc']:.4f}; the saved maps' AUCs equal the "
        "inline maps' (1e-6)")
    # the narrow model on the card and on the CPU
    gpu_maps, gpu_aucs = _narrow_saliency("cuda")
    cpu_maps, cpu_aucs = _narrow_saliency("cpu")
    map_err = (gpu_maps - cpu_maps).abs().max().item()
    auc_err = float(np.abs(gpu_aucs - cpu_aucs).max())
    check(map_err <= SALIENCY_CPU_TOL and auc_err <= SALIENCY_CPU_TOL,
          f"narrow SBSM / ins-del on the card vs the CPU: maps {map_err}, AUCs {auc_err} > "
          f"{SALIENCY_CPU_TOL}")
    log(f"[slice] narrow DenseNet121 SBSM + ins/del, card vs CPU: maps within {map_err:.3g}, AUCs "
        f"within {auc_err:.3g} (bound {SALIENCY_CPU_TOL})")
    # rates: one query's SBSM over its top 5, and its both-curves evaluation
    model, spec = create_model("densenet121", generator=torch.Generator().manual_seed(0))
    embed = make_embed_fn(model.to("cuda", memory_format=torch.channels_last).eval())
    gen = torch.Generator().manual_seed(31)
    q, r = (torch.randn((k, 224, 224, 3), generator=gen).cuda() for k in (1, top_k))
    masks = torch.from_numpy(generate_masks(224, 24, 5)).cuda()
    sal = sbsm_pair_saliency(embed, q, r, masks)
    blur = blur_substrate()

    def curves():
        return run_causal_metric_pairs_both(embed, q[0], r, list(sal[0]), zeros_substrate,
                                            blur, step=1000)

    curves()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sbsm_pair_saliency(embed, q, r, masks)
    torch.cuda.synchronize()
    sbsm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    curves()
    torch.cuda.synchronize()
    curves_s = time.perf_counter() - t0
    rates = {"sbsm_img_per_s": top_k * masks.shape[0] / sbsm_s,
             "insdel_pair_evals_per_s": top_k / curves_s, "sbsm_s": sbsm_s, "curves_s": curves_s}
    log(f"[rates] SBSM DenseNet121 @224 f32: {top_k} x {masks.shape[0]} masked images in "
        f"{sbsm_s:.2f} s = {rates['sbsm_img_per_s']:.0f} images/s; insertion + deletion of "
        f"{top_k} pairs (52 reveal slots each, both curves) in {curves_s:.3f} s = "
        f"{rates['insdel_pair_evals_per_s']:.1f} pair-evals/s (wall, one query)")
    return {"launches": launches, "rates": rates, "card_vs_cpu": {"maps": map_err,
                                                                 "aucs": auc_err},
            "mean_deletion_auc": saved_out["summary"]["mean_deletion_auc"],
            "mean_insertion_auc": saved_out["summary"]["mean_insertion_auc"], "aucs": aucs}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-swin", action="store_true",
                        help="only build, then print where a bf16 SwinV2-Base batch's time goes")
    parser.add_argument("--train-only", action="store_true",
                        help="only build, then the training phases (17 to 23); prints no result")
    opts = parser.parse_args()
    smi = phase_device()
    phase_build()
    if opts.profile_swin:
        profile_swin()
        print(smi)
        return
    if opts.train_only:
        phase_kernel_bwd()
        with tempfile.TemporaryDirectory() as tmp:
            phase_train_dinov2(Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            phase_train_densenet(Path(tmp))
        phase_bwd_rates()
        phase_train_rates()
        phase_kernel_tail_bwd()
        with tempfile.TemporaryDirectory() as tmp:
            phase_train_convnext(Path(tmp))
        phase_tail_bwd_rates()
        phase_convnext_train_rates()
        print(smi)
        return
    max_err = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        d_launches, slice_err = phase_slice(Path(tmp))
    phase_embed_rate()
    serving = phase_serving()
    tail_errs = phase_kernel_convnext()
    with tempfile.TemporaryDirectory() as tmp:
        c_launches, c_slice_err, emb_err = phase_slice_convnext(Path(tmp))
    rates = phase_convnext_rates()
    vit_errs = phase_kernel_vit()
    with tempfile.TemporaryDirectory() as tmp:
        v_slices = phase_slice_dinov2(Path(tmp))
    vit_rates = phase_vit_rates()
    window_errs = phase_kernel_window()
    select_err = phase_kernel_select()
    with tempfile.TemporaryDirectory() as tmp:
        s_slices = phase_slice_swinv2(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        r_launches, r_err = phase_slice_full_ranking(Path(tmp))
    window_rates = phase_window_rates()
    swin_rates = phase_swin_model_rates()
    select_rates = phase_select_rates()
    bwd_errs = phase_kernel_bwd()
    with tempfile.TemporaryDirectory() as tmp:
        t_slice = phase_train_dinov2(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        dt_launches = phase_train_densenet(Path(tmp))
    bwd_rates = phase_bwd_rates()
    train_rates = phase_train_rates()
    tail_bwd_errs = phase_kernel_tail_bwd()
    with tempfile.TemporaryDirectory() as tmp:
        ct_slice = phase_train_convnext(Path(tmp))
    tail_bwd_rates = phase_tail_bwd_rates()
    convnext_train_rates = phase_convnext_train_rates()
    with tempfile.TemporaryDirectory() as tmp:
        sal = phase_saliency(Path(tmp))
    by_path = {key: {"densenet121": d_launches[key], "convnextv2": c_launches[key],
                     **{path: v["launches"][key] for path, v in v_slices.items()},
                     **{path: v["launches"][key] for path, v in s_slices.items()},
                     "densenet121_full_ranking": r_launches[key],
                     "dinov2_train": t_slice["launches"][key],
                     "densenet121_train": dt_launches[key],
                     "convnextv2_train": ct_slice["launches"][key],
                     "densenet121_saliency": sal["launches"][key]}
               for key in WRAPPERS}
    slice_errs = [slice_err, c_slice_err] + [v["err"] for v in v_slices.values()] + [
        v["err"] for v in s_slices.values()]
    f32 = serving["float32"]
    k1 = dict(KERNELS["K1"], launches=sum(by_path["K1"].values()),
              max_abs_err=max(max_err, f32["max_abs_err"], *slice_errs),
              ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
              bound_by=f32["bound_by"], library_ms=None, by_dtype=serving,
              shape="Q=1024 N=100000 D=1024 k=10, f32", launches_by_path=by_path["K1"])
    big = select_rates["Q=1024 k=2048"]
    k1s = dict(KERNELS["K1'"], launches=sum(by_path["K1'"].values()),
               max_abs_err=max(select_err, r_err, *(v["max_abs_err"] for v in
                                                    select_rates.values())),
               ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
               bound_by=big["bound_by"], library_ms=None, by_shape=select_rates,
               shape="Q=1024 N=100000 D=1024 k=2048, f32", launches_by_path=by_path["K1'"])
    kernels = [k1, k1s]
    for key in ("K2", "K7", "K8"):
        bf16 = vit_rates[key]["bfloat16"]
        kernels.append(dict(
            KERNELS[key], launches=sum(by_path[key].values()),
            max_abs_err=max(e["max_abs_err"] for e in vit_errs[key].values()),
            err_by_dtype=vit_errs[key], ms=bf16["ms"], plain_ms=bf16["plain_ms"],
            bound_ms=bf16["bound_ms"], bound_by=bf16["bound_by"], library_ms=bf16["library_ms"],
            shape="bf16, one DINOv2 ViT-B/14 block's call at B=16, 518 px",
            by_dtype=vit_rates[key], launches_by_path=by_path[key]))
    k3 = bwd_rates["bfloat16 B=16"]
    kernels.append(dict(
        KERNELS["K3"], launches=sum(by_path["K3"].values()),
        max_abs_err=max(e["max_abs_err"] for e in bwd_errs["K3"].values()),
        err_by_dtype=bwd_errs["K3"], ms=k3["ms"], plain_ms=k3["plain_ms"],
        bound_ms=k3["bound_ms"], bound_by=k3["bound_by"], library_ms=k3["library_ms"],
        shape="bf16, one DINOv2 ViT-B/14 block's backward call at B=16, 518 px",
        by_shape=bwd_rates, launches_by_path=by_path["K3"]))
    for key in ("K4", "K6"):
        bf16 = window_rates[key]["bfloat16"]
        kernels.append(dict(
            KERNELS[key], launches=sum(by_path[key].values()),
            max_abs_err=max(e["max_abs_err"] for e in window_errs[key].values()),
            err_by_dtype=window_errs[key], ms=bf16["ms"], plain_ms=bf16["plain_ms"],
            bound_ms=bf16["bound_ms"], bound_by=bf16["bound_by"], library_ms=bf16["library_ms"],
            shape=f"bf16, the {SWIN_DEPTH} calls of one SwinV2-Base forward at B=16, 384 px "
                  "(sum over the six stage shapes by their block counts)",
            ms_by_shape=window_rates[key], launches_by_path=by_path[key]))
    for key in ("K9", "K11"):
        by_shape = rates[key]
        bf16 = [v for s, v in by_shape.items() if s.startswith("bfloat16")]
        f32s = [v for s, v in by_shape.items() if s.startswith("float32")]
        kernels.append(dict(
            KERNELS[key], launches=sum(by_path[key].values()),
            max_abs_err=max(e["max_abs_err"] for e in tail_errs[key].values()),
            err_by_dtype=tail_errs[key],
            ms=sum(v["ms"] for v in bf16), plain_ms=sum(v["plain_ms"] for v in bf16),
            bound_ms=sum(v["bound_ms"] for v in bf16),
            bound_by="operations" if all(v["bound_by"] == "operations" for v in bf16)
            else "mixed: see ms_by_shape", library_ms=None,
            shape="bf16, one block of each ConvNeXtV2-Base stage at B=32, 384 px (sum)",
            f32_sum={"ms": sum(v["ms"] for v in f32s),
                     "plain_ms": sum(v["plain_ms"] for v in f32s),
                     "bound_ms": sum(v["bound_ms"] for v in f32s)},
            ms_by_shape=by_shape, launches_by_path=by_path[key]))
    bf16 = [v for k, v in tail_bwd_rates.items() if k.startswith("bfloat16")]
    f32s = [v for k, v in tail_bwd_rates.items() if k.startswith("float32")]
    kernels.append(dict(
        KERNELS["K10"], launches=sum(by_path["K10"].values()),
        max_abs_err=max(e["max_abs_err"] for e in tail_bwd_errs["K10"].values()),
        err_by_dtype=tail_bwd_errs["K10"], ms=sum(v["ms"] for v in bf16),
        plain_ms=sum(v["plain_ms"] for v in bf16), bound_ms=sum(v["bound_ms"] for v in bf16),
        bound_by="operations" if all(v["bound_by"] == "operations" for v in bf16)
        else "mixed: see ms_by_shape", library_ms=None,
        library="none: 5 products + LN / GELU / GRN backward",
        autograd_ms=sum(v["autograd_ms"] for v in bf16),
        shape="bf16, one block of each ConvNeXtV2-Base stage at B=16, 384 px (sum)",
        f32_sum={"ms": sum(v["ms"] for v in f32s), "plain_ms": sum(v["plain_ms"] for v in f32s),
                 "bound_ms": sum(v["bound_ms"] for v in f32s)},
        ms_by_shape=tail_bwd_rates, function_grad_rel_err=tail_bwd_errs["block"],
        launches_by_path=by_path["K10"]))
    by_name = {k["name"]: k for k in kernels}
    by_name["convnext_block_fused"]["embedding_max_abs_err_vs_plain_tail"] = emb_err
    by_name["convnext_mlp_grn_fused"]["main_path"] = (
        "none: the JAX package reaches it only from its tests")
    print(smi)
    print(json.dumps({"kernels": kernels, "convnextv2_embed_img_per_s": rates["embed_rate"],
                      "dinov2_embed_img_per_s": vit_rates["embed_rate"],
                      "dinov2_train_step": train_rates,
                      "dinov2_train_f32_vs_plain": t_slice["f32_vs_plain"],
                      "convnextv2_train_step": convnext_train_rates,
                      "convnextv2_train_f32_vs_plain": ct_slice["f32_vs_plain"],
                      "saliency": {k: v for k, v in sal.items() if k != "launches"},
                      "k7_backward_rel_err": bwd_errs["K7 backward"],
                      "swinv2_embed_img_per_s": swin_rates,
                      "swinv2_eval_metrics": s_slices["swinv2_test"]["metrics"],
                      "dinov2_embedding_max_abs_err": {
                          path: v["embedding_max_abs_err"] for path, v in v_slices.items()},
                      "swinv2_embedding_max_abs_err": {
                          path: v["embedding_max_abs_err"] for path, v in s_slices.items()
                          if "embedding_max_abs_err" in v}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
