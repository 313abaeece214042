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
The launch counts are set to 0 before each slice and read after it.
The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from xmir_tpu_torch.cli import common, ingest, query
from xmir_tpu_torch.data.pipeline import embed_dataset
from xmir_tpu_torch.data.synthetic import write_synthetic_covidx
from xmir_tpu_torch.index import ShardedGalleryIndex
from xmir_tpu_torch.models import convnext as convnext_model
from xmir_tpu_torch.models.registry import create_model
from xmir_tpu_torch.ops import _build
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.ops.distance import l2_normalize
from xmir_tpu_torch.ops.topk_fused import fused_topk
from xmir_tpu_torch.ops.topk_kernels import fused_topk_scores, launch_plan, topk_scores_reference
from xmir_tpu_torch.train import make_embed_fn

REPO = Path(__file__).resolve().parent
KERNELS = {
    "K1": {"name": "fused_topk_scores", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/topk.cu",
           "replaces": "xmir_tpu/ops/topk_pallas.py:243"},
    "K9": {"name": "convnext_block_fused", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/convnext_block.cu",
           "replaces": "xmir_tpu/ops/convnext_block_pallas.py:124"},
    "K11": {"name": "convnext_mlp_grn_fused", "route": "cuda",
            "source": "xmir_tpu_torch/csrc/convnext_block.cu",
            "replaces": "xmir_tpu/ops/convnext_block_pallas.py:45"},
}
METRICS = ("cosine", "ip", "l2", "hamming")
TIE_GAP = 1e-5  # ids may differ only where the exact ranking's gap is below this


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


WRAPPERS = {"K1": fused_topk_scores, "K9": cb.convnext_block_fused,
            "K11": cb.convnext_mlp_grn_fused}


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
    check(launches["K9"] == launches["K11"] == 0, f"DenseNet121 launched a ConvNeXt kernel: "
                                                  f"{launches}")
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
        out[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
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
def fused_mlp_flag(value):
    """XMIR_FUSED_MLP (the JAX package's switch) set to value, or unset for
    None, for the duration."""
    before = os.environ.pop("XMIR_FUSED_MLP", None)
    if value is not None:
        os.environ["XMIR_FUSED_MLP"] = value
    try:
        yield
    finally:
        os.environ.pop("XMIR_FUSED_MLP", None)
        if before is not None:
            os.environ["XMIR_FUSED_MLP"] = before


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
    with fused_mlp_flag("1"):  # the f32 CLIs take K9
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
        check(launches["K11"] == 0, f"the model launched K11 {launches['K11']} times")
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
            for k in ("K9", "K11"):
                out[k][f"{name} {shape}"] = {"ms": ms[k], "plain_ms": ms[f"{k} plain"]}
            flop = 4 * 32 * hw * hw * c * 4 * c
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
        with fused_mlp_flag("0"):
            return embed(x)

    with fused_mlp_flag(None):
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


def main():
    smi = phase_device()
    phase_build()
    max_err = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        d_launches, slice_err = phase_slice(Path(tmp))
    phase_embed_rate()
    serving = phase_serving()
    tail_errs = phase_kernel_convnext()
    with tempfile.TemporaryDirectory() as tmp:
        c_launches, c_slice_err, emb_err = phase_slice_convnext(Path(tmp))
    rates = phase_convnext_rates()
    by_path = {key: {"densenet121": d_launches[key], "convnextv2": c_launches[key]}
               for key in WRAPPERS}
    k1 = dict(KERNELS["K1"], launches=sum(by_path["K1"].values()),
              max_abs_err=max(max_err, slice_err, c_slice_err,
                              serving["float32"]["max_abs_err"]),
              ms=serving["float32"]["ms"], plain_ms=serving["float32"]["plain_ms"],
              ms_bf16=serving["bfloat16"]["ms"],
              plain_ms_bf16=serving["bfloat16"]["plain_ms"],
              shape="Q=1024 N=100000 D=1024 k=10", launches_by_path=by_path["K1"])
    kernels = [k1]
    for key in ("K9", "K11"):
        by_shape = rates[key]
        bf16 = [v for s, v in by_shape.items() if s.startswith("bfloat16")]
        kernels.append(dict(
            KERNELS[key], launches=sum(by_path[key].values()),
            max_abs_err=max(e["max_abs_err"] for e in tail_errs[key].values()),
            err_by_dtype=tail_errs[key],
            ms=sum(v["ms"] for v in bf16), plain_ms=sum(v["plain_ms"] for v in bf16),
            shape="bf16, one block of each ConvNeXtV2-Base stage at B=32, 384 px (sum)",
            ms_by_shape=by_shape, launches_by_path=by_path[key]))
    kernels[1]["embedding_max_abs_err_vs_plain_tail"] = emb_err
    kernels[2]["main_path"] = "none: the JAX package reaches it only from its tests"
    print(smi)
    print(json.dumps({"kernels": kernels, "convnextv2_embed_img_per_s": rates["embed_rate"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
