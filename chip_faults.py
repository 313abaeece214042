"""Plants one fault at a time in the ViT kernels (K2, K3, K7, K8; K3 also at
head width 72, against chip_smoke.py phase 38's check, and ConceptGather's
backward made atomic, against phase 40's), the Swin
attention kernels (K4, K6) and K4's backward (K5), the top-k (K1, K1'),
the ConvNeXtV2 block tail (K9, K11) and its backward (K10) on an NVIDIA card
and prints how far each faulty kernel lies from its plain PyTorch version,
beside the real kernels' readings: the evidence the bounds in
xmir_tpu_torch/ops/vit_attn.py (``agreement``, ``grad_agreement``,
``window_agreement``) and ops/convnext_block.py (``agreement``) were set
from, K10's by ``grad_agreement`` too (in bf16 also pass 2's ab bit-equal
to pass 1's, ``convnext_block.tail_bwd_recomputes_ab``), K2's with its flip
allowance (``vit_attn.flip_allowance``). K1 and K1' are held to bit-equal
ids and values on integer inputs, K1's f32 scores also to
``topk_kernels.f32_score_error``'s bound (3xTF32) on full-mantissa rows; K1
on ATH's +/-1 codes at D = 48 to bit-equal ids and values by chip_smoke.py
phase 42's check, which a result with two tied ids swapped must fail. The
ATH train step's checks of phase 44 (its losses against the CPU's, its first
gradients against float64's) must refuse ATHNet's average pool padded by
``F.avg_pool2d`` itself, whose CUDA backward on a channels_last map is wrong.
chip_smoke.py phase 47's check of the YOLOv5s detector (the card against
the CPU and against an ultralytics-semantics oracle) must refuse the
decode's rows flattened cell-major and SPPF's pool padded with zeros
(``--only chestmir``). The mesh checks (``--only mesh``): phase 51's check of
the sharded search (bit-equal to one unsharded call, ties to the lower id,
on duplicates planted across the shard boundaries) must refuse a merge that
breaks ties toward the higher id; the data-parallel training check of
tests/test_torch_train_dp.py (the first step's loss within 1e-5 and its group
norms within 1e-5 relative of world 1's, BatchNorm's buffers equal on both
ranks), run at a world of 2 on the card machine's CPU (gloo; NCCL cannot put
two ranks on one card), must refuse a gradient ``world`` times too large and
per-rank BatchNorm statistics. The tensor-parallel checks (``--only tp``):
a narrow ViT split over a (1, 2) mesh of gloo ranks on the card machine's
CPU (tests/test_torch_tensor_parallel.py's check: outputs within 1e-5,
every gradient within 1e-5 of world 1's largest magnitude, no qkv / proj /
fc1 / fc2 weight gathered whole, the ViT-B/14 rule table of chip_smoke.py
phase 55) must refuse a row-parallel bias added on every rank, a sum whose
backward sums again, qkv's head slots cut in the wrong rank order (rank r
computing another rank's heads) and the rule's tie read in the torch
layout. The export checks (``--only export``): chip_smoke.py phase 56
(``phase_export``, on timm-layout .pt files of random weights) must refuse
an op's CUDA implementation that calls the kernel's plain version (K9's: no
launch is counted), a fake implementation one row short (K2's: the trace
refuses it), and a ``--format torch`` export of DINOv2 with the q and k rows
of one block's ``attn.qkv.weight`` swapped (the same shapes: the reload's
bit-equality refuses it).
The f32 routes of K3 and K5 (3xTF32 wgmma, csrc/attn_bwd_f32.cuh) must
refuse 2xTF32 (small . big dropped) and 1xTF32 (both small products
dropped) by K3's f32 bounds (chip_smoke.py phases 17 and 38's cases) and
K5's (phase 25's); the score product, which the design keeps on IEEE FMAs,
and K3's dp (on FMAs too) moved onto 3xTF32 must be refused by K3's bounds
on phase 17's hard rows (their readings at phase 38's random shapes and
K5's are recorded; PERF.md says whether they are refused). The f32 route of
K4 and K6 (3xTF32 wgmma, one pass, csrc/window_attn.cu) must refuse both
products on 2xTF32, both on 1xTF32, the value product alone on 1xTF32 and
the running max's rescale of the output sums dropped, by phase 12's f32
readings of both kernels.
Each line prints how far the reading goes toward its bounds (above 1: past
one of them).

    python3 chip_faults.py [--only K2 K7 ...]

``--only`` takes the real kernels' readings and plants the faults of the
named kernels alone.

A fault in a CUDA source is a text substitution in a copy of
xmir_tpu_torch/csrc under a temporary directory, built by ops/_build.py like
the real sources (one build per fault, ~15 s each); the checkout's sources
are never touched. A fault in a wrapper's constant or in a plain version is
planted in Python for the one call. Readings are worst cases over the
shapes of chip_smoke.py's kernel phase that the fault can reach. Exits 1
if a real kernel is outside its bounds or a planted fault inside them.
"""
from __future__ import annotations

import argparse
import contextlib
import re
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from xmir_tpu_torch.models import yolo
from xmir_tpu_torch.ops import _build
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.ops import ln_dense as ld
from xmir_tpu_torch.ops import vit_attn as va
from xmir_tpu_torch.ops import window_attn as wa
from xmir_tpu_torch.ops.topk_kernels import (
    f32_score_error,
    fused_topk_scores,
    topk_scores_reference,
)

REAL_CSRC = _build.CSRC_DIR
ROUND_BF16 = "__bfloat162float(__float2bfloat16({}))"

# name -> (file, old text, new text, ...): substitutions in a copy of the sources
SOURCE_FAULTS = {
    "K2: e rounded before the sum z": (
        "vit_attn.cu",
        "sm[j & 3] += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];",
        f"sm[j & 3] += {ROUND_BF16.format('s[4 * j + 2 * h]')} + "
        f"{ROUND_BF16.format('s[4 * j + 2 * h + 1]')};"),
    "K2: running max not rounded up (rescales no power of two)": (
        "vit_attn.cu", "const float m_new = fmaxf(m_run[h], ceilf(m));\n          alpha[h] = pow2i("
        "m_run[h] - m_new);",
        "const float m_new = fmaxf(m_run[h], m);\n          alpha[h] = exp2f(m_run[h] - m_new);"),
    "K2 bf16 kernel: a K ring stage read one step stale": (
        "vit_attn.cu", "const uint32_t k_tile = smem_addr(smem + stage * 2 * L::kTile);",
        "const uint32_t k_tile = smem_addr(smem + prev * 2 * L::kTile);"),
    "K2 bf16 kernel: the ragged last key tile unmasked": (
        "vit_attn.cu", "if (k0 + BK > n) {  // the ragged last tile",
        "if (false) {  // the ragged last tile"),
    "K3: dk rounded to bf16 after every query tile": (
        "vit_attn_bwd.cu", "      fence_regs(dk_acc);\n",
        "      fence_regs(dk_acc);\n      for (int i2 = 0; i2 < DP / 2; ++i2)\n"
        f"        dk_acc[i2] = {ROUND_BF16.format('dk_acc[i2]')};\n"),
    "K3: scale missing from dk": (
        "vit_attn_bwd.cu", "rqz = scale8(rq, scale * zinv);", "rqz = scale8(rq, zinv);",
        "sz_s[r] = live ? scale * zinv : 0.f;", "sz_s[r] = live ? zinv : 0.f;"),
    "K3: dead key columns unmasked": (
        "vit_attn_bwd.cu",
        "const float ev = live_key[e >> 1] ? exp2_fast(s[4 * j + e] - r.x) : 0.f;",
        "const float ev = exp2_fast(s[4 * j + e] - r.x);",
        "const float ev = live_key[e >> 1] ? exp2f(s[4 * j + e] - r.x) : 0.f;",
        "const float ev = exp2f(s[4 * j + e] - r.x);"),
    "K3 f32 kernel, hd 72: each streamed q and g row's last panel (lanes 64-71) read from lanes "
    "0-7": (
        "vit_attn_bwd.cu",
        "tma_load(tiles + op * St::kTile + pn * QB * P::kRowBytes, rows[op], pn * P::kWidth / 2,",
        "tma_load(tiles + op * St::kTile + pn * QB * P::kRowBytes, rows[op],\n"
        "                     (pn + 1 == P::kCount ? 0 : pn) * P::kWidth / 2,"),
    "K3 bf16 kernel: one key unit's dq part skipped": (
        "vit_attn_bwd.cu", "tma_reduce_add(&dq_map, c0, i * kBQ, head, src + c0 * (kBQ * 4));",
        "if (u != 1) tma_reduce_add(&dq_map, c0, i * kBQ, head, src + c0 * (kBQ * 4));"),
    "K3 bf16 kernel: dq parts added unordered, the counter bypassed": (
        "vit_attn_bwd.cu", "while (ld_acquire_gpu(cnt) != u) {",
        "while (false && ld_acquire_gpu(cnt) != u) {"),
    "K3 bf16 kernel: qz written without the 1 / z factor": (
        "vit_attn_bwd.cu", "rqz = scale8(rq, scale * zinv);", "rqz = scale8(rq, scale);"),
    # the f32 routes' arithmetic (attn_bwd_f32.cuh, both K3 and K5): the TF32
    # shortcuts the unchanged f32 bounds must refuse, and the two products the
    # design keeps on IEEE FMAs moved to the tensor cores
    "K3, K5 f32 route: 2xTF32 (small . big dropped)": (
        "attn_bwd_f32.cuh", "constexpr int kProductTerms = 3;", "constexpr int kProductTerms = 2;"),
    "K3, K5 f32 route: 1xTF32 (both small products dropped)": (
        "attn_bwd_f32.cuh", "constexpr int kProductTerms = 3;", "constexpr int kProductTerms = 1;"),
    "K3, K5 f32 route: the score product on 3xTF32 (not IEEE FMAs)": (
        "attn_bwd_f32.cuh", "constexpr int kScoreTerms = 0;", "constexpr int kScoreTerms = 3;"),
    "K3 f32 route: dp on 3xTF32 (not IEEE FMAs), each depth step's sum added in f32": (
        "vit_attn_bwd.cu", "constexpr int kDpTerms = 0;", "constexpr int kDpTerms = 3;"),
    "K7, K8: LN eps 1e-5 for 1e-6": (
        "gemm_tile.cuh", "constexpr float kLnEps = 1e-6f;", "constexpr float kLnEps = 1e-5f;"),
    # the tanh form of f32 K8 (gelu_tanh) and of bf16 K8 (gelu_sigmoid)
    "K8: erf GELU for tanh": (
        "gemm_tile.cuh",
        "return v * (0.5f * (1.f + tanhf(kGeluK0 * (v + kGeluK1 * v * v * v))));",
        "return v * (0.5f * (1.f + erff(v * 0.7071067811865476f)));",
        "return v * r;", "return v * (0.5f * (1.f + erff(v * 0.7071067811865476f)));"),
    # bf16 only: f32 sums round to nothing
    "K7, K8: sum rounded before the bias": (
        "ln_dense.cu",
        "acc[4 * j8 + 2 * h] + b.x, acc[4 * j8 + 2 * h + 1] + b.y);",
        f"{ROUND_BF16.format('acc[4 * j8 + 2 * h]')} + b.x, "
        f"{ROUND_BF16.format('acc[4 * j8 + 2 * h + 1]')} + b.y);",
        "float v0 = acc[4 * j8 + 2 * h] + b.x, v1 = acc[4 * j8 + 2 * h + 1] + b.y;",
        f"float v0 = {ROUND_BF16.format('acc[4 * j8 + 2 * h]')} + b.x, "
        f"v1 = {ROUND_BF16.format('acc[4 * j8 + 2 * h + 1]')} + b.y;"),
    "K7 bf16 kernel: the ragged tail's last row dropped": (
        "ln_dense.cu", "const bool live_row[2] = {row_a < rows, row_a + 8 < rows};",
        "const bool live_row[2] = {row_a < rows - 1, row_a + 8 < rows - 1};"),
    "K7 bf16 kernel: each item stored at the block's first column tile": (
        "ln_dense.cu",
        "const int n0 = (item - group * args.n_tiles) * kWgN;\n    const int u =",
        "const int n0 = (blockIdx.x % args.n_tiles) * kWgN;\n    const int u ="),
    # refused by the canary rows after the output (read_ln's canary_intact)
    "K8 bf16 kernel: the ragged last unit's rows stored past R": (
        "ln_dense.cu", "if (row >= args.rows) break;", "if (false) break;"),
    "K8 bf16 kernel: the bias skipped on the last column tile of an M not a multiple of 256": (
        "ln_dense.cu", "const float2 b = args.bias != nullptr && col < N\n",
        "const float2 b = args.bias != nullptr && col < N && n0 + kWgN <= N\n"),
    # each stage still released once, so the ring cannot hang: the copy engine
    # refills a stage while its products may still read it
    "K8 bf16 kernel: a ring stage released one chunk early": (
        "ln_dense.cu",
        "mbar_wait(full + stage, (it / kStages) & 1);\n",
        "mbar_wait(full + stage, (it / kStages) & 1);\n      release(it);\n",
        "      if (kc > 0) release(it - 1);\n", "",
        "    release(it - 1);  // the item's last chunk\n", ""),
    "K4: bias not scaled by log2(e)": (
        "window_attn.cu", "return __fadd_rn(s, MODE == kV1 ? b : __fmul_rn(b, kLog2e));",
        "return __fadd_rn(s, b);"),
    "K4: q rounded after the normalisation too, before the scale": (
        "window_attn.cu", "for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(f[i], rn);",
        f"for (int i = 0; i < 8; ++i) f[i] = {ROUND_BF16.format('__fmul_rn(f[i], rn)')};"),
    "K4, K6: group index off by one fold": (
        "window_attn.cu", "return (i / g.d1) % g.m1 * g.s1 +",
        "return (i / g.d1 + 1) % g.m1 * g.s1 +"),
    "K4: norm clamp 1e-12 on the sum of squares for 1e-24": (
        "window_attn.cu", "fmaxf(sum_sq, 1e-24f)", "fmaxf(sum_sq, 1e-12f)"),
    "K4 bf16 kernel: the second image takes the neighbouring group's bias tiles": (
        "window_attn.cu",
        "const int row0 = run * run_rows + (blockIdx.x - run * per_run) * images;",
        "const int row0 = min(static_cast<int>(blockIdx.x) * images, bh - 1);",
        "min((run + 1) * run_rows, bh) - row0", "bh - row0"),
    "K4 bf16 kernel: a ring stage read one step stale": (
        "window_attn.cu", "const unsigned char* const bt = ring + stage * kBiasTileBytes;",
        "const unsigned char* const bt = ring + (stage + stages - 1) % stages * kBiasTileBytes;"),
    "K6: weights rounded before they are normalised": (
        "window_attn.cu", "const float e = __fmul_rn(expf(d), 0x1p64f);",
        f"const float e = __fmul_rn({ROUND_BF16.format('expf(d)')}, 0x1p64f);"),
    # the f32 route's arithmetic (wattn_f32_wg, both K4 and K6): the TF32
    # shortcuts the unchanged f32 bound must refuse, and the one pass's
    # rescale of the accumulator by exp(m_old - m_new) dropped
    "K4, K6 f32 route: both products on 2xTF32 (small . big dropped)": (
        "window_attn.cu", "constexpr int kScoreTerms = 3;", "constexpr int kScoreTerms = 2;",
        "constexpr int kValueTerms = 3;", "constexpr int kValueTerms = 2;"),
    "K4, K6 f32 route: both products on 1xTF32 (both small products dropped)": (
        "window_attn.cu", "constexpr int kScoreTerms = 3;", "constexpr int kScoreTerms = 1;",
        "constexpr int kValueTerms = 3;", "constexpr int kValueTerms = 1;"),
    "K4, K6 f32 route: the value product alone on 1xTF32": (
        "window_attn.cu", "constexpr int kValueTerms = 3;", "constexpr int kValueTerms = 1;"),
    "K4, K6 f32 route: the running max's rescale of the accumulator dropped": (
        "window_attn.cu",
        "for (int i = 0; i < DP / 2; ++i) acc[i] = acc[i] * alpha[(i >> 1) & 1] + pv[i];",
        "for (int i = 0; i < DP / 2; ++i) acc[i] = acc[i] + pv[i];"),
    "K6 bf16 kernel: e rounded for the product, the product divided by z": (
        "window_attn.cu",
        "s[i] = v1_weight_rcp(s[i] - m[(i >> 1) & 1], z[(i >> 1) & 1], zr[(i >> 1) & 1]);",
        "s[i] = expf(s[i] - m[(i >> 1) & 1]);",
        "float div = 1.f;  // K6's weights are already normalised\n      if constexpr",
        "float div = MODE == kV1 ? z[h] : 1.f;\n      if constexpr"),
    "K6 bf16 kernel: z summed without the running-max rescale": (
        "window_attn.cu", "z[h] = z[h] * expf(m[h] - m_new) + sum;", "z[h] = z[h] + sum;"),
    "K6 bf16 kernel: the second image on the neighbouring slice's bias": (
        "window_attn.cu", "return MODE == kV1 ? g.d1 / g.m2 : g.d1;",
        "return MODE == kV1 ? g.d1 / g.m2 + 1 : g.d1;"),
    "K1: a tie inside a tile given to the higher row": (
        "topk.cu", "return v > w || (v == w && i < j);", "return v > w || (v == w && i > j);"),
    # >= in the stash's test would re-admit the k-th entry's ties every round
    # and never finish; planted where the order places an entry, it misplaces
    # ties without a hang
    "K1: pruning with >= in place of the strict (value, row) order": (
        "topk.cu", "if (ahead(v, i, bv[mid], bi[mid])) {", "if (v >= bv[mid]) {"),
    "K1 f32: 2xTF32 (small . big dropped)": (
        "topk_scores.cuh", "WgmmaTf32x128::ss(acc, da_s, db, 1);     // small . big", ""),
    "K1 f32: 1xTF32 (both small products dropped)": (
        "topk_scores.cuh", "WgmmaTf32x128::ss(acc, da_s, db, 1);     // small . big", "",
        "WgmmaTf32x128::ss(acc, da, db_s, 1);     // big . small", ""),
    "K1: a ring stage read one step stale": (
        "topk_scores.cuh", "const uint32_t a_tile = smem_addr(smem + st * kStage);",
        "const uint32_t a_tile = smem_addr(smem + (it + stages - 1) % stages * kStage);"),
    "K1: the gallery's ragged last tile unmasked": (
        "topk.cu",
        "acc[4 * j + 2 * h + e] = live ? acc[4 * j + 2 * h + e] + b : -CUDART_INF_F;",
        "acc[4 * j + 2 * h + e] = live ? acc[4 * j + 2 * h + e] + b : acc[4 * j + 2 * h + e];"),
    "K1: the merge giving equal values to the higher split": (
        "topk.cu", "if (ov > best || (ov == best && os < src)) {",
        "if (ov > best || (ov == best && os > src)) {",
        "if (hv[h] > best) {", "if (hv[h] >= best) {"),
    "K1': ties to the higher row (equal digits ranked from the last lane)": (
        "topk_select.cu", "const unsigned rank = __popc(peers & lt);",
        "const unsigned rank = __popc(peers) - 1 - __popc(peers & lt);"),
    "K1': the k-th key left out of the gather": (
        "topk_select.cu", "const bool all_ties = remaining == ties;", "const bool all_ties = false;",
        "take = gt || (eq && eq_rank < remaining);", "take = gt || (eq && eq_rank + 1 < remaining);"),
    # (-0 ranked below +0 cannot show on the tensor-core producer: its sums
    # return +0 for every zero, +0 plus a -0 bias is +0, so no score is -0;
    # the fault below plants in the same map)
    "K1': negative scores' words not inverted (their order reversed)": (
        "topk_scores.cuh", "return (u & 0x80000000u) ? ~u : (u | 0x80000000u);",
        "return (u & 0x80000000u) ? (u & 0x7fffffffu) : (u | 0x80000000u);"),
    "K5: dbias summed over the group's first folded row only": (
        "window_attn_bwd.cu",
        "tma_reduce_add(&maps.dbias, kc, i * kT, un.group, src + kb * (kT * 128));",
        "(void)kc;", "tma_reduce_add(&maps.dbias, kc, i * QB, un.group, part);", "(void)part;"),
    "K5: the cosine chain's - qh alpha term dropped from dq": (
        "window_attn_bwd.cu",
        "__fmul_rn(__fsub_rn(dqh[i], __fmul_rn(qh[i], a)), qinv)", "__fmul_rn(dqh[i], qinv)"),
    "K5: z taken from the neighbouring row for dk and dv": (
        "window_attn_bwd.cu",
        "const float zinv = 1.f / z[h], szr = __fmul_rn(sc, zinv);",
        "const float zinv = 1.f / z[h], szr = __fmul_rn(sc, 1.f / z[h ^ 1]);",
        "gv[k2] = __fmul_rn(gv[k2], zinv);", "gv[k2] = __fmul_rn(gv[k2], 1.f / z[h ^ 1]);",
        "const float x = __fmul_rn(q_s[r * SQ + d], sz_s[r]), y = __fmul_rn(k_s[r * SQ + d], "
        "zinv_s[r]);",
        "const float x = __fmul_rn(q_s[r * SQ + d], sz_s[r ^ 1]), y = __fmul_rn(k_s[r * SQ + d], "
        "zinv_s[r ^ 1]);"),
    "K5 bf16 kernel: one key unit's dq part skipped": (
        "window_attn_bwd.cu", "tma_reduce_add(&maps.dq, c0, i * kT, un.row, part);",
        "if (un.u != 1) tma_reduce_add(&maps.dq, c0, i * kT, un.row, part);"),
    "K5 bf16 kernel: dbias added out of the fixed order, the counter bypassed": (
        "window_attn_bwd.cu", "while (ld_acquire_gpu(cb) != un.level) {",
        "while (false && ld_acquire_gpu(cb) != un.level) {"),
    "K5 bf16 kernel: one row's dbias contribution dropped": (
        "window_attn_bwd.cu",
        "tma_reduce_add(&maps.dbias, kc, i * kT, un.group, src + kb * (kT * 128));",
        "if (un.level != 1) tma_reduce_add(&maps.dbias, kc, i * kT, un.group, "
        "src + kb * (kT * 128));"),
    "K5 bf16 kernel: a ring stage's bias read one step stale": (
        "window_attn_bwd.cu", "unsigned char* const bt = smem + L::kRing + stage * L::kStage;",
        "unsigned char* const bt = smem + L::kRing + (stage + kS - 1) % kS * L::kStage;"),
    "K9, K11 bf16 kernel: h's squares taken before its rounding to bf16": (
        "convnext_block.cu", "sq0 += v0 * v0;\n          sq1 += v1 * v1;",
        "const float u0 = gelu_sigmoid(acc[4 * j + 2 * h] + b.x);\n"
        "          const float u1 = gelu_sigmoid(acc[4 * j + 2 * h + 1] + b.y);\n"
        "          sq0 += u0 * u0;\n          sq1 += u1 * u1;"),
    "K9, K11: one row tile's GRN partial dropped": (
        "convnext_block.cu", "for (int t = 0; t < row_tiles; ++t) s += p[(size_t)t * c4 + c];",
        "for (int t = 0; t < row_tiles; ++t) s += t == 1 ? 0.f : p[(size_t)t * c4 + c];"),
    "K9, K11 bf16 kernel: the residual added after acc + b2 is rounded": (
        "convnext_block.cu",
        "x.x + (acc[4 * j + 2 * h] + b.x), x.y + (acc[4 * j + 2 * h + 1] + b.y));",
        f"x.x + {ROUND_BF16.format('acc[4 * j + 2 * h] + b.x')}, "
        f"x.y + {ROUND_BF16.format('acc[4 * j + 2 * h + 1] + b.y')});"),
    # the LayerNorm pre-pass is K9's, K7's (bf16) and K10's
    "K9 bf16 kernel: the LayerNorm without its eps": (
        "gemm_tile.cuh", "rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + kLnEps);",
        "rsqrtf(fmaxf(ss / C - mean * mean, 0.f));"),
    "K9, K11 bf16 kernel: a pw1 ring stage read one step stale": (
        "convnext_block.cu",
        "wg * kWA);\n      const uint32_t b_tile = smem_addr(smem + stage * kWStage + 2 * kWA);",
        "wg * kWA);\n      const uint32_t b_tile = smem_addr(smem + (stage + kWStages - 1) % "
        "kWStages * kWStage + 2 * kWA);"),
    "K10: the GRN term ab dgx / gx dropped from dab": (
        "convnext_block_bwd.cu", "const float d = (dz[at] * ca + a * cb) * gelu_grad(x, t);",
        "const float d = (dz[at] * ca) * gelu_grad(x, t);",
        "const float d = (dz_v * ca_v + a * cb_v) * gelu_grad(x, tt);",
        "const float d = (dz_v * ca_v) * gelu_grad(x, tt);"),
    "K10: the GELU derivative's 3 K1 written as K1": (
        "convnext_block_bwd.cu", "constexpr float kGelu3K1 = 0.134145f;",
        "constexpr float kGelu3K1 = 0.044715f;"),
    "K10: the LN backward's xhat mean(dyh xhat) term dropped": (
        "convnext_block_bwd.cu", "store(out + c, st.y * (dyh - m1 - xhat * m2));",
        "store(out + c, st.y * (dyh - m1));",
        "return rstd[h] * (dyh - m1[h] - xhat * m2[h]);", "return rstd[h] * (dyh - m1[h]);"),
    "K10: dW1 summed over the first image only": (
        "convnext_block_bwd.cu", "TnArgs t1{dh1, y, br, ws.chunk, c4, c, part_w1};",
        "TnArgs t1{dh1, y, rows, ws.chunk, c4, c, part_w1};",
        "launch_wgrad(dh1_rows, y_rows, c4, c, br,", "launch_wgrad(dh1_rows, y_rows, c4, c, rows,"),
    "K10 bf16 kernel: pass 2's h1 recomputed in another k order": (
        "convnext_block_bwd.cu",
        "const int k16 = 16 * kk;  // the same k order in both passes: ab bit-equal",
        "const int k16 = kP2 ? 16 * (3 - kk) : 16 * kk;"),
    "K10 bf16 kernel: a weight product's B operand read K-major": (
        "convnext_block_bwd.cu",
        "Wgmma<128>::template ss<TA, 1>(acc, da, desc_mn_major<128>(b_tile, 64, 16 * kk, 0),",
        "Wgmma<128>::template ss<TA, 0>(acc, da, desc_k_major<64>(b_tile, 128, 0, 16 * kk),"),
}


def use_sources(directory: Path):
    _build.CSRC_DIR = directory
    _build.load.cache_clear()
    _build.load()


def worst(readings):
    """The largest of each reading; a NaN (which agrees with nothing) sticks."""
    out = {}
    for e in readings:
        for k, v in e.items():
            seen = out.get(k, 0.0)
            out[k] = v if v != v or (seen == seen and v > seen) else seen
    return out


def attention_cases(gen):
    """Random scores at the DINOv2 shape and ragged ones, and rows with few
    dominant scores (scores scaled up: the rounding of e shows most there)."""
    for bh, n, hd, gain in ((24, 1370, 64, 1.0), (3, 257, 64, 1.0), (2, 300, 72, 1.0),
                            (3, 729, 64, 4.0), (3, 300, 32, 8.0)):
        q, k, v = (torch.randn((bh, n, hd), generator=gen).cuda() for _ in range(3))
        yield (q * gain).bfloat16(), k.bfloat16(), v.bfloat16(), hd ** -0.5


def read_attention(scale_constant=None):
    gen = torch.Generator().manual_seed(0)
    readings = []
    with torch.inference_mode():
        for q, k, v, sc in attention_cases(gen):
            real = va.scale_constant
            if scale_constant is not None:
                va.scale_constant = scale_constant
            try:
                out = va.vit_attention_fused(q, k, v, sc)
            finally:
                va.scale_constant = real
            readings.append(va.agreement(out, va.attention_plain(q, k, v, sc),
                                         va.flip_allowance(q, k, v, sc)))
    return worst(readings)


def tail_cases(gen, dtype):
    """K9's operands (h, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta):
    ConvNeXtV2-Base's stage 3 and 4 shapes at B = 2 (576 rows are nine
    64-row units, 144 rows three with a ragged last), 49 rows at B = 3, and
    rows of small spread (std 0.02), where the LayerNorm's eps matters."""
    for b, rows, c, std in ((2, 576, 512, 1.0), (2, 144, 1024, 1.0), (3, 49, 128, 1.0),
                            (2, 576, 256, 0.02)):
        c4 = 4 * c

        def r(*shape, sc=1.0):
            return (torch.randn(shape, generator=gen) * sc).cuda()

        yield ((r(b, rows, c) * std).to(dtype), r(b, rows, c).to(dtype), 1 + r(c, sc=0.2),
               r(c, sc=0.1), r(c4, c, sc=c ** -0.5).to(dtype), r(c4, sc=0.1),
               r(c, c4, sc=c4 ** -0.5).to(dtype), r(c, sc=0.1), r(c4, sc=0.5), r(c4, sc=0.1))


def read_tail(dtype):
    """(K9's, K11's) worst ``cb.agreement`` reading over ``tail_cases``: K9
    on the tail's input h, K11 on its plain LayerNorm."""
    gen = torch.Generator().manual_seed(7)
    r9, r11 = [], []
    with torch.inference_mode():
        for h, x, lns, lnb, *tail in tail_cases(gen, dtype):
            r9.append(cb.agreement(cb._launch(h, x, lns, lnb, *tail),
                                   cb.block_tail_reference(h, x, lns, lnb, *tail)))
            y = cb.layer_norm(h, lns, lnb).to(dtype)
            r11.append(cb.agreement(cb.convnext_mlp_grn_fused(y, x, *tail),
                                    cb.mlp_grn_reference(y, x, *tail)))
    return worst(r9), worst(r11)


def backward_cases(gen, dtype):
    """K3's operands (q, k, v, g, scale): random scores at the DINOv2 shape
    and ragged ones, rows with few dominant scores, rows whose every shift
    lies below -128 at a ragged N (where 2^-m of an unmasked dead key column
    overflows), and chip_smoke.py phase 17's rows of very negative scores
    with one dominant key in the last tile (t = e (dp - c) a residue of dp)."""
    for bh, n, hd, gain in ((24, 1370, 64, 1.0), (3, 257, 64, 1.0), (2, 300, 72, 1.0),
                            (3, 729, 64, 4.0), (4, 300, 64, -8.0), (4, 300, 64, 0.0)):
        q, k, v, g = (torch.randn((bh, n, hd), generator=gen).cuda() for _ in range(4))
        if gain < 0:
            q, k = q.abs() * gain, k.abs() * -gain
        elif gain == 0.0:  # phase 17's: scores of -3 |q| . 3 |k|, key 290 twelve times the other way
            q, k = -q.abs() * 3, k.abs() * 3
            k[:, 290] *= -4.0
        else:
            q = q * gain
        sc = 0.125 if gain == 0.0 else hd ** -0.5
        yield q.to(dtype), k.to(dtype), v.to(dtype), g.to(dtype), sc


def backward_plain_with(fault):
    """``va.attention_bwd_plain`` with one rounding point moved: "t" leaves t
    in f32; "z" applies 1 / z to the score tile (p = e / z) instead of the
    small operands; "c" takes c = rowsum(p dp) from p and dp rounded to the
    input dtype instead of rowsum(g o)."""
    def plain(q, k, v, o, g, sm_scale):
        dt = q.dtype
        qs = q * torch.tensor(va.scale_constant(sm_scale, dt), dtype=dt, device=q.device)
        s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
        e = torch.exp2(s - torch.ceil(s.amax(dim=-1, keepdim=True)))
        zinv = 1.0 / e.sum(dim=-1, keepdim=True)
        g32 = g.float()
        dp = torch.matmul(g32, v.float().transpose(-1, -2))
        if fault == "c":
            c = ((e * zinv).to(dt).float() * dp.to(dt).float()).sum(dim=-1, keepdim=True)
        else:
            c = (g32 * o.float()).sum(dim=-1, keepdim=True)
        if fault == "z":
            e, row, zinv = e * zinv, sm_scale, 1.0
        else:
            row = sm_scale * zinv
        t = e * (dp - c)
        if fault != "t":
            t = t.to(dt).float()
        dq = (torch.matmul(t, k.float()) * row).to(dt)
        qz, gz = (q.float() * row).to(dt), (g32 * zinv).to(dt)
        dk = torch.matmul(t.transpose(-1, -2), qz.float()).to(dt)
        dv = torch.matmul(e.to(dt).float().transpose(-1, -2), gz.float()).to(dt)
        return dq, dk, dv

    return plain


def read_backward(dtype, plain=va.attention_bwd_plain):
    """K3's worst ``va.grad_agreement`` reading over ``backward_cases``."""
    gen = torch.Generator().manual_seed(4)
    readings = []
    for q, k, v, g, sc in backward_cases(gen, dtype):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = va.vit_attention_fused(*leaves, sc)
        grads = torch.autograd.grad(out, leaves, g)
        for a, b, floor in zip(grads, plain(q, k, v, out.detach(), g, sc),
                               va.grad_floors(q, k, v, g, sc)):
            readings.append(va.grad_agreement(a, b, floor))
    return worst(readings)


def backward_repeatable(dtype):
    """Whether two runs of K3 over ``backward_cases`` give bit-equal
    gradients."""
    gen = torch.Generator().manual_seed(4)
    for q, k, v, g, sc in backward_cases(gen, dtype):
        runs = []
        for _ in range(2):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            runs.append(torch.autograd.grad(va.vit_attention_fused(*leaves, sc), leaves, g))
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            return False
    return True


def gather_backward_atomic(ctx, g):
    """ConceptGather's backward as indexing's own: index_add_, atomic adds in
    the cotangent's dtype in no fixed order on the card."""
    (inverse,) = ctx.saved_tensors
    flat = inverse.reshape(-1).long()
    rows = torch.zeros((ctx.rows, g.shape[-1]), dtype=g.dtype, device=g.device)
    return rows.index_add_(0, flat, g.reshape(flat.shape[0], -1)), None


def read_train_slice():
    """chip_smoke.py's f32 DINOv2 training slice, the kernels against their
    plain versions: the reading its TRAIN_F32_MEAN_TOL gates."""
    import chip_smoke as cs

    with tempfile.TemporaryDirectory() as tmp:
        data, pt, start, steps, _ = cs.dinov2_train_setup(Path(tmp))
        run = cs.make_trainer(Path(tmp), "dinov2", data, "-p", "2")
        with cs.env_flags(XMIR_FUSED_LN_MLP=None, **cs.FUSED_VIT):
            return cs.f32_kernels_against_plain(run, pt, start, steps[0])


def tail_bwd_cases(gen, dtype):
    """K10's operands (h, dy, ln_scale, ln_bias, w1, b1, w2, gamma, beta): two
    of ConvNeXtV2-Base's stage shapes at 384 px (B = 2) and the tiny model's
    width at 49 rows."""
    for b, hw, c in ((2, 48, 256), (2, 12, 1024), (2, 7, 96)):
        c4 = 4 * c

        def r(*shape, sc=1.0):
            return (torch.randn(shape, generator=gen) * sc).cuda()

        h, dy = r(b, hw * hw, c).to(dtype), r(b, hw * hw, c).to(dtype)
        yield (h, dy, 1 + r(c, sc=0.2), r(c, sc=0.1), r(c4, c, sc=c ** -0.5).to(dtype),
               r(c4, sc=0.1), r(c, c4, sc=c4 ** -0.5).to(dtype), r(c4, sc=0.5), r(c4, sc=0.1))


def tail_plain_dh1_unrounded(h, dy, ln_scale, ln_bias, w1, b1, w2, gamma, beta):
    """K10's plain version with dh1 left in f32 before its products (dW1 and
    dyln): tail_backward_reference from its intermediates, dh1b = dh1."""
    t = cb._tail_backward_terms(h, dy, ln_scale, ln_bias, w1, b1, w2, gamma, beta)
    c, c4 = h.shape[-1], w1.shape[0]
    xhat, dh1 = t["xhat"], t["dh1"]
    dyln = dh1 @ w1.float()
    dyh = dyln * ln_scale.float()
    dacc = t["rstd"] * (dyh - dyh.mean(dim=-1, keepdim=True)
                        - xhat * (dyh * xhat).mean(dim=-1, keepdim=True))
    return (dacc.to(h.dtype), (dyln * xhat).sum(dim=(0, 1)), dyln.sum(dim=(0, 1)),
            dh1.reshape(-1, c4).t() @ t["y"].float().reshape(-1, c), dh1.sum(dim=(0, 1)),
            cb.linear_f32(dy.reshape(-1, c).t(), t["z"].reshape(-1, c4).t()),
            (t["s1"] * t["nx"]).sum(dim=(0, 1)), t["dz"].sum(dim=(0, 1)))


def read_tail_bwd(dtype, plain=cb.tail_backward_reference):
    """K10's worst ``va.grad_agreement`` reading over its eight outputs
    and ``tail_bwd_cases``; in bf16 also whether pass 2 formed ab bit for bit
    as pass 1 did in every case (``ab_recomputed``)."""
    gen = torch.Generator().manual_seed(5)
    readings, recomputed = [], True
    for args in tail_bwd_cases(gen, dtype):
        for out, ref, floor in zip(cb.convnext_tail_bwd(*args), plain(*args),
                                   cb.tail_grad_floors(*args)):
            readings.append(va.grad_agreement(out, ref, floor, dtype))
        if dtype == torch.bfloat16:
            recomputed &= cb.tail_bwd_recomputes_ab(*args)
    reading = worst(readings)
    if dtype == torch.bfloat16:
        reading["ab_recomputed"] = recomputed
    return reading


def tail_bwd_agrees(reading) -> bool:
    """K10's bounds, and in bf16 pass 2's ab bit-equal to pass 1's."""
    return va.grad_agrees(reading) and reading.get("ab_recomputed", True)


def k5_cases(gen, dtype):
    """K5's operands (q, k, v, bias, scale, g, g_size) in Swin's fold at
    B = 2: stage 3 (one window, 16 heads), stage 1 shifted (a -100 mask),
    stage 4 (N = 144), and stage 3 with every scale at the clamp of 100."""
    import chip_smoke as cs

    for nw, h, n, shifted, clamp in ((1, 16, 576, False, False), (16, 4, 576, True, False),
                                     (1, 32, 144, False, False), (1, 16, 576, False, True)):
        bh, groups, g_size = cs.swin_fold(2, nw, h, shifted)
        q, k, v, bias, scale, g = cs._k5_inputs(gen, bh, groups, n, cs.SWIN_HD, dtype, shifted,
                                                scale_max=60.0)
        if clamp:
            scale.fill_(100.0)
        yield q, k, v, bias, scale, g, g_size


def k5_plain_t_unrounded(q, k, v, bias, scale, o, g, g_size, cosine):
    """``va.biased_attention_bwd_plain`` with t left in f32 before its two
    products (the rest written out as there)."""
    bh, n, _ = q.shape
    groups = bias.shape[0]
    gidx = va.group_index(bh, groups, g_size, q.device)
    sc = scale.reshape(-1).float()[gidx][:, None, None]
    qf, kf = q.float(), k.float()
    qinv, kinv = va.inv_norm(qf), va.inv_norm(kf)
    qh32, kh32 = qf * qinv, kf * kinv
    qh, kh = qh32.to(q.dtype).float(), kh32.to(k.dtype).float()
    s2 = torch.matmul(qh, kh.transpose(-1, -2)) * (sc * va.LOG2E) + (bias * va.LOG2E)[gidx]
    e = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    zinv = 1.0 / e.sum(dim=-1, keepdim=True)
    g32 = g.float()
    t = e * (torch.matmul(g32, v.float().transpose(-1, -2))
             - (g32 * o.float()).sum(dim=-1, keepdim=True))
    tz = (t * zinv).reshape(groups, g_size, n, n)
    dbias = tz[:, 0]
    for r in range(1, g_size):
        dbias = dbias + tz[:, r]
    dqh = torch.matmul(t, kh) * (sc * zinv)
    alpha = (dqh * qh32).sum(dim=-1, keepdim=True)
    dkh = torch.matmul(t.transpose(-1, -2), (qh32 * (sc * zinv)).to(q.dtype).float())
    dk = (dkh - kh32 * (dkh * kh32).sum(dim=-1, keepdim=True)) * kinv
    dv = torch.matmul(e.to(q.dtype).float().transpose(-1, -2), (g32 * zinv).to(g.dtype).float())
    dscale = alpha.sum(dim=(1, 2)).reshape(groups, -1).sum(dim=1) / scale
    return (((dqh - qh32 * alpha) * qinv).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias,
            dscale)


def k5_dscale_undivided(q, k, v, bias, scale, o, g, g_size, cosine):
    """K5 with its wrapper's division of dscale by scale_g left out."""
    dq, dk, dv, dbias, dscale = va.biased_attention_bwd(q, k, v, bias, scale, o, g, g_size,
                                                        cosine)
    return dq, dk, dv, dbias, dscale * scale


def read_k5(dtype, kernel=va.biased_attention_bwd, plain=va.biased_attention_bwd_plain):
    """K5's worst ``va.biased_grad_agreement`` reading over its five outputs
    and ``k5_cases``."""
    gen = torch.Generator().manual_seed(6)
    readings = []
    for q, k, v, bias, scale, g, g_size in k5_cases(gen, dtype):
        with torch.no_grad():
            o = va.biased_attention_fused(q, k, v, bias, scale, g_size, True)
        outs = kernel(q, k, v, bias, scale, o, g, g_size, True)
        refs = plain(q, k, v, bias, scale, o, g, g_size, True)
        floors = va.biased_grad_floors(q, k, v, bias, scale, g, g_size, True)
        readings += va.biased_grad_agreement(outs, refs, floors, dtype).values()
    return worst(readings)


def k5_repeatable(dtype):
    """Whether two runs of K5 over ``k5_cases`` give bit-equal outputs."""
    gen = torch.Generator().manual_seed(6)
    for q, k, v, bias, scale, g, g_size in k5_cases(gen, dtype):
        with torch.no_grad():
            o = va.biased_attention_fused(q, k, v, bias, scale, g_size, True)
        runs = [va.biased_attention_bwd(q, k, v, bias, scale, o, g, g_size, True)
                for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            return False
    return True


def ln_plain_unrounded(x, lns, lnb, w, b, act):
    """K8's plain version with the LayerNorm output left in f32."""
    y = cb.layer_norm(x, lns, lnb)
    out = torch.nn.functional.linear(y.float(), w.float())
    if b is not None:
        out = out + b
    if act == "gelu":
        out = torch.nn.functional.gelu(out, approximate="tanh")
    return out.to(x.dtype)


def ln_dense_canary(x, lns, lnb, w, b, act, pad=64):
    """bf16 K8 through its C entry point into a buffer of ``pad`` canary rows
    after the (R, M) output: (the output, whether every canary is intact)."""
    rows, c = x.shape
    m = w.shape[0]
    buf = torch.full((rows + pad, m), 7.0, dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    lns32, lnb32, b32 = (t.float().contiguous() for t in (lns, lnb, b))
    err = _build.load().xmir_ln_dense(
        x.data_ptr(), lns32.data_ptr(), lnb32.data_ptr(), w.data_ptr(), b32.data_ptr(),
        ld.DTYPE_CODES[x.dtype], rows, c, m, int(act == "gelu"), y.data_ptr(), buf.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"LN -> dense kernel launch failed: cudaError_t {err}")
    torch.cuda.synchronize()
    return buf[:rows], bool((buf[rows:] == 7.0).all())


def read_ln(dtype, plain_unrounded=False):
    """K7's and K8's worst readings; bf16 K8's also says whether the canary
    rows after its output stayed intact (canary_intact)."""
    gen = torch.Generator().manual_seed(1)
    r7, r8, canary = [], [], True

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen) * sc).cuda()

    with torch.inference_mode():
        # the second case's rows are small (std 0.02 about 0), so that eps
        # matters; the last two are K8's alone: the DINOv2 batch of 16, and a
        # ragged R (1370 = 21 x 64 + 26) at an M whose last column tile holds
        # 2 of 256 columns
        for b, n, c, m, heads, std, mean in ((2, 1370, 768, 3072, 12, 2.0, 0.5),
                                             (2, 257, 256, 1024, 4, 0.02, 0),
                                             (16, 1370, 768, 3072, 0, 2.0, 0.5),
                                             (1, 1370, 768, 514, 0, 2.0, 0.5)):
            x = (r(b, n, c) * std + mean).to(dtype)
            lns, lnb = 1 + r(c, sc=0.2), r(c, sc=0.1)
            w1, b1 = r(m, c, sc=c ** -0.5).to(dtype), r(m, sc=0.1)
            rows = x.reshape(b * n, c)
            if heads and not plain_unrounded:
                w, bias = r(3 * c, c, sc=c ** -0.5).to(dtype), r(3 * c, sc=0.1)
                for o, ref in zip(ld.ln_qkv_fused(x, lns, lnb, w, bias, heads),
                                  ld.ln_qkv_reference(x, lns, lnb, w, bias, heads)):
                    r7.append(ld.agreement(o, ref))
            for act in ("gelu", ""):
                if dtype == torch.bfloat16:
                    out, intact = ln_dense_canary(rows, lns, lnb, w1, b1, act)
                    canary &= intact
                else:
                    out = ld.ln_dense_fused(rows, lns, lnb, w1, b1, 1e-6, act)
                ref = (ln_plain_unrounded(rows, lns, lnb, w1, b1, act) if plain_unrounded
                       else ld.ln_dense_reference(rows, lns, lnb, w1, b1, 1e-6, act))
                r8.append(ld.agreement(out, ref))
    e8 = worst(r8)
    if dtype == torch.bfloat16:
        e8["canary_intact"] = canary
    return worst(r7), e8


def ln_dense_agrees(reading) -> bool:
    """K8 within its bounds, and (bf16) no row stored past R."""
    return cb.agrees(reading) and reading.get("canary_intact", True)


def window_cases(gen, dtype):
    """K4's operands in its fold (head, window, image): SwinV2-Base's last two
    stage shapes at B = 2, a shifted fold with ragged N, and a case with every
    scale at the clamp, few live keys a row and rows of norm 1e-9 (which only
    the 1e-24 clamp normalises). Yields (q, k, v, bias, scale, g_size, b, nw, h)."""
    for b, nw, h, n, shifted, hard in ((2, 1, 16, 576, False, False), (2, 1, 32, 144, False, False),
                                       (2, 4, 2, 140, True, False), (3, 4, 2, 144, True, True)):
        q, k, v = (torch.randn((h * nw * b, n, 32), generator=gen).cuda() for _ in range(3))
        groups = h * nw if shifted else h
        bias = (16 * torch.rand((groups, n, n), generator=gen)).cuda()
        if shifted:
            bias += torch.where(torch.rand((groups, n, n), generator=gen) < 0.4, -100.0,
                                0.0).cuda()
        scale = (1 + 59 * torch.rand(groups, generator=gen)).cuda()
        if hard:
            scale.fill_(100.0)
            bias[:, :, 3:] -= 100.0
            q[:, ::3] *= 1e-9 / 5.6
            k[:, 1::4] *= 1e-9 / 5.6
        yield (q.to(dtype), k.to(dtype), v.to(dtype), bias, scale,
               b if shifted else nw * b, b, nw, h)


def plain_k_unrounded(q, k, v, bias, scale, g_size, cosine):
    """K4's plain version with the normalised k left in f32."""
    gidx = va.group_index(q.shape[0], bias.shape[0], g_size, q.device)
    c = (scale.reshape(-1).float() * va.LOG2E)[gidx][:, None, None]
    qf, kf = q.float(), k.float()
    qs = ((qf * va.inv_norm(qf)) * c).to(q.dtype)
    s = torch.matmul(qs.float(), (kf * va.inv_norm(kf)).transpose(-1, -2))
    s = s + (bias.float() * va.LOG2E)[gidx]
    e = torch.exp2(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(e.to(v.dtype).float(), v.float())
    return (o / e.sum(dim=-1, keepdim=True)).to(v.dtype)


def read_window(dtype, k4_plain=va.biased_attention_plain):
    """(K4's, K6's) worst reading over ``window_cases``."""
    gen = torch.Generator().manual_seed(2)
    r4, r6 = [], []
    with torch.inference_mode():
        for q, k, v, bias, scale, g_size, b, nw, h in window_cases(gen, dtype):
            out = va.biased_attention_fused(q, k, v, bias, scale, g_size, True)
            r4.append(va.window_agreement(out, k4_plain(q, k, v, bias, scale, g_size, True)))
            n = q.shape[1]

            def layout(t):
                return t.reshape(h, nw, b, n, 32).permute(1, 2, 0, 3, 4).contiguous()

            qf, kf = layout(q).float(), layout(k).float()
            per_head = scale.reshape(h, -1)[:, 0].reshape(1, 1, h, 1, 1)
            ops = ((qf * va.inv_norm(qf) * per_head).to(dtype), (kf * va.inv_norm(kf)).to(dtype),
                   layout(v), bias.reshape(h, -1, n, n).permute(1, 0, 2, 3).contiguous())
            r6.append(va.window_agreement(wa.window_attention_fused(*ops),
                                          wa.window_attention_plain(*ops)))
    return worst(r4), worst(r6)


def read_select():
    """K1' on integer inputs with planted ties, masked rows and -0 scores:
    of_bound 0 when ids and values are bit-equal to the plain version's."""
    gen = torch.Generator().manual_seed(3)
    equal = True
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randint(-3, 4, (33, 64), generator=gen).float()
        g = torch.randint(-3, 4, (4099, 64), generator=gen).float()
        g[[5, 63, 64, 2048, 4098]] = g[3].clone()
        q[0] = g[3]
        q, g = q.to("cuda", dtype), g.to("cuda", dtype)
        bias = torch.zeros(4099, device="cuda")
        bias[4090:] = float("-inf")
        for k in (1025, 2048, 4099):
            v, i = fused_topk_scores(q, g, bias, k)
            torch.cuda.synchronize()
            rv, ri = topk_scores_reference(q, g, bias, k)
            equal &= torch.equal(v, rv) and torch.equal(i, ri)
        # products that all underflow to -0 on some rows (a query of -1e-30
        # against rows of 1e-30), to +0 on the rest, plus a bias of -0: scores
        # of -0 and +0, all equal, so the ranking is the row order
        q = torch.zeros((2, 64))
        g = torch.zeros((2100, 64))
        q[0], q[1] = -1e-30, 1e-30
        g[10:900:7] = 1e-30
        g[900:1500:5] = -1e-30
        i = fused_topk_scores(q.to("cuda", dtype), g.to("cuda", dtype),
                              torch.full((2100,), -0.0, device="cuda"), 2100)[1]
        equal &= torch.equal(i, torch.arange(2100, device="cuda", dtype=torch.int32).expand(2, -1))
    return {"max_abs_err": 0.0, "of_bound": 0.0 if equal else float("inf"), "mean_steps": 0.0}


def read_k1():
    """K1 against its plain version: integer inputs bit-equal (ties inside a
    tile, across tile edges, split edges and the merge's lane wrap, masked
    rows, ragged ends) at both routes, and f32 rows of full mantissas within
    topk_kernels.f32_score_error's bound. of_bound: the worst score reading,
    inf where an integer case differs."""
    import chip_smoke as cs

    gen = torch.Generator().manual_seed(5)
    worst, worst_abs = 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for q_n, n, d, k in ((70, 4099, 96, 10), (300, 4099, 64, 32), (16, 100_000, 64, 10),
                             (70, 4099, 96, 100), (1, 4099, 96, 10), (70, 4099, 97, 200)):
            # rows masked at the end, and every score below zero: the zeros
            # the copy engine reads past row N would rank first if unmasked
            for low in (0.0, -1000.0):
                bias = torch.full((n,), low, device="cuda")
                bias[n - 37:] = float("-inf")
                q, g = cs._int_inputs(gen, q_n, n, d, k, dtype)
                v, i = fused_topk_scores(q, g, bias, k)
                torch.cuda.synchronize()
                rv, ri = topk_scores_reference(q, g, bias, k)
                if not (torch.equal(v, rv) and torch.equal(i, ri)):
                    worst = float("inf")
    for q_n, n, d, k in cs.FULL_MANTISSA_SHAPES:
        q = torch.randn((q_n, d), generator=gen).cuda()
        g = torch.randn((n, d), generator=gen).cuda()
        bias = torch.randn(n, generator=gen).cuda()
        reading = f32_score_error(q, g, bias, *fused_topk_scores(q, g, bias, k))
        worst, worst_abs = max(worst, reading["of_bound"]), max(worst_abs, reading["max_abs_err"])
    return {"max_abs_err": worst_abs, "of_bound": worst, "mean_steps": 0.0}


def swap_first_tie(v, i):
    """(v, i) with the ids of the first two tied slots swapped: the lower
    row no longer first among equal scores."""
    i = i.clone()
    qi, s = (v[:, 1:] == v[:, :-1]).nonzero()[0].tolist()
    i[qi, s], i[qi, s + 1] = i[qi, s + 1].clone(), i[qi, s].clone()
    return v, i


def read_hamming(kernel=fused_topk_scores):
    """K1 on +/-1 codes at D = 48 over 100,000 rows, Q = 1024, k = 10, f32
    and bf16, by chip_smoke.py phase 42's check (k1_hamming_reading): of_bound
    0 where ids and values are bit-equal to the plain version's, else inf."""
    import chip_smoke as cs

    gen = torch.Generator().manual_seed(6)
    equal = True
    for dtype in (torch.float32, torch.bfloat16):
        q = cs.sign_rows(gen, 1024).to("cuda", dtype)
        g = cs.sign_rows(gen, cs.SERVING_N).to("cuda", dtype)
        equal &= cs.k1_hamming_reading(q, g, 10, kernel)["bit_equal"]
    return {"max_abs_err": 0.0, "of_bound": 0.0 if equal else float("inf"), "mean_steps": 0.0}


def read_ath(padded_pool=False):
    """chip_smoke.py phase 44's checks of cli.train_ath on a generated COVIDx
    tree: the three steps' losses against the CPU's (``ath_losses_agree``)
    and the first step's gradients against float64's (``ath_grads_agree``),
    of_bound the larger share of their bounds. With ``padded_pool``, ATHNet's
    average pool pads by ``F.avg_pool2d`` itself, whose CUDA backward on a
    channels_last map is wrong (torch 2.11, CUDA 12.8)."""
    import chip_smoke as cs
    from xmir_tpu_torch.models import ath

    fixed = ath.avg_pool_3x3
    if padded_pool:
        ath.avg_pool_3x3 = lambda h: torch.nn.functional.avg_pool2d(h, 3, stride=1, padding=1)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tree = cs.covidx_tree(Path(tmp), "f")
            losses = cs.ath_train_reading(Path(tmp), tree, str(Path(tmp) / "ath.pt"))
            grads = cs.ath_first_step_grads(tree)
    finally:
        ath.avg_pool_3x3 = fixed
    return {"of_bound": max(losses["of_bound"], grads["of_bound"]),
            "losses_rel": losses["rel"], "grads_rel": grads["card"],
            "agree": cs.ath_losses_agree(losses) and cs.ath_grads_agree(grads)}


def decode_cell_major(self, maps):
    """YOLOv5.decode_maps with the rows flattened cell-major, (b, ny, nx, na,
    no), where ultralytics flattens anchor-major."""
    na, no = self.detect.na, self.detect.no
    anchors = self.anchors_px
    outs = []
    for i, p in enumerate(maps):
        b, _, ny, nx = p.shape
        y = torch.sigmoid(p.float().reshape(b, na, no, ny, nx).permute(0, 3, 4, 1, 2))
        gy, gx = torch.meshgrid(torch.arange(ny, device=p.device),
                                torch.arange(nx, device=p.device), indexing="ij")
        grid = torch.stack([gx, gy], dim=-1).float().view(ny, nx, 1, 2) - 0.5
        xy = (y[..., 0:2] * 2.0 + grid) * yolo.STRIDES[i]
        wh = (y[..., 2:4] * 2.0) ** 2 * anchors[i].view(1, 1, 1, na, 2)
        outs.append(torch.cat([xy, wh, y[..., 4:]], dim=-1).reshape(b, -1, no))
    return torch.cat(outs, dim=1)


def sppf_zero_padded(self, x):
    """SPPF's max pool padded with zeros, where flax and ultralytics pad
    with -inf."""
    pad = self.k // 2
    return torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(x, (pad, pad, pad, pad)), self.k, stride=1)


YOLO_FAULTS = {
    "the decode's rows flattened cell-major, not anchor-major": (yolo.YOLOv5, "decode_maps",
                                                                  decode_cell_major),
    "SPPF's max pool padded with zeros, not -inf": (yolo.SPPF, "pool", sppf_zero_padded),
}


def read_chestmir():
    """chip_smoke.py phase 47's check on two 1024^2 films through the first
    of its seeded YOLOv5s folds: the card's predictions against the CPU's
    and against the ultralytics oracle (of_bound: the larger worst share of
    atol 2e-4 + rtol 1e-4), with the port as it is and with each fault of
    YOLO_FAULTS planted in models/yolo.py for the reading. Yields (name,
    reading, expected inside)."""
    import chip_smoke as cs

    with tempfile.TemporaryDirectory() as tmp:
        tree = cs.write_chest_tree(Path(tmp), n=2)
        images = [cs._letterboxed(tree[0], i) for i in range(2)]
        pts, _ = cs.write_yolo_folds(Path(tmp), [x for _, x in images])
        for name, fault in [("the port's YOLOv5s (chip_smoke.py phase 47)", None)] + list(
                YOLO_FAULTS.items()):
            if fault is not None:
                owner, attr, planted = fault
                fixed = getattr(owner, attr)
                setattr(owner, attr, planted)
            try:
                reading = cs.yolo_reading(pts[0], images)[0]
            finally:
                if fault is not None:
                    setattr(owner, attr, fixed)
            yield name, {k: reading[k] for k in ("of_bound", "card_vs_cpu", "card_vs_oracle",
                                                  "max_abs_err")}, fault is None


def merge_ties_to_higher_ids(vals, idxs, k):
    """The fault: the shards' blocks merged last-first, so that equal scores
    go to the higher gallery id."""
    from xmir_tpu_torch.index.gallery import merge_shard_candidates

    return merge_shard_candidates(vals.flip(0), idxs.flip(0), k)


def read_shard_merge(merge=None):
    """Phase 51's check on duplicates planted across the boundaries of 4
    shards (Q = 1024, N = 100,000, D = 1024, f32, k = 10)."""
    import chip_smoke as cs
    from xmir_tpu_torch.ops.distance import l2_normalize

    gen = torch.Generator().manual_seed(51)
    q = l2_normalize(torch.randn((1024, 1024), generator=gen)).cuda()
    g = l2_normalize(torch.randn((100_000, 1024), generator=gen)).cuda()
    q, g = cs.planted_shard_inputs(q, g)
    kwargs = {} if merge is None else {"merge": merge}
    return cs.shard_reading(q, g, 10, torch.float32, **kwargs)[0]


DP_SPECS = {"densenet121": (dict(growth_rate=8, block_config=(2, 2, 2, 2),
                                 num_init_features=16), 64)}
DP_FAULTS = ("gradient world times too large", "per-rank BatchNorm statistics")


def dp_worker(rank, world, root, fault):
    """cli.train --use-mesh on a narrow DenseNet121 (a world of ``world``
    gloo ranks), with ``fault`` planted in this process."""
    import torch_mesh_workers
    from xmir_tpu_torch.parallel import data_parallel
    from xmir_tpu_torch.parallel import mesh as mesh_module

    if fault == DP_FAULTS[0]:  # every rank's identical gradient summed into each rank's rows
        def backward(ctx, g):
            g = ctx.mesh.all_reduce_(g.contiguous().clone())
            lo = ctx.mesh.rank * ctx.rows
            return g[lo:lo + ctx.rows], None

        mesh_module._GatherRows.backward = staticmethod(backward)
    elif fault == DP_FAULTS[1]:
        data_parallel.sync_batch_norm = lambda model, mesh: model
    argv = ["--dataset", "synthetic", "--device", "cpu", "--model", "densenet121",
            "--embedding-dim", "16", "-p", "2", "-k", "4", "-j", "1", "--print-freq", "1",
            "--eval-freq", "1", "--ckpt-every", "1", "--lr", "1e-3", "--margin", "2.0",
            "--epochs", "1", "--save-dir", f"{root}/ck", "--metrics-log", f"{root}/log.jsonl",
            "--use-mesh"]
    return torch_mesh_workers.train_worker(rank, world, [argv], DP_SPECS)[0]


def read_dp(fault=None):
    """The data-parallel training check at a world of 2 (with ``fault``)
    against a world of 1 (without), on the CPU."""
    import json

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_mesh_workers

    with tempfile.TemporaryDirectory() as tmp:
        out = {}
        for world, f in ((1, None), (2, fault)):
            root = Path(tmp) / f"w{world}"
            root.mkdir()
            recs = torch_mesh_workers.run_world(dp_worker, world, root, str(root), f)
            with open(root / "log.jsonl") as fh:
                losses = [json.loads(line)["loss"] for line in fh if '"train"' in line]
            out[world] = (recs, losses)
    (one,), l1 = out[1]
    (r0, r1), l2 = out[2]
    return {"first_loss_diff": abs(l1[0] - l2[0]),
            "norm_rel": max(abs(a - b) / b for a, b in zip(r0["norms"][:2], one["norms"][:2])),
            "buffers_equal": all(torch.equal(v, r1["buffers"][k])
                                 for k, v in r0["buffers"].items())}


def dp_agrees(reading) -> bool:
    return (reading["first_loss_diff"] <= 1e-5 and reading["norm_rel"] <= 1e-5
            and reading["buffers_equal"])


TP_FAULTS = ("the row-parallel bias added on every rank",
             "the sum's backward summing again (tp times the gradient)",
             "qkv slots cut in the wrong rank order",
             "the tie read in the torch layout (proj split by its output)")
TP_VIT = dict(img_size=56, dim=256, depth=2, num_heads=4)


def tp_fault_worker(rank, world, shape, cases, fault):
    """tests/torch_mesh_workers.py ``tp_worker`` with ``fault`` planted in
    this process, and the ViT-B/14 rule table it gives."""
    import chip_smoke as cs
    import torch_mesh_workers
    from xmir_tpu_torch.parallel import mesh as mesh_module
    from xmir_tpu_torch.parallel import tensor_parallel as tpm

    if fault == TP_FAULTS[0]:
        def row_with_bias(self, fn, bias, dtype, *inputs):
            return self.row(lambda r, *a: fn(r, *a) + bias.float(), *inputs).to(dtype)

        tpm.ModelAxis.row_with_bias = row_with_bias
    elif fault == TP_FAULTS[1]:
        def backward(ctx, g):
            return ctx.mesh.model_all_reduce_(g.contiguous().clone()), None

        tpm._Sum.backward = staticmethod(backward)
    elif fault == TP_FAULTS[2]:
        rows = tpm.head_major_rows
        tpm.head_major_rows = lambda heads, hd, tp: torch.cat(rows(heads, hd, tp).chunk(tp)[::-1])
    elif fault == TP_FAULTS[3]:
        rule = mesh_module.tp_shard_axis
        mesh_module.tp_shard_axis = (
            lambda shape, kind, n_model, min_dim=256: rule(shape, "same", n_model, min_dim))
    out = torch_mesh_workers.tp_worker(rank, world, shape, cases)
    out["rule"] = cs.vit_b14_rule(2)
    return out


def read_tp(fault=None):
    """A narrow ViT (dim 256, 4 heads, 2 blocks, 56 px, random nonzero
    weights) split over a (1, 2) mesh of gloo ranks on the CPU (with
    ``fault``), eager and on the fused path (K8 / K2's plain versions),
    against world 1: the outputs' largest difference, the gradients' largest
    difference relative to world 1's largest magnitude, the model weights
    gathered whole, and whether the ViT-B/14 rule table is phase 55's."""
    import chip_smoke as cs

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_mesh_workers

    model = cs.randomized_vit(55, **TP_VIT)
    gen = torch.Generator().manual_seed(56)
    x = torch.randn((4, 56, 56, 3), generator=gen)
    cot = torch.randn((4, 256), generator=gen)
    envs = ({}, {"XMIR_FUSED_LN": "1", "XMIR_FLASH_ATTN": "1", "XMIR_FUSED_LN_MLP": "1"})
    cases = [{"model": ("vit", dict(TP_VIT)), "state_dict": model.state_dict(), "x": x,
              "cotangent": cot, "env": env} for env in envs]
    reading = {"fwd_err": 0.0, "grad_rel": 0.0, "gathered": [], "rule_ok": True}
    with tempfile.TemporaryDirectory() as tmp:
        recs = torch_mesh_workers.run_world(tp_fault_worker, 2, tmp, (1, 2), cases, fault)
    for i, env in enumerate(envs):
        with cs.env_flags(**{k: env.get(k) for k in envs[1]}):
            one = cs.randomized_vit(55, **TP_VIT)
            y = one(x)["cls"]
            (y * cot).sum().backward()
        grads = {k: p.grad for k, p in one.named_parameters()}
        for rec in recs:
            case = rec["cases"][i]
            reading["fwd_err"] = max(reading["fwd_err"], (case["out"] - y).abs().max().item())
            rel = [((g - grads[k]).abs().max() / grads[k].abs().max()).item()
                   for k, g in case["grads"].items()]
            for k, (dim, rows, g) in case["pieces"].items():
                full = grads[k].index_select(dim, rows)
                rel.append(((g - full).abs().max() / grads[k].abs().max()).item())
            reading["grad_rel"] = max(reading["grad_rel"], *rel)
            reading["gathered"] += sorted({k for k in case["gathers"]
                                           if any(leaf in k for leaf in cs.TP_MODEL_LEAVES)})
            reading["rule_ok"] &= rec["rule"] == cs.VIT_B14_RULE[2]
    reading["gathered"] = sorted(set(reading["gathered"]))
    return reading


def tp_agrees(reading) -> bool:
    return (reading["fwd_err"] <= 1e-5 and reading["grad_rel"] <= 1e-5
            and not reading["gathered"] and reading["rule_ok"])


@contextlib.contextmanager
def op_cuda_calls_plain():
    """xmir::convnext_tail's CUDA implementation replaced by the tail's plain
    version: the same numbers, and no launch counted."""
    torch.library.register_kernel("xmir::convnext_tail", "cuda", cb.block_tail_reference)
    try:
        yield
    finally:
        torch.library.register_kernel("xmir::convnext_tail", "cuda", cb.convnext_tail_op._init_fn)


@contextlib.contextmanager
def fake_one_row_short():
    """xmir::vit_attention's fake implementation one query row short."""
    op = va.vit_attention_op
    real = op._abstract_fn

    def short(q, k, v, sm_scale, want_stats):
        return [x[:, :-1] for x in real(q, k, v, sm_scale, want_stats)]

    op.register_fake(short)
    try:
        yield
    finally:
        op.register_fake(real)


@contextlib.contextmanager
def export_swaps_q_and_k():
    """``export_backbone`` with the q and k rows of blocks.0.attn.qkv.weight
    swapped."""
    from xmir_tpu_torch.models import export as ex

    real = ex.export_backbone

    def swapped(name, model):
        sd = real(name, model)
        w = sd["blocks.0.attn.qkv.weight"]
        c = w.shape[1]
        sd["blocks.0.attn.qkv.weight"] = np.concatenate([w[c:2 * c], w[:c], w[2 * c:]])
        return sd

    ex.export_backbone = swapped
    try:
        yield
    finally:
        ex.export_backbone = real


EXPORT_FAULTS = {
    "export: xmir::convnext_tail's CUDA implementation calls the plain version":
        ("convnextv2", op_cuda_calls_plain),
    "export: xmir::vit_attention's fake implementation one row short":
        ("dinov2", fake_one_row_short),
    "export: --format torch with one block's q and k rows swapped":
        ("dinov2", export_swaps_q_and_k),
}


def read_export(name, fault=contextlib.nullcontext):
    """chip_smoke.py phase 56 on ``name`` (a timm-layout .pt of random
    weights, 8 query PNGs): {"refused": whether a check raised, "by": the
    check's message}."""
    import chip_smoke as cs

    writers = {"dinov2": cs.write_vit_checkpoint, "convnextv2": cs.write_timm_checkpoint}
    with tempfile.TemporaryDirectory() as tmp:
        queries = cs.write_synthetic_covidx(str(Path(tmp) / "q"), n=8, size=256, seed=56)
        pt = str(Path(tmp) / f"{name}.pt")
        writers[name](pt, seed=57)
        try:
            with fault():
                cs.phase_export(Path(tmp), name, pt, queries)
        except Exception as e:  # noqa: BLE001  (any check or the trace refusing)
            return {"refused": True, "by": f"{type(e).__name__}: {str(e)[:400]}"}
    return {"refused": False}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", nargs="+", metavar="KERNEL",
                        help="the kernels to read and plant faults in (K1 K1' K2 ... K11), "
                             "ath: the ATH train step's checks, chestmir: the YOLOv5 "
                             "detector's, mesh: the sharded search's and the "
                             "data-parallel step's, tp: the tensor-parallel split's, or "
                             "export: chip_smoke.py phase 56's")
    only = parser.parse_args().only

    def want(*kernels):
        return only is None or any(k in only for k in kernels)

    if not torch.cuda.is_available():
        raise SystemExit("chip_faults: torch.cuda.is_available() is False; this script needs a "
                         "CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}", flush=True)
    ok = True

    def report(name, kernel, reading, want_inside, agrees=cb.agrees):
        """want_inside None: a reading recorded either way (PERF.md says which)."""
        nonlocal ok
        inside = agrees(reading)
        ok &= want_inside is None or inside == want_inside
        # how far the reading goes toward its bounds (above 1: past one of them)
        if "ulps" in reading:
            share = reading["ulps"] / cs.CONCEPT_GATHER_ULPS
        elif "mean_of_bound" in reading:
            share = max(reading["of_bound"], reading["mean_of_bound"])
        elif "mean_steps" in reading:
            share = max(reading["of_bound"], reading["mean_steps"] / cb.BF16_MEAN_STEPS)
        elif "of_bound" in reading:
            share = reading["of_bound"]
        else:
            share = float("nan")
        expected = ("recorded" if want_inside is None
                    else "expected inside" if want_inside else "expected outside")
        print(f"[faults] {name:60s} {kernel:9s} {'inside' if inside else 'OUTSIDE'} "
              f"({expected}; {share:.3g} of the bounds): {reading}", flush=True)

    use_sources(REAL_CSRC)
    if want("K2"):
        report("the kernel", "K2 bf16", read_attention(), True)
    for dtype in (torch.bfloat16, torch.float32) if want("K7", "K8") else ():
        e7, e8 = read_ln(dtype)
        report("the kernel", f"K7 {str(dtype)[6:]}", e7, True)
        report("the kernel", f"K8 {str(dtype)[6:]}", e8, True, ln_dense_agrees)
    for dtype in (torch.bfloat16, torch.float32) if want("K4", "K6") else ():
        e4, e6 = read_window(dtype)
        report("the kernel", f"K4 {str(dtype)[6:]}", e4, True)
        report("the kernel", f"K6 {str(dtype)[6:]}", e6, True)
    if want("K1"):
        report("the kernel", "K1", read_k1(), True)
        report("the kernel on +/-1 codes at D = 48 (chip_smoke.py phase 42)", "K1",
               read_hamming(), True)
        report("K1 at D = 48: two tied ids swapped in its result", "K1",
               read_hamming(lambda *a: swap_first_tie(*fused_topk_scores(*a))), False)
    if want("K1'"):
        report("the kernel", "K1'", read_select(), True)
    if want("chestmir"):
        for name, reading, inside in read_chestmir():
            report(name, "YOLOv5s", reading, inside, lambda r: r["of_bound"] <= 1.0)
    if want("mesh"):
        import chip_smoke as cs

        report("the sharded search on planted duplicates (phase 51)", "merge",
               read_shard_merge(), True, cs.shard_agrees)
        report("a merge that breaks ties toward the higher id", "merge",
               read_shard_merge(merge_ties_to_higher_ids), False, cs.shard_agrees)
        report("cli.train --use-mesh at world 2 against world 1 (CPU, gloo)", "DP",
               read_dp(), True, dp_agrees)
        for fault in DP_FAULTS:
            report(f"DP: {fault}", "DP", read_dp(fault), False, dp_agrees)
    if want("tp"):
        report("a narrow ViT split over (1, 2) against world 1 (CPU, gloo)", "TP", read_tp(),
               True, tp_agrees)
        for fault in TP_FAULTS:
            report(f"TP: {fault}", "TP", read_tp(fault), False, tp_agrees)
    if want("export"):
        for name in ("dinov2", "convnextv2"):
            report(f"phase 56 on {name} (cli.export, both formats)", "export", read_export(name),
                   True, lambda r: not r["refused"])
        for fault, (name, plant) in EXPORT_FAULTS.items():
            report(fault, "export", read_export(name, plant), False,
                   lambda r: not r["refused"])
    if want("ath"):
        report("cli.train_ath on the card against the CPU and float64 (phase 44)", "ath",
               read_ath(), True, lambda r: r["agree"])
        report("ATHNet's average pool padded by F.avg_pool2d", "ath", read_ath(True), False,
               lambda r: r["agree"])
    for dtype in (torch.bfloat16, torch.float32) if want("K9", "K11") else ():
        e9, e11 = read_tail(dtype)
        report("the kernel", f"K9 {str(dtype)[6:]}", e9, True)
        report("the kernel", f"K11 {str(dtype)[6:]}", e11, True)
    for dtype in (torch.bfloat16, torch.float32) if want("K3") else ():
        report("the kernel", f"K3 {str(dtype)[6:]}", read_backward(dtype), True, va.grad_agrees)
    for dtype in (torch.bfloat16, torch.float32) if want("K10") else ():
        report("the kernel", f"K10 {str(dtype)[6:]}", read_tail_bwd(dtype), True,
               tail_bwd_agrees)
    if want("K5"):
        for dtype in (torch.bfloat16, torch.float32):
            report("the kernel", f"K5 {str(dtype)[6:]}", read_k5(dtype), True, va.grad_agrees)
        report("K5's plain version with t left unrounded before its products", "K5 bf16",
               read_k5(torch.bfloat16, plain=k5_plain_t_unrounded), False, va.grad_agrees)
        for dtype in (torch.bfloat16, torch.float32):
            report("K5: dscale not divided by scale_g", f"K5 {str(dtype)[6:]}",
                   read_k5(dtype, kernel=k5_dscale_undivided), False, va.grad_agrees)
    if want("K10"):
        report("K10's plain version with dh1 left unrounded before its products", "K10 bf16",
               read_tail_bwd(torch.bfloat16, tail_plain_dh1_unrounded), False, va.grad_agrees)
    import chip_smoke as cs

    def report_slice(name, want_inside):
        nonlocal ok
        reading = read_train_slice()
        inside = reading["mean_apart_of_mean_moved"] <= cs.TRAIN_F32_MEAN_TOL
        ok &= inside == want_inside
        print(f"[faults] {name:60s} f32 slice {'inside' if inside else 'OUTSIDE'} (expected "
              f"{'inside' if want_inside else 'outside'}): {reading}", flush=True)

    if want("K3"):
        for dtype in (torch.bfloat16, torch.float32):
            report("the kernel at head width 72 (chip_smoke.py phase 38's shapes)",
                   f"K3 {str(dtype)[6:]}", cs.k3_hd72_reading(dtype), True, cs.k3_hd72_agrees)
        from xmir_tpu_torch.train import ConceptGather

        report("ConceptGather's backward (a fixed-order sum)", "gather", cs.concept_gather_check(),
               True, cs.concept_gather_agrees)
        fixed = ConceptGather.backward
        ConceptGather.backward = staticmethod(gather_backward_atomic)
        try:
            report("ConceptGather's backward by index_add_ (atomic adds in bf16)", "gather",
                   cs.concept_gather_check(), False, cs.concept_gather_agrees)
        finally:
            ConceptGather.backward = fixed
        report_slice("the kernel: cli.train dinov2 f32 against the plain versions", True)
        for name, fault in (("t left in f32", "t"), ("1 / z applied to the score tile", "z"),
                            ("c taken from p and dp rounded to bf16", "c")):
            report(f"K3's plain version with {name}", "K3 bf16",
                   read_backward(torch.bfloat16, backward_plain_with(fault)), False,
                   va.grad_agrees)
    if want("K4"):
        report("K4's plain version with the normalised k left unrounded", "K4 bf16",
               read_window(torch.bfloat16, plain_k_unrounded)[0], False)
    if want("K2"):
        report("K2: q-scale constant not rounded to bf16", "K2 bf16",
               read_attention(lambda s, dtype: s * va.LOG2E), False)
    if want("K8"):
        report("K8's plain version with the LN output left unrounded", "K8 bf16",
               read_ln(torch.bfloat16, plain_unrounded=True)[1], False)
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, (file, *subs)) in enumerate(SOURCE_FAULTS.items()):
            if not want(*re.findall(r"K\d+'?", name.split(":")[0])):
                continue
            directory = Path(tmp) / f"fault{i}"
            shutil.copytree(REAL_CSRC, directory)
            text = (directory / file).read_text()
            for old, new in zip(subs[0::2], subs[1::2]):
                if text.count(old) < 1:
                    raise SystemExit(f"chip_faults: {file} does not hold {old!r}")
                text = text.replace(old, new)  # every occurrence: the f32 and bf16 kernels
            (directory / file).write_text(text)
            use_sources(directory)
            if name.startswith("K2"):
                report(name, "K2 bf16", read_attention(), False)
                continue
            if name.startswith("K4, K6 f32 route"):  # the f32 route of K4 and K6 alone
                # phase 12's f32 readings must refuse it; bf16 is another body
                f4, f6 = read_window(torch.float32)
                report(name, "K4 float32", f4, False)
                report(name, "K6 float32", f6, False)
                continue
            if "f32 route" in name:  # the f32 routes of K3 and K5 alone
                # the TF32 shortcuts must be refused by every check; the two
                # products kept on IEEE FMAs by phase 17's hard rows (K3's
                # cases), their readings at phase 38's random shapes and K5's
                # recorded (PERF.md)
                kept = None if "IEEE FMAs" in name else False
                report(name, "K3 float32", read_backward(torch.float32), False, va.grad_agrees)
                report(name, "K3 f32 hd 72", cs.k3_hd72_reading(torch.float32), kept,
                       cs.k3_hd72_agrees)
                if "K5" in name:
                    report(name, "K5 float32", read_k5(torch.float32), kept, va.grad_agrees)
                continue
            if name.startswith("K3") and "hd 72" in name:  # phase 38's check must refuse it
                report(name, "K3 f32", cs.k3_hd72_reading(torch.float32), False,
                       cs.k3_hd72_agrees)
                continue
            if name.startswith("K3"):
                if "unordered" in name:  # refused if outside the bounds or not repeatable
                    reading = read_backward(torch.bfloat16)
                    reading["runs_bit_equal"] = backward_repeatable(torch.bfloat16)
                    report(name, "K3 bf16", reading, False,
                           lambda e: va.grad_agrees(e) and e["runs_bit_equal"])
                    continue
                report(name, "K3 bf16", read_backward(torch.bfloat16), False, va.grad_agrees)
                # faults of rounding, and of the bf16 kernel alone, do not show in f32
                if "rounded" not in name and "bf16 kernel" not in name:
                    report(name, "K3 float32", read_backward(torch.float32), False,
                           va.grad_agrees)
                if "scale missing" in name:
                    report_slice(name, False)
                continue
            if name.startswith("K1'"):
                report(name, "K1'", read_select(), False)
                continue
            if re.match(r"K1[ :]", name):
                report(name, "K1", read_k1(), False)
                if any(w in name for w in ("tie", "equal values", "order")):  # tie order
                    # as phase 42 reads it on +/-1 codes
                    report(name, "K1 +/-1", read_hamming(), False)
                continue
            if name.startswith("K5"):
                if "out of the fixed order" in name:  # refused if outside or not repeatable
                    reading = read_k5(torch.bfloat16)
                    reading["runs_bit_equal"] = k5_repeatable(torch.bfloat16)
                    report(name, "K5 bf16", reading, False,
                           lambda e: va.grad_agrees(e) and e["runs_bit_equal"])
                    continue
                # faults of the bf16 kernel alone do not show in f32
                dtypes = ((torch.bfloat16,) if "bf16 kernel" in name
                          else (torch.bfloat16, torch.float32))
                for dtype in dtypes:
                    report(name, f"K5 {str(dtype)[6:]}", read_k5(dtype), False, va.grad_agrees)
                continue
            if name.startswith("K9"):
                # faults of the bf16 kernels alone do not show in f32; the
                # LayerNorm is K9's alone
                dtypes = ((torch.bfloat16,) if "bf16 kernel" in name
                          else (torch.bfloat16, torch.float32))
                for dtype in dtypes:
                    e9, e11 = read_tail(dtype)
                    report(name, f"K9 {str(dtype)[6:]}", e9, False)
                    if "K11" in name:
                        report(name, f"K11 {str(dtype)[6:]}", e11, False)
                continue
            if name.startswith("K10"):
                # faults of the bf16 kernel alone do not show in f32
                dtypes = ((torch.bfloat16,) if "bf16 kernel" in name
                          else (torch.bfloat16, torch.float32))
                for dtype in dtypes:
                    report(name, f"K10 {str(dtype)[6:]}", read_tail_bwd(dtype), False,
                           tail_bwd_agrees)
                continue
            if name.startswith("K7 bf16 kernel"):
                report(name, "K7 bf16", read_ln(torch.bfloat16)[0], False)
                continue
            if name.startswith(("K4", "K6")):
                b4, b6 = read_window(torch.bfloat16)
                f4, f6 = read_window(torch.float32)
                # faults of rounding, and of the bf16 kernel alone, do not show in f32
                rounding = "rounded" in name or "bf16 kernel" in name
                if "K4" in name:
                    report(name, "K4 bf16", b4, False)
                    if not rounding:
                        report(name, "K4 float32", f4, False)
                if "K6" in name:
                    report(name, "K6 bf16", b6, False)
                    if not rounding:
                        report(name, "K6 float32", f6, False)
                continue
            if name.startswith("K8 bf16 kernel"):
                report(name, "K8 bf16", read_ln(torch.bfloat16)[1], False, ln_dense_agrees)
                continue
            e7, e8 = read_ln(torch.bfloat16)
            if "K7" in name:
                report(name, "K7 bf16", e7, False)
            report(name, "K8 bf16", e8, False, ln_dense_agrees)
            if "eps" in name or "erf" in name:  # faults of arithmetic, not of rounding
                report(name, "K8 float32", read_ln(torch.float32)[1], False)
        use_sources(REAL_CSRC)
    print(f"[faults] {'every bound sits between the kernels and the faults' if ok else 'FAILED'}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
