"""Drives the PyTorch port (xmir_tpu_torch) once on an NVIDIA card and checks it.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) on any failure:
  1. device  the card's name and power limit (nvidia-smi)
  2. build   the CUDA kernels, from the sources in this checkout (one nvcc per
             source, all started together)
  3. kernel  K1 (csrc/topk.cu, the score producer csrc/topk_scores.cuh) and,
             above k = 32, K1' (its select route, csrc/topk_select.cu)
             through fused_topk_scores against their plain
             PyTorch version on the card: f32 and bf16, the slice's own shape
             (64 x 256 x 1024, k 10) and k in {1, 10, 32, 33, 128, 129, 1024},
             Q in {1, 5, 16, 17, ..., 300}, ragged N, N = 100,000 at Q = 16
             (131 splits: the merge's lane wrap), D in {8, 32, 64, 96, 1024}
             and D the copy engine cannot take (97, 100: padded), valid rows
             < k; bit-equal on small-integer inputs with ties inside a tile,
             across tile, split and lane-wrap edges; within 1e-5 (f32) / 1e-2
             (bf16) on random ones; two runs bit-equal; f32 rows of full
             mantissas within topk_kernels.f32_score_error's 3xTF32 bound;
             all four metrics through fused_topk
  4. slice   the ingest -> query CLIs with DenseNet121 at full width (224
             crop, 1024-d) on COVIDx-format PNGs, through K1; its hits
             against the plain top-k on the same device embeddings, and the
             built gallery against queries whose scores spread
  5. serving K1 over 100,000 x 1024 unit rows at Q = 1024 with k in {10,
             100, 1000} (k = 100 and 1000 take the select route, K1') and at
             Q in {1, 16} with k = 10 (a single query's and a small batch's
             latency), f32 and bf16: kernel and plain version by CUDA events
             in turns, the device time (device_ms: CUDA events around calls
             enqueued behind a device-side spin) and its split by kernel
             (torch.profiler, reported only where the trace's records hold
             90% of the device time), the yardsticks torch.mm alone and
             torch.mm + torch.topk by device time (timed here, used nowhere
             in the port), the wall time of one call with the host at Q <=
             16; then K1' at Q = 1024, k = 2048 and at Q = 64, k = N, f32 and
             bf16, with K1 at k = 10 in the same turns, the same readings
             (the split: the score producer, the select and sort), one
             call's memory, and the yardsticks torch.mm, torch.mm +
             torch.topk and torch.sort of the scores by device time
  6. kernel  K9 and K11 (csrc/convnext_block.cu) against their plain versions,
             f32 and bf16, random LN / GRN / biases: ConvNeXtV2-Base's four
             stage shapes at 384 px (B = 2), ragged rows (7x7, 25x25), and 64
             / 144 / 576 rows at B = 3 (the bf16 kernels' 64-row units, two a
             block, each of one image; 144 rows end in a ragged unit); within
             the bounds of
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
             first), beside the dwconv alone and the block's two products
             alone (torch.matmul, the dtype in and out); ConvNeXtV2-Base bf16
             (weights and input) batch 32 at 384 px with the kernels, with the
             tail's plain version, and on the plain path, the kernels'
             embeddings held to both; CUDA events, in turns; a torch.profiler
             breakdown of the bf16 forward (device time, kernels, time to
             enqueue, K9's and the dwconv's shares)
  9. kernel  K2 (csrc/vit_attn.cu), K7 and K8 (csrc/ln_dense.cu) against their
             plain versions, f32 and bf16: the DINOv2 shape (N = 1370, hd = 64,
             C = 768, 12 heads) at B = 2; ragged and tiny N (1, 7, 197, 257,
             729, 1024); the edges of K2's 128-row tiles (127, 128, 129,
             255); hd in {16, 32, 64, 72, 128} for K2 and {32, 64, 128} for
             K7 (C = 128, 256, 384, 768); K8 with and without GELU and bias,
             also at the edges of bf16 K8's 64-row units (R = 1, 63, 64, 65)
             and at M with a partial 256-column tile (130, 514), and over a
             GELU tail of pre-activations from -12 to 12; rows whose every
             score is very negative and rows with one dominant score; within
             the bounds of ops/vit_attn.py::agreement (K2: with the flip
             allowance of each row's dominant term, flip_allowance) and
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
             nowhere in the port; the SDPA backend the default dispatch picks,
             pinned once outside the timed windows and named; CUDA events over
             windows of 20 calls and the device time, device_ms, beside the
             share of it torch.profiler's records hold); K2 also at B = 8, with the row statistics, and
             the host's enqueue time of a K2 and a library call; K7's and
             K8's device time beside their products alone (torch.matmul on the
             normalised rows) and, for K8, the unfused sequence a block runs
             without it (the port's LayerNorm, fc1 through _dense,
             adaptive_gelu), yardsticks used nowhere in the port, and K8's
             split by kernel (ln_rows, ln_gemm_wg) where torch.profiler's
             records hold 90% of its device time; DINOv2 ViT-B/14 bf16
             (weights and input) batch 16 at 518 px with the kernels, with K8
             too (XMIR_FUSED_LN_MLP=1: bf16 K8 is ln_rows and the wgmma
             product whose warpgroups take turns), with the kernels' plain
             versions, and on the eager path, the kernels' embeddings held to
             the last two; CUDA events, in turns, and the first two by device
             time (device_ms) in turns; a torch.profiler breakdown of the bf16
             forward (K2's and K7's shares)
 12. kernel  K4 and K6 (csrc/window_attn.cu) against their plain versions, f32
             and bf16: every SwinV2-Base shape at 384 px (stages 1-4, shifted
             and unshifted, B = 16), ragged N (140, 77, 1), groups that wrap,
             groups of 3 and 5 images (bf16 K4 takes two images a block),
             every logit scale at its clamp of 100 with a -100 mask that
             leaves rows few live keys, rows of tiny norm; within the bounds
             of ops/vit_attn.py::window_agreement; two runs bit-equal
 13. kernel  K1' (csrc/topk_select.cu) against the plain top-k: bit-equal on
             integer inputs for k in {1025, 2048, 4096, N} at N in {4096,
             100,000}, f32 and bf16, and its first 1024 entries against a
             call at k = 1024; on random rows its first 10, 128 and 1024
             entries equal to the calls at those k (K1's fused route and its
             own) bit for bit
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
             here, used nowhere in the port; the SDPA backend the default
             dispatch picks, named and pinned once outside the timed windows;
             CUDA events over windows of 20 calls and the device time of K4,
             K6 and the library call, device_ms), with the time of the fold
             and unfold copies around K4; SwinV2-Base bf16 (weights and
             input) batch 16 at 384 px
             with K4, with K6, with the kernels' plain versions and on the
             eager path; CUDA events, in turns
 17. kernel  K3 (csrc/vit_attn_bwd.cu) against its plain version through the
             autograd Function around K2 / K3, f32 and bf16: (BH, N, hd) in
             {(24, 1370, 64), (4, 729, 72), (6, 64, 32), (2, 1, 64),
             (3, 137, 128), (140, 200, 64), (133, 129, 32)} (the last two:
             more (head, 128-key) units than SMs, a half-dead last unit),
             rows of negative scores and rows with few
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
             the port; its backend, the one the default dispatch picks for the
             forward, named and pinned once outside the timed windows; CUDA
             events and device time, with torch.profiler's share of K3's);
             the bf16 DINOv2 train step at batch 8 with the
             kernels, with their plain versions and on the eager path: img/s,
             peak memory, forward / backward / optimiser shares, and the
             device time by kernel (torch.profiler), K3's share of it
 21. kernel  K10 (csrc/convnext_block_bwd.cu) against tail_backward_reference,
             f32 and bf16: ConvNeXtV2-Base's four stage shapes at 384 px
             (B = 2), 49 rows and 1 row at C = 96, 144 rows at B = 3; within
             ops/vit_attn.py::grad_agreement's bounds (the run's dtype, the
             floors of ops/convnext_block.py::tail_grad_floors); two runs
             bit-equal; bf16 pass 2's ab bit-equal to pass 1's
             (tail_bwd_recomputes_ab); the wrapper's workspace equal to the C
             plan's; the fused block's eleven gradients (K9 forward, K10
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
             training gate's table, by CUDA events and by device time (with
             torch.profiler's share of K10's); the
             bf16 ConvNeXtV2-Base train step at batch 16, 384 px with the
             kernels, their plain versions and on the eager path, and a
             torch.profiler breakdown of the step (K10's share)
 24. slice   main-path step 4 on DenseNet121 at full width (224 px, f32):
             cli.test --save-dir, cli.compute_saliency --results (2 queries,
             top 5, 2401 masks), cli.evaluate_saliency --saliency-dir (K1
             once) and inline: maps finite and nonnegative, AUCs in [0, 1],
             the saved maps' AUCs equal the inline ones; a narrow model's
             maps and AUCs on the card against the CPU; SBSM images/s and
             insertion / deletion pair-evals/s
 25. kernel  K5 (csrc/window_attn_bwd.cu) against biased_attention_bwd_plain,
             f32 and bf16, cosine on and off: the six SwinV2-Base (stage,
             shifted) shapes at B = 2, N = 64 at hd = 8, and one group over 64
             folded rows; logit scales up to the clamp of 100 and -100 shift
             masks; within ops/vit_attn.py::biased_grad_agreement's bounds;
             two runs bit-equal, dbias and dscale included; the Function's
             five gradients (K4 forward, K5 backward) against f32 autograd
             through biased_attention_reference
 26. slice   cli.train with SwinV2-Base at full width (432 decode, 384 crop, 24
             blocks, --bf16 -p 2 -k 4) and a timm-layout --resume with random
             nonzero LN, biases and logit_scale (one head above the clamp): K4
             and K5 in every block of every step, K6 never, also under
             XMIR_SWIN_KERNEL=v1 (the same losses); the f32 evaluation eager;
             parameters moved, none of the backbone's under --freeze-backbone
             (K5 never); --resume bit-exact; three f32 steps under
             XMIR_FUSED_ATTN=1 against the plain versions
 27. rates   K5 at the six SwinV2-Base shapes at B = 8 (a train step's 24
             calls), bf16 and f32, against its plain version and one
             scaled_dot_product_attention backward with a float mask that
             needs a gradient (timed here, used nowhere in the port; the
             SDPA backend the default dispatch picks, named and pinned once
             outside the timed windows; CUDA events, and the device time of
             both, device_ms)
 28. rates   the bf16 SwinV2-Base train step at batch 8, 384 px with the
             kernels, their plain versions and on the eager path: img/s, peak
             memory, forward / backward / optimiser, the host's enqueue time
             beside the device time by kernel (torch.profiler), K4's and K5's
             shares of it
 29. slice   the other explainers of main-path step 4 through both saliency
             CLIs: SimAtt and SimCAM on DenseNet121 (224 px, f32), attention
             rollout on DINOv2 ViT-B/14 (518 px); cli.debug_insdel on one pair
             (K1 once for each index search); maps finite and nonnegative,
             AUCs in [0, 1]; narrow models' maps and AUCs on the card against
             the CPU; maps/s
 30. slice   python -m xmir_tpu_torch.demo_end_to_end --device cuda: train ->
             test -> ingest -> query -> evaluate_saliency; its summary.json
 31. slice   NIH ChestX-ray14 on a generated tree (24 + 16 .npy files named
             Chest_X-ray_<URL-encoded A|B|C>_<i>.npy: three pathologies a
             file, each of the 14 in 4 to 6 training files, the alias
             "pleural_thickening" in every other one): cli.train --model
             nih_dinov2 --dataset nih --loss-name dual_branch --bf16 -p 2 -k 4
             at full width (518 px, 12 blocks, 1370 tokens; the multi-label
             sampler) from a timm-layout --resume: K7 = K2 = 12 x (steps +
             evaluation batches), K3 = 12 x steps; contrastive and asl in the
             metrics log; every tensor moved; --resume bit-exact; three f32
             steps with the kernels against their plain versions; cli.test
             --save-dir (the multi-label metrics against numpy's from the
             artifact), cli.ingest -> cli.query on the trained checkpoint (a
             256-d gallery: K1 at D = 256, bit-equal to its plain version on
             integer inputs); cli.train --model nih_convnextv2 for one epoch
             (K9 + K10 in the blocks the training gate fuses)
 32. slice   convnextv2_dino_distill at full width (ConvNeXtV2-Base student
             at 384 px, ViT-B/14 teacher at 518, seeded weights): three bf16
             make_distill_train_step steps at batch 16 (K9 + K10 as in
             ConvNeXtV2 training, K7 = K2 = 12 a step, K3 = 0; the teacher's
             tensors bit-equal, the student's all moved, distill in [0, 2]);
             one step of convnextv2_raddino_distill; cli.train --model
             convnextv2_dino_distill --bf16 for one epoch (the embedding step:
             K7 = K2 = 0, the teacher's tensors at their init); cli.ingest ->
             cli.query with the student (K9, K1)
 33. rates   the bf16 dual-branch step (nih_dinov2, batch 8, 518 px) and the
             bf16 distillation step (batch 16): CUDA events and device time
             (device_ms, where the host can enqueue a step within its spin),
             the host's enqueue time, peak memory; the distillation step split
             into the teacher's forward, the student's forward + backward and
             the optimiser (by events, and by torch.profiler's records where
             they hold 90% of the step)
 34. kernel  K7 at SigLIP SO400M's C = 1152, 16 heads of 72 (3C = 3456
             columns: a half-full last 256-column tile, tiles straddling q / k
             / v and heads): N = 1024 at B = 16, N = 729 at B = 4, N = 64 at
             B = 8 (the text tower), ragged N in {1, 63, 65, 197}, and at
             BiomedCLIP's C = 768, N = 197; the last tile's columns and each
             head's boundary lanes on their own; K2 at (BH, N, hd) = (256,
             1024, 72), (64, 729, 72), (128, 64, 72); f32 and bf16, within
             ld.agreement / k2_agreement, two runs bit-equal; build.log holds
             no C75xx (a serialised wgmma product) for ln_dense.cu or
             vit_attn.cu, and every other source's C75xx lines are printed
 35. slice   cli.ingest -> cli.query --top-k 10 with MedSigLIP-448 at full
             width (448 px, 1024 tokens, 27 layers, C = 1152, a 512-d
             projection; --resume of a seeded HF SiglipVisionModel .pt with
             random nonzero LN / biases) and ConceptCLIP-384 (729 tokens,
             seeded, 1152-d) under XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1, with
             XMIR_FUSED_LN_QKV72 unset (K2 = 27 x batches, K7 = 0) and set to 1
             (K7 = K2 = 27 x batches), K1 once; the hits against the plain
             top-k, the query embeddings against the same model with the
             kernels' plain versions and on the eager path; K1 bit-equal to
             its plain version at D = 512 and 1152 on integer inputs
 36. slice   cli.test --model biomedclip --save-dir at full width (224 px,
             12 + 12 layers, 768-d) from a seeded open_clip-layout .pt and a
             generated vocab.txt under the same flags (K7 = K2 = 12 x image
             batches, the text tower none): the zero-shot accuracy, macro P /
             R, R@1 and mAP recomputed with numpy from the artifact;
             cli.zeroshot --model medsiglip --embedding-dim 1152
             --dual-checkpoint (a seeded text tower, 27 layers, C = 1152,
             seq-len 64, its vocabulary as large as the generated vocab.txt)
             with XMIR_FUSED_LN_QKV72 unset and set: K2 = 27 x (image
             batches + 1), K7 = 0 / the same; accuracy and confusion matrix
             recomputed from the printed predictions
 37. rates   K7 at the SigLIP shape (B = 16, N = 1024, C = 1152, H = 16)
             against its plain version and its product alone (torch.matmul,
             (16384 x 1152) . (1152 x 3456)); K2 at (256, 1024, 72) against
             its plain version and SDPA (the default dispatch's backend,
             pinned once outside the timed windows); bf16, CUDA events in
             turns and device_ms; the bf16 MedSigLIP-448 embed at batch 16
             with K2, with K7 + K2 (XMIR_FUSED_LN_QKV72=1) and eager, and
             BiomedCLIP's image tower at batch 64 (224 px) with K7 + K2 and
             eager: events in turns, device_ms where a forward's launches
             fit the launch queue, peak memory, a torch.profiler breakdown
``--train-only`` builds and runs phases 17 to 23, 25 to 28 and 31 to 33
alone (no result line).
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
import io
import json
import os
import statistics
import subprocess
import tempfile
import time
from pathlib import Path
from urllib.parse import quote

import numpy as np
import torch
import torch.nn.functional as F

from xmir_tpu_torch.cli import common, ingest, query
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.cli import train as train_cli
from xmir_tpu_torch.cli import zeroshot as zeroshot_cli
from xmir_tpu_torch.data.datasets import NIH_RETRIEVAL_PATHOLOGIES
from xmir_tpu_torch.data.pipeline import embed_dataset
from xmir_tpu_torch.data.synthetic import write_synthetic_covidx
from xmir_tpu_torch.index import ShardedGalleryIndex
from xmir_tpu_torch.models import convnext as convnext_model
from xmir_tpu_torch.models import siglip as siglip_model
from xmir_tpu_torch.models import swin as swin_model
from xmir_tpu_torch.models import vit as vit_model
from xmir_tpu_torch.models.activations import adaptive_gelu
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
    F32_SCORE_C,
    ROUTE_FUSED,
    f32_score_error,
    fused_topk_scores,
    launch_plan,
    select_topk_scores,
    topk_scores_reference,
)
from xmir_tpu_torch.train import (
    TrainState,
    build_optimizer,
    make_distill_train_step,
    make_dual_branch_train_step,
    make_embed_fn,
    make_embedding_train_step,
)
from xmir_tpu_torch.utils.checkpoint import checkpoint_name, load_checkpoint

REPO = Path(__file__).resolve().parent
KERNELS = {
    "K1": {"name": "fused_topk_scores", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/topk.cu",
           "sources": ["xmir_tpu_torch/csrc/topk.cu", "xmir_tpu_torch/csrc/topk_scores.cuh"],
           "bodies": "the fused route, k <= 32: score_tiles<T, wgs, false> (wgmma: bf16, or f32 "
                     "as 3xTF32; selection from the accumulators) + topk_merge",
           "replaces": "xmir_tpu/ops/topk_pallas.py:243"},
    "K1'": {"name": "select_topk_scores", "route": "cuda",
            "source": "xmir_tpu_torch/csrc/topk_select.cu",
            "sources": ["xmir_tpu_torch/csrc/topk_select.cu",
                        "xmir_tpu_torch/csrc/topk_scores.cuh"],
            "bodies": "the select route, k > 32: score_tiles<T, wgs, true> (K1's score "
                      "producer, words) + select_sort (radix select, stable LSD sort); k = N: "
                      "rank_counts, rank_offsets, rank_scatter (a stable LSD sort over many "
                      "blocks a query)",
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
    "K5": {"name": "biased_attention_bwd", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/window_attn_bwd.cu",
           "replaces": "xmir_tpu/ops/vit_attn_pallas.py:486"},
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
# type (f32 outside the tensor cores; TF32 on them) and bytes per second of
# device memory
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tfloat32": 495e12}
PEAK_BYTES = 3.35e12


def bound(ops, nbytes, dtype_name):
    """(least ms the card could take, which of the two bounds it): each input
    read once and each output written once over the memory rate, against the
    operations over the peak rate of their type."""
    by_ops, by_bytes = ops / PEAK_OPS[dtype_name] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


# SDPA backends the library yardsticks try, in order: the one the dispatcher
# picks by default (its output bit-equal to the default call's) is pinned for
# every shape, so that each run times the same library kernel
SDPA_ORDER = ("CUDNN_ATTENTION", "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "MATH")


@contextlib.contextmanager
def sdpa_pinned(name):
    """SDPA restricted to the backend ``name`` (an SDPBackend member) for
    the duration; enter it outside a timed region, since entering it costs
    host time on every call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([getattr(SDPBackend, name)]):
        yield


def under_backend(name, fn):
    """fn() with SDPA restricted to the backend ``name``."""
    with sdpa_pinned(name):
        return fn()


def sdpa_backend(call):
    """The backend the dispatcher picks for ``call()`` (a tensor): the first
    of SDPA_ORDER whose result equals the default call's bit for bit, else
    (not identified) the first under which it runs."""
    want, first = call(), None
    for name in SDPA_ORDER:
        try:
            got = under_backend(name, call)
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        first = first or name
        if torch.equal(got, want):
            return name
    if first is None:
        raise RuntimeError("no SDPA backend runs this call")
    return first


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
    plan = launch_plan(q_n, n, k, torch.cuda.get_device_properties(0).multi_processor_count, d,
                       dtype)
    rows, nt = plan.rows_per_split, plan.tile_rows
    # duplicates of one row inside a tile, across a tile edge inside a split,
    # on both sides of split boundaries, across the merge's lane wrap (split
    # 31 | 32, the first split a lane holds as its second head), across the
    # full ranking's first chunk edge (4096 entries) and at the ragged end:
    # ties the kernels must order by row
    dup = [r for r in (3, 5, nt - 1, nt, rows - 1, rows, 2 * rows - 1, 2 * rows, 32 * rows - 1,
                       32 * rows, 4095, 4096, n - 1) if r < n]
    src = min(3, n - 1)
    g[dup] = g[src].clone()
    q[0] = g[src]
    return q.to("cuda", dtype), g.to("cuda", dtype)


def _random_inputs(gen, q_n, n, d, dtype):
    q = l2_normalize(torch.randn((q_n, d), generator=gen))
    g = l2_normalize(torch.randn((n, d), generator=gen))
    return q.to("cuda", dtype), g.to("cuda", dtype)


SLICE_SHAPE = (64, 256, 1024, 10)  # what the slice's query hands K1: Q, N, D, k


# f32 rows of full mantissas (random normal, not unit): scores against the
# float64 score within topk_kernels.f32_score_error's bound, which 3xTF32
# meets and 2xTF32 / 1xTF32 do not (chip_faults.py)
FULL_MANTISSA_SHAPES = ((64, 4099, 1024, 10), (256, 20_000, 1024, 10), (16, 20_000, 96, 128),
                        (70, 4099, 97, 10))


def phase_kernel():
    gen = torch.Generator().manual_seed(0)
    # the slice's shape; tiny and ragged N; k at 1, the fused route's edge
    # (32, 33) and the select route (128, 129, 1024);
    # Q of 1 and 16 (up to a split per SM: 131 splits, the merge's lane wrap)
    # and above 64; D of 32, 96, 1024 and D the copy engine cannot take (97,
    # 100: padded)
    shapes = [SLICE_SHAPE, (70, 4099, 32, 1), (70, 4099, 96, 10), (33, 4099, 1024, 128),
              (17, 4099, 96, 129), (20, 4099, 32, 1024), (129, 4099, 1024, 10),
              (1, 4099, 1024, 10), (16, 100_000, 1024, 10), (200, 4099, 97, 10),
              (300, 4099, 64, 32), (70, 4099, 100, 33), (5, 1, 8, 1)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[kernel] the slice's shape {SLICE_SHAPE} runs the plan "
        f"{launch_plan(*SLICE_SHAPE[:2], SLICE_SHAPE[3], sms, SLICE_SHAPE[2], torch.float32)}")
    max_err = 0.0
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        for q_n, n, d, k in shapes:
            for valid in sorted({n, k // 2 + 1}):
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
                v2, i2 = fused_topk_scores(q, g, bias, k)
                torch.cuda.synchronize()
                check(torch.equal(v, v2) and torch.equal(i, i2),
                      f"two runs differ: {dtype} Q={q_n} N={n} D={d} k={k}")
                rv, ri = topk_scores_reference(q, g, bias, min(k + 1, n))
                err, _, _ = compare(v, i, rv[:, :k], ri[:, :k], atol, rv)
                max_err = max(max_err, err)
            plan = launch_plan(q_n, n, k, sms, d, dtype)
            log(f"[kernel] {str(dtype)[6:]:8s} Q={q_n:4d} N={n} D={d:4d} k={k:4d}: "
                f"integer bit-equal, random within {atol}, two runs bit-equal (max err so far "
                f"{max_err:.3g}); route {'fused' if plan.route == ROUTE_FUSED else 'select'}, "
                f"{plan.wgs} consumer warpgroup(s), {plan.n_splits} splits of "
                f"{plan.rows_per_split} rows, depth {plan.depth}")
    for q_n, n, d, k in FULL_MANTISSA_SHAPES:
        q = torch.randn((q_n, d), generator=gen).cuda()
        g = torch.randn((n, d), generator=gen).cuda()
        bias = torch.randn(n, generator=gen).cuda()
        v, i = fused_topk_scores(q, g, bias, k)
        reading = f32_score_error(q, g, bias, v, i)
        check(reading["of_bound"] <= 1, f"f32 scores outside the 3xTF32 bound at Q={q_n} N={n} "
                                        f"D={d} k={k}: {reading}")
        log(f"[kernel] float32 full-mantissa rows Q={q_n} N={n} D={d} k={k}: "
            f"{reading['of_bound']:.3g} of the score bound (F32_SCORE_C = {F32_SCORE_C:g}), "
            f"max abs err {reading['max_abs_err']:.3g}")
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
            "K3": va.vit_attention_bwd, "K4": va.biased_attention_fused,
            "K5": va.biased_attention_bwd, "K6": wa.window_attention_fused,
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


# the serving gallery (the JAX bench.py shape): N rows of D, unit rows
SERVING_N, SERVING_D = 100_000, 1024
# (Q, k) of the serving phase: a batch of 1024 at k = 10, 100 and 1000, and a
# single query and a small batch at k = 10 (a clinician's query is one image)
SERVING_SHAPES = ((1024, 10), (1024, 100), (1024, 1000), (1, 10), (16, 10))


def k1_bound(q_n, n, d, k, dtype):
    """K1 / K1''s bound under its arithmetic, beside the FMA bound: bytes are
    q and g once, the bias and the (Q, k) result; operations 2 Q N D, on the
    tensor cores in bf16, as 3 TF32 products (3xTF32) in f32."""
    size = torch.empty((), dtype=dtype).element_size()
    nbytes = (q_n + n) * d * size + n * 4 + q_n * k * 8
    if dtype == torch.bfloat16:
        ms, by = bound(2 * q_n * n * d, nbytes, "bfloat16")
        return {"bound_ms": ms, "bound_by": by, "arithmetic": "bf16 wgmma"}
    ms, by = bound(3 * 2 * q_n * n * d, nbytes, "tfloat32")
    fma_ms, fma_by = bound(2 * q_n * n * d, nbytes, "float32")
    return {"bound_ms": ms, "bound_by": by, "arithmetic": "3xTF32 wgmma",
            "fma_bound_ms": fma_ms, "fma_bound_by": fma_by}


def phase_serving():
    """K1 at every (Q, k) of SERVING_SHAPES over the serving gallery, f32 and
    bf16: checked against the plain version, then CUDA events in turns with
    it, device time by kernel (torch.profiler), the yardsticks' device time
    (the product alone, torch.mm, and torch.topk of it; used nowhere in the
    port) and, for Q <= 16, the wall time of one call with the host."""
    n, d = SERVING_N, SERVING_D
    gen = torch.Generator().manual_seed(2)
    q = l2_normalize(torch.randn((1024, d), generator=gen)).cuda()
    g = l2_normalize(torch.randn((n, d), generator=gen)).cuda()
    bias = torch.zeros(n, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        name, gg = str(dtype)[6:], g.to(dtype)
        for q_n, k in SERVING_SHAPES:
            qq = q[:q_n].to(dtype)

            def kern():
                return fused_topk_scores(qq, gg, bias, k)

            def plain():
                return topk_scores_reference(qq, gg, bias, k)

            v, i = kern()
            rv, ri = topk_scores_reference(qq, gg, bias, k + 1)
            torch.cuda.synchronize()
            err, checked, total = compare(v, i, rv[:, :k], ri[:, :k], atol, rv)
            del v, i, rv, ri
            ms, runs = _in_turns({"kernel": kern, "plain": plain}, rounds=4, reps=3)
            dev_ms = device_ms(kern)
            split = kernel_split(kern, dev_ms)
            yard = {"mm": device_ms(lambda: torch.mm(qq, gg.T)),
                    "mm+topk": device_ms(lambda: torch.topk(torch.mm(qq, gg.T) + bias, k,
                                                            dim=1).values)}
            key = f"{name} Q={q_n} k={k}"
            plan = launch_plan(q_n, n, k, sms, d, dtype)
            out[key] = dict(k1_bound(q_n, n, d, k, dtype), ms=ms["kernel"],
                            plain_ms=ms["plain"], device_ms=dev_ms, device_by_kernel=split,
                            yardstick_device_ms=yard, max_abs_err=err,
                            route="fused (K1)" if plan.route == ROUTE_FUSED else "select (K1')",
                            plan=plan._asdict())
            if q_n <= 16:
                out[key]["wall_ms"] = wall_ms(kern)
            log(f"[serving] {key} N={n} D={d}, {out[key]['route']} route: device "
                f"{dev_ms:.4f} ms ({2 * q_n * n * d / dev_ms / 1e9:.1f} TFLOP/s; bound "
                f"{out[key]['bound_ms']:.4f} ms by {out[key]['bound_by']}"
                + (f", FMA bound {out[key]['fma_bound_ms']:.4f}" if "fma_bound_ms" in out[key]
                   else "") + f"), by kernel {split_text(split)}; "
                f"events {ms['kernel']:.4f} ms ({q_n / ms['kernel'] * 1e3:.0f} QPS), plain "
                f"{ms['plain']:.3f} ms; yardsticks by device time: torch.mm "
                f"{yard['mm']:.4f} ms, torch.mm + torch.topk {yard['mm+topk']:.4f} ms"
                + (f"; wall per call with the host {out[key]['wall_ms']:.4f} ms"
                   if "wall_ms" in out[key] else "")
                + f"; max err {err:.3g}, {checked}/{total} ids checked equal; plan "
                f"{out[key]['plan']}; kernel runs {[round(t, 4) for t in runs['kernel']]}, "
                f"plain runs {[round(t, 3) for t in runs['plain']]}")
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
        (3, 8, 128, "64 rows: one bf16 unit, B 3"),
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
            # K9's own share and a GEMM floor on this card: the dwconv alone
            # and the two products alone (torch.matmul, the dtype in and out)
            y2, w1t, w2t = y.reshape(-1, c), a["w1"].t(), a["w2"].t()
            z2 = torch.ones((y2.shape[0], 4 * c), dtype=dtype, device="cuda")
            ms, _ = _in_turns({
                "K9": lambda: cb.convnext_block_fused(x, **a),
                "K9 plain": lambda: plain_block(x, **a),
                "K11": lambda: cb.convnext_mlp_grn_fused(y, xr, *t),
                "K11 plain": lambda: cb.mlp_grn_reference(y, xr, *t),
                "dwconv": lambda: cb.dwconv(x, a["dw_weight"], a["dw_bias"]),
                "pw1 matmul": lambda: torch.matmul(y2, w1t),
                "pw2 matmul": lambda: torch.matmul(z2, w2t),
            })
            flop = 4 * 32 * hw * hw * c * 4 * c
            rc, size = 32 * hw * hw * c, x.element_size()
            weights = 8 * c * c * size + 10 * c * 4  # pw1, pw2; b1, gamma, beta, b2
            work = {  # K9: the block with its dwconv and LN; K11 reads y and x
                "K9": (flop + 2 * 49 * rc, 2 * rc * size + weights + (49 + 3) * c * 4),
                "K11": (flop, 3 * rc * size + weights)}
            alone = {k: ms[k] for k in ("dwconv", "pw1 matmul", "pw2 matmul")}
            for k in ("K9", "K11"):
                bound_ms, bound_by = bound(*work[k], name)
                out[k][f"{name} {shape}"] = {"ms": ms[k], "plain_ms": ms[f"{k} plain"],
                                            "bound_ms": bound_ms, "bound_by": bound_by,
                                            "alone_ms": alone}
            log(f"[rates] {name:8s} {shape}: K9 {ms['K9']:.3f} ms (block incl. dwconv; "
                f"{flop / ms['K9'] / 1e9:.1f} TFLOP/s of GEMM) vs plain {ms['K9 plain']:.3f} ms;"
                f" K11 {ms['K11']:.3f} ms vs plain {ms['K11 plain']:.3f} ms; alone: dwconv "
                f"{alone['dwconv']:.3f} ms, pw1 {alone['pw1 matmul']:.3f} ms, pw2 "
                f"{alone['pw2 matmul']:.3f} ms (torch.matmul); agreement K9 {e9}, K11 {e11}")
            del x, a, y, xr, t, y2, z2
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
        out["profile"] = profile_forward(
            "ConvNeXtV2-Base bf16 batch 32 @384 with K9", embed, x,
            {"K9": K9_BF16_KERNELS, "dwconv": ("conv2d",)})
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


def k2_agreement(q, k, v, sc):
    """K2's bound on these inputs: ``va.agreement`` with the flip allowance
    of each row's dominant term."""
    allowance = va.flip_allowance(q, k, v, sc)
    return lambda out, ref: va.agreement(out, ref, allowance)


def phase_kernel_vit():
    gen = torch.Generator().manual_seed(8)
    err = {key: {} for key in ("K2", "K7", "K8")}
    attn_cases = [(2 * VIT["heads"], VIT["n"], 64, "DINOv2, B 2")] + [
        (3, n, 64, "ragged N") for n in (1, 7, 197, 257, 729, 1024)] + [
        (2, n, 64, "128-row tile edges") for n in (127, 128, 129, 255)] + [
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
                ref = va.attention_plain(q, k, v, hd ** -0.5)
                e = vit_err(out, ref, k2_agreement(q, k, v, hd ** -0.5),
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
            e = vit_err(out, va.attention_plain(q, k, v, 0.125), k2_agreement(q, k, v, 0.125),
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
                e8 = k8_err(x.reshape(b * n, c), lns, lnb, w1, b1, name)
                _worst(err["K8"].setdefault(name, {}), e8)
                log(f"[kernel] K7/K8 {name:8s} B={b} N={n:4d} C={c:3d} H={heads:2d} ({what}): "
                    f"K7 {e7}; K8 (GELU and bias on / off) {e8}; both twice bit-equal")
            for r_, m, what in K8_CASES:
                x, lns, lnb, w1, b1 = _ln_inputs(gen, 1, r_, VIT["c"], m, dtype)
                e8 = k8_err(x[0], lns, lnb, w1, b1, name)
                _worst(err["K8"][name], e8)
                log(f"[kernel] K8 {name:8s} R={r_:5d} C={VIT['c']} M={m:4d} ({what}): {e8}; "
                    "twice bit-equal")
            # the GELU's tail: pre-activations over [-12, 12] (the bias), finite
            x, lns, lnb, w1, _ = _ln_inputs(gen, 1, 300, VIT["c"], 4 * VIT["c"], dtype)
            w1 = w1 * 0.02
            tail = torch.linspace(-12, 12, 4 * VIT["c"], device="cuda")
            o = ld.ln_dense_fused(x[0], lns, lnb, w1, tail, 1e-6, "gelu")
            check(torch.isfinite(o.float()).all(), f"K8 {name}: non-finite GELU tail")
            e8 = vit_err(o, ld.ln_dense_reference(x[0], lns, lnb, w1, tail, 1e-6, "gelu"),
                         ld.agreement, f"K8 {name} GELU tail")
            _worst(err["K8"][name], e8)
            log(f"[kernel] K8 {name:8s} GELU tail, pre-activations over [-12, 12]: {e8}")
    return err


# K8 alone: the edges of its 64-row units and M that are not multiples of its
# 256-column tiles (130: one partial tile; 514: two whole and one of 2)
K8_CASES = [(r_, 4 * VIT["c"], "64-row unit edges") for r_ in (1, 63, 64, 65)] + [
    (300, m, "partial column tile") for m in (130, 514)]


def k8_err(rows, lns, lnb, w1, b1, name):
    """K8 on (R, C) rows against ln_dense_reference, with GELU and bias each
    on and off, every call twice bit-equal: the worst agreement reading."""
    e8 = {}
    for act in ("gelu", ""):
        for bb in (b1, None):
            o = ld.ln_dense_fused(rows, lns, lnb, w1, bb, 1e-6, act)
            what = (f"K8 {name} R={rows.shape[0]} C={rows.shape[1]} M={w1.shape[0]} "
                    f"act={act!r} bias={bb is not None}")
            check(torch.equal(o, ld.ln_dense_fused(rows, lns, lnb, w1, bb, 1e-6, act)),
                  f"{what}: two runs differ")
            r = ld.ln_dense_reference(rows, lns, lnb, w1, bb, 1e-6, act)
            _worst(e8, vit_err(o, r, ld.agreement, what))
    return e8


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
    """The ViT's and the SigLIP towers' kernel calls pointed at the kernels'
    plain versions, the forward's and the backward's."""
    saved = (vit_model.ln_qkv_fused, siglip_model.ln_qkv_fused, vit_model.ln_dense_fused,
             plain_attn.vit_attention_fused)
    vit_model.ln_qkv_fused = siglip_model.ln_qkv_fused = PlainLnQkv.apply
    vit_model.ln_dense_fused = ld.ln_dense_reference
    plain_attn.vit_attention_fused = PlainAttention.apply
    try:
        yield
    finally:
        (vit_model.ln_qkv_fused, siglip_model.ln_qkv_fused, vit_model.ln_dense_fused,
         plain_attn.vit_attention_fused) = saved


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


class TraceIncomplete(RuntimeError):
    """A torch.profiler trace whose kernel records miss part of the device
    time that CUDA events read for the same calls."""


# the least share of device_ms a trace's kernel records must hold: the rest is
# the device's gaps between back-to-back launches, a few microseconds each.
# torch.profiler drops kernel records once a process has run many traces (on
# an NVIDIA H100 a full run's late traces held ~60% of the events' time)
TRACE_MIN_SHARE = 0.9


def profiled_split(fn, reps=10):
    """{short kernel name: ms} of one fn() call: the kernels' own time in a
    torch.profiler trace over ``reps`` calls. Unchecked: see device_split."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
            # "void (anonymous namespace)::name<args>(params)" -> "name<args>"
            short = e.key.removeprefix("void ").replace("(anonymous namespace)::", "")
            short = short.split("(")[0]
            out[short] = out.get(short, 0.0) + e.self_device_time_total / reps / 1e3
    return out


def device_split(fn, ms, reps=10):
    """One fn() call's device time by CUDA kernel, {short name: ms}, from
    torch.profiler, held against ``ms``, fn's device_ms: raises
    TraceIncomplete when the records hold less than TRACE_MIN_SHARE of it."""
    split = profiled_split(fn, reps)
    held = sum(split.values())
    if held < TRACE_MIN_SHARE * ms:
        raise TraceIncomplete(f"the trace's kernel records hold {held:.4f} of {ms:.4f} ms "
                              f"({held / ms:.0%})")
    return split


def wall_ms(fn, reps=50):
    """Median wall time of one fn() call with the host included: what a
    caller waits for, from the call to its result on the device."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


class SpinTooShort(RuntimeError):
    """The host could not enqueue the calls within the device's spin."""


def device_ms(fn, reps=20):
    """Device time of one fn() call: CUDA events around ``reps`` calls that
    the host enqueues while the device spins (``torch.cuda._sleep``), so the
    device runs them back to back and neither the host's enqueue time nor
    its gaps count. The spin doubles until it outlasts the enqueue, and the
    calls halve where a full launch queue held the host back; a single call
    whose enqueue outlasts the spin twice running holds more launches than
    the queue (the host waits for the spin to end, however long): it raises
    SpinTooShort at once. Unlike a
    torch.profiler trace it sees every kernel: the backward of SDPA with a
    mask gradient, launched from autograd's device thread, and kernels a
    long process's traces drop (TRACE_MIN_SHARE)."""
    fn()
    torch.cuda.synchronize()
    spin = 10 ** 8  # cycles, ~60 ms at the H100's clock
    outlasted = 0  # single calls in a row whose enqueue outlasted the spin
    for _ in range(8):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        spun = start.elapsed_time(end)
        if host_ms < 0.5 * spin / 1.98e6:  # the enqueue ended well within the spin
            return spun / reps
        outlasted = outlasted + 1 if reps == 1 and host_ms >= spin / 1.98e6 else 0
        if outlasted == 2:
            break
        spin, reps = spin * 2, max(1, reps // 2)
    raise SpinTooShort(f"the host could not enqueue {reps} call(s) within a spin of {spin} "
                       "cycles")


def profiler_share(fn, ms, reps=10):
    """The share of ``ms`` (fn's device_ms) that torch.profiler's kernel
    records hold for the same calls at this point of the run."""
    return sum(profiled_split(fn, reps).values()) / ms


def kernel_split(fn, ms, reps=10):
    """device_split, or None where the trace is incomplete (logged): a split
    is reported only where its records hold the events' time."""
    try:
        return device_split(fn, ms, reps)
    except TraceIncomplete as e:
        log(f"[trace] no split by kernel: {e}")
        return None


def split_text(split):
    return ("not measured (the trace is incomplete)" if split is None
            else str({k: round(v, 4) for k, v in split.items()}))


def enqueue_us(fn, reps=50):
    """Host microseconds to enqueue one fn() call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def k2_against_library(fns, backend):
    """K2 against SDPA on ``backend``, pinned once outside every timed
    region: CUDA-event medians in turns over windows of 20 calls, and the
    device time of each of K2, K2 with its row statistics and the library
    call (``device_ms``). fns {name: fn} holds those three as "K2",
    "K2 with statistics" and "K2 library" (SDPA unpinned), and any others
    to time in the same turns."""
    with sdpa_pinned(backend):
        ms, _ = _in_turns(fns, reps=20)
        dev = {key: device_ms(fns[key]) for key in ("K2", "K2 with statistics", "K2 library")}
    return ms, dev


def k2_at_b8(q, k, v, sc, name):
    """K2 at B = 8 (the first 96 heads of the B = 16 inputs; the train
    step's batch) against the library call on its default backend: see
    ``k2_against_library``; and the host's enqueue time of a call of each."""
    h, n, hd = VIT["heads"], VIT["n"], q.shape[-1]
    q8, k8, v8 = (t[:8 * h] for t in (q, k, v))
    q4, k4, v4 = (t.reshape(8, h, n, hd) for t in (q8, k8, v8))
    backend = sdpa_backend(lambda: F.scaled_dot_product_attention(q4, k4, v4))
    fns = {"K2": lambda: va.vit_attention_fused(q8, k8, v8, sc),
           "K2 with statistics": lambda: va.launch_attention_forward(q8, k8, v8, sc, True),
           "K2 library": lambda: F.scaled_dot_product_attention(q4, k4, v4)}
    ms, dev = k2_against_library(fns, backend)
    with sdpa_pinned(backend):
        host = {"K2": enqueue_us(fns["K2"]), "K2 library": enqueue_us(fns["K2 library"])}
    out = {"ms": ms["K2"], "stats_ms": ms["K2 with statistics"], "library_ms": ms["K2 library"],
           "device_ms": dev["K2"], "stats_device_ms": dev["K2 with statistics"],
           "library_device_ms": dev["K2 library"], "library": backend,
           "enqueue_us": host["K2"], "library_enqueue_us": host["K2 library"]}
    log(f"[rates] K2 {name:8s} B=8: {ms['K2']:.3f} ms, with statistics "
        f"{ms['K2 with statistics']:.3f} ms, library call {ms['K2 library']:.3f} ms (SDPA, "
        f"{backend}); device time {dev['K2']:.4f} ms, with statistics "
        f"{dev['K2 with statistics']:.4f} ms, library call {dev['K2 library']:.4f} ms; the host "
        f"enqueues a call in {host['K2']:.1f} us (library {host['K2 library']:.1f} us)")
    return out


# the bf16 model's unit embeddings with the kernels against the same model
# with the kernels' plain versions and on the eager bf16 path: 2^-9 and
# 1.25 x 2^-9 seen (PERF.md); twice that is allowed
VIT_EMBED_BF16_TOL = {"plain versions": 4e-3, "eager": 5e-3}


def unfused_mlp_head(lns, lnb, w1, b1, dtype):
    """The port's LayerNorm and fc1 modules holding K8's operands, on the
    card in ``dtype`` as a block's parameters are."""
    c = w1.shape[1]
    norm = convnext_model.LayerNorm(c)
    fc1 = torch.nn.Linear(c, w1.shape[0])
    with torch.no_grad():
        norm.weight.copy_(lns)
        norm.bias.copy_(lnb)
        fc1.weight.copy_(w1)
        fc1.bias.copy_(b1)
    return norm.to("cuda", dtype), fc1.to("cuda", dtype)


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
            # K7's and K8's products alone, yardsticks used nowhere in the port:
            # torch.matmul on the normalised rows, (B N, C) . (C, 3C) and (C, 4C)
            y_rows, w_t = ld._ln_rows(rows, lns, lnb, 1e-6), w.t().contiguous()
            w1_t = w1.t().contiguous()
            # K8 unfused: what a block runs in its place (Mlp.forward without
            # XMIR_FUSED_LN_MLP): the port's LayerNorm, fc1 through _dense and
            # adaptive_gelu, on parameters in the model's dtype
            norm2, fc1 = unfused_mlp_head(lns, lnb, w1, b1, dtype)
            # the library yardstick on the backend the default dispatch picks, pinned
            backend = sdpa_backend(lambda: F.scaled_dot_product_attention(q4, k4, v4))
            fns = {
                "K2": lambda: va.vit_attention_fused(q, k, v, sc),
                "K2 plain": lambda: va.attention_plain(q, k, v, sc),
                "K2 library": lambda: F.scaled_dot_product_attention(q4, k4, v4),
                "K2 with statistics": lambda: va.launch_attention_forward(q, k, v, sc, True),
                "K7": lambda: ld.ln_qkv_fused(x, lns, lnb, w, bias, h),
                "K7 plain": lambda: ld.ln_qkv_reference(x, lns, lnb, w, bias, h),
                "K7 product": lambda: torch.matmul(y_rows, w_t),
                "K8": lambda: ld.ln_dense_fused(rows, lns, lnb, w1, b1, 1e-6, "gelu"),
                "K8 plain": lambda: ld.ln_dense_reference(rows, lns, lnb, w1, b1, 1e-6, "gelu"),
                "K8 product": lambda: torch.matmul(y_rows, w1_t),
                "K8 unfused": lambda: adaptive_gelu(vit_model._dense(norm2(rows), fc1)),
            }
            errs = {"K2": vit_err(fns["K2"](), fns["K2 plain"](), va.agreement, f"K2 {name} B=16"),
                    "K8": vit_err(fns["K8"](), fns["K8 plain"](), ld.agreement, f"K8 {name} B=16")}
            errs["K7"] = {}
            for o, r in zip(fns["K7"](), fns["K7 plain"]()):
                _worst(errs["K7"], vit_err(o, r, ld.agreement, f"K7 {name} B=16"))
            lib_err = (fns["K2"]().float() - under_backend(backend, fns["K2 library"]).reshape(
                q.shape).float()).abs().max().item()
            ms, dev = k2_against_library(fns, backend)
            k2_share = profiler_share(fns["K2"], dev["K2"])
            for key in ("K7", "K7 product", "K8", "K8 product", "K8 unfused"):
                dev[key] = device_ms(fns[key])
            k8_split = kernel_split(fns["K8"], dev["K8"])
            bounds = _kernel_bounds(b, dtype)
            for key in out:
                ops, nbytes = bounds[key]
                bound_ms, bound_by = bound(ops, nbytes, name)
                out[key][name] = {"ms": ms[key], "plain_ms": ms[f"{key} plain"],
                                  "library_ms": ms.get(f"{key} library"), "bound_ms": bound_ms,
                                  "bound_by": bound_by, "agreement": errs[key]}
                lib = (f", with statistics {ms['K2 with statistics']:.3f} ms, library call "
                       f"{ms['K2 library']:.3f} ms (SDPA, {backend}); device time "
                       f"{dev['K2']:.4f} ms, with statistics {dev['K2 with statistics']:.4f} ms, "
                       f"library call {dev['K2 library']:.4f} ms (torch.profiler's records hold "
                       f"{k2_share:.1%} of K2's)" if key == "K2" else
                       f"; device time {dev['K7']:.4f} ms; the product alone (torch.matmul on the "
                       f"normalised rows) {ms['K7 product']:.3f} ms, device time "
                       f"{dev['K7 product']:.4f} ms" if key == "K7" else
                       f"; device time {dev['K8']:.4f} ms (by kernel: {split_text(k8_split)}); "
                       f"the product alone (torch.matmul on the normalised rows) "
                       f"{ms['K8 product']:.3f} ms, device time {dev['K8 product']:.4f} ms; "
                       f"the unfused sequence (LayerNorm, fc1, adaptive_gelu) "
                       f"{ms['K8 unfused']:.3f} ms, device time {dev['K8 unfused']:.4f} ms")
                log(f"[rates] {key} {name:8s} B=16 N={n} C={c}: {ms[key]:.3f} ms "
                    f"({ops / ms[key] / 1e9:.1f} TFLOP/s; bound {bound_ms:.3f} ms by {bound_by}) "
                    f"vs plain {ms[f'{key} plain']:.3f} ms{lib}; agreement {errs[key]}")
            log(f"[rates] K2 {name} vs scaled_dot_product_attention: max |diff| {lib_err:.3g}")
            out["K7"][name].update(device_ms=dev["K7"], product_ms=ms["K7 product"],
                                   product_device_ms=dev["K7 product"])
            out["K8"][name].update(device_ms=dev["K8"], split=k8_split,
                                   product_ms=ms["K8 product"],
                                   product_device_ms=dev["K8 product"],
                                   unfused_ms=ms["K8 unfused"],
                                   unfused_device_ms=dev["K8 unfused"])
            out["K2"][name].update(library=backend, stats_ms=ms["K2 with statistics"],
                                   device_ms=dev["K2"], stats_device_ms=dev["K2 with statistics"],
                                   library_device_ms=dev["K2 library"], profiler_share=k2_share,
                                   b8=k2_at_b8(q, k, v, sc, name))
            del q, k, v, x, w, w1, rows, q4, k4, v4, fns, y_rows, w_t, w1_t, norm2, fc1
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
        # the same two paths by device time, in turns
        dev = {"kernels": [], "kernels + K8": []}
        for path in ("kernels", "kernels + K8", "kernels + K8", "kernels"):
            dev[path].append(device_ms(with_fused_mlp if path == "kernels + K8"
                                       else lambda: embed(x), reps=3))
        dev = {path: statistics.median(v) for path, v in dev.items()}
        out["profile"] = profile_forward("DINOv2 ViT-B/14 bf16 batch 16 @518 with K7 + K2", embed,
                                         x, {"K2": K2_BF16_KERNELS, "K7": K7_KERNELS})
    rates = {k: 16 / v * 1e3 for k, v in ms.items()}
    log(f"[rates] DINOv2 ViT-B/14 bf16 batch 16 @518 (device only): "
        + "; ".join(f"{k} {ms[k]:.2f} ms = {rates[k]:.0f} img/s" for k in ms)
        + f"; the kernels' embeddings within {diff} of those paths' (bounds "
        f"{VIT_EMBED_BF16_TOL}), with K8 within {mlp_diff:.3g} of the eager path's; runs "
        f"{({k: [round(t, 2) for t in v] for k, v in runs.items()})}")
    log(f"[rates] DINOv2 ViT-B/14 bf16 batch 16 @518 by device time (device_ms, in turns): "
        f"kernels {dev['kernels']:.4f} ms, kernels + K8 {dev['kernels + K8']:.4f} ms "
        f"(K8 on: {dev['kernels'] - dev['kernels + K8']:+.4f} ms a forward)")
    out["embed_rate"] = rates
    out["embed_device_ms"] = dev
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
        (3, 1, 5, 1, False, "N 1"), (2, 4, 2, 144, False, "N 144"),
        # bf16 K4 takes a group's images two to a block: an odd number a group
        (3, 4, 2, 144, True, "3 images a group"), (5, 1, 4, 576, False, "5 images a group")]
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
    # one score producer: on random rows K1''s first entries equal K1's at
    # every route (fused at k = 10, select at 128 and 1024) bit for bit
    for dtype in (torch.float32, torch.bfloat16):
        for q_n, n, d in ((70, 4099, 96), (300, 20_000, 1024), (16, 20_000, 1024)):
            q, g = _random_inputs(gen, q_n, n, d, dtype)
            bias = torch.randn(n, generator=gen).cuda() * 0.01
            v, i = fused_topk_scores(q, g, bias, 2048)
            for k in (10, 128, 1024):
                v1, i1 = fused_topk_scores(q, g, bias, k)
                check(torch.equal(v1, v[:, :k]) and torch.equal(i1, i[:, :k]),
                      f"K1' and K1 at k={k} disagree on random rows: {dtype} Q={q_n} N={n} D={d}")
        log(f"[kernel] K1' {str(dtype)[6:]} random rows: first 10, 128 and 1024 entries equal "
            "to K1's at those k, bit for bit")
    return err


class PlainBiasedAttention(torch.autograd.Function):
    """K4's and K5's plain versions as one differentiable call."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, g_size, cosine):
        out = va.biased_attention_plain(q, k, v, bias, scale, g_size, cosine)
        ctx.g_size, ctx.cosine = g_size, cosine
        ctx.save_for_backward(q, k, v, bias, scale, out)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, scale, out = ctx.saved_tensors
        return (*va.biased_attention_bwd_plain(q, k, v, bias, scale, out, g.contiguous(),
                                               ctx.g_size, ctx.cosine), None, None)


@contextlib.contextmanager
def swin_plain_versions():
    """The Swin model's kernel calls pointed at the kernels' plain versions
    (K4's and K5's as one Function, K6's)."""
    saved = (swin_model.biased_attention_fused, swin_model.window_attention_fused)
    swin_model.biased_attention_fused = PlainBiasedAttention.apply
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
            total = {key: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                                         "library_device_ms"), 0.0) for key in out}
            bound_by, backends, fold_ms = set(), set(), 0.0
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

                def sdpa():
                    return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask, scale=1.0)

                # the backend the default dispatch picks, named and pinned once
                # outside every timed region
                sdpa_name = sdpa_backend(sdpa)
                backends.add(sdpa_name)
                fns = {
                    "K4": lambda: va.biased_attention_fused(q, k, v, bias, scale, g_size, True),
                    "K4 plain": lambda: va.biased_attention_plain(q, k, v, bias, scale, g_size,
                                                                  True),
                    "K6": lambda: wa.window_attention_fused(*ops6),
                    "K6 plain": lambda: wa.window_attention_plain(*ops6),
                    "library": sdpa,
                    "fold": folds,
                }
                shape = (f"B={b} windows={nw} H={h} N={n} "
                         f"{'shifted' if shifted else 'unshifted'} x{count}")
                e4 = window_err(fns["K4"](), fns["K4 plain"](), f"K4 {name} {shape}")
                e6 = window_err(fns["K6"](), fns["K6 plain"](), f"K6 {name} {shape}")
                lib = under_backend(sdpa_name, sdpa)
                lib = (lib.reshape(b, nw, h, n, SWIN_HD).permute(1, 0, 2, 3, 4) if shifted
                       else lib.reshape(nw, b, h, n, SWIN_HD))
                lib_err = (lib.float() - fns["K6"]().float()).abs().max().item()
                fast = ("K4", "K6", "library", "fold")
                with sdpa_pinned(sdpa_name):
                    ms, _ = _in_turns({key: fns[key] for key in fast}, reps=20)
                    dev = {key: device_ms(fns[key]) for key in ("K4", "K6", "library")}
                ms.update(_in_turns({key: fns[key] for key in fns if key not in fast})[0])
                work = _window_work(b, nw, h, n, shifted, dtype)
                bound_ms, by = bound(*work, name)
                bound_by.add(by)
                fold_ms += count * ms["fold"]
                for key in out:
                    out[key][f"{name} {shape}"] = {
                        "ms": ms[key], "plain_ms": ms[f"{key} plain"], "library_ms": ms["library"],
                        "bound_ms": bound_ms, "bound_by": by, "device_ms": dev[key],
                        "library_device_ms": dev["library"]}
                    for field, value in (("ms", ms[key]), ("plain_ms", ms[f"{key} plain"]),
                                         ("library_ms", ms["library"]), ("bound_ms", bound_ms),
                                         ("device_ms", dev[key]),
                                         ("library_device_ms", dev["library"])):
                        total[key][field] += count * value
                log(f"[rates] {name:8s} {shape}: K4 {ms['K4']:.3f} ms "
                    f"({work[0] / ms['K4'] / 1e9:.1f} TFLOP/s; bound {bound_ms:.3f} ms by {by}, "
                    f"{bound_ms / ms['K4']:.1%} of it) vs "
                    f"plain {ms['K4 plain']:.3f} ms; K6 {ms['K6']:.3f} ms vs plain "
                    f"{ms['K6 plain']:.3f} ms; library call (SDPA, {sdpa_name}) "
                    f"{ms['library']:.3f} ms (max |diff| to K6 {lib_err:.3g}); device time K4 "
                    f"{dev['K4']:.4f} ms, K6 {dev['K6']:.4f} ms, library {dev['library']:.4f} ms; "
                    f"K4's fold + unfold copies {ms['fold']:.3f} ms; agreement K4 {e4}, K6 {e6}")
                del q, k, v, bias, scale, ops6, lq, lk, lv, mask, bw_qkv, fns, lib
                torch.cuda.empty_cache()
            library = f"scaled_dot_product_attention, {'/'.join(sorted(backends))} backend"
            for key in out:
                out[key][name] = dict(total[key], bound_by="/".join(sorted(bound_by)),
                                      library=library)
            log(f"[rates] {name:8s} the {SWIN_DEPTH} calls of one SwinV2-Base forward at B={b}: "
                + "; ".join(f"{key} {total[key]['ms']:.3f} ms (plain {total[key]['plain_ms']:.3f}, "
                            f"library {total[key]['library_ms']:.3f}, bound "
                            f"{total[key]['bound_ms']:.3f}: "
                            f"{total[key]['bound_ms'] / total[key]['ms']:.1%} of it; device time "
                            f"{total[key]['device_ms']:.4f} against the library's "
                            f"{total[key]['library_device_ms']:.4f})" for key in out)
                + f"; K4's fold + unfold copies {fold_ms:.3f} ms; library = {library}")
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


# the device kernels of K3's and K4's bf16 launches, by name in a profiler trace
K3_BF16_KERNELS = ("bwd_prep_bf16", "bwd_bf16_wg", "bwd_dq_finish")
K4_BF16_KERNELS = ("wattn_bf16_wg",)
K5_BF16_KERNELS = ("window_bwd_prep", "window_bwd_main", "window_bwd_finish")
# ... and of K2's, K7's and K9's (K11's) in the bf16 forwards
K2_BF16_KERNELS = ("attn_bf16_wg",)
# bf16 K7: ln_rows and ln_gemm_wg<kHeads, false> (K8 is off in the profiled
# forward); f32: ln_qkv_f32
K7_KERNELS = ("ln_gemm_wg<0, false>", "ln_qkv", "ln_rows")
K9_BF16_KERNELS = ("ln_rows", "tail_gemm_wg", "grn_scale")
# ... and of K10's in the bf16 ConvNeXtV2-Base train step
# (its LayerNorm pre-pass, ln_rows, is also K9's there, and is read apart)
K10_BF16_KERNELS = ("tail_bwd_pass", "grn_bwd", "tail_bwd_gemm", "sum_jobs", "ln_bwd_rows")


def kernel_share(rows, names):
    """(ms, share) of the device time in ``rows`` ((name, ms, count) from
    torch.profiler) spent in kernels whose names hold any of ``names``."""
    total = sum(r[1] for r in rows)
    ms = sum(r[1] for r in rows if any(k in r[0] for k in names))
    return ms, (ms / total if total else 0.0)


def profile_forward(label, embed, x, shares, what="forward"):
    """Where one forward's (``what``'s) time goes: the host's wall time per
    call (and the time to enqueue it) beside the device time by kernel name,
    from torch.profiler over three calls. ``shares`` {name: kernel names}
    picks the kernels whose share of the device time is reported."""
    from torch.profiler import ProfilerActivity, profile

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
    traced = sum(r[1] for r in rows)
    try:
        events = device_ms(lambda: embed(x), reps=3)
    except SpinTooShort:  # more launches than the launch queue holds: the trace alone
        events = None
    device = traced if events is None else events
    out = {"wall_ms": wall * 1e3, "enqueue_ms": enqueued * 1e3, "device_ms": events,
           "traced_ms": traced, "kernels": sum(r[2] for r in rows),
           "idle_share": max(0.0, 1 - device / (wall * 1e3))}
    log(f"[profile] {label}: {out['wall_ms']:.2f} ms a {what} on the host's clock "
        f"({out['enqueue_ms']:.2f} ms to enqueue it), "
        + (f"{traced:.2f} ms of device time in the trace, unchecked (a {what}'s launches "
           "outrun the launch queue, so device_ms cannot read it)" if events is None else
           f"{events:.2f} ms of device time (device_ms), {traced:.2f} ms "
           f"({traced / events:.0%}) of it in the trace")
        + f" in {out['kernels']:.0f} kernels: the device is idle {out['idle_share']:.0%} of a "
        f"{what}")
    if events is not None and traced < TRACE_MIN_SHARE * events:
        log(f"[profile] {label}: the trace is incomplete; its shares below are not measured")
        return out
    for name, names in shares.items():
        ms, share = kernel_share(rows, names)
        out[name] = {"ms": ms, "share": share}
        log(f"[profile] {name} ({', '.join(names)}) {ms:.3f} ms a {what} = {share:.1%} of the "
            "device time")
    for name, ms, count in rows[:20]:
        log(f"[profile] {ms:8.3f} ms  {count:6.0f} x  {name[:110]}")
    return out


def profile_swin():
    """Where one bf16 SwinV2-Base batch's time goes (``--profile-swin``) on
    the default path (K4)."""
    embed, x = _swin_bf16_model()
    profile_forward("SwinV2-Base bf16 batch 16 @384 with K4", embed, x,
                    {"K4": K4_BF16_KERNELS})


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
    """K1' over the serving gallery at Q = 1024, k = 2048 and as a full
    ranking of 64 queries, f32 and bf16, with K1 at k = 10 in the same turns:
    CUDA events, device time by kernel, one call's memory, and the yardsticks
    by device time (torch.mm alone; torch.topk of it at k = 2048, values
    only, since its tie order is not the kernel's; torch.sort of the scores,
    stable, for the full ranking; used nowhere in the port)."""
    n, d = SERVING_N, SERVING_D
    gen = torch.Generator().manual_seed(20)
    q = l2_normalize(torch.randn((1024, d), generator=gen)).cuda()
    g = l2_normalize(torch.randn((n, d), generator=gen)).cuda()
    bias = torch.zeros(n, device="cuda")
    out = {}
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        name, gg = str(dtype)[6:], g.to(dtype)
        q10 = q.to(dtype)
        for label, q_n, k in (("Q=1024 k=2048", 1024, 2048), ("Q=64 k=N", 64, n)):
            qq = q10[:q_n].contiguous()
            v, i = fused_topk_scores(qq, gg, bias, k)
            rv, ri = topk_scores_reference(qq[:64], gg, bias, min(k + 1, n))
            torch.cuda.synchronize()
            sorted_ref = rv if k < n else torch.cat([rv, rv[:, -1:] - 1], dim=1)
            err, checked, total = compare(v[:64], i[:64], rv[:, :k], ri[:, :k], atol,
                                          sorted_ref)
            # what one K1' call allocates: its result and its scratch, the plain
            # version's Q x N scores and sort left out of the reading
            del v, i, rv, ri, sorted_ref
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            held = fused_topk_scores(qq, gg, bias, k)
            torch.cuda.synchronize()
            peak_mib = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            result_mib = sum(t.numel() * t.element_size() for t in held) / 2 ** 20
            del held
            ms, runs = _in_turns({
                "K1'": lambda: fused_topk_scores(qq, gg, bias, k),
                "plain": lambda: topk_scores_reference(qq, gg, bias, k),
                "K1 k=10": lambda: fused_topk_scores(q10, gg, bias, 10)}, rounds=3, reps=2)
            dev_ms = device_ms(lambda: fused_topk_scores(qq, gg, bias, k), reps=5)
            split = kernel_split(lambda: fused_topk_scores(qq, gg, bias, k), dev_ms, reps=5)
            yard = {"mm": device_ms(lambda: torch.mm(qq, gg.T), reps=5)}
            if k < n:
                yard["mm+topk"] = device_ms(
                    lambda: torch.topk(torch.mm(qq, gg.T) + bias, k, dim=1).values, reps=5)
            else:
                scores = torch.mm(qq, gg.T) + bias
                yard["sort"] = device_ms(
                    lambda: torch.sort(scores, dim=1, descending=True, stable=True), reps=5)
                del scores
            key = f"{name} {label}"
            out[key] = dict(k1_bound(q_n, n, d, k, dtype), ms=ms["K1'"], plain_ms=ms["plain"],
                            device_ms=dev_ms, device_by_kernel=split,
                            yardstick_device_ms=yard, max_abs_err=err,
                            k1_k10_ms=ms["K1 k=10"], peak_mib=peak_mib, result_mib=result_mib)
            r = out[key]
            log(f"[rates] K1' {key} N={n} D={d}: device {r['device_ms']:.4f} ms "
                f"({2 * q_n * n * d / r['device_ms'] / 1e9:.1f} TFLOP/s; bound "
                f"{r['bound_ms']:.4f} ms by {r['bound_by']}"
                + (f", FMA bound {r['fma_bound_ms']:.4f}" if "fma_bound_ms" in r else "")
                + f"), by kernel {split_text(split)}; events "
                f"{r['ms']:.4f} ms vs plain {ms['plain']:.3f} ms; K1 at k=10 in the same "
                f"turns {ms['K1 k=10']:.4f} ms; yardsticks by device time "
                f"{({k_: round(v_, 4) for k_, v_ in yard.items()})}; max err {err:.3g}, "
                f"{checked}/{total} ids of the first 64 queries checked equal; one K1' call "
                f"alone peaks {peak_mib:.0f} MiB above its inputs, {result_mib:.0f} MiB of it "
                f"the result; runs {({k_: [round(t, 3) for t in v_] for k_, v_ in runs.items()})}")
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
             (2, 1, 64, "N 1"), (3, 137, 128, "hd 128"),
             # bf16: more (head, 128-key) units than blocks, a last unit half dead
             (140, 200, 64, "more units than SMs"), (133, 129, 32, "half-dead last unit")]
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


def _train_args(img_dir, manifest, val_dir, val_manifest, model, save_dir, log_path, *extra,
                dataset="covid"):
    return ["--dataset", dataset, "--dataset-dir", img_dir, "--train-image-list", manifest,
            "--val-dataset-dir", val_dir, "--val-image-list", val_manifest, "--model", model,
            "--device", "cuda", "--seed", "0", "-k", "4", "-j", "8", "--print-freq", "1",
            # on unit embeddings a margin of 2 keeps every triplet active: every
            # step has a gradient, however far apart random weights put the classes
            "--margin", "2.0",
            "--eval-freq", "1", "--ckpt-every", "1", "--eval-batch-size", "8", "--save-dir",
            save_dir, "--metrics-log", log_path, *extra]


def _option(extra, flag, default=None):
    return extra[extra.index(flag) + 1] if flag in extra else default


def make_trainer(workdir, model, data, *common_args, dataset="covid"):
    """run(name, *extra) -> (losses [(epoch, step, loss)], the last epoch's
    checkpoint path): cli.train.main on ``data`` into ``workdir / name``.
    The dual-branch step's terms, where logged, stand beside each loss:
    (epoch, step, loss, contrastive, asl)."""
    def run(name, *extra):
        extra = (*common_args, *extra)
        save, log_path = str(workdir / name), str(workdir / f"{name}.jsonl")
        train_cli.main(_train_args(*data, model, save, log_path, *extra, dataset=dataset))
        dim = _option(extra, "--embedding-dim")
        path = os.path.join(save, checkpoint_name(
            dataset, model, embedding_dim=dim and int(dim), rand_resize="--rand-resize" in extra,
            seed=0, epoch=int(_option(extra, "--epochs"))))
        check(os.path.isfile(path) and os.path.isfile(path + ".json"), f"no checkpoint {path}")
        records = [json.loads(line) for line in Path(log_path).read_text().splitlines()]
        losses = [(r["epoch"], r["step"], r["loss"],
                   *(r[k] for k in ("contrastive", "asl") if k in r))
                  for r in records if r["kind"] == "train"]
        check(losses and all(np.isfinite(v).all() for v in (np.array(r[2:]) for r in losses)),
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


def check_resume(run, steps, what, *first_args, first_run=None):
    """One epoch (started with ``first_args``), then --resume of its
    checkpoint for a second, against two epochs in one run: the second
    epoch's losses and the final tensors are bit-equal. ``steps``: the train
    steps of epochs 1 and 2; ``first_run``: the (losses, checkpoint) of an
    epoch already run with ``first_args``, in place of running it again.
    Returns the first epoch's checkpoint."""
    first, ckpt1 = first_run or run("first", *first_args, "--epochs", "1")
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
        f"(losses {[round(r[2], 4) for r in whole]})")
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
            # the library call: one SDPA forward on the backend the default
            # dispatch picks (named, and pinned for the forward, which fixes
            # the backward's kernel), its graph kept, its backward timed alone
            lq, lk, lv = (t.reshape(b, h, n, hd).detach().requires_grad_(True) for t in (q, k, v))
            backend = sdpa_backend(lambda: F.scaled_dot_product_attention(lq, lk, lv))
            lo = under_backend(backend, lambda: F.scaled_dot_product_attention(lq, lk, lv))
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
            fast = ("K3", "K3 library", "K2")
            with sdpa_pinned(backend):
                ms, _ = _in_turns({key: fns[key] for key in fast}, reps=20)
                dev = {key: device_ms(fns[key]) for key in ("K3", "K3 library")}
                k3_share = profiler_share(fns["K3"], dev["K3"])
            ms.update(_in_turns({"K3 plain": fns["K3 plain"]})[0])
            ops, nbytes = _bwd_work(bh, n, hd, dtype)
            bound_ms, bound_by = bound(ops, nbytes, name)
            out[f"{name} B={b}"] = {"ms": ms["K3"], "plain_ms": ms["K3 plain"],
                                    "library_ms": ms["K3 library"], "forward_ms": ms["K2"],
                                    "bound_ms": bound_ms, "bound_by": bound_by, "agreement": e,
                                    "device_ms": dev["K3"], "library_device_ms": dev["K3 library"],
                                    "profiler_share": k3_share,
                                    "library": f"scaled_dot_product_attention backward, {backend}"}
            log(f"[rates] K3 {name:8s} B={b} BH={bh} N={n} hd={hd}: {ms['K3']:.3f} ms "
                f"({ops / ms['K3'] / 1e9:.1f} TFLOP/s of the 10 BH N^2 hd it must do; bound "
                f"{bound_ms:.3f} ms by {bound_by}, {bound_ms / ms['K3']:.1%} of it) vs plain "
                f"{ms['K3 plain']:.3f} ms, library backward ({backend}) {ms['K3 library']:.3f} ms, "
                f"K2 with statistics {ms['K2']:.3f} ms; device time K3 {dev['K3']:.4f} ms "
                f"(torch.profiler's records hold {k3_share:.1%} of it), library "
                f"backward {dev['K3 library']:.4f} ms; agreement {e}; within {lib_rel:.3g} of the "
                "library's gradients' largest magnitude")
            del q, k, v, g, o, stats, lq, lk, lv, lo, lg, fns
            torch.cuda.empty_cache()
    return out


def phase_train_rates():
    """The bf16 DINOv2 ViT-B/14 train step at batch 8, 518 px (f32 master
    weights, triplet loss): with the kernels, with their plain versions and
    on the eager path, in turns; peak memory of each; where a step's time
    goes; and the device time by kernel (torch.profiler over one step), K3's
    share of it."""
    from torch.profiler import ProfilerActivity, profile

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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with_kernels()
            torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    k3_ms, k3_share = kernel_share(rows, K3_BF16_KERNELS)
    out["profile"] = {"device_ms": sum(r[1] for r in rows), "kernels": sum(r[2] for r in rows),
                      "k3_ms": k3_ms, "k3_share": k3_share,
                      "top": [[n[:90], round(t, 3), c] for n, t, c in rows[:12]]}
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
    log(f"[profile] DINOv2 ViT-B/14 bf16 train step with the kernels: "
        f"{out['profile']['device_ms']:.2f} ms of device time in {out['profile']['kernels']} "
        f"kernels, K3's launches {k3_ms:.3f} ms of it ({k3_share:.1%}); by kernel:")
    for name, t, count in rows[:12]:
        log(f"[profile] {t:8.3f} ms  {count:6d} x  {name[:110]}")
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
            extra = ""
            if dtype == torch.bfloat16:  # pass 2 forms h1 and ab bit for bit as pass 1 did
                check(cb.tail_bwd_recomputes_ab(h, dy, *p),
                      f"K10 {name} {what}: pass 2's ab differs from pass 1's")
                extra = "; pass 2's ab^2 sums bit-equal to pass 1's"
            log(f"[kernel] K10 {name:8s} B={b} {hw:2d}x{hw:2d} C={c:4d} ({what}): {e}; twice "
                f"bit-equal{extra}")
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
            # device time of the kernel and of the gate's two blocks: the plain
            # block's many small launches follow the host in CUDA-event readings
            dev = {key: device_ms(fns[key], reps=10) for key in ("K10", "fused block",
                                                                  "plain block")}
            k10_share = profiler_share(fns["K10"], dev["K10"])
            nbytes = ctypes.c_longlong()
            check(_build.load().xmir_convnext_bwd_plan(b, r, c, 4 * c, cb.DTYPE_CODES[dtype],
                                                       ctypes.addressof(nbytes)) == 0,
                  f"K10 {name} {what}: no workspace plan")
            ws = nbytes.value
            ops, nbytes = _tail_bwd_work(b, r, c, dtype)
            bound_ms, bound_by = bound(ops, nbytes, name)
            gate = "fused" if cb.fused_train_wins(r, c, 4 * c) else "plain"
            out[f"{name} {what}"] = {
                "ms": ms["K10"], "plain_ms": ms["K10 plain"], "autograd_ms": ms["autograd"],
                "fused_block_ms": ms["fused block"], "plain_block_ms": ms["plain block"],
                "bound_ms": bound_ms, "bound_by": bound_by, "workspace_mib": ws / 2 ** 20,
                "agreement": e, "gate": gate, "device_ms": dev["K10"], "profiler_share": k10_share,
                "fused_block_device_ms": dev["fused block"],
                "plain_block_device_ms": dev["plain block"]}
            log(f"[rates] K10 {name:8s} B=16 {hw}x{hw} C={c} ({what}): {ms['K10']:.3f} ms "
                f"({ops / ms['K10'] / 1e9:.1f} TFLOP/s; bound {bound_ms:.3f} ms by {bound_by}) vs "
                f"plain {ms['K10 plain']:.3f} ms, autograd through the plain tail "
                f"{ms['autograd']:.3f} ms; device time {dev['K10']:.4f} ms (torch.profiler's "
                f"records hold {k10_share:.1%} of it); workspace "
                f"{ws / 2 ** 20:.1f} MiB; one block forward + backward: fused (K9 + K10) "
                f"{ms['fused block']:.3f} ms, plain block {ms['plain block']:.3f} ms, by device "
                f"time {dev['fused block']:.4f} against {dev['plain block']:.4f} ms (gate: "
                f"{gate}); agreement {e}")
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
        out["profile"] = profile_forward(
            "ConvNeXtV2-Base bf16 train step, batch 16 @384, with K9 + K10",
            lambda _: with_kernels(), None,
            {"K10": K10_BF16_KERNELS, "ln_rows (K9 and K10)": ("ln_rows",),
             "K9": ("tail_gemm_wg", "grn_scale")}, what="step")
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


# --- SwinV2 training: K5 -----------------------------------------------------


def swin_fold(b, nw, h, shifted):
    """(BH, G, g_size) of one SwinV2 block's fold at batch b: without a shift
    mask a head's bias slice serves its nw b rows, with one a (head, window)
    pair's serves its b rows."""
    return b * nw * h, (nw * h if shifted else h), (b if shifted else nw * b)


def _k5_inputs(gen, bh, groups, n, hd, dtype, shifted, scale_max=100.0):
    """q, k, v (bh, n, hd), the bias (CPB-like, plus a random -100 shift mask
    when ``shifted``), logit scales up to ``scale_max`` and a cotangent g."""
    q, k, v, g = (torch.randn((bh, n, hd), generator=gen).to("cuda", dtype) for _ in range(4))
    bias = 16 * torch.rand((groups, n, n), generator=gen)
    if shifted:
        bias += torch.where(torch.rand((groups, n, n), generator=gen) < 0.4, -100.0, 0.0)
    scale = 1 + (scale_max - 1) * torch.rand(groups, generator=gen)
    return q, k, v, bias.cuda(), scale.cuda(), g


def k5_err(outs, refs, floors, dtype, what):
    """The worst ``va.biased_grad_agreement`` reading over K5's five outputs
    (and each output's); raises past the bounds stated in ops/vit_attn.py."""
    readings = va.biased_grad_agreement(outs, refs, floors, dtype)
    worst = {}
    for name, e in readings.items():
        check(va.grad_agrees(e), f"{what} {name}: K5 differs from its plain version past the "
                                 f"bounds (GRAD_RTOL, GRAD_MEAN_RTOL, dscale's ten times): {e}")
        _worst(worst, e)
    return worst, readings


def biased_grads(q, k, v, bias, scale, g, g_size, cosine=True):
    """(out, the five gradients) through the Function: K4 forward, K5
    backward (their plain versions for CPU tensors)."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v, bias, scale)]
    out = va.biased_attention_fused(*leaves, g_size, cosine)
    return out.detach(), torch.autograd.grad(out, leaves, g)


# the Function's five gradients (K4 forward, K5 backward) against autograd
# through the f32 reference, of each gradient's largest magnitude: f32 the JAX
# package's bounds on its kernel (5e-5; dscale 5e-4, tests/test_vit_attn.py);
# bf16 K10's Function bound (its roundings of qh, kh, t, e and the gradients),
# dscale ten times it
FUNCTION_GRAD_RTOL = {torch.float32: 5e-5, torch.bfloat16: 2 ** -5}
# the six SwinV2-Base (stage, shifted) shapes at B = 2, a tiny head, one
# group over 64 folded rows (an unshifted fold's large g_size)
K5_CASES = [(2, nw, h, n, sh, SWIN_HD, "Swin-B, B 2") for nw, h, n, sh, _ in SWIN_SHAPES] + [
    (2, 2, 2, 64, True, 8, "N 64, hd 8"), (64, 1, 1, 576, False, SWIN_HD, "G 1, g_size 64")]


def phase_kernel_window_bwd():
    gen = torch.Generator().manual_seed(32)
    err = {"K5": {}, "function": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        for b, nw, h, n, shifted, hd, what in K5_CASES:
            bh, groups, g_size = swin_fold(b, nw, h, shifted)
            q, k, v, bias, scale, g = _k5_inputs(gen, bh, groups, n, hd, dtype, shifted)
            shape = (f"B={b} windows={nw} H={h} N={n} hd={hd} "
                     f"{'shifted' if shifted else 'unshifted'}")
            worst = {}
            for cosine, sc in ((True, scale), (False, scale * 0.01)):
                with torch.no_grad():
                    o = va.biased_attention_fused(q, k, v, bias, sc, g_size, cosine)
                outs = va.biased_attention_bwd(q, k, v, bias, sc, o, g, g_size, cosine)
                again = va.biased_attention_bwd(q, k, v, bias, sc, o, g, g_size, cosine)
                torch.cuda.synchronize()
                check(all(torch.equal(a, c) for a, c in zip(outs, again)),
                      f"K5 {name} {shape} cosine={cosine}: two runs differ")
                check(all(torch.isfinite(t.float()).all() for t in outs),
                      f"K5 {name} {shape}: non-finite gradients")
                refs = va.biased_attention_bwd_plain(q, k, v, bias, sc, o, g, g_size, cosine)
                floors = va.biased_grad_floors(q, k, v, bias, sc, g, g_size, cosine)
                e, _ = k5_err(outs, refs, floors, dtype, f"K5 {name} {shape} cosine={cosine}")
                _worst(worst, e)
                del outs, again, refs
            _worst(err["K5"].setdefault(name, {}), worst)
            log(f"[kernel] K5 {name:8s} {shape} ({what}), scales to 100, cosine on / off: "
                f"{worst}; twice bit-equal, dbias and dscale included")
            del q, k, v, bias, scale, g
            torch.cuda.empty_cache()
        # the Function's five gradients against f32 autograd through the reference
        for b, nw, h, n, shifted, hd, what in (K5_CASES[1], K5_CASES[5]):
            bh, groups, g_size = swin_fold(b, nw, h, shifted)
            q, k, v, bias, scale, g = _k5_inputs(gen, bh, groups, n, hd, dtype, shifted,
                                                 scale_max=30.0)
            _, got = biased_grads(q, k, v, bias, scale, g, g_size)
            ref = va.biased_attention_bwd_reference(q.float(), k.float(), v.float(), bias, scale,
                                                    None, g.float(), g_size, True)
            check(all(a.dtype == t.dtype and a.shape == t.shape
                      for a, t in zip(got, (q, k, v, bias, scale))),
                  "a gradient did not come back in its input's dtype and shape")
            rel = {n_: ((a.float() - r).abs().max() / r.abs().max()).item()
                   for n_, a, r in zip(va.BIASED_GRAD_NAMES, got, ref)}
            tol = FUNCTION_GRAD_RTOL[dtype]
            check(all(v_ <= tol * (va.DSCALE_BOUND_FACTOR if n_ == "dscale" else 1)
                      for n_, v_ in rel.items()),
                  f"the Function's gradients {name} {what}: {rel} of the largest magnitude from "
                  f"f32 autograd through the reference > {tol} (dscale ten times)")
            err["function"][f"{name} N={n} {'shifted' if shifted else 'unshifted'}"] = rel
            log(f"[kernel] K4 + K5 Function {name:8s} BH={bh} N={n} G={groups}: each gradient "
                f"within {max(rel.values()):.3g} of its largest magnitude of the f32 autograd "
                f"gradients (bound {tol:.3g}, dscale ten times): {rel}")
    return err


def _k5_work(bh, groups, n, hd, dtype):
    """(operations, bytes) of one K5 call: five products of 2 N^2 hd a
    folded row; q, k, v, o, g read and dq, dk, dv written once (eight
    tensors), the bias read and dbias written once, the scales read and
    dscale written once."""
    size = torch.empty((), dtype=dtype).element_size()
    return 10 * bh * n * n * hd, 8 * bh * n * hd * size + 2 * groups * n * n * 4 + 2 * groups * 4


def phase_window_bwd_rates():
    """K5 at the SwinV2-Base shapes at B = 8 (a train step's 24 calls, each
    shape by its block count), bf16 and f32, against its plain version and the
    library call: one scaled_dot_product_attention backward whose float
    attn_mask (the bias, per folded row) needs a gradient."""
    gen = torch.Generator().manual_seed(34)
    b, out = 8, {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        total = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                               "library_device_ms"), 0.0)
        bound_by = {"bytes": 0.0, "operations": 0.0}  # ms of the summed bound by what bounds it
        backend = None
        for nw, h, n, shifted, count in SWIN_SHAPES:
            bh, groups, g_size = swin_fold(b, nw, h, shifted)
            q, k, v, bias, scale, g = _k5_inputs(gen, bh, groups, n, SWIN_HD, dtype, shifted,
                                                 scale_max=30.0)
            with torch.no_grad():
                o = va.biased_attention_fused(q, k, v, bias, scale, g_size, True)
            gidx = va.group_index(bh, groups, g_size, "cuda")
            qf, kf = q.float(), k.float()
            lq = ((qf * va.inv_norm(qf)) * scale[gidx][:, None, None]).to(dtype)[:, None]
            lk = (kf * va.inv_norm(kf)).to(dtype)[:, None]
            leaves = [t.detach().requires_grad_(True)
                      for t in (lq, lk, v[:, None], bias[gidx][:, None].to(dtype))]
            lg = g[:, None]

            def forward_backward():
                out_ = F.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3], scale=1.0)
                torch.autograd.grad(out_, leaves, lg, retain_graph=True)
                return out_

            # the backend the default dispatch picks at the first shape, pinned for
            # all: for the forward, which fixes the backward's kernel, and once
            # outside the timed regions
            backend = backend or sdpa_backend(forward_backward)
            lo = under_backend(backend, forward_backward)
            fns = {"K5": lambda: va.biased_attention_bwd(q, k, v, bias, scale, o, g, g_size, True),
                   "plain": lambda: va.biased_attention_bwd_plain(q, k, v, bias, scale, o, g,
                                                                  g_size, True),
                   "library": lambda: torch.autograd.grad(lo, leaves, lg, retain_graph=True)}
            e, _ = k5_err(fns["K5"](), fns["plain"](),
                          va.biased_grad_floors(q, k, v, bias, scale, g, g_size, True), dtype,
                          f"K5 {name} B={b}")
            with sdpa_pinned(backend):
                ms, _ = _in_turns({"K5": fns["K5"], "library": fns["library"]}, reps=10)
                dev = {key: device_ms(fns[key], reps=10) for key in ("K5", "library")}
            ms.update(_in_turns({"plain": fns["plain"]}, reps=2)[0])
            ops, nbytes = _k5_work(bh, groups, n, SWIN_HD, dtype)
            bound_ms, by = bound(ops, nbytes, name)
            bound_by[by] += count * bound_ms
            shape = (f"B={b} windows={nw} H={h} N={n} "
                     f"{'shifted' if shifted else 'unshifted'} x{count}")
            out[f"{name} {shape}"] = {"ms": ms["K5"], "plain_ms": ms["plain"],
                                      "library_ms": ms["library"], "bound_ms": bound_ms,
                                      "bound_by": by, "agreement": e, "device_ms": dev["K5"],
                                      "library_device_ms": dev["library"]}
            for field, key in (("ms", "K5"), ("plain_ms", "plain"), ("library_ms", "library")):
                total[field] += count * ms[key]
            total["device_ms"] += count * dev["K5"]
            total["library_device_ms"] += count * dev["library"]
            total["bound_ms"] += count * bound_ms
            log(f"[rates] K5 {name:8s} {shape}: {ms['K5']:.3f} ms ({ops / ms['K5'] / 1e9:.1f} "
                f"TFLOP/s of the 10 BH N^2 hd it must do; bound {bound_ms:.3f} ms by {by}) vs "
                f"plain {ms['plain']:.3f} ms, library ({backend}) {ms['library']:.3f} ms; device "
                f"time K5 {dev['K5']:.4f} ms, library {dev['library']:.4f} ms; agreement {e}")
            del q, k, v, bias, scale, g, o, qf, kf, lq, lk, leaves, lo, lg, fns
            torch.cuda.empty_cache()
        library = f"scaled_dot_product_attention backward (mask gradient), {backend} backend"
        out[name] = dict(total, bound_by=max(bound_by, key=bound_by.get), library=library)
        log(f"[rates] K5 {name:8s} the {SWIN_DEPTH} calls of one SwinV2-Base train step at B={b}: "
            f"{total['ms']:.3f} ms (plain {total['plain_ms']:.3f}, library "
            f"{total['library_ms']:.3f}, bound {total['bound_ms']:.3f} by "
            f"{out[name]['bound_by']}); device time K5 {total['device_ms']:.4f} ms, library "
            f"{total['library_device_ms']:.4f} ms; library = {library}")
    return out


def phase_train_swinv2(workdir: Path):
    p, n_train, n_val = 2, 24, 8  # three train steps in epoch 1
    t0 = time.perf_counter()
    data = (*write_synthetic_covidx(str(workdir / "sw_train"), n=n_train, size=256, seed=17),
            *write_synthetic_covidx(str(workdir / "sw_val"), n=n_val, size=256, seed=18))
    pt = str(workdir / "swinv2_train_timm.pt")
    write_swin_checkpoint(pt, seed=33)
    steps = [pk_steps(data[1], p, 4, epoch) for epoch in (1, 2)]
    log(f"[slice] SwinV2 train: wrote {n_train} + {n_val} PNGs and a timm-layout .pt in "
        f"{time.perf_counter() - t0:.1f} s; {steps} train steps in epochs 1, 2")
    start, _ = create_model("swinv2", generator=torch.Generator().manual_seed(0))
    start = load_torch_checkpoint(start, pt).state_dict()
    run = make_trainer(workdir, "swinv2", data, "-p", str(p))
    out = {}
    want = dict.fromkeys(WRAPPERS, 0)
    want.update({"K4": SWIN_DEPTH * steps[0], "K5": SWIN_DEPTH * steps[0]})
    # bf16 takes K4 + K5 in every block; the evaluation embeds in f32, which
    # keeps the eager path; XMIR_SWIN_KERNEL=v1 changes nothing in training
    with env_flags(XMIR_FUSED_ATTN=None, XMIR_SWIN_KERNEL=None):
        reset_launches()
        t0 = time.perf_counter()
        losses, ckpt = run("main", "--bf16", "--epochs", "1", "--resume", pt)
        wall = time.perf_counter() - t0
        launches = read_launches()
        check(launches == want, f"cli.train swinv2: launches {launches}, expected {want} "
                                f"({SWIN_DEPTH} blocks x {steps[0]} steps, forward and backward)")
        check(len(losses) == steps[0], f"{len(losses)} losses for {steps[0]} steps")
        log(f"[slice] cli.train swinv2 --bf16: launches {launches} ({SWIN_DEPTH} blocks x "
            f"{steps[0]} steps, forward and backward; the f32 evaluation eager); losses "
            f"{[round(v, 4) for _, _, v in losses]}; {wall:.1f} s wall")
        out["launches"] = launches
        trained = load_checkpoint(ckpt)
        still = [key for key, v in trained.items() if torch.equal(v, start[key])]
        check(not still, f"parameters that did not move: {still}")
        check(all(torch.isfinite(v).all() for v in trained.values()), "non-finite parameters")
        with env_flags(XMIR_SWIN_KERNEL="v1"):
            reset_launches()
            v1_losses, _ = run("v1", "--bf16", "--epochs", "1", "--resume", pt)
            v1_launches = read_launches()
        check(v1_launches == want and v1_losses == losses,
              f"under XMIR_SWIN_KERNEL=v1 training took launches {v1_launches} (expected {want}) "
              f"and losses {v1_losses} (expected {losses})")
        log(f"[slice] cli.train swinv2 --bf16 under XMIR_SWIN_KERNEL=v1: K6 {v1_launches['K6']}, "
            f"K4 {v1_launches['K4']}, K5 {v1_launches['K5']}; the losses equal the default run's")
        reset_launches()
        _, frozen_ckpt = run("frozen", "--bf16", "--epochs", "1", "--resume", pt,
                             "--freeze-backbone", "--embedding-dim", "64")
        frozen_launches = read_launches()
        check(frozen_launches["K5"] == 0, "the frozen backbone's blocks ran their backward")
        frozen = load_checkpoint(frozen_ckpt)
        fresh64, _ = create_model("swinv2", embedding_dim=64,
                                  generator=torch.Generator().manual_seed(0))
        fresh64 = dict(fresh64.state_dict(), **start)
        for key, v in frozen.items():
            check(torch.equal(v, fresh64[key]) == key.startswith("backbone."),
                  f"--freeze-backbone: {key} " + ("moved" if key.startswith("backbone.")
                                                  else "did not move"))
        log(f"[slice] cli.train swinv2: every tensor moved; under --freeze-backbone the "
            f"backbone's {sum(key.startswith('backbone.') for key in frozen)} tensors did not and "
            f"the head's did (launches {frozen_launches})")
        check_resume(make_trainer(workdir, "swinv2", data, "-p", str(p), "--bf16"), steps,
                     "cli.train swinv2 --bf16", "--resume", pt)
    # f32 under XMIR_FUSED_ATTN=1: every block takes K4 + K5 in f32
    with env_flags(XMIR_FUSED_ATTN="1", XMIR_SWIN_KERNEL=None):
        reset_launches()
        _, f32_ckpt = run("f32", "--epochs", "1", "--resume", pt)
        check(read_launches()["K5"] == SWIN_DEPTH * steps[0], "the f32 steps did not take K5")
        with swin_plain_versions():
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
          f"f32 parameters after {steps[0]} steps with K4 + K5 differ from the plain versions' "
          f"past the bound {TRAIN_F32_MEAN_TOL}: {reading}")
    log(f"[slice] cli.train swinv2 f32 (XMIR_FUSED_ATTN=1), {steps[0]} steps, K4 + K5 against "
        f"their plain versions: {reading} (bound on the first {TRAIN_F32_MEAN_TOL})")
    out["f32_vs_plain"] = reading
    return out


def phase_swin_train_rates():
    """The bf16 SwinV2-Base train step at batch 8, 384 px (f32 master
    weights, triplet loss): with the kernels (K4 + K5 in every block), with
    their plain versions and on the eager path, in turns; peak memory of
    each; where a step's time goes; and the device time by kernel beside the
    host's enqueue time (torch.profiler over one step)."""
    from torch.profiler import ProfilerActivity, profile

    model, _ = create_model("swinv2", generator=torch.Generator().manual_seed(35))
    randomize_swin_(model.backbone, 36)
    model = model.to("cuda").train()
    state = TrainState(model, build_optimizer(model, lr=1e-5))
    step = make_embedding_train_step(model, "triplet", {"margin": 2.0},
                                     compute_dtype=torch.bfloat16)
    x = torch.randn((8, 384, 384, 3), generator=torch.Generator().manual_seed(37)).cuda()
    labels = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], device="cuda")

    def with_kernels():
        return step(state, x, labels)

    def with_plain_versions():
        with swin_plain_versions():
            return step(state, x, labels)

    def eager_path():
        with env_flags(XMIR_FUSED_ATTN="0"):
            return step(state, x, labels)

    def forward_only():
        step.loss_and_aux(x, labels)

    def forward_backward():
        state.optimizer.zero_grad(set_to_none=True)
        step.loss_and_aux(x, labels)[0].backward()

    paths = {"kernels": with_kernels, "plain versions": with_plain_versions, "eager": eager_path}
    out = {}
    with env_flags(XMIR_FUSED_ATTN=None, XMIR_SWIN_KERNEL=None):
        reset_launches()
        loss = with_kernels()["loss"]
        launches = read_launches()
        check(launches["K4"] == launches["K5"] == SWIN_DEPTH,
              f"the bf16 step did not take K4 and K5 in every block: {launches}")
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with_kernels()
            torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    for name in paths:
        out[name] = {"ms": ms[name], "img_per_s": 8 / ms[name] * 1e3, "peak_gib": peak[name]}
    shares = {"forward": ms["forward"], "backward": ms["forward + backward"] - ms["forward"],
              "optimiser": ms["kernels"] - ms["forward + backward"]}
    out["shares_ms"] = shares
    out["enqueue_ms"] = enqueue
    out["profile"] = {"device_ms": sum(r[1] for r in rows), "kernels": sum(r[2] for r in rows),
                      "top": [[n[:90], round(t, 3), c] for n, t, c in rows[:12]]}
    log("[rates] SwinV2-Base bf16 train step, batch 8 @384 (device time): "
        + "; ".join(f"{k} {v['ms']:.2f} ms = {v['img_per_s']:.1f} img/s, peak {v['peak_gib']:.2f} "
                    "GiB" for k, v in out.items() if isinstance(v, dict) and "ms" in v)
        + f"; with the kernels a step is forward {shares['forward']:.2f} ms + backward "
        f"{shares['backward']:.2f} ms + optimiser {shares['optimiser']:.2f} ms, and the host "
        f"enqueues it in {enqueue:.2f} ms; runs "
        f"{({k: [round(t, 2) for t in v] for k, v in runs.items()})}")
    k4_ms, k4_share = kernel_share(rows, K4_BF16_KERNELS)
    k5_ms, k5_share = kernel_share(rows, K5_BF16_KERNELS)
    out["profile"].update(k4_ms=k4_ms, k4_share=k4_share, k5_ms=k5_ms, k5_share=k5_share)
    log(f"[profile] SwinV2-Base bf16 train step with K4 + K5: {out['profile']['device_ms']:.2f} "
        f"ms of device time in {out['profile']['kernels']} kernels, K4 {k4_ms:.3f} ms of it "
        f"({k4_share:.1%}), K5 {k5_ms:.3f} ms ({k5_share:.1%}; {', '.join(K5_BF16_KERNELS)}); "
        "by kernel:")
    for name, t, count in rows[:12]:
        log(f"[profile] {t:8.3f} ms  {count:6d} x  {name[:110]}")
    del model, state, step, x
    torch.cuda.empty_cache()
    return out


# --- main-path step 4: the other explainers, debug_insdel, the demo ----------


def _narrow_explainers(device, explanations=None):
    """SimAtt, SimCAM (narrow DenseNet121) and rollout (narrow DINOv2) maps on
    ``device``, and the AUCs of both curves there of ``explanations`` (the
    SimAtt maps of the retrieved images by default)."""
    from xmir_tpu_torch.models.embedders import DenseNet121Embedder, DinoV2Embedder
    from xmir_tpu_torch.xai import (
        blur_substrate,
        get_feature_head,
        rollout_saliency,
        run_causal_metric_pairs_both,
        simatt_saliency,
        simcam_maps,
        zeros_substrate,
    )

    model = DenseNet121Embedder(12, 3, growth_rate=8, block_config=(2, 2, 2, 2),
                                num_init_features=16,
                                generator=torch.Generator().manual_seed(38)).to(device).eval()
    vit = DinoV2Embedder(16, img_size=56, dim=128, depth=2, num_heads=2,
                         generator=torch.Generator().manual_seed(39)).to(device).eval()
    gen = torch.Generator().manual_seed(40)
    x = torch.randn((3, 64, 64, 3), generator=gen).to(device)
    xv = torch.randn((2, 56, 56, 3), generator=gen).to(device)

    def feats(t):
        with torch.no_grad():
            return model(t)["features"]

    att = simatt_saliency(feats, get_feature_head("densenet121", model), x)
    cam = simcam_maps(feats(x[:1])[0], feats(x[1:]), out_hw=(64, 64))
    with torch.no_grad():
        out = vit(xv, output_attentions=True)
    roll = rollout_saliency(out["attentions"], (56, 56), prefix_tokens=1)
    expl = att[1:] if explanations is None else explanations.to(device)
    d, i = run_causal_metric_pairs_both(make_embed_fn(model), x[0], x[1:], list(expl),
                                        zeros_substrate, blur_substrate(), step=256)
    return [m.cpu() for m in (att, cam, roll)], np.array([a for a, _ in d + i])


def phase_explainers(workdir: Path):
    """SimAtt and SimCAM on DenseNet121 at full width (224 px, f32) and
    attention rollout on DINOv2 ViT-B/14 (518 px) through both saliency
    CLIs; cli.debug_insdel on one DenseNet121 pair; a narrow model's maps and
    AUCs on the card against the CPU; maps/s of each explainer."""
    from xmir_tpu_torch.cli import compute_saliency, debug_insdel, evaluate_saliency

    n, n_q, top_k = 32, 2, 3
    img_dir, manifest = write_synthetic_covidx(str(workdir / "ex"), n=n, size=256, seed=19)
    dense_pt = str(workdir / "densenet121_whitened.pt")
    write_whitened_densenet(dense_pt, img_dir, manifest)
    vit_pt = str(workdir / "dinov2_timm.pt")
    write_vit_checkpoint(vit_pt, seed=41)
    data = ["--dataset", "covid", "--dataset-dir", img_dir, "--test-image-list", manifest,
            "--device", "cuda", "--seed", "0", "-j", "8"]
    dense = data + ["--model", "densenet121", "--embedding-dim", "32", "--resume", dense_pt]
    vit = data + ["--model", "dinov2", "--resume", vit_pt]
    res = workdir / "ex_res"
    test_cli.main(dense + ["--save-dir", str(res)])
    out = {"launches": dict.fromkeys(WRAPPERS, 0), "rates": {}, "aucs": {}}
    for explainer, args, size, step in (("simatt", dense, 224, "1000"),
                                        ("simcam", dense, 224, "1000"),
                                        ("rollout", vit, 518, "10000")):
        extra = ["--results", str(res / "evaluation_results.npz")] if explainer == "simatt" else []
        maps_dir = workdir / f"ex_{explainer}"
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = compute_saliency.main(args + ["--explainer", explainer, "--top-k", str(top_k),
                                              "--limit", str(n_q), "--save-dir", str(maps_dir)]
                                      + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(read_launches().values()), f"{explainer} maps launched a kernel")
        n_maps = 0
        for path in sorted(maps_dir.iterdir()):
            m = np.load(path)
            n_maps += m.shape[0] * (m.shape[1] if m.ndim == 4 else 1)
            check(m.shape[-2:] == (size, size) and np.isfinite(m).all() and (m >= 0).all(),
                  f"{explainer} {path.name}: not finite nonnegative {size} x {size} maps")
        check(count == n_q and len(list(maps_dir.iterdir())) == n_q,
              f"{explainer}: {count} map files")
        reset_launches()
        t1 = time.perf_counter()
        result = evaluate_saliency.main(args + ["--explainer", explainer, "--top-k", str(top_k),
                                                "--limit", str(n_q), "--step", step, "--output",
                                                str(workdir / f"ex_{explainer}.json")])
        eval_wall = time.perf_counter() - t1
        launches = read_launches()
        check(launches["K1"] == 1 and sum(launches.values()) == 1,
              f"cli.evaluate_saliency --explainer {explainer}: launches {launches}, expected K1 "
              "once")
        out["launches"]["K1"] += 1
        aucs = [a for r in result["results"] for a in r["per_pair_del"] + r["per_pair_ins"]]
        check(len(aucs) == 2 * n_q * top_k and all(0.0 <= a <= 1.0 for a in aucs),
              f"{explainer}: AUCs {aucs}")
        out["rates"][explainer] = {"maps_per_s": n_maps / wall, "compute_saliency_s": wall,
                                   "evaluate_saliency_s": eval_wall}
        out["aucs"][explainer] = {"mean_deletion_auc": result["summary"]["mean_deletion_auc"],
                                  "mean_insertion_auc": result["summary"]["mean_insertion_auc"]}
        model = "DINOv2 ViT-B/14 @518" if explainer == "rollout" else "DenseNet121 @224"
        log(f"[slice] {explainer} ({model}, f32): {n_maps} maps in {wall:.2f} s wall through "
            f"cli.compute_saliency = {n_maps / wall:.2f} maps/s (model builds and decode included); "
            f"cli.evaluate_saliency inline over {n_q} queries x top {top_k} in {eval_wall:.1f} s, "
            f"launches {launches}, mean deletion AUC "
            f"{result['summary']['mean_deletion_auc']:.4f}, insertion "
            f"{result['summary']['mean_insertion_auc']:.4f}")
    # cli.debug_insdel on one pair, its neighbour through the index
    reset_launches()
    t0 = time.perf_counter()
    dbg = debug_insdel.main(dense + ["--query-index", "0", "--step", "1000"])
    launches = read_launches()
    check(launches["K1"] == 1 and sum(launches.values()) == 1,
          f"cli.debug_insdel: launches {launches}, expected K1 once")
    out["launches"]["K1"] += 1
    check(np.isfinite(dbg["saliency"]).all() and (dbg["saliency"] >= 0).all()
          and all(0.0 <= dbg[m]["auc"] <= 1.0 for m in ("del", "ins"))
          and dbg["retrieved_index"] != 0, f"cli.debug_insdel: {dbg['retrieved_index']}, "
                                           f"{dbg['del']['auc']}, {dbg['ins']['auc']}")
    out["debug_insdel"] = {"retrieved_index": dbg["retrieved_index"], "del_auc": dbg["del"]["auc"],
                           "ins_auc": dbg["ins"]["auc"], "wall_s": time.perf_counter() - t0}
    log(f"[slice] cli.debug_insdel DenseNet121 @224 pair (0, {dbg['retrieved_index']}): deletion "
        f"AUC {dbg['del']['auc']:.4f}, insertion {dbg['ins']['auc']:.4f} over "
        f"{len(dbg['del']['scores'])} steps each; launches {launches}; "
        f"{out['debug_insdel']['wall_s']:.1f} s wall")
    # the narrow models on the card and on the CPU: the card's own maps ->
    # ranks -> AUCs, held to the CPU's AUCs of those same maps
    cpu_maps, cpu_aucs = _narrow_explainers("cpu")
    gpu_maps, gpu_aucs = _narrow_explainers("cuda")
    _, cpu_aucs_of_gpu_maps = _narrow_explainers("cpu", gpu_maps[0][1:])
    map_err = max((a - c).abs().max().item() / max(c.abs().max().item(), 1e-30)
                  for a, c in zip(gpu_maps, cpu_maps))
    auc_err = float(np.abs(gpu_aucs - cpu_aucs_of_gpu_maps).max())
    check(map_err <= SALIENCY_CPU_TOL and auc_err <= SALIENCY_CPU_TOL,
          f"narrow SimAtt / SimCAM / rollout on the card vs the CPU: maps {map_err} of their "
          f"largest magnitude, the card's AUCs of its maps {auc_err} from the CPU's AUCs of "
          f"them > {SALIENCY_CPU_TOL}")
    # the two devices' maps rank their pixels alike up to near-ties: any pair
    # of pixels that the card's and the CPU's ranks order the other way round
    # lies within the bound in the CPU's map
    flips = [rank_flips(a, c) for a, c in zip(gpu_maps[0][1:], cpu_maps[0][1:])]
    tie_gap = max(gap for _, gap in flips)
    check(tie_gap <= SALIENCY_CPU_TOL, f"the card's SimAtt maps rank pixels {tie_gap} of the "
                                       f"largest magnitude out of the CPU's order")
    own_auc_err = float(np.abs(gpu_aucs - cpu_aucs).max())
    out["card_vs_cpu"] = {"maps": map_err, "aucs_of_the_same_maps": auc_err,
                          "aucs_of_own_maps": own_auc_err,
                          "pixels_ranked_apart": [n_ for n_, _ in flips],
                          "largest_gap_of_a_flipped_pair": tie_gap}
    log(f"[slice] narrow SimAtt, SimCAM (DenseNet121) and rollout (DINOv2), card vs CPU: maps "
        f"within {map_err:.3g} of their largest magnitude; the card's AUCs of its own SimAtt "
        f"maps within {auc_err:.3g} of the CPU's AUCs of those maps (bound {SALIENCY_CPU_TOL}); "
        f"{[n_ for n_, _ in flips]} pixels ranked apart, every flipped pair within "
        f"{tie_gap:.3g} of the largest magnitude in the CPU's map (near-ties; bound "
        f"{SALIENCY_CPU_TOL}); each device's AUCs of its own maps {own_auc_err:.3g} apart")
    return out


def rank_flips(a, c):
    """(pixels whose ``saliency_rank`` differs between maps ``a`` and ``c``,
    the largest gap in ``c``, of its largest magnitude, between two pixels
    that ``a``'s order puts the other way round)."""
    from xmir_tpu_torch.xai import saliency_rank

    ra, rc = saliency_rank(a.cpu()), saliency_rank(c)
    along = c.reshape(-1)[torch.argsort(ra)]  # c in a's order, most salient first
    gap = (along - torch.cummin(along, dim=0).values).max().item()
    return int((ra != rc).sum()), gap / max(c.abs().max().item(), 1e-30)


def phase_demo(workdir: Path):
    """The end-to-end demo on the card: train -> test -> ingest -> query ->
    evaluate_saliency through the port's CLIs on its synthetic COVIDx."""
    from xmir_tpu_torch import demo_end_to_end

    reset_launches()
    t0 = time.perf_counter()
    summary = demo_end_to_end.main(["--workdir", str(workdir / "demo"), "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    maps = summary["eval_mAP_by_epoch"]
    aucs = [a for r in summary["insdel"]["results"] for a in r["per_pair_del"] + r["per_pair_ins"]]
    check(summary["platform"] == "cuda" and len(maps) == summary["epochs"] + 1
          and all(np.isfinite(m) for m in maps), f"demo summary: {summary['platform']}, {maps}")
    check(aucs and all(0.0 <= a <= 1.0 for a in aucs), f"demo AUCs {aucs}")
    check(launches["K1"] >= 2 and sum(launches.values()) == launches["K1"],
          f"demo launches {launches}: K1 for the query and the evaluation, nothing else")
    log(f"[slice] demo_end_to_end --device cuda: {wall:.1f} s wall; mAP by epoch {maps}; top-1 "
        f"label accuracy {summary['top1_label_accuracy_pct']:.1f}%; mean deletion AUC "
        f"{summary['insdel']['summary']['mean_deletion_auc']:.4f}, insertion "
        f"{summary['insdel']['summary']['mean_insertion_auc']:.4f}; launches {launches}")
    return {"launches": launches, "wall_s": wall, "eval_mAP_by_epoch": maps}


# --- NIH dual-head models and distillation -------------------------------------

NIH_TRAIN, NIH_VAL = 24, 16  # -p 2 -k 4: 3 train steps an epoch, 2 evaluation batches of 8


def nih_label_set(i: int):
    """The pathologies of the i-th generated NIH file: three at fixed
    offsets along the 14, so 24 files give each pathology 4 to 6 images
    (the multi-label sampler draws 4 a pathology); "Pleural Thickening" is
    written as its alias "pleural_thickening" in every other file."""
    names = [NIH_RETRIEVAL_PATHOLOGIES[(i + shift) % 14] for shift in (0, 5, 9)]
    if i % 2:
        names = ["pleural_thickening" if n == "Pleural Thickening" else n for n in names]
    return names


def write_nih_tree(root: Path, n: int, seed: int, size: int = 256):
    """``n`` NIH-format files, ``Chest_X-ray_<URL-encoded A|B|C>_<i>.npy``
    (grey float32 size x size: 8 x 8 blocks of noise plus fine noise),
    labelled by nih_label_set from ``seed`` on. Returns (the directory, ""
    for the manifest: the dataset walks the directory)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = np.kron(rng.standard_normal((size // 8, size // 8)), np.ones((8, 8)))
        img += 0.1 * rng.standard_normal((size, size))
        name = quote("|".join(nih_label_set(i + seed)))
        np.save(root / f"Chest_X-ray_{name}_{i}.npy", img.astype(np.float32))
    return str(root), ""


def check_multilabel_evaluation(save_dir, metrics, n, dim):
    """cli.test's multi-label artifact: shapes, finite values, and the
    metrics equal to what numpy makes of the artifact's own embeddings and
    labels (float64 cosine, diagonal -inf), wherever no two scores of a row
    lie within 1e-6 of each other (where they do, the two rankings may
    differ)."""
    art = np.load(os.path.join(save_dir, "evaluation_results.npz"))
    embeds, labels = art["embeds"], art["labels"]
    check(embeds.shape == (n, dim) and labels.shape == (n, 14) and "dists" not in art.files,
          f"artifact shapes {embeds.shape}, {labels.shape}, files {art.files}")
    check(np.isfinite(embeds).all() and set(np.unique(labels)) <= {0.0, 1.0}, "bad artifact")
    stored = json.loads(str(art["metrics"]))
    check(stored == json.loads(json.dumps(metrics, default=float)), "artifact metrics != returned")
    e = embeds.astype(np.float64)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    sims = e @ e.T
    np.fill_diagonal(sims, -np.inf)
    again = test_cli.multilabel_metrics(sims, labels)
    off = np.sort(sims[~np.eye(n, dtype=bool)].reshape(n, n - 1), axis=1)
    gap = np.diff(off, axis=1).min()
    diff = max(abs(stored[k] - v) for k, v in again.items())
    check(set(again) == set(stored) and all(np.isfinite(list(stored.values()))),
          "missing or non-finite metrics")
    check(gap <= 1e-6 or diff <= 1e-9, f"the metrics lie {diff} from numpy's")
    log(f"[slice] cli.test nih: evaluation_results.npz holds {len(stored)} finite multi-label "
        f"metrics (mAP@jaccard>0.25 {stored['mAP@jaccard>0.25']:.2f}, P@1 {stored['P@1']:.2f}) "
        f"{'equal to' if gap > 1e-6 else f'within {diff:.3g} of'} numpy's (least score gap "
        f"{gap:.3g})")
    return stored


def k1_bit_equal_at(q_n, n, d, k):
    """K1 (fused_topk_scores) against its plain version on integer inputs
    with ties at every edge of its plan, f32 and bf16: ids and values bit
    for bit."""
    gen = torch.Generator().manual_seed(q_n + n + d)
    for dtype in (torch.float32, torch.bfloat16):
        q, g = _int_inputs(gen, q_n, n, d, k, dtype)
        bias = torch.zeros(n, device="cuda")
        v, i = fused_topk_scores(q, g, bias, k)
        rv, ri = topk_scores_reference(q, g, bias, k)
        check(torch.equal(v, rv) and torch.equal(i, ri),
              f"K1 at D = {d}: not bit-equal to its plain version ({dtype}, Q={q_n} N={n} k={k})")


def phase_train_nih(workdir: Path):
    p = 2
    t0 = time.perf_counter()
    data = (*write_nih_tree(workdir / "n_train", NIH_TRAIN, seed=40),
            *write_nih_tree(workdir / "n_val", NIH_VAL, seed=41))
    pt = str(workdir / "nih_vit_timm.pt")
    write_vit_checkpoint(pt, seed=31)
    steps, eval_batches = [NIH_TRAIN // (p * 4)] * 2, -(-NIH_VAL // 8)
    train_ds = common.build_dataset(argparse.Namespace(
        dataset="nih", dataset_dir=data[0], train_image_list=""), "train")
    counts = train_ds.labels.sum(0)
    aliased = sum("pleural_thickening" in name for name in train_ds.image_names)
    log(f"[slice] NIH: wrote {NIH_TRAIN} + {NIH_VAL} .npy files ({int(counts.min())} to "
        f"{int(counts.max())} training images a pathology, {aliased} naming the alias "
        f"pleural_thickening) and a timm-layout .pt in {time.perf_counter() - t0:.1f} s")
    check(counts.min() >= 4 and aliased > 0, f"pathology counts {counts}, {aliased} aliases")
    start, _ = create_model("nih_dinov2", generator=torch.Generator().manual_seed(0))
    start = load_torch_checkpoint(start, pt).state_dict()
    dual = ("-p", str(p), "--loss-name", "dual_branch")
    run = make_trainer(workdir, "nih_dinov2", data, *dual, dataset="nih")
    out, paths = {}, {}
    # as phase_train_dinov2: the bf16 step takes K7 + K2 + K3 by the default
    # rule, the f32 evaluation K7 + K2 under the switches
    with env_flags(XMIR_FUSED_LN_MLP=None, **FUSED_VIT):
        reset_launches()
        t0 = time.perf_counter()
        main_run = run("main", "--bf16", "--epochs", "1", "--resume", pt)
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = dict.fromkeys(WRAPPERS, 0)
        forwards = steps[0] + eval_batches
        want.update({"K2": VIT["depth"] * forwards, "K7": VIT["depth"] * forwards,
                     "K3": VIT["depth"] * steps[0]})
        check(launches == want, f"cli.train nih_dinov2: launches {launches}, expected {want}")
        losses, ckpt = main_run
        check(len(losses) == steps[0] and all(len(r) == 5 for r in losses),
              f"{len(losses)} losses for {steps[0]} steps, or no contrastive / asl logged")
        check(all(abs(r[2] - r[3] - r[4]) <= 1e-5 * (1 + abs(r[2])) for r in losses),
              f"loss != contrastive + asl (--dual-asl-alpha 1): {losses}")
        log(f"[slice] cli.train nih_dinov2 --dataset nih --loss-name dual_branch --bf16: launches "
            f"{launches} ({VIT['depth']} blocks x ({steps[0]} train steps + {eval_batches} "
            f"evaluation batches) forwards, x {steps[0]} backwards); (loss, contrastive, asl) "
            f"{[tuple(round(v, 4) for v in r[2:]) for r in losses]}; {wall:.1f} s wall")
        paths["nih_dinov2_train"] = launches
        trained = load_checkpoint(ckpt)
        still = [key for key, v in trained.items() if torch.equal(v, start[key])]
        check(not still, f"parameters that did not move: {still}")
        check(all(torch.isfinite(v).all() for v in trained.values()), "non-finite parameters")
        log(f"[slice] cli.train nih_dinov2: all {len(trained)} tensors moved, the backbone's and "
            "the head's")
        check_resume(make_trainer(workdir, "nih_dinov2", data, *dual, "--bf16", dataset="nih"),
                     steps, "cli.train nih_dinov2 --bf16 dual_branch", "--resume", pt,
                     first_run=main_run)
        reading = f32_kernels_against_plain(run, pt, start, steps[0])
        check(reading["mean_apart_of_mean_moved"] <= TRAIN_F32_MEAN_TOL,
              f"nih_dinov2 f32 parameters with the kernels differ from the plain versions' past "
              f"the bound {TRAIN_F32_MEAN_TOL}: {reading}")
        log(f"[slice] cli.train nih_dinov2 f32 dual_branch, {steps[0]} steps, kernels against "
            f"their plain versions: {reading} (bound on the first {TRAIN_F32_MEAN_TOL})")
        out["f32_vs_plain"] = reading
        # serving the trained checkpoint: cli.test, then ingest -> query (a
        # 256-d gallery: K1 at D = 256), f32 with K7 + K2 under the switches
        serve = ["--dataset", "nih", "--model", "nih_dinov2", "--device", "cuda", "--resume",
                 ckpt, "-j", "8"]
        reset_launches()
        save = str(workdir / "n_test")
        metrics = test_cli.main(serve + ["--dataset-dir", data[2], "--test-image-list", "",
                                         "--eval-batch-size", "8", "--save-dir", save])
        paths["nih_dinov2_test"] = read_launches()
        check(paths["nih_dinov2_test"]["K2"] == VIT["depth"] * eval_batches,
              f"cli.test nih_dinov2: launches {paths['nih_dinov2_test']}")
        out["metrics"] = check_multilabel_evaluation(save, metrics, NIH_VAL, 256)
        gal, hits = str(workdir / "n_gallery.npz"), str(workdir / "n_hits.json")
        calls = []
        reset_launches()
        with record_searches(calls):
            ingest.main(serve + ["--dataset-dir", data[0], "--train-image-list", "", "--split",
                                 "train", "--batch-size", "64", "--output", gal])
            results = query.main(serve + ["--dataset-dir", data[2], "--test-image-list", "",
                                          "--split", "test", "--batch-size", "64", "--index", gal,
                                          "--top-k", "10", "--output", hits])
        serving = read_launches()
    check(serving["K1"] == 1 and serving["K7"] == serving["K2"] == 2 * VIT["depth"],
          f"nih_dinov2 ingest -> query: launches {serving}")
    check(all(len(r["query_label"]) == 14 and len(r["results"][0]["label"]) == 14
              for r in results), "the hits do not carry the multi-hot labels")
    out["hits_err"] = check_hits(calls, results, NIH_TRAIN, NIH_VAL, 256)
    paths["nih_dinov2_serving"] = serving
    k1_bit_equal_at(NIH_VAL, NIH_TRAIN, 256, 10)
    k1_bit_equal_at(64, 4099, 256, 10)
    log(f"[slice] nih_dinov2 ingest -> query: launches {serving}; K1 at D = 256 bit-equal to its "
        "plain version on integer inputs (Q=16 N=24 and Q=64 N=4099, k=10, f32 and bf16)")
    # nih_convnextv2: K9 + K10 in the blocks the training gate fuses
    with env_flags(XMIR_FUSED_MLP=None):
        reset_launches()
        t0 = time.perf_counter()
        losses, ckpt_c = make_trainer(workdir, "nih_convnextv2", data, *dual, dataset="nih")(
            "nih_convnextv2", "--bf16", "--epochs", "1")
        wall = time.perf_counter() - t0
        launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want.update({"K9": FUSED_TRAIN_BLOCKS * steps[0], "K10": FUSED_TRAIN_BLOCKS * steps[0]})
    check(launches == want, f"cli.train nih_convnextv2: launches {launches}, expected {want}")
    trained = load_checkpoint(ckpt_c)
    fresh, _ = create_model("nih_convnextv2", generator=torch.Generator().manual_seed(0))
    still = [k for k, v in fresh.state_dict().items() if torch.equal(v, trained[k])]
    check(not still and len(losses) == steps[0], f"nih_convnextv2: tensors that did not move "
                                                 f"{still}, {len(losses)} losses")
    log(f"[slice] cli.train nih_convnextv2 --dataset nih --loss-name dual_branch --bf16: "
        f"launches {launches} ({FUSED_TRAIN_BLOCKS} fused blocks x {steps[0]} steps); (loss, "
        f"contrastive, asl) {[tuple(round(v, 4) for v in r[2:]) for r in losses]}; every tensor "
        f"moved; {wall:.1f} s wall")
    paths["nih_convnextv2_train"] = launches
    out["launches"] = paths
    return out


DISTILL_BATCH = 16  # PK 4 x 4: the ConvNeXtV2 train step's batch (convnext_block_pallas.py:285)


def distill_model(name, seed):
    """``name`` (convnextv2_*_distill) at full width on the card in training
    mode: seeded weights, the student's embedding as wide as the teacher's
    CLS (768: the distillation term is their inner product), the teacher's
    LayerScale at 0.5 (at its 1e-5 init the blocks all but vanish)."""
    model, _ = create_model(name, embedding_dim=768, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for key, p in model.teacher.named_parameters():
            if key.endswith(".gamma"):
                p.fill_(0.5)
    return model.to("cuda", memory_format=torch.channels_last).train()


def distill_batch(seed):
    x = torch.randn((DISTILL_BATCH, 384, 384, 3), generator=torch.Generator().manual_seed(seed))
    return x.cuda(), torch.arange(4, device="cuda").repeat_interleave(4)


def distill_steps(name, seed, steps):
    """``steps`` bf16 distillation steps (triplet, margin 2, distill weight 1)
    of ``name`` from seeded weights. Returns (metrics, launches, peak GiB,
    moved student tensors of all, teacher tensors that moved)."""
    model = distill_model(name, seed)
    state = TrainState(model, build_optimizer(model, lr=1e-4,
                                              backbone_prefixes=train_cli.BACKBONE_PREFIXES))
    step = make_distill_train_step(model, "triplet", 1.0, {"margin": 2.0},
                                   compute_dtype=torch.bfloat16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    metrics = [step(state, *distill_batch(seed + i)) for i in range(steps)]
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = [{k: v.item() for k, v in m.items()} for m in metrics]
    after = model.state_dict()
    student = [k for k in after if k.startswith("student.")]
    moved = sum(not torch.equal(after[k], before[k]) for k in student)
    teacher_moved = [k for k in after if k.startswith("teacher.")
                     and not torch.equal(after[k], before[k])]
    del model, state, step
    torch.cuda.empty_cache()
    return metrics, launches, peak, (moved, len(student)), teacher_moved


def phase_distill(workdir: Path):
    out, paths = {}, {}
    with env_flags(XMIR_FUSED_MLP=None, XMIR_FLASH_ATTN=None, XMIR_FUSED_LN=None,
                   XMIR_FUSED_LN_QKV=None, XMIR_FUSED_LN_MLP=None):
        t0 = time.perf_counter()
        metrics, launches, peak, moved, teacher_moved = distill_steps(
            "convnextv2_dino_distill", 60, 3)
        wall = time.perf_counter() - t0
        want = dict.fromkeys(WRAPPERS, 0)
        want.update({"K9": FUSED_TRAIN_BLOCKS * 3, "K10": FUSED_TRAIN_BLOCKS * 3,
                     "K7": VIT["depth"] * 3, "K2": VIT["depth"] * 3})
        check(launches == want, f"distill steps: launches {launches}, expected {want} (the "
                                "frozen teacher: K7 + K2 forward, no K3)")
        check(all(np.isfinite(list(m.values())).all() and 0.0 <= m["distill"] <= 2.0
                  for m in metrics), f"distill metrics {metrics}")
        check(not teacher_moved and moved[0] == moved[1],
              f"teacher tensors that moved {teacher_moved}; student moved {moved}")
        log(f"[slice] convnextv2_dino_distill (ConvNeXtV2-Base student @384, ViT-B/14 teacher "
            f"@518), 3 bf16 distillation steps at batch {DISTILL_BATCH}: launches {launches} "
            f"({FUSED_TRAIN_BLOCKS} fused student blocks x 3 forward and backward, "
            f"{VIT['depth']} teacher blocks x 3 forward, no K3); (loss, aux, distill) "
            f"{[tuple(round(v, 4) for v in m.values()) for m in metrics]}; the teacher's "
            f"tensors bit-equal, all {moved[1]} of the student's moved; peak {peak:.2f} GiB; "
            f"{wall:.1f} s wall")
        paths["distill_steps"] = launches
        out["steps"] = {"metrics": metrics, "peak_gib": peak}
        metrics, launches, peak, moved, teacher_moved = distill_steps(
            "convnextv2_raddino_distill", 70, 1)
        # the RAD-DINO conversion's f32 constants promote the teacher's input
        # to f32 (as in the JAX module), so its blocks keep the f32 eager path
        want = dict.fromkeys(WRAPPERS, 0)
        want.update({"K9": FUSED_TRAIN_BLOCKS, "K10": FUSED_TRAIN_BLOCKS})
        check(launches == want, f"raddino distill step: launches {launches}, expected {want}")
        check(np.isfinite(list(metrics[0].values())).all() and 0 <= metrics[0]["distill"] <= 2
              and not teacher_moved and moved[0] == moved[1],
              f"raddino distill step: {metrics}, teacher moved {teacher_moved}, student {moved}")
        log(f"[slice] convnextv2_raddino_distill, one bf16 step: launches {launches} (the "
            f"teacher in f32 on the eager path: its input is f32 after the RAD-DINO "
            f"conversion); (loss, aux, distill) {tuple(round(v, 4) for v in metrics[0].values())};"
            f" teacher bit-equal; peak {peak:.2f} GiB")
        paths["raddino_distill_step"] = launches
    # cli.train as the JAX CLI runs a distillation model: the embedding step,
    # the student alone (K9 + K10), no teacher; the f32 evaluation plain
    p, n_train, n_val = 2, 16, 8
    data = (*write_synthetic_covidx(str(workdir / "ds_train"), n=n_train, size=256, seed=16),
            *write_synthetic_covidx(str(workdir / "ds_val"), n=n_val, size=256, seed=17))
    steps = pk_steps(data[1], p, 4, 1)
    with env_flags(XMIR_FUSED_MLP=None):
        reset_launches()
        t0 = time.perf_counter()
        losses, ckpt = make_trainer(workdir, "convnextv2_dino_distill", data, "-p", str(p))(
            "distill", "--bf16", "--epochs", "1")
        wall = time.perf_counter() - t0
        launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want.update({"K9": FUSED_TRAIN_BLOCKS * steps, "K10": FUSED_TRAIN_BLOCKS * steps})
    check(launches == want and len(losses) == steps,
          f"cli.train convnextv2_dino_distill: launches {launches}, expected {want}")
    trained = load_checkpoint(ckpt)
    fresh, _ = create_model("convnextv2_dino_distill", generator=torch.Generator().manual_seed(0))
    for key, v in fresh.state_dict().items():
        check(torch.equal(v, trained[key]) == key.startswith("teacher."),
              f"cli.train convnextv2_dino_distill: {key} "
              + ("moved" if key.startswith("teacher.") else "did not move"))
    log(f"[slice] cli.train convnextv2_dino_distill --bf16: launches {launches} (K7 = K2 = 0: no "
        f"teacher in the embedding step), losses {[round(r[2], 4) for r in losses]}; the "
        f"teacher's tensors kept their init, every student tensor moved; {wall:.1f} s wall")
    paths["distill_cli_train"] = launches
    # the student serves: ingest -> query under XMIR_FUSED_MLP=1 (K9 in f32)
    gal, hits = str(workdir / "ds_gallery.npz"), str(workdir / "ds_hits.json")
    serve = ["--dataset", "covid", "--model", "convnextv2_dino_distill", "--device", "cuda",
             "--resume", ckpt, "-j", "8", "--batch-size", "16"]
    calls = []
    with env_flags(XMIR_FUSED_MLP="1"):
        reset_launches()
        with record_searches(calls):
            ingest.main(serve + ["--dataset-dir", data[0], "--train-image-list", data[1],
                                 "--split", "train", "--output", gal])
            results = query.main(serve + ["--dataset-dir", data[2], "--test-image-list", data[3],
                                          "--split", "test", "--index", gal, "--top-k", "5",
                                          "--output", hits])
        serving = read_launches()
    batches = -(-n_train // 16) + -(-n_val // 16)
    check(serving["K9"] == DEPTH * batches and serving["K1"] == 1
          and serving["K7"] == serving["K2"] == 0, f"distill ingest -> query: launches {serving}")
    out["hits_err"] = check_hits(calls, results, n_train, n_val, 1024)
    log(f"[slice] convnextv2_dino_distill ingest -> query with the student: launches {serving}")
    paths["distill_serving"] = serving
    out["launches"] = paths
    return out


def step_reading(label, fns, batch):
    """A train step's readings: CUDA events in turns with its parts (fns
    {"step": fn, part: fn, ...}), its device time (device_ms, where the host
    can enqueue a step within the spin), the host's enqueue time of three
    steps a step, its peak memory; and, where torch.profiler's records hold
    TRACE_MIN_SHARE of the step's device time (its events time where
    device_ms cannot read it), the device time of each part by its
    records."""
    step = fns["step"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms, runs = _in_turns(fns, rounds=3, reps=2)
    try:
        dev = device_ms(step, reps=2)
    except SpinTooShort as e:
        dev = None
        log(f"[rates] {label}: device_ms not measured ({e})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step()
    enqueue = (time.perf_counter() - t0) / 3 * 1e3
    torch.cuda.synchronize()
    held = sum(profiled_split(step, reps=2).values())
    whole = dev if dev is not None else ms["step"]
    parts = None
    if held >= TRACE_MIN_SHARE * whole:
        parts = {name: sum(profiled_split(fn, reps=2).values())
                 for name, fn in fns.items() if name != "step"}
    out = {"ms": ms["step"], "img_per_s": batch / ms["step"] * 1e3, "device_ms": dev,
           "enqueue_ms": enqueue, "peak_gib": peak, "traced_ms": held,
           "parts_ms_events": {k: v for k, v in ms.items() if k != "step"},
           "parts_ms_device": parts}
    log(f"[rates] {label}: {ms['step']:.2f} ms a step by CUDA events = "
        f"{out['img_per_s']:.1f} img/s; device_ms "
        + ("not measured" if dev is None else f"{dev:.2f}")
        + f"; the host enqueues a step in {enqueue:.2f} ms; peak {peak:.2f} GiB; parts by events "
        f"{({k: round(v, 2) for k, v in out['parts_ms_events'].items()})}; the profiler's records "
        f"hold {held:.2f} ms ({held / whole:.0%} of the step's "
        f"{'device time' if dev is not None else 'events time'}): parts by device time "
        + ("not measured (the trace is incomplete)" if parts is None
           else str({k: round(v, 2) for k, v in parts.items()}))
        + f"; runs {({k: [round(t, 2) for t in v] for k, v in runs.items()})}")
    return out


def phase_nih_distill_rates():
    """The bf16 dual-branch step (nih_dinov2, batch 8, 518 px) and the bf16
    distillation step (convnextv2_dino_distill, batch 16: the student at
    384 px, the teacher at 518) by step_reading; the distillation step split
    into the teacher's forward, the student's forward + backward and the
    optimiser."""
    from torch.func import functional_call

    from xmir_tpu_torch.losses import triplet_margin_loss
    from xmir_tpu_torch.models.embedders import teacher_input

    out = {}
    with env_flags(XMIR_FUSED_MLP=None, XMIR_FLASH_ATTN=None, XMIR_FUSED_LN=None,
                   XMIR_FUSED_LN_QKV=None, XMIR_FUSED_LN_MLP=None):
        model, _ = create_model("nih_dinov2", generator=torch.Generator().manual_seed(80))
        with torch.no_grad():
            for key, p in model.named_parameters():
                if key.endswith(".gamma"):
                    p.fill_(0.5)
        model = model.to("cuda").train()
        state = TrainState(model, build_optimizer(model, lr=1e-5,
                                                  backbone_prefixes=train_cli.BACKBONE_PREFIXES))
        step = make_dual_branch_train_step(model, compute_dtype=torch.bfloat16)
        x = torch.randn((8, 518, 518, 3), generator=torch.Generator().manual_seed(81)).cuda()
        y = torch.zeros((8, 14), device="cuda")
        y[torch.arange(8), torch.tensor([0, 0, 1, 1, 2, 2, 3, 3])] = 1.0
        y[::3, 12] = 1.0

        def forward_backward():
            state.optimizer.zero_grad(set_to_none=True)
            step.losses(x, y)[0].backward()

        reset_launches()
        step(state, x, y)
        launches = read_launches()
        check(launches["K7"] == launches["K2"] == launches["K3"] == VIT["depth"],
              f"the dual-branch step did not take K7, K2 and K3 in every block: {launches}")
        out["dual_branch"] = step_reading(
            "nih_dinov2 bf16 dual-branch step, batch 8 @518",
            {"step": lambda: step(state, x, y), "forward": lambda: step.losses(x, y),
             "forward + backward": forward_backward,
             "optimiser": lambda: state.optimizer.step()}, 8)
        del model, state, step, x
        torch.cuda.empty_cache()

        model = distill_model("convnextv2_dino_distill", 82)
        state = TrainState(model, build_optimizer(model, lr=1e-5,
                                                  backbone_prefixes=train_cli.BACKBONE_PREFIXES))
        step = make_distill_train_step(model, "triplet", 1.0, {"margin": 2.0},
                                       compute_dtype=torch.bfloat16)
        x, labels = distill_batch(83)
        xb = x.to(torch.bfloat16)
        teacher16 = {k: v.to(torch.bfloat16) for k, v in model.teacher.named_parameters()}
        with torch.no_grad():
            t = l2_normalize(functional_call(model.teacher, teacher16,
                                             (teacher_input(xb, 518),))["cls"]).float()

        def teacher_forward():
            with torch.no_grad():
                functional_call(model.teacher, teacher16, (teacher_input(xb, 518),))

        def student_forward_backward():
            state.optimizer.zero_grad(set_to_none=True)
            tensors = {k: v.to(torch.bfloat16) for k, v in model.student.named_parameters()}
            e = functional_call(model.student, tensors, (xb,))["embedding"].float()
            loss, _ = triplet_margin_loss(e, labels, margin=2.0)
            (loss + torch.mean(1.0 - torch.sum(e * t, dim=1))).backward()

        out["distill"] = step_reading(
            f"convnextv2_dino_distill bf16 distillation step, batch {DISTILL_BATCH} (student "
            "@384, teacher @518)",
            {"step": lambda: step(state, x, labels), "teacher forward": teacher_forward,
             "student forward + backward": student_forward_backward,
             "optimiser": lambda: state.optimizer.step()}, DISTILL_BATCH)
        del model, state, step, x, xb, teacher16
        torch.cuda.empty_cache()
    return out


# SigLIP SO400M (xmir_tpu/models/siglip.py:248-261): 1152 wide, 27 layers, 16
# heads of 72; MedSigLIP at 448 px (1024 tokens), ConceptCLIP at 384 (729), the
# text tower's 64 tokens. BiomedCLIP's image tower (biomedclip.py:27-34): a
# ViT-B/16 at 224 px, 197 tokens, 12 blocks, 12 heads of 64
SIGLIP = dict(c=1152, heads=16, depth=27)
BIOMEDCLIP_DEPTH = 12


def phase_kernel_siglip():
    """K7 at SigLIP's C = 1152 (3C = 3456 columns: the last 256-column tile
    half full, tiles straddling q / k / v and 72-lane heads) and at
    BiomedCLIP's C = 768, N = 197; K2 at head width 72 at the towers' shapes;
    and ptxas's report of the build: no product serialised (C75xx)."""
    gen = torch.Generator().manual_seed(34)
    c, h = SIGLIP["c"], SIGLIP["heads"]
    hd = c // h
    ln_cases = [(16, 1024, c, h, "MedSigLIP-448, B 16"), (4, 729, c, h, "ConceptCLIP-384, B 4"),
                (8, 64, c, h, "SigLIP text, B 8")] + [
        (2, n, c, h, "ragged N") for n in (1, 63, 65, 197)] + [
        (4, 197, 768, 12, "BiomedCLIP ViT-B/16, B 4")]
    attn_cases = [(256, 1024, hd, "MedSigLIP-448, B 16"), (64, 729, hd, "ConceptCLIP-384, B 4"),
                  (128, 64, hd, "SigLIP text, B 8")]
    err = {"K2": {}, "K7": {}, "K7 last tile and head edges": {}}
    # v's heads 14 and 15 hold the last tile's columns 3328..3455; lanes 0, 1,
    # 70 and 71 of every head sit on a head boundary
    lanes = [0, 1, hd - 2, hd - 1]
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            for b, n, cc, heads, what in ln_cases:
                x, lns, lnb, w, bias = _ln_inputs(gen, b, n, cc, 3 * cc, dtype)
                out = ld.ln_qkv_fused(x, lns, lnb, w, bias, heads)
                check(all(torch.equal(o, a) for o, a in
                          zip(out, ld.ln_qkv_fused(x, lns, lnb, w, bias, heads))),
                      f"K7 {name} {what}: two runs differ")
                ref = ld.ln_qkv_reference(x, lns, lnb, w, bias, heads)
                label = f"K7 {name} B={b} N={n} C={cc} H={heads}"
                e7 = {}
                for o, r in zip(out, ref):
                    _worst(e7, vit_err(o, r, ld.agreement, label))
                _worst(err["K7"].setdefault(name, {}), e7)
                edge = ""
                if cc == c:
                    e_edge = vit_err(out[2][:, 14:], ref[2][:, 14:], ld.agreement,
                                     f"{label}: the last column tile")
                    for o, r in zip(out, ref):
                        _worst(e_edge, vit_err(o[..., lanes], r[..., lanes], ld.agreement,
                                               f"{label}: head boundary lanes"))
                    _worst(err["K7 last tile and head edges"].setdefault(name, {}), e_edge)
                    edge = f"; the last tile and head boundary lanes {e_edge}"
                log(f"[kernel] K7 {name:8s} B={b:2d} N={n:4d} C={cc} H={heads} ({what}): "
                    f"{e7}{edge}; twice bit-equal")
                del x, w, out, ref
            for bh, n, hd_, what in attn_cases:
                q, k, v = _attn_inputs(gen, bh, n, hd_, dtype)
                sc = hd_ ** -0.5
                out = va.vit_attention_fused(q, k, v, sc)
                check(torch.equal(out, va.vit_attention_fused(q, k, v, sc)),
                      f"K2 {name} {what}: two runs differ")
                e = vit_err(out, va.attention_plain(q, k, v, sc), k2_agreement(q, k, v, sc),
                            f"K2 {name} BH={bh} N={n} hd={hd_}")
                _worst(err["K2"].setdefault(name, {}), e)
                log(f"[kernel] K2 {name:8s} BH={bh:3d} N={n:4d} hd={hd_} ({what}): {e}; "
                    "twice bit-equal")
                del q, k, v, out
            torch.cuda.empty_cache()
    err["ptxas C75xx"] = found = ptxas_serialisations()
    for src, lines in found.items():
        log(f"[kernel] build.log: ptxas reports {len(lines)} C75xx line(s) for {src}: "
            + " | ".join(lines))
    mine = {src: lines for src, lines in found.items() if src in ("ln_dense.cu", "vit_attn.cu")}
    check(not mine, f"ptxas serialised K7 / K8 or K2 wgmma products: {mine}")
    log("[kernel] build.log: no C75xx for ln_dense.cu (K7, K8) or vit_attn.cu (K2)")
    return err


def ptxas_serialisations():
    """{source file: its C75xx lines} in this build's build.log: where ptxas
    serialised wgmma products (C7518 ...) or injected a warpgroup wait
    (C7517). The log holds each source's ptxas report after its nvcc
    command."""
    text = (_build.BUILD_ROOT / _build._source_hash() / "build.log").read_text()
    found, src = {}, None
    for line in text.splitlines():
        if line.startswith("$ "):
            src = Path(line.split()[-1]).name
        elif "C75" in line:
            found.setdefault(src, []).append(line.strip())
    return found


def randomize_norms_(module, seed):
    """Random nonzero LayerNorm and bias tensors (at init they are 1 and 0,
    which would leave those terms of the kernels unchecked)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif "norm" in name.lower():
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=gen))
    return module


def write_siglip_checkpoint(path, seed):
    """google/medsiglip-448's vision tower in HF SiglipVisionModel's layout
    (``vision_model.`` keys, the position_ids buffer some HF versions save)
    with random nonzero LayerNorm and bias tensors."""
    tower = randomize_norms_(siglip_model.medsiglip_448_vision(
        torch.Generator().manual_seed(seed)), seed + 1)
    sd = {f"vision_model.{k}": v for k, v in tower.state_dict().items()}
    sd["vision_model.embeddings.position_ids"] = torch.arange(1024)[None]
    torch.save(sd, path)


def write_vocab(path, texts):
    """A BERT vocab.txt of the special tokens and every basic token of
    ``texts``: WordPiece then keeps each word whole."""
    from xmir_tpu_torch.data.wordpiece import BasicTokenizer

    words = sorted({t for text in texts for t in BasicTokenizer().tokenize(text)})
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    Path(path).write_text("\n".join(tokens) + "\n")
    return len(tokens)


# f32 unit embeddings of the CLIP slices' queries: the kernels against the same
# model with their plain versions and on the eager path (PERF.md)
# (PERF.md): <= 7.5e-8 seen, 5e-6 allowed (DINOv2's bound)
SIGLIP_EMBED_TOL = {"plain versions": 5e-6, "eager": 5e-6}


def _slice_args(img_dir, manifest, split, model_args):
    key = "--train-image-list" if split == "train" else "--test-image-list"
    return ["--dataset", "covid", "--dataset-dir", img_dir, key, manifest, "--split",
            split] + model_args


def phase_slice_clip(workdir: Path):
    """cli.ingest -> cli.query --top-k 10 with MedSigLIP-448 (HF-layout
    --resume, 512-d) and ConceptCLIP-384 (seeded, 1152-d) at full width under
    FUSED_VIT, with XMIR_FUSED_LN_QKV72 unset (K2 alone) and set to 1 (K7 +
    K2); then K1 bit-equal at D = 512 and 1152 on integer inputs."""
    t0 = time.perf_counter()
    n_g, n_q, batch = 32, 16, 16
    img_dir, g_manifest = write_synthetic_covidx(str(workdir / "c_gallery"), n=n_g, size=256,
                                                 seed=14)
    q_dir, q_manifest = write_synthetic_covidx(str(workdir / "c_queries"), n=n_q, size=256,
                                               seed=15)
    pt = str(workdir / "medsiglip_hf.pt")
    write_siglip_checkpoint(pt, seed=16)
    log(f"[slice] CLIP: wrote {n_g} + {n_q} PNGs and an HF-layout SigLIP .pt in "
        f"{time.perf_counter() - t0:.1f} s")
    batches = -(-n_g // batch) + -(-n_q // batch)
    per_path = SIGLIP["depth"] * batches
    out = {}
    for model_name, dim, resume in (("medsiglip", 512, pt), ("conceptclip", 1152, "")):
        model_args = ["--model", model_name, "--device", "cuda", "--seed", "0",
                      "--batch-size", str(batch), "-j", "8"] + (
            ["--resume", resume] if resume else [])
        q_args = _slice_args(q_dir, q_manifest, "test", model_args)
        gal, hits_path = str(workdir / f"{model_name}.npz"), str(workdir / f"{model_name}.json")
        p = argparse.ArgumentParser()
        common.add_dataset_args(p)
        common.add_model_args(p)
        args, _ = p.parse_known_args(q_args)
        model, spec = common.build_model(args, torch.device("cuda"))

        def reembed():
            ref, _ = embed_dataset(common.build_dataset(args, "test"), make_embed_fn(model), spec,
                                   device="cuda", batch_size=batch, num_workers=8)
            return ref

        with env_flags(XMIR_FLASH_ATTN="0", XMIR_FUSED_LN="0"):
            eager = reembed()
        for path, qkv72 in ((model_name, None), (f"{model_name}_fused_ln_qkv72", "1")):
            calls = []
            with env_flags(XMIR_FUSED_LN_QKV72=qkv72, **FUSED_VIT):
                reset_launches()
                with record_searches(calls):
                    t0 = time.perf_counter()
                    ingest.main(_slice_args(img_dir, g_manifest, "train", model_args)
                                + ["--output", gal])
                    results = query.main(q_args + ["--index", gal, "--top-k", "10",
                                                   "--output", hits_path])
                    wall = time.perf_counter() - t0
                launches = read_launches()
                want = dict.fromkeys(WRAPPERS, 0)
                want.update({"K1": 1, "K2": per_path, "K7": per_path if qkv72 else 0})
                check(launches == want, f"{path}: launches {launches}, expected {want} "
                                        f"({SIGLIP['depth']} layers x {batches} batches)")
                log(f"[slice] {path}: launches {launches} ({SIGLIP['depth']} layers x {batches} "
                    f"batches of {batch}); ingest + query {wall:.1f} s wall")
                err = check_hits(calls, results, n_g, n_q, dim)
                with vit_plain_versions():
                    plain = reembed()
            emb = calls[0][1]
            diff = {"plain versions": (emb - plain).abs().max().item(),
                    "eager": (emb - eager).abs().max().item()}
            for k, v in diff.items():
                check(v <= SIGLIP_EMBED_TOL[k], f"{path}: query embeddings differ from the "
                                                f"{k}'s by {v} > {SIGLIP_EMBED_TOL[k]}")
            log(f"[slice] {path}: query embeddings vs the same model's {diff} (bounds "
                f"{SIGLIP_EMBED_TOL})")
            out[path] = {"launches": launches, "err": err, "embedding_max_abs_err": diff}
        del model
        torch.cuda.empty_cache()
        k1_bit_equal_at(n_q, n_g, dim, 10)
        k1_bit_equal_at(64, 4099, dim, 10)
        log(f"[slice] K1 at D = {dim}: bit-equal to its plain version on integer inputs "
            f"(f32 and bf16; Q = {n_q}, N = {n_g} and Q = 64, N = 4099)")
    return out, pt, (q_dir, q_manifest)


def zeroshot_from_artifact(save_dir, metrics, n):
    """cli.test --model biomedclip's artifact: shapes, unit embeddings, and
    the zero-shot accuracy, macro P/R/F1, R@1 and mAP recomputed with numpy
    from its embeddings, labels and predictions equal to the CLI's."""
    art = np.load(os.path.join(save_dir, "biomedclip_zeroshot.npz"))
    embeds, labels, preds, dists = art["embeds"], art["labels"], art["predictions"], art["dists"]
    check(embeds.shape == (n, 512) and preds.shape == labels.shape == (n,)
          and dists.shape == (n, n), f"artifact shapes {embeds.shape} {preds.shape}")
    check(np.abs(np.linalg.norm(embeds, axis=1) - 1).max() < 1e-5, "embeddings not unit")
    check(np.isposinf(np.diag(dists)).all(), "the diagonal is not excluded")
    stored = json.loads(str(art["metrics"]))
    check(stored == json.loads(json.dumps(metrics, default=float)), "artifact metrics != returned")
    acc = 100.0 * np.mean(preds == labels)
    check(abs(stored["zero_shot_accuracy"] - acc) <= 1e-9, "zero-shot accuracy != numpy's")
    ps, rs = [], []
    for cls in np.unique(np.concatenate([labels, preds])):
        tp = np.sum((preds == cls) & (labels == cls))
        ps.append(tp / max(np.sum(preds == cls), 1))
        rs.append(tp / max(np.sum(labels == cls), 1))
    check(abs(stored["zero_shot_precision_macro"] - 100 * np.mean(ps)) <= 1e-9
          and abs(stored["zero_shot_recall_macro"] - 100 * np.mean(rs)) <= 1e-9,
          "zero-shot macro P / R != numpy's")
    e = embeds.astype(np.float64)
    sims = e @ e.T
    off = ~np.eye(n, dtype=bool)
    d_err = np.abs(-dists[off] - sims[off]).max()
    check(d_err <= 2e-6, f"the artifact's cosines lie {d_err} from numpy's")
    order = np.argsort(dists, axis=1, kind="stable")  # dists = -cosine: ascending
    r1 = 100.0 * np.mean(labels[order[:, 0]] == labels)
    check(abs(stored["R@1"] - r1) <= 1e-9, "R@1 != numpy's")
    again = test_cli.single_label_metrics(-dists, labels)
    check(abs(stored["mAP"] - again["mAP"]) <= 1e-9, "mAP != numpy's")
    log(f"[slice] biomedclip_zeroshot.npz: zero-shot accuracy {acc:.2f}%, macro P / R, R@1 "
        f"{r1:.2f} and mAP {stored['mAP']:.2f} equal to numpy's from the artifact; its cosines "
        f"within {d_err:.2g} of numpy's")
    return {k: stored[k] for k in ("zero_shot_accuracy", "zero_shot_f1_macro", "R@1", "mAP")}


def phase_clip_zeroshot(workdir: Path, siglip_pt, queries):
    """cli.test --model biomedclip at full width (224 px, 12 + 12 layers) from
    a seeded open_clip-layout .pt and a generated vocab.txt, under FUSED_VIT;
    then cli.zeroshot --model medsiglip --dual-checkpoint at full width (27
    layers, C = 1152, seq-len 64; the text vocabulary only as large as the
    generated vocab.txt), with XMIR_FUSED_LN_QKV72 unset and set."""
    from xmir_tpu_torch.models.siglip_text import COVIDX_LABEL_TO_TEXT, SiglipTextBackbone

    out = {"launches": {}}
    n = 96  # two batches of cli.test's 64
    t_dir, t_manifest = write_synthetic_covidx(str(workdir / "b_test"), n=n, size=256, seed=17)
    names = test_cli.DATASET_LABEL_NAMES["covid"]
    vocab = str(workdir / "biomedclip_vocab.txt")
    write_vocab(vocab, [f"this is a medical image of {c}" for c in names])
    model, _ = create_model("biomedclip", generator=torch.Generator().manual_seed(18))
    sd = randomize_norms_(model, 19).state_dict()
    sd["text.transformer.embeddings.position_ids"] = torch.arange(512)[None]
    pt = str(workdir / "biomedclip_open_clip.pt")
    torch.save(sd, pt)
    del model, sd
    save_dir = str(workdir / "b_res")
    with env_flags(**FUSED_VIT):
        reset_launches()
        t0 = time.perf_counter()
        metrics = test_cli.main(["--dataset", "covid", "--dataset-dir", t_dir,
                                 "--test-image-list", t_manifest, "--model", "biomedclip",
                                 "--device", "cuda", "--vocab", vocab, "--resume", pt,
                                 "--save-dir", save_dir, "-j", "8"])
        wall = time.perf_counter() - t0
        launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want.update({"K2": BIOMEDCLIP_DEPTH * 2, "K7": BIOMEDCLIP_DEPTH * 2})
    check(launches == want, f"biomedclip zero-shot: launches {launches}, expected {want}")
    log(f"[slice] cli.test --model biomedclip: launches {launches} (12 blocks x 2 image "
        f"batches; the text tower none); {wall:.1f} s wall")
    out["launches"]["biomedclip_zeroshot"] = launches
    out["biomedclip"] = zeroshot_from_artifact(save_dir, metrics, n)

    q_dir, q_manifest = queries
    prompts = [COVIDX_LABEL_TO_TEXT[i] for i in range(3)]
    vocab = str(workdir / "siglip_vocab.txt")
    n_vocab = write_vocab(vocab, prompts)
    text = SiglipTextBackbone(vocab_size=n_vocab)
    siglip_model.init_weights_(text, torch.Generator().manual_seed(20))
    # the dual encoder's text tower and logits in HF SiglipModel's layout; the
    # CLI reads no vision_model. tensor, so the file leaves them out
    sd = {f"text_model.{k}": v for k, v in randomize_norms_(text, 21).state_dict().items()}
    sd.update(logit_scale=torch.full((1,), float(np.log(10.0))), logit_bias=torch.full((1,), -10.0))
    dual = str(workdir / "medsiglip_dual.pt")
    torch.save(sd, dual)
    del text, sd
    labels = np.asarray(common.build_dataset(argparse.Namespace(
        dataset="covid", dataset_dir=q_dir, test_image_list=q_manifest), "test").labels)
    n_q = len(labels)
    for path, qkv72 in (("medsiglip_zeroshot", None), ("medsiglip_zeroshot_fused_ln_qkv72", "1")):
        buf = io.StringIO()
        with env_flags(XMIR_FUSED_LN_QKV72=qkv72, **FUSED_VIT), contextlib.redirect_stdout(buf):
            reset_launches()
            t0 = time.perf_counter()
            result = zeroshot_cli.main([
                "--dataset", "covid", "--dataset-dir", q_dir, "--test-image-list", q_manifest,
                "--model", "medsiglip", "--embedding-dim", "1152", "--resume", siglip_pt,
                "--device", "cuda", "--dual-checkpoint", dual, "--vocab", vocab,
                "--text-vocab-size", str(n_vocab), "--output", str(workdir / f"{path}.json")])
            wall = time.perf_counter() - t0
            launches = read_launches()
        printed = buf.getvalue()
        log(printed.rstrip())
        image_batches = -(-n_q // 32)
        want = dict.fromkeys(WRAPPERS, 0)
        want["K2"] = SIGLIP["depth"] * (image_batches + 1)
        want["K7"] = want["K2"] if qkv72 else 0
        check(launches == want, f"{path}: launches {launches}, expected {want} (27 layers x "
                                f"({image_batches} image batches + the prompts))")
        preds = np.asarray(json.loads(printed.split(">> predictions: ")[1].splitlines()[0]))
        check(preds.shape == labels.shape and ((preds >= 0) & (preds < 3)).all(),
              "bad predictions")
        confusion = np.zeros((3, 3), int)
        np.add.at(confusion, (labels, preds), 1)
        check(abs(result["accuracy"] - np.mean(preds == labels)) <= 1e-12
              and result["confusion"] == confusion.tolist(),
              f"{path}: accuracy / confusion differ from those of the printed predictions")
        check(json.load(open(workdir / f"{path}.json")) == result, "--output != the result")
        log(f"[slice] cli.zeroshot --model medsiglip ({path}): launches {launches} (27 layers x "
            f"({image_batches} image batch + the 3 prompts at 64 tokens)); accuracy "
            f"{result['accuracy']:.4f} and the confusion matrix equal to numpy's from the printed "
            f"predictions; {wall:.1f} s wall")
        out["launches"][path] = launches
        out[path] = {"accuracy": result["accuracy"], "confusion": result["confusion"]}
    return out


# bf16 unit embeddings of the timed MedSigLIP (K2, or K7 + K2) and BiomedCLIP
# (K7 + K2) against the same model on the eager path: 2^-10 and 2^-9 seen
# (PERF.md); twice the larger is allowed
SIGLIP_EMBED_BF16_TOL = 4e-3


def phase_clip_rates():
    """K7 at the SigLIP shape (B = 16, N = 1024, C = 1152, H = 16) against its
    plain version and its product alone; K2 at (256, 1024, 72) against its
    plain version and SDPA (the default dispatch's backend, pinned once
    outside the timed windows); the bf16 MedSigLIP-448 embed at batch 16 with
    K2, with K7 + K2 and eager, and BiomedCLIP's image tower at batch 64:
    CUDA events in turns and device_ms, the peak memory."""
    gen = torch.Generator().manual_seed(38)
    c, h, n, b = SIGLIP["c"], SIGLIP["heads"], 1024, 16
    hd, dtype = c // h, torch.bfloat16
    out = {}
    with torch.inference_mode():
        x, lns, lnb, w, bias = _ln_inputs(gen, b, n, c, 3 * c, dtype)
        y_rows, w_t = ld._ln_rows(x.reshape(b * n, c), lns, lnb, 1e-6), w.t().contiguous()
        q, k, v = _attn_inputs(gen, b * h, n, hd, dtype)
        q4, k4, v4 = (t.reshape(b, h, n, hd) for t in (q, k, v))
        sc = hd ** -0.5
        backend = sdpa_backend(lambda: F.scaled_dot_product_attention(q4, k4, v4))
        fns = {
            "K2": lambda: va.vit_attention_fused(q, k, v, sc),
            "K2 plain": lambda: va.attention_plain(q, k, v, sc),
            "K2 library": lambda: F.scaled_dot_product_attention(q4, k4, v4),
            "K2 with statistics": lambda: va.launch_attention_forward(q, k, v, sc, True),
            "K7": lambda: ld.ln_qkv_fused(x, lns, lnb, w, bias, h),
            "K7 plain": lambda: ld.ln_qkv_reference(x, lns, lnb, w, bias, h),
            "K7 product": lambda: torch.matmul(y_rows, w_t),
        }
        errs = {"K2": vit_err(fns["K2"](), fns["K2 plain"](), k2_agreement(q, k, v, sc),
                              "K2 at the SigLIP shape"), "K7": {}}
        for o, r in zip(fns["K7"](), fns["K7 plain"]()):
            _worst(errs["K7"], vit_err(o, r, ld.agreement, "K7 at the SigLIP shape"))
        ms, dev = k2_against_library(fns, backend)
        for key in ("K7", "K7 product"):
            dev[key] = device_ms(fns[key])
        bounds = {"K2": (4 * b * h * n * n * hd, 4 * b * n * c * 2),
                  "K7": (2 * b * n * c * 3 * c, (4 * b * n * c + 3 * c * c) * 2 + 5 * c * 4)}
        for key, (ops, nbytes) in bounds.items():
            bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
            out[key] = {"ms": ms[key], "plain_ms": ms[f"{key} plain"], "device_ms": dev[key],
                        "bound_ms": bound_ms, "bound_by": bound_by, "agreement": errs[key]}
            log(f"[rates] {key} bfloat16 at the SigLIP shape: {ms[key]:.3f} ms by events, "
                f"device time {dev[key]:.4f} ms ({ops / dev[key] / 1e9:.1f} TFLOP/s; bound "
                f"{bound_ms:.4f} ms by {bound_by}) vs plain {ms[f'{key} plain']:.3f} ms; "
                f"agreement {errs[key]}")
        out["K2"].update(library=backend, library_ms=ms["K2 library"],
                         library_device_ms=dev["K2 library"],
                         stats_device_ms=dev["K2 with statistics"],
                         shape="bf16, BH=256 N=1024 hd=72 (MedSigLIP-448 at B=16)")
        out["K7"].update(library_ms=None, product_ms=ms["K7 product"],
                         product_device_ms=dev["K7 product"],
                         shape="bf16, B=16 N=1024 C=1152 H=16 (MedSigLIP-448 at B=16)")
        log(f"[rates] K2 at the SigLIP shape: library call (SDPA, {backend}) "
            f"{ms['K2 library']:.3f} ms by events, device time {dev['K2 library']:.4f} ms; "
            f"K7's product alone (torch.matmul, (16384 x 1152) . (1152 x 3456)) "
            f"{ms['K7 product']:.3f} ms, device time {dev['K7 product']:.4f} ms")
        del x, w, y_rows, w_t, q, k, v, q4, k4, v4, fns
        torch.cuda.empty_cache()
    out["medsiglip_embed"] = _clip_embed_rate(
        "medsiglip", 16, 448, SIGLIP["depth"], seed=39,
        paths={"kernels": {}, "kernels + K7": {"XMIR_FUSED_LN_QKV72": "1"},
               "eager": {"XMIR_FLASH_ATTN": "0", "XMIR_FUSED_LN": "0"}})
    out["biomedclip_embed"] = _clip_embed_rate(
        "biomedclip", 64, 224, BIOMEDCLIP_DEPTH, seed=40,
        paths={"kernels": {}, "eager": {"XMIR_FLASH_ATTN": "0", "XMIR_FUSED_LN": "0"}})
    return out


def _clip_embed_rate(name, batch, size, depth, seed, paths):
    """A registry model's bf16 embed (weights and input) on the card, device
    only: the launches of each path ("kernels": K2 in every layer, K7 too
    where the gate takes it; "kernels + K7": XMIR_FUSED_LN_QKV72=1), the
    unit embeddings of every path within SIGLIP_EMBED_BF16_TOL of the eager
    path's, CUDA events in turns, device_ms (or "not measured" where a
    forward's launches outrun the launch queue), the peak memory and a
    torch.profiler breakdown of the default path."""
    model, _ = create_model(name, generator=torch.Generator().manual_seed(seed))
    model = randomize_norms_(model, seed).to("cuda", torch.bfloat16).eval()
    x = torch.randn((batch, size, size, 3), generator=torch.Generator().manual_seed(seed)).to(
        "cuda", torch.bfloat16)
    embed = make_embed_fn(model)

    def run(flags):
        def fn():
            with env_flags(**flags):
                return embed(x)
        return fn

    fns = {path: run(flags) for path, flags in paths.items()}
    out = {"launches": {}, "embedding_max_abs_err_vs_eager": {}}
    with env_flags(XMIR_FLASH_ATTN=None, XMIR_FUSED_LN=None, XMIR_FUSED_LN_QKV=None,
                   XMIR_FUSED_LN_QKV72=None, XMIR_FUSED_LN_MLP=None):
        ref = fns["eager"]()
        for path, fn in fns.items():
            reset_launches()
            e = fn()
            launches = read_launches()
            k7 = depth if (path != "eager" and (name == "biomedclip" or "K7" in path)) else 0
            k2 = depth if path != "eager" else 0
            check(launches["K2"] == k2 and launches["K7"] == k7,
                  f"{name} bf16 {path}: launches {launches}, expected K2 {k2} and K7 {k7}")
            diff = (e - ref).abs().max().item()
            check(e.shape[0] == batch and torch.isfinite(e).all() and
                  diff <= SIGLIP_EMBED_BF16_TOL, f"{name} bf16 {path}: embeddings {diff} from "
                                                 f"the eager path's")
            out["launches"][path] = {"K2": launches["K2"], "K7": launches["K7"]}
            out["embedding_max_abs_err_vs_eager"][path] = diff
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fns["kernels"]()
        torch.cuda.synchronize()
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        ms, runs = _in_turns(fns)
        dev = {path: [] for path in fns}
        for path in list(fns) + list(fns)[::-1]:  # in turns
            try:
                dev[path].append(device_ms(fns[path], reps=3))
            except SpinTooShort:  # a forward's launches outrun the launch queue
                pass
        dev = {p: (statistics.median(v) if v else None) for p, v in dev.items()}
        out["profile"] = profile_forward(f"{name} bf16 batch {batch} @{size} with the kernels",
                                         embed, x, {"K2": K2_BF16_KERNELS, "K7": K7_KERNELS})
    out.update(ms=ms, device_ms=dev, img_per_s={p: batch / t * 1e3 for p, t in ms.items()})
    log(f"[rates] {name} bf16 batch {batch} @{size} (device only): "
        + "; ".join(f"{p} {ms[p]:.2f} ms = {batch / ms[p] * 1e3:.0f} img/s by events, "
                    + (f"{dev[p]:.4f} ms by device_ms" if dev[p] else "device_ms not measured")
                    for p in ms)
        + f"; launches {out['launches']}; embeddings vs the eager path's "
        f"{out['embedding_max_abs_err_vs_eager']} (bound {SIGLIP_EMBED_BF16_TOL}); peak "
        f"{out['peak_gib']:.2f} GiB; runs "
        f"{({p: [round(t, 2) for t in v] for p, v in runs.items()})}")
    del model, x
    torch.cuda.empty_cache()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-swin", action="store_true",
                        help="only build, then print where a bf16 SwinV2-Base batch's time goes")
    parser.add_argument("--train-only", action="store_true",
                        help="only build, then the training phases (17 to 23, 25 to 28, 31 to "
                             "33); prints no result")
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
        phase_kernel_window_bwd()
        with tempfile.TemporaryDirectory() as tmp:
            phase_train_swinv2(Path(tmp))
        phase_window_bwd_rates()
        phase_swin_train_rates()
        with tempfile.TemporaryDirectory() as tmp:
            phase_train_nih(Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            phase_distill(Path(tmp))
        phase_nih_distill_rates()
        print(smi)
        return
    max_err = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        d_launches, slice_err = phase_slice(Path(tmp))
    phase_embed_rate()
    serving = phase_serving()
    select_rates = phase_select_rates()
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
    k5_errs = phase_kernel_window_bwd()
    with tempfile.TemporaryDirectory() as tmp:
        sw_slice = phase_train_swinv2(Path(tmp))
    k5_rates = phase_window_bwd_rates()
    swin_train_rates = phase_swin_train_rates()
    with tempfile.TemporaryDirectory() as tmp:
        ex = phase_explainers(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        demo = phase_demo(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        nih = phase_train_nih(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        distill = phase_distill(Path(tmp))
    nd_rates = phase_nih_distill_rates()
    clip_errs = phase_kernel_siglip()
    with tempfile.TemporaryDirectory() as tmp:
        c_slices, siglip_pt, queries = phase_slice_clip(Path(tmp))
        zs = phase_clip_zeroshot(Path(tmp), siglip_pt, queries)
    clip_rates = phase_clip_rates()
    by_path = {key: {"densenet121": d_launches[key], "convnextv2": c_launches[key],
                     **{path: v["launches"][key] for path, v in v_slices.items()},
                     **{path: v["launches"][key] for path, v in s_slices.items()},
                     "densenet121_full_ranking": r_launches[key],
                     "dinov2_train": t_slice["launches"][key],
                     "densenet121_train": dt_launches[key],
                     "convnextv2_train": ct_slice["launches"][key],
                     "densenet121_saliency": sal["launches"][key],
                     "swinv2_train": sw_slice["launches"][key],
                     "explainers": ex["launches"][key], "demo": demo["launches"][key],
                     **{path: v[key] for path, v in nih["launches"].items()},
                     **{path: v[key] for path, v in distill["launches"].items()},
                     **{path: v["launches"][key] for path, v in c_slices.items()},
                     **{path: v[key] for path, v in zs["launches"].items()}}
               for key in WRAPPERS}
    slice_errs = [slice_err, c_slice_err, nih["hits_err"], distill["hits_err"]] + [
        v["err"] for v in v_slices.values()] + [v["err"] for v in s_slices.values()] + [
        v["err"] for v in c_slices.values()]
    f32 = serving["float32 Q=1024 k=10"]
    k1 = dict(KERNELS["K1"], launches=sum(by_path["K1"].values()),
              max_abs_err=max(max_err, *(v["max_abs_err"] for v in serving.values()),
                              *slice_errs),
              ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
              bound_by=f32["bound_by"], library_ms=None,
              library="none: torch.mm + torch.topk are two calls (yardstick_device_ms)",
              device_ms=f32["device_ms"], by_shape=serving,
              shape="Q=1024 N=100000 D=1024 k=10, f32", launches_by_path=by_path["K1"])
    big = select_rates["float32 Q=1024 k=2048"]
    k1s = dict(KERNELS["K1'"], launches=sum(by_path["K1'"].values()),
               max_abs_err=max(select_err, r_err, *(v["max_abs_err"] for v in
                                                    select_rates.values())),
               ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
               bound_by=big["bound_by"], library_ms=None,
               library="none: torch.mm + torch.topk / torch.sort are two calls",
               device_ms=big["device_ms"], by_shape=select_rates,
               shape="Q=1024 N=100000 D=1024 k=2048, f32", launches_by_path=by_path["K1'"])
    kernels = [k1, k1s]
    for key in ("K2", "K7", "K8"):
        bf16 = vit_rates[key]["bfloat16"]
        errs = [vit_errs[key]] + ([clip_errs[key]] if key in clip_errs else [])
        kernels.append(dict(
            KERNELS[key], launches=sum(by_path[key].values()),
            max_abs_err=max(e["max_abs_err"] for d in errs for e in d.values()),
            err_by_dtype=vit_errs[key], ms=bf16["ms"], plain_ms=bf16["plain_ms"],
            bound_ms=bf16["bound_ms"], bound_by=bf16["bound_by"], library_ms=bf16["library_ms"],
            library=bf16.get("library"), device_ms=bf16.get("device_ms"),
            library_device_ms=bf16.get("library_device_ms"),
            shape="bf16, one DINOv2 ViT-B/14 block's call at B=16, 518 px",
            by_dtype=vit_rates[key], launches_by_path=by_path[key]))
    k3 = bwd_rates["bfloat16 B=16"]
    kernels.append(dict(
        KERNELS["K3"], launches=sum(by_path["K3"].values()),
        max_abs_err=max(e["max_abs_err"] for e in bwd_errs["K3"].values()),
        err_by_dtype=bwd_errs["K3"], ms=k3["ms"], plain_ms=k3["plain_ms"],
        bound_ms=k3["bound_ms"], bound_by=k3["bound_by"], library_ms=k3["library_ms"],
        library=k3["library"], device_ms=k3["device_ms"],
        library_device_ms=k3["library_device_ms"],
        shape="bf16, one DINOv2 ViT-B/14 block's backward call at B=16, 518 px",
        by_shape=bwd_rates, launches_by_path=by_path["K3"]))
    for key in ("K4", "K6"):
        bf16 = window_rates[key]["bfloat16"]
        kernels.append(dict(
            KERNELS[key], launches=sum(by_path[key].values()),
            max_abs_err=max(e["max_abs_err"] for e in window_errs[key].values()),
            err_by_dtype=window_errs[key], ms=bf16["ms"], plain_ms=bf16["plain_ms"],
            bound_ms=bf16["bound_ms"], bound_by=bf16["bound_by"], library_ms=bf16["library_ms"],
            library=bf16["library"], device_ms=bf16["device_ms"],
            library_device_ms=bf16["library_device_ms"],
            shape=f"bf16, the {SWIN_DEPTH} calls of one SwinV2-Base forward at B=16, 384 px "
                  "(sum over the six stage shapes by their block counts)",
            ms_by_shape=window_rates[key], launches_by_path=by_path[key]))
    k5 = k5_rates["bfloat16"]
    kernels.append(dict(
        KERNELS["K5"], launches=sum(by_path["K5"].values()),
        max_abs_err=max(e["max_abs_err"] for e in k5_errs["K5"].values()),
        err_by_dtype=k5_errs["K5"], ms=k5["ms"], plain_ms=k5["plain_ms"],
        bound_ms=k5["bound_ms"], bound_by=k5["bound_by"], library_ms=k5["library_ms"],
        library=k5["library"], device_ms=k5["device_ms"],
        library_device_ms=k5["library_device_ms"],
        f32_sum={key: k5_rates["float32"][key] for key in
                 ("ms", "plain_ms", "library_ms", "bound_ms")},
        shape=f"bf16, the {SWIN_DEPTH} calls of one SwinV2-Base train step's backward at B=8, "
              "384 px (sum over the six stage shapes by their block counts)",
        ms_by_shape=k5_rates, function_grad_rel_err=k5_errs["function"],
        launches_by_path=by_path["K5"]))
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
        device_ms=sum(v["device_ms"] for v in bf16),
        shape="bf16, one block of each ConvNeXtV2-Base stage at B=16, 384 px (sum)",
        f32_sum={"ms": sum(v["ms"] for v in f32s), "plain_ms": sum(v["plain_ms"] for v in f32s),
                 "bound_ms": sum(v["bound_ms"] for v in f32s)},
        ms_by_shape=tail_bwd_rates, function_grad_rel_err=tail_bwd_errs["block"],
        launches_by_path=by_path["K10"]))
    by_name = {k["name"]: k for k in kernels}
    for key in ("K2", "K7"):
        by_name[KERNELS[key]["name"]].update(siglip=clip_rates[key],
                                             siglip_err_by_dtype=clip_errs[key])
    by_name["ln_qkv_fused"]["siglip_last_tile_and_head_edges"] = clip_errs[
        "K7 last tile and head edges"]
    by_name["convnext_block_fused"]["embedding_max_abs_err_vs_plain_tail"] = emb_err
    by_name["convnext_mlp_grn_fused"]["main_path"] = (
        "none: the JAX package reaches it only from its tests")
    print(smi)
    print(json.dumps({"kernels": kernels, "convnextv2_embed_img_per_s": rates["embed_rate"],
                      "dinov2_embed_img_per_s": vit_rates["embed_rate"],
                      "dinov2_embed_device_ms": vit_rates["embed_device_ms"],
                      "dinov2_train_step": train_rates,
                      "dinov2_train_f32_vs_plain": t_slice["f32_vs_plain"],
                      "convnextv2_train_step": convnext_train_rates,
                      "convnextv2_train_f32_vs_plain": ct_slice["f32_vs_plain"],
                      "saliency": {k: v for k, v in sal.items() if k != "launches"},
                      "swinv2_train_step": swin_train_rates,
                      "swinv2_train_f32_vs_plain": sw_slice["f32_vs_plain"],
                      "explainers": {k: v for k, v in ex.items() if k != "launches"},
                      "demo": {k: v for k, v in demo.items() if k != "launches"},
                      "k7_backward_rel_err": bwd_errs["K7 backward"],
                      "nih_dual_branch_train_step": nd_rates["dual_branch"],
                      "distill_train_step": nd_rates["distill"],
                      "distill_steps": distill["steps"],
                      "nih_train_f32_vs_plain": nih["f32_vs_plain"],
                      "nih_eval_metrics": nih["metrics"],
                      "swinv2_embed_img_per_s": swin_rates,
                      "swinv2_eval_metrics": s_slices["swinv2_test"]["metrics"],
                      "dinov2_embedding_max_abs_err": {
                          path: v["embedding_max_abs_err"] for path, v in v_slices.items()},
                      "swinv2_embedding_max_abs_err": {
                          path: v["embedding_max_abs_err"] for path, v in s_slices.items()
                          if "embedding_max_abs_err" in v},
                      "clip_embedding_max_abs_err": {
                          path: v["embedding_max_abs_err"] for path, v in c_slices.items()},
                      "clip_zeroshot": {k: v for k, v in zs.items() if k != "launches"},
                      "ptxas_c75xx": clip_errs["ptxas C75xx"],
                      "medsiglip_embed": clip_rates["medsiglip_embed"],
                      "biomedclip_embed": clip_rates["biomedclip_embed"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
