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
 15. slice   cli.query --top-k 0 over a DenseNet121 gallery of 1152 rows: K1'
             once, K1 never, the whole gallery ranked as a stable sort
 16. rates   K4 and K6 at the six SwinV2-Base shapes at B = 16, bf16 and f32,
             against their plain versions and one
             scaled_dot_product_attention call on pre-normalised inputs (timed
             here, used nowhere in the port; the SDPA backend the default
             dispatch picks, named and pinned once outside the timed windows;
             CUDA events over windows of 20 calls and the device time of K4,
             K6 and the library call, device_ms; the bound under each dtype's
             arithmetic, f32's (3xTF32) beside the FMA bound, attn_bound;
             --f32-window-only adds the f32 SwinV2-Base forward at B = 16 and
             its f32 train step at B = 8), with the time of the fold
             and unfold copies around K4; the f32 SwinV2-Base forward at B =
             16, 384 px (randomized logit scales, random normal pixels) with
             K4, with K6, with the plain versions and eager, its unit
             embeddings within 2e-6 of the plain versions' and eager's, not
             timed; SwinV2-Base bf16 (weights and input) batch 16 at 384 px
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
             within 3e-5 of the largest magnitude of the exact gradient (f32
             takes the 3xTF32 route of csrc/attn_bwd_f32.cuh); K7's
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
             events and device time, with torch.profiler's share of K3's; the
             bound under each dtype's arithmetic, f32's beside the FMA
             bound, attn_bound); the bf16 DINOv2 train step at batch 8
             with the kernels, with their plain versions and on the eager
             path: img/s, peak memory, forward / backward / optimiser shares,
             and the device time by kernel (torch.profiler), K3's share of it
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
             cli.test --save-dir, cli.compute_saliency --results (1 query,
             top 3, 2401 masks), cli.evaluate_saliency --saliency-dir (K1
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
             both, device_ms; the bound under each dtype's arithmetic,
             attn_bound)
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
 38. kernel  K2 (with its row statistics) and K3 at head width 72 (bf16 K3
             pads it to 80, f32 runs 72) at the SigLIP train steps' shapes: bf16 (BH, N) = (128,
             729) (ConceptCLIP-384 at B = 8), f32 (256, 1024) and (256, 64)
             (MedSigLIP-448's towers at B = 16); K3 through the Function
             within ops/vit_attn.py::grad_agreement's bounds, every head's
             last real lanes 64-71 (beside the padding 72-79) on their own
             too, two runs bit-equal, f32 within 3e-5 of the exact gradient;
             K2 within k2_agreement; K3 timed beside SDPA's backward (the
             default dispatch's backend, pinned once outside the timed
             windows), CUDA events in turns and device_ms; build.log's C75xx
             lines for vit_attn_bwd.cu
 39. slice   cli.train_medsiglip at google/medsiglip-448's widths (448 px,
             27 + 27 layers, C = 1152, 16 heads of 72, a 256,000-token
             table, seq-len 64), --bf16 --batch-size 16 on 60 generated
             COVIDx PNGs and a generated vocab.txt, one epoch of 3 steps under
             XMIR_FLASH_ATTN=1 (--bf16 casts the pixels only: f32 towers, K2
             = 54 and K3 = 4 a step); the first step's loss bit-equal to the
             same seeded model's and within 1e-4 of the kernels' plain
             versions'; frozen tensors bit-equal, trained ones moved; the step
             by step_reading; cli.zeroshot --dual-checkpoint reads the saved
             encoder strictly (K2 = 27 x (image batches + 1))
 40. slice   cli.train_conceptclip at ConceptCLIP's widths (SO400M at 384 px,
             729 tokens, 27 layers; a 12-layer 768-wide BERT) with --bf16
             --batch-size 8 --max-concepts 8 --concept-len 16 on a generated
             VinDr CSV and PNGs, one epoch of 3 steps, deduped twice (losses
             and every tensor bit-equal) and with --no-dedupe-concepts (the
             first step's IT-Align bit-equal, RC-Align within 5e-3); K2 = 27
             and K3 = 4 a step; ConceptGather's backward bit-equal over 10
             runs and within a bf16 step of the exact slot sums; the deduped
             and every-slot steps by step_reading
 41. slice   --explainer gradcam_sim through cli.compute_saliency and
             cli.evaluate_saliency on MedSigLIP-448 (f32, XMIR_FLASH_ATTN=1:
             K2 in every layer, K3 never), maps in [0, 1], AUCs in [0, 1],
             Grad-CAM maps/s; sbsm_feature_saliency and fsal_grad_saliency (a
             seeded probe) on a full-width MedSigLIP tower at 224 px against
             the CPU's plain path, they and sim_score_cam against the card's
             eager path, within 1e-3 of each map's scale; cli.xai_conceptclip
             on phase 40's checkpoint and data (K2 = 27 x gallery batches)
 42. kernel  K1 at the two depths the slice adds, over 100,000 rows at Q =
             1024 and Q = 1, k = 10, f32 and bf16: D = 48 on +/-1 codes
             (ATH's Hamming path: every score an exact integer, thousands of
             rows tied at each query's k-th score) bit-equal to the plain
             version, ids and values, and fused_topk(metric="hamming")
             against the CPU's plain path; D = 2048 on unit rows (ResNet50)
             within phase 3's agreement, f32 within the 3xTF32 score bound;
             integer inputs with ties at every plan edge bit-equal at both;
             the plans; each timed (events in turns with the plain version,
             device_ms) beside its bound and torch.mm + torch.topk
 43. slice   ResNet50 at full width (224 crop, 2048-d) on COVIDx-format PNGs:
             cli.ingest -> cli.query (K1 at D = 2048 once; the hits against
             the plain top-k) and cli.test --save-dir (no kernel; the metrics
             against numpy's)
 44. slice   the ATH hashing path (256 px, 48 bits): cli.train_ath, three
             steps at batch 32 (no kernel; the f32 losses within 1e-5 (1 +
             |loss|) of the same CLI on the CPU, beyond the CPU's own f32
             drift from a float64 run, every tensor moved);
             cli.test_ath --resume with and without --binary-codes;
             cli.ingest --model ath --metric hamming -> cli.query (K1 once on
             +/-1 codes: the hits bit-equal to the plain top-k of the
             recorded search); the card's codes, metrics and hits against
             the CPU CLIs' on the same .pt (equal where no code's sign
             differs)
 45. slice   cli.anomaly --model resnet50 (no kernel); the query sets of
             ResNet50 and DenseNet121 through cli.fusion (the card and the
             CPU) and, against their galleries, cli.compare --html (K1 twice,
             each search's hits against the plain top-k)
 46. rates   the ResNet50 embed at batch 64 (224 px) in f32, TF32 and bf16 by
             device_ms; the ATH train step at batch 32 (96 images at 256 px)
             by step_reading
 47. slice   the ChestMIR lesion detector: five seeded YOLOv5s folds (14
             classes, depth 0.33, width 0.5) as ultralytics-layout .pt files,
             the objectness prior offset on the card so that ~40 rows a
             forward pass run_detector's 0.01 gates; the card's raw (1, 25200,
             19) predictions at 640 px against the CPU's on the same .pt and
             against an ultralytics-semantics oracle on the card (atol 2e-4,
             rtol 1e-4); run_detector's boxes equal on both devices (unless a
             confidence lies within 1e-5 of a gate); batch-1 latency by CUDA
             events and device_ms, run_detector's wall time on a 1024^2 film
 48. slice   cli.chestmir_ingest --model convnextv2 (f32 under
             XMIR_FUSED_MLP=1) on 8 generated 1024^2 grayscale films with a
             --detector-plugin of the five folds, --raw-detector-outputs --tta
             0,4: K9 = 36 x (global + region batches), no other kernel; again
             with the tail's plain version: global and region vectors within
             1e-4, region labels and boxes equal; images/s split into detector
             forwards, host decode / NMS / WBF, crops + region embeds, global
             embeds
 49. slice   cli.chestmir_eval on phase 48's artifact (adaptive, and the most
             detected lesion): its JSON equal to two_stage_eval's on the same
             artifact; reranked and fallback queries (at least one reranked a
             stage)
The mesh phases (--use-mesh on torch.distributed: a world of 1 over NCCL on
the card, at full width):
 50. mesh A  (in phase 4's directory, after it) cli.ingest --use-mesh
             --upload-originals -> cli.query --use-mesh and cli.test
             --use-mesh on phase 4's DenseNet121 data: the saved index's
             vectors, labels and hits bit-equal to phase 4's (the paths are
             the stored URIs, whose files equal the originals), info()'s
             sharding {"devices": 1, ...}, K1 once a query batch; cli.test's
             metrics and artifact equal to the run without the flag; the
             backend is NCCL and the process group is gone after each CLI
 51. mesh B  the sharded search at the serving shape (Q = 1024, N = 100,000,
             D = 1024, unit rows), split as a world of 4 splits it (25,088
             rows a shard, 24,736 valid in the last): each shard body on the
             card, then the merge, against one unsharded call, f32 and bf16,
             at k = 10 (K1) and k = 100 (K1'), bit-equal, again with
             duplicate rows planted across every shard boundary (ties to the
             lower id); the four shard searches plus the merge by device_ms
             beside the unsharded call
 52. mesh C  (in phase 18's directory) cli.train --model dinov2 --bf16 -p 2 -k 4
             --use-mesh, and with --fsdp, one epoch from phase 18's .pt: the
             launches of phase 18's run; the data-parallel run's losses,
             parameters and Adam moments bit-equal to phase 18's, the FSDP
             run's first loss within 1e-5 and its parameters within 1e-3 by
             mean distance over mean movement; the FSDP checkpoint resumed
             under --fsdp for epoch 2 bit-equal to phase 18's two-epoch run;
             (in phase 19's directory) cli.train --model densenet121
             --use-mesh --cache-dir, one epoch (the cache complete, its rows
             byte-equal to fresh decodes), then --resume of it for epoch 2
             read from the cache: losses and tensors bit-equal to phase 19's
             two-epoch run without the cache
 53. mesh D  (in phase 24's directory) cli.compute_saliency --use-mesh (1
             query, top 2, 2401 masks) -> cli.evaluate_saliency --use-mesh:
             maps and AUCs within 1e-6 of phase 24's, its JSON's use_mesh and
             mesh_devices, K1 once
 54. mesh E  the native NIH reader built with g++ under build/ and a batch of
             64 generated .npy files through it (the counter: all native)
             within the JAX tests' bound of the PIL path (median |diff| <= 1,
             mean < 3); prefetch_to_device's batches equal to the host's, a
             kernel reading each at once; cli.parity on
             tests/fixtures/reference_single_label_golden.npz; a span report
             and a torch.profiler trace file
 55. tensor  DINOv2 ViT-B/14 (random nonzero weights, 518 px, B = 16) split by
     parallel  auto_param_shardings (parallel/tensor_parallel.py), bf16 and f32
             (fused switches on), with and without XMIR_FUSED_LN_MLP: on a
             (1, 1) NCCL mesh the rule shards nothing and the embeddings are
             bit-equal to the untransformed model's with equal launches
             (K7 = K2 = 12, K8 = 12 under the switch); every rank's pieces
             at tp = 2 and 4 run on this card and combine in-process
             (an f32 sum): K8 on each rank's head-major qkv rows, K2 on its
             H / tp heads, K8 on its fc1 columns under the switch, the unit
             embeddings within 1e-5 (f32) / 5e-3 (bf16) of world 1's, only
             cls_token and pos_embed gathered whole; K8 against its plain
             version at the pieces' shapes (B N rows by 3C / tp and 4C / tp
             columns), timed at the qkv pieces
 56. export  (in the directories of phases 18, 26 and 29, after each) cli.export
             of the phase's trained DINOv2 ViT-B/14, ConvNeXtV2-Base and
             SwinV2-Base checkpoint: --format torch read back through
             --resume (models/convert.py::load_torch_checkpoint) into a model
             of torch's default init, the f32 unit embeddings of the phase's
             validation PNGs bit-equal to the checkpoint's model; --format
             exported at full width on the card (DINOv2 518 px under
             XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1 with a dynamic batch run at 2
             and 3; ConvNeXtV2 384 px under XMIR_FUSED_MLP=1; SwinV2 384 px
             under XMIR_FUSED_ATTN=1): the graph calls xmir::ln_qkv and
             xmir::vit_attention 12 times, xmir::convnext_tail 36,
             xmir::biased_attention 24; tracing launches nothing; the program
             loaded by torch.export.load launches K7 = K2 = 12, K9 = 36, K4 =
             24 a forward, its unit embeddings within 1e-6 of the eager
             model's on the kernels and within the slices' bounds of the
             plain path (5e-6, 1e-4, 2e-6)
Every phase logs its seconds ("[time] phase_...: s"), the run its total
before the kernels line; the summary's "phase_seconds" holds the top-level
phases'.
``--train-only`` builds and runs phases 17 to 23, 25 to 28, 31 to 33 and 38
to 40 alone, ``--siglip-only`` phases 38 to 41, ``--resnet-ath-only`` phases
42 to 46, ``--chestmir-only`` phases 47 to 49, ``--mesh-only`` phases 4, 18,
19 and 24 with the mesh phases they hold (50, 52, 53), then 51 and 54 (no
result line). ``--cards N`` (N cards of one host) runs the mesh CLIs at N
ranks under torchrun against a world of 1 (``phase_cards``; no result line),
and DINOv2 (bf16, f32) and DenseNet121 (f32, 224 px, B = 64) split over
(1, N) and (N / 2, 2) meshes (``phase_cards_tp``), ``--cards-on-cpu N`` the
same with gloo and narrow models, a rehearsal; ``--tp-only`` phase 55;
``--export-only`` phase 56 on timm-layout .pt files of random weights (no
training runs).
The launch counts are set to 0 before each slice and read after it. Each
kernel's bound (the least time the card could take: bytes moved once over
3.35 TB/s, or operations over the peak of their type) is reckoned from the
timed shapes. The last two lines are a JSON summary of the kernels and
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import functools
import importlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from urllib.parse import quote

import numpy as np
import torch
import torch.nn.functional as F

from xmir_tpu_torch.analysis import hash_retrieval_metrics
from xmir_tpu_torch.chestmir import canonical_lesion_name, two_stage_eval
from xmir_tpu_torch.chestmir import inference as chest_inference
from xmir_tpu_torch.chestmir import lesions as chest_lesions
from xmir_tpu_torch.cli import anomaly as anomaly_cli
from xmir_tpu_torch.cli import chestmir_eval as chestmir_eval_cli
from xmir_tpu_torch.cli import chestmir_ingest as chestmir_ingest_cli
from xmir_tpu_torch.cli import common, ingest, query
from xmir_tpu_torch.cli import compare as compare_cli
from xmir_tpu_torch.cli import fusion as fusion_cli
from xmir_tpu_torch.cli import test as test_cli
from xmir_tpu_torch.cli import test_ath as test_ath_cli
from xmir_tpu_torch.cli import train as train_cli
from xmir_tpu_torch.cli import train_ath as train_ath_cli
from xmir_tpu_torch.cli import zeroshot as zeroshot_cli
from xmir_tpu_torch.data.datasets import NIH_RETRIEVAL_PATHOLOGIES
from xmir_tpu_torch.data.pipeline import embed_dataset
from xmir_tpu_torch.data.synthetic import write_synthetic_covidx
from xmir_tpu_torch.index import ShardedGalleryIndex
from xmir_tpu_torch.index.gallery import (
    make_local_shard_search,
    merge_shard_candidates,
    shard_layout,
)
from xmir_tpu_torch.models import convnext as convnext_model
from xmir_tpu_torch.models import siglip as siglip_model
from xmir_tpu_torch.models import swin as swin_model
from xmir_tpu_torch.models import vit as vit_model
from xmir_tpu_torch.models import yolo as yolo_model
from xmir_tpu_torch.models.activations import adaptive_gelu
from xmir_tpu_torch.models.convert import (
    load_torch_checkpoint,
    load_yolov5_checkpoint,
    yolov5_state_dict_from_ultralytics,
)
from xmir_tpu_torch.models.embedders import ATHEmbedder
from xmir_tpu_torch.models.registry import create_model
from xmir_tpu_torch.ops import _build
from xmir_tpu_torch.ops import convnext_block as cb
from xmir_tpu_torch.ops import ln_dense as ld
from xmir_tpu_torch.ops import plain_attn
from xmir_tpu_torch.ops import vit_attn as va
from xmir_tpu_torch.ops import window_attn as wa
from xmir_tpu_torch.ops.distance import l2_normalize, sign_codes
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
    GroupedAdam,
    TrainState,
    build_optimizer,
    make_ath_train_step,
    make_conceptclip_train_step,
    make_distill_train_step,
    make_dual_branch_train_step,
    make_embed_fn,
    make_embedding_train_step,
    make_it_align_train_step,
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
           "sources": ["xmir_tpu_torch/csrc/vit_attn_bwd.cu",
                       "xmir_tpu_torch/csrc/attn_bwd_f32.cuh"],
           "bodies": "bf16: bwd_prep_bf16 + bwd_bf16_wg (wgmma bf16, persistent, TMA ring, "
                     "ordered dq adds) + bwd_dq_finish; f32: bwd_prep_f32 + bwd_f32_wg "
                     "(persistent, TMA ring, ordered dq adds; s and dp on IEEE FMAs, dv, dk, "
                     "dq as 3xTF32 wgmma) + bwd_dq_finish_f32",
           "replaces": "xmir_tpu/ops/vit_attn_pallas.py:683"},
    "K4": {"name": "biased_attention_fused", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/window_attn.cu",
           "replaces": "xmir_tpu/ops/vit_attn_pallas.py:320"},
    "K5": {"name": "biased_attention_bwd", "route": "cuda",
           "source": "xmir_tpu_torch/csrc/window_attn_bwd.cu",
           "sources": ["xmir_tpu_torch/csrc/window_attn_bwd.cu",
                       "xmir_tpu_torch/csrc/attn_bwd_f32.cuh"],
           "bodies": "bf16: window_bwd_prep (wgmma scores, exact max and z) + window_bwd_main "
                     "(wgmma bf16, persistent, ordered dq and dbias adds) + window_bwd_finish; "
                     "f32: window_prep_f32 (FMA scores, exact max and z) + window_bwd_f32_wg "
                     "(persistent, TMA ring, ordered dq and dbias adds; s on IEEE FMAs, dp, "
                     "dv, dk, dq as 3xTF32 wgmma) + window_bwd_finish_f32",
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
# the forward kernels an exported program calls, as torch.library custom ops
EXPORT_OPS = {"K2": "xmir::vit_attention", "K4": "xmir::biased_attention",
              "K6": "xmir::window_attention", "K7": "xmir::ln_qkv", "K8": "xmir::ln_dense",
              "K9": "xmir::convnext_tail"}
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


_START = time.perf_counter()


def log(*args):
    """A line of the run's report, after the seconds since the script
    started (where the 1,200 s of a run go)."""
    print(f"[{time.perf_counter() - _START:5.0f} s]", *args, flush=True)


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
def record_searches(calls, returned=None):
    """Record each ShardedGalleryIndex.search's (index, queries, k) in
    ``calls`` and, where ``returned`` is a list, the (values, ids) it gave."""
    orig = ShardedGalleryIndex.search

    def search(self, queries, k, exclude_ids=None):
        calls.append((self, torch.as_tensor(queries).clone(), k))
        out = orig(self, queries, k, exclude_ids)
        if returned is not None:
            returned.append(tuple(t.clone() for t in out))
        return out

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


# the DenseNet121 slice's gallery and query images
SLICE_ROWS = (128, 32)


def phase_slice(workdir: Path):
    t0 = time.perf_counter()
    n_g, n_q = SLICE_ROWS
    img_dir, g_manifest = write_synthetic_covidx(str(workdir / "gallery"), n=n_g, size=256, seed=0)
    q_dir, q_manifest = write_synthetic_covidx(str(workdir / "queries"), n=n_q, size=256, seed=1)
    log(f"[slice] wrote {n_g} gallery + {n_q} query PNGs (256 px) in "
        f"{time.perf_counter() - t0:.1f} s")
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
    err = check_hits(calls, results, n_g, n_q, 1024)
    mesh = phase_mesh_slice(workdir, (img_dir, g_manifest), (q_dir, q_manifest), model_args,
                            gal, results)
    return launches, err, mesh


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
    n_g, n_q, batch = 64, 32, 32
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


def _in_turns(fns, rounds=3, reps=2):
    """Median ms of each of fns {name: fn}, timed with CUDA events in turns:
    the order reverses every round (a, b, b, a, ...); a round times ``reps``
    calls of each."""
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


def randomized_vit(seed, **widths):
    """DINOv2 ViT-B/14 (or a ViT of ``widths``) with random nonzero
    LayerNorm, LayerScale and bias tensors (at init LayerScale is 1e-5 and
    the blocks all but vanish), on the CPU in f32."""
    gen = torch.Generator().manual_seed(seed)
    backbone = (vit_model.init_weights_(vit_model.ViTBackbone(**widths), gen) if widths
                else vit_model.vit_base_patch14_dinov2(gen))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in backbone.named_parameters():
            if name.endswith(".gamma"):
                p.copy_(0.5 + 0.2 * torch.randn(p.shape, generator=gen))
            elif name.endswith(".bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif "norm" in name:
                p.copy_(1 + 0.2 * torch.randn(p.shape, generator=gen))
    return backbone


def write_vit_checkpoint(path, seed):
    """``randomized_vit`` in timm's layout, plus a classifier, which the
    port's loader ignores."""
    sd = randomized_vit(seed).state_dict()
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
    n_g, n_q, batch = 16, 16, 16
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
    n_g, n_q, batch = 16, 16, 16
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


def check_evaluation(save_dir, metrics, n, dim=1024):
    """cli.test's artifact: shapes, finite values, and every metric equal to
    what numpy makes of the artifact's own embeddings and labels."""
    art = np.load(os.path.join(save_dir, "evaluation_results.npz"))
    embeds, labels, dists = art["embeds"], art["labels"], art["dists"]
    check(embeds.shape == (n, dim) and labels.shape == (n,) and dists.shape == (n, n),
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
    n_g, n_q = 1152, 16
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


# the parts of an f32 bound (attn_bound) that add up over a forward's calls
F32_BOUND_PARTS = ("fma_bound_ms", "fma_part_ms", "tf32_part_ms")


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
            parts = F32_BOUND_PARTS if dtype == torch.float32 else ()
            total = {key: dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms", "device_ms",
                                         "library_device_ms", *parts), 0.0)
                     for key in out}
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
                bnd = attn_bound(*work, dtype, "K4")  # K6's arithmetic is K4's
                bound_ms, by = bnd["bound_ms"], bnd["bound_by"]
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
                                         ("library_device_ms", dev["library"]),
                                         *((part, bnd.get(part, 0.0)) for part in parts)):
                        total[key][field] += count * value
                log(f"[rates] {name:8s} {shape}: K4 {ms['K4']:.3f} ms "
                    f"({work[0] / ms['K4'] / 1e9:.1f} TFLOP/s; device time "
                    f"{bound_text(bnd, dev['K4'])}) vs "
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
                                      library=library, arithmetic=bnd["arithmetic"])
            log(f"[rates] {name:8s} the {SWIN_DEPTH} calls of one SwinV2-Base forward at B={b}: "
                + "; ".join(f"{key} {total[key]['ms']:.3f} ms (plain {total[key]['plain_ms']:.3f}, "
                            f"library {total[key]['library_ms']:.3f}); device time "
                            f"{total[key]['device_ms']:.4f} against the library's "
                            f"{total[key]['library_device_ms']:.4f} "
                            f"({total[key]['device_ms'] / total[key]['library_device_ms']:.2f}x), "
                            f"{bound_text(out[key][name], total[key]['device_ms'])}"
                            for key in out)
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


# the f32 routes' products on IEEE FMAs (the rest 3xTF32 on wgmma): K3's s
# and dp, K5's s (csrc/attn_bwd_f32.cuh); none of K4's and K6's
# (csrc/window_attn.cu); and the products each kernel's operations hold
F32_FMA_PRODUCTS = {"K3": ("s", "dp"), "K5": ("s",), "K4": (), "K6": ()}
PRODUCTS = {"K3": 5, "K5": 5, "K4": 2, "K6": 2}


def attn_bound(ops, nbytes, dtype, kernel="K3"):
    """An attention kernel's bound under its arithmetic, beside the FMA
    bound (``ops``: its PRODUCTS' operations, the work the function needs:
    K3 / K5's five products 10 BH N^2 hd, K4 / K6's two 4 BH N^2 hd; bytes
    each input read and each output written once): bf16, the products on the
    tensor cores; f32, the kernel's F32_FMA_PRODUCTS on IEEE FMAs and the
    others as three TF32 products each (3xTF32), the larger of the two
    parts, which run on separate units; the FMA bound, all on IEEE FMAs."""
    if dtype == torch.bfloat16:
        ms, by = bound(ops, nbytes, "bfloat16")
        return {"bound_ms": ms, "bound_by": by, "arithmetic": "bf16 wgmma"}
    on_fma, products = F32_FMA_PRODUCTS[kernel], PRODUCTS[kernel]
    fma_part = bound(ops * len(on_fma) / products, nbytes, "float32")
    tf32_part = bound(3 * ops * (products - len(on_fma)) / products, nbytes, "tfloat32")
    ms, by = max(fma_part, tf32_part)
    fma_ms, fma_by = bound(ops, nbytes, "float32")
    arithmetic = (f"{', '.join(on_fma)} IEEE FMA; the other products 3xTF32 wgmma" if on_fma
                  else "every product 3xTF32 wgmma")
    return {"bound_ms": ms, "bound_by": by, "fma_part_ms": fma_part[0],
            "tf32_part_ms": tf32_part[0], "fma_bound_ms": fma_ms, "fma_bound_by": fma_by,
            "arithmetic": arithmetic}


def bound_text(b, ms):
    """``attn_bound``'s reading against a time, for the log."""
    text = f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['arithmetic']}), " \
           f"{b['bound_ms'] / ms:.1%} of it"
    if "fma_bound_ms" in b:
        text += (f"; FMA part {b['fma_part_ms']:.4f} ms, 3xTF32 part {b['tf32_part_ms']:.4f} ms; "
                 f"all on FMAs {b['fma_bound_ms']:.4f} ms, {b['fma_bound_ms'] / ms:.1%} of it")
    return text


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
        out["launches"], out["ckpt"], out["queries"] = launches, ckpt, data[2:]
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
                     "cli.train dinov2 --bf16", "--resume", pt, first_run=(losses, ckpt))
        out["mesh"] = mesh_train_dinov2(workdir, run, pt, start, losses, ckpt, launches, steps)
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
    reset_launches()
    cache = mesh_train_cache(workdir, run, data, steps)
    check(not any(read_launches().values()), "mesh C: DenseNet121 training launched a kernel")
    return launches, cache


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
            bnd = attn_bound(ops, nbytes, dtype)
            out[f"{name} B={b}"] = {"ms": ms["K3"], "plain_ms": ms["K3 plain"],
                                    "library_ms": ms["K3 library"], "forward_ms": ms["K2"],
                                    **bnd, "agreement": e,
                                    "device_ms": dev["K3"], "library_device_ms": dev["K3 library"],
                                    "profiler_share": k3_share,
                                    "library": f"scaled_dot_product_attention backward, {backend}"}
            log(f"[rates] K3 {name:8s} B={b} BH={bh} N={n} hd={hd}: {ms['K3']:.3f} ms by "
                f"events ({ops / ms['K3'] / 1e9:.1f} TFLOP/s of the 10 BH N^2 hd it must do; "
                f"device time {bound_text(bnd, dev['K3'])}) vs plain "
                f"{ms['K3 plain']:.3f} ms, library backward ({backend}) {ms['K3 library']:.3f} ms, "
                f"K2 with statistics {ms['K2']:.3f} ms; device time K3 {dev['K3']:.4f} ms "
                f"(torch.profiler's records hold {k3_share:.1%} of it), library "
                f"backward {dev['K3 library']:.4f} ms ({dev['K3'] / dev['K3 library']:.2f}x); "
                f"agreement {e}; within {lib_rel:.3g} of the library's gradients' largest "
                "magnitude")
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
                              "forward + backward": forward_backward}, rounds=3, reps=1)
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


def _f32_step_reading(out, label, fns, want, flags):
    """One f32 train step's launches (``want``: the kernels' counts a step
    with ``fns["kernels"]``) and its ms a step by CUDA events in turns of
    each of ``fns``, under the environment ``flags``, into out[label]."""
    with env_flags(**flags):
        reset_launches()
        fns["kernels"]()
        torch.cuda.synchronize()
        launches = read_launches()
        check(all(launches[key] == n for key, n in want.items()),
              f"{label}: launches {launches}, expected {want} a step")
        ms, runs = _in_turns(fns, rounds=3, reps=1)
    out[label] = {"ms": ms, "launches": {k: v for k, v in launches.items() if v}}
    log(f"[rates] {label}, f32: {ms['kernels']:.2f} ms a step by CUDA events with the "
        f"kernels, {ms['plain versions']:.2f} ms with their plain versions"
        + (f", {ms['eager']:.2f} ms on the eager path" if "eager" in ms else "")
        + f"; launches a step {out[label]['launches']}; runs "
        f"{({k: [round(v, 2) for v in r] for k, r in runs.items()})}")


def f32_swin_train_step(out):
    """The f32 SwinV2-Base train step at batch 8, 384 px under
    XMIR_FUSED_ATTN=1 (K4 forward and K5 backward in every block), with the
    kernels' plain versions and on the eager path, by CUDA events in turns."""
    model, _ = create_model("swinv2", generator=torch.Generator().manual_seed(35))
    randomize_swin_(model.backbone, 36)
    model = model.to("cuda").train()
    state = TrainState(model, build_optimizer(model, lr=1e-5))
    step = make_embedding_train_step(model, "triplet", {"margin": 2.0})
    x = torch.randn((8, 384, 384, 3), generator=torch.Generator().manual_seed(37)).cuda()
    labels = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], device="cuda")

    def plain_swin():
        with swin_plain_versions():
            step(state, x, labels)

    def eager_swin():
        with env_flags(XMIR_FUSED_ATTN="0"):
            step(state, x, labels)

    _f32_step_reading(out, "SwinV2-Base train step at batch 8, 384 px",
                      {"kernels": lambda: step(state, x, labels), "plain versions": plain_swin,
                       "eager": eager_swin},
                      {"K4": SWIN_DEPTH, "K5": SWIN_DEPTH},
                      dict(XMIR_FUSED_ATTN="1", XMIR_SWIN_KERNEL=None))
    del model, state, step, x
    torch.cuda.empty_cache()


def _swin_f32_forwards():
    """(model, forwards): SwinV2-Base in f32 (weights and input) with
    randomize_swin_'s logit scales (one head of each block above the clamp),
    batch 16 at 384 px, taken with K4 (the forwards run under
    XMIR_FUSED_ATTN=1), with K6 (XMIR_SWIN_KERNEL=v1), with the kernels'
    plain versions and on the eager path."""
    model, _ = create_model("swinv2", generator=torch.Generator().manual_seed(17))
    randomize_swin_(model.backbone, 18)
    model = model.to("cuda").eval()
    embed = make_embed_fn(model)
    x = torch.randn((16, 384, 384, 3), generator=torch.Generator().manual_seed(19)).cuda()

    def with_v1():
        with env_flags(XMIR_SWIN_KERNEL="v1"):
            return embed(x)

    def with_plain_versions():
        with swin_plain_versions():
            return embed(x)

    def eager_path():
        with env_flags(XMIR_FUSED_ATTN="0"):
            return embed(x)

    return model, {"K4": lambda: embed(x), "K6": with_v1, "plain versions": with_plain_versions,
                   "eager": eager_path}


def check_swin_f32_embeddings(fns):
    """The unit embeddings of ``_swin_f32_forwards``: K4's held to the plain
    versions' and the eager path's, K6's to the eager path's
    (SWIN_EMBED_TOL), each forward's K4 / K6 launches checked. Run under
    XMIR_FUSED_ATTN=1. Returns the differences."""
    want = {"K4": (SWIN_DEPTH, 0), "K6": (0, SWIN_DEPTH)}
    emb = {}
    for key, fn in fns.items():
        reset_launches()
        emb[key] = l2_normalize(fn())
        launches = read_launches()
        got = (launches["K4"], launches["K6"])
        check(got == want.get(key, (0, 0)),
              f"f32 SwinV2-Base {key}: launches K4, K6 {got}, expected {want.get(key, (0, 0))}")
    check(emb["K4"].shape == (16, 1024) and torch.isfinite(emb["K4"]).all(), "bad embeddings")
    diff = {"K4 vs plain versions": (emb["K4"] - emb["plain versions"]).abs().max().item(),
            "K4 vs eager": (emb["K4"] - emb["eager"]).abs().max().item(),
            "K6 vs eager": (emb["K6"] - emb["eager"]).abs().max().item()}
    for k, v in diff.items():
        tol = SWIN_EMBED_TOL["plain versions" if "plain" in k else "eager"]
        check(v <= tol, f"f32 SwinV2-Base embeddings, {k}: {v} > {tol}")
    return diff


def phase_swin_f32_embeddings():
    """The f32 SwinV2-Base forward at B = 16 with K4, K6, the plain versions
    and the eager path, its unit embeddings checked (no timing). Random
    normal pixels move the f32 route's embeddings some 20x more than the
    slice's synthetic scans do (PERF.md), so this check sees an accumulation
    drift in K4's and K6's f32 route that the slice's passes."""
    model, fns = _swin_f32_forwards()
    with env_flags(XMIR_FUSED_ATTN="1", XMIR_SWIN_KERNEL=None):
        diff = check_swin_f32_embeddings(fns)
    log(f"[slice] SwinV2-Base f32 batch 16 @384, randomized logit scales: unit embeddings {diff} "
        f"(bounds {SWIN_EMBED_TOL})")
    del model, fns
    torch.cuda.empty_cache()
    return diff


def phase_swin_f32_rates():
    """``_swin_f32_forwards`` checked as ``check_swin_f32_embeddings`` does,
    then timed by CUDA events in turns and by device time (device_ms, "not
    measured" where a forward's launches do not fit behind the spin)."""
    model, fns = _swin_f32_forwards()
    with env_flags(XMIR_FUSED_ATTN="1", XMIR_SWIN_KERNEL=None):
        diff = check_swin_f32_embeddings(fns)
        ms, runs = _in_turns(fns, rounds=3, reps=2)
        dev = {}
        for key, fn in fns.items():
            try:
                dev[key] = device_ms(fn, reps=4)
            except SpinTooShort:
                dev[key] = "not measured"
    log("[rates] SwinV2-Base f32 batch 16 @384 by CUDA events: "
        + "; ".join(f"{k} {ms[k]:.2f} ms = {16 / ms[k] * 1e3:.1f} img/s" for k in ms)
        + "; by device time (device_ms): "
        + "; ".join(f"{k} {v if isinstance(v, str) else f'{v:.4f} ms'}" for k, v in dev.items())
        + f"; unit embeddings {diff} (bounds {SWIN_EMBED_TOL}); runs "
        f"{({k: [round(t, 2) for t in v] for k, v in runs.items()})}")
    del model, fns
    torch.cuda.empty_cache()
    return {"ms": ms, "device_ms": dev, "embedding_max_abs_err": diff}


def phase_f32_train_steps():
    """The f32 train steps that reach K3's and K5's f32 routes, each with the
    kernels and with their plain versions, by CUDA events in turns: DINOv2
    ViT-B/14 at batch 8, 518 px, under XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1 (K3
    in every block); SwinV2-Base at batch 8, 384 px, under XMIR_FUSED_ATTN=1
    (K5 in every block); the MedSigLIP-448 IT-Align step at batch 16 (f32
    towers, bf16 pixels) under XMIR_FLASH_ATTN=1 (K3 in the 2 + 2 unfrozen
    layers). Launches a step checked."""
    from xmir_tpu_torch.cli import train_medsiglip
    from xmir_tpu_torch.models.siglip_text import MedSigLIPDualEncoder

    out = {}
    model, _ = create_model("dinov2", generator=torch.Generator().manual_seed(23))
    with torch.no_grad():  # LayerScale at its 1e-5 init would hide the blocks
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                p.fill_(0.5)
    model = model.to("cuda").train()
    state = TrainState(model, build_optimizer(model, lr=1e-5))
    step = make_embedding_train_step(model, "triplet", {"margin": 0.2})
    x = torch.randn((8, 518, 518, 3), generator=torch.Generator().manual_seed(24)).cuda()
    labels = torch.tensor([0, 0, 0, 0, 1, 1, 1, 1], device="cuda")

    def plain_dinov2():
        with vit_plain_versions():
            step(state, x, labels)

    _f32_step_reading(out, "DINOv2 ViT-B/14 train step at batch 8, 518 px",
                      {"kernels": lambda: step(state, x, labels), "plain versions": plain_dinov2},
                      {"K3": VIT["depth"]}, FUSED_VIT)
    del model, state, step, x
    torch.cuda.empty_cache()

    f32_swin_train_step(out)

    model = MedSigLIPDualEncoder(img_size=448, text_vocab=256000,
                                 generator=torch.Generator().manual_seed(0)).cuda().train()
    frozen = train_medsiglip.frozen_predicate(SIGLIP["depth"], MEDSIGLIP_UNFREEZE)
    for name, p in model.named_parameters():  # as the CLI's build_optimizer leaves them
        p.requires_grad_(not frozen(name))
    state = TrainState(model, build_optimizer(model, lr=1e-4, backbone_lr_scale=1.0,
                                              frozen_predicate=frozen))
    step = make_it_align_train_step(model, torch.bfloat16)
    gen = torch.Generator().manual_seed(40)
    x = torch.randn((16, 448, 448, 3), generator=gen).cuda()
    ids = torch.randint(1, 30000, (16, 64), generator=gen).cuda()

    def plain_medsiglip():
        with vit_plain_versions():
            step(state, x, ids)

    _f32_step_reading(out, "MedSigLIP-448 IT-Align train step at batch 16 (f32 towers, --bf16 "
                           "pixels)",
                      {"kernels": lambda: step(state, x, ids), "plain versions": plain_medsiglip},
                      {"K3": 2 * MEDSIGLIP_UNFREEZE}, MEDSIGLIP_TRAIN_FLAGS)
    del model, state, step, x, ids
    torch.cuda.empty_cache()
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
        out["launches"], out["ckpt"], out["queries"] = launches, ckpt, data[2:]
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
                     "cli.train convnextv2 --bf16", "--resume", pt, first_run=(losses, ckpt))
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
                              "forward + backward": forward_backward}, rounds=3, reps=1)
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
    cli.test --save-dir, cli.compute_saliency --results on 1 query (top 3,
    window 24, stride 5: 2401 masks), cli.evaluate_saliency --saliency-dir
    and the same inline; then the rates of SBSM and of the curves (one
    query's top 5)."""
    from xmir_tpu_torch.cli import compute_saliency, evaluate_saliency
    from xmir_tpu_torch.xai import (
        blur_substrate,
        generate_masks,
        run_causal_metric_pairs_both,
        sbsm_pair_saliency,
        zeros_substrate,
    )

    n, n_q, top_k, rate_k = 64, 1, 3, 5
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
    mesh = mesh_saliency(workdir, common, xai, maps, saved_out, n_q, top_k)
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
    q, r = (torch.randn((k, 224, 224, 3), generator=gen).cuda() for k in (1, rate_k))
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
    rates = {"sbsm_img_per_s": rate_k * masks.shape[0] / sbsm_s,
             "insdel_pair_evals_per_s": rate_k / curves_s, "sbsm_s": sbsm_s, "curves_s": curves_s}
    log(f"[rates] SBSM DenseNet121 @224 f32: {rate_k} x {masks.shape[0]} masked images in "
        f"{sbsm_s:.2f} s = {rates['sbsm_img_per_s']:.0f} images/s; insertion + deletion of "
        f"{rate_k} pairs (52 reveal slots each, both curves) in {curves_s:.3f} s = "
        f"{rates['insdel_pair_evals_per_s']:.1f} pair-evals/s (wall, one query)")
    return {"launches": launches, "rates": rates, "mesh": mesh,
            "card_vs_cpu": {"maps": map_err, "aucs": auc_err},
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
                               "library_device_ms", "fma_bound_ms", "fma_part_ms",
                               "tf32_part_ms"), 0.0)
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
            bnd = attn_bound(ops, nbytes, dtype, "K5")
            bound_ms, by = bnd["bound_ms"], bnd["bound_by"]
            bound_by[by] += count * bound_ms
            for key in ("fma_bound_ms", "fma_part_ms", "tf32_part_ms"):
                total[key] += count * bnd.get(key, 0.0)
            shape = (f"B={b} windows={nw} H={h} N={n} "
                     f"{'shifted' if shifted else 'unshifted'} x{count}")
            out[f"{name} {shape}"] = {"ms": ms["K5"], "plain_ms": ms["plain"],
                                      "library_ms": ms["library"], **bnd, "agreement": e,
                                      "device_ms": dev["K5"], "library_device_ms": dev["library"]}
            for field, key in (("ms", "K5"), ("plain_ms", "plain"), ("library_ms", "library")):
                total[field] += count * ms[key]
            total["device_ms"] += count * dev["K5"]
            total["library_device_ms"] += count * dev["library"]
            total["bound_ms"] += count * bound_ms
            log(f"[rates] K5 {name:8s} {shape}: {ms['K5']:.3f} ms by events "
                f"({ops / ms['K5'] / 1e9:.1f} TFLOP/s of the 10 BH N^2 hd it must do) vs "
                f"plain {ms['plain']:.3f} ms, library ({backend}) {ms['library']:.3f} ms; device "
                f"time K5 {dev['K5']:.4f} ms ({bound_text(bnd, dev['K5'])}), library "
                f"{dev['library']:.4f} ms; agreement {e}")
            del q, k, v, bias, scale, g, o, qf, kf, lq, lk, leaves, lo, lg, fns
            torch.cuda.empty_cache()
        library = f"scaled_dot_product_attention backward (mask gradient), {backend} backend"
        out[name] = dict(total, bound_by=max(bound_by, key=bound_by.get), library=library)
        fma = (f"; FMA part {total['fma_part_ms']:.4f}, 3xTF32 part {total['tf32_part_ms']:.4f}, "
               f"all on FMAs {total['fma_bound_ms']:.4f} ms" if dtype == torch.float32 else "")
        log(f"[rates] K5 {name:8s} the {SWIN_DEPTH} calls of one SwinV2-Base train step at B={b}: "
            f"{total['ms']:.3f} ms by events (plain {total['plain_ms']:.3f}, library "
            f"{total['library_ms']:.3f}); device time K5 {total['device_ms']:.4f} ms, library "
            f"{total['library_device_ms']:.4f} ms "
            f"({total['device_ms'] / total['library_device_ms']:.2f}x); "
            f"bound {total['bound_ms']:.4f} by {out[name]['bound_by']} "
            f"({total['bound_ms'] / total['device_ms']:.1%} of the device time){fma}; "
            f"library = {library}")
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
        out["launches"], out["ckpt"], out["queries"] = launches, ckpt, data[2:]
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
                     "cli.train swinv2 --bf16", "--resume", pt, first_run=(losses, ckpt))
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
                              "forward + backward": forward_backward}, rounds=3, reps=1)
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
    ms, runs = _in_turns(fns, rounds=3, reps=1)
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
    n_g, n_q, batch = 16, 16, 16
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


# ---------------------------------------------------------------------------
# Phases 38-41: the SigLIP family's training and its XAI


# K3 at head width 72 (padded to 80 inside the kernel) at the shapes the
# SigLIP train steps hand it: (dtype, BH, N, what)
SIGLIP_BWD_CASES = (
    (torch.bfloat16, 128, 729, "ConceptCLIP-384 train step, B 8"),
    (torch.float32, 256, 1024, "MedSigLIP-448 train step (vision), B 16"),
    (torch.float32, 256, 64, "MedSigLIP-448 train step (text), B 16"))
SIGLIP_HD = 72


def k3_hd72_check(q, k, v, g, sc):
    """K2 forward + K3 backward through the Function at head width 72: (the
    worst ``va.grad_agreement`` over dq, dk, dv, the same over each head's
    last 8 real lanes 64-71 beside the padding 72-79 on their own, whether
    two runs were bit-equal, whether every gradient is finite, the forward's
    output and the gradients)."""
    out, grads = attention_grads(q, k, v, g, sc)
    _, again = attention_grads(q, k, v, g, sc)
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(grads, again))
    finite = all(bool(torch.isfinite(t.float()).all()) for t in grads)
    refs = va.attention_bwd_plain(q, k, v, out, g, sc)
    whole, lanes = {}, {}
    for a, r, floor in zip(grads, refs, va.grad_floors(q, k, v, g, sc)):
        _worst(whole, va.grad_agreement(a, r, floor))
        _worst(lanes, va.grad_agreement(a[..., 64:], r[..., 64:], floor))
    return whole, lanes, equal, finite, out, grads


def k3_hd72_reading(dtype):
    """K3's worst readings over phase 38's shapes of ``dtype`` (chip_faults.py
    plants faults against it): {"of_bound", "mean_of_bound", ...,
    "lanes_64_71": ..., "runs_bit_equal", "finite"}."""
    gen = torch.Generator().manual_seed(38)
    worst, lanes_worst, equal, finite = {}, {}, True, True
    for dt, bh, n, _ in SIGLIP_BWD_CASES:
        if dt != dtype:
            continue
        q, k, v = _attn_inputs(gen, bh, n, SIGLIP_HD, dtype)
        g = _attn_inputs(gen, bh, n, SIGLIP_HD, dtype)[0]
        whole, lanes, eq, fin, *_ = k3_hd72_check(q, k, v, g, SIGLIP_HD ** -0.5)
        _worst(worst, whole)
        _worst(lanes_worst, lanes)
        equal, finite = equal and eq, finite and fin
        del q, k, v, g
        torch.cuda.empty_cache()
    return dict(worst, lanes_64_71=lanes_worst, runs_bit_equal=equal, finite=finite)


def k3_hd72_agrees(reading) -> bool:
    return (va.grad_agrees(reading) and va.grad_agrees(reading["lanes_64_71"])
            and reading["runs_bit_equal"] and reading["finite"])


def phase_kernel_siglip_bwd():
    """K2 (with statistics) and K3 at head width 72 at the SigLIP train
    steps' shapes: held to their plain versions (va.grad_agreement, each
    head's lanes 64-71 beside the padding on their own; k2_agreement), two
    runs bit-equal, f32 also to the exact gradient; then timed beside SDPA's
    backward (the default dispatch's backend, pinned once outside the timed
    windows) by CUDA events in turns and device_ms; ptxas's C75xx lines for
    vit_attn_bwd.cu."""
    gen = torch.Generator().manual_seed(38)
    out = {"err": {}, "rates": {}}
    for dtype, bh, n, what in SIGLIP_BWD_CASES:
        name, hd, sc = str(dtype)[6:], SIGLIP_HD, SIGLIP_HD ** -0.5
        label = f"BH={bh} N={n} hd={hd} ({what})"
        q, k, v = _attn_inputs(gen, bh, n, hd, dtype)
        g = _attn_inputs(gen, bh, n, hd, dtype)[0]
        whole, lanes, equal, finite, o, grads = k3_hd72_check(q, k, v, g, sc)
        check(equal, f"K3 {name} {label}: two runs differ")
        check(finite, f"K3 {name} {label}: non-finite gradients")
        for e, part in ((whole, "dq, dk, dv"), (lanes, "lanes 64-71 of every head")):
            check(va.grad_agrees(e), f"K3 {name} {label}, {part}: past the bounds (GRAD_RTOL, "
                                     f"GRAD_MEAN_RTOL): {e}")
        e2 = vit_err(o, va.attention_plain(q, k, v, sc), k2_agreement(q, k, v, sc),
                     f"K2 {name} {label}")
        exact = ""
        if dtype == torch.float32:
            floors = va.grad_floors(q, k, v, g, sc)
            rel = max(((a - b).abs().max() / torch.maximum(b.abs().max(), floor)).item()
                      for a, b, floor in zip(grads, va.attention_bwd_reference(q, k, v, g, sc),
                                             floors))
            check(rel <= K3_EXACT_RTOL, f"K3 f32 {label}: {rel} of the largest magnitude from "
                                        f"the exact gradient > {K3_EXACT_RTOL}")
            exact = f"; within {rel:.2g} of the exact gradient (bound {K3_EXACT_RTOL})"
        out["err"][f"{name} {label}"] = {"K3": whole, "K3 lanes 64-71": lanes, "K2": e2}
        log(f"[kernel] K3 {name:8s} {label}: {whole}; lanes 64-71 {lanes}; twice bit-equal"
            f"{exact}; K2 with statistics {e2}")
        del grads, o
        # times: K3 on the forward's statistics, its plain version, SDPA's backward
        o, stats = va.launch_attention_forward(q, k, v, sc, want_stats=True)
        b, h = bh // SIGLIP["heads"], SIGLIP["heads"]
        lq, lk, lv = (t.reshape(b, h, n, hd).detach().requires_grad_(True) for t in (q, k, v))
        backend = sdpa_backend(lambda: F.scaled_dot_product_attention(lq, lk, lv))
        lo = under_backend(backend, lambda: F.scaled_dot_product_attention(lq, lk, lv))
        lg = g.reshape(b, h, n, hd)
        fns = {"K3": lambda: va.vit_attention_bwd(q, k, v, o, g, stats, sc),
               "K3 library": lambda: torch.autograd.grad(lo, (lq, lk, lv), lg, retain_graph=True),
               "K2 with statistics": lambda: va.launch_attention_forward(q, k, v, sc, True)}
        reps = 20 if dtype == torch.bfloat16 else 4
        with sdpa_pinned(backend):
            ms, _ = _in_turns(fns, reps=reps)
            dev = {key: device_ms(fns[key], reps=reps) for key in ("K3", "K3 library")}
        ms.update(_in_turns({"K3 plain": lambda: va.attention_bwd_plain(q, k, v, o, g, sc)},
                            rounds=1, reps=1)[0])
        ops, nbytes = _bwd_work(bh, n, hd, dtype)
        bnd = attn_bound(ops, nbytes, dtype)
        out["rates"][f"{name} BH={bh} N={n}"] = {
            "ms": ms["K3"], "plain_ms": ms["K3 plain"], "library_ms": ms["K3 library"],
            "forward_ms": ms["K2 with statistics"], "device_ms": dev["K3"],
            "library_device_ms": dev["K3 library"], **bnd,
            "library": f"scaled_dot_product_attention backward, {backend}", "what": what}
        log(f"[rates] K3 {name:8s} {label}: device time {dev['K3']:.4f} ms "
            f"({ops / dev['K3'] / 1e9:.1f} TFLOP/s of the 10 BH N^2 hd; "
            f"{bound_text(bnd, dev['K3'])}), events {ms['K3']:.3f} ms; plain "
            f"{ms['K3 plain']:.3f} ms; SDPA's backward ({backend}) device time "
            f"{dev['K3 library']:.4f} ms, events {ms['K3 library']:.3f} ms (K3 "
            f"{dev['K3'] / dev['K3 library']:.2f}x it); K2 with statistics "
            f"{ms['K2 with statistics']:.3f} ms")
        del q, k, v, g, o, stats, lq, lk, lv, lo, lg, fns
        torch.cuda.empty_cache()
    found = ptxas_serialisations().get("vit_attn_bwd.cu", [])
    out["ptxas_vit_attn_bwd"] = found
    log(f"[kernel] build.log: ptxas reports {len(found)} C75xx line(s) for vit_attn_bwd.cu: "
        + " | ".join(found))
    return out


# MedSigLIP's --bf16 casts the pixels only: the f32 tower takes K2 / K3 in
# f32 under XMIR_FLASH_ATTN=1 (K7 stays off at head width 72 without
# XMIR_FUSED_LN_QKV72)
MEDSIGLIP_TRAIN_FLAGS = dict(XMIR_FLASH_ATTN="1", XMIR_FUSED_LN=None, XMIR_FUSED_LN_QKV=None,
                             XMIR_FUSED_LN_QKV72=None, XMIR_FUSED_LN_MLP=None)
# the first step's f32 loss with the kernels against their plain versions,
# of |loss|: the IT-Align loss of 27-layer towers whose f32 sums run in
# other orders (PERF.md §6)
SIGLIP_TRAIN_LOSS_RTOL = 1e-4
MEDSIGLIP_UNFREEZE = 2  # the CLI's --unfreeze-layers default: K3 in 2 layers a tower


# the largest model registry_draws_cached keeps a draw of: the SigLIP family's
# towers (400M and up) are shared by registry_models_drawn_once instead
DRAW_CACHE_PARAMS = 2 * 10 ** 8


@contextlib.contextmanager
def registry_draws_cached(keep=4):
    """``registry.create_model`` with a seeded generator draws its weights on
    the host once per (name, arguments, seed): later calls get a deep copy of
    the first draw, the same weights bit for bit, in a model of their own
    (which they may train), for ~0.1 s where a full-width draw takes ~1.5 s.
    The ``keep`` most recent draws are held on the host."""
    from xmir_tpu_torch.models import registry

    real, drawn = registry.create_model, collections.OrderedDict()

    def create(name, **overrides):
        gen = overrides.get("generator")
        if gen is None:
            return real(name, **overrides)
        key = (name, tuple(sorted((k, v) for k, v in overrides.items() if k != "generator")),
               gen.initial_seed())
        if key in drawn:
            drawn.move_to_end(key)
            model, spec = drawn[key]
            return copy.deepcopy(model), spec
        model, spec = real(name, **overrides)
        if sum(p.numel() for p in model.parameters()) <= DRAW_CACHE_PARAMS:
            drawn[key] = (copy.deepcopy(model), spec)
            while len(drawn) > keep:
                drawn.popitem(last=False)
        return model, spec

    registry.create_model = create
    try:
        yield
    finally:
        registry.create_model = real


@contextlib.contextmanager
def registry_models_drawn_once():
    """``registry.create_model`` memoised for a phase: the CLIs' calls with
    the same name, arguments and seed get one model, drawn on the host once
    (a full-width SigLIP tower takes ~10 s to draw) and shared, as the CLIs
    of one process would share it; the phase must not train it."""
    from xmir_tpu_torch.models import registry

    real, drawn = registry.create_model, {}

    def create(name, **overrides):
        gen = overrides.get("generator")
        key = (name, tuple(sorted((k, v) for k, v in overrides.items() if k != "generator")),
               gen.initial_seed() if gen is not None else None)
        if key not in drawn:
            drawn[key] = real(name, **overrides)
        return drawn[key]

    registry.create_model = create
    try:
        yield
    finally:
        registry.create_model = real


@contextlib.contextmanager
def drawn_once(module, name, model, **want):
    """The CLI's ``module.name(...)`` (a model class it builds from a seeded
    generator) handing back ``model``, which the caller drew with the same
    arguments: the full-width weights are drawn on the host once for a
    phase (tens of seconds each), not once a run. Raises if the CLI asks for
    other arguments or another seed."""
    real = getattr(module, name)

    def build(**kwargs):
        seed = kwargs.pop("generator").initial_seed()
        check(kwargs == {k: v for k, v in want.items() if k != "seed"} and seed == want["seed"],
              f"the CLI built {name}({kwargs}, seed {seed}), not {want}")
        return model

    setattr(module, name, build)
    try:
        yield
    finally:
        setattr(module, name, real)


def phase_train_medsiglip(workdir: Path):
    """cli.train_medsiglip at google/medsiglip-448's widths (27 + 27 layers,
    C = 1152, 16 heads of 72, a 256,000-token text table, seq-len 64) with
    --bf16 --batch-size 16 on a generated COVIDx tree and vocab.txt, one
    epoch of 3 steps under XMIR_FLASH_ATTN=1: K2 = 54 and K3 = 4 a step
    exactly; the first step's loss bit-equal to the same seeded model's
    loss on that batch, which lies within SIGLIP_TRAIN_LOSS_RTOL of the
    kernels' plain versions'; frozen tensors bit-equal, trained ones moved;
    the step's readings (step_reading); then cli.zeroshot --dual-checkpoint
    reads the checkpoint strictly."""
    from xmir_tpu_torch.cli import train_medsiglip
    from xmir_tpu_torch.models import siglip_text
    from xmir_tpu_torch.models.siglip_text import COVIDX_LABEL_TO_TEXT, MedSigLIPDualEncoder

    common.set_tf32(False)  # as the CLI sets it: its first loss is compared bit for bit
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    img_dir, manifest = write_synthetic_covidx(str(workdir / "ms_train"), n=60, size=256,
                                               seed=39)
    vocab = str(workdir / "ms_vocab.txt")
    write_vocab(vocab, [COVIDX_LABEL_TO_TEXT[i] for i in range(3)])
    ckpt = str(workdir / "medsiglip_dual.pt")
    cli_args = ["--dataset", "covid", "--dataset-dir", img_dir, "--train-image-list", manifest,
                "--vocab", vocab, "--bf16", "--batch-size", "16", "--epochs", "1",
                "--seq-len", "64", "--lr", "1e-4", "--device", "cuda", "--seed", "0",
                "--save", ckpt]
    args = train_medsiglip.parse_args(cli_args)
    ds = common.build_dataset(args, "train")
    labels = np.asarray(ds.labels)
    table = train_medsiglip.class_token_table(args, sorted(set(labels.tolist())))
    batches = list(train_medsiglip.epoch_batches(ds, labels, 16, 448, 1, "cuda"))
    steps = len(batches)
    check(steps == 3, f"the generated tree gives {steps} batches of 16, not 3")
    x, labs = batches[0]
    ids = train_medsiglip.class_token_ids(table, labs, 64).cuda()
    del batches
    model = MedSigLIPDualEncoder(img_size=448, text_vocab=args.vocab_size,
                                 generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.cuda().train()
    frozen = train_medsiglip.frozen_predicate(SIGLIP["depth"], MEDSIGLIP_UNFREEZE)
    for name, p in model.named_parameters():  # as the CLI's build_optimizer leaves them
        p.requires_grad_(not frozen(name))
    log(f"[slice] MedSigLIP training: wrote 60 PNGs and a {args.vocab_size}-token table's "
        f"vocab.txt, drew the dual encoder in {time.perf_counter() - t0:.1f} s")
    with env_flags(**MEDSIGLIP_TRAIN_FLAGS):
        loss_of = make_it_align_train_step(model, torch.bfloat16).losses
        reset_launches()
        loss_k = loss_of(x, ids)
        launches = read_launches()
        check(launches["K2"] == 2 * SIGLIP["depth"] and launches["K3"] == 0,
              f"one MedSigLIP forward: launches {launches}, expected K2 = 54")
        with vit_plain_versions():
            loss_p = loss_of(x, ids)
        diff = abs(loss_k.item() - loss_p.item())
        check(math.isfinite(loss_k.item())
              and diff <= SIGLIP_TRAIN_LOSS_RTOL * abs(loss_p.item()),
              f"the first step's loss {loss_k.item()} lies {diff} from the plain versions' "
              f"{loss_p.item()}")
        log(f"[slice] MedSigLIP-448 f32 IT-Align loss of the first batch: kernels "
            f"{loss_k.item():.7f}, plain versions {loss_p.item():.7f} ({diff:.3g} apart, bound "
            f"{SIGLIP_TRAIN_LOSS_RTOL} of it)")
        first = loss_k.item()
        del loss_k, loss_p
        reset_launches()
        t0 = time.perf_counter()
        with drawn_once(siglip_text, "MedSigLIPDualEncoder", model, img_size=448,
                        text_vocab=args.vocab_size, dim=SIGLIP["c"], depth=SIGLIP["depth"],
                        seed=0):
            result = train_medsiglip.main(cli_args)
        wall = time.perf_counter() - t0
        launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(K2=2 * SIGLIP["depth"] * steps, K3=2 * MEDSIGLIP_UNFREEZE * steps)
    check(launches == want, f"cli.train_medsiglip: launches {launches}, expected {want} (27 + 27 "
                            f"layers and 2 + 2 unfrozen a step, {steps} steps)")
    losses = result["losses"]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses), f"losses {losses}")
    check(losses[0] == first, f"the CLI's first loss {losses[0]} != the same step's {first}")
    sd = load_checkpoint(ckpt)
    check(sorted(sd) == sorted(init), "the checkpoint's names differ from the model's")
    trained = [n_ for n_ in init if not frozen(n_)]
    still = [n_ for n_ in trained if torch.equal(sd[n_], init[n_])]
    moved = [n_ for n_ in init if frozen(n_) and not torch.equal(sd[n_], init[n_])]
    check(not moved and not still, f"frozen tensors moved: {moved[:4]}; trained ones did not: "
                                   f"{still[:4]}")
    log(f"[slice] cli.train_medsiglip --bf16 -b 16 (f32 towers, XMIR_FLASH_ATTN=1): launches "
        f"{launches} ({steps} steps: K2 27 + 27 a step, K3 in the 2 unfrozen layers of each "
        f"tower); losses {[round(v, 5) for v in losses]}, the first bit-equal to the seeded "
        f"model's; {len(trained)} trained tensors moved, {len(init) - len(trained)} frozen ones "
        f"bit-equal; {wall:.1f} s wall (the weights drawn once, above)")
    # the step's readings, on the trained model with a fresh optimiser
    state = TrainState(model, build_optimizer(model, lr=1e-4, backbone_lr_scale=1.0,
                                              frozen_predicate=frozen))
    step = make_it_align_train_step(model, torch.bfloat16)
    with env_flags(**MEDSIGLIP_TRAIN_FLAGS):
        rates = step_reading("MedSigLIP-448 train step (f32 towers, --bf16 pixels, "
                             "XMIR_FLASH_ATTN=1) at batch 16",
                             {"step": lambda: step(state, x, ids),
                              "forward": lambda: step.losses(x, ids)}, 16)
    del model, state, step, x, ids
    torch.cuda.empty_cache()
    del sd, init
    buf = io.StringIO()
    with env_flags(**MEDSIGLIP_TRAIN_FLAGS), contextlib.redirect_stdout(buf):
        reset_launches()
        zs = zeroshot_cli.main(["--dataset", "covid", "--dataset-dir", img_dir,
                                "--test-image-list", manifest, "--model", "medsiglip",
                                "--embedding-dim", "1152", "--device", "cuda",
                                "--dual-checkpoint", ckpt, "--vocab", vocab,
                                "--text-vocab-size", str(args.vocab_size)])
        zs_launches = read_launches()
    printed = buf.getvalue()
    check("(strict)" in printed and 0 <= zs["accuracy"] <= 1, "cli.zeroshot did not read the "
                                                              "trained checkpoint strictly")
    image_batches = -(-len(labels) // 32)
    check(zs_launches["K2"] == SIGLIP["depth"] * (image_batches + 1) and zs_launches["K3"] == 0,
          f"cli.zeroshot after training: launches {zs_launches}")
    log(f"[slice] cli.zeroshot --dual-checkpoint on the trained encoder: "
        f"{printed.strip().splitlines()[0]}; accuracy {zs['accuracy']:.4f}; launches "
        f"{zs_launches}")
    return {"launches": {"medsiglip_train": launches, "medsiglip_train_zeroshot": zs_launches},
            "losses": losses, "first_loss_vs_plain": diff, "step": rates,
            "zeroshot_accuracy": zs["accuracy"]}


def write_vindr_concept_tree(root: Path, n: int, seed: int, size: int = 256):
    """A VinDr-CXR tree: ``{image_id}.png`` and a CSV of two radiologists'
    rows a study over the 28 columns (findings at 15%, one study normal)."""
    from PIL import Image

    from xmir_tpu_torch.data.datasets import VINDR_ALL_COLUMNS

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = [",".join(["image_id", "rad_id"] + VINDR_ALL_COLUMNS)]
    for i in range(n):
        image_id = f"study{i:03d}"
        pix = rng.integers(0, 255, (size // 8, size // 8), dtype=np.uint8)
        Image.fromarray(np.kron(pix, np.ones((8, 8), np.uint8))).convert("RGB").save(
            root / f"{image_id}.png")
        for r in range(2):
            v = (rng.random(len(VINDR_ALL_COLUMNS)) < 0.15).astype(int)
            if i == 0:
                v[:] = 0
                v[VINDR_ALL_COLUMNS.index("No finding")] = 1
            lines.append(",".join([image_id, f"R{r}"] + [str(x) for x in v]))
    csv_path = root / "vindr.csv"
    csv_path.write_text("\n".join(lines) + "\n")
    return str(root), str(csv_path)


CONCEPTCLIP_UNFREEZE = 4  # the CLI's --unfreeze-vision-layers default: K3 in 4 layers
# the first step's RC-Align term, deduped against every slot: the text tower
# encodes each concept in a batch of another size, so cuBLAS's bf16 products
# may round it otherwise (PERF.md §6); IT-Align is bit-equal
CONCEPT_DEDUPE_RC_RTOL = 5e-3


def concept_gather_check(reps: int = 10):
    """ConceptGather's backward on the card at a ConceptCLIP batch's shape
    (64 slots of 1152, 24 rows, one row shared by half the slots), bf16:
    {"runs_bit_equal": ``reps`` runs bit-equal, "ulps": its largest distance
    from the f32 sum of each row's slots rounded once, in bf16 steps of that
    sum}. An atomic (index_add_) backward would add in bf16 in no fixed
    order."""
    from xmir_tpu_torch.train import ConceptGather

    gen = torch.Generator().manual_seed(40)
    inverse = torch.randint(0, 24, (8, 8), generator=gen).int()
    inverse[:, :4] = 3
    feats = torch.randn((24, 1152), generator=gen).to(torch.bfloat16)
    g = torch.randn((8, 8, 1152), generator=gen).to(torch.bfloat16)
    want = torch.zeros((24, 1152), dtype=torch.float64).index_add_(
        0, inverse.reshape(-1).long(), g.double().reshape(64, 1152))
    inverse, feats_c, g_c = inverse.cuda(), feats.cuda(), g.cuda()
    runs = []
    for _ in range(reps):
        leaf = feats_c.clone().requires_grad_(True)
        runs.append(torch.autograd.grad(ConceptGather.apply(leaf, inverse), leaf, g_c)[0])
    torch.cuda.synchronize()
    step = cb.bf16_step(want.to(torch.bfloat16).float()).double()
    ulps = ((runs[0].cpu().double() - want).abs() / step).max().item()
    return {"runs_bit_equal": all(torch.equal(runs[0], r) for r in runs[1:]), "ulps": ulps}


# the f32 slot sums rounded once to bf16: within one bf16 step of the exact sum
CONCEPT_GATHER_ULPS = 1.0


def concept_gather_agrees(reading) -> bool:
    return reading["runs_bit_equal"] and reading["ulps"] <= CONCEPT_GATHER_ULPS


def phase_train_conceptclip(workdir: Path):
    """cli.train_conceptclip at ConceptCLIP's widths (SO400M at 384 px: 729
    tokens, 27 layers; a 12-layer 768-wide BERT) with --bf16 --batch-size 8
    --max-concepts 8 --concept-len 16 on a generated VinDr CSV and PNGs:
    one epoch of 3 steps deduped, again (bit-equal: losses and every
    tensor), and with --no-dedupe-concepts (the first step's IT-Align
    bit-equal, its RC-Align within CONCEPT_DEDUPE_RC_RTOL); K2 = 27 and K3 = 4
    a step exactly; ConceptGather's backward bit-equal over 10 runs and
    within a bf16 step of the exact slot sums (concept_gather_check); the
    deduped and every-slot steps' readings (step_reading)."""
    from xmir_tpu_torch.cli import train_conceptclip
    from xmir_tpu_torch.data.datasets import CONCEPT_DESCRIPTIONS, DISEASE_DESCRIPTIONS
    from xmir_tpu_torch.models import embedders
    from xmir_tpu_torch.models.embedders import ConceptCLIPModel

    data_dir, csv_path = write_vindr_concept_tree(workdir / "vindr", n=26, seed=40)
    base = ["--dataset", "vindr", "--dataset-dir", data_dir, "--train-image-list", csv_path,
            "--bf16", "--batch-size", "8", "--epochs", "1", "--max-concepts", "8",
            "--concept-len", "16", "--lr", "1e-4", "--device", "cuda", "--seed", "0"]
    args = train_conceptclip.parse_args(base)
    ds = train_conceptclip.concept_dataset(args)
    texts = [t for i in range(len(ds)) for t in [ds.get_text(i)[0], *ds.get_text(i)[1]]]
    vocab = str(workdir / "cc_vocab.txt")
    n_vocab = write_vocab(vocab, texts + list(CONCEPT_DESCRIPTIONS.values())
                          + list(DISEASE_DESCRIPTIONS.values()))
    base += ["--vocab", vocab]
    args = train_conceptclip.parse_args(base)
    steps = len(ds) // 8
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(K2=SIGLIP["depth"] * steps, K3=CONCEPTCLIP_UNFREEZE * steps)
    t0 = time.perf_counter()
    vocab_size = max(args.vocab_size, n_vocab)  # as the CLI raises it for a bigger vocab.txt
    model = ConceptCLIPModel(img_size=384, text_vocab=vocab_size,
                             generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    model = model.cuda()
    log(f"[slice] ConceptCLIP training: drew the model in {time.perf_counter() - t0:.1f} s")
    runs, out = {}, {"launches": {}}
    for path, extra in (("deduped", []), ("deduped again", []),
                        ("every slot", ["--no-dedupe-concepts"])):
        ckpt = str(workdir / f"conceptclip_{path.replace(' ', '_')}.pt")
        model.load_state_dict(init)  # each run starts from the seeded weights
        with env_flags(XMIR_FLASH_ATTN=None, XMIR_FUSED_LN=None, XMIR_FUSED_LN_QKV72=None), \
                drawn_once(embedders, "ConceptCLIPModel", model, img_size=384, dim=SIGLIP["c"],
                           depth=SIGLIP["depth"], text_depth=12, text_vocab=vocab_size,
                           seed=0):
            reset_launches()
            t0 = time.perf_counter()
            result = train_conceptclip.main(base + extra + ["--save", ckpt])
            wall = time.perf_counter() - t0
            launches = read_launches()
        check(launches == want, f"cli.train_conceptclip ({path}): launches {launches}, expected "
                                f"{want} (27 layers, K3 in the 4 unfrozen, {steps} steps)")
        hist = result["history"]
        check(len(hist) == steps and all(math.isfinite(m[key]) for m in hist for key in m),
              f"cli.train_conceptclip ({path}): {hist}")
        runs[path] = (hist, ckpt)
        out["launches"][f"conceptclip_train_{path.replace(' ', '_')}"] = launches
        log(f"[slice] cli.train_conceptclip --bf16 -b 8 ({path}): launches {launches}; losses "
            f"{[round(m['loss'], 5) for m in hist]}; {wall:.1f} s wall")
    (a, ca), (b, cb_), (c, _) = runs["deduped"], runs["deduped again"], runs["every slot"]
    sa, sb = load_checkpoint(ca), load_checkpoint(cb_)
    check(a == b and all(torch.equal(sa[k], sb[k]) for k in sa),
          "two deduped runs differ (losses or tensors)")
    del sb
    check(a[0]["it_loss"] == c[0]["it_loss"], f"the first step's IT-Align: deduped "
                                              f"{a[0]['it_loss']} != every slot {c[0]['it_loss']}")
    rc_rel = abs(a[0]["rc_loss"] - c[0]["rc_loss"]) / abs(c[0]["rc_loss"])
    check(rc_rel <= CONCEPT_DEDUPE_RC_RTOL, f"the first step's RC-Align, deduped against every "
                                            f"slot: {rc_rel} of it apart")
    gather = concept_gather_check()
    check(concept_gather_agrees(gather), f"ConceptGather's backward: {gather} (runs bit-equal, "
                                         f"within {CONCEPT_GATHER_ULPS} bf16 step of the sum)")
    log(f"[slice] ConceptCLIP: two deduped runs bit-equal (losses and all {len(sa)} tensors); "
        f"the first step deduped against every slot: IT-Align bit-equal, RC-Align "
        f"{rc_rel:.3g} of it apart (bound {CONCEPT_DEDUPE_RC_RTOL}); ConceptGather's backward "
        f"bit-equal over 10 runs, {gather['ulps']:.3g} bf16 steps from the exact slot sums; a "
        f"{n_vocab}-token vocab.txt")
    out.update(losses={k: v[0] for k, v in runs.items()}, first_rc_rel=rc_rel,
               checkpoint=ca, data=(data_dir, csv_path), vocab=vocab)
    # the step's readings: the seeded weights, the first batch deduped and not
    tok = train_conceptclip.text_tokenizer(args)
    model.load_state_dict(init)
    del init
    state = TrainState(model, build_optimizer(
        model, lr=1e-4, backbone_lr_scale=1.0, weight_decay=0.01, mu_dtype=torch.bfloat16,
        frozen_predicate=train_conceptclip.frozen_predicate(27, 12, CONCEPTCLIP_UNFREEZE, 2)))
    deduped = next(train_conceptclip.epoch_batches(ds, tok, args, 1, "cuda", True))
    slots = next(train_conceptclip.epoch_batches(ds, tok, args, 1, "cuda", False))
    step = make_conceptclip_train_step(model, compute_dtype=torch.bfloat16, dedupe_concepts=True)
    step_all = make_conceptclip_train_step(model, compute_dtype=torch.bfloat16)
    with env_flags(XMIR_FLASH_ATTN=None, XMIR_FUSED_LN=None, XMIR_FUSED_LN_QKV72=None):
        out["step"] = step_reading("ConceptCLIP-384 bf16 train step (deduped concepts) at batch 8",
                                   {"step": lambda: step(state, *deduped),
                                    "step, every slot": lambda: step_all(state, *slots),
                                    "forward": lambda: step.losses(*deduped)}, 8)
    del model, state, step, step_all, deduped, slots, sa
    torch.cuda.empty_cache()
    return out


# full-width MedSigLIP tower at 224 px (256 tokens; the positions resized):
# the card with the kernels against the CPU's plain path (sbsm_feature_saliency,
# fsal_grad_saliency) or the card's eager path (sim_score_cam, whose 1,154
# forwards the CPU cannot run in a smoke run), of each map's scale (PERF.md)
VARIANT_TOL = 1e-3


def phase_siglip_xai(workdir: Path, conceptclip):
    """--explainer gradcam_sim through cli.compute_saliency and
    cli.evaluate_saliency on MedSigLIP-448 (f32, XMIR_FLASH_ATTN=1: K2 in
    every layer, K3 never: the gradient stops at the tap); Grad-CAM maps/s;
    cli.xai_conceptclip on ConceptCLIP-384 from phase 40's checkpoint and
    data; sbsm_feature_saliency, fsal_grad_saliency (a seeded probe) and
    sim_score_cam on a full-width MedSigLIP tower at 224 px against the
    CPU's plain path or the card's eager path."""
    import copy

    from xmir_tpu_torch.cli import compute_saliency, evaluate_saliency, xai_conceptclip
    from xmir_tpu_torch.xai import (
        generate_masks,
        make_vit_gradcam_fn,
        sbsm_feature_saliency,
        sim_score_cam,
        vit_gradcam_similarity,
    )
    from xmir_tpu_torch.xai.variants import fsal_grad_saliency

    common.set_tf32(False)  # IEEE f32 on the card, as on the CPU it is held to
    out = {"launches": {}}
    img_dir, manifest = write_synthetic_covidx(str(workdir / "gc"), n=8, size=256, seed=41)
    data = ["--dataset", "covid", "--dataset-dir", img_dir, "--test-image-list", manifest,
            "--model", "medsiglip", "--device", "cuda", "--seed", "0", "-j", "8",
            "--explainer", "gradcam_sim", "--limit", "2"]
    flags = dict(MEDSIGLIP_TRAIN_FLAGS)
    # compute_saliency and evaluate_saliency build one model: drawn once
    with registry_models_drawn_once(), env_flags(**flags):
        reset_launches()
        t0 = time.perf_counter()
        compute_saliency.main(data + ["--save-dir", str(workdir / "gc_maps")])
        wall = time.perf_counter() - t0
        launches = read_launches()
        want = dict.fromkeys(WRAPPERS, 0)
        want["K2"] = 2 * 2 * SIGLIP["depth"]  # a query: its embedding and the map's forward
        check(launches == want, f"compute_saliency gradcam_sim: launches {launches}, "
                                f"expected {want}")
        names = sorted(p.name for p in (workdir / "gc_maps").iterdir())
        check(names == ["gradcam_q00000_r00001.npy", "gradcam_q00001_r00002.npy"],
              f"maps {names}")
        for name in names:
            m = np.load(workdir / "gc_maps" / name)
            check(m.shape == (448, 448) and np.isfinite(m).all() and m.min() >= 0
                  and m.max() <= 1 + 1e-6, f"{name}: shape {m.shape}, range {m.min()}..{m.max()}")
        out["launches"]["gradcam_compute_saliency"] = launches
        log(f"[slice] compute_saliency --explainer gradcam_sim (MedSigLIP-448, f32): launches "
            f"{launches}; {names} in [0, 1]; {wall:.1f} s wall")
        reset_launches()
        t0 = time.perf_counter()
        res = evaluate_saliency.main(data + ["--top-k", "2", "--step", "20000", "--output",
                                             str(workdir / "gc_insdel.json")])
        wall = time.perf_counter() - t0
        launches = read_launches()
    aucs = [r[k] for r in res["results"] for k in ("deletion_auc", "insertion_auc")]
    check(launches["K1"] == 1 and launches["K3"] == 0 and launches["K2"] > 0
          and launches["K2"] % SIGLIP["depth"] == 0, f"evaluate_saliency gradcam_sim: {launches}")
    check(len(res["results"]) == 2 and all(0 <= a <= 1 for a in aucs), f"AUCs {aucs}")
    out["launches"]["gradcam_evaluate_saliency"] = launches
    log(f"[slice] evaluate_saliency --explainer gradcam_sim (inline maps, top 2, step 20000): "
        f"launches {launches}; AUCs {[round(a, 4) for a in aucs]}; {wall:.1f} s wall")

    model, _ = create_model("medsiglip", generator=torch.Generator().manual_seed(42))
    model = randomize_norms_(model, 42).eval()
    cpu = copy.deepcopy(model)
    model = model.cuda()
    gen = torch.Generator().manual_seed(43)
    xs = (0.5 * torch.randn((6, 448, 448, 3), generator=gen)).cuda()
    apply_fn, embed = make_vit_gradcam_fn(model), make_embed_fn(model)
    with env_flags(**flags):
        q = embed(xs[:1])[0]
        maps = vit_gradcam_similarity(apply_fn, q, xs[1:])
        check(maps.shape == (5, 448, 448) and bool(torch.isfinite(maps).all()), "gradcam maps")
        ms, _ = _in_turns({"gradcam": lambda: vit_gradcam_similarity(apply_fn, q, xs[1:])},
                          rounds=1, reps=3)
    out["gradcam_maps_per_s"] = 5 / ms["gradcam"] * 1e3
    log(f"[rates] Grad-CAM on similarity, MedSigLIP-448 f32 (XMIR_FLASH_ATTN=1), 5 retrieved "
        f"images a call: {ms['gradcam']:.1f} ms = {out['gradcam_maps_per_s']:.1f} maps/s")

    # the variants at 224 px on the full-width tower
    size, d = 224, SIGLIP["c"]
    x224 = (0.5 * torch.randn((2, size, size, 3), generator=gen))
    masks = torch.from_numpy(generate_masks(size, 48, 24))
    coef = torch.randn((1, 512), generator=gen).numpy()
    probe = type("Probe", (), {})()
    probe.clf = type("Clf", (), {"coef_": coef, "intercept_": np.asarray([0.1])})()

    def fns_of(m):
        def features(x):
            with torch.no_grad():
                t = m.backbone(x)["tokens"]
            g_ = int(round(t.shape[1] ** 0.5))
            return t.reshape(t.shape[0], g_, g_, d)

        def head(f):
            return l2_normalize(m.projection(m.backbone.head(f.reshape(f.shape[0], -1, d))),
                                dim=1)

        return make_embed_fn(m), features, head

    def run_variants(m, x, mk, with_score_cam):
        e_fn, f_fn, h_fn = fns_of(m)
        got = {"sbsm_feature_saliency": sbsm_feature_saliency(e_fn, f_fn, x[:1], x[1:], mk),
               "fsal_grad_saliency": fsal_grad_saliency(f_fn, h_fn, probe, x)}
        if with_score_cam:
            got["sim_score_cam"] = sim_score_cam(e_fn, f_fn, x[:1], x[1:], chunk=64)
        return {k: v.float().cpu() for k, v in got.items()}

    with env_flags(**flags):
        reset_launches()
        t0 = time.perf_counter()
        card = run_variants(model, x224.cuda(), masks.cuda(), True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
    check(launches["K2"] > 0 and launches["K3"] == 0, f"the variants' launches {launches}")
    with env_flags(XMIR_FLASH_ATTN="0"):
        eager = run_variants(model, x224.cuda(), masks.cuda(), True)
    t1 = time.perf_counter()
    host = run_variants(cpu, x224, masks, False)
    cpu_wall = time.perf_counter() - t1
    errs = {}
    for name, m in card.items():
        # sim_score_cam weights the activations themselves, which may be negative
        check(bool(torch.isfinite(m).all()) and (name == "sim_score_cam" or m.min() >= 0),
              f"{name}: not finite, or negative")
        refs = {"eager on the card": eager[name]}
        if name in host:
            refs["the CPU's plain path"] = host[name]
        scale = m.abs().max().item() or 1.0
        if name == "sbsm_feature_saliency":  # of the mean features' size (distances' scale)
            with torch.no_grad():
                scale = fns_of(model)[1](x224[:1].cuda()).mean(dim=(1, 2)).norm().item()
        for what, ref in refs.items():
            e = (m - ref).abs().max().item() / scale
            check(e <= VARIANT_TOL, f"{name}: {e} of its scale from {what} > {VARIANT_TOL}")
            errs[f"{name} vs {what}"] = e
    out["variants"] = {"err_of_scale": errs, "card_wall_s": wall, "cpu_wall_s": cpu_wall,
                       "launches": launches}
    out["launches"]["siglip_variants"] = launches
    log(f"[slice] saliency variants on a full-width MedSigLIP tower at 224 px (f32, "
        f"XMIR_FLASH_ATTN=1): launches {launches}; of each map's scale {errs} (bound "
        f"{VARIANT_TOL}); {wall:.1f} s on the card (sim_score_cam: 1,154 forwards), "
        f"{cpu_wall:.1f} s for the two others on the CPU")
    del model, cpu, xs
    torch.cuda.empty_cache()

    # ConceptXAI on the trained ConceptCLIP-384
    data_dir, csv_path = conceptclip["data"]
    n_images = len(load_vindr_ids(csv_path))
    with env_flags(**flags):
        reset_launches()
        t0 = time.perf_counter()
        results = xai_conceptclip.main(["--dataset", "vindr", "--dataset-dir", data_dir,
                                        "--test-image-list", csv_path, "--checkpoint",
                                        conceptclip["checkpoint"], "--vocab",
                                        conceptclip["vocab"], "--top-k", "3",
                                        "--num-query-samples", "2", "--device", "cuda",
                                        "--out-dir", str(workdir / "cxai")])
        wall = time.perf_counter() - t0
        launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want["K2"] = SIGLIP["depth"] * -(-n_images // 16)
    check(launches == want, f"xai_conceptclip: launches {launches}, expected {want}")
    files = sorted(p.name for p in (workdir / "cxai").iterdir())
    check(len(results) == 2 and len(files) == 4 and all(
        len(r["retrieved"]) == 3 and len(r["query_top_concepts"]) == 5 for r in results),
        f"xai_conceptclip: {files}")
    out["launches"]["conceptclip_xai"] = launches
    out["conceptxai"] = {"wall_s": wall, "images_per_s": n_images / wall,
                         "explanations": len(results)}
    log(f"[slice] cli.xai_conceptclip (ConceptCLIP-384 from cli.train_conceptclip's "
        f"checkpoint, f32, XMIR_FLASH_ATTN=1): launches {launches}; {n_images} images encoded "
        f"and 2 queries explained in {wall:.1f} s ({n_images / wall:.1f} images/s with the "
        f"model's build); first query's concepts "
        f"{[c['name'] for c in results[0]['query_top_concepts']]}")
    return out


HASH_BITS = 48  # ATH's codes (xmir_tpu/models/registry.py:100): K1's depth on its Hamming path
RESNET_DIM = 2048  # ResNet50's embedding: K1's deepest depth on a main path
# (Q, k) of K1 at the two depths over SERVING_N rows: a batch and a single query
K1_DEPTH_SHAPES = ((1024, 10), (1, 10))


def sign_rows(gen, rows, bits=HASH_BITS):
    """Random +/-1 rows: hash codes as the Hamming index stores them."""
    return sign_codes(torch.randn((rows, bits), generator=gen))


def k1_hamming_reading(q, g, k, kernel=fused_topk_scores):
    """K1 on +/-1 codes against its plain version: every score is an exact
    integer, so values and ids must be bit-equal, and the order of tied rows
    (the lower row first) decides most of the top-k. Returns {"bit_equal",
    "max_abs_err", "ties_at_kth": the mean count of gallery rows whose score
    equals a query's k-th, "tied_slots": the share of top-k slots tied with
    the slot before}."""
    bias = torch.zeros(g.shape[0], device=g.device)
    v, i = kernel(q, g, bias, k)
    rv, ri = topk_scores_reference(q, g, bias, k)
    ties = (torch.matmul(q.float(), g.float().T) == rv[:, -1:]).sum(dim=1).double().mean()
    torch.cuda.synchronize()
    return {"bit_equal": bool(torch.equal(v, rv) and torch.equal(i, ri)),
            "max_abs_err": (v - rv).abs().max().item(), "ties_at_kth": ties.item(),
            "tied_slots": (rv[:, 1:] == rv[:, :-1]).double().mean().item()}


def phase_k1_depths():
    """K1 at the slice's two new depths over SERVING_N rows, k = 10, at Q =
    1024 and Q = 1, f32 and bf16: D = 48 on +/-1 codes (bit-equal to the
    plain version, and through fused_topk(metric="hamming") against the CPU
    plain path) and D = 2048 on unit rows (within the agreement of phase 3,
    f32 within the 3xTF32 score bound); integer inputs with ties at every
    edge of the plan bit-equal at both; each timed (events in turns with
    the plain version, device_ms) beside its bound and the library's
    torch.mm + torch.topk (device_ms; timed here, used nowhere in the port)."""
    n = SERVING_N
    gen = torch.Generator().manual_seed(48)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (HASH_BITS, RESNET_DIM):
        for q_n, k in K1_DEPTH_SHAPES:
            k1_bit_equal_at(q_n, n, d, k)
            for dtype in (torch.float32, torch.bfloat16):
                log(f"[k1 depth] D={d} Q={q_n} k={k} {str(dtype)[6:]}: plan "
                    f"{launch_plan(q_n, n, k, sms, d, dtype)._asdict()}")
        log(f"[k1 depth] D={d}: integer inputs with ties at every plan edge bit-equal at Q=1024 "
            f"and Q=1, N={n}, f32 and bf16")
    # the metric wrapper on raw (real) codes: the sign transform and the
    # distance map, against the CPU's plain path
    raw_q, raw_g = torch.randn((64, HASH_BITS), generator=gen), torch.randn((n, HASH_BITS),
                                                                             generator=gen)
    v, i = fused_topk(raw_q.cuda(), raw_g.cuda(), 10, "hamming")
    rv, ri = fused_topk(raw_q, raw_g, 10, "hamming")
    check(torch.equal(v.cpu(), rv) and torch.equal(i.cpu(), ri),
          "fused_topk(metric='hamming') at D = 48 differs from the CPU's plain path")
    rows = {HASH_BITS: (sign_rows(gen, 1024), sign_rows(gen, n)),
            RESNET_DIM: (l2_normalize(torch.randn((1024, RESNET_DIM), generator=gen)),
                         l2_normalize(torch.randn((n, RESNET_DIM), generator=gen)))}
    bias = torch.zeros(n, device="cuda")
    out = {}
    for d, (q_all, g_all) in rows.items():
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            gg = g_all.to("cuda", dtype)
            for q_n, k in K1_DEPTH_SHAPES:
                qq = q_all[:q_n].to("cuda", dtype)
                key = f"D={d} {str(dtype)[6:]} Q={q_n} k={k}"
                reading = {}
                if d == HASH_BITS:
                    reading = k1_hamming_reading(qq, gg, k)
                    check(reading["bit_equal"], f"K1 {key} on +/-1 codes: not bit-equal to its "
                                                f"plain version: {reading}")
                    err = reading.pop("max_abs_err")
                else:
                    v, i = fused_topk_scores(qq, gg, bias, k)
                    rv, ri = topk_scores_reference(qq, gg, bias, k + 1)
                    err, checked, total = compare(v, i, rv[:, :k], ri[:, :k], atol, rv)
                    reading = {"ids_checked": f"{checked}/{total}"}
                    if dtype == torch.float32:
                        score = f32_score_error(qq, gg, bias, v, i)
                        check(score["of_bound"] <= 1, f"K1 {key}: f32 scores outside the 3xTF32 "
                                                      f"bound: {score}")
                        reading.update(score_of_bound=score["of_bound"],
                                       score_max_abs_err=score["max_abs_err"])
                    del v, i, rv, ri

                def kern():
                    return fused_topk_scores(qq, gg, bias, k)

                def plain():
                    return topk_scores_reference(qq, gg, bias, k)

                ms, _ = _in_turns({"kernel": kern, "plain": plain}, rounds=2, reps=3)
                dev = device_ms(kern)
                lib = device_ms(lambda: torch.topk(torch.mm(qq, gg.T) + bias, k, dim=1).values)
                out[key] = dict(k1_bound(q_n, n, d, k, dtype), ms=ms["kernel"],
                                plain_ms=ms["plain"], device_ms=dev, library_ms=lib,
                                library="torch.mm + torch.topk (device_ms)", max_abs_err=err,
                                plan=launch_plan(q_n, n, k, sms, d, dtype)._asdict(), **reading)
                log(f"[k1 depth] {key} N={n}: device {dev:.4f} ms (bound "
                    f"{out[key]['bound_ms']:.4f} ms by {out[key]['bound_by']}, "
                    f"{out[key]['bound_ms'] / dev:.1%} of it); events {ms['kernel']:.4f} ms, "
                    f"plain {ms['plain']:.3f} ms; torch.mm + torch.topk {lib:.4f} ms by device "
                    f"time; max err {err:.3g}; {reading}")
            del gg
    # the same shape on random unit rows at D = 48: few ties, so the time the
    # ties of +/-1 codes add stands apart from the depth's
    qq, gg = _random_inputs(gen, 1024, n, HASH_BITS, torch.bfloat16)
    dev = device_ms(lambda: fused_topk_scores(qq, gg, bias, 10))
    out[f"D={HASH_BITS} bfloat16 Q=1024 k=10, unit rows"] = {"device_ms": dev}
    log(f"[k1 depth] D={HASH_BITS} bfloat16 Q=1024 k=10 on random unit rows (no ties): device "
        f"{dev:.4f} ms")
    return out


TREE = (256, 64)  # the gallery (train) and query (test) images of phases 43-45


def covidx_tree(workdir: Path, name: str):
    """Gallery (train) and query (test) COVIDx PNGs at 256 px: (gallery
    images dir, its manifest, query images dir, its manifest, a query
    manifest naming its files from the gallery's directory, for the CLIs
    that read both splits from one --dataset-dir)."""
    g_dir, g_manifest = write_synthetic_covidx(str(workdir / f"{name}_gallery"), n=TREE[0],
                                               size=256, seed=0)
    q_dir, q_manifest = write_synthetic_covidx(str(workdir / f"{name}_queries"), n=TREE[1],
                                               size=256, seed=1)
    rel = os.path.relpath(q_dir, g_dir)
    both = str(workdir / f"{name}_test_from_gallery.txt")
    with open(q_manifest) as f, open(both, "w") as g:
        for line in f:
            i, fname, label = line.split()
            g.write(f"{i} {rel}/{fname} {label}\n")
    return g_dir, g_manifest, q_dir, q_manifest, both


def _split_args(tree):
    """--dataset-dir and both manifests of covidx_tree, one directory."""
    return ["--dataset", "covid", "--dataset-dir", tree[0], "--train-image-list", tree[1],
            "--test-image-list", tree[4]]


def _no_launches(launches, what):
    check(all(v == 0 for v in launches.values()), f"{what} launched a kernel: {launches}")


def phase_slice_resnet(workdir: Path, tree):
    """ResNet50 at full width (224 crop, 2048-d): cli.ingest -> cli.query
    (K1 at D = 2048 once, the hits against the plain top-k) and cli.test
    --save-dir on the query set (no kernel; the metrics against numpy's)."""
    g_dir, g_manifest, q_dir, q_manifest, _ = tree
    gal, hits_path = str(workdir / "resnet_gallery.npz"), str(workdir / "resnet_hits.json")
    model_args = ["--model", "resnet50", "--device", "cuda", "--seed", "0", "--batch-size", "64",
                  "-j", "8"]
    calls = []
    reset_launches()
    t0 = time.perf_counter()
    with record_searches(calls):
        ingest.main(_slice_args(g_dir, g_manifest, "train", model_args) + ["--output", gal])
        results = query.main(_slice_args(q_dir, q_manifest, "test", model_args)
                             + ["--index", gal, "--top-k", "10", "--output", hits_path])
    launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want["K1"] = 1
    check(launches == want, f"resnet50 ingest -> query: launches {launches}, expected {want}")
    log(f"[slice] resnet50 ingest -> query: launches {launches}; "
        f"{time.perf_counter() - t0:.1f} s wall")
    err = check_hits(calls, results, *TREE, RESNET_DIM)
    reset_launches()
    save = str(workdir / "resnet_test")
    metrics = test_cli.main(["--dataset", "covid", "--dataset-dir", q_dir, "--test-image-list",
                             q_manifest, "--model", "resnet50", "--device", "cuda", "--seed",
                             "0", "-j", "8", "--eval-batch-size", "64", "--save-dir", save])
    test_launches = read_launches()
    _no_launches(test_launches, "cli.test resnet50")
    metrics = check_evaluation(save, metrics, TREE[1], dim=RESNET_DIM)
    return {"launches": {"resnet50": launches, "resnet50_test": test_launches}, "err": err,
            "metrics": metrics, "gallery": gal}


ATH_STEPS, ATH_BATCH = 3, 32  # cli.train_ath: three steps of 3 x 32 images at 256 px
# The card's f32 losses against the CPU's by step, relative to 1 + |loss|.
# Step 1 is one forward: 1e-5. The later steps carry each device's rounding
# of the gradients (ath_first_step_grads) through Adam's updates, which
# divide by each gradient's own size: 1e-4, set from readings (PERF.md
# section 6: 1.7e-7 and 1.32e-5 on steps 2 and 3 on an H100; the padded
# average pool's wrong backward, planted by chip_faults.py, 3.1e-2 and
# 6.1e-2)
ATH_LOSS_RTOL = (1e-5, 1e-4, 1e-4)
# the first step's gradients against float64's, per tensor, relative to its
# largest |gradient| (floored at ATH_GRAD_FLOOR of the model's largest): the
# CPU's f32 gradients read 1.7e-3 (block1's down_conv: a sum over 96 x 128 x
# 128 positions)
ATH_GRAD_RTOL, ATH_GRAD_FLOOR = 1e-2, 1e-3
# the trained model's hash codes and type logits on the card against the
# CPU's on the same .pt, relative to the CPU's largest |value|: a sign may
# differ only where both lie within this of 0
ATH_CODE_RTOL = 1e-4


def ath_train_reading(workdir: Path, tree, pt: str):
    """cli.train_ath's three steps on the card (saving ``pt``) and on the CPU
    from the same seeded weights and triplets: {"card", "cpu": the losses by
    step, "rel": per step the largest |card - cpu| / (1 + |cpu|) of loss, hash
    and ce, "of_bound": the largest rel over its step's ATH_LOSS_RTOL, "wall":
    the card's seconds, "launches"}."""
    train = ["--dataset", "covid", "--dataset-dir", tree[0], "--train-image-list", tree[1],
             "--batch-size", str(ATH_BATCH), "--epochs", str(ATH_STEPS), "--steps-per-epoch",
             "1", "-j", "8", "--seed", "0"]
    reset_launches()
    t0 = time.perf_counter()
    run = train_ath_cli.main(train + ["--device", "cuda", "--save", pt])
    wall = time.perf_counter() - t0
    launches = read_launches()
    cpu = train_ath_cli.main(train + ["--device", "cpu", "--save", str(workdir / "ath_cpu.pt")])
    rel = [max(abs(a[key] - b[key]) / (1 + abs(b[key])) for key in a)
           for a, b in zip(run["losses"], cpu["losses"])]
    of_bound = max(r / t for r, t in zip(rel, ATH_LOSS_RTOL)) if rel else float("inf")
    return {"card": run["losses"], "cpu": cpu["losses"], "rel": rel, "of_bound": of_bound,
            "wall": wall, "launches": launches}


def ath_losses_agree(reading) -> bool:
    return len(reading["rel"]) == ATH_STEPS and reading["of_bound"] <= 1


def ath_first_step_grads(tree):
    """The gradients of cli.train_ath's first loss (its seeded weights, its
    first triplet batch, cuDNN deterministic, no TF32) on the card and on the
    CPU in f32, each against float64's on the CPU: {"card", "cpu": the worst
    tensor's max |g - g64| over its largest |g64| (floored at ATH_GRAD_FLOOR
    of the model's largest), "of_bound": the card's over ATH_GRAD_RTOL,
    "opposite": elements whose gradient has the other sign on the card than on
    the CPU (they take opposite first Adam steps), "opposite_rel": the largest
    |g64| among them, relative as above, "zero": tensors whose exact gradient
    is 0}."""
    ds = common.build_dataset(argparse.Namespace(dataset="covid", dataset_dir=tree[0],
                                                 train_image_list=tree[1]), "train")
    x, y = train_ath_cli.triplet_batch(ds, np.asarray(ds.labels), ATH_BATCH, 256,
                                       np.random.default_rng(0), "cpu")
    torch.backends.cudnn.deterministic = True
    common.set_tf32(False)
    grads = {}
    for name, device, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                                ("f64", "cpu", torch.float64)):
        model = ATHEmbedder(HASH_BITS, 3, 256, generator=torch.Generator().manual_seed(0))
        model = model.to(device=device, dtype=dtype, memory_format=torch.channels_last).train()
        make_ath_train_step(model, ATH_BATCH).losses(x.to(device, dtype), y.to(device))[0].backward()
        grads[name] = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
    top = max(g.abs().max().item() for g in grads["f64"].values())
    out = {"card": 0.0, "cpu": 0.0, "opposite": 0, "opposite_rel": 0.0, "zero": []}
    for n, exact in grads["f64"].items():
        scale = max(exact.abs().max().item(), ATH_GRAD_FLOOR * top)
        for side in ("card", "cpu"):
            out[side] = max(out[side], (grads[side][n] - exact).abs().max().item() / scale)
        opposite = (grads["card"][n] > 0) != (grads["cpu"][n] > 0)
        out["opposite"] += int(opposite.sum())
        if opposite.any():
            out["opposite_rel"] = max(out["opposite_rel"],
                                      exact[opposite].abs().max().item() / scale)
        if exact.abs().max().item() < 1e-12 * top:
            out["zero"].append(n)
    out["of_bound"] = out["card"] / ATH_GRAD_RTOL
    return out


def ath_grads_agree(reading) -> bool:
    return reading["of_bound"] <= 1


@contextlib.contextmanager
def record_extracts(out):
    """Record each cli.test_ath extract's (codes, logits, labels)."""
    orig = test_ath_cli.extract

    def extract(*args, **kwargs):
        out.append(orig(*args, **kwargs))
        return out[-1]

    test_ath_cli.extract = extract
    try:
        yield
    finally:
        test_ath_cli.extract = orig


def check_codes(card, cpu, what):
    """Card arrays (codes or logits) against the CPU's on the same .pt: within
    ATH_CODE_RTOL of the CPU's largest |value|, so that a sign differs only
    where both lie that near 0. Returns (max |card - cpu| over that scale,
    the signs that differ)."""
    scale = max(float(np.abs(b).max()) for b in cpu)
    err = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu)) / scale
    check(err <= ATH_CODE_RTOL, f"{what} on the card lie {err:.3g} of their scale {scale:.3g} "
                                f"from the CPU's, past {ATH_CODE_RTOL}")
    return err, sum(int(((a >= 0) != (b >= 0)).sum()) for a, b in zip(card, cpu))


def phase_ath(workdir: Path, tree):
    """The ATH hashing path at 256 px, 48 bits: cli.train_ath for three steps
    at batch 32 (no kernel; the f32 losses within ATH_LOSS_RTOL of the same
    CLI on the CPU, the first step's gradients within ATH_GRAD_RTOL of
    float64's, every tensor moved); cli.test_ath --resume with and without
    --binary-codes (the card's codes and logits within ATH_CODE_RTOL of the
    CPU's; the Hamming metrics equal to the CPU's computation on the card's
    codes, and to the CPU CLI's where no sign or type prediction differs);
    cli.ingest --model ath --metric hamming -> cli.query (K1 once on +/-1
    codes at D = 48: the hits bit-equal to the plain top-k of the recorded
    search, the codes within ATH_CODE_RTOL of the CPU CLIs', and the hits
    equal to theirs on every query that neither holds a code whose sign
    differs nor finds a gallery row that does)."""
    pt = str(workdir / "ath.pt")
    train = ath_train_reading(workdir, tree, pt)
    _no_launches(train["launches"], "cli.train_ath")
    check(ath_losses_agree(train),
          f"cli.train_ath: the card's losses {train['card']} lie {train['rel']} (relative to 1 + "
          f"|loss|, by step) from the CPU's {train['cpu']}, past {ATH_LOSS_RTOL}")
    grads = ath_first_step_grads(tree)
    check(ath_grads_agree(grads), f"cli.train_ath's first gradients on the card lie past "
                                  f"{ATH_GRAD_RTOL} of float64's: {grads}")
    start = ATHEmbedder(HASH_BITS, 3, 256, generator=torch.Generator().manual_seed(0))
    trained = load_checkpoint(pt)
    still = [k for k, v in start.state_dict().items() if torch.equal(v, trained[k])]
    check(not still and all(torch.isfinite(v).all() for v in trained.values()),
          f"cli.train_ath: tensors that did not move {still}, or non-finite ones")
    log(f"[slice] cli.train_ath, {ATH_STEPS} steps at batch {ATH_BATCH} (256 px): (loss, hash, "
        f"ce) {[tuple(round(r[k], 4) for k in ('loss', 'hash', 'ce')) for r in train['card']]}; "
        f"the CPU's within {[f'{r:.3g}' for r in train['rel']]} of 1 + |loss| by step (bounds "
        f"{ATH_LOSS_RTOL}); the first step's gradients within {grads['card']:.3g} of float64's "
        f"(the CPU's f32 {grads['cpu']:.3g}; bound {ATH_GRAD_RTOL}); {grads['opposite']} "
        f"element(s) take opposite first Adam steps on the card and the CPU, their exact "
        f"gradients within {grads['opposite_rel']:.3g} of their tensors' scale (exactly 0: "
        f"{grads['zero']}); every tensor moved; {train['wall']:.1f} s wall")
    out = {"losses": train["card"], "losses_vs_cpu_rel": train["rel"],
           "first_step_grads": grads, "launches": {}}
    for binary in (True, False):
        argv = _split_args(tree) + ["--resume", pt, "--batch-size", "64"] + (
            ["--binary-codes"] if binary else [])
        card, cpu = [], []
        reset_launches()
        with record_extracts(card):
            res = test_ath_cli.main(argv + ["--device", "cuda"])
        _no_launches(read_launches(), "cli.test_ath")
        with record_extracts(cpu):
            res_cpu = test_ath_cli.main(argv + ["--device", "cpu"])
        (g_codes, _, g_labels), (q_codes, q_logits, q_labels) = card
        code_err, flips = check_codes([g_codes, q_codes], [cpu[0][0], cpu[1][0]], "ATH codes")
        logit_err, _ = check_codes([q_logits], [cpu[1][1]], "ATH type logits")
        moved = int((q_logits.argmax(1) != cpu[1][1].argmax(1)).sum())
        flat = [v for m in res["retrieval"].values() for v in m.values()]
        check(np.isfinite(flat).all() and all(0 <= v <= 1 for v in flat),
              f"cli.test_ath: metrics {res}")
        diff = max(abs(res["retrieval"][k][m] - res_cpu["retrieval"][k][m])
                   for k in res["retrieval"] for m in res["retrieval"][k])
        if binary:
            own = hash_retrieval_metrics(q_codes, q_labels, g_codes, g_labels, q_logits,
                                         topk_values=(1, 5, 10), binary_codes=True, device="cpu")
            check(res == own, f"cli.test_ath --binary-codes: the card's metrics {res} differ from "
                              f"the CPU's {own} on the card's codes")
            if flips == 0 and moved == 0:
                check(res == res_cpu, f"cli.test_ath --binary-codes: the card's metrics {res} "
                                      f"differ from the CPU's {res_cpu}")
            out.update(codes_vs_cpu=code_err, logits_vs_cpu=logit_err, code_sign_flips=flips)
        out["test_ath_binary" if binary else "test_ath_l2"] = res
        log(f"[slice] cli.test_ath {'--binary-codes' if binary else '(L2)'}: classification "
            f"{res['classification_acc']:.4f}, top-10 mAP {res['retrieval'][10]['map']:.4f}; "
            f"codes within {code_err:.3g} of the CPU's (relative to their largest; {flips} "
            f"sign(s) differ of "
            f"{g_codes.size + q_codes.size}), logits within {logit_err:.3g} ({moved} type "
            f"prediction(s) differ); metrics within {diff:.3g} of the CPU CLI's"
            + ("; equal to the CPU's on the card's codes" if binary else ""))
    model_args = ["--model", "ath", "--resume", pt, "--seed", "0", "--batch-size", "64", "-j",
                  "8"]
    results, calls, galleries = {}, {}, {}
    for device in ("cuda", "cpu"):
        calls[device] = []
        galleries[device] = str(workdir / f"ath_gallery_{device}.npz")
        reset_launches()
        with record_searches(calls[device]):
            ingest.main(_slice_args(tree[0], tree[1], "train", model_args)
                        + ["--device", device, "--metric", "hamming", "--output",
                           galleries[device]])
            results[device] = query.main(_slice_args(tree[2], tree[3], "test", model_args)
                                         + ["--device", device, "--index", galleries[device],
                                            "--top-k", "10", "--output",
                                            str(workdir / f"ath_hits_{device}.json")])
        if device == "cuda":
            launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want["K1"] = 1
    check(launches == want, f"ath ingest -> query: launches {launches}, expected {want}")
    idx, queries, k = calls["cuda"][0]
    check(idx.metric == "hamming" and idx._device_embeds.is_cuda and queries.shape == (
        TREE[1], HASH_BITS), "the ATH search did not run on +/-1 codes on the card")
    bias = torch.zeros(idx.ntotal, device="cuda")
    rv, ri = topk_scores_reference(sign_codes(queries), idx._device_embeds, bias, k)
    ids = {d: np.array([[h["id"] for h in r["results"]] for r in results[d]]) for d in results}
    dist = torch.tensor([[h["distance"] for h in r["results"]] for r in results["cuda"]],
                        device="cuda")
    check(torch.equal(torch.from_numpy(ids["cuda"]).to("cuda", torch.int32), ri)
          and torch.equal(dist, (HASH_BITS - rv) / 2),
          "the ATH hits differ from the plain top-k of the recorded search")
    out["launches"]["ath_serving"] = launches
    # the card's codes against the CPU CLIs'; a query's hits may differ only
    # where it holds a code whose sign differs, or finds a gallery row that does
    g_card, g_cpu = (np.load(galleries[d])["embeds"] for d in ("cuda", "cpu"))
    q_card, q_cpu = (calls[d][0][1].cpu().numpy() for d in ("cuda", "cpu"))
    code_err, flips = check_codes([g_card, q_card], [g_cpu, q_cpu], "ATH ingest / query codes")
    g_flip = np.flatnonzero(((g_card >= 0) != (g_cpu >= 0)).any(1))
    exempt = ((q_card >= 0) != (q_cpu >= 0)).any(1) | np.isin(ids["cuda"], g_flip).any(1) | (
        np.isin(ids["cpu"], g_flip).any(1))
    check(np.array_equal(ids["cuda"][~exempt], ids["cpu"][~exempt]),
          "the ATH hits on the card differ from the CPU CLIs' on queries that no sign flip reaches")
    out.update(serving_codes_vs_cpu=code_err, serving_code_sign_flips=flips,
               hits_equal_cpu=bool(np.array_equal(ids["cuda"], ids["cpu"])),
               hits_compared_with_cpu=int((~exempt).sum()))
    log(f"[slice] ath ingest --metric hamming -> query: launches {launches}; the hits' ids and "
        f"distances bit-equal to the plain top-k of the recorded search "
        f"({(rv[:, 1:] == rv[:, :-1]).double().mean().item():.0%} of the slots tied with the one "
        f"before); codes within {code_err:.3g} of the CPU CLIs' (relative to their largest; "
        f"{flips} sign(s) differ); the "
        f"hits equal to theirs on {int((~exempt).sum())} of {TREE[1]} queries ({int(exempt.sum())} "
        f"reached by a sign that differs)")
    return out


def phase_analysis(workdir: Path, tree, resnet_gallery):
    """cli.anomaly --model resnet50 (no kernel; AUROC / AUPR / FPR@95 and the
    scores finite, in [0, 1]); the query sets embedded by ResNet50 and
    DenseNet121 (cli.ingest --split test) through cli.fusion (its products on
    the card; the same CLI on the CPU beside it) and, with a DenseNet121
    gallery, cli.compare (K1 twice: each search's hits against the plain
    top-k)."""
    g_dir, g_manifest, q_dir, q_manifest, _ = tree
    reset_launches()
    res = anomaly_cli.main(_split_args(tree) + ["--model", "resnet50", "--device", "cuda",
                                                "--eval-batch-size", "64", "-j", "8",
                                                "--save-dir", str(workdir / "anomaly")])
    anomaly_launches = read_launches()
    _no_launches(anomaly_launches, "cli.anomaly")
    scores = np.asarray(res["scores"])
    check(scores.shape == (TREE[1],) and np.isfinite(scores).all() and scores.min() >= 0
          and scores.max() == 1.0 and all(0 <= res[k] <= 1 for k in ("auroc", "aupr", "fpr@95")),
          f"cli.anomaly: {({k: v for k, v in res.items() if k != 'scores'})}")
    log(f"[slice] cli.anomaly --model resnet50: AUROC {res['auroc']:.4f}, AUPR "
        f"{res['aupr']:.4f}, FPR@95 {res['fpr@95']:.4f} ({res['n_anomaly']} anomalies of "
        f"{TREE[1]})")
    sources = {}
    for name in ("resnet50", "densenet121"):
        args = ["--model", name, "--device", "cuda", "--seed", "0", "--batch-size", "64", "-j",
                "8"]
        sources[name] = str(workdir / f"q_{name}.npz")
        ingest.main(_slice_args(q_dir, q_manifest, "test", args) + ["--output", sources[name]])
    dense_gallery = str(workdir / "densenet_gallery.npz")
    ingest.main(_slice_args(g_dir, g_manifest, "train", ["--model", "densenet121", "--device",
                                                         "cuda", "--seed", "0", "-j", "8"])
                + ["--output", dense_gallery])
    fusion = {}
    for device in ("cuda", "cpu"):
        fusion[device] = fusion_cli.main(["--source-a", sources["resnet50"], "--source-b",
                                          sources["densenet121"], "--device", device,
                                          "--output", str(workdir / f"fusion_{device}")])
    runs = {k: v for k, v in fusion["cuda"].items() if "skipped" not in v}
    check(len(fusion["cuda"]) == 18 and len(runs) == 11
          and all(np.isfinite(list(m.values())).all() for m in runs.values()),
          f"cli.fusion: {fusion['cuda']}")
    fusion_diff = max(abs(m[key] - fusion["cpu"][name][key]) for name, m in runs.items()
                      for key in m)
    log(f"[slice] cli.fusion (ResNet50 x DenseNet121 query embeddings, {TREE[1]} rows): "
        f"{len(runs)} experiments, 7 weighted sums skipped (2048 vs 1024 wide); baseline mAP "
        f"{runs['baseline_a']['mAP']:.2f} / {runs['baseline_b']['mAP']:.2f}, concat "
        f"{runs['concat_fusion']['mAP']:.2f}; the CPU's metrics within {fusion_diff:.3g}")
    calls, returned = [], []
    reset_launches()
    with record_searches(calls, returned):
        groups = compare_cli.main(["--index-a", resnet_gallery, "--index-b", dense_gallery,
                                   "--queries-a", sources["resnet50"], "--queries-b",
                                   sources["densenet121"], "--name-a", "resnet50", "--name-b",
                                   "densenet121", "--top-k", "5", "--device", "cuda",
                                   "--out-dir", str(workdir / "comparison"), "--html"])
    compare_launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want["K1"] = 2
    check(compare_launches == want and len(calls) == 2,
          f"cli.compare: launches {compare_launches}, expected {want}")
    err = 0.0
    for (idx, queries, k), (v, i) in zip(calls, returned):
        bias = torch.zeros(idx.ntotal, device="cuda")
        queries = queries.to("cuda")  # the CLI hands the index host rows
        check(v.is_cuda and i.is_cuda, "cli.compare: a search did not run on the card")
        rv, ri = topk_scores_reference(l2_normalize(queries), idx._device_embeds, bias, k + 1)
        e, _, _ = compare(v, i, rv[:, :k], ri[:, :k], 1e-5, rv)
        err = max(err, e)
    check(sum(len(v) for v in groups.values()) == TREE[1]
          and (workdir / "comparison" / "mismatches.html").is_file(),
          "cli.compare: not every query classified, or no report")
    log(f"[slice] cli.compare resnet50 x densenet121: launches {compare_launches}; groups "
        f"{({g: len(v) for g, v in groups.items()})}; the hits each search gave the CLI within "
        f"{err:.3g} of the plain top-k")
    return {"launches": {"resnet50_anomaly": anomaly_launches, "compare": compare_launches},
            "err": err, "anomaly": {k: res[k] for k in ("auroc", "aupr", "fpr@95")},
            "fusion_vs_cpu": fusion_diff}


def phase_resnet_ath_rates():
    """The ResNet50 embed at batch 64, 224 px, in f32, TF32 and bf16 (img/s by
    device_ms), and the ATH train step at batch 32 (3 x 32 images at 256 px)
    by step_reading."""
    model, _ = create_model("resnet50", generator=torch.Generator().manual_seed(0))
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.randn((64, 224, 224, 3), generator=torch.Generator().manual_seed(1)).cuda()
    rates = {}
    for label, dtype, tf32 in (("f32", torch.float32, False), ("tf32", torch.float32, True),
                               ("bf16", torch.bfloat16, False)):
        torch.backends.cudnn.allow_tf32 = tf32
        embed = make_embed_fn(model, compute_dtype=dtype)
        out = embed(x)
        check(out.shape == (64, RESNET_DIM) and torch.isfinite(out).all(), "bad embeddings")
        ms = device_ms(lambda: embed(x))
        rates[label] = {"device_ms": ms, "img_per_s": 64 / ms * 1e3}
        log(f"[rates] ResNet50 embed {label:4s} batch 64 @224: {ms:.3f} ms a batch by device "
            f"time, {rates[label]['img_per_s']:.0f} img/s")
    torch.backends.cudnn.allow_tf32 = False
    del model
    ath = ATHEmbedder(HASH_BITS, 3, 256, generator=torch.Generator().manual_seed(0))
    ath = ath.to("cuda", memory_format=torch.channels_last).train()
    state = TrainState(ath, GroupedAdam({"all": (list(ath.parameters()), 1e-3)}, clip_norm=5.0))
    step = make_ath_train_step(ath, ATH_BATCH)
    xs = torch.randn((3 * ATH_BATCH, 256, 256, 3), generator=torch.Generator().manual_seed(2))
    xs, ys = xs.cuda(), torch.arange(ATH_BATCH, device="cuda") % 3
    torch.backends.cudnn.deterministic = True  # as cli.train_ath runs it

    def train_step():
        return step(state, xs, ys)

    reading = step_reading(
        f"ATH train step (batch {ATH_BATCH}: {3 * ATH_BATCH} images at 256 px, f32)",
        {"step": train_step, "forward + loss": lambda: step.losses(xs, ys)}, ATH_BATCH)
    split = kernel_split(train_step, reading["device_ms"] or reading["ms"], reps=3)
    if split is not None:  # the eight kernels that take the most of it
        split = dict(sorted(split.items(), key=lambda kv: -kv[1])[:8])
    reading["top_kernels_ms"] = split
    log(f"[rates] ATH train step, its eight largest kernels by device time: {split_text(split)}")
    rates["ath_train_step"] = reading
    return rates


def phases_siglip_train():
    """Phases 38 to 41: K3 at head width 72, the MedSigLIP and ConceptCLIP
    trainers, the SigLIP family's XAI."""
    siglip_bwd = phase_kernel_siglip_bwd()
    with tempfile.TemporaryDirectory() as tmp:
        ms_train = phase_train_medsiglip(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        cc_train = phase_train_conceptclip(Path(tmp))
        sx = phase_siglip_xai(Path(tmp), cc_train)
    return siglip_bwd, ms_train, cc_train, sx


def phases_resnet_ath():
    """Phases 42 to 46: K1 at D = 48 and 2048, the ResNet50, ATH and analysis
    paths on one generated COVIDx tree, their rates."""
    k1_depths = phase_k1_depths()
    with tempfile.TemporaryDirectory() as tmp:
        tree = covidx_tree(Path(tmp), "r")
        resnet = phase_slice_resnet(Path(tmp), tree)
        ath = phase_ath(Path(tmp), tree)
        analysis = phase_analysis(Path(tmp), tree, resnet["gallery"])
    return k1_depths, resnet, ath, analysis, phase_resnet_ath_rates()


# ---------------------------------------------------------------- ChestMIR
# the JAX package's detector defaults (xmir_tpu/chestmir/lesions.py:48-53):
# YOLOv5s, 14 VinDr classes, at 640 px (inference.py::predict_image)
YOLO_NC, YOLO_DM, YOLO_WM, YOLO_SIZE = 14, 0.33, 0.50, 640
YOLO_FOLDS = 5
YOLO_GATE = 0.01  # run_detector's conf_thres: objectness and class score
YOLO_IOU = 0.4  # run_detector's iou_thres
YOLO_TOL = dict(atol=2e-4, rtol=1e-4)  # tests/test_yolo.py's, the card against the CPU
# rows of a forward that pass both gates, set by the objectness prior's
# offset (calibrated on the card): a few dozen, as a trained fold gives
YOLO_TARGET_ROWS = 40
# the Detect convs' weights are scaled by this: a random head's logits lie
# within a logit of its prior, so that thousands of rows tie to 1e-6 (below
# the two devices' f32 difference) and NMS orders them by rounding; x 32
# spreads them as a trained head's are
YOLO_HEAD_GAIN = 32.0
YOLO_FOLD_NOISE = 0.02  # each fold: the base's conv weights x (1 + 0.02 N(0, 1))
CHEST_N, CHEST_SIZE, CHEST_BATCH = 8, 1024, 16  # the ingest's gallery: 1024^2 grayscale films
CHEST_SCORE = 0.01  # --score-thres: a random fold's boxes fuse below the default 0.1
CHEST_TTA = "0,4"


def chest_like(size, seed):
    """A grayscale (as RGB) chest-film-like image: a bright mediastinum,
    two darker lungs, bright blobs, noise (no flat region, so no two cells
    of the detector's maps see the same pixels)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = 60 + 80 * np.exp(-((xx - 0.5) ** 2) / 0.08)
    for cx in (0.3, 0.7):
        img -= 50 * np.exp(-(((xx - cx) / 0.15) ** 2 + ((yy - 0.5) / 0.3) ** 2))
    for _ in range(6):
        cx, cy, r = rng.random(), rng.random(), 0.02 + 0.06 * rng.random()
        img += 90 * rng.random() * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / r ** 2)
    img = np.clip(img + rng.normal(0, 6, img.shape), 0, 255).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=2)


def write_chest_tree(root: Path, n=CHEST_N, size=CHEST_SIZE, seed=0):
    """n chest-like PNGs at size^2 in COVIDx's layout (`idx filename label`,
    three classes in turn). Not VinDr's: its labels are multi-hot, and the
    two-stage evaluation (both packages) hashes a label per image."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    img_dir = root / "chest_images"
    img_dir.mkdir(parents=True)
    manifest = root / "chest_manifest.txt"
    names = ("normal", "pneumonia", "COVID-19")

    def write(i):
        Image.fromarray(chest_like(size, seed * 1000 + i)).save(img_dir / f"cxr_{i:03d}.png",
                                                                compress_level=1)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(n)))
    with open(manifest, "w") as f:
        f.writelines(f"{i} cxr_{i:03d}.png {names[i % 3]}\n" for i in range(n))
    return str(img_dir), str(manifest)


# An ultralytics v6.0 oracle (the modules' own semantics, as
# tests/test_yolo.py's torch oracle): the yardstick of the port's graph and
# decode on the card, written apart from models/yolo.py
class OConv(torch.nn.Module):
    def __init__(self, c1, c2, k=1, s=1, p=None):
        super().__init__()
        self.conv = torch.nn.Conv2d(c1, c2, k, s, k // 2 if p is None else p, bias=False)
        self.bn = torch.nn.BatchNorm2d(c2, eps=1e-3, momentum=0.03)
        self.act = torch.nn.SiLU()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class OBottleneck(torch.nn.Module):
    def __init__(self, c, shortcut):
        super().__init__()
        self.cv1, self.cv2, self.add = OConv(c, c, 1), OConv(c, c, 3), shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class OC3(torch.nn.Module):
    def __init__(self, c1, c2, n, shortcut=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1, self.cv2, self.cv3 = OConv(c1, c_), OConv(c1, c_), OConv(2 * c_, c2)
        self.m = torch.nn.Sequential(*(OBottleneck(c_, shortcut) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class OSPPF(torch.nn.Module):
    def __init__(self, c1, c2):
        super().__init__()
        self.cv1, self.cv2 = OConv(c1, c1 // 2), OConv(c1 // 2 * 4, c2)
        self.m = torch.nn.MaxPool2d(kernel_size=5, stride=1, padding=2)

    def forward(self, x):
        x = self.cv1(x)
        y1 = self.m(x)
        y2 = self.m(y1)
        return self.cv2(torch.cat((x, y1, y2, self.m(y2)), 1))


class ODetect(torch.nn.Module):
    def __init__(self, nc, ch):
        super().__init__()
        self.no, self.na = nc + 5, 3
        self.m = torch.nn.ModuleList(torch.nn.Conv2d(c, self.na * self.no, 1) for c in ch)
        self.register_buffer("anchors", torch.zeros(3, 3, 2))

    def forward(self, feats):
        outs = []
        for i, x in enumerate(feats):
            b, _, ny, nx = x.shape
            y = self.m[i](x).view(b, self.na, self.no, ny, nx).permute(0, 1, 3, 4, 2).sigmoid()
            yv, xv = torch.meshgrid(torch.arange(ny, device=x.device),
                                    torch.arange(nx, device=x.device), indexing="ij")
            grid = torch.stack((xv, yv), 2).view(1, 1, ny, nx, 2).float() - 0.5
            stride = 8 * 2 ** i
            anchor_grid = (self.anchors[i] * stride).view(1, self.na, 1, 1, 2)
            xy = (y[..., 0:2] * 2 + grid) * stride
            wh = (y[..., 2:4] * 2) ** 2 * anchor_grid
            outs.append(torch.cat((xy, wh, y[..., 4:]), -1).view(b, -1, self.no))
        return torch.cat(outs, 1)


class OYOLO(torch.nn.Module):
    """ultralytics' layer list (model.{i}) at YOLOv5s's widths."""

    def __init__(self, nc=YOLO_NC, dm=YOLO_DM, wm=YOLO_WM):
        super().__init__()
        w = lambda c: max(8, int(math.ceil(c * wm / 8) * 8))  # noqa: E731
        d = lambda n: max(round(n * dm), 1)  # noqa: E731
        up = lambda: torch.nn.Upsample(scale_factor=2, mode="nearest")  # noqa: E731
        ident = torch.nn.Identity
        self.model = torch.nn.ModuleList([
            OConv(3, w(64), 6, 2, 2), OConv(w(64), w(128), 3, 2), OC3(w(128), w(128), d(3)),
            OConv(w(128), w(256), 3, 2), OC3(w(256), w(256), d(6)), OConv(w(256), w(512), 3, 2),
            OC3(w(512), w(512), d(9)), OConv(w(512), w(1024), 3, 2), OC3(w(1024), w(1024), d(3)),
            OSPPF(w(1024), w(1024)), OConv(w(1024), w(512)), up(), ident(),
            OC3(w(1024), w(512), d(3), False), OConv(w(512), w(256)), up(), ident(),
            OC3(w(512), w(256), d(3), False), OConv(w(256), w(256), 3, 2), ident(),
            OC3(w(512), w(512), d(3), False), OConv(w(512), w(512), 3, 2), ident(),
            OC3(w(1024), w(1024), d(3), False), ODetect(nc, (w(256), w(512), w(1024)))])

    def forward(self, x):
        m = self.model
        p3 = m[4](m[3](m[2](m[1](m[0](x)))))
        p4 = m[6](m[5](p3))
        t10 = m[10](m[9](m[8](m[7](p4))))
        t14 = m[14](m[13](torch.cat((m[11](t10), p4), 1)))
        o17 = m[17](torch.cat((m[15](t14), p3), 1))
        o20 = m[20](torch.cat((m[18](o17), t14), 1))
        o23 = m[23](torch.cat((m[21](o20), t10), 1))
        return m[24]((o17, o20, o23))


def seeded_detector(seed, gen=None):
    """YOLOv5s (models/yolo.py) with seeded weights: Kaiming-normal
    convolutions, random BatchNorm statistics (as tests/test_yolo.py sets
    them), ultralytics' Detect priors (init_weights_), the head's weights x
    YOLO_HEAD_GAIN."""
    gen = gen or torch.Generator().manual_seed(seed)
    model = yolo_model.YOLOv5(YOLO_NC, YOLO_DM, YOLO_WM, generator=gen)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.uniform_(-0.5, 0.5, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
            elif isinstance(mod, torch.nn.Conv2d) and not name.startswith(
                    f"model.{yolo_model.DETECT}."):
                mod.weight.normal_(0.0, (2.0 / mod.weight[0].numel()) ** 0.5, generator=gen)
        for conv in model.detect.m:
            conv.weight.mul_(YOLO_HEAD_GAIN)
    return model.eval()


def gate_counts(pred):
    """Rows of raw (1, N, 5 + nc) predictions that pass run_detector's two
    gates (objectness, then objectness x best class score)."""
    p = pred[0]
    return int(((p[:, 4] > YOLO_GATE) & ((p[:, 5:] * p[:, 4:5]).max(1) > YOLO_GATE)).sum())


def calibrate_objectness(model, inputs):
    """The offset of the objectness prior that lets YOLO_TARGET_ROWS rows a
    forward (on average over ``inputs``) through both gates: bisection on
    the card's maps, the head's other outputs unchanged."""
    with torch.inference_mode():
        preds = [model(torch.from_numpy(x).cuda())["prediction"].cpu().numpy()[0]
                 for x in inputs]
    obj = [np.clip(p[:, 4].astype(np.float64), 1e-30, 1 - 1e-7) for p in preds]
    logit = [np.log(o / (1 - o)) for o in obj]
    best = [p[:, 5:].max(1) for p in preds]

    def passing(delta):
        obj = [1 / (1 + np.exp(-(lg + delta))) for lg in logit]
        return np.mean([((o > YOLO_GATE) & (o * b > YOLO_GATE)).sum() for o, b in zip(obj, best)])

    lo, hi = -20.0, 20.0
    for _ in range(50):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if passing(mid) < YOLO_TARGET_ROWS else (lo, mid)
    return hi


def write_yolo_folds(workdir: Path, inputs):
    """YOLO_FOLDS ultralytics-layout state-dict .pt files: a seeded base
    detector whose objectness prior is offset on the card
    (calibrate_objectness), and each fold's conv weights perturbed by its
    own seed (folds of one training agree on most boxes)."""
    base = seeded_detector(0).cuda()
    delta = calibrate_objectness(base, inputs)
    base = base.cpu()
    with torch.no_grad():
        for conv in base.detect.m:
            conv.bias.view(3, -1)[:, 4] += delta
    paths = []
    for k in range(YOLO_FOLDS):
        gen = torch.Generator().manual_seed(100 + k)
        sd = {key: v * (1 + YOLO_FOLD_NOISE * torch.randn(v.shape, generator=gen))
              if v.ndim == 4 else v for key, v in base.state_dict().items()}
        path = workdir / f"yolov5s_fold{k}.pt"
        torch.save(sd, path)
        paths.append(str(path))
    return paths, float(delta)


def _letterboxed(img_dir, i):
    """(image, its letterboxed (1, 3, 640, 640) input) of the tree's i-th PNG."""
    from PIL import Image

    img = np.asarray(Image.open(Path(img_dir) / f"cxr_{i:03d}.png").convert("RGB"), np.uint8)
    return img, chest_inference.prepare_input(img, YOLO_SIZE)[0]


def near_gate(pred, eps=1e-5):
    """Rows whose objectness or objectness x class score lies within eps of
    run_detector's gate."""
    p = pred[0]
    conf = p[:, 5:] * p[:, 4:5]
    return int((np.abs(p[:, 4] - YOLO_GATE) < eps).sum() + (np.abs(conf - YOLO_GATE) < eps).sum())


def yolo_reading(pt, images):
    """The port's YOLOv5 on the card against the same .pt on the CPU (raw
    predictions) and against the ultralytics oracle on the card; of_bound
    the larger worst |a - b| / (atol + rtol |b|) (above 1: outside)."""
    fn_cuda = chest_lesions.detector_fn_from_checkpoint(pt, YOLO_NC, YOLO_DM, YOLO_WM)
    fn_cpu = chest_lesions.detector_fn_from_checkpoint(pt, YOLO_NC, YOLO_DM, YOLO_WM,
                                                       device="cpu")
    oracle = OYOLO()
    oracle.load_state_dict(yolov5_state_dict_from_ultralytics(load_checkpoint(pt)), strict=True)
    oracle = oracle.cuda().eval()
    out = {"card_vs_cpu": 0.0, "card_vs_oracle": 0.0, "max_abs_err": 0.0, "preds": []}
    for _, x in images:
        card, cpu = fn_cuda(x), fn_cpu(x)
        with torch.inference_mode(), chest_lesions.tf32_off():
            ref = oracle(torch.from_numpy(x).cuda()).cpu().numpy()
        check(card.shape == cpu.shape == ref.shape, f"shapes {card.shape} {cpu.shape} {ref.shape}")
        for key, want in (("card_vs_cpu", cpu), ("card_vs_oracle", ref)):
            share = np.abs(card - want) / (YOLO_TOL["atol"] + YOLO_TOL["rtol"] * np.abs(want))
            out[key] = max(out[key], float(share.max()))
        out["max_abs_err"] = max(out["max_abs_err"], float(np.abs(card - cpu).max()))
        out["preds"].append((card, cpu))
    out["of_bound"] = max(out["card_vs_cpu"], out["card_vs_oracle"])
    return out, fn_cuda, fn_cpu


def phase_detector(workdir: Path, tree):
    """Phase 47: YOLOv5s at 640 px on the card, five seeded folds."""
    t0 = time.perf_counter()
    images = [_letterboxed(tree[0], i) for i in range(2)]
    pts, delta = write_yolo_folds(workdir, [x for _, x in images])
    reading, fn_cuda, fn_cpu = yolo_reading(pts[0], images)
    check(reading["of_bound"] <= 1.0,
          f"YOLOv5s on the card lies {reading['card_vs_cpu']:.3g} of atol 2e-4 + rtol 1e-4 from "
          f"the CPU and {reading['card_vs_oracle']:.3g} from the ultralytics oracle")
    passed = [gate_counts(card) for card, _ in reading["preds"]]
    log(f"[chestmir] YOLOv5s (nc {YOLO_NC}, depth {YOLO_DM}, width {YOLO_WM}) at {YOLO_SIZE} px: "
        f"the card's raw (1, 25200, {5 + YOLO_NC}) predictions against the CPU's: max abs err "
        f"{reading['max_abs_err']:.3g}, {reading['card_vs_cpu']:.3g} of the bound (atol 2e-4, "
        f"rtol 1e-4); against the ultralytics oracle on the card {reading['card_vs_oracle']:.3g}"
        f"; objectness prior offset {delta:.3f}; rows through the {YOLO_GATE} gates {passed}")
    kept, near = [], 0
    for (img, _), (card, cpu) in zip(images, reading["preds"]):
        # run_detector on the forwards above (the same letterboxed input)
        got = chest_inference.run_detector(lambda _, p=card: p, img, YOLO_SIZE)
        want = chest_inference.run_detector(lambda _, p=cpu: p, img, YOLO_SIZE)
        same = (len(got[0]) == len(want[0]) and np.array_equal(got[0], want[0])
                and np.array_equal(got[2], want[2])
                and np.allclose(got[1], want[1], rtol=0, atol=1e-5))
        if not same:
            n = near_gate(card) + near_gate(cpu)
            check(n > 0, f"the card's detections differ from the CPU's ({len(got[0])} against "
                         f"{len(want[0])} boxes) with no confidence within 1e-5 of a gate")
            log(f"[chestmir] detections differ between the card and the CPU on an image where "
                f"{n} rows lie within 1e-5 of a gate")
            near += n
        kept.append(len(got[0]))
    check(all(k > 0 for k in kept), f"a fold kept no box: {kept}")
    log(f"[chestmir] run_detector (NMS IoU {YOLO_IOU}): {kept} boxes kept an image, equal "
        f"on the card and the CPU{'' if near == 0 else ' away from the gates'}")
    # rates: one batch-1 forward by CUDA events and device_ms; run_detector's
    # wall time with the host's letterbox, copies and decode
    model = yolo_model.YOLOv5(YOLO_NC, YOLO_DM, YOLO_WM)
    load_yolov5_checkpoint(model, pts[0])
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.from_numpy(images[0][1]).cuda().contiguous(memory_format=torch.channels_last)

    def forward():
        with torch.inference_mode():
            return model(x)["prediction"]

    rates = {"events_ms": _time_ms(forward, 20), "device_ms": device_ms(forward),
             "run_detector_wall_ms": wall_ms(
                 lambda: chest_inference.run_detector(fn_cuda, images[0][0], YOLO_SIZE), 10),
             "rows_passing": passed, "boxes_kept": kept, "near_gate_rows": near,
             "max_abs_err": reading["max_abs_err"], "of_bound": reading["of_bound"],
             "objectness_offset": delta}
    log(f"[rates] YOLOv5s batch 1 at {YOLO_SIZE} px, f32 (TF32 off): {rates['events_ms']:.3f} ms "
        f"by CUDA events, {rates['device_ms']:.4f} ms by device_ms; run_detector on a "
        f"{CHEST_SIZE}^2 film (letterbox, copies, forward, NMS) {rates['run_detector_wall_ms']:.2f}"
        f" ms wall; phase {time.perf_counter() - t0:.1f} s")
    return rates, pts


PLUGIN = '''"""The five seeded YOLOv5s folds of chip_smoke.py phase 48, each call's
seconds summed (the detector forwards' share of detection)."""
import time

from xmir_tpu_torch.chestmir.lesions import detector_fn_from_checkpoint

PATHS = {paths!r}
FORWARD_SECONDS = [0.0]


def _timed(fn):
    def call(x):
        t0 = time.perf_counter()
        out = fn(x)
        FORWARD_SECONDS[0] += time.perf_counter() - t0
        return out
    return call


def build_detectors():
    return [_timed(detector_fn_from_checkpoint(p, {nc}, {dm}, {wm})) for p in PATHS]
'''


def _chest_artifact(path):
    data = np.load(path, allow_pickle=True)
    return data["global_vectors"], json.loads(str(data["regions_json"]))


def phase_chestmir_ingest(workdir: Path, tree, pts):
    """Phase 48: cli.chestmir_ingest --model convnextv2 (f32, under
    XMIR_FUSED_MLP=1: K9 in every block) with the five folds x TTA 0 / 4,
    then again with the tail's plain version."""
    import importlib
    import sys

    (workdir / "chest_folds_plugin.py").write_text(
        PLUGIN.format(paths=pts, nc=YOLO_NC, dm=YOLO_DM, wm=YOLO_WM))
    sys.path.insert(0, str(workdir))
    args = ["--dataset", "covid", "--dataset-dir", tree[0], "--test-image-list", tree[1],
            "--split", "test", "--model", "convnextv2", "--device", "cuda", "--seed", "0",
            "--batch-size", str(CHEST_BATCH), "--region-batch-size", str(CHEST_BATCH),
            "--detector-plugin", "chest_folds_plugin", "--raw-detector-outputs", "--tta",
            CHEST_TTA, "--score-thres", str(CHEST_SCORE)]
    runs = {}
    try:
        plugin = importlib.import_module("chest_folds_plugin")
        with env_flags(XMIR_FUSED_MLP="1"):  # the f32 CLIs take K9
            for name, ctx in (("K9", contextlib.nullcontext()),
                              ("plain", tail_plain_version())):
                gal = str(workdir / f"chestmir_{name}.npz")
                plugin.FORWARD_SECONDS[0] = 0.0
                reset_launches()
                t0 = time.perf_counter()
                with ctx:
                    summary = chestmir_ingest_cli.main(args + ["--output", gal])
                runs[name] = dict(summary, wall=time.perf_counter() - t0, gallery=gal,
                                  launches=read_launches(), forward=plugin.FORWARD_SECONDS[0])
    finally:
        sys.path.remove(str(workdir))
    g, regions = _chest_artifact(runs["K9"]["gallery"])
    g_plain, regions_plain = _chest_artifact(runs["plain"]["gallery"])
    n_regions = sum(len(r) for r in regions)
    check(n_regions > 0, "the ingest found no region")
    batches = -(-CHEST_N // CHEST_BATCH) + sum(-(-len(r) // CHEST_BATCH) for r in regions)
    launches = runs["K9"]["launches"]
    want = dict.fromkeys(WRAPPERS, 0)
    want["K9"] = DEPTH * batches
    check(launches == want, f"chestmir ingest: launches {launches}, expected {want} ({DEPTH} x "
                            f"{batches} global and region batches)")
    _no_launches(runs["plain"]["launches"], "the ingest with the tail's plain version")
    check([[(r["label"], r["box"]) for r in rs] for rs in regions] == [
        [(r["label"], r["box"]) for r in rs] for rs in regions_plain],
        "region labels or boxes differ between the two runs")
    g_err = float(np.abs(g - g_plain).max())
    r_err = max(float(np.abs(np.asarray(a["vector"]) - np.asarray(b["vector"])).max())
                for rs, ps in zip(regions, regions_plain) for a, b in zip(rs, ps))
    check(max(g_err, r_err) <= CONVNEXT_EMBED_TOL,
          f"the ingest's vectors lie {g_err:.3g} (global) / {r_err:.3g} (regions) from the tail's "
          f"plain version's, above {CONVNEXT_EMBED_TOL}")
    run = runs["K9"]
    sec = run["seconds"]
    total = sum(sec.values())
    split = {"image_load_s": sec["load"], "detector_forwards_s": run["forward"],
             "host_decode_nms_wbf_s": sec["detect"] - run["forward"],
             "crops_and_region_embeds_s": sec["regions"], "global_embeds_s": sec["global"]}
    rates = {"images": CHEST_N, "regions": n_regions, "img_per_s": CHEST_N / total,
             "wall_s_with_builds": run["wall"], "split_s": split, "launches": launches,
             "global_max_abs_err": g_err, "region_max_abs_err": r_err,
             "plain_img_per_s": CHEST_N / sum(runs["plain"]["seconds"].values())}
    log(f"[chestmir] cli.chestmir_ingest --model convnextv2 (f32, XMIR_FUSED_MLP=1), "
        f"{YOLO_FOLDS} folds x TTA {CHEST_TTA}: {CHEST_N} films at {CHEST_SIZE}^2, {n_regions} "
        f"regions; K9 launches {launches['K9']} ({DEPTH} x {batches} batches); vectors against "
        f"the tail's plain version: global {g_err:.3g}, regions {r_err:.3g} (<= "
        f"{CONVNEXT_EMBED_TOL}); labels and boxes equal")
    log(f"[rates] chestmir ingest: {rates['img_per_s']:.2f} img/s ({total:.2f} s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
        + f"); {run['wall']:.1f} s wall with the model builds; plain tail "
          f"{rates['plain_img_per_s']:.2f} img/s")
    return rates, run["gallery"]


def phase_chestmir_eval(workdir: Path, gallery):
    """Phase 49: cli.chestmir_eval on phase 48's artifact against
    two_stage_eval on the same artifact, adaptive and one specific lesion."""
    _, regions = _chest_artifact(gallery)
    counts = collections.Counter(canonical_lesion_name(r["label"]) for rs in regions for r in rs)
    specific = counts.most_common(1)[0][0]
    out = str(workdir / "chestmir_results.json")
    t0 = time.perf_counter()
    chestmir_eval_cli.main(["--gallery", gallery, "--specific-lesions", specific,
                            "--rerank-topk", "10", "--output", out])
    dt = time.perf_counter() - t0
    with open(out) as f:
        got = json.load(f)
    g, labels, _, maps = chestmir_eval_cli.load_chestmir_npz(gallery)
    target = ["consolidation", "lung opacity", "infiltration", "atelectasis", "pleural effusion"]
    want = json.loads(json.dumps(two_stage_eval(g, labels, maps, target, [specific],
                                                rerank_topk=10), default=float))
    check(got == want, "cli.chestmir_eval's JSON differs from two_stage_eval's")
    stats = {stage: {k: payload["stats"].get(k) for k in ("queries_reranked",
                                                           "queries_fallback_global")}
             for stage, payload in got.items() if payload["stats"]}
    check(all(s["queries_reranked"] > 0 for s in stats.values()),
          f"a stage reranked no query: {stats}")
    log(f"[chestmir] cli.chestmir_eval ({dt:.2f} s) equals two_stage_eval on the artifact; "
        f"reranked / fallback queries: {stats}; mAP by stage "
        f"{ {k: round(v['report']['mAP'], 4) for k, v in got.items()} }")
    return {"stats": stats, "mAP": {k: v["report"]["mAP"] for k, v in got.items()},
            "specific_lesion": specific, "seconds": dt}


def phases_chestmir():
    """Phases 47 to 49: the YOLOv5s folds, the ChestMIR ingest and its
    two-stage evaluation on one generated tree of chest films."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        tree = write_chest_tree(Path(tmp))
        log(f"[chestmir] wrote {CHEST_N} chest-like PNGs at {CHEST_SIZE}^2 in "
            f"{time.perf_counter() - t0:.1f} s")
        detector, pts = phase_detector(Path(tmp), tree)
        ingest_rates, gallery = phase_chestmir_ingest(Path(tmp), tree, pts)
        evaluation = phase_chestmir_eval(Path(tmp), gallery)
    return {"detector": detector, "ingest": ingest_rates, "eval": evaluation}


def load_vindr_ids(csv_path):
    with open(csv_path) as f:
        return sorted({line.split(",")[0] for line in f.read().splitlines()[1:] if line})


# --- the mesh phases (50-54): --use-mesh on torch.distributed ------------------


def nccl_world_of_one():
    """A world of 1 on the card is NCCL's, and leaves no process group."""
    import torch.distributed as dist

    from xmir_tpu_torch.parallel import make_mesh

    with make_mesh("cuda") as mesh:
        backend = dist.get_backend()
        gathered = mesh.all_gather(torch.arange(3, device=mesh.device))
    check(backend == "nccl" and mesh.world == 1 and not dist.is_initialized(),
          f"the world of 1: backend {backend}, world {mesh.world}")
    check(torch.equal(gathered.cpu(), torch.arange(3)[None]), "NCCL's all_gather at world 1")
    return backend


def uploaded_as_stored(paths, uris, store):
    """The stored URIs of ``paths``: store/original/<path relative to the
    images' common directory>, each a byte copy of its original."""
    common_dir = os.path.commonpath(sorted({os.path.dirname(os.path.abspath(p)) for p in paths}))
    want = [os.path.join(store, "original", os.path.relpath(os.path.abspath(p), common_dir))
            for p in paths]
    check(uris == want, f"stored URIs {uris[:2]} ..., expected {want[:2]} ...")
    check(all(Path(u).read_bytes() == Path(p).read_bytes() for u, p in zip(uris, paths)),
          "an uploaded original differs from its file")


def phase_mesh_slice(workdir: Path, gallery, queries, model_args, gal, results):
    """Mesh A (phase 50): phase 4's chain again under --use-mesh."""
    t0 = time.perf_counter()
    backend = nccl_world_of_one()
    (img_dir, g_manifest), (q_dir, q_manifest) = gallery, queries
    mesh_gal, store = str(workdir / "gallery_mesh.npz"), str(workdir / "store")
    reset_launches()
    idx = ingest.main(["--dataset", "covid", "--dataset-dir", img_dir, "--train-image-list",
                       g_manifest, "--split", "train", "--output", mesh_gal, "--use-mesh",
                       "--upload-originals", store] + model_args)
    ingest_launches = read_launches()
    got = query.main(["--dataset", "covid", "--dataset-dir", q_dir, "--test-image-list",
                      q_manifest, "--split", "test", "--index", mesh_gal, "--top-k", "10",
                      "--output", str(workdir / "hits_mesh.json"), "--use-mesh"] + model_args)
    launches = read_launches()
    want = dict.fromkeys(WRAPPERS, 0)
    want["K1"] = 1  # one search of the queries, one shard
    check(not any(ingest_launches.values()) and launches == want,
          f"mesh A: launches {launches} (ingest {ingest_launches}), expected {want}")
    check(idx.info()["sharding"] == {"devices": 1, "rows_per_shard": SLICE_ROWS[0]},
          f"mesh A: info {idx.info()}")
    a, b = np.load(gal), np.load(mesh_gal)
    check(np.array_equal(a["embeds"], b["embeds"]) and np.array_equal(a["labels"], b["labels"])
          and str(a["meta"]) == str(b["meta"]),
          "mesh A: the index saved under --use-mesh differs from phase 4's")
    uploaded_as_stored([str(p) for p in a["paths"]], [str(p) for p in b["paths"]], store)
    for r0, r1 in zip(results, got, strict=True):
        check([(h["id"], h["similarity"], h["distance"], h["label"]) for h in r0["results"]]
              == [(h["id"], h["similarity"], h["distance"], h["label"]) for h in r1["results"]],
              f"mesh A: hits of {r0['query_path']} differ")
    common_args = ["--dataset", "covid", "--dataset-dir", q_dir, "--test-image-list",
                   q_manifest, "--model", "densenet121", "--device", "cuda", "--seed", "0",
                   "-j", "8"]
    plain = test_cli.main(common_args + ["--save-dir", str(workdir / "test_plain")])
    meshed = test_cli.main(common_args + ["--save-dir", str(workdir / "test_mesh"),
                                          "--use-mesh"])
    x, y = (np.load(workdir / d / "evaluation_results.npz") for d in ("test_plain", "test_mesh"))
    check(meshed == plain and np.array_equal(x["embeds"], y["embeds"])
          and np.array_equal(x["dists"], y["dists"]),
          "mesh A: cli.test --use-mesh differs from cli.test")
    log(f"[mesh A] cli.ingest --use-mesh --upload-originals -> cli.query --use-mesh and "
        f"cli.test --use-mesh, DenseNet121 at 224 px over a world of 1 ({backend}): the index "
        f"bit-equal to phase 4's ({a['embeds'].shape[0]} rows, its paths the {len(b['paths'])} "
        f"stored URIs), hits and cli.test's metrics and artifact equal; info "
        f"{idx.info()['sharding']}; launches {launches}; {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "backend": backend, "sharding": idx.info()["sharding"]}


SHARD_WORLD = 4  # the world phase 51 splits the serving gallery for


def ties_lower_first(v, i):
    """Whether every pair of equal neighbouring values holds its ids in
    ascending order."""
    same = (v[:, 1:] == v[:, :-1]) & torch.isfinite(v[:, 1:])
    return bool(((i[:, 1:] > i[:, :-1]) | ~same).all())


def shard_reading(q, g, k, dtype, merge=merge_shard_candidates, world=SHARD_WORLD):
    """The sharded search as a world of ``world`` splits it (every shard
    body on the card, then ``merge``) against one unsharded call: (reading,
    the sharded function, the unsharded one)."""
    n = g.shape[0]
    rows, pad = shard_layout(n, world)
    qq = q.to(dtype)
    gg = g.to(dtype)
    gp = torch.cat([gg, gg.new_zeros((pad, g.shape[1]))])
    shards = [gp[r * rows:(r + 1) * rows] for r in range(world)]
    body = make_local_shard_search(k, rows, n, "ip", dtype)

    def sharded():
        cands = [body(qq, shard, r) for r, shard in enumerate(shards)]
        return merge(torch.stack([c[0] for c in cands]), torch.stack([c[1] for c in cands]), k)

    def whole():
        return fused_topk(qq, gg, k, "ip", compute_dtype=dtype)

    v, i = sharded()
    wv, wi = whole()
    torch.cuda.synchronize()
    bit = torch.equal(v, wv) and torch.equal(i, wi)
    fin = torch.isfinite(wv)
    reading = {"bit_equal": bit, "ties_lower_first": ties_lower_first(v, i),
               "max_abs_err": (v[fin] - wv[fin]).abs().max().item(),
               "ids_differing": int((i != wi).sum()), "rows_per_shard": rows,
               "valid_in_last": n - rows * (world - 1)}
    if not bit:  # K1's near-tie rule: ids equal except where the gap is below TIE_GAP
        rv, _ = topk_scores_reference(qq, gg, torch.zeros(n, device=q.device), k + 1)
        try:
            compare(v, i, wv, wi, 0.0, rv)
            reading["near_tie_rule"] = True
        except AssertionError as e:
            reading["near_tie_rule"] = str(e)
    return reading, sharded, whole


def shard_agrees(reading) -> bool:
    return reading["bit_equal"] and reading["ties_lower_first"]


def planted_shard_inputs(q, g, world=SHARD_WORLD):
    """Copies of q and g with the last row of each shard copied into the
    next shard's first, and queries equal to those rows: ties across every
    shard boundary at the top of their rankings."""
    g, q = g.clone(), q.clone()
    rows, _ = shard_layout(g.shape[0], world)
    for j, b in enumerate(range(rows, g.shape[0], rows)):
        g[b] = g[b - 1]
        q[j] = g[b - 1]
    return q, g


def phase_shards():
    """Mesh B (phase 51)."""
    n, d = SERVING_N, SERVING_D
    gen = torch.Generator().manual_seed(51)
    q = l2_normalize(torch.randn((1024, d), generator=gen)).cuda()
    g = l2_normalize(torch.randn((n, d), generator=gen)).cuda()
    pq, pg = planted_shard_inputs(q, g)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for k in (10, 100):
            key = f"{str(dtype)[6:]} k={k}"
            reading, sharded, whole = shard_reading(q, g, k, dtype)
            planted, _, _ = shard_reading(pq, pg, k, dtype)
            check(planted["bit_equal"] and planted["ties_lower_first"],
                  f"mesh B {key}, duplicates across the shard boundaries: {planted}")
            if not reading["bit_equal"]:
                check(reading.get("near_tie_rule") is True,
                      f"mesh B {key}: the sharded search is neither bit-equal to the unsharded "
                      f"call nor within K1's near-tie rule: {reading}")
            reset_launches()
            sharded()
            launches = read_launches()
            route = "K1" if k <= 32 else "K1'"
            check(launches[route] == SHARD_WORLD and sum(launches.values()) == SHARD_WORLD,
                  f"mesh B {key}: launches {launches}")
            shard_ms, whole_ms = device_ms(sharded), device_ms(whole)
            out[key] = dict(reading, planted=planted, per_shard_launches=launches[route],
                            sharded_device_ms=shard_ms, unsharded_device_ms=whole_ms)
            log(f"[mesh B] {key} Q=1024 N={n} D={d} over {SHARD_WORLD} shards of "
                f"{reading['rows_per_shard']} rows ({reading['valid_in_last']} valid in the "
                f"last), {route}: bit-equal to one unsharded call {reading['bit_equal']} (ids "
                f"differing {reading['ids_differing']}, max err {reading['max_abs_err']:.3g}), "
                f"planted duplicates bit-equal {planted['bit_equal']}, ties to the lower id "
                f"{planted['ties_lower_first']}; device {shard_ms:.4f} ms for the {SHARD_WORLD} "
                f"shard searches and the merge, {whole_ms:.4f} ms unsharded")
    return out


def mesh_train_dinov2(workdir: Path, run, pt, start, losses, ckpt, launches, steps):
    """Mesh C (phase 52), DINOv2: --use-mesh and --use-mesh --fsdp against
    phase 18's run (which started from ``start``), then the FSDP checkpoint
    resumed for epoch 2 against check_resume's two-epoch run."""
    out = {}
    ref = load_checkpoint(ckpt, unwrap=False)
    for name, extra in (("dp", ("--use-mesh",)), ("fsdp", ("--use-mesh", "--fsdp"))):
        reset_launches()
        t0 = time.perf_counter()
        got, path = run(name, "--bf16", "--epochs", "1", "--resume", pt, *extra)
        wall = time.perf_counter() - t0
        got_launches = read_launches()
        check(got_launches == launches,
              f"mesh C {name}: launches {got_launches}, phase 18's {launches}")
        tree = load_checkpoint(path, unwrap=False)
        a, b = tree["state_dict"], ref["state_dict"]
        bit = got == losses and all(torch.equal(v, b[k]) for k, v in a.items()) and all(
            torch.equal(v, ref["optimizer"]["state"][i][key])
            for i, st in tree["optimizer"]["state"].items() for key, v in st.items())
        moved = torch.cat([(b[k] - start[k]).abs().flatten() for k in b])
        apart = torch.cat([(a[k] - b[k]).abs().flatten() for k in b])
        share = (apart.mean() / moved.mean()).item()
        first = abs(got[0][2] - losses[0][2])
        if name == "dp":
            check(bit, f"mesh C dp: the data-parallel run at world 1 is not bit-equal to phase "
                       f"18's (losses {got} / {losses}, parameters apart {share:.3g})")
        else:
            check(first <= 1e-5 and share <= TRAIN_F32_MEAN_TOL,
                  f"mesh C fsdp: first loss {first} apart, parameters {share:.3g} of the movement")
        out[name] = {"bit_equal": bit, "first_loss_diff": first, "mean_apart_of_moved": share,
                     "wall_s": wall, "losses": [r[2] for r in got]}
        log(f"[mesh C] cli.train dinov2 --bf16 {' '.join(extra)} at world 1: {len(got)} steps, "
            f"launches {got_launches} (phase 18's), bit-equal to phase 18 {bit}, first loss "
            f"{first:.3g} apart, parameters {share:.3g} of the movement apart; {wall:.1f} s")
        if name == "fsdp":
            fsdp_ckpt = path
    reset_launches()
    resumed, path = run("fsdp_resumed", "--bf16", "--epochs", "2", "--resume", fsdp_ckpt,
                        "--use-mesh", "--fsdp")
    check(read_launches()["K3"] == VIT["depth"] * steps[1], "mesh C: the resumed epoch's K3")
    whole = workdir / "whole"
    a = load_checkpoint(whole / checkpoint_name("covid", "dinov2", seed=0, epoch=2), unwrap=False)
    b = load_checkpoint(path, unwrap=False)
    whole_losses = [json.loads(line) for line in (workdir / "whole.jsonl").read_text().splitlines()]
    whole_losses = [(r["epoch"], r["step"], r["loss"]) for r in whole_losses
                    if r["kind"] == "train"]
    check(resumed == whole_losses[steps[0]:] and a["step"] == b["step"] and all(
        torch.equal(v, b["state_dict"][k]) for k, v in a["state_dict"].items()) and all(
        torch.equal(v, b["optimizer"]["state"][i][key])
        for i, st in a["optimizer"]["state"].items() for key, v in st.items()),
        "mesh C: the FSDP checkpoint resumed under --fsdp does not continue bit-exactly")
    out["fsdp_resume_bit_exact"] = True
    log(f"[mesh C] the FSDP checkpoint resumed under --use-mesh --fsdp for epoch 2: losses, "
        f"parameters and Adam moments bit-equal to the uninterrupted two-epoch run")
    return out


def mesh_train_cache(workdir: Path, run, data, steps):
    """Mesh C (phase 52), DenseNet121: --use-mesh --cache-dir for epoch 1,
    then --resume of it for epoch 2 from the filled cache, against phase
    19's two-epoch run without a cache."""
    from xmir_tpu_torch.data.datasets import CovidxDataset
    from xmir_tpu_torch.data.transforms import pil_resize_center_crop

    cache = str(workdir / "cache")
    first, ckpt1 = run("cached1", "--epochs", "1", "--use-mesh", "--cache-dir", cache)
    meta = workdir / "cache" / "meta.json"
    check(meta.is_file(), "mesh C: the decoded-image cache is not complete after epoch 1")
    size = json.loads(meta.read_text())["size"]
    images = np.load(workdir / "cache" / "images.npy", mmap_mode="r")
    dataset = CovidxDataset(data[0], data[1])
    for i in range(len(dataset)):
        check(np.array_equal(images[i], pil_resize_center_crop(dataset.load_image(i), size)),
              f"mesh C: cached row {i} is not its decode")
    second, ckpt2 = run("cached2", "--epochs", "2", "--resume", ckpt1, "--use-mesh",
                        "--cache-dir", cache)
    records = [json.loads(line) for line in (workdir / "whole.jsonl").read_text().splitlines()]
    whole = [(r["epoch"], r["step"], r["loss"]) for r in records if r["kind"] == "train"]
    check(first + second == whole, f"mesh C: cached losses {first + second}, uncached {whole}")
    a = load_checkpoint(workdir / "whole" / Path(ckpt2).name, unwrap=False)
    b = load_checkpoint(ckpt2, unwrap=False)
    check(all(torch.equal(v, b["state_dict"][k]) for k, v in a["state_dict"].items()),
          "mesh C: the run through the cache ends apart from the run without it")
    log(f"[mesh C] cli.train densenet121 --use-mesh --cache-dir: the cache complete after epoch "
        f"1 ({len(dataset)} rows at {size} px, each its decode), epoch 2 read from it; losses "
        f"and tensors bit-equal to the two-epoch run without the cache")
    return {"cache_rows": len(dataset), "size": size, "bit_equal": True}


def mesh_saliency(workdir: Path, common_args, xai, maps, saved_out, n_q, top_k):
    """Mesh D (phase 53): compute_saliency / evaluate_saliency --use-mesh
    against phase 24's runs without it (phase 24's n_q queries, of whose top
    top_k the maps of the first top_k - 1 are made again)."""
    from xmir_tpu_torch.cli import compute_saliency, evaluate_saliency

    mesh_maps = workdir / "sal_maps_mesh"
    fewer = xai[:xai.index("--top-k")] + ["--top-k", str(top_k - 1), "--limit", str(n_q)]
    t0 = time.perf_counter()
    compute_saliency.main(common_args + fewer + [
        "--results", str(workdir / "sal_res" / "evaluation_results.npz"),
        "--save-dir", str(mesh_maps), "--use-mesh"])
    sbsm_wall = time.perf_counter() - t0
    saved = sorted(mesh_maps.iterdir())
    check(len(saved) == n_q * (top_k - 1),
          f"mesh D: {len(saved)} maps for {n_q} queries x top {top_k - 1}")
    map_err = max(float(np.abs(np.load(p) - np.load(maps / p.name)).max()) for p in saved)
    check(map_err <= 1e-6, f"mesh D: maps {map_err} apart from phase 24's")
    reset_launches()
    ins = ["--step", "1000", "--top-k", str(top_k), "--limit", str(n_q)]
    got = evaluate_saliency.main(common_args + ins + ["--saliency-dir", str(maps), "--output",
                                                      str(workdir / "insdel_mesh.json"),
                                                      "--use-mesh"])
    launches = read_launches()
    check(launches["K1"] == 1 and sum(launches.values()) == 1, f"mesh D: launches {launches}")
    auc_err = max(abs(x - y) for r, s in zip(got["results"], saved_out["results"], strict=True)
                  for x, y in zip(r["per_pair_del"] + r["per_pair_ins"],
                                  s["per_pair_del"] + s["per_pair_ins"], strict=True))
    summary = got["summary"]
    check(auc_err <= 1e-6 and summary["use_mesh"] is True and summary["mesh_devices"] == 1,
          f"mesh D: AUCs {auc_err} apart, summary {summary['use_mesh'], summary['mesh_devices']}")
    log(f"[mesh D] cli.compute_saliency --use-mesh ({n_q} queries x top {top_k - 1}, 2401 masks, "
        f"{sbsm_wall:.1f} s) maps within {map_err:.3g} of phase 24's; cli.evaluate_saliency "
        f"--use-mesh AUCs within {auc_err:.3g}, use_mesh {summary['use_mesh']}, mesh_devices "
        f"{summary['mesh_devices']}, launches {launches}")
    return {"launches": launches, "map_err": map_err, "auc_err": auc_err,
            "sbsm_wall_s": sbsm_wall}


def phase_host(workdir: Path):
    """Mesh E (phase 54)."""
    from xmir_tpu_torch.cli import parity as parity_cli
    from xmir_tpu_torch.data import native_loader
    from xmir_tpu_torch.data.datasets import NIHChestXrayRetrievalDataset
    from xmir_tpu_torch.data.pipeline import batch_iterator, prefetch_to_device
    from xmir_tpu_torch.utils import profiling

    profiling.reset_spans()
    with profiling.span("native build"):
        lib = native_loader.build()
        native_loader.load()
    check(lib.is_relative_to(REPO / "build"), f"the native reader built outside build/: {lib}")
    root, _ = write_nih_tree(workdir / "nih", 64, seed=54)
    native = NIHChestXrayRetrievalDataset(data_dir=root)
    pil = NIHChestXrayRetrievalDataset(data_dir=root, use_native=False)
    before = dict(native_loader.LOADS)
    with profiling.span("native batches"):
        batches = list(batch_iterator(native, 16, image_size=224, num_workers=8))
    counted = {k: native_loader.LOADS[k] - before.get(k, 0) for k in ("native", "fallback")}
    check(counted == {"native": 64, "fallback": 0}, f"mesh E: the reader's counter {counted}")
    with profiling.span("PIL batches"):
        ref = np.concatenate([pil.load_batch_cropped(list(i), 224) for _, _, i in batches])
    diff = np.abs(np.concatenate([b[0] for b in batches]).astype(int) - ref.astype(int))
    med, mean = float(np.median(diff)), float(diff.mean())
    check(med <= 1 and mean < 3, f"mesh E: native against PIL median {med}, mean {mean}")
    sums, staged = [], []
    with profiling.span("prefetch"):
        for x, labels, idxs in prefetch_to_device(iter(batches), "cuda", size=2):
            sums.append(x.to(torch.int64).sum())  # read at once, on the consumer's stream
            staged.append(x)
        torch.cuda.synchronize()
    check([int(s) for s in sums] == [int(b[0].astype(np.int64).sum()) for b in batches]
          and all(torch.equal(x.cpu(), torch.from_numpy(b[0])) for x, b in zip(staged, batches)),
          "mesh E: a prefetched batch differs from the host's")
    golden = str(REPO / "tests" / "fixtures" / "reference_single_label_golden.npz")
    res = parity_cli.main(["--results", golden, "--output", str(workdir / "parity.json")])
    check(res["mismatches"] == [], f"mesh E: cli.parity {res['mismatches']}")
    gen = torch.Generator().manual_seed(54)
    qq = l2_normalize(torch.randn((64, 1024), generator=gen)).cuda()
    gg = l2_normalize(torch.randn((4096, 1024), generator=gen)).cuda()
    with profiling.trace(str(workdir / "trace")):
        fused_topk(qq, gg, 10, "ip")
        torch.cuda.synchronize()
    events = json.loads((workdir / "trace" / "trace.json").read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    spans = profiling.span_report()
    check(set(spans) == {"native build", "native batches", "PIL batches", "prefetch"},
          f"mesh E: spans {spans}")
    log(f"[mesh E] native NIH reader ({lib.relative_to(REPO)}): 64 images native, against "
        f"PIL median |diff| {med}, mean {mean:.3f}; prefetch_to_device: {len(staged)} "
        f"batches equal to the host's; cli.parity on the single-label golden: "
        f"{len(res['computed'])} metric groups agree; trace: {len(events)} events, {kernels} "
        f"device kernels; spans {spans}")
    return {"native_vs_pil": {"median": med, "mean": mean}, "loads": counted,
            "trace_events": len(events), "trace_kernels": kernels, "spans": spans}


def phases_mesh():
    """The phases --mesh-only runs: 4 (with 50), 18 and 19 (with 52), 24
    (with 53), 51 and 54."""
    with tempfile.TemporaryDirectory() as tmp:
        phase_slice(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_dinov2(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_train_densenet(Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        phase_saliency(Path(tmp))
    phase_shards()
    with tempfile.TemporaryDirectory() as tmp:
        phase_host(Path(tmp))


# Unit embeddings of DINOv2 split over a model axis against world 1's: f32
# within the JAX TP test's atol, bf16 within PERF.md section 2's bf16 DINOv2
# bound. Set before the first chip call; a fault must not pass (LayerScale is
# random and nonzero: at its 1e-5 init every embedding is nearly the same).
TP_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
TP_BATCH = 16
TP_MODEL_LEAVES = ("attn.qkv.", "attn.proj.", "mlp.fc1.", "mlp.fc2.")


# auto_param_shardings of DINOv2 ViT-B/14 in the torch layout (the JAX rule
# mapped across: tests/test_torch_tensor_parallel.py derives it from the JAX
# package), block 0 standing for every block: Megatron's split of the block,
# pos_embed's 1370 tokens at tp = 2 only (1370 % 4 = 2)
_BLOCK_RULE = {"blocks.0.attn.qkv.weight": 0, "blocks.0.attn.proj.weight": 1,
               "blocks.0.mlp.fc1.weight": 0, "blocks.0.mlp.fc2.weight": 1}
VIT_B14_RULE = {2: {"cls_token": 2, "pos_embed": 1, "patch_embed.proj.weight": 0, **_BLOCK_RULE},
                4: {"cls_token": 2, "patch_embed.proj.weight": 0, **_BLOCK_RULE}}


def vit_b14_rule(n_model):
    """The sharded leaves of DINOv2 ViT-B/14 (built on the meta device) at a
    model axis of ``n_model``, block 0 standing for every block (which must
    all agree)."""
    from xmir_tpu_torch.parallel import Mesh, auto_param_shardings

    with torch.device("meta"):
        model = vit_model.vit_base_patch14_dinov2()
    rule = auto_param_shardings(model, Mesh(world=n_model, rank=0, device=torch.device("cpu"),
                                            shape=(1, n_model)))
    for key, axis in rule.items():
        if key.startswith("blocks."):
            check(axis == rule["blocks.0." + key.split(".", 2)[2]],
                  f"tp: {key} splits unlike block 0's")
    return {k: v for k, v in rule.items()
            if v is not None and (k.startswith("blocks.0.") or not k.startswith("blocks."))}


@contextlib.contextmanager
def vit_piece_shapes():
    """What the ViT hands K2 and K8, recorded: K2's leading (B heads) size
    and K8's (output width, activation), from ViTBlock and from the
    tensor-parallel block alike."""
    from xmir_tpu_torch.parallel import tensor_parallel as tpm

    seen = {"K2": [], "K8": []}
    attn, dense = plain_attn.vit_attention_fused, vit_model.ln_dense_fused

    def attn_recorded(q, k, v, sm_scale):
        seen["K2"].append(q.shape[0])
        return attn(q, k, v, sm_scale)

    def dense_recorded(x, lns, lnb, w, b, eps=ld.LN_EPS, act=""):
        seen["K8"].append((w.shape[0], act))
        return dense(x, lns, lnb, w, b, eps, act)

    plain_attn.vit_attention_fused = attn_recorded
    vit_model.ln_dense_fused = tpm.ln_dense_fused = dense_recorded
    try:
        yield seen
    finally:
        plain_attn.vit_attention_fused = attn
        vit_model.ln_dense_fused = tpm.ln_dense_fused = dense


def unit_cls(model, x):
    with torch.no_grad():
        return l2_normalize(model(x)["cls"].float(), dim=1)


def tp_want(tp, mlp, b=TP_BATCH, heads=VIT["heads"], c=VIT["c"], depth=VIT["depth"]):
    """(launches, K2's leading sizes, K8's calls) of one DINOv2 forward whose
    blocks run every rank's pieces of a model axis of ``tp``."""
    launches = dict.fromkeys(WRAPPERS, 0)
    launches.update(K2=depth * tp, K8=depth * tp * (2 if mlp == "1" else 1))
    k8 = [(3 * c // tp, "")] * tp + ([(4 * c // tp, "gelu")] * tp if mlp == "1" else [])
    return launches, [b * heads // tp] * depth * tp, k8 * depth


def phase_tensor_parallel():
    """Phase 55: DINOv2 ViT-B/14 (random nonzero weights, 518 px, B = 16)
    split by auto_param_shardings, bf16 on its default path and f32 with
    the fused switches (K7 / K2 on, so that both dtypes' kernels run), each
    with and without XMIR_FUSED_LN_MLP. On a (1, 1) NCCL mesh the rule
    shards nothing and the transformed model is the model: its embeddings
    bit-equal and its launches equal. Every rank's pieces of a model axis of
    2 and 4 run on this card, combined in-process (LocalAxis: torch.cat and
    an f32 sum in rank order): K8 on each rank's qkv rows (head-major), K2
    on its H / tp heads, K8 with the GELU on its fc1 columns under the
    switch; the unit
    embeddings within TP_TOL of world 1's and nothing but cls_token and
    pos_embed gathered whole. Then K8 at the pieces' shapes (the B N rows,
    3C / tp and 4C / tp columns) held against ln_dense_reference
    (``k8_err``: with and without the GELU and the bias) and timed at the
    qkv pieces."""
    from xmir_tpu_torch.parallel import auto_param_shardings, make_mesh
    from xmir_tpu_torch.parallel import tensor_parallel as tpm

    t0 = time.perf_counter()
    base = randomized_vit(55)
    gen = torch.Generator().manual_seed(56)
    x = torch.randn((TP_BATCH, 518, 518, 3), generator=gen).cuda()
    out = {"errs": {}, "launches": {}}
    path_launches = dict.fromkeys(WRAPPERS, 0)
    for tp in (2, 4):
        rule = vit_b14_rule(tp)
        check(rule == VIT_B14_RULE[tp], f"tp: the rule at {tp}: {rule}, want {VIT_B14_RULE[tp]}")
    with make_mesh("cuda", (1, 1)) as mesh:
        check(all(v is None for v in auto_param_shardings(base, mesh).values()),
              "tp: the rule shards a leaf on a (1, 1) mesh")
        for dtype, flags in ((torch.bfloat16, {}), (torch.float32, FUSED_VIT)):
            name = str(dtype)[6:]
            ref_model = copy.deepcopy(base).to("cuda", dtype).eval()
            same = copy.deepcopy(base).to("cuda", dtype).eval()
            check(tpm.tensor_parallel(same, mesh) is same and not any(
                isinstance(m, tpm.ShardedLeaf) for m in same.modules()),
                f"tp {name}: the (1, 1) transform changed the model")
            pieces = {tp: tpm.tensor_parallel(copy.deepcopy(base).to("cuda", dtype).eval(),
                                              tp=tp) for tp in (2, 4)}
            for mlp in ("0", "1"):
                with env_flags(XMIR_FUSED_LN_MLP=mlp, **flags):
                    reset_launches()
                    ref = unit_cls(ref_model, x.to(dtype))
                    l_ref = read_launches()
                    reset_launches()
                    got = unit_cls(same, x.to(dtype))
                    l_same = read_launches()
                    want = dict.fromkeys(WRAPPERS, 0)
                    want.update(K2=VIT["depth"], K7=VIT["depth"],
                                K8=VIT["depth"] if mlp == "1" else 0)
                    check(torch.equal(ref, got) and l_ref == l_same == want,
                          f"tp {name} mlp={mlp}: (1, 1) against the model: bit-equal "
                          f"{torch.equal(ref, got)}, launches {l_same} / {l_ref}, want {want}")
                    for key in WRAPPERS:
                        path_launches[key] += l_same[key]
                    for tp, model in pieces.items():
                        tpm.GATHERS.clear()
                        reset_launches()
                        with vit_piece_shapes() as seen:
                            e = unit_cls(model, x.to(dtype))
                        launches = read_launches()
                        for key in WRAPPERS:
                            path_launches[key] += launches[key]
                        w_launches, w_k2, w_k8 = tp_want(tp, mlp)
                        err = (e - ref).abs().max().item()
                        gathered = dict(tpm.GATHERS)
                        want_gathers = {"cls_token": 1, "pos_embed": 1} if tp == 2 else {
                            "cls_token": 1}  # 1370 % 4 = 2: pos_embed replicates
                        check(err <= TP_TOL[dtype], f"tp {name} mlp={mlp} at {tp} pieces: "
                                                    f"{err} from world 1 > {TP_TOL[dtype]}")
                        check(launches == w_launches and seen["K2"] == w_k2
                              and seen["K8"] == w_k8 and gathered == want_gathers,
                              f"tp {name} mlp={mlp} at {tp} pieces: launches {launches} (want "
                              f"{w_launches}), K2 sizes {sorted(set(seen['K2']))}, K8 calls "
                              f"{sorted(set(seen['K8']))}, gathered {gathered}")
                        out["errs"][f"{name} mlp={mlp} tp={tp}"] = err
                        out["launches"][f"{name} mlp={mlp} tp={tp}"] = {
                            k: v for k, v in launches.items() if v}
            del ref_model, same, pieces
            torch.cuda.empty_cache()
    # K8 at the pieces' shapes (bf16 and f32): rows B N, C = 768, the qkv
    # pieces' 3C / tp columns and the fc1 pieces' 4C / tp, against its plain
    # version; the bf16 qkv pieces timed
    rows, c = TP_BATCH * VIT["n"], VIT["c"]
    gen = torch.Generator().manual_seed(57)
    out["k8_qkv_piece"] = {}
    for tp in (2, 4):
        for piece, m in (("qkv", 3 * c // tp), ("fc1", 4 * c // tp)):
            entry = {}
            for dtype in (torch.float32, torch.bfloat16):
                xr, lns, lnb, w, b = _ln_inputs(gen, 1, rows, c, m, dtype)
                entry[f"max_err_{str(dtype)[6:]}"] = k8_err(xr[0], lns, lnb, w, b,
                                                            f"tp={tp} {piece} piece")
            if piece == "qkv":
                entry["device_ms"] = device_ms(lambda: ld.ln_dense_fused(xr[0], lns, lnb, w, b))
                entry["bound_ms"], entry["bound_by"] = bound(
                    2 * rows * c * m, (rows * c + m * c + rows * m) * 2 + (2 * c + m) * 4,
                    "bfloat16")
            out["k8_qkv_piece"][f"tp={tp} {piece} ({m} columns)"] = entry
            del xr, w
    out["path_launches"] = path_launches
    log(f"[tp] phase 55: (1, 1) bit-equal with equal launches; pieces at tp 2 / 4 against "
        f"world 1: {out['errs']} (bounds {[TP_TOL[d] for d in TP_TOL]}); launches "
        f"{out['launches']}; K8 at the pieces {out['k8_qkv_piece']}; "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# --cards: the models split over (1, n) and (n / 2, 2) meshes, one card a
# rank. (name, model factory, dtype, image size, batch, switches, min_dim)
def _card_dinov2():
    return randomized_vit(55)


def _card_densenet():
    model, _ = create_model("densenet121", generator=torch.Generator().manual_seed(58))
    return model


def _cpu_vit():
    return randomized_vit(55, img_size=56, dim=256, depth=2, num_heads=4)


def _cpu_tiny():
    model, _ = create_model("tiny", embedding_dim=16,
                            generator=torch.Generator().manual_seed(58))
    return model


TP_CARD_MODELS = {
    "cuda": (("dinov2 bf16", _card_dinov2, torch.bfloat16, 518, TP_BATCH, {}, 256),
             ("dinov2 f32", _card_dinov2, torch.float32, 518, TP_BATCH, FUSED_VIT, 256),
             ("densenet121 f32", _card_densenet, torch.float32, 224, 64, {}, 256)),
    "cpu": (("dinov2 f32", _cpu_vit, torch.float32, 56, 8, FUSED_VIT, 256),
            ("tiny f32", _cpu_tiny, torch.float32, 64, 8, {}, 16)),
}


def card_embed(model, x):
    out = model(x)
    return l2_normalize((out["cls"] if "cls" in out else out["embedding"]).float(), dim=1)


def timed_forward(model, x, device, reps=5):
    """ms of one forward: CUDA events around ``reps`` calls (wall time on the
    CPU), after one untimed call."""
    with torch.no_grad():
        model(x)
        if device == "cpu":
            t0 = time.perf_counter()
            for _ in range(reps):
                model(x)
            return (time.perf_counter() - t0) * 1e3 / reps
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            model(x)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps


def tp_card_inputs(size, batch, seed=59):
    return torch.randn((batch, size, size, 3), generator=torch.Generator().manual_seed(seed))


def tp_ranks_main(shape, device, out_path):
    """One rank of ``--cards`` under torchrun: each model of
    TP_CARD_MODELS[device] split over a (data, model) mesh of ``shape``, the
    batch over the data axis; rank 0 saves the gathered unit embeddings and
    every rank's launches, K2 sizes, gathers and forward ms, and on the card
    a torch.profiler split of one forward's device time: NCCL's kernels by
    name and the rest."""
    import torch.distributed as dist

    from xmir_tpu_torch.parallel import make_mesh, shard_batch
    from xmir_tpu_torch.parallel import tensor_parallel as tpm

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets them in world 1
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    with make_mesh(device, shape) as mesh:
        for name, build, dtype, size, batch, flags, min_dim in TP_CARD_MODELS[device]:
            with env_flags(**flags):
                model = tpm.tensor_parallel(build().to(mesh.device, dtype).eval(), mesh,
                                            min_dim=min_dim)
                x, _ = shard_batch(tp_card_inputs(size, batch).to(mesh.device, dtype), mesh)
                tpm.GATHERS.clear()
                reset_launches()
                with vit_piece_shapes() as seen, torch.no_grad():
                    e = card_embed(model, x)
                launches = (read_launches() if device == "cuda"
                            else {k: w.launches for k, w in WRAPPERS.items()})
                mine = {"launches": launches, "k2_sizes": sorted(set(seen["K2"])),
                        "k8_calls": sorted(set(seen["K8"])), "gathers": dict(tpm.GATHERS),
                        "ms": timed_forward(model, x, device),
                        "sharded": sum(isinstance(m, tpm.ShardedLeaf) for m in model.modules())}
                if device == "cuda":
                    with torch.no_grad():
                        split = profiled_split(lambda: model(x), reps=3)
                    # NCCL's kernels (their time holds any wait for the group's
                    # other ranks); its "nccl:*" annotations repeat them
                    mine["nccl_ms"] = {k: v for k, v in split.items()
                                       if k.startswith("nccl") and ":" not in k}
                    mine["other_kernels_ms"] = sum(v for k, v in split.items()
                                                   if not k.startswith("nccl"))
                emb = mesh.all_gather(e).reshape(-1, e.shape[1])
                ranks = [None] * mesh.world
                dist.all_gather_object(ranks, mine)
                results[name] = {"emb": emb.cpu(), "ranks": ranks}
                del model
        if mesh.rank == 0:
            torch.save(results, out_path)
        mesh.barrier()


def phase_cards_tp(workdir: Path, n: int, device: str = "cuda"):
    """``--cards n``, tensor parallel: TP_CARD_MODELS[device] at meshes (1, n)
    and (n / 2, 2) under torchrun against a world of 1 in this process: unit
    embeddings within TP_TOL; on a (1, n) mesh each rank's DINOv2 runs K2 12
    times a forward on H / n heads; no qkv / proj / fc1 / fc2 weight is
    gathered whole; the forward ms of each mesh beside world 1's, and each
    rank's device time in NCCL's kernels (torch.profiler) beside the bytes
    that DINOv2's row-parallel sums move (2 a block, f32 (B / data, N, C))."""
    out = {}
    one = {}
    for name, build, dtype, size, batch, flags, _ in TP_CARD_MODELS[device]:
        with env_flags(**flags):
            model = build().to(device, dtype).eval()
            x = tp_card_inputs(size, batch).to(device, dtype)
            one[name] = (card_embed(model, x), timed_forward(model, x, device))
            del model
    for shape in ((1, n), (n // 2, 2)):
        tag = f"{shape[0]}x{shape[1]}"
        path = workdir / f"tp_{tag}.pt"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               f"--nproc_per_node={n}", str(REPO / "chip_smoke.py"), "--tp-ranks", tag,
               "--tp-device", device, "--tp-out", str(path)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=REPO)
        check(proc.returncode == 0, f"cards tp {tag}: rc {proc.returncode}\n"
                                    f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        results = torch.load(path)
        for name, dtype in ((m[0], m[2]) for m in TP_CARD_MODELS[device]):
            ref, ms1 = one[name]
            rec = results[name]
            err = (rec["emb"].to(ref.device) - ref).abs().max().item()
            tp = shape[1]
            whole = sorted({k for r in rec["ranks"] for k in r["gathers"]
                            if any(leaf in k for leaf in TP_MODEL_LEAVES)})
            check(err <= TP_TOL[dtype] and not whole and all(r["sharded"] for r in rec["ranks"]),
                  f"cards tp {tag} {name}: {err} from world 1 (bound {TP_TOL[dtype]}), "
                  f"gathered whole {whole}, sharded leaves {[r['sharded'] for r in rec['ranks']]}")
            if name.startswith("dinov2") and device == "cuda":
                heads = VIT["heads"] // tp
                rows = TP_BATCH // shape[0]
                check(all(r["launches"]["K2"] == VIT["depth"] and r["k2_sizes"] == [rows * heads]
                          for r in rec["ranks"]),
                      f"cards tp {tag} {name}: K2 per rank "
                      f"{[(r['launches']['K2'], r['k2_sizes']) for r in rec['ranks']]}, want "
                      f"{VIT['depth']} calls on {heads} heads")
            out[f"{name} {tag}"] = {
                "max_abs_err": err, "ms_world_1": ms1,
                "ms_by_rank": [r["ms"] for r in rec["ranks"]],
                "nccl_ms_by_rank": [r.get("nccl_ms") for r in rec["ranks"]],
                "other_kernels_ms_by_rank": [r.get("other_kernels_ms") for r in rec["ranks"]],
                "launches_rank0": {k: v for k, v in rec["ranks"][0]["launches"].items() if v},
                "k2_sizes": rec["ranks"][0]["k2_sizes"], "k8_calls": rec["ranks"][0]["k8_calls"],
                "gathers_rank0": rec["ranks"][0]["gathers"]}
            if name.startswith("dinov2") and device == "cuda":
                out[f"{name} {tag}"]["sum_bytes_a_forward"] = (
                    2 * VIT["depth"] * (TP_BATCH // shape[0]) * VIT["n"] * VIT["c"] * 4)
        out[f"wall_s {tag}"] = time.perf_counter() - t0
    log(f"[cards] tensor parallel ({device}) at (1, {n}) and ({n // 2}, 2) under torchrun "
        f"against a world of 1: {json.dumps(out)}")
    return out


def torchrun(n: int, module: str, args, timeout: int = 900):
    """``python -m module args`` on ``n`` ranks of one host under torchrun
    (its rendezvous on localhost); fails the phase if a rank fails. Returns
    (the ranks' standard output, seconds)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", module, *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO)
    check(proc.returncode == 0, f"torchrun {module} at {n} ranks: rc {proc.returncode}\n"
                                f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


CARD_MODELS = {"cuda": ("densenet121", "dinov2"), "cpu": ("tiny", "tiny")}


def phase_cards(workdir: Path, n: int, device: str = "cuda"):
    """``--cards n`` (not a phase of the default run): the mesh CLIs at a
    world of ``n`` ranks under torchrun, one card each (gloo on the CPU with
    ``device="cpu"``, the tiny model: a rehearsal), against the same CLIs at a
    world of 1 in this process: ingest -> query and cli.test (vectors within
    1e-5, ids equal away from near-ties), cli.compute_saliency (maps within
    1e-5, the JAX tests' bound of the fan-out: a rank embeds its masks in
    chunks of another size, and the sum over masks is reassociated) and
    cli.evaluate_saliency on the world-1 maps (AUCs within 1e-5; on maps
    made at another world, pixels of near-equal saliency swap ranks and an
    AUC moved by 7.4e-5 at 4 ranks on H100s: PERF.md section 6), cli.train
    --use-mesh --fsdp (f32; the first loss within 1e-5, the parameters within
    TRAIN_F32_MEAN_TOL of the movement)."""
    serve_model, train_model = CARD_MODELS[device]
    out = {"ranks": n, "device": device, "wall_s": {}}
    gallery = write_synthetic_covidx(str(workdir / "gallery"), n=256, size=256, seed=0)
    queries = write_synthetic_covidx(str(workdir / "queries"), n=64, size=256, seed=1)
    model_args = ["--model", serve_model, "--device", device, "--seed", "0", "-j", "4"]
    if serve_model == "tiny":
        model_args += ["--embedding-dim", "16"]

    def chain(tag, run):
        """ingest -> query -> cli.test -> compute_saliency (pair maps of the
        world-1 artifact) -> evaluate_saliency (on the world-1 maps), each by
        ``run``: the outputs differ only by the world."""
        d = workdir / tag
        d.mkdir()
        gal = str(d / "g.npz")
        ref = workdir / "w1"
        run("ingest", ["--dataset", "covid", "--dataset-dir", gallery[0],
                       "--train-image-list", gallery[1], "--split", "train", "--output", gal,
                       "--batch-size", "64"] + model_args)
        run("query", ["--dataset", "covid", "--dataset-dir", queries[0], "--test-image-list",
                      queries[1], "--index", gal, "--top-k", "10", "--output",
                      str(d / "hits.json")] + model_args)
        run("test", ["--dataset", "covid", "--dataset-dir", queries[0], "--test-image-list",
                     queries[1], "--save-dir", str(d / "res")] + model_args)
        xai = ["--dataset", "covid", "--dataset-dir", queries[0], "--test-image-list",
               queries[1], "--window-size", "24", "--stride", "5", "--top-k", "3", "--limit",
               "2"] + model_args
        run("compute_saliency", xai + ["--results", str(ref / "res" / "evaluation_results.npz"),
                                       "--save-dir", str(d / "maps")])
        run("evaluate_saliency", xai + ["--saliency-dir", str(ref / "maps"), "--step", "1000",
                                        "--output", str(d / "insdel.json")])
        return d

    def in_process(cli, args):
        t0 = time.perf_counter()
        importlib.import_module(f"xmir_tpu_torch.cli.{cli}").main(args + ["--use-mesh"])
        out["wall_s"][f"{cli} 1"] = time.perf_counter() - t0

    def ranks(cli, args):
        _, out["wall_s"][f"{cli} {n}"] = torchrun(n, f"xmir_tpu_torch.cli.{cli}",
                                                   args + ["--use-mesh"])

    one, many = chain("w1", in_process), chain(f"w{n}", ranks)
    a, b = np.load(one / "g.npz"), np.load(many / "g.npz")
    emb_err = float(np.abs(a["embeds"] - b["embeds"]).max())
    check(emb_err <= 1e-5 and np.array_equal(a["labels"], b["labels"]),
          f"cards: the gallery at {n} ranks is {emb_err} from world 1's")
    h1, hn = (json.loads((d / "hits.json").read_text()) for d in (one, many))
    sims = torch.tensor([[h["similarity"] for h in r["results"]] for r in h1], dtype=torch.float64)
    ids1 = torch.tensor([[h["id"] for h in r["results"]] for r in h1])
    idsn = torch.tensor([[h["id"] for h in r["results"]] for r in hn])
    simn = torch.tensor([[h["similarity"] for h in r["results"]] for r in hn], dtype=torch.float64)
    near = ranked_gaps(torch.cat([sims, sims[:, -1:] - 1], dim=1), sims.shape[1]) <= TIE_GAP
    check(((ids1 == idsn) | near).all() and (sims - simn).abs().max() <= 1e-5,
          f"cards: hits at {n} ranks differ from world 1's")
    e1, en = (np.load(d / "res" / "evaluation_results.npz")["embeds"] for d in (one, many))
    check(np.abs(e1 - en).max() <= 1e-5, "cards: cli.test's embeddings differ")
    maps = sorted(p.name for p in (one / "maps").iterdir())
    check(len(maps) == 6 and maps == sorted(p.name for p in (many / "maps").iterdir()),
          f"cards: SBSM maps {maps}")
    map_err = max(float(np.abs(np.load(one / "maps" / m) - np.load(many / "maps" / m)).max())
                  for m in maps)
    check(map_err <= 1e-5, f"cards: SBSM maps at {n} ranks {map_err} apart")
    i1, i_n = (json.loads((d / "insdel.json").read_text()) for d in (one, many))
    auc_err = max(abs(x - y) for r, s in zip(i1["results"], i_n["results"], strict=True)
                  for x, y in zip(r["per_pair_del"] + r["per_pair_ins"],
                                  s["per_pair_del"] + s["per_pair_ins"], strict=True))
    check(auc_err <= 1e-5 and i_n["summary"]["mesh_devices"] == n
          and i_n["summary"]["index"]["sharding"]["devices"] == n,
          f"cards: insertion / deletion at {n} ranks: {auc_err}, {i_n['summary']}")
    # training: f32 (per-rank batches change no row's arithmetic), FSDP
    data = (*write_synthetic_covidx(str(workdir / "t_train"), n=24, size=256, seed=10),
            *write_synthetic_covidx(str(workdir / "t_val"), n=16, size=256, seed=11))
    train = ["--epochs", "1", "-p", "2", "-k", "4", "--use-mesh", "--fsdp"]
    if train_model == "dinov2":
        pt = str(workdir / "dinov2_timm.pt")
        write_vit_checkpoint(pt, seed=25)
        train += ["--resume", pt]
    readings = {}
    for tag in ("1", str(n)):
        save, log_path = str(workdir / f"train{tag}"), str(workdir / f"train{tag}.jsonl")
        args = _train_args(*data, train_model, save, log_path, *train)
        args[args.index("--device") + 1] = device
        t0 = time.perf_counter()
        if tag == "1":
            train_cli.main(args)
            stdout = ""
        else:
            stdout, _ = torchrun(n, "xmir_tpu_torch.cli.train", args)
        out["wall_s"][f"train {tag}"] = time.perf_counter() - t0
        records = [json.loads(line) for line in Path(log_path).read_text().splitlines()]
        ckpt = os.path.join(save, checkpoint_name("covid", train_model, seed=0, epoch=1))
        readings[tag] = ([r["loss"] for r in records if r["kind"] == "train"],
                         load_checkpoint(ckpt), stdout)
    (l1, s1, _), (ln, sn, stdout) = readings["1"], readings[str(n)]
    start, _ = create_model(train_model, generator=torch.Generator().manual_seed(0))
    if train_model == "dinov2":
        start = load_torch_checkpoint(start, pt)
    start = start.state_dict()
    moved = torch.cat([(s1[k] - start[k]).abs().flatten() for k in s1 if s1[k].is_floating_point()])
    apart = torch.cat([(sn[k] - s1[k]).abs().flatten() for k in s1 if s1[k].is_floating_point()])
    share = (apart.mean() / moved.mean()).item()
    sharded = [line for line in stdout.splitlines() if "leaves sharded" in line]
    check(abs(l1[0] - ln[0]) <= 1e-5 and share <= TRAIN_F32_MEAN_TOL and sharded,
          f"cards: training at {n} ranks: first losses {l1[0]} / {ln[0]}, parameters {share} "
          f"of the movement apart, {sharded[:1]}")
    out["tensor_parallel"] = phase_cards_tp(workdir, n, device)
    out.update(embedding_max_abs_err=emb_err, map_max_abs_err=map_err, auc_err=auc_err,
               first_loss_diff=abs(l1[0] - ln[0]),
               mean_apart_of_moved=share, fsdp=sharded[0].strip())
    log(f"[cards] {n} ranks under torchrun ({device}): ingest -> query, cli.test and "
        f"cli.evaluate_saliency --use-mesh against a world of 1: vectors within {emb_err:.3g}, "
        f"ids equal away from near-ties, SBSM maps within {map_err:.3g}, AUCs "
        f"within {auc_err:.3g}; cli.train {train_model} "
        f"--use-mesh --fsdp (f32, {len(ln)} steps): first loss {abs(l1[0] - ln[0]):.3g} apart, "
        f"parameters {share:.3g} of the movement apart; {sharded[0].strip()}; wall "
        f"{ {k: round(v, 1) for k, v in out['wall_s'].items()} }")
    return out


# ------------------------------------------------------------------ export
# phase 56: cli.export on trained checkpoints of phases 18, 26 and 29. Per
# model: the f32 switches that route the full-width forward to its kernels,
# the xmir:: ops (and the counters they move) one forward calls, the input
# size, the bound of the kernels' plain path (the slices' own), and whether
# the program's batch is dynamic (run at two sizes).
EXPORT_CELLS = {
    "dinov2": dict(flags=dict(XMIR_FLASH_ATTN="1", XMIR_FUSED_LN="1", XMIR_FUSED_LN_QKV=None,
                              XMIR_FUSED_LN_MLP=None),
                   ops={"ln_qkv": VIT["depth"], "vit_attention": VIT["depth"]},
                   launches={"K7": VIT["depth"], "K2": VIT["depth"]}, size=518,
                   plain=vit_plain_versions, plain_tol=VIT_EMBED_TOL["plain versions"],
                   dynamic=True),
    "convnextv2": dict(flags=dict(XMIR_FUSED_MLP="1"), ops={"convnext_tail": DEPTH},
                       launches={"K9": DEPTH}, size=384, plain=convnext_plain_versions,
                       plain_tol=CONVNEXT_EMBED_TOL, dynamic=False),
    "swinv2": dict(flags=dict(XMIR_FUSED_ATTN="1", XMIR_SWIN_KERNEL=None),
                   ops={"biased_attention": SWIN_DEPTH}, launches={"K4": SWIN_DEPTH}, size=384,
                   plain=swin_plain_versions, plain_tol=SWIN_EMBED_TOL["plain versions"],
                   dynamic=False),
}
# the loaded program's f32 unit embeddings against the eager module's on the
# same kernels: the same launches in the same order, so 0 is expected; 1e-6
# bounds an op that a trace had reordered or decomposed
EXPORT_EAGER_TOL = 1e-6
EXPORT_BATCHES = (2, 3)  # a dynamic program runs at both, a static one at the first


def export_model(name, args):
    """The CLIs' model for ``args`` (``common.build_model``: its seeded draw,
    then --resume), in eval mode on the card."""
    p = argparse.ArgumentParser()
    common.add_dataset_args(p)
    common.add_model_args(p)
    return common.build_model(p.parse_known_args(["--model", name, *args])[0],
                              torch.device("cuda"))


def phase_export(workdir: Path, name: str, ckpt: str, queries):
    """Phase 56 for one model: (a) ``cli.export --format torch`` of ``ckpt``
    (a checkpoint of cli.train, or a timm-layout .pt), read back through
    --resume into a model of other weights: its f32 unit embeddings of the
    query images ``queries`` (dir, manifest) bit-equal to the checkpoint's
    model; (b) ``cli.export --format exported`` of it at full width on the
    card under EXPORT_CELLS' switches: the graph names the ops at their
    counts, tracing launches nothing, the loaded program launches the
    kernels by the same counts, its embeddings lie within EXPORT_EAGER_TOL of
    the eager model's on the kernels and within the slice's bound of the
    plain path; a dynamic program runs at two batch sizes."""
    from xmir_tpu_torch.cli import export as export_cli
    from xmir_tpu_torch.models.export import xmir_op_counts

    t0 = time.perf_counter()
    cell = EXPORT_CELLS[name]
    out = {"model": name}
    q_args = ["--dataset", "covid", "--dataset-dir", queries[0], "--test-image-list",
              queries[1]]
    exported = str(workdir / f"{name}_export.pt")
    with registry_models_drawn_once():
        export_cli.main(["--model", name, "--resume", ckpt, "--format", "torch",
                         "--output", exported, "--device", "cuda"])
        model, spec = export_model(name, ["--resume", ckpt, *q_args])
        # torch's default init (other weights than the checkpoint's, and no
        # seeded draw on the host), then the --resume path
        fresh = load_torch_checkpoint(create_model(name)[0], exported)
        fresh = fresh.to(device="cuda", memory_format=torch.channels_last).eval()
        p = argparse.ArgumentParser()
        common.add_dataset_args(p)
        args = p.parse_known_args(q_args)[0]
        embeds = [embed_dataset(common.build_dataset(args, "test"), make_embed_fn(m), spec,
                                device="cuda", batch_size=8, num_workers=8)[0]
                  for m in (model, fresh)]
        n_tensors = len(torch.load(exported, mmap=True))
        check(torch.equal(*embeds), f"export {name}: the reloaded export's embeddings differ from "
                                    f"the trained model's by "
                                    f"{(embeds[0] - embeds[1]).abs().max().item()}")
        log(f"[export] {name} --format torch: {n_tensors} tensors; reloaded through --resume into "
            f"a model of other weights, the {embeds[0].shape[0]} query embeddings (f32) equal the "
            "trained model's bit for bit")
        out["reload_bit_equal"], out["torch_tensors"] = True, n_tensors
        out["torch_seconds"] = time.perf_counter() - t0
        program = str(workdir / f"{name}.pt2")
        with env_flags(**cell["flags"]):
            reset_launches()
            export_cli.main(["--model", name, "--resume", ckpt, "--format", "exported",
                             "--batch", "0" if cell["dynamic"] else str(EXPORT_BATCHES[0]),
                             "--output", program, "--device", "cuda"])
            traced = read_launches()
            check(not any(traced.values()), f"export {name}: tracing launched {traced}")
            ep = torch.export.load(program)
            ops = xmir_op_counts(ep)
            check(ops == cell["ops"], f"export {name}: the program's ops {ops}, expected "
                                      f"{cell['ops']}")
            loaded = ep.module()
            gen = torch.Generator(device="cuda").manual_seed(56)
            runs = []
            for b in EXPORT_BATCHES[:2 if cell["dynamic"] else 1]:
                x = torch.randn((b, cell["size"], cell["size"], 3), generator=gen, device="cuda")
                with torch.no_grad():
                    reset_launches()
                    got = loaded(x)
                    launches = read_launches()
                    want = dict.fromkeys(WRAPPERS, 0)
                    want.update(cell["launches"])
                    check(launches == want, f"export {name} at B={b}: the loaded program "
                                            f"launched {launches}, expected {want}")
                    eager = model(x)["embedding"]
                    with cell["plain"]():
                        reset_launches()
                        plain = model(x)["embedding"]
                        check(not any(read_launches().values()),
                              "the plain versions launched a kernel")
                errs = {"eager": (got - eager).abs().max().item(),
                        "plain": (got - plain).abs().max().item()}
                check(got.shape == (b, spec.embed_dim) and torch.isfinite(got).all(),
                      f"export {name}: embeddings {tuple(got.shape)}")
                check(errs["eager"] <= EXPORT_EAGER_TOL and errs["plain"] <= cell["plain_tol"],
                      f"export {name} at B={b}: {errs} against the bounds {EXPORT_EAGER_TOL} "
                      f"(eager, the kernels) and {cell['plain_tol']} (the plain path)")
                runs.append({"batch": b, "launches": {k: v for k, v in launches.items() if v},
                             "max_abs_err_vs_eager": errs["eager"],
                             "max_abs_err_vs_plain": errs["plain"]})
    out["exported_seconds"] = time.perf_counter() - t0 - out["torch_seconds"]
    log(f"[export] {name} --format exported ({'dynamic' if cell['dynamic'] else 'static'} "
        f"batch, {cell['size']} px, f32 under {cell['flags']}): the graph calls {ops}; tracing "
        f"launched nothing; the loaded program {runs} (bounds {EXPORT_EAGER_TOL} against the "
        f"eager kernels, {cell['plain_tol']} against the plain path)")
    out.update(ops=ops, runs=runs, launches=sum_launches(r["launches"] for r in runs),
               seconds=time.perf_counter() - t0)
    log(f"[export] {name}: {out['seconds']:.1f} s")
    return out


def sum_launches(readings):
    """{kernel: launches} summed over readings, every wrapper's key present."""
    total = dict.fromkeys(WRAPPERS, 0)
    for r in readings:
        for k, v in r.items():
            total[k] += v
    return total


def phase_export_only(workdir: Path):
    """Phase 56 alone (``--export-only``), on timm-layout .pt files of random
    nonzero weights (the phases' training does not run) and 8 query PNGs."""
    queries = write_synthetic_covidx(str(workdir / "x_queries"), n=8, size=256, seed=56)
    pts = {"dinov2": write_vit_checkpoint, "convnextv2": write_timm_checkpoint,
           "swinv2": write_swin_checkpoint}
    out = {}
    for name, write in pts.items():
        pt = str(workdir / f"{name}_timm.pt")
        write(pt, seed=57)
        out[name] = phase_export(workdir, name, pt, queries)
    return out


# each phase's seconds: a phase logs its own; one that no other phase called
# adds them to PHASE_SECONDS, which with the time before the first phase
# makes up the run (the default run has 1,200 s)
PHASE_SECONDS = {}
_PHASE_DEPTH = [0]


def timed_phase(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        _PHASE_DEPTH[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _PHASE_DEPTH[0] -= 1
            dt = time.perf_counter() - t0
            if _PHASE_DEPTH[0] == 0:
                PHASE_SECONDS[fn.__name__] = PHASE_SECONDS.get(fn.__name__, 0.0) + dt
            log(f"[time] {fn.__name__}: {dt:.1f} s")
    return run


for _name, _fn in list(globals().items()):
    if _name.startswith(("phase_", "phases_")) and callable(_fn):
        globals()[_name] = timed_phase(_fn)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile-swin", action="store_true",
                        help="only build, then print where a bf16 SwinV2-Base batch's time goes")
    parser.add_argument("--train-only", action="store_true",
                        help="only build, then the training phases (17 to 23, 25 to 28, 31 to "
                             "33, 38 to 40); prints no result")
    parser.add_argument("--siglip-only", action="store_true",
                        help="only build, then the SigLIP family's training and XAI phases "
                             "(38 to 41); prints no result")
    parser.add_argument("--resnet-ath-only", action="store_true",
                        help="only build, then the ResNet50, ATH and analysis phases (42 to "
                             "46); prints no result")
    parser.add_argument("--chestmir-only", action="store_true",
                        help="only build, then the ChestMIR phases (47 to 49); prints no "
                             "result")
    parser.add_argument("--mesh-only", action="store_true",
                        help="only build, then phases 4, 18, 19 and 24 with the mesh phases "
                             "they hold (50, 52, 53), 51 and 54; prints no result")
    parser.add_argument("--cards", type=int, default=0, metavar="N",
                        help="only build, then the mesh CLIs at N ranks under torchrun, one "
                             "card each, against a world of 1; prints no result")
    parser.add_argument("--cards-on-cpu", type=int, default=0, metavar="N",
                        help="the same on the CPU (gloo, the tiny model): a rehearsal that "
                             "needs no card")
    parser.add_argument("--tp-only", action="store_true",
                        help="only build, then phase 55 (tensor parallel); with --cards or "
                             "--cards-on-cpu, their tensor-parallel meshes alone; prints no "
                             "result")
    parser.add_argument("--export-only", action="store_true",
                        help="only build, then phase 56 (cli.export, both formats) on "
                             "timm-layout .pt files of random weights; prints no result")
    parser.add_argument("--f32-window-only", action="store_true",
                        help="only build, then K4's and K6's kernel and rate phases (12, 16), "
                             "the f32 SwinV2-Base forward at B = 16 and its f32 train step at B "
                             "= 8 with the kernels, their plain versions and the eager path; "
                             "prints no result")
    parser.add_argument("--f32-bwd-only", action="store_true",
                        help="only build, then K3's and K5's kernel and rate phases (17, 20, 25, "
                             "27, 38) and the f32 train steps that reach their f32 routes, with "
                             "the kernels and with their plain versions; prints no result")
    parser.add_argument("--tp-ranks", metavar="DxM", help=argparse.SUPPRESS)
    parser.add_argument("--tp-device", default="cuda", help=argparse.SUPPRESS)
    parser.add_argument("--tp-out", help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.tp_ranks:  # one rank of phase_cards_tp, under torchrun
        tp_ranks_main(tuple(int(v) for v in opts.tp_ranks.split("x")), opts.tp_device,
                      opts.tp_out)
        return
    cards = phase_cards_tp if opts.tp_only else phase_cards
    if opts.cards_on_cpu:
        with tempfile.TemporaryDirectory() as tmp:
            cards(Path(tmp), opts.cards_on_cpu, "cpu")
        return
    smi = phase_device()
    phase_build()
    with registry_draws_cached():
        return run_phases(opts, smi)


def run_phases(opts, smi):
    """The phases ``opts`` asks for, after the device and the build."""
    cards = phase_cards_tp if opts.tp_only else phase_cards
    if opts.cards:
        with tempfile.TemporaryDirectory() as tmp:
            cards(Path(tmp), opts.cards)
        print(smi)
        return
    if opts.mesh_only:
        phases_mesh()
        print(smi)
        return
    if opts.tp_only:
        phase_tensor_parallel()
        print(smi)
        return
    if opts.export_only:
        with tempfile.TemporaryDirectory() as tmp:
            phase_export_only(Path(tmp))
        print(smi)
        return
    if opts.resnet_ath_only:
        phases_resnet_ath()
        print(smi)
        return
    if opts.chestmir_only:
        phases_chestmir()
        print(smi)
        return
    if opts.profile_swin:
        profile_swin()
        print(smi)
        return
    if opts.siglip_only:
        phases_siglip_train()
        print(smi)
        return
    if opts.f32_window_only:
        phase_kernel_window()
        phase_window_rates()
        phase_swin_f32_rates()
        f32_swin_train_step({})
        print(smi)
        return
    if opts.f32_bwd_only:
        for phase in (phase_kernel_bwd, phase_bwd_rates, phase_kernel_siglip_bwd,
                      phase_kernel_window_bwd, phase_window_bwd_rates, phase_f32_train_steps):
            phase()
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
        phase_kernel_siglip_bwd()
        with tempfile.TemporaryDirectory() as tmp:
            phase_train_medsiglip(Path(tmp))
        with tempfile.TemporaryDirectory() as tmp:
            phase_train_conceptclip(Path(tmp))
        print(smi)
        return
    max_err = phase_kernel()
    with tempfile.TemporaryDirectory() as tmp:
        d_launches, slice_err, mesh_a = phase_slice(Path(tmp))
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
    swin_f32_emb = phase_swin_f32_embeddings()
    swin_rates = phase_swin_model_rates()
    bwd_errs = phase_kernel_bwd()
    exports = {}
    with tempfile.TemporaryDirectory() as tmp:
        t_slice = phase_train_dinov2(Path(tmp))
        exports["dinov2"] = phase_export(Path(tmp), "dinov2", t_slice["ckpt"], t_slice["queries"])
    with tempfile.TemporaryDirectory() as tmp:
        dt_launches, mesh_cache = phase_train_densenet(Path(tmp))
    bwd_rates = phase_bwd_rates()
    train_rates = phase_train_rates()
    tail_bwd_errs = phase_kernel_tail_bwd()
    with tempfile.TemporaryDirectory() as tmp:
        ct_slice = phase_train_convnext(Path(tmp))
        exports["convnextv2"] = phase_export(Path(tmp), "convnextv2", ct_slice["ckpt"],
                                             ct_slice["queries"])
    tail_bwd_rates = phase_tail_bwd_rates()
    convnext_train_rates = phase_convnext_train_rates()
    with tempfile.TemporaryDirectory() as tmp:
        sal = phase_saliency(Path(tmp))
    k5_errs = phase_kernel_window_bwd()
    with tempfile.TemporaryDirectory() as tmp:
        sw_slice = phase_train_swinv2(Path(tmp))
        exports["swinv2"] = phase_export(Path(tmp), "swinv2", sw_slice["ckpt"],
                                         sw_slice["queries"])
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
        with registry_models_drawn_once():
            c_slices, siglip_pt, queries = phase_slice_clip(Path(tmp))
        with registry_models_drawn_once():
            zs = phase_clip_zeroshot(Path(tmp), siglip_pt, queries)
    clip_rates = phase_clip_rates()
    siglip_bwd, ms_train, cc_train, sx = phases_siglip_train()
    k1_depths, resnet, ath, analysis, ra_rates = phases_resnet_ath()
    chest = phases_chestmir()
    shards = phase_shards()
    with tempfile.TemporaryDirectory() as tmp:
        host = phase_host(Path(tmp))
    tp = phase_tensor_parallel()
    by_path = {key: {"densenet121": d_launches[key], "convnextv2": c_launches[key],
                     "densenet121_mesh": mesh_a["launches"][key],
                     "densenet121_saliency_mesh": sal["mesh"]["launches"][key],
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
                     **{path: v[key] for path, v in zs["launches"].items()},
                     **{path: v[key] for path, v in ms_train["launches"].items()},
                     **{path: v[key] for path, v in cc_train["launches"].items()},
                     **{path: v[key] for path, v in sx["launches"].items()},
                     **{path: v[key] for path, v in resnet["launches"].items()},
                     **{path: v[key] for path, v in ath["launches"].items()},
                     **{path: v[key] for path, v in analysis["launches"].items()},
                     "chestmir_ingest": chest["ingest"]["launches"][key],
                     "dinov2_tensor_parallel": tp["path_launches"][key],
                     **{f"export_{path}": v["launches"][key] for path, v in exports.items()}}
               for key in WRAPPERS}
    slice_errs = [slice_err, c_slice_err, nih["hits_err"], distill["hits_err"], resnet["err"],
                  analysis["err"]] + [
        v["err"] for v in v_slices.values()] + [v["err"] for v in s_slices.values()] + [
        v["err"] for v in c_slices.values()]
    f32 = serving["float32 Q=1024 k=10"]
    k1 = dict(KERNELS["K1"], launches=sum(by_path["K1"].values()),
              max_abs_err=max(max_err, *(v["max_abs_err"] for v in serving.values()),
                              *(v.get("max_abs_err", 0.0) for v in k1_depths.values()),
                              *slice_errs),
              ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
              bound_by=f32["bound_by"], library_ms=None,
              library="none: torch.mm + torch.topk are two calls (yardstick_device_ms)",
              device_ms=f32["device_ms"], by_shape=serving, by_depth=k1_depths,
              shape="Q=1024 N=100000 D=1024 k=10, f32", launches_by_path=by_path["K1"],
              sharded={key: v for key, v in shards.items() if key.endswith("k=10")})
    big = select_rates["float32 Q=1024 k=2048"]
    k1s = dict(KERNELS["K1'"], launches=sum(by_path["K1'"].values()),
               max_abs_err=max(select_err, r_err, *(v["max_abs_err"] for v in
                                                    select_rates.values())),
               ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
               bound_by=big["bound_by"], library_ms=None,
               library="none: torch.mm + torch.topk / torch.sort are two calls",
               device_ms=big["device_ms"], by_shape=select_rates,
               shape="Q=1024 N=100000 D=1024 k=2048, f32", launches_by_path=by_path["K1'"],
               sharded={key: v for key, v in shards.items() if key.endswith("k=100")})
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
        f32={key: bwd_rates["float32 B=16"][key] for key in
             ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
              "bound_by", "fma_bound_ms", "arithmetic")},
        by_shape=bwd_rates, siglip_hd72=siglip_bwd["rates"], siglip_hd72_err=siglip_bwd["err"],
        launches_by_path=by_path["K3"]))
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
            f32={field: window_rates[key]["float32"][field] for field in
                 ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                  "bound_by", "fma_bound_ms", "arithmetic")},
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
                 ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms", "bound_ms",
                  "bound_by", "fma_bound_ms")},
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
    by_name["ln_dense_fused"]["tp_qkv_piece"] = tp["k8_qkv_piece"]
    by_name["convnext_mlp_grn_fused"]["main_path"] = (
        "none: the JAX package reaches it only from its tests")
    for key, op in EXPORT_OPS.items():
        by_name[KERNELS[key]["name"]]["op"] = op
    log(f"[time] total {time.perf_counter() - _START:.1f} s; by phase (s) "
        f"{ {k: round(v, 1) for k, v in PHASE_SECONDS.items()} }")
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
                          **{path: v["embedding_max_abs_err"] for path, v in s_slices.items()
                             if "embedding_max_abs_err" in v},
                          "swinv2_f32_b16_randomized": swin_f32_emb},
                      "clip_embedding_max_abs_err": {
                          path: v["embedding_max_abs_err"] for path, v in c_slices.items()},
                      "clip_zeroshot": {k: v for k, v in zs.items() if k != "launches"},
                      "ptxas_c75xx": clip_errs["ptxas C75xx"],
                      "medsiglip_embed": clip_rates["medsiglip_embed"],
                      "biomedclip_embed": clip_rates["biomedclip_embed"],
                      "ptxas_c75xx_vit_attn_bwd": siglip_bwd["ptxas_vit_attn_bwd"],
                      "medsiglip_train": {k: v for k, v in ms_train.items() if k != "launches"},
                      "conceptclip_train": {k: cc_train[k] for k in ("losses", "first_rc_rel",
                                                                     "step")},
                      "siglip_xai": {k: v for k, v in sx.items() if k != "launches"},
                      "resnet50_eval_metrics": resnet["metrics"],
                      "resnet50_embed": {k: v for k, v in ra_rates.items()
                                         if k != "ath_train_step"},
                      "ath_train_step": ra_rates["ath_train_step"],
                      "ath": {k: v for k, v in ath.items() if k != "launches"},
                      "analysis": {k: v for k, v in analysis.items()
                                   if k not in ("launches", "err")},
                      "mesh": {"slice": mesh_a, "shards": shards,
                               "train_dinov2": t_slice["mesh"], "train_cache": mesh_cache,
                               "saliency": {k: v for k, v in sal["mesh"].items()
                                            if k != "launches"}, "host": host},
                      "tensor_parallel": {k: v for k, v in tp.items()
                                          if k != "path_launches"},
                      "export": {path: {k: v for k, v in e.items() if k != "launches"}
                                 for path, e in exports.items()},
                      "phase_seconds": PHASE_SECONDS,
                      "chestmir": {"detector": chest["detector"],
                                   "ingest": {k: v for k, v in chest["ingest"].items()
                                              if k != "launches"},
                                   "eval": chest["eval"]}}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
