// Biased window attention for the Swin towers on Hopper (sm_90a), forward
// only: out = softmax(q k^T + bias_g) v per (image, window, head), q / k / v
// (BH, N, hd), bias (G, N, N) f32 shared by the rows of a group.
//
// Replaces two TPU kernels:
//   K4  xmir_tpu/ops/vit_attn_pallas.py::_biased_fwd_pallas (body
//       _kernel_biased): SwinV2's cosine attention. q and k rows are
//       L2-normalised in f32 here, q is multiplied by scale_g log2(e) and
//       rounded to the input dtype, k is rounded to the input dtype; f32
//       scores plus bias log2(e); e = exp2(s - row max); the value product
//       takes e rounded to v's dtype, the row sum z the unrounded e; one
//       division (e . v) / z in f32, one rounding. Without `cosine` q is
//       multiplied by scale_g log2(e) rounded to the input dtype.
//   K6  xmir_tpu/ops/window_attn_pallas.py::window_attention_fused (body
//       _kernel): the v1 kernel. q arrives normalised and scaled, k
//       normalised; natural exp; p = e / z is normalised BEFORE it is rounded
//       to v's dtype for the value product, and the product is rounded once.
//
// The bf16 route keeps a window's K (normalised on the way in) and V in
// shared memory and passes every query row over them twice: pass 1 finds
// each row's exact max (and, for K6, its sum z); pass 2 recomputes the scores
// and forms e, z and the value product. With the exact max the arithmetic is
// the TPU kernels' own, up to the order of the f32 sums. The f32 route takes
// one pass (below). The (N, N) scores never reach device memory. Ragged N is
// masked with -inf and predicated.
//
// K4 in bf16 (modes 0 and 1: every SwinV2 block, serving and training) and
// K6 in bf16 (mode 2: the serving path under XMIR_SWIN_KERNEL=v1) share one
// body, wattn_bf16_wg. What bounds K4 on this card: at hd = 32 a score costs 128
// FLOP on the tensor cores, one exp2 and, in each pass, 4 bytes of f32 bias,
// which is the largest stream: 2 x N^2 x 4 B = 2.65 MB per window at N = 576
// from L2, against 147 KB of q, k, v and out. The design: a block owns two
// images of one bias group (consecutive rows of one run of g_size folded
// rows; one where two windows' K and V do not fit, as at hd = 64 and N =
// 576), one consumer warpgroup each with that image's K and V resident in
// the swizzled panel layout of wgmma.cuh (144 KB for two at N = 576, hd =
// 32), and a producer warp that streams the group's 64 x 64 bias tiles once
// for both images through a ring of three 16 KB stages: two TMA boxes a tile
// (128-byte swizzled, zeros outside the slice), full and empty mbarriers; so
// each tile leaves L2 once per pair of images and is read from shared memory
// where the copy has already landed. Where N is not a multiple of 4 the
// bias rows are not 16-byte aligned for the copy engine and the producer's
// lanes copy 4 bytes at a time into the same layout. Both products are
// wgmma: q k^T (m64n64k16, the normalised, scaled, rounded q as A from
// registers, K from shared memory) and e v (e rounded to bf16 as A from
// registers, V MN-major from shared memory). A group with an odd number of
// images leaves one warpgroup idle on its last block. Registers (-Xptxas -v,
// sm_90a): 107 / 120 (hd 32, modes 0 / 1), 152 / 156 (hd 64), 94 / 95 (hd
// 16), no spills; shared memory 203 KB at N = 576, hd = 32. What bounds it
// now: the per-tile work of the two warpgroups (bias adds and masks, the
// exponentials, the products' latency); the copies are off its path
// (PERF.md).
//
// K6 keeps its v1 arithmetic exactly in the same body: natural exp; pass 1
// sums z along the running max of each row's four lanes (one exp a score and
// a rescale a tile, each lane's share summed, then the four shares); pass 2
// forms p = e / z (v1_weight_rcp: the correctly rounded quotient without a
// division), rounds p to bf16 for the value product and rounds the product
// once. Its rows lie in (window, image, head) order, so a block
// takes two images of one (window, head) slice, H rows apart (row_of_block,
// run_length). One exp a score in each pass: the exponentials bound it
// sooner than K4's exp2 (PERF.md).
//
// f32 K4 and K6 (every SwinV2 block of an f32 model under XMIR_FUSED_ATTN=1)
// share a second body, wattn_f32_wg. What bounds it on this card: the two
// products, 4 BH N^2 hd operations, which the CUDA cores' f32 FMAs (67
// TFLOP/s) take 4.9 ms for over one Swin-B forward at B = 16 against 2.0 ms
// as three TF32 products each on the tensor cores (3 x 495 TFLOP/s); the
// bytes (q, k, v and out once) take 0.7 ms. So both products are 3xTF32 on
// wgmma .tf32 (attn_bwd_f32.cuh: x = big + small, big . big + big . small +
// small . big, kScoreTerms and kValueTerms below). An f32 tile and its small
// part are four times a bf16 tile, so one window's K and V with their small
// parts (295 KB at N = 576, hd = 32) do not stay resident: a prep pass
// (wattn_prep_f32) writes, once a call, k (normalised for the cosine) and V^T
// with their small parts into the wrapper's workspace, and the main kernel
// streams them in 64-key tiles through a ring by the copy engine, each stage
// holding the bias tile that both images share and each image's K, K small,
// V^T, V^T small. The grid is persistent: a block per SM walks items of
// (pair of images of one bias slice, 64-row query tile) in row_of_block's
// order, a consumer warpgroup an image, a producer warp the ring, as in the
// bf16 route (one image a block at hd 64, where two do not fit beside a
// two-stage ring). One pass: s = q k^T (A, the normalised, scaled query
// fragments, split in registers; B, the K tile, K-major); bias, mask; a
// running max m rescales the f32 accumulator and z by exp2(m_old - m_new)
// (K6: exp); e = exp2(s - m) split in registers into the value product's A
// (its accumulator columns 2t, 2t + 1 of each group of 8 are the fragment's
// t and t + 4: the prep writes V^T's keys in that order, slot_query), each
// tile's e v in an accumulator of its own added to the rescaled sum in f32
// (the tensor cores' own sums truncate); out = (e . v) / z. In f32 nothing
// is rounded to a narrower type, so the exact-max pass of the bf16 route buys
// nothing here, and K6's p = e / z normalised before its value product
// differs from (e . v) / z only by roundings. What bounds it now: the
// consumers' per-tile work around the products (bias, exponentials, the
// split, the running max), about a quarter of the time at the 3xTF32 bound
// (PERF.md).
//
// hd is a multiple of 8 up to 64, zero-padded in shared memory to 16, 32 or
// 64. Launches go on the caller's stream and allocate nothing: the f32 route
// takes the wrapper's workspace (xmir_window_attn_workspace).

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_bwd_f32.cuh"
#include "attn_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBK = 64;         // keys per tile of a pass
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

enum : int { kScaled = 0, kCosine = 1, kV1 = 2 };

// Row i of the (BH, N, hd) batch uses bias slice
// (i / d1) % m1 * s1 + (i / d2) % m2 * s2.
// K4: (i / g_size) % G. K6 on (NW, B, H): window * H + head, or head alone.
struct Groups {
  int d1, m1, s1, d2, m2, s2;
};

__device__ __forceinline__ int group_of(const Groups& g, int i) {
  return (i / g.d1) % g.m1 * g.s1 + (i / g.d2) % g.m2 * g.s2;
}

// The row a block owns. K4's fold puts the rows of one bias slice side by
// side, so blocks take rows in order. K6's layout (window, image, head) does
// not: there block j takes the j-th row in (window, head, image) order, so
// that the blocks of one slice still run together and the slice stays in L2.
template <int MODE>
__device__ __forceinline__ int row_of_block(const Groups& g, int j) {
  if (MODE != kV1) return j;
  const int per_window = g.d1, heads = g.m2, images = per_window / heads;
  const int w = j / per_window, r = j - w * per_window;
  return w * per_window + (r % images) * heads + r / images;
}

// Rows of one bias slice that follow each other in row_of_block's order: K4
// the d1 folded rows of a group; K6 the B images of a (window, head).
template <int MODE>
__host__ __device__ __forceinline__ int run_length(const Groups& g) {
  return MODE == kV1 ? g.d1 / g.m2 : g.d1;
}

// 1 / max(||x||, 1e-12), as the TPU kernel clamps it
__device__ __forceinline__ float inv_norm(float sum_sq) {
  return 1.f / sqrtf(fmaxf(sum_sq, 1e-24f));
}

// Row row0 + r, columns vc .. vc + 7 of an (n, hd) bf16 matrix as one 16-byte
// vector, zeros for a dead row or the head's padding. With `normalise` the
// row is divided by its norm in f32, with `scale` then multiplied by c, and
// rounded to bf16 once. The DP / 8 lanes that hold one row's vectors are
// neighbours (the norm is a shuffle over them), and every lane of the warp
// takes part.
template <int DP>
__device__ __forceinline__ uint4 load_bf16(const __nv_bfloat16* src, int row0, int r, int vc,
                                           int n, int hd, bool normalise, bool scale, float c) {
  constexpr int VPR = DP / 8;
  uint4 raw = make_uint4(0, 0, 0, 0);
  if (row0 + r < n && vc < hd) {
    raw = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * hd + vc));
  }
  if (normalise || scale) {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
    float f[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
    if (normalise) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = fmaf(f[i], f[i], ss);
#pragma unroll
      for (int off = 1; off < VPR; off <<= 1) ss += __shfl_xor_sync(kFull, ss, off);
      const float rn = inv_norm(ss);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(f[i], rn);
    }
    if (scale) {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = __fmul_rn(f[i], c);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  return raw;
}

// Rows [row0, row0 + rows) of an (n, hd) bf16 matrix into shared memory at
// stride DP + 8 (load_bf16 per vector). rows * DP / 8 is a multiple of 32, so
// whole warps take each step.
template <int DP>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int rows, int n, int hd, bool normalise,
                                           bool scale, float c, int tid, int n_threads) {
  constexpr int S = DP + 8, VPR = DP / 8;
  for (int idx = tid; idx < rows * VPR; idx += n_threads) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * S + vc) =
        load_bf16<DP>(src, row0, r, vc, n, hd, normalise, scale, c);
  }
}

// K6's weight exp(d) / z in the bf16 body, for d = score - row max <= 0 and
// z >= 1, without a division a score: zr is the correctly rounded 1 / z of
// the row; e 2^64 times zr and one FMA correction (Markstein's) give the
// correctly rounded quotient, scaled back by 2^-64 (powers of two: exact).
// It equals IEEE e / z wherever that is at least 2^-126 (normal). Below that
// it is taken as 0: it rounds to 0 in bf16 and adds nothing to an f32 sum of
// weights of order 1 (with e scaled, no step of the correction meets a
// denormal).
__device__ __forceinline__ float v1_weight_rcp(float d, float z, float zr) {
  const float e = __fmul_rn(expf(d), 0x1p64f);
  const float q = __fmul_rn(e, zr);
  const float p = __fmul_rn(fmaf(fmaf(-q, z, e), zr, q), 0x1p-64f);
  return p < 0x1p-126f ? 0.f : p;
}

// score + bias: K4 works in exp2 space, so its bias is scaled by log2(e)
// first (one rounding, as the TPU wrapper scales the table); never an FMA.
template <int MODE>
__device__ __forceinline__ float add_bias(float s, float b) {
  return __fadd_rn(s, MODE == kV1 ? b : __fmul_rn(b, kLog2e));
}

// The factor q is multiplied by: scale_g log2(e) in f32; without the cosine
// normalisation rounded to the input dtype (the product is taken there).
template <int MODE>
__device__ __forceinline__ float q_factor(const float* scale, int g, bool bf16) {
  if (MODE == kV1) return 1.f;
  const float c = __fmul_rn(scale[g], kLog2e);
  return (MODE == kScaled && bf16) ? __bfloat162float(__float2bfloat16(c)) : c;
}

// ---------------------------------------------------------------------------
// bf16, K4 (modes kScaled and kCosine) and K6 (kV1): one block owns `images`
// (2, or 1 where two windows' K and V do not fit) consecutive rows of one run
// of rows that share one bias slice: K4's d1 folded rows; K6's B images of a
// (window, head) slice (or of a head, where the windows share it), taken in
// row_of_block's (window, head, image) order, so that a block's two rows lie H
// apart. Warpgroup w (warps 4 w .. 4 w + 3) owns image w: its K (normalised
// for the cosine) and V stay in shared memory in the panel layout of
// wgmma.cuh, and it walks the window's 64-row query tiles, each warp staging
// its 16 query rows (K4: normalised, scaled, rounded) for ldmatrix. Warp 8,
// the producer, streams the slice's 64 x 64 f32 bias tiles in the order both
// warpgroups take them (per query tile: pass 1's key tiles, then pass 2's)
// through a ring of `stages` tiles, each tile's landing reported to a full
// mbarrier and its release by the consumers' warps to an empty one. Pass 1:
// s = q k^T by wgmma (A, the query fragments, from registers; B, K, from
// shared memory), bias added, the exact row max; K6 also z along the running
// max of the row's four lanes (expf). Pass
// 2: s again; K4 e = exp2(s - max), z += e; K6 p = e / z (v1_weight_rcp); the
// value product by wgmma with e (p) rounded to bf16 as A from registers and V
// as B; K4 divides by z, K6 rounds the product as it is.
constexpr int kConsumerWarps = 8;                           // two warpgroups
constexpr int kWgThreads = (kConsumerWarps + 1) * 32;       // and the producer warp
constexpr int kBiasTileBytes = kBK * kBK * 4;               // one 64 x 64 f32 tile

// Byte offset of bias element (r, c) in a ring stage: two 64 x 32 halves, each
// row 128 bytes with its 16-byte chunks swizzled by r % 8, as the copy engine
// writes them; float2 reads in the accumulator layout then meet at most two
// to a bank.
__device__ __forceinline__ int bias_offset(int r, int c) {
  return (c >> 5) * (kBK * 128) + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

struct WgLayout {  // byte offsets in the block's 1024-aligned shared memory
  int kv_bytes;    // one image's K (or V), [n_pad][DP] in the panel layout
  int q;           // per consumer warp: 16 query rows at stride DP + 8
  int ring;        // `stages` bias tiles
  int bars;        // full[stages], then empty[stages]
  int total;       // with 1024 bytes to align the start
};

__host__ __device__ inline WgLayout wg_layout(int dp, int n_pad, int images, int stages) {
  WgLayout l;
  l.kv_bytes = n_pad * dp * 2;
  l.q = images * 2 * l.kv_bytes;
  l.ring = (l.q + images * 4 * 16 * (dp + 8) * 2 + 1023) / 1024 * 1024;
  l.bars = l.ring + stages * kBiasTileBytes;
  l.total = l.bars + 2 * stages * 8 + 1024;
  return l;
}

template <int DP, int MODE>
__global__ void __launch_bounds__(kWgThreads, 1) wattn_bf16_wg(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
    const __grid_constant__ CUtensorMap bias_map, const float* __restrict__ scale,
    __nv_bfloat16* __restrict__ o, int bh, int n, int hd, Groups grp, int images, int stages,
    int tma) {
  constexpr int S = DP + 8, VPR = DP / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  const int n_pad = (n + kBK - 1) / kBK * kBK, tiles = n_pad / kBK;
  const WgLayout lay = wg_layout(DP, n_pad, images, stages);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* const empty = full + stages;
  unsigned char* const ring = smem + lay.ring;

  // the block's images: consecutive rows of one run of rows (one bias slice),
  // in row_of_block's order
  const int run_rows = run_length<MODE>(grp);
  const int per_run = (run_rows + images - 1) / images;  // blocks a run takes
  const int run = blockIdx.x / per_run;
  const int row0 = run * run_rows + (blockIdx.x - run * per_run) * images;
  const int live_images = min(images, min((run + 1) * run_rows, bh) - row0);
  const int group = group_of(grp, row_of_block<MODE>(grp, row0));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (live_images <= 0) return;  // past the end of a short last run

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, tma ? 1 : 32);       // the producer, once its copies land
      mbar_init(empty + st, 4 * live_images);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer: the slice's bias tiles, in the consumers' order
    if (tma && lane != 0) return;
    const float* const bias_g = bias + static_cast<size_t>(group) * n * n;
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = 0; qt < tiles; ++qt) {
      for (int pass = 0; pass < 2; ++pass) {
        for (int kt = 0; kt < tiles; ++kt) {
          mbar_wait(empty + stage, phase ^ 1);
          unsigned char* const dst = ring + kBiasTileBytes * stage;
          if (tma) {  // two 64 x 32 boxes; outside the slice reads as zeros
            mbar_arrive_expect_tx(full + stage, kBiasTileBytes);
            tma_load(dst, &bias_map, kt * kBK, qt * kBK, group, full + stage);
            tma_load(dst + kBK * 128, &bias_map, kt * kBK + 32, qt * kBK, group, full + stage);
          } else {  // rows not 16-byte aligned: 4-byte copies, zeros outside
            const int r0 = qt * kBK, c0 = kt * kBK;
            for (int idx = lane; idx < kBK * kBK; idx += 32) {
              const int r = idx >> 6, c = idx & 63;
              const bool live = r0 + r < n && c0 + c < n;
              cp_async4(dst + bias_offset(r, c),
                        bias_g + (live ? static_cast<size_t>(r0 + r) * n + c0 + c : 0), live);
            }
            mbar_arrive_cp_async(full + stage);
          }
          if (++stage == stages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  if (wg >= live_images) return;  // a run's odd last image leaves this warpgroup idle
  const int row = row_of_block<MODE>(grp, row0 + wg);
  const size_t base = static_cast<size_t>(row) * n * hd;
  const int g = lane >> 2, t = lane & 3, wt = tid & 127;
  const float c = q_factor<MODE>(scale, group, true);
  unsigned char* const k_s = smem + wg * 2 * lay.kv_bytes;
  unsigned char* const v_s = k_s + lay.kv_bytes;
  const uint32_t k_tile = smem_addr(k_s), v_tile = smem_addr(v_s);

  // this image's V (copied) and K (normalised with the cosine), in the panel layout
  for (int idx = wt; idx < n_pad * VPR; idx += 128) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 8;
    const bool live = r < n && vc < hd;
    cp_async16(v_s + panel_offset<DP>(n_pad, r, vc),
               v + base + (live ? static_cast<size_t>(r) * hd + vc : 0), live);
  }
  cp_async_commit();
#pragma unroll 2
  for (int idx = wt; idx < n_pad * VPR; idx += 128) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 8;
    *reinterpret_cast<uint4*>(k_s + panel_offset<DP>(n_pad, r, vc)) =
        load_bf16<DP>(k + base, 0, r, vc, n, hd, MODE == kCosine, false, 1.f);
  }
  cp_async_wait<0>();
  fence_async_smem();
  named_barrier(1 + wg, 128);

  __nv_bfloat16* const q_w = reinterpret_cast<__nv_bfloat16*>(smem + lay.q) + warp * 16 * S;
  int stage = 0;
  uint32_t phase = 0;
  for (int qt = 0; qt < tiles; ++qt) {
    const int q0 = qt * kBK + 16 * wq;  // this warp's 16 rows
    __syncwarp();
    stage_bf16<DP>(q_w, q + base, q0, 16, n, hd, MODE == kCosine, MODE != kV1, c, lane, 32);
    __syncwarp();
    uint32_t qf[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      ldmatrix_x4(qf[kk], q_w + (lane & 15) * S + kk * 16 + (lane >> 4) * 8);
    }

    // s = q k^T of key tile kt plus the ring's next bias tile; dead keys -inf
    auto scores = [&](int kt, float (&s)[32]) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        Wgmma<64>::rs<0>(s, qf[kk], desc_k_major<DP>(k_tile, n_pad, kt * kBK, kk * 16), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_wait(full + stage, phase);
      const unsigned char* const bt = ring + stage * kBiasTileBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 b = *reinterpret_cast<const float2*>(
              bt + bias_offset(16 * wq + g + 8 * h, 8 * j + 2 * t));
          s[4 * j + 2 * h] = add_bias<MODE>(s[4 * j + 2 * h], b.x);
          s[4 * j + 2 * h + 1] = add_bias<MODE>(s[4 * j + 2 * h + 1], b.y);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == stages) stage = 0, phase ^= 1;
      if ((kt + 1) * kBK > n) {  // the ragged last tile
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (kt * kBK + 8 * (i >> 2) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
        }
      }
    };

    // pass 1: the exact max of rows g (h = 0) and g + 8 (h = 1); K6 also z
    float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, zr[2];
    for (int kt = 0; kt < tiles; ++kt) {
      float s[32];
      scores(kt, s);
      if constexpr (MODE == kV1) {  // the quad's running max of the row, this lane's share of z
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
          const float m_new = fmaxf(m[h], mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sum += expf(s[4 * j + 2 * h] - m_new) + expf(s[4 * j + 2 * h + 1] - m_new);
          }
          z[h] = z[h] * expf(m[h] - m_new) + sum;
          m[h] = m_new;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          m[0] = fmaxf(m[0], fmaxf(s[4 * j], s[4 * j + 1]));
          m[1] = fmaxf(m[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = fmaxf(m[h], __shfl_xor_sync(kFull, m[h], 1));
      m[h] = fmaxf(m[h], __shfl_xor_sync(kFull, m[h], 2));
      if constexpr (MODE == kV1) {
        z[h] += __shfl_xor_sync(kFull, z[h], 1);
        z[h] += __shfl_xor_sync(kFull, z[h], 2);
        zr[h] = 1.f / z[h];
      }
    }

    // pass 2: the weights and the value product
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < tiles; ++kt) {
      float s[32];
      scores(kt, s);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if constexpr (MODE == kV1) {
          s[i] = v1_weight_rcp(s[i] - m[(i >> 1) & 1], z[(i >> 1) & 1], zr[(i >> 1) & 1]);
        } else {
          s[i] = exp2f(s[i] - m[(i >> 1) & 1]);
          z[(i >> 1) & 1] += s[i];  // the unrounded e
        }
      }
      uint32_t pf[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Wgmma<DP>::template rs<1>(acc, pf[kk], desc_mn_major<DP>(v_tile, n_pad, kt * kBK + 16 * kk, 0), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
    }
    fence_regs(qf);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float div = 1.f;  // K6's weights are already normalised
      if constexpr (MODE != kV1) {
        div = z[h];
        div += __shfl_xor_sync(kFull, div, 1);
        div += __shfl_xor_sync(kFull, div, 2);
      }
      const int r = q0 + g + 8 * h;
      if (r >= n) continue;
      __nv_bfloat16* dst = o + base + static_cast<size_t>(r) * hd;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < hd) {
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] / div, acc[4 * j + 2 * h + 1] / div);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32, K4 (modes kScaled and kCosine) and K6 (kV1): wattn_prep_f32 writes the
// operands the main kernel streams, wattn_f32_wg takes both products in
// 3xTF32 on wgmma.

namespace tb = tf32bwd;

// The terms each product takes (attn_bwd_f32.cuh, product_rs): 3 is 3xTF32,
// big . big + big . small + small . big; 2 drops small . big; 1 is big . big
// alone. The CPU's emulation of the split (tests/test_torch_tf32_split.py)
// keeps both products on 3xTF32 within a fifth of window_agreement's f32
// bound at the clamp of scale 100, and puts 2xTF32, 1xTF32 and the value
// product alone on 1xTF32 past it (chip_faults.py plants them on the card).
constexpr int kScoreTerms = 3;  // s = q k^T
constexpr int kValueTerms = 3;  // out += e v

// A ring stage: the bias tile both images share, then per image its K, K
// small, V^T, V^T small.
__host__ __device__ inline int f32_stage_bytes(int dp, int images) {
  return kBiasTileBytes + images * 4 * kBK * dp * 4;
}

__host__ __device__ inline int f32_smem_bytes(int dp, int images, int stages) {
  return stages * f32_stage_bytes(dp, images) + 2 * stages * 8 + 1024;  // + mbarriers, alignment
}

// The f32 workspace: k normalised (the cosine only; else the main kernel
// reads k itself) and its small part as (bh, n, hd); V^T and its small part
// as (bh, hd, n_pad), each 64-key tile's keys in slot_query's order, zeros
// past n.
struct F32Workspace {
  size_t kb, ks, vtb, vts, bytes;
};

inline F32Workspace f32_workspace(int mode, int bh, int n, int hd) {
  const size_t elems = static_cast<size_t>(bh) * n * hd;
  const size_t plane = static_cast<size_t>(bh) * hd * ((n + kBK - 1) / kBK * kBK);
  F32Workspace w;
  w.kb = 0;
  w.ks = mode == kCosine ? elems * 4 : 0;
  w.vtb = w.ks + elems * 4;
  w.vts = w.vtb + plane * 4;
  w.bytes = w.vts + plane * 4;
  return w;
}

// One block per (row, 64-key tile): K's rows (normalised with the cosine: the
// DP / 4 lanes of a row add their vectors' squares by xor shuffles) and their
// small parts; V's rows through shared memory into V^T and its small part,
// column p of the tile holding key slot_query(p).
template <int DP, int MODE>
__global__ void __launch_bounds__(256) wattn_prep_f32(const float* __restrict__ k,
                                                      const float* __restrict__ v,
                                                      float* __restrict__ kb, float* __restrict__ ks,
                                                      float* __restrict__ vtb,
                                                      float* __restrict__ vts, int n, int hd) {
  constexpr int VPR = DP / 4;
  __shared__ float v_s[kBK][DP + 1];
  const int tiles = (n + kBK - 1) / kBK, n_pad = tiles * kBK;
  const int row = blockIdx.x / tiles, key0 = (blockIdx.x - row * tiles) * kBK;
  const size_t base = static_cast<size_t>(row) * n * hd;
  for (int idx = threadIdx.x; idx < kBK * VPR; idx += 256) {  // whole warps a step
    const int r = idx / VPR, vc = (idx - r * VPR) * 4;
    const bool live = key0 + r < n && vc < hd;
    const size_t off = base + static_cast<size_t>(key0 + r) * hd + vc;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f), g = f;
    if (live) {
      f = __ldg(reinterpret_cast<const float4*>(k + off));
      g = __ldg(reinterpret_cast<const float4*>(v + off));
    }
    if (MODE == kCosine) {
      float ss = fmaf(f.x, f.x, fmaf(f.y, f.y, fmaf(f.z, f.z, f.w * f.w)));
#pragma unroll
      for (int o = 1; o < VPR; o <<= 1) ss += __shfl_xor_sync(kFull, ss, o);
      const float rn = inv_norm(ss);
      f = make_float4(__fmul_rn(f.x, rn), __fmul_rn(f.y, rn), __fmul_rn(f.z, rn),
                      __fmul_rn(f.w, rn));
    }
    if (live) {
      if (MODE == kCosine) *reinterpret_cast<float4*>(kb + off) = f;
      *reinterpret_cast<float4*>(ks + off) =
          make_float4(tf32_small(f.x), tf32_small(f.y), tf32_small(f.z), tf32_small(f.w));
    }
    v_s[r][vc] = g.x;
    v_s[r][vc + 1] = g.y;
    v_s[r][vc + 2] = g.z;
    v_s[r][vc + 3] = g.w;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < hd * kBK; idx += 256) {
    const int d = idx / kBK, p = idx - d * kBK;
    const float x = v_s[tb::slot_query(p)][d];
    const size_t dst = (static_cast<size_t>(row) * hd + d) * n_pad + key0 + p;
    vtb[dst] = x;
    vts[dst] = tf32_small(x);
  }
}

struct F32Maps {  // the copy engine's tensor maps, passed by value
  CUtensorMap bias, kb, ks, vtb, vts;
};

// An item of the f32 grid: up to two images of one run of rows that share a
// bias slice (the bf16 route's pairs, in row_of_block's order) and a 64-row
// query tile. An image past the run repeats the last live one, whose
// products its warpgroup then takes without storing them.
struct PairItem {
  int rows[2], live, group, qt;
};

template <int MODE>
__device__ __forceinline__ PairItem pair_item(const Groups& grp, int x, int tiles, int images,
                                              int bh) {
  PairItem it;
  const int pair = x / tiles, run_rows = run_length<MODE>(grp);
  const int pairs_per_run = (run_rows + images - 1) / images, run = pair / pairs_per_run;
  const int first = run * run_rows + (pair - run * pairs_per_run) * images;
  it.qt = x - pair * tiles;
  it.live = min(images, min((run + 1) * run_rows, bh) - first);
  it.group = group_of(grp, row_of_block<MODE>(grp, first));
  it.rows[0] = row_of_block<MODE>(grp, first);
  it.rows[1] = row_of_block<MODE>(grp, first + (it.live > 1 ? 1 : 0));
  return it;
}

// 2^d (K4) or e^d (K6).
template <int MODE>
__device__ __forceinline__ float softmax_exp(float d) {
  return MODE == kV1 ? expf(d) : exp2f(d);
}

// This thread's query fragments of a 64-row tile (rows r0 = tile + 16 wq + g
// and r0 + 8, columns 8 kk + t and + 4 of each depth step kk), as wgmma's
// TF32 A operand, big and small: normalised with the cosine (the quad's
// lanes add their squares), multiplied by c (K4), zeros past n and hd.
template <int DP, int MODE>
__device__ __forceinline__ void query_fragments(const float* q, int r0, int n, int hd, float c,
                                                int t, uint32_t (&big)[DP / 8][4],
                                                uint32_t (&small)[DP / 8][4]) {
  float x[2][DP / 4];  // [h][2 kk + u]: row r0 + 8 h, column 8 kk + t + 4 u
  float ss[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int i = 0; i < DP / 4; ++i) {
      const int col = 8 * (i >> 1) + t + 4 * (i & 1);
      x[h][i] = r < n && col < hd ? __ldg(q + static_cast<size_t>(r) * hd + col) : 0.f;
      ss[h] = fmaf(x[h][i], x[h][i], ss[h]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (MODE == kCosine) {
      ss[h] += __shfl_xor_sync(kFull, ss[h], 1);
      ss[h] += __shfl_xor_sync(kFull, ss[h], 2);
      const float rn = inv_norm(ss[h]);
#pragma unroll
      for (int i = 0; i < DP / 4; ++i) x[h][i] = __fmul_rn(x[h][i], rn);
    }
    if (MODE != kV1) {
#pragma unroll
      for (int i = 0; i < DP / 4; ++i) x[h][i] = __fmul_rn(x[h][i], c);
    }
  }
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const float f[4] = {x[0][2 * kk], x[1][2 * kk], x[0][2 * kk + 1], x[1][2 * kk + 1]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      big[kk][i] = __float_as_uint(f[i]);
      small[kk][i] = __float_as_uint(tf32_small(f[i]));
    }
  }
}

// warps 0-7 the two consumer warpgroups (232 registers each by setmaxnreg:
// ptxas sizes a block of three warpgroups at 168 a thread, too few for the
// query, score, weight and output fragments, and serialises the products),
// warps 8-11 the third, which gives its registers up: warp 8 the producer
constexpr int kF32Threads = 384;

// A persistent block per SM walks the items x = blockIdx.x, + gridDim.x, ...
// Warpgroup w (warps 4 w .. 4 w + 3) takes image w of each item; warp 8, the
// producer, streams per item and 64-key tile one ring stage: the bias tile by
// the copy engine (two 64 x 32 boxes; where N is not a multiple of 4 its
// lanes copy 4 bytes at a time) and each image's K, K small, V^T, V^T small
// (a box a panel). Per tile: s = q k^T (3xTF32, the query fragments from
// registers), bias (add_bias) and the ragged mask, the running max of the
// quad's row, the rescale of the accumulator and z, e = softmax_exp(s - m),
// out += e v (3xTF32, e's fragments from the accumulator); at the item's end
// out / z, stored for live rows of a live image.
template <int DP, int MODE>
__global__ void __launch_bounds__(kF32Threads, 1) wattn_f32_wg(
    const float* __restrict__ q, const __grid_constant__ F32Maps maps,
    const float* __restrict__ bias, const float* __restrict__ scale, float* __restrict__ o,
    int bh, int n, int hd, Groups grp, int images, int stages, int items, int tma) {
  constexpr int kOp = kBK * DP * 4;  // an operand tile: K or its small part, V^T or its small part
  using KP = Panels<2 * DP>;  // the K tile's panels (f32 columns = 2 bf16 columns)
  extern __shared__ unsigned char smem_raw[];
  if (threadIdx.x == 0) {
    unsigned char* const smem = align_1024(smem_raw);
    uint64_t* const full = reinterpret_cast<uint64_t*>(smem + stages * f32_stage_bytes(DP, images));
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, tma ? 1 : 33);        // the producer's lane 0 (and its lanes' 4-byte copies)
      mbar_init(full + stages + st, 4 * images);  // empty: one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the block's layout is worked out after the register move: a value live
  // across setmaxnreg would live in local memory
  if (threadIdx.x >= kConsumerWarps * 32) {
    regs_shrink<40>();
  } else {
    regs_grow<232>();
  }
  unsigned char* const smem = align_1024(smem_raw);
  const int tiles = (n + kBK - 1) / kBK, stage_bytes = f32_stage_bytes(DP, images);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + stages * stage_bytes);
  uint64_t* const empty = full + stages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (warp >= kConsumerWarps) {  // warp 8, the producer
    if (warp != kConsumerWarps || (tma && lane != 0)) return;
    const uint32_t tx = images * 4 * kOp + (tma ? kBiasTileBytes : 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int x = blockIdx.x; x < items; x += gridDim.x) {
      const PairItem it = pair_item<MODE>(grp, x, tiles, images, bh);
      if (it.live <= 0) continue;
      const float* const bias_g = bias + static_cast<size_t>(it.group) * n * n;
      const int r0 = it.qt * kBK;
      for (int kt = 0; kt < tiles; ++kt) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* const dst = smem + stage * stage_bytes;
        if (lane == 0) {
          mbar_arrive_expect_tx(full + stage, tx);
          if (tma) {  // outside the slice reads as zeros
            tma_load(dst, &maps.bias, kt * kBK, r0, it.group, full + stage);
            tma_load(dst + kBK * 128, &maps.bias, kt * kBK + 32, r0, it.group, full + stage);
          }
          for (int w = 0; w < images; ++w) {
            unsigned char* const ops = dst + kBiasTileBytes + w * 4 * kOp;
#pragma unroll
            for (int pn = 0; pn < KP::kCount; ++pn) {
              const int off = pn * kBK * KP::kRowBytes, c0 = pn * KP::kWidth / 2;
              tma_load(ops + off, &maps.kb, c0, kt * kBK, it.rows[w], full + stage);
              tma_load(ops + kOp + off, &maps.ks, c0, kt * kBK, it.rows[w], full + stage);
            }
#pragma unroll
            for (int pn = 0; pn < 2; ++pn) {  // 32 keys a panel
              const int off = pn * DP * 128, c0 = kt * kBK + 32 * pn;
              tma_load(ops + 2 * kOp + off, &maps.vtb, c0, 0, it.rows[w], full + stage);
              tma_load(ops + 3 * kOp + off, &maps.vts, c0, 0, it.rows[w], full + stage);
            }
          }
        }
        if (!tma) {  // rows not 16-byte aligned: 4-byte copies, zeros outside
          const int c0 = kt * kBK;
          for (int idx = lane; idx < kBK * kBK; idx += 32) {
            const int r = idx >> 6, c = idx & 63;
            const bool live = r0 + r < n && c0 + c < n;
            cp_async4(dst + bias_offset(r, c),
                      bias_g + (live ? static_cast<size_t>(r0 + r) * n + c0 + c : 0), live);
          }
          mbar_arrive_cp_async(full + stage);
        }
        if (++stage == stages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  if (wg >= images) return;  // one image a block
  int stage = 0;
  uint32_t phase = 0;
  for (int x = blockIdx.x; x < items; x += gridDim.x) {
    const PairItem it = pair_item<MODE>(grp, x, tiles, images, bh);
    if (it.live <= 0) continue;
    const size_t base = static_cast<size_t>(it.rows[wg]) * n * hd;
    const int r0 = it.qt * kBK + 16 * wq + g;  // this thread's rows r0, r0 + 8
    uint32_t qb[DP / 8][4], qs[DP / 8][4];
    query_fragments<DP, MODE>(q + base, r0, n, hd, q_factor<MODE>(scale, it.group, false), t, qb,
                              qs);
    float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f}, acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < tiles; ++kt) {
      mbar_wait(full + stage, phase);
      const unsigned char* const st = smem + stage * stage_bytes;
      // the stage's K and V^T descriptors: one of each layout at the image's
      // first operand tile, the others at constant offsets from it (the
      // address field is the shared address / 16, which no offset within the
      // block carries over)
      const uint32_t ops = smem_addr(st + kBiasTileBytes + wg * 4 * kOp);
      const uint64_t k0 = tb::desc<DP>(ops, kBK, 0, 0), v0 = tb::desc<kBK>(ops, DP, 0, 0);
      float s[32];
      wgmma_fence();
      tb::product_rs<kBK, DP / 8, kScoreTerms>(
          s, qb, qs,
          [&](int part, int kk) { return k0 + (tb::desc<DP>(part * kOp, kBK, 0, kk) & 0x3fffu); },
          0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 b = *reinterpret_cast<const float2*>(
              st + bias_offset(16 * wq + g + 8 * h, 8 * j + 2 * t));
          s[4 * j + 2 * h] = add_bias<MODE>(s[4 * j + 2 * h], b.x);
          s[4 * j + 2 * h + 1] = add_bias<MODE>(s[4 * j + 2 * h + 1], b.y);
        }
      }
      if ((kt + 1) * kBK > n) {  // the ragged last tile
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if (kt * kBK + 8 * (i >> 2) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
        }
      }
      // the running max of rows g (h = 0) and g + 8 (h = 1) over the quad;
      // key 0 is live, so m is finite from the first tile on
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        alpha[h] = softmax_exp<MODE>(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = softmax_exp<MODE>(s[i] - m[(i >> 1) & 1]);
        rsum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) z[h] = z[h] * alpha[h] + rsum[h];  // this lane's share of z
      // this tile's e v in an accumulator of its own, then added to the
      // rescaled sum in f32: the tensor cores' own sums truncate, and a
      // window's 72 depth steps into one accumulator moved the f32 SwinV2
      // embeddings past their bound (PERF.md)
      uint32_t eb[8][4], es[8][4];
      tb::split_fragments<8>(s, eb, es);
      float pv[DP / 2];
      wgmma_fence();
      tb::product_rs<DP, 8, kValueTerms>(
          pv, eb, es,
          [&](int part, int kk) {
            return v0 + (tb::desc<kBK>((2 + part) * kOp, DP, 0, kk) & 0x3fffu);
          },
          0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
      fence_regs(eb);
      fence_regs(es);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] = acc[i] * alpha[(i >> 1) & 1] + pv[i];
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stage);
      if (++stage == stages) stage = 0, phase ^= 1;
    }
    fence_regs(qb);
    fence_regs(qs);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      z[h] += __shfl_xor_sync(kFull, z[h], 1);
      z[h] += __shfl_xor_sync(kFull, z[h], 2);
      const int r = r0 + 8 * h;
      if (wg >= it.live || r >= n) continue;
      float* const dst = o + base + static_cast<size_t>(r) * hd;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < hd) {
          *reinterpret_cast<float2*>(dst + col) =
              make_float2(acc[4 * j + 2 * h] / z[h], acc[4 * j + 2 * h + 1] / z[h]);
        }
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const float *bias, *scale;
  void *o, *workspace;
  int dtype, bh, n, hd;
  Groups grp;
  cudaStream_t stream;
};

// returned in place of a cudaError_t code (all >= 0) when one window's K and V
// do not fit a block's shared memory
constexpr int kTooLarge = -1;

// The bias as (N columns, N rows, G slices) for the copy engine: two 64 x 32
// boxes a tile, 128-byte swizzled (bias_offset).
int bias_map(CUtensorMap* map, const Args& a) {
  const int slices = (a.grp.m1 - 1) * a.grp.s1 + (a.grp.m2 - 1) * a.grp.s2 + 1;
  return make_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.bias, a.n, a.n,
                         static_cast<uint64_t>(slices), static_cast<uint64_t>(a.n) * 4,
                         static_cast<uint64_t>(a.n) * a.n * 4, 32, kBK, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DP, int MODE>
int launch_f32(const Args& a) {
  // two images an item where they fit beside a ring of at least two stages, else one
  int images = 0, stages = 0;
  for (int im = 2; im >= 1 && !images; --im) {
    for (int st = 4; st >= 2 && !images; --st) {
      if (f32_smem_bytes(DP, im, st) <= kSmemLimit) images = im, stages = st;
    }
  }
  const int bytes = f32_smem_bytes(DP, images, stages);
  cudaError_t err = cudaFuncSetAttribute(wattn_f32_wg<DP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (a.n + kBK - 1) / kBK, n_pad = tiles * kBK;
  const int run_rows = run_length<MODE>(a.grp);
  const long long items = static_cast<long long>((a.bh + run_rows - 1) / run_rows) *
                          ((run_rows + images - 1) / images) * tiles;
  if (items > 2147483647LL || static_cast<long long>(a.bh) * tiles > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const F32Workspace w = f32_workspace(MODE, a.bh, a.n, a.hd);
  unsigned char* const ws = static_cast<unsigned char*>(a.workspace);
  const float* const k = static_cast<const float*>(a.k);
  wattn_prep_f32<DP, MODE><<<a.bh * tiles, 256, 0, a.stream>>>(
      k, static_cast<const float*>(a.v), reinterpret_cast<float*>(ws + w.kb),
      reinterpret_cast<float*>(ws + w.ks), reinterpret_cast<float*>(ws + w.vtb),
      reinterpret_cast<float*>(ws + w.vts), a.n, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // K (the prep's normalised k with the cosine, else k) and its small part as
  // (hd, N, BH), a box a panel; V^T and its small part as (n_pad, hd, BH),
  // boxes of 32 keys x DP rows; the bias where its rows are 16-byte aligned
  using KP = Panels<2 * DP>;
  F32Maps maps = {};
  const void* const k_rows[2] = {MODE == kCosine ? ws + w.kb : a.k, ws + w.ks};
  CUtensorMap* const k_maps[2] = {&maps.kb, &maps.ks};
  const void* const vt_rows[2] = {ws + w.vtb, ws + w.vts};
  CUtensorMap* const vt_maps[2] = {&maps.vtb, &maps.vts};
  for (int part = 0; part < 2; ++part) {
    if (make_tensor_map(k_maps[part], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, k_rows[part], a.hd, a.n,
                        a.bh, static_cast<uint64_t>(a.hd) * 4,
                        static_cast<uint64_t>(a.n) * a.hd * 4, KP::kWidth / 2, kBK,
                        panel_swizzle<2 * DP>()) != 0 ||
        make_tensor_map(vt_maps[part], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, vt_rows[part], n_pad, a.hd,
                        a.bh, static_cast<uint64_t>(n_pad) * 4,
                        static_cast<uint64_t>(n_pad) * a.hd * 4, 32, DP,
                        CU_TENSOR_MAP_SWIZZLE_128B) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int tma = a.n % 4 == 0;
  if (tma && bias_map(&maps.bias, a) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(items < sms ? items : sms);
  wattn_f32_wg<DP, MODE><<<grid, kF32Threads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), maps, a.bias, a.scale, static_cast<float*>(a.o), a.bh, a.n,
      a.hd, a.grp, images, stages, static_cast<int>(items), tma);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, int MODE>
int launch_one(const Args& a) {
  // both routes take a run of rows that share a bias slice a pair at a time:
  // K4's rows run through the groups in order; K6's are (window, image, head)
  if (MODE != kV1 && a.grp.m2 != 1 && a.grp.s2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (MODE == kV1 && (a.grp.d2 != 1 || a.grp.s2 != 1 || a.grp.s1 != a.grp.m2 ||
                      a.grp.d1 % a.grp.m2 != 0 || a.bh % a.grp.d1 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.dtype == 0) return launch_f32<DP, MODE>(a);
  // bf16: two images a block where their K and V fit, else one; three ring
  // stages, else two
  const int n_pad = (a.n + kBK - 1) / kBK * kBK;
  int images = 0, stages = 0;
  for (int im = 2; im >= 1 && !images; --im) {
    for (int st = 3; st >= 2 && !images; --st) {
      if (wg_layout(DP, n_pad, im, st).total <= kSmemLimit) images = im, stages = st;
    }
  }
  if (!images) return kTooLarge;
  const int bytes = wg_layout(DP, n_pad, images, stages).total;
  cudaError_t err = cudaFuncSetAttribute(wattn_bf16_wg<DP, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int run_rows = run_length<MODE>(a.grp);
  const int per_run = (run_rows + images - 1) / images;
  const long long blocks = static_cast<long long>((a.bh + run_rows - 1) / run_rows) * per_run;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  // the bias by the copy engine where its rows are 16-byte aligned; else the
  // kernel copies 4 bytes at a time
  const int tma = a.n % 4 == 0;
  CUtensorMap map = {};
  if (tma && bias_map(&map, a) != 0) return static_cast<int>(cudaErrorInvalidValue);
  wattn_bf16_wg<DP, MODE><<<static_cast<unsigned>(blocks), kWgThreads, bytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.bias, map, a.scale,
      static_cast<__nv_bfloat16*>(a.o), a.bh, a.n, a.hd, a.grp, images, stages, tma);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_mode(int mode, const Args& a) {
  if (mode == kScaled) return launch_one<DP, kScaled>(a);
  if (mode == kCosine) return launch_one<DP, kCosine>(a);
  return launch_one<DP, kV1>(a);
}

bool valid(int dtype, int mode, int bh, int n, int hd) {
  return (dtype == 0 || dtype == 1) && mode >= 0 && mode <= 2 && bh >= 1 && n >= 1 && hd >= 8 &&
         hd <= 64 && hd % 8 == 0;
}

}  // namespace

// Bytes of the workspace xmir_window_attn takes: the f32 route's
// (F32Workspace); the bf16 route takes none.
extern "C" int xmir_window_attn_workspace(int dtype, int mode, int bh, int n, int hd,
                                          long long* bytes) {
  if (!valid(dtype, mode, bh, n, hd)) return (int)cudaErrorInvalidValue;
  *bytes = dtype == 0 ? static_cast<long long>(f32_workspace(mode, bh, n, hd).bytes) : 0;
  return 0;
}

// C entry point bound with ctypes; returns a cudaError_t code, or -1 when one
// window's K and V do not fit a block's shared memory (bf16). q, k, v, o (bh,
// n, hd) contiguous, 16-byte aligned, of one dtype (0 = float32, 1 =
// bfloat16); hd a multiple of 8 up to 64; bias (groups, n, n) float32, 16-byte
// aligned; scale (groups,) float32, unread in mode 2. mode: 0 = K4 without the
// cosine normalisation, 1 = K4 with it, 2 = K6. Row i uses bias slice (i / d1)
// % m1 * s1 + (i / d2) % m2 * s2: K4 with m2 = 1 or s2 = 0; K6 (d1 = B H, m1,
// s1 = H, 1, H, 1) on (window, image, head) rows. workspace: scratch of
// xmir_window_attn_workspace's bytes, 16-byte aligned (unread in bf16).
extern "C" int xmir_window_attn(const void* q, const void* k, const void* v, const float* bias,
                                const float* scale, void* o, int dtype, int mode, int bh, int n,
                                int hd, int d1, int m1, int s1, int d2, int m2, int s2,
                                void* workspace, void* stream) {
  if (!valid(dtype, mode, bh, n, hd) || d1 < 1 || m1 < 1 || d2 < 1 || m2 < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a = {q, k, v, bias, scale, o, workspace, dtype, bh, n, hd,
                  {d1, m1, s1, d2, m2, s2}, static_cast<cudaStream_t>(stream)};
  if (hd <= 16) return launch_mode<16>(mode, a);
  if (hd <= 32) return launch_mode<32>(mode, a);
  return launch_mode<64>(mode, a);
}
