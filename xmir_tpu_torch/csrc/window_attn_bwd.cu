// Backward of the grouped-bias cosine window attention (K4) for the Swin
// towers on Hopper (sm_90a): dq, dk, dv (BH, N, hd), dbias (G, N, N) f32 and
// each folded row's alpha total (for dscale) of
// out = softmax(norm(q) norm(k)^T scale_g + bias_g) v, row i in group
// (i / g_size) % G.
//
// Replaces K5, xmir_tpu/ops/vit_attn_pallas.py::_biased_bwd_pallas (body
// _bwd_kernel_biased). Its arithmetic, which ops/vit_attn.py::
// biased_attention_bwd_plain writes out: qh, kh = q, k times their inverse
// norms in f32 (with `cosine`), rounded to the input dtype; f32 s_cos = qh kh^T;
// s2 = s_cos (scale_g log2 e) + bias log2 e (two products, one sum, no FMA);
// m the exact row max, e = exp2(s2 - m), z its f32 sum; c = rowsum(g o) and
// dp = g v^T in f32; t = e (dp - c), rounded to the input dtype before both
// of its products; dbias_g += t / z (f32 t) over the group's folded rows in
// their order; dqh = (t kh) (scale_g / z); alpha = rowsum(dqh qh32);
// dq = (dqh - qh32 alpha) / |q|; qz = qh32 scale_g / z and gz = g / z
// rounded; dkh = t^T qz, dk = (dkh - kh32 beta) / |k|; dv = e^T gz on e
// rounded. The backward recomputes its own m and z from its own s2, as the
// TPU kernel does: K4 rounds q times scale log2 e before its product, the
// backward rounds qh alone, so K4's row statistics would not normalise this
// e (and K4 saves none).
//
// What does not carry over from the TPU: there a (1, N, N) f32 dbias block
// stays resident across a group's contiguous grid steps and is added to in
// order. Blocks on the card run in no order; nothing here is added up with
// atomics in an order that changes, and two runs are bit-equal.
//
// bf16 (every SwinV2 block's backward in training: 24 calls a Swin-B step),
// three launches and a memset of counters. What bounds it on the H100: 10 BH
// N^2 hd operations (five products) against eight (BH, N, hd) tensors and the
// bias and dbias tables moved once, by bytes at Swin-B's shapes (0.673 ms a
// step at B = 8). The main pass moves most through L2: each row reads its
// bias tile and adds its dbias part, 12 B a score (PERF.md: by arithmetic,
// not a counter). The design:
//   window_bwd_prep    a block per (four rows of a group, run of query
//                      tiles), kh resident, the group's bias tiles by TMA
//                      once for all four: s = qh kh^T once by wgmma, each
//                      row's exact max m and z along running maxima (z
//                      differs from the sum at the exact max by rounding
//                      only); then c = rowsum(g o) and qh, qz, gz for the
//                      main pass, and (m, 1 / z, c) into `stats`;
//   window_bwd_main    a persistent block per SM takes (row, 128-key) units:
//                      per (query tile, 64-key half) s^T and dp^T are formed
//                      once on wgmma and feed all outputs: dk and dv
//                      (registers, the whole unit), the unit's dq part (t kh,
//                      ordered adds across the row's key units) and its dbias
//                      part (t / z written over the bias tile it came from,
//                      ordered adds across the group's rows). 12 BH N^2 hd
//                      operations with the prep's scores, against 20 in the
//                      f32 kernels below;
//   window_bwd_finish  dq = (the sum) (scale / z), alpha into `stats`, the
//                      cosine chain, one rounding.
// dbias: each row's t / z (BH N^2 4 B in all, 680 MB at stage 1) must be
// summed over g_size rows in a fixed order. Of the two ways: (a) ordered adds
// of each unit's 64 x 128 tile behind a counter per (group, query tile, key
// unit), as K3 orders dq; (b) per-(group, query tile) partials over a block's
// run of rows, summed in a fixed order afterwards. (b) needs a block to keep
// a partial across rows: one unit's partials for all query tiles (9 x 32 KB at
// N = 576) do not fit beside the ring, and holding a run's rows at once
// (their K, V and dk / dv accumulators) spills past the 232 registers the
// consumers have; partials in device memory per run of R rows cost BH / R N^2
// 4 B written and read again (170 MB at stage 1 for R = 4). (a) moves each
// row's part once through L2 by the copy engine (BH N^2 4 B of reductions, 1.3
// GB over a step's 24 calls at B = 8), and its cost is the chain: each link is
// one reduction's round trip (a few us). Units run level-major ((level,
// group, key unit), unit_of), so a link's predecessor is G U units earlier:
// at most ceil(132 / (G U)) links of one chain fall in one wave of 132 units,
// 7 at stage 1 unshifted (G U = 4 x 5), 2 at stage 3 (16 x 5), 1 elsewhere,
// against 9 query tiles of work a unit. So (a).
// Registers (-Xptxas -v, sm_90a): the main kernel 168 at its 384 threads,
// of which the third warpgroup (producer and reducers) gives its own up
// (setmaxnreg 40) and the consumers take 232; 68 bytes of spill stores. The
// prep 96 at its 544 threads, with 42-86 bytes of spills at hd 16-32 (four
// rows a block still beat two of 105 registers and no spills in development
// runs). Shared memory: the main kernel 201 KB at hd 32 (three ring stages of
// 49 KB: bias 32 KB, four operand tiles, the stats; kh and v of the unit,
// t^T), 200 KB at hd 64 (two stages); the prep 218 KB at N = 576, hd 32.
//
// f32 (SwinV2 f32 training under XMIR_FUSED_ATTN=1). What bounds it on the
// H100: the same 10 BH N^2 hd operations and the prep's scores, 6.1 ms a
// SwinV2-Base step (B = 8) on the CUDA cores' f32 FMAs against about 2.5 ms
// as three TF32 products each on the tensor cores: so dp, dv, dk and dq are
// 3xTF32 on wgmma (attn_bwd_f32.cuh; dp's depth steps each added in f32)
// and the scores, whose error e = exp2(s2 - m) scales up at logits of +-144,
// stay on IEEE FMAs, the bound now with the prep's (PERF.md). Three launches
// and a memset of counters, the bf16 route's structure with f32 pieces:
//   window_prep_f32       a block per (folded row, 64-query tile) streams
//                         the row's kh tiles past its qh tile on IEEE FMAs
//                         (the exact row max wants every score of the row
//                         before any e): s2, each row's max m and z along
//                         running maxima; then c, stats = (m, 1 / z, c, 0),
//                         and the main pass's operands: qh with its small
//                         part, g's small part, qz = qh32 (scale_g / z) and
//                         gz = g / z transposed (hd, N) with their small
//                         parts (TF32 reads no MN-major operand);
//   window_bwd_f32_wg     a persistent block per SM takes (row, 64-key)
//                         units in the bf16 route's order: kh and v stay
//                         resident (big and small), a producer warp streams
//                         the 32-row query tiles (eight operand tiles, the
//                         bias tile, the stats) through a ring of two
//                         stages, one for each of two consumer warpgroups
//                         that take the tiles in turns; per tile s_cos (FMAs)
//                         and dp (3xTF32) once each feed dv, dk, the dq part
//                         and the dbias part (t / z over the bias), which a
//                         reducer per stage adds in the bf16 route's fixed
//                         orders (counters per (row, query tile) and per
//                         (group, query tile, key unit));
//   window_bwd_finish_f32 dq = (the sum) (scale / z), alpha, the cosine chain.
// 12 BH N^2 hd operations (the prep's scores on FMAs) against 20 in the
// three FMA kernels this replaces. Two runs are bit-equal.
//
// hd is a multiple of 8 up to 64, zero-padded in shared memory to 16 (bf16),
// 32 or 64; N a multiple of 8 (ragged tiles are masked, or read as zeros by the
// copy engine); BH == G g_size. Launches go on the caller's stream and
// allocate nothing: the wrapper hands over the scratch.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_bwd_f32.cuh"
#include "attn_mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;  // query rows or keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// 1 / max(||x||, 1e-12), as the TPU kernel clamps it
__device__ __forceinline__ float inv_norm(float sum_sq) {
  return 1.f / sqrtf(fmaxf(sum_sq, 1e-24f));
}

// s2 = s_cos (scale_g log2 e) + b log2 e: two roundings, then the sum
__device__ __forceinline__ float logit2(float s, float csc, float b2) {
  return __fadd_rn(__fmul_rn(s, csc), b2);
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// The sum of squares of one bf16 vector of eight, in sequence (each square
// is exact in f32), and of one f32 vector of four.
__device__ __forceinline__ float sumsq8(uint4 raw) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    ss = fmaf(t.x, t.x, ss);
    ss = fmaf(t.y, t.y, ss);
  }
  return ss;
}
__device__ __forceinline__ float sumsq4(float4 f) {
  return fmaf(f.x, f.x, fmaf(f.y, f.y, fmaf(f.z, f.z, f.w * f.w)));
}

// A row's inverse norm: the vectors' sums of squares added in a pairwise
// tree (VPR a power of two), the order in which a row's VPR neighbouring
// lanes add them with xor shuffles in the loaders below. In bf16 this is
// ops/vit_attn.py::sum_squares bit for bit.
template <int DP>
__device__ float row_inv_norm(const bf16* row, int hd) {
  constexpr int VPR = DP / 8;
  float part[VPR];
#pragma unroll
  for (int v = 0; v < VPR; ++v) {
    part[v] = v * 8 < hd ? sumsq8(__ldg(reinterpret_cast<const uint4*>(row + v * 8))) : 0.f;
  }
#pragma unroll
  for (int w = 1; w < VPR; w <<= 1)
#pragma unroll
    for (int v = 0; v < VPR; v += 2 * w) part[v] += part[v + w];
  return inv_norm(part[0]);
}
template <int DP>
__device__ float row_inv_norm(const float* row, int hd) {
  constexpr int VPR = DP / 4;
  float part[VPR];
#pragma unroll
  for (int v = 0; v < VPR; ++v) {
    part[v] = v * 4 < hd ? sumsq4(__ldg(reinterpret_cast<const float4*>(row + v * 4))) : 0.f;
  }
#pragma unroll
  for (int w = 1; w < VPR; w <<= 1)
#pragma unroll
    for (int v = 0; v < VPR; v += 2 * w) part[v] += part[v + w];
  return inv_norm(part[0]);
}

// Rows [row0, row0 + rows) of an (n, hd) matrix into shared memory: element
// x becomes (x rn) factor(row), two f32 products, then (bf16) one rounding;
// rn is the row's inverse norm with `normalise`, else 1. Dead rows and a
// head's padding are zeros. The DP / 8 (bf16) or DP / 4 (f32) lanes of a row
// are neighbours and rows * lanes is a multiple of 32, so whole warps take
// each step of the shuffles.
template <int DP, typename F>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int rows, int n,
                                          int hd, bool normalise, F factor, int tid,
                                          int n_threads) {
  constexpr int S = DP + 8, VPR = DP / 8;
  for (int idx = tid; idx < rows * VPR; idx += n_threads) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 8;
    const bool live = row0 + r < n;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (live && vc < hd) {
      raw = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * hd + vc));
    }
    float rn = 1.f;
    if (normalise) {
      float ss = sumsq8(raw);
#pragma unroll
      for (int off = 1; off < VPR; off <<= 1) ss += __shfl_xor_sync(kFull, ss, off);
      rn = inv_norm(ss);
    }
    const float fac = live ? factor(row0 + r) : 0.f;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      p[i] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(t.x, rn), fac),
                                   __fmul_rn(__fmul_rn(t.y, rn), fac));
    }
    *reinterpret_cast<uint4*>(dst + r * S + vc) = raw;
  }
}
template <int DP, typename F>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows, int n,
                                          int hd, bool normalise, F factor, int tid,
                                          int n_threads) {
  constexpr int SQ = DP + 1, VPR = DP / 4;
  for (int idx = tid; idx < rows * VPR; idx += n_threads) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 4;
    const bool live = row0 + r < n;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && vc < hd) {
      f = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * hd + vc));
    }
    float rn = 1.f;
    if (normalise) {
      float ss = sumsq4(f);
#pragma unroll
      for (int off = 1; off < VPR; off <<= 1) ss += __shfl_xor_sync(kFull, ss, off);
      rn = inv_norm(ss);
    }
    const float fac = live ? factor(row0 + r) : 0.f;
    float* d = dst + r * SQ + vc;
    d[0] = __fmul_rn(__fmul_rn(f.x, rn), fac);
    d[1] = __fmul_rn(__fmul_rn(f.y, rn), fac);
    d[2] = __fmul_rn(__fmul_rn(f.z, rn), fac);
    d[3] = __fmul_rn(__fmul_rn(f.w, rn), fac);
  }
}

struct Params {
  const void *q, *k, *v, *o, *g;
  const float *bias, *scale;
  float4* stats;  // (bh, n): m, 1 / z, c, alpha of each query row
  void *dq, *dk, *dv;
  float* dbias;
  int n, hd, tiles, g_size, n_groups;
};

__device__ __forceinline__ int group_of(const Params& p, int bh) {
  return (bh / p.g_size) % p.n_groups;
}

// ---------------------------------------------------------------------------
// bf16: a prep pass, one main pass, a finishing pass (the file's header).

constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kUnitKeys = 128;      // keys of one unit of the main pass
constexpr int kBiasTile = kT * kT * 4;  // a 64 x 64 f32 bias tile

// Byte offset of f32 element (r, c) of a bias (or dbias) tile of 64 rows in
// shared memory: boxes of 64 rows x 32 columns side by side, each row 128
// bytes with its 16-byte chunks swizzled by r % 8, as the copy engine's
// 128-byte swizzle writes and reads them.
__device__ __forceinline__ int bias_offset(int r, int c) {
  return (c >> 5) * (kT * 128) + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// Rows [r0, r0 + rows) of an (n, hd) bf16 matrix into rows t0 .. of a
// panel-layout tile of `tile_rows` rows (wgmma.cuh); with `normalise` each
// row times its inverse norm in f32, rounded once (load_rows' arithmetic).
// Zeros past n and in the head's padding. The DP / 8 lanes of a row are
// neighbours and rows * DP / 8 is a multiple of n_threads (whole warps).
template <int DP>
__device__ __forceinline__ void load_panel(unsigned char* dst, int tile_rows, int t0,
                                           const bf16* src, int r0, int rows, int n, int hd,
                                           bool normalise, int tid, int n_threads) {
  constexpr int VPR = DP / 8;
#pragma unroll 4
  for (int idx = tid; idx < rows * VPR; idx += n_threads) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < n && vc < hd) {
      raw = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(r0 + r) * hd + vc));
    }
    if (normalise) {
      float ss = sumsq8(raw);
#pragma unroll
      for (int off = 1; off < VPR; off <<= 1) ss += __shfl_xor_sync(kFull, ss, off);
      const float rn = inv_norm(ss);
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 t = __bfloat1622float2(p[i]);
        p[i] = __floats2bfloat162_rn(__fmul_rn(t.x, rn), __fmul_rn(t.y, rn));
      }
    }
    *reinterpret_cast<uint4*>(dst + panel_offset<DP>(tile_rows, t0 + r, vc)) = raw;
  }
}

// Eight bf16 values as f32.
__device__ __forceinline__ void unpack8(uint4 raw, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 raw;
  uint32_t* p = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
  return raw;
}

// 2^x by the special-function unit (ex2.approx, 2 ulp; results below 2^-126
// flush to zero: e only weighs a bf16 product and an f32 sum of order 1).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- the prep pass ---------------------------------------------------------
// A block owns `images` (4, 2 or 1: as many as whose K fit) rows of one group
// and a run of q_per_block query tiles; warpgroup w owns row w with its kh
// resident (panel layout), warp 16 streams the group's 64 x 64 bias tiles
// once for all rows through a TMA ring (K4's producer, one pass). Per query
// tile each warp stages its 16 rows of qh for ldmatrix; per pair of key
// tiles s = qh kh^T by wgmma (both products in flight at once), s2, and each
// lane's running max and z of its share of a row (exp2_fast, no shuffles); the
// row's four lanes then agree on m and add their z rescaled to it. Then per
// row: c = rowsum(g o), 1 / z, and qh, qz = qh32 (scale / z), gz = g / z
// rounded to bf16 for the main pass; stats = (m, 1 / z, c, 0).
constexpr int kPrepConsumers = 16;                     // warps: four warpgroups
constexpr int kPrepThreads = (kPrepConsumers + 1) * 32;  // and the producer warp

struct PrepLayout {  // byte offsets in the block's 1024-aligned shared memory
  int k_bytes;       // one row's kh, [n_pad][DP] in the panel layout
  int q;             // per consumer warp: 16 query rows at stride DP + 8
  int ring;          // `stages` bias tiles
  int bars;          // full[stages], then empty[stages]
  int total;         // with 1024 bytes to align the start
};

__host__ __device__ inline PrepLayout prep_layout(int dp, int n_pad, int images, int stages) {
  PrepLayout l;
  l.k_bytes = n_pad * dp * 2;
  l.q = images * l.k_bytes;
  l.ring = (l.q + images * 4 * 16 * (dp + 8) * 2 + 1023) / 1024 * 1024;
  l.bars = l.ring + stages * kBiasTile;
  l.total = l.bars + 2 * stages * 8 + 1024;
  return l;
}

template <int DP, bool COS>
__global__ void __launch_bounds__(kPrepThreads, 1) window_bwd_prep(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ o,
    const bf16* __restrict__ go, const __grid_constant__ CUtensorMap bias_map,
    const float* __restrict__ scale, float4* __restrict__ stats, bf16* __restrict__ qh_out,
    bf16* __restrict__ qz_out, bf16* __restrict__ gz_out, int n, int hd, int g_size, int images,
    int stages, int q_per_block) {
  constexpr int S = DP + 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  const int n_pad = (n + kT - 1) / kT * kT, tiles = n_pad / kT;
  const PrepLayout lay = prep_layout(DP, n_pad, images, stages);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* const empty = full + stages;
  unsigned char* const ring = smem + lay.ring;

  // the block: (group, its rows row0 .., a run of query tiles)
  const int chunks = (tiles + q_per_block - 1) / q_per_block;
  const int per_group = (g_size + images - 1) / images;
  const int rest = blockIdx.x / chunks, chunk = blockIdx.x - rest * chunks;
  const int group = rest / per_group;
  const int row0 = group * g_size + (rest - group * per_group) * images;
  const int live_images = min(images, (group + 1) * g_size - row0);
  const int qt0 = chunk * q_per_block, qt1 = min(tiles, qt0 + q_per_block);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + st, 1);                  // the producer, once its copies land
      mbar_init(empty + st, 4 * live_images);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kPrepConsumers) {  // the producer: the group's bias tiles, in the consumers' order
    if (lane != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int qt = qt0; qt < qt1; ++qt) {
      for (int kt = 0; kt < tiles; ++kt) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* const dst = ring + kBiasTile * stage;
        mbar_arrive_expect_tx(full + stage, kBiasTile);  // two 64 x 32 boxes, zeros outside
        tma_load(dst, &bias_map, kt * kT, qt * kT, group, full + stage);
        tma_load(dst + kT * 128, &bias_map, kt * kT + 32, qt * kT, group, full + stage);
        if (++stage == stages) stage = 0, phase ^= 1;
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3, wt = tid & 127;
  if (wg >= live_images) return;  // a group's odd last row leaves this warpgroup idle
  const int row = row0 + wg;
  const size_t base = static_cast<size_t>(row) * n * hd;
  const float sc = scale[group], csc = __fmul_rn(sc, kLog2e);
  unsigned char* const k_s = smem + wg * lay.k_bytes;
  const uint32_t k_tile = smem_addr(k_s);
  load_panel<DP>(k_s, n_pad, 0, k + base, 0, n_pad, n, hd, COS, wt, 128);
  fence_async_smem();
  named_barrier(1 + wg, 128);

  bf16* const q_w = reinterpret_cast<bf16*>(smem + lay.q) + warp * 16 * S;
  auto one = [](int) { return 1.f; };
  int stage = 0;
  uint32_t phase = 0;
  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * kT + 16 * wq;  // this warp's 16 rows
    __syncwarp();
    load_rows<DP>(q_w, q + base, q0, 16, n, hd, COS, one, lane, 32);
    __syncwarp();
    uint32_t qf[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      ldmatrix_x4(qf[kk], q_w + (lane & 15) * S + kk * 16 + (lane >> 4) * 8);
    }
    // s2 of key tiles kt, kt + 1 (two products in flight, then the two
    // tiles' bias and the running max and z of each lane's share of its rows)
    float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f};
    for (int kt = 0; kt < tiles; kt += 2) {
      float s[2][32];
      const int pair = min(2, tiles - kt);
      wgmma_fence();
#pragma unroll
      for (int p2 = 0; p2 < 2; ++p2) {
        if (p2 < pair) {
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk) {
            Wgmma<64>::rs<0>(s[p2], qf[kk],
                             desc_k_major<DP>(k_tile, n_pad, (kt + p2) * kT, kk * 16), kk);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s[0]);
      fence_regs(s[1]);
#pragma unroll
      for (int p2 = 0; p2 < 2; ++p2) {
        if (p2 == pair) break;
        float (&sp)[32] = s[p2];
        const int k0 = (kt + p2) * kT;
        mbar_wait(full + stage, phase);
        const unsigned char* const bt = ring + stage * kBiasTile;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 b = *reinterpret_cast<const float2*>(
                bt + bias_offset(16 * wq + g + 8 * h, 8 * j + 2 * t));
            sp[4 * j + 2 * h] = logit2(sp[4 * j + 2 * h], csc, __fmul_rn(b.x, kLog2e));
            sp[4 * j + 2 * h + 1] = logit2(sp[4 * j + 2 * h + 1], csc, __fmul_rn(b.y, kLog2e));
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == stages) stage = 0, phase ^= 1;
        if (k0 + kT > n) {  // the ragged last tile
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= n) sp[i] = -INFINITY;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // every lane holds a live key of the first tile
          float mx = m[h];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            mx = fmaxf(mx, fmaxf(sp[4 * j + 2 * h], sp[4 * j + 2 * h + 1]));
          }
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sum += exp2_fast(sp[4 * j + 2 * h] - mx) + exp2_fast(sp[4 * j + 2 * h + 1] - mx);
          }
          z[h] = z[h] * exp2_fast(m[h] - mx) + sum;
          m[h] = mx;
        }
      }
    }
    fence_regs(qf);

    // rows q0 + g (h = 0) and q0 + g + 8: the row's max over the quad's four
    // lanes, each lane's z moved to it, summed; the lanes take columns 8 t + 32 i
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(m[h], __shfl_xor_sync(kFull, m[h], 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      z[h] *= exp2_fast(m[h] - mx);
      m[h] = mx;
      z[h] += __shfl_xor_sync(kFull, z[h], 1);
      z[h] += __shfl_xor_sync(kFull, z[h], 2);
      const int r = q0 + g + 8 * h;
      const bool live = r < n;
      const size_t off = base + static_cast<size_t>(min(r, n - 1)) * hd;
      constexpr int VL = (DP + 31) / 32;  // the lane's vectors of the row: columns 8 t + 32 i
      uint4 rq[VL], rg[VL], ro[VL];       // every load of the row in flight at once
#pragma unroll
      for (int i = 0; i < VL; ++i) {
        const int vc = 8 * t + 32 * i;
        rq[i] = rg[i] = ro[i] = make_uint4(0, 0, 0, 0);
        if (vc < hd) {
          rq[i] = __ldg(reinterpret_cast<const uint4*>(q + off + vc));
          rg[i] = __ldg(reinterpret_cast<const uint4*>(go + off + vc));
          ro[i] = __ldg(reinterpret_cast<const uint4*>(o + off + vc));
        }
      }
      // c = rowsum(g o); the sum of squares of q in row_inv_norm's pairwise tree
      // (each vector's over the quad's butterfly, then the two halves of hd 64)
      float c = 0.f, qss = 0.f;
#pragma unroll
      for (int i = 0; i < VL; ++i) {
        float gv[8], ov[8];
        unpack8(rg[i], gv);
        unpack8(ro[i], ov);
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2) c = fmaf(gv[k2], ov[k2], c);
        float ss = sumsq8(rq[i]);
        ss += __shfl_xor_sync(kFull, ss, 1);
        ss += __shfl_xor_sync(kFull, ss, 2);
        qss = i == 0 ? ss : qss + ss;
      }
      c += __shfl_xor_sync(kFull, c, 1);
      c += __shfl_xor_sync(kFull, c, 2);
      if (!live) continue;
      const float zinv = 1.f / z[h], szr = __fmul_rn(sc, zinv);
      const float qinv = COS ? inv_norm(qss) : 1.f;
#pragma unroll
      for (int i = 0; i < VL; ++i) {
        const int vc = 8 * t + 32 * i;
        if (vc >= hd) continue;
        float x[8], gv[8], qz[8];
        unpack8(rq[i], x);
        unpack8(rg[i], gv);
#pragma unroll
        for (int k2 = 0; k2 < 8; ++k2) {
          if (COS) x[k2] = __fmul_rn(x[k2], qinv);  // qh32
          qz[k2] = __fmul_rn(x[k2], szr);
          gv[k2] = __fmul_rn(gv[k2], zinv);
        }
        *reinterpret_cast<uint4*>(qh_out + off + vc) = pack8(x);
        *reinterpret_cast<uint4*>(qz_out + off + vc) = pack8(qz);
        *reinterpret_cast<uint4*>(gz_out + off + vc) = pack8(gv);
      }
      if (t == 0) stats[static_cast<size_t>(row) * n + r] = make_float4(m[h], zinv, c, 0.f);
    }
  }
}

// The bulk groups this thread committed before its last one are complete.
__device__ __forceinline__ void bulk_wait_older() {
  asm volatile("cp.async.bulk.wait_group 1;\n" ::: "memory");
}

// --- the main pass ---------------------------------------------------------
// A block per SM takes units of (folded row, 128 keys) in the order that
// unit_of and next_unit give. Warpgroup w holds keys 64 w .. 64 w + 63 of the unit (kh
// normalised, v) in the panel layout; warp 8 streams per query tile the
// unit's 64 x 128 bias tile (four TMA boxes), the row's qh, g, qz, gz tiles
// (a box a panel) and its (m, 1 / z, c) through a ring, counted in bytes on a
// full mbarrier. Per query tile each warpgroup forms s^T = kh qh^T and dp^T =
// v g^T once (wgmma, both operands from shared memory), then per score s2, e,
// t = e (dp - c) and t / z, which it writes over the bias value it read: the
// stage's bias tile becomes the unit's dbias part. dv += e^T gz and dk += t^T
// qz (wgmma, e and t rounded to bf16 as A from registers); t^T goes to shared
// memory, and the warpgroup's dq part t kh over its own 64 keys (run under the
// next tile's s^T and dp^T) is staged in f32 over two of the stage's operand
// tiles once both warpgroups are done with the stage (a `consumed` mbarrier
// per stage): so the warpgroups share no barrier inside a tile and drift
// apart, one's exponentials under the other's products. Warp 9 + s adds the
// two parts (warpgroup 0's plus 1's) and takes ring stage s's parts into
// device memory with the copy engine, in a fixed order: the dq part into
// an f32 sum after the row's earlier key units (a counter per (row, query
// tile)), the dbias part into dbias after the group's earlier rows (a counter
// per (group, query tile, key unit)); the first part of each is stored, the
// later ones added by cp.reduce.async.bulk.tensor, in two bulk groups so that
// each counter moves on once its own add is done in device memory. Every wait
// is for a unit of lower index, which a resident block holds or has done, so
// the order cannot deadlock.
constexpr int kBwdThreads = 12 * 32;  // two consumer warpgroups; the producer and reducers

template <int DP>
struct BwdLayout {  // byte offsets in the block's 1024-aligned shared memory
  static constexpr int kStages = DP <= 32 ? 3 : 2;
  static constexpr int kTile = kT * DP * 2;            // one query tile of one operand
  static constexpr int kKV = kUnitKeys * DP * 2;       // the unit's kh (or v)
  static constexpr int kBias = kT * kUnitKeys * 4;     // the unit's bias, then dbias, tile
  static constexpr int kStage = kBias + 4 * kTile + kT * 16;  // bias, qh, g, qz, gz, stats
  static constexpr int kK = 0, kV = kKV, kRing = 2 * kKV;
  static constexpr int kTT = kRing + kStages * kStage;  // t^T: [2 parities][2 warpgroups]
  static constexpr int kTBytes = kT * kT * 2;
  static constexpr int kBars = kTT + 4 * kTBytes;
  static constexpr int kTotal = kBars + 4 * kStages * 8 + 1024;
};

// Units in (level, group, key unit) order, the folded row group g_size + level:
// the rows of one level follow each other group by group, so that the unit a
// dbias add waits for (the level before, G U units earlier) is mostly done
// in the wave before; a row's key units are neighbours (its dq chain).
struct Unit {
  int row, group, level, u;
};
__device__ __forceinline__ Unit unit_of(long long x, int units, int groups, int g_size) {
  const long long per_level = static_cast<long long>(groups) * units;
  const int level = static_cast<int>(x / per_level);
  const int rest = static_cast<int>(x - level * per_level);
  const int group = rest / units, u = rest - group * units;
  return {group * g_size + level, group, level, u};
}

// The units a block takes, in increasing order: every gridDim-th unit, or
// (`rowwise`) all key units of every gridDim-th row, so that a row's dq parts
// come from one block in order and only the dbias chain runs across blocks.
// The launcher takes rows where a wave's rows spread over many groups (its
// dbias chains then have few links a wave).
__device__ __forceinline__ long long first_unit(bool rowwise, int units) {
  return rowwise ? static_cast<long long>(blockIdx.x) * units : blockIdx.x;
}
__device__ __forceinline__ long long next_unit(long long x, bool rowwise, int units) {
  if (!rowwise) return x + gridDim.x;
  return (x + 1) % units ? x + 1 : x + 1 + static_cast<long long>(gridDim.x - 1) * units;
}

// Warpgroup wg's dq part of one query tile: t kh over its own 64 keys (its
// t^T from shared memory as the MN-major A, kh rows k0 .. k0 + 63), all DP
// columns, issued asynchronously.
template <int DP>
__device__ __forceinline__ void dq_issue(float (&acc)[DP / 2], uint32_t t_tile, uint32_t k_tile,
                                         int k0) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    Wgmma<DP>::template ss<1, 1>(acc, make_desc(t_tile + kk * 16 * 128, 8192, 1024, 1),
                                 desc_mn_major<DP>(k_tile, kUnitKeys, k0 + 16 * kk, 0), kk);
  }
  wgmma_commit();
}

// Byte offset of dq element (r, c) in the f32 staging tile: boxes of 64 rows
// x 16 columns, each row 64 bytes with its 16-byte chunks swizzled by
// (r / 2) % 4, as the copy engine reads them.
__device__ __forceinline__ int staging_offset(int r, int c) {
  return (c >> 4) * (kT * 64) + r * 64 + ((((c & 15) >> 2) ^ ((r >> 1) & 3)) << 4) + (c & 3) * 4;
}

// The landed dq part into the warpgroup's staging tile, then the stage (with
// its t / z tile) handed to its reducer on `ready`.
template <int DP>
__device__ __forceinline__ void dq_hand_over(const float (&acc)[DP / 2], unsigned char* staging,
                                             uint64_t* ready, int wq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      *reinterpret_cast<float2*>(staging + staging_offset(16 * wq + g + 8 * h, 8 * j + 2 * t)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  fence_async_smem();  // the copy engine reads the stage through the asynchronous proxy
  __syncwarp();
  if (lane == 0) mbar_arrive(ready);
}

struct MainMaps {  // the copy engine's tensor maps, passed by value
  CUtensorMap qh, g, qz, gz, stats, bias, dq, dbias;
};

template <int DP, bool COS>
__global__ void __launch_bounds__(kBwdThreads, 1) window_bwd_main(
    const bf16* __restrict__ k, const bf16* __restrict__ v, const __grid_constant__ MainMaps maps,
    const float* __restrict__ scale, bf16* __restrict__ dk, bf16* __restrict__ dv,
    int* __restrict__ dq_count, int* __restrict__ db_count, int n, int hd, int groups,
    int g_size, int rowwise) {
  using L = BwdLayout<DP>;
  constexpr int kS = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* const empty = full + kS;
  uint64_t* const dq_ready = empty + kS;
  uint64_t* const consumed = dq_ready + kS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int units = (n + kUnitKeys - 1) / kUnitKeys, q_tiles = (n + kT - 1) / kT;
  const long long total = static_cast<long long>(groups) * g_size * units;

  if (tid == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(full + st, 1);      // the producer, once its copies land
      mbar_init(empty + st, 1);     // its reducer, once the copy engine has read the stage
      mbar_init(dq_ready + st, 8);  // one arrival per consumer warp
      mbar_init(consumed + st, 8);  // one per consumer warp, once it is done reading the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the third warpgroup gives (168 - 40) x 128 registers to the consumers
    regs_shrink<40>();
    if (warp - 9 >= kS) return;
    if (warp >= 9) {  // reducer 9 + s: ring stage s's dq and dbias parts, in their fixed orders
      const int stage = warp - 9;
      int it = 0;
      for (long long x = first_unit(rowwise, units); x < total; x = next_unit(x, rowwise, units)) {
        const Unit un = unit_of(x, units, groups, g_size);
        for (int i = 0; i < q_tiles; ++i, ++it) {
          if (it % kS != stage) continue;
          mbar_wait(dq_ready + stage, (it / kS) & 1);
          unsigned char* const src = smem + L::kRing + stage * L::kStage;
          {  // the unit's dq part: warpgroup 0's plus warpgroup 1's, into the first
            float4* const p0 = reinterpret_cast<float4*>(src + L::kBias);
            const float4* const p1 = reinterpret_cast<const float4*>(src + L::kBias + 2 * L::kTile);
            for (int vi = lane; vi < kT * DP / 4; vi += 32) {
              float4 a = p0[vi];
              const float4 b = p1[vi];
              a.x += b.x;
              a.y += b.y;
              a.z += b.z;
              a.w += b.w;
              p0[vi] = a;
            }
            fence_async_smem();  // the copy engine reads it through the asynchronous proxy
            __syncwarp();
          }
          if (lane != 0) continue;
          int* const cq = dq_count + static_cast<size_t>(un.row) * q_tiles + i;
          int* const cb = db_count + (static_cast<size_t>(un.group) * q_tiles + i) * units + un.u;
          while (ld_acquire_gpu(cq) != un.u) {
          }
          fence_async_global();
          for (int c0 = 0; c0 < hd; c0 += 16) {  // a box of 16 columns; rows past N not written
            const unsigned char* const part = src + L::kBias + c0 * (kT * 4);
            if (un.u == 0) {  // the first key unit's part is the sum so far
              tma_store(&maps.dq, c0, i * kT, un.row, part);
            } else {
              tma_reduce_add(&maps.dq, c0, i * kT, un.row, part);
            }
          }
          bulk_commit();
          while (ld_acquire_gpu(cb) != un.level) {
          }
          fence_async_global();
          for (int kb = 0; kb < 4; ++kb) {  // boxes of 32 keys; columns past N not written
            const int kc = un.u * kUnitKeys + 32 * kb;
            if (kc >= n) break;
            if (un.level == 0) {  // the group's first row's part is the sum so far
              tma_store(&maps.dbias, kc, i * kT, un.group, src + kb * (kT * 128));
            } else {
              tma_reduce_add(&maps.dbias, kc, i * kT, un.group, src + kb * (kT * 128));
            }
          }
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(empty + stage);
          // each part added in device memory: the next unit in its order may add
          bulk_wait_older();  // the dq group (the dbias group may be in flight)
          fence_async_global();
          __threadfence();
          st_release_gpu(cq, un.u + 1);
          bulk_wait();
          fence_async_global();
          __threadfence();
          st_release_gpu(cb, un.level + 1);
        }
      }
      return;
    }
    // warp 8, the producer: every unit's query tiles, in the consumers' order
    if (lane != 0) return;
    using P = Panels<DP>;
    const CUtensorMap* const ops[4] = {&maps.qh, &maps.g, &maps.qz, &maps.gz};
    int it = 0;
    for (long long x = first_unit(rowwise, units); x < total; x = next_unit(x, rowwise, units)) {
      const Unit un = unit_of(x, units, groups, g_size);
      for (int i = 0; i < q_tiles; ++i, ++it) {
        const int stage = it % kS;
        mbar_wait(empty + stage, ((it / kS) & 1) ^ 1);
        unsigned char* const dst = smem + L::kRing + stage * L::kStage;
        // every box reads zeros outside its tensor (rows past N, columns past
        // N or hd), so the stage's bytes are always the whole stage
        mbar_arrive_expect_tx(full + stage, L::kStage);
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          tma_load(dst + kb * (kT * 128), &maps.bias, un.u * kUnitKeys + 32 * kb, i * kT, un.group,
                   full + stage);
        }
#pragma unroll
        for (int op = 0; op < 4; ++op) {
#pragma unroll
          for (int pn = 0; pn < P::kCount; ++pn) {
            tma_load(dst + L::kBias + op * L::kTile + pn * kT * P::kRowBytes, ops[op],
                     pn * P::kWidth, i * kT, un.row, full + stage);
          }
        }
        tma_load(dst + L::kBias + 4 * L::kTile, &maps.stats, 0, i * kT, un.row, full + stage);
      }
    }
    return;
  }
  regs_grow<232>();

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3, wt = tid & 127;
  unsigned char* const k_s = smem + L::kK;
  unsigned char* const v_s = smem + L::kV;
  const uint32_t k_tile = smem_addr(k_s), v_tile = smem_addr(v_s);
  const uint32_t ring = smem_addr(smem + L::kRing);
  auto ops = [&](int stage) { return smem + L::kRing + stage * L::kStage + L::kBias; };
  // the operand tiles of stage st are free once both warpgroups are done with
  // it: then this warpgroup's dq part goes over two of them (qh, g or qz, gz)
  auto hand_over = [&](const float (&part)[DP / 2], int step) {
    const int st = step % kS;
    __syncwarp();
    if (lane == 0) mbar_arrive(consumed + st);
    mbar_wait(consumed + st, (step / kS) & 1);
    dq_hand_over<DP>(part, ops(st) + wg * 2 * L::kTile, dq_ready + st, wq, lane);
  };
  int it = 0;
  for (long long x = first_unit(rowwise, units); x < total; x = next_unit(x, rowwise, units)) {
    const Unit un = unit_of(x, units, groups, g_size);
    const int k0 = un.u * kUnitKeys;
    const size_t row0 = static_cast<size_t>(un.row) * n;
    const float csc = __fmul_rn(scale[un.group], kLog2e);
    // this warpgroup's 64 keys of kh (normalised with the cosine) and v; only
    // its own products read them, and those of the last unit are done
    load_panel<DP>(k_s, kUnitKeys, kT * wg, k + row0 * hd, k0 + kT * wg, kT, n, hd, COS, wt, 128);
    load_panel<DP>(v_s, kUnitKeys, kT * wg, v + row0 * hd, k0 + kT * wg, kT, n, hd, false, wt,
                   128);
    fence_async_smem();
    named_barrier(2 + wg, 128);

    const int key = k0 + kT * wg + 16 * wq + g;  // this thread's key rows: key, key + 8
    const bool live_key[2] = {key < n, key + 8 < n};

    // Per query tile: s^T, dp^T (issued at the end of the tile before); e, t
    // and t / z over the bias; dv, dk; t^T shared within the warpgroup; its dq
    // part issued, and the next tile's s^T, dp^T after it, so that the dq
    // product runs under them; the dq part handed over at the start of the
    // next tile. The two warpgroups meet only where a stage's tiles are reused.
    float dk_acc[DP / 2], dv_acc[DP / 2], s[32], dp[32], dq_part[DP / 2];
    uint32_t ef[4][4], tf[4][4];  // e^T and t^T rounded to bf16, as A fragments
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    auto issue_scores = [&](int step) {  // s^T = kh qh^T, dp^T = v g^T: 64 keys x 64 queries
      const int stage = step % kS;
      mbar_wait(full + stage, (step / kS) & 1);
      const uint32_t tiles = ring + stage * L::kStage + L::kBias;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        Wgmma<64>::ss<0, 0>(s, desc_k_major<DP>(k_tile, kUnitKeys, kT * wg, 16 * kk),
                            desc_k_major<DP>(tiles, kT, 0, 16 * kk), kk);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        Wgmma<64>::ss<0, 0>(dp, desc_k_major<DP>(v_tile, kUnitKeys, kT * wg, 16 * kk),
                            desc_k_major<DP>(tiles + L::kTile, kT, 0, 16 * kk), kk);
      }
      wgmma_commit();
    };

    issue_scores(it);
    for (int i = 0; i < q_tiles; ++i, ++it) {
      const int stage = it % kS;
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(ef);
      fence_regs(tf);
      if (i > 0) {
        fence_regs(dq_part);
        hand_over(dq_part, it - 1);
      }
      const uint32_t tiles = ring + stage * L::kStage + L::kBias;

      // per score: s2, e = exp2(s2 - m) (0 on dead keys), t = e (dp - c), and
      // t / z written over the bias value it was formed from
      unsigned char* const bt = smem + L::kRing + stage * L::kStage;
      const float4* const mzc = reinterpret_cast<const float4*>(ops(stage) + 4 * L::kTile);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 rq[2] = {mzc[8 * j + 2 * t], mzc[8 * j + 2 * t + 1]};  // (m, 1 / z, c, 0)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 r = rq[e & 1];
          float* const slot = reinterpret_cast<float*>(
              bt + bias_offset(8 * j + 2 * t + (e & 1), kT * wg + 16 * wq + g + 8 * (e >> 1)));
          const float s2 = logit2(s[4 * j + e], csc, __fmul_rn(*slot, kLog2e));
          const float ev = live_key[e >> 1] ? exp2_fast(s2 - r.x) : 0.f;
          const float tv = ev * (dp[4 * j + e] - r.z);
          *slot = __fmul_rn(tv, r.y);
          dp[4 * j + e] = tv;
          s[4 * j + e] = ev;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ef[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          tf[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
      }
      // t^T into this warpgroup's [key][query] tile of the parity, 128-byte swizzled
      unsigned char* const tb = smem + L::kTT + ((it & 1) * 2 + wg) * L::kTBytes;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wq + g + 8 * h;
          *reinterpret_cast<uint32_t*>(tb + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
              tf[j >> 1][2 * (j & 1) + h];
        }
      }

      // dv += e^T gz, dk += t^T qz
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Wgmma<DP>::template rs<1>(dv_acc, ef[kk],
                                  desc_mn_major<DP>(tiles + 3 * L::kTile, kT, 16 * kk, 0), 1);
        Wgmma<DP>::template rs<1>(dk_acc, tf[kk],
                                  desc_mn_major<DP>(tiles + 2 * L::kTile, kT, 16 * kk, 0), 1);
      }
      wgmma_commit();
      fence_async_smem();           // t^T written through the generic proxy
      named_barrier(2 + wg, 128);   // the warpgroup's t^T is in
      dq_issue<DP>(dq_part, smem_addr(tb), k_tile, kT * wg);
      if (i + 1 < q_tiles) issue_scores(it + 1);
    }
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(ef);
    fence_regs(tf);
    fence_regs(dq_part);
    hand_over(dq_part, it - 1);

    // dk = (dkh - kh32 beta) / |k| with the cosine (beta = rowsum(dkh kh32)), dv
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = live_key[h];
      const size_t off = (row0 + min(key + 8 * h, n - 1)) * hd;
      const float kinv = COS && live ? row_inv_norm<DP>(k + off, hd) : 1.f;
      float kh[DP / 8][2], b = 0.f;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = 8 * j + 2 * t + u;
          const float x = live && col < hd ? bf(k[off + col]) : 0.f;
          kh[j][u] = COS ? __fmul_rn(x, kinv) : x;
          b = __fadd_rn(b, __fmul_rn(dk_acc[4 * j + 2 * h + u], kh[j][u]));
        }
      b += __shfl_xor_sync(kFull, b, 1);
      b += __shfl_xor_sync(kFull, b, 2);
      if (!live) continue;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= hd) continue;
        float r2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float dkh = dk_acc[4 * j + 2 * h + u];
          r2[u] = COS ? __fmul_rn(__fsub_rn(dkh, __fmul_rn(kh[j][u], b)), kinv) : dkh;
        }
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) = __floats2bfloat162_rn(r2[0], r2[1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// --- the finishing pass ----------------------------------------------------
// Per query row, L = DP / 8 neighbouring lanes of eight columns each: dqh =
// (the summed t kh) (scale_g / z); alpha = rowsum(dqh qh32) into stats;
// dq = (dqh - qh32 alpha) / |q| with the cosine, rounded once.
template <int DP, bool COS>
__global__ void __launch_bounds__(256) window_bwd_finish(const bf16* __restrict__ q,
                                                     const float* __restrict__ acc,
                                                     const float* __restrict__ scale,
                                                     float4* __restrict__ stats,
                                                     bf16* __restrict__ dq, long long rows, int n,
                                                     int hd, int g_size) {
  constexpr int L = DP / 8;
  const int lane = threadIdx.x & 31;
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / L;
  const int vc = (lane % L) * 8;
  if (row >= rows) return;  // a row's L lanes leave together
  const unsigned mask = (L == 32 ? kFull : ((1u << L) - 1u) << (lane & ~(L - 1)));
  const bool live = vc < hd;
  const size_t off = static_cast<size_t>(row) * hd + vc;
  float qh[8], dqh[8];
  uint4 raw = make_uint4(0, 0, 0, 0);
  if (live) raw = __ldg(reinterpret_cast<const uint4*>(q + off));
  unpack8(raw, qh);
  float qinv = 1.f;
  if (COS) {
    float ss = sumsq8(raw);
#pragma unroll
    for (int o2 = 1; o2 < L; o2 <<= 1) ss += __shfl_xor_sync(mask, ss, o2);
    qinv = inv_norm(ss);
  }
  const float szr = __fmul_rn(scale[row / n / g_size], stats[row].y);
  float a = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (COS) qh[i] = __fmul_rn(qh[i], qinv);  // qh32
    dqh[i] = live ? __fmul_rn(__ldg(acc + off + i), szr) : 0.f;
    a = __fadd_rn(a, __fmul_rn(dqh[i], qh[i]));
  }
#pragma unroll
  for (int o2 = 1; o2 < L; o2 <<= 1) a += __shfl_xor_sync(mask, a, o2);
  if (vc == 0) stats[row].w = a;
  if (!live) return;
  float r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r[i] = COS ? __fmul_rn(__fsub_rn(dqh[i], __fmul_rn(qh[i], a)), qinv) : dqh[i];
  }
  *reinterpret_cast<uint4*>(dq + off) = pack8(r);
}

// ---------------------------------------------------------------------------
// f32: window_prep_f32 (each row's exact max m and z, on FMAs), the main
// pass window_bwd_f32_wg (3xTF32, attn_bwd_f32.cuh) and window_bwd_finish_f32.
// Prep thread (ty, tx) = (tid / 16, tid % 16) owns tile rows ty + 16 i
// (i < 4) and columns tx + 16 j (j < 4) of a 64 x 64 score tile; the 16
// threads of a row are half a warp.

namespace tb = tf32bwd;

// s = A B^T: rows ty + 16 i of a_s against rows tx + 16 j of b_s
template <int DP>
__device__ __forceinline__ void fma_tile(float (&s)[4][4], const float* a_s, const float* b_s,
                                         int ty, int tx) {
  constexpr int SQ = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a_s[(ty + 16 * i) * SQ + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * SQ + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// The operands the f32 main pass streams (Workspace): qh and the small
// parts of qh and g as (bh, n, hd); qz^T = (qh32 (scale_g / z))^T and
// gz^T = (g / z)^T as (bh, hd, n_pad), each big then small (`plane` elements
// apart), in slot_query's order.
struct F32Operands {
  float *qh, *qh_small, *g_small, *qzt, *gzt;
  size_t plane;
  int n_pad;
};

// One block per (folded row, 64-query tile): qh resident, the row's kh tiles
// streamed; s2 per score on FMAs and, per query row, the running max and z
// (z rescaled to each new max: it differs from the sum at the exact max by
// rounding only); then stats = (m, 1 / z, c, 0) and the main pass's operands.
template <int DP, bool COS>
__global__ void __launch_bounds__(256) window_prep_f32(Params p, F32Operands ops) {
  constexpr int SQ = DP + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const q_s = reinterpret_cast<float*>(smem);  // [kT][SQ] qh
  float* const k_s = q_s + kT * SQ;                    // [kT][SQ] kh, then g
  float* const zinv_s = k_s + kT * SQ;                 // [kT]
  float* const sz_s = zinv_s + kT;                     // [kT]
  const float *q = static_cast<const float*>(p.q), *k = static_cast<const float*>(p.k),
              *o = static_cast<const float*>(p.o), *go = static_cast<const float*>(p.g);
  const int n = p.n, hd = p.hd;
  const int bh = blockIdx.x / p.tiles, q0 = (blockIdx.x - bh * p.tiles) * kT;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int group = group_of(p, bh);
  const float sc = p.scale[group], csc = __fmul_rn(sc, kLog2e);
  const float* const bias_g = p.bias + static_cast<size_t>(group) * n * n;
  auto one = [](int) { return 1.f; };

  load_rows<DP>(q_s, q + base, q0, kT, n, hd, COS, one, tid, 256);
  int row[4];
  const float* b_row[4];
  float c_row[4], m[4], zp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty + 16 * i;
    b_row[i] = bias_g + static_cast<size_t>(min(row[i], n - 1)) * n;
    float sum = 0.f;
    if (row[i] < n) {
      const size_t off = base + static_cast<size_t>(row[i]) * hd;
      for (int d = tx; d < hd; d += 16) sum = fmaf(go[off + d], o[off + d], sum);
    }
    c_row[i] = half_warp_sum(sum);
    m[i] = -INFINITY;
    zp[i] = 0.f;
  }
  for (int tile = 0; tile < p.tiles; ++tile) {
    __syncthreads();
    load_rows<DP>(k_s, k + base, tile * kT, kT, n, hd, COS, one, tid, 256);
    __syncthreads();
    float s[4][4];
    fma_tile<DP>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tile * kT + tx + 16 * j;
        s[i][j] = col < n ? logit2(s[i][j], csc, __fmul_rn(__ldg(b_row[i] + col), kLog2e))
                          : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mx));  // every tile holds a live key
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += exp2f(s[i][j] - mn);
      zp[i] = zp[i] * exp2f(m[i] - mn) + sum;
      m[i] = mn;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float zinv = 1.f / half_warp_sum(zp[i]);
    const bool live = row[i] < n;
    if (tx == 0) {
      zinv_s[ty + 16 * i] = live ? zinv : 0.f;
      sz_s[ty + 16 * i] = live ? __fmul_rn(sc, zinv) : 0.f;
      if (live) p.stats[static_cast<size_t>(bh) * n + row[i]] = make_float4(m[i], zinv, c_row[i], 0.f);
    }
  }
  __syncthreads();
  load_rows<DP>(k_s, go + base, q0, kT, n, hd, false, one, tid, 256);
  __syncthreads();
  for (int idx = tid; idx < kT * hd; idx += 256) {
    const int r = idx / hd, d = idx - r * hd;
    if (q0 + r >= n) break;
    const size_t off = base + static_cast<size_t>(q0 + r) * hd + d;
    const float x = q_s[r * SQ + d];
    ops.qh[off] = x;
    ops.qh_small[off] = tf32_small(x);
    ops.g_small[off] = tf32_small(k_s[r * SQ + d]);
  }
  for (int idx = tid; idx < hd * kT; idx += 256) {
    const int d = idx >> 6, slot = idx & 63;
    const int r = tb::slot_query(slot);
    const size_t dst = (static_cast<size_t>(bh) * hd + d) * ops.n_pad + q0 + slot;
    const float x = __fmul_rn(q_s[r * SQ + d], sz_s[r]), y = __fmul_rn(k_s[r * SQ + d], zinv_s[r]);
    ops.qzt[dst] = x;
    ops.qzt[ops.plane + dst] = tf32_small(x);
    ops.gzt[dst] = y;
    ops.gzt[ops.plane + dst] = tf32_small(y);
  }
}

template <int DP>
struct F32Layout {  // byte offsets in the block's 1024-aligned shared memory
  using C = tb::Cfg<DP>;
  using St = tb::Stage<DP>;
  static constexpr int kQB = C::kQB, kStages = C::kStages;
  static constexpr int kUnit = tb::kUnitKeys * DP * 4;  // the unit's kh (or v), big or small
  static constexpr int kK = 0, kV = 2 * kUnit, kRing = 4 * kUnit;  // big, then small
  // in a stage, after the operands: the unit's bias (then dbias) tile, QB x
  // 64 f32 in two boxes of 32 keys, and the rows' (m, 1 / z, c, alpha)
  static constexpr int kBias = St::kOperands, kStats = kBias + kQB * 256;
  static constexpr int kStage = (kStats + kQB * 16 + 1023) / 1024 * 1024;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kTotal = kBars + 3 * kStages * 8 + 1024;
};

// Byte offset of f32 element (r, c) of a QB x 64 bias tile: boxes of QB rows
// x 32 columns, each row 128 bytes with its chunks swizzled by r % 8.
template <int QB>
__device__ __forceinline__ int bias_offset_f32(int r, int c) {
  return (c >> 5) * (QB * 128) + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

struct F32Maps {  // the copy engine's tensor maps, passed by value
  CUtensorMap qh, qh_small, g, g_small, qzt, qzt_small, gzt, gzt_small, stats, bias, dq, dbias;
};

// The bf16 main pass's walk (unit_of, next_unit) over units of (folded row,
// 64 keys) with two consumer warpgroups (warps 0-7: kh and v of the unit,
// big and small, resident; warpgroup w takes the query tiles of walk count
// w mod 2: s_cos^T and dp^T, s2 with the stage's bias, e, t and t / z written
// over the bias; dv, dk; t staged over the stage's consumed qh and g tiles
// and dq^T = kh^T t^T over its qz^T tiles; at the unit's end warpgroup 0
// stores its dkh, dv parts, warpgroup 1 adds its own and finishes dk), a
// producer (warp 8) and a reducer per stage (warp 9 + s: the dq part after
// the row's earlier key units, the dbias part after the group's earlier
// rows, each behind its counter, as the bf16 reducers order them).
template <int DP, bool COS>
__global__ void __launch_bounds__(tb::kThreads, 1) window_bwd_f32_wg(
    const float* __restrict__ k, const float* __restrict__ v, const __grid_constant__ F32Maps maps,
    const float* __restrict__ scale, float* __restrict__ dk, float* __restrict__ dv,
    int* __restrict__ dq_count, int* __restrict__ db_count, int n, int hd, int groups,
    int g_size, int rowwise) {
  using L = F32Layout<DP>;
  using St = tb::Stage<DP>;
  constexpr int QB = L::kQB, kS = L::kStages, MT = (DP + 63) / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* const empty = full + kS;
  uint64_t* const dq_ready = empty + kS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int units = (n + tb::kUnitKeys - 1) / tb::kUnitKeys, q_tiles = (n + QB - 1) / QB;
  const long long total = static_cast<long long>(groups) * g_size * units;

  if (tid == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(full + st, 1);      // the producer, once its copies land
      mbar_init(empty + st, 1);     // its reducer, once the copy engine has read the stage
      mbar_init(dq_ready + st, 4);  // one arrival per warp of the tile's warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the third warpgroup gives (168 - 40) x 128 registers to the consumers
    regs_shrink<40>();
    if (lane != 0 || warp - 9 >= kS) return;
    if (warp >= 9) {  // reducer 5 + s: ring stage s's dq and dbias parts, in their fixed orders
      const int stage = warp - 9;
      int it = 0;
      for (long long x = first_unit(rowwise, units); x < total; x = next_unit(x, rowwise, units)) {
        const Unit un = unit_of(x, units, groups, g_size);
        for (int i = 0; i < q_tiles; ++i, ++it) {
          if (it % kS != stage) continue;
          mbar_wait(dq_ready + stage, (it / kS) & 1);
          const unsigned char* const src = smem + L::kRing + stage * L::kStage;
          int* const cq = dq_count + static_cast<size_t>(un.row) * q_tiles + i;
          int* const cb = db_count + (static_cast<size_t>(un.group) * q_tiles + i) * units + un.u;
          while (ld_acquire_gpu(cq) != un.u) {
          }
          fence_async_global();
          for (int c0 = 0; c0 < hd; c0 += 16) {  // a box of 16 columns; rows past N not written
            const unsigned char* const part = src + St::kQzT + c0 * (QB * 4);
            if (un.u == 0) {  // the first key unit's part is the sum so far
              tma_store(&maps.dq, c0, i * QB, un.row, part);
            } else {
              tma_reduce_add(&maps.dq, c0, i * QB, un.row, part);
            }
          }
          bulk_commit();
          while (ld_acquire_gpu(cb) != un.level) {
          }
          fence_async_global();
          for (int kb = 0; kb < 2; ++kb) {  // boxes of 32 keys; columns past N not written
            const int kc = un.u * tb::kUnitKeys + 32 * kb;
            if (kc >= n) break;
            const unsigned char* const part = src + L::kBias + kb * (QB * 128);
            if (un.level == 0) {  // the group's first row's part is the sum so far
              tma_store(&maps.dbias, kc, i * QB, un.group, part);
            } else {
              tma_reduce_add(&maps.dbias, kc, i * QB, un.group, part);
            }
          }
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(empty + stage);
          // each part added in device memory: the next unit in its order may add
          bulk_wait_older();  // the dq group (the dbias group may be in flight)
          fence_async_global();
          __threadfence();
          st_release_gpu(cq, un.u + 1);
          bulk_wait();
          fence_async_global();
          __threadfence();
          st_release_gpu(cb, un.level + 1);
        }
      }
      return;
    }
    // warp 8, the producer: every unit's query tiles, in the consumers' order
    using P = Panels<2 * DP>;
    const CUtensorMap* const rows[4] = {&maps.qh, &maps.qh_small, &maps.g, &maps.g_small};
    const CUtensorMap* const cols[4] = {&maps.qzt, &maps.qzt_small, &maps.gzt, &maps.gzt_small};
    int it = 0;
    for (long long x = first_unit(rowwise, units); x < total; x = next_unit(x, rowwise, units)) {
      const Unit un = unit_of(x, units, groups, g_size);
      for (int i = 0; i < q_tiles; ++i, ++it) {
        const int stage = it % kS;
        mbar_wait(empty + stage, ((it / kS) & 1) ^ 1);
        unsigned char* const dst = smem + L::kRing + stage * L::kStage;
        // every box reads zeros outside its tensor (rows past N, columns past
        // N or hd), so the stage's bytes are always the whole stage
        mbar_arrive_expect_tx(full + stage, St::kOperands + QB * 256 + QB * 16);
#pragma unroll
        for (int op = 0; op < 4; ++op) {
#pragma unroll
          for (int pn = 0; pn < P::kCount; ++pn) {
            tma_load(dst + op * St::kTile + pn * QB * P::kRowBytes, rows[op], pn * P::kWidth / 2,
                     i * QB, un.row, full + stage);
          }
          tma_load(dst + St::kQzT + op * St::kTile, cols[op], i * QB, 0, un.row, full + stage);
        }
#pragma unroll
        for (int kb = 0; kb < 2; ++kb) {
          tma_load(dst + L::kBias + kb * (QB * 128), &maps.bias, un.u * tb::kUnitKeys + 32 * kb,
                   i * QB, un.group, full + stage);
        }
        tma_load(dst + L::kStats, &maps.stats, 0, i * QB, un.row, full + stage);
      }
    }
    return;
  }

  regs_grow<232>();
  // warpgroup wg takes the query tiles of parity wg (of the walk's count)
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  unsigned char* const k_s = smem + L::kK;
  unsigned char* const v_s = smem + L::kV;
  int it = 0;
  for (long long x = first_unit(rowwise, units); x < total; x = next_unit(x, rowwise, units)) {
    const Unit un = unit_of(x, units, groups, g_size);
    const int k0 = un.u * tb::kUnitKeys;
    const size_t row0 = static_cast<size_t>(un.row) * n;
    const float csc = __fmul_rn(scale[un.group], kLog2e);
    named_barrier(1, tb::kConsumers);  // the last unit's products have read kh and v
    tb::load_unit<DP>(k_s, k_s + L::kUnit, k + row0 * hd, k0, n, hd, COS, inv_norm, tid);
    tb::load_unit<DP>(v_s, v_s + L::kUnit, v + row0 * hd, k0, n, hd, false, inv_norm, tid);
    fence_async_smem();
    named_barrier(1, tb::kConsumers);

    const int key = k0 + 16 * wq + g;  // this thread's key rows: key, key + 8
    const bool live_key[2] = {key < n, key + 8 < n};
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
    for (int i = 0; i < q_tiles; ++i, ++it) {
      if ((it & 1) != wg) continue;
      const int stage = it % kS;
      unsigned char* const tiles = smem + L::kRing + stage * L::kStage;
      const uint32_t tiles_a = smem_addr(tiles);
      float s[QB / 2], dp[QB / 2];
      mbar_wait(full + stage, (it / kS) & 1);
      tb::scores_and_dp<DP, tb::kProductTerms>(s, dp, k_s, v_s, L::kUnit, tiles, wq, g, t);

      // per score: s2, e = exp2(s2 - m) (0 on dead keys), t = e (dp - c), and
      // t / z written over the bias value it was formed from
      const float4* const mzc = reinterpret_cast<const float4*>(tiles + L::kStats);
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
        const float4 rq[2] = {mzc[8 * j + 2 * t], mzc[8 * j + 2 * t + 1]};  // (m, 1 / z, c, 0)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 r = rq[e & 1];
          float* const slot = reinterpret_cast<float*>(
              tiles + L::kBias + bias_offset_f32<QB>(8 * j + 2 * t + (e & 1), 16 * wq + g + 8 * (e >> 1)));
          const float s2 = logit2(s[4 * j + e], csc, __fmul_rn(*slot, kLog2e));
          const float ev = live_key[e >> 1] ? exp2f(s2 - r.x) : 0.f;
          const float tv = ev * (dp[4 * j + e] - r.z);
          *slot = __fmul_rn(tv, r.y);
          dp[4 * j + e] = tv;
          s[4 * j + e] = ev;
        }
      }
      uint32_t eb[QB / 8][4], es[QB / 8][4], tb_[QB / 8][4], ts[QB / 8][4];
      tb::split_fragments<QB / 8>(s, eb, es);
      tb::split_fragments<QB / 8>(dp, tb_, ts);
      tb::issue_dkv<DP>(dv_acc, dk_acc, eb, es, tb_, ts, tiles_a);
      tb::stage_t<QB>(tiles + St::kQs, tb_, ts, wq, g, t);  // over the consumed qh, g tiles
      fence_async_smem();
      named_barrier(2 + wg, 128);  // every warp's t is in
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(eb);
      fence_regs(es);
      fence_regs(tb_);
      fence_regs(ts);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float dq_acc[QB / 2];
        tb::issue_dq<DP>(dq_acc, k_s, k_s + L::kUnit, tiles_a + St::kQs, mt, wq, g, t);
        tb::stage_dq<DP>(tiles + St::kQzT, dq_acc, mt, wq, g, t);  // over the consumed qz^T tiles
      }
      fence_async_smem();  // the copy engine reads the stage through the asynchronous proxy
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_ready + stage);
    }

    // dkh and dv: warpgroup 0's parts through the outputs, then warpgroup 1
    // adds its own to them (in that order) and finishes:
    // dk = (dkh - kh32 beta) / |k| with the cosine (beta = rowsum(dkh kh32)), dv
    if (wg == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!live_key[h]) continue;
        const size_t off = (row0 + key + 8 * h) * hd;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < hd) {
            *reinterpret_cast<float2*>(dk + off + col) =
                make_float2(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
            *reinterpret_cast<float2*>(dv + off + col) =
                make_float2(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    __threadfence_block();
    named_barrier(1, tb::kConsumers);
    if (wg == 0) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool live = live_key[h];
      const size_t off = (row0 + min(key + 8 * h, n - 1)) * hd;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (live && col < hd) {
          const float2 a = *reinterpret_cast<const float2*>(dk + off + col);
          const float2 c2 = *reinterpret_cast<const float2*>(dv + off + col);
          dk_acc[4 * j + 2 * h] = a.x + dk_acc[4 * j + 2 * h];
          dk_acc[4 * j + 2 * h + 1] = a.y + dk_acc[4 * j + 2 * h + 1];
          dv_acc[4 * j + 2 * h] = c2.x + dv_acc[4 * j + 2 * h];
          dv_acc[4 * j + 2 * h + 1] = c2.y + dv_acc[4 * j + 2 * h + 1];
        }
      }
      const float kinv = COS && live ? row_inv_norm<DP>(k + off, hd) : 1.f;
      float kh[DP / 8][2], b = 0.f;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int col = 8 * j + 2 * t + u;
          const float x = live && col < hd ? k[off + col] : 0.f;
          kh[j][u] = COS ? __fmul_rn(x, kinv) : x;
          b = __fadd_rn(b, __fmul_rn(dk_acc[4 * j + 2 * h + u], kh[j][u]));
        }
      b += __shfl_xor_sync(kFull, b, 1);
      b += __shfl_xor_sync(kFull, b, 2);
      if (!live) continue;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col >= hd) continue;
        float r2[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float dkh = dk_acc[4 * j + 2 * h + u];
          r2[u] = COS ? __fmul_rn(__fsub_rn(dkh, __fmul_rn(kh[j][u], b)), kinv) : dkh;
        }
        *reinterpret_cast<float2*>(dk + off + col) = make_float2(r2[0], r2[1]);
        *reinterpret_cast<float2*>(dv + off + col) =
            make_float2(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// Per query row, L = DP / 4 neighbouring lanes of four columns each: dqh =
// (the summed t kh) (scale_g / z); alpha = rowsum(dqh qh32) into stats;
// dq = (dqh - qh32 alpha) / |q| with the cosine.
template <int DP, bool COS>
__global__ void __launch_bounds__(256) window_bwd_finish_f32(const float* __restrict__ q,
                                                         const float* __restrict__ acc,
                                                         const float* __restrict__ scale,
                                                         float4* __restrict__ stats,
                                                         float* __restrict__ dq, long long rows,
                                                         int n, int hd, int g_size) {
  constexpr int L = DP / 4;
  const int lane = threadIdx.x & 31;
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / L;
  const int vc = (lane % L) * 4;
  if (row >= rows) return;  // a row's L lanes leave together
  const unsigned mask = (L == 32 ? kFull : ((1u << L) - 1u) << (lane & ~(L - 1)));
  const bool live = vc < hd;
  const size_t off = static_cast<size_t>(row) * hd + vc;
  const float4 raw = live ? __ldg(reinterpret_cast<const float4*>(q + off))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  float qinv = 1.f;
  if (COS) {
    float ss = sumsq4(raw);
#pragma unroll
    for (int o2 = 1; o2 < L; o2 <<= 1) ss += __shfl_xor_sync(mask, ss, o2);
    qinv = inv_norm(ss);
  }
  const float szr = __fmul_rn(scale[row / n / g_size], stats[row].y);
  const float x[4] = {raw.x, raw.y, raw.z, raw.w};
  float qh[4], dqh[4], a = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qh[i] = COS ? __fmul_rn(x[i], qinv) : x[i];  // qh32
    dqh[i] = live ? __fmul_rn(__ldg(acc + off + i), szr) : 0.f;
    a = __fadd_rn(a, __fmul_rn(dqh[i], qh[i]));
  }
#pragma unroll
  for (int o2 = 1; o2 < L; o2 <<= 1) a += __shfl_xor_sync(mask, a, o2);
  if (vc == 0) stats[row].w = a;
  if (!live) return;
  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = COS ? __fmul_rn(__fsub_rn(dqh[i], __fmul_rn(qh[i], a)), qinv) : dqh[i];
  }
  *reinterpret_cast<float4*>(dq + off) = make_float4(r[0], r[1], r[2], r[3]);
}

// The scratch xmir_window_attn_bwd takes as `stats`: each query row's (m,
// 1 / z, c, alpha) as (bh, n, 4) f32 first; in bf16 then qh, qz, gz (bh, n,
// hd) bf16, the dq sums (bh, n, hd) f32, a counter per (row, 64-row query
// tile) and one per (group, query tile, 128-key unit); in f32 then qh and the
// small parts of qh and g (bh, n, hd), qz^T and gz^T (bh, hd, n_pad) big and
// small, the dq sums (bh, n, hd), a counter per (row, 32-row query tile) and
// one per (group, query tile, 64-key unit). ops/vit_attn.py::
// biased_bwd_workspace_bytes gives the same total.
struct Workspace {
  size_t qh, qz, gz, dq, dq_count, db_count, bytes;
  size_t qh_small, g_small, qzt, gzt, plane;  // f32
};

Workspace workspace(int dtype, int bh, int n, int hd, int groups) {
  const size_t rows = static_cast<size_t>(bh) * n, elems = rows * hd;
  Workspace w{};
  w.qh = rows * 16;
  if (dtype == 0) {
    const size_t n_pad = (n + kT - 1) / kT * kT, q_tiles = (n + 31) / 32;
    const size_t units = (n + tf32bwd::kUnitKeys - 1) / tf32bwd::kUnitKeys;
    w.plane = static_cast<size_t>(bh) * hd * n_pad * 4;
    w.qh_small = w.qh + elems * 4;
    w.g_small = w.qh_small + elems * 4;
    w.qzt = w.g_small + elems * 4;
    w.gzt = w.qzt + 2 * w.plane;
    w.dq = w.gzt + 2 * w.plane;
    w.dq_count = w.dq + elems * 4;
    w.db_count = w.dq_count + static_cast<size_t>(bh) * q_tiles * 4;
    w.bytes = w.db_count + static_cast<size_t>(groups) * q_tiles * units * 4;
    return w;
  }
  const size_t q_tiles = (n + kT - 1) / kT, units = (n + kUnitKeys - 1) / kUnitKeys;
  w.qz = w.qh + elems * 2;
  w.gz = w.qz + elems * 2;
  w.dq = w.gz + elems * 2;
  w.dq_count = w.dq + elems * 4;
  w.db_count = w.dq_count + static_cast<size_t>(bh) * q_tiles * 4;
  w.bytes = w.db_count + static_cast<size_t>(groups) * q_tiles * units * 4;
  return w;
}

// q_per_block for the prep pass: the run of query tiles a block takes, the
// one with the fewest tiles on the longest SM's path (ties: the longer run).
int prep_run(long long row_blocks, int tiles, int sms) {
  int best = tiles;
  long long best_cost = -1;
  for (int qpb = tiles; qpb >= 1; --qpb) {
    const long long blocks = row_blocks * ((tiles + qpb - 1) / qpb);
    const long long cost = (blocks + sms - 1) / sms * qpb;
    if (best_cost < 0 || cost < best_cost) best = qpb, best_cost = cost;
  }
  return best;
}

// Once per device and instantiation (the launches' host time counts at the
// small shapes): the SM count, and each bf16 kernel's shared-memory limit
// raised to what any launch may ask.
template <int DP, bool COS>
cudaError_t prepare_bf16(int* sms) {
  constexpr int kDevices = 64;
  static int counts[kDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices) return cudaErrorInvalidDevice;
  int& count = counts[device];
  if (count == 0) {
    int c = 0;
    err = cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(window_bwd_prep<DP, COS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    }
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(window_bwd_main<DP, COS>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 BwdLayout<DP>::kTotal);
    }
    if (err != cudaSuccess) return err;
    count = c;
  }
  *sms = count;
  return cudaSuccess;
}

template <int DP, bool COS>
cudaError_t launch_bf16(const Params& p, int bh, cudaStream_t stream) {
  using T = bf16;
  const int n = p.n, hd = p.hd, groups = p.n_groups;
  int sms = 0;
  cudaError_t err = prepare_bf16<DP, COS>(&sms);
  if (err != cudaSuccess) return err;
  const Workspace w = workspace(1, bh, n, hd, groups);
  unsigned char* const ws = reinterpret_cast<unsigned char*>(p.stats);
  err = cudaMemsetAsync(ws + w.dq_count, 0, w.bytes - w.dq_count, stream);  // the counters
  if (err != cudaSuccess) return err;

  // the bias (and dbias) as (N columns, N rows, G slices), boxes of 32 x 64
  CUtensorMap bias_map, dbias_map;
  if (make_tensor_map(&bias_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.bias, n, n, groups,
                      static_cast<uint64_t>(n) * 4, static_cast<uint64_t>(n) * n * 4, 32, kT,
                      CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
      make_tensor_map(&dbias_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.dbias, n, n, groups,
                      static_cast<uint64_t>(n) * 4, static_cast<uint64_t>(n) * n * 4, 32, kT,
                      CU_TENSOR_MAP_SWIZZLE_128B) != 0) {
    return cudaErrorInvalidValue;
  }

  // prep: four rows a block where their kh fit, else two or one; three ring
  // stages, else two
  const int n_pad = (n + kT - 1) / kT * kT, tiles = n_pad / kT;
  int images = 0, stages = 0;
  for (int im = 4; im >= 1 && !images; im /= 2) {
    for (int st = 3; st >= 2 && !images; --st) {
      if (prep_layout(DP, n_pad, im, st).total <= kSmemLimit) images = im, stages = st;
    }
  }
  if (!images) return cudaErrorInvalidValue;
  const int prep_bytes = prep_layout(DP, n_pad, images, stages).total;
  const long long row_blocks = static_cast<long long>(groups) * ((p.g_size + images - 1) / images);
  const int qpb = prep_run(row_blocks, tiles, sms);
  const long long prep_blocks = row_blocks * ((tiles + qpb - 1) / qpb);
  if (prep_blocks > 2147483647LL) return cudaErrorInvalidValue;
  window_bwd_prep<DP, COS>
      <<<static_cast<unsigned>(prep_blocks), kPrepThreads, prep_bytes, stream>>>(
      static_cast<const T*>(p.q), static_cast<const T*>(p.k), static_cast<const T*>(p.o),
      static_cast<const T*>(p.g), bias_map, p.scale, p.stats, reinterpret_cast<T*>(ws + w.qh),
      reinterpret_cast<T*>(ws + w.qz), reinterpret_cast<T*>(ws + w.gz), n, hd, p.g_size, images,
      stages, qpb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // main: the streamed operands as (hd, N, BH), a box a panel; the stats as
  // (4, N, BH); the f32 dq sums as (hd, N, BH), boxes of 16 columns, 64-byte swizzled
  MainMaps maps;
  const void* const bases[4] = {ws + w.qh, p.g, ws + w.qz, ws + w.gz};
  CUtensorMap* const ops[4] = {&maps.qh, &maps.g, &maps.qz, &maps.gz};
  for (int op = 0; op < 4; ++op) {
    if (make_tensor_map(ops[op], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bases[op], hd, n, bh,
                        static_cast<uint64_t>(hd) * 2, static_cast<uint64_t>(n) * hd * 2,
                        Panels<DP>::kWidth, kT, panel_swizzle<DP>()) != 0) {
      return cudaErrorInvalidValue;
    }
  }
  if (make_tensor_map(&maps.stats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.stats, 4, n, bh, 16,
                      static_cast<uint64_t>(n) * 16, 4, kT, CU_TENSOR_MAP_SWIZZLE_NONE) != 0 ||
      make_tensor_map(&maps.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws + w.dq, hd, n, bh,
                      static_cast<uint64_t>(hd) * 4, static_cast<uint64_t>(n) * hd * 4, 16, kT,
                      CU_TENSOR_MAP_SWIZZLE_64B) != 0) {
    return cudaErrorInvalidValue;
  }
  maps.bias = bias_map;
  maps.dbias = dbias_map;
  constexpr int kMainBytes = BwdLayout<DP>::kTotal;
  // persistent: one block per SM (or per unit, where there are fewer); by rows
  // where a wave of rows meets at most about eight of a group's
  const int rowwise = groups >= 16;
  const long long units =
      rowwise ? bh : static_cast<long long>(bh) * ((n + kUnitKeys - 1) / kUnitKeys);
  const int grid = static_cast<int>(units < sms ? units : sms);
  window_bwd_main<DP, COS><<<grid, kBwdThreads, kMainBytes, stream>>>(
      static_cast<const T*>(p.k), static_cast<const T*>(p.v), maps, p.scale,
      static_cast<T*>(p.dk), static_cast<T*>(p.dv), reinterpret_cast<int*>(ws + w.dq_count),
      reinterpret_cast<int*>(ws + w.db_count), n, hd, groups, p.g_size, rowwise);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long rows = static_cast<long long>(bh) * n;
  const long long threads = rows * (DP / 8);
  window_bwd_finish<DP, COS><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(p.q), reinterpret_cast<const float*>(ws + w.dq), p.scale, p.stats,
      static_cast<T*>(p.dq), rows, n, hd, p.g_size);
  return cudaGetLastError();
}

template <int DP, bool COS>
cudaError_t launch_f32(const Params& p, int bh, cudaStream_t stream) {
  using L = F32Layout<DP>;
  constexpr int QB = L::kQB;
  constexpr int kPrepSmem = 2 * kT * (DP + 1) * 4 + 2 * kT * 4;
  const int n = p.n, hd = p.hd, groups = p.n_groups;
  cudaError_t err = cudaFuncSetAttribute(window_prep_f32<DP, COS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kPrepSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(window_bwd_f32_wg<DP, COS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::kTotal);
  }
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const Workspace w = workspace(0, bh, n, hd, groups);
  unsigned char* const ws = reinterpret_cast<unsigned char*>(p.stats);
  err = cudaMemsetAsync(ws + w.dq_count, 0, w.bytes - w.dq_count, stream);  // the counters
  if (err != cudaSuccess) return err;
  const int n_pad = p.tiles * kT;
  const F32Operands ops{reinterpret_cast<float*>(ws + w.qh), reinterpret_cast<float*>(ws + w.qh_small),
                        reinterpret_cast<float*>(ws + w.g_small), reinterpret_cast<float*>(ws + w.qzt),
                        reinterpret_cast<float*>(ws + w.gzt), w.plane / 4, n_pad};
  window_prep_f32<DP, COS><<<bh * p.tiles, 256, kPrepSmem, stream>>>(p, ops);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the row operands as (hd, N, BH), a box a panel; the transposed ones as
  // (n_pad, hd, BH), a box of (QB, DP); the stats as (4, N, BH); the bias and
  // dbias as (N, N, G), boxes of 32 x QB; the f32 dq sums as (hd, N, BH),
  // boxes of 16 columns x QB rows, 64-byte swizzled
  F32Maps maps;
  using P = Panels<2 * DP>;
  const void* const rows[4] = {ws + w.qh, ws + w.qh_small, p.g, ws + w.g_small};
  CUtensorMap* const row_maps[4] = {&maps.qh, &maps.qh_small, &maps.g, &maps.g_small};
  const void* const cols[4] = {ws + w.qzt, ws + w.qzt + w.plane, ws + w.gzt, ws + w.gzt + w.plane};
  CUtensorMap* const col_maps[4] = {&maps.qzt, &maps.qzt_small, &maps.gzt, &maps.gzt_small};
  for (int op = 0; op < 4; ++op) {
    if (make_tensor_map(row_maps[op], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows[op], hd, n, bh,
                        static_cast<uint64_t>(hd) * 4, static_cast<uint64_t>(n) * hd * 4,
                        P::kWidth / 2, QB, panel_swizzle<2 * DP>()) != 0 ||
        make_tensor_map(col_maps[op], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cols[op], n_pad, hd, bh,
                        static_cast<uint64_t>(n_pad) * 4, static_cast<uint64_t>(n_pad) * hd * 4,
                        QB, DP, panel_swizzle<2 * QB>()) != 0) {
      return cudaErrorInvalidValue;
    }
  }
  if (make_tensor_map(&maps.stats, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.stats, 4, n, bh, 16,
                      static_cast<uint64_t>(n) * 16, 4, QB, CU_TENSOR_MAP_SWIZZLE_NONE) != 0 ||
      make_tensor_map(&maps.bias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.bias, n, n, groups,
                      static_cast<uint64_t>(n) * 4, static_cast<uint64_t>(n) * n * 4, 32, QB,
                      CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
      make_tensor_map(&maps.dbias, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.dbias, n, n, groups,
                      static_cast<uint64_t>(n) * 4, static_cast<uint64_t>(n) * n * 4, 32, QB,
                      CU_TENSOR_MAP_SWIZZLE_128B) != 0 ||
      make_tensor_map(&maps.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws + w.dq, hd, n, bh,
                      static_cast<uint64_t>(hd) * 4, static_cast<uint64_t>(n) * hd * 4, 16, QB,
                      CU_TENSOR_MAP_SWIZZLE_64B) != 0) {
    return cudaErrorInvalidValue;
  }
  // persistent: one block per SM (or per unit, where there are fewer); by rows
  // where a wave of rows meets at most about eight of a group's
  const int rowwise = groups >= 16;
  const int units = (n + tb::kUnitKeys - 1) / tb::kUnitKeys;
  const long long work = rowwise ? bh : static_cast<long long>(bh) * units;
  const int grid = static_cast<int>(work < sms ? work : sms);
  window_bwd_f32_wg<DP, COS><<<grid, tb::kThreads, L::kTotal, stream>>>(
      static_cast<const float*>(p.k), static_cast<const float*>(p.v), maps, p.scale,
      static_cast<float*>(p.dk), static_cast<float*>(p.dv), reinterpret_cast<int*>(ws + w.dq_count),
      reinterpret_cast<int*>(ws + w.db_count), n, hd, groups, p.g_size, rowwise);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long rows_n = static_cast<long long>(bh) * n, threads = rows_n * (DP / 4);
  window_bwd_finish_f32<DP, COS><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(p.q), reinterpret_cast<const float*>(ws + w.dq), p.scale, p.stats,
      static_cast<float*>(p.dq), rows_n, n, hd, p.g_size);
  return cudaGetLastError();
}

template <int DP, bool COS>
cudaError_t launch_all(int dtype, int bh, const Params& p, cudaStream_t stream) {
  if (dtype == 1) return launch_bf16<DP, COS>(p, bh, stream);
  if constexpr (DP >= 32) return launch_f32<DP, COS>(p, bh, stream);
  return cudaErrorInvalidValue;  // f32 pads hd to 32 at least
}

template <int DP>
cudaError_t launch_width(int dtype, int cosine, int bh, const Params& p, cudaStream_t stream) {
  return cosine ? launch_all<DP, true>(dtype, bh, p, stream)
                : launch_all<DP, false>(dtype, bh, p, stream);
}

}  // namespace

// Bytes of the scratch xmir_window_attn_bwd takes as `stats` (Workspace).
extern "C" int xmir_window_attn_bwd_workspace(int dtype, int bh, int n, int hd, int groups,
                                              long long* bytes) {
  if ((dtype != 0 && dtype != 1) || bh < 1 || n < 1 || hd < 8 || hd > 64 || hd % 8 != 0 ||
      groups < 1) {
    return (int)cudaErrorInvalidValue;
  }
  *bytes = static_cast<long long>(workspace(dtype, bh, n, hd, groups).bytes);
  return 0;
}

// C entry point bound with ctypes; returns a cudaError_t code. q, k, v, o, g
// and the outputs dq, dk, dv are (bh, n, hd), contiguous, 16-byte aligned, of
// one dtype (0 = float32, 1 = bfloat16); bias and the output dbias (groups, n,
// n) float32; scale (groups,) float32; stats is scratch of
// xmir_window_attn_bwd_workspace's bytes, 16-byte aligned, and comes back
// with each query row's (m, 1 / z, c, alpha) as (bh, n, 4) float32 at its
// start. hd a multiple of 8 up to 64, n a multiple of 8, bh == groups *
// g_size. Each dtype: a prep, a main and a finishing kernel.
extern "C" int xmir_window_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                    const void* g, const float* bias, const float* scale,
                                    void* stats, void* dq, void* dk, void* dv, float* dbias,
                                    int dtype, int cosine, int bh, int n, int hd, int groups,
                                    int g_size, void* stream) {
  if ((dtype != 0 && dtype != 1) || n < 8 || n % 8 != 0 || hd < 8 || hd > 64 || hd % 8 != 0 ||
      groups < 1 || g_size < 1 || static_cast<long long>(groups) * g_size != bh) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (n + kT - 1) / kT;
  if (static_cast<long long>(bh) * tiles > 2147483647LL ||
      static_cast<long long>(groups) * tiles * tiles > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{q, k, v, o, g, bias, scale, static_cast<float4*>(stats), dq, dk, dv, dbias,
                 n, hd, tiles, g_size, groups};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 16 && dtype == 1) return (int)launch_width<16>(dtype, cosine, bh, p, s);
  if (hd <= 32) return (int)launch_width<32>(dtype, cosine, bh, p, s);
  return (int)launch_width<64>(dtype, cosine, bh, p, s);
}
