// ConvNeXtV2 block tail for Hopper (sm_90a): LayerNorm -> pw1 -> tanh-GELU
// -> GRN -> pw2 -> + residual, per image, forward only.
//
// Replaces xmir_tpu/ops/convnext_block_pallas.py::_block_fused_fwd (K9, body
// _ln_block_kernel) and ::convnext_mlp_grn_fused (K11, body _kernel: the same
// tail with the input already normalised). The TPU kernel keeps one image's
// whole expanded tensor h (R x 4C) in VMEM. On the H100 it does not fit: at
// 384 px stage 1 h is 9216 x 512, 9.4 MB in bf16, against 227 KB of shared
// memory per block; and GRN needs a statistic over all R rows of an image
// before any row of pw2 can start. So the tail runs as a GEMM with a GELU +
// column-squares epilogue, a fixed-order reduction, and a GEMM with a GRN
// prologue and a residual epilogue. Rounding points, the TPU kernel's: the
// LN output y rounded to the dtype (:101-107); h = tanh-GELU(y . pw1 + b1)
// rounded to the dtype (:111), its squares taken in f32 on the rounded values
// and summed per column over the image's rows (:112-114); gx = sqrt(sum +
// 1e-12), nx = gx / (mean over the 4C columns of gx + 1e-6) (:115); z =
// gamma (h nx) + beta + h in f32, rounded to the dtype (:116); out = x +
// (z . pw2 + b2) in f32, rounded once (:117-120). Every sum runs in a fixed
// order (no atomics): two runs give the same bits.
//
// What bounds it: the two GEMMs are 4 R C 4C FLOP per image (~2.4 GFLOP per
// image at 384 px, the same at every stage); h (B R 4C) is written once and
// read once by the second GEMM, against the plain PyTorch version's several
// passes over it (GEMM out, bias, GELU, square-sum, GRN apply). At stage 1
// (C = 128) h's round trip (604 MB at B = 32) outweighs the products.
//
// bf16 (every ConvNeXtV2 block in inference, and the forward of the blocks
// training fuses), four launches:
//   ln_rows   K9 only (gemm_tile.cuh, shared with K7, K8 and K10): each row
//       normalised once (a warp a row: f32 statistics with the fast variance
//       max(E[x^2] - mean^2, 0), eps 1e-6), y rounded to bf16 into a
//       (B, R, C) scratch. A pre-pass and not a
//       block that keeps its normalised rows in shared memory and walks every
//       column tile of 4C: at C = 1024 a 64-row tile of y is 128 KB, and the
//       pre-pass moves 2 B R C bytes (11 us at stage 3, 45 us at stage 1,
//       where h's round trip is 180 us), while the product's A operand becomes
//       a plain copy-engine box. K11's input is y already.
//   tail_gemm_wg<kGeluSquares, 128>   y . pw1^T: a block owns two 64-row
//       units (each of one image: a unit never straddles two images, so 576
//       = 9 x 64 rows waste nothing and 144 rows waste 25%) and 128 columns
//       of 4C; two consumer warpgroups, one unit each (wgmma m64n128k16, both
//       operands from shared memory), and a producer warp that streams the
//       units' 64 x 64 tiles of y and the 128 x 64 tiles of pw1 (K-major as
//       torch's Linear stores it) by the copy engine into a ring behind full
//       / empty mbarriers. Epilogue: + b1, tanh-GELU, rounded, stored as h;
//       the rounded values' squares summed per column over the unit's live
//       rows (a shuffle tree over the warp's rows, then the four warps in
//       order) into part[unit][column]. Two blocks an SM.
//   grn_scale   one block per image: gx and nx from the image's units'
//       partials, in unit order.
//   tail_gemm_wg<kResidual, 256 (128 at C = 128)>   z . pw2^T: the same
//       units by 256 columns of C; z forms on the A operand's way into the
//       product: each warpgroup rewrites its h tile in the stage as z (f32,
//       gamma, beta and its image's nx loaded a chunk ahead, rounded to bf16)
//       behind a proxy fence and a barrier of its own, then issues the
//       product from shared memory. A register-A form (z as wgmma's A
//       fragments) had ptxas serialise the products, whose input registers it
//       wrote while earlier products ran. Epilogue: out = x + (acc + b2) in
//       f32, rounded once.
// At 128 x 128 a stage moves 32 KB for 2.1 MFLOP, so the products ask for
// about 3.5 TB/s of L2 at 230 TFLOP/s: the second product's 256 columns cut
// that by a quarter and form each z half as often (PERF.md). The first
// product keeps 128 columns and two blocks an SM: at 256 (one block an SM)
// its GELU epilogue no longer runs under another block's products.
//
// f32 (only under XMIR_FUSED_MLP=1 f32), three launches on gemm_tile.cuh's
// 128 x 128 register-staged tile loop (IEEE f32 FMAs, no TF32), rows tiled
// per image by 128:
//   gemm<.., kLayerNorm or kNone, kGeluSquares>   grid (row tiles, 4C / 128,
//       B): the block's rows normalised on their way into shared memory
//       (K11 skips it), GEMM1, + b1, tanh-GELU, h and part[image][row tile];
//   grn_scale;
//   gemm<.., kGrn, kResidual>   the GRN apply as the A prologue, GEMM2, + x.
//
// Operands: activations (B, R, K) row-major and torch Linear weights (N, K)
// row-major, both K-contiguous: no transpose per call. The launches go on the
// caller's stream and allocate nothing: the wrapper
// (xmir_tpu_torch/ops/convnext_block.py) passes y, h, the partial sums, nx
// and the output; the bf16 launches make their four tensor maps on the host.

#include "gemm_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxBatch = 65535;  // gridDim.z
constexpr float kGrnEps = 1e-12f;
constexpr float kGrnMeanEps = 1e-6f;

enum Epilogue { kGeluSquares = 0, kResidual = 1 };

struct GemmArgs {
  const void* a;      // (B, rows, K) activations in T
  const void* w;      // (N, K) weights in T
  const float* bias;  // (N,)
  int rows, k, n;
  // prologue: kLayerNorm: p0 = LN scale (K,), p1 = LN bias (K,)
  //           kGrn: p0 = gamma (K,), p1 = beta (K,), p2 = nx (B, K)
  const float* p0;
  const float* p1;
  const float* p2;
  // epilogue: kGeluSquares: out = h (B, rows, N), part (B, row tiles, N)
  //           kResidual: out = block output (B, rows, N), res = x (B, rows, N)
  void* out;
  float* part;
  const void* res;
};

// f32: two blocks per SM (at most 128 registers a thread): one block's stall
// on its next chunk's loads hides behind the other's math.
template <typename T, int P, int E>
__global__ void __launch_bounds__(kThreads, 2) gemm(GemmArgs args) {
  using Ly = Layout<T>;
  static_assert(sizeof(TileShared<T>::tiles) >= kGroups * kBN * sizeof(float),
                "the column-sum buffer reuses the tiles' shared memory");
  __shared__ TileShared<T> sm;
  const int img = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rows = args.rows, K = args.k, N = args.n;
  float acc[8][8];
  gemm_tile<T, P>(static_cast<const T*>(args.a) + (size_t)img * rows * K,
                  static_cast<const T*>(args.w), rows, K, N, m0, n0, args.p0, args.p1,
                  P == kGrn ? args.p2 + (size_t)img * K : nullptr, sm, acc);

  // Epilogue. The tiles' shared memory is free after the last barrier.
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + Ly::col_of(j);
    bias[j] = n < N ? args.bias[n] : 0.f;
  }
  T* out = static_cast<T*>(args.out) + (size_t)img * rows * N;
  if constexpr (E == kGeluSquares) {
    float* red = reinterpret_cast<float*>(sm.tiles);  // [kGroups][kBN]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = Ly::col_of(j), n = n0 + c;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + Ly::row_of(i);
        if (m < rows && n < N) {
          const float h = round_to(gelu_tanh(acc[i][j] + bias[j]), T());
          store(out + (size_t)m * N + n, h);
          sq += h * h;
        }
      }
      red[Ly::group_of() * kBN + c] = sq;
    }
    __syncthreads();
    if (threadIdx.x < kBN && n0 + (int)threadIdx.x < N) {
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) s += red[g * kBN + threadIdx.x];
      args.part[((size_t)img * gridDim.x + blockIdx.x) * N + n0 + threadIdx.x] = s;
    }
  } else {
    const T* res = static_cast<const T*>(args.res) + (size_t)img * rows * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + Ly::row_of(i);
      if (m >= rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + Ly::col_of(j);
        if (n < N) {
          const size_t at = (size_t)m * N + n;
          store(out + at, load(res + at) + (acc[i][j] + bias[j]));
        }
      }
    }
  }
}

// nx[image][c] from the (image, row tile, c) partial sums of h^2, the row
// tiles (f32) or units (bf16) added in order.
__global__ void __launch_bounds__(kThreads) grn_scale(const float* __restrict__ part,
                                                      int row_tiles, int c4,
                                                      float* __restrict__ nx) {
  __shared__ float red[kThreads];
  const int img = blockIdx.x;
  const float* p = part + (size_t)img * row_tiles * c4;
  float* out = nx + (size_t)img * c4;
  float local = 0.f;
  for (int c = threadIdx.x; c < c4; c += kThreads) {
    float s = 0.f;
    for (int t = 0; t < row_tiles; ++t) s += p[(size_t)t * c4 + c];
    const float gx = sqrtf(s + kGrnEps);
    out[c] = gx;
    local += gx;
  }
  red[threadIdx.x] = local;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if ((int)threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  const float denom = red[0] / c4 + kGrnMeanEps;
  for (int c = threadIdx.x; c < c4; c += kThreads) out[c] = out[c] / denom;
}

// ---------------------------------------------------------------------------
// bf16

constexpr int kUnit = 64;     // rows of one image a consumer warpgroup owns
constexpr int kWK = 64;       // depth a ring stage: one 128-byte panel
constexpr int kWA = kUnit * kWK * 2;  // one unit's A tile

// Per product: the block's width BN (128 or 256 output columns), threads,
// blocks an SM and ring stages. A stage is both units' A tiles and the
// weight tile. 128 columns: two consumer warpgroups and a producer warp, and
// for the first product (depth C, a long GELU epilogue) two blocks an SM,
// one's epilogue under the other's products. 256 columns (m64n256, 128
// accumulators a thread): a whole producer warpgroup that gives its
// registers to the consumers (ptxas sizes a 288- or 384-thread block at 168
// a thread, too few), one block an SM; it reads 48 KB a stage for twice the
// products of 32 KB at 128, and the second product forms each z once per
// 256 columns. Shared memory: the ring, the column sums [2 warpgroups][4
// warps][BN] f32, full[stages], empty[stages].
template <int E, int BN>
struct WgCfg {
  static constexpr bool kWide = BN == 256;
  static constexpr int kThreads = kWide ? 384 : 288;
  static constexpr int kBlocks = !kWide && E == kGeluSquares ? 2 : 1;
  static constexpr int kB = BN * kWK * 2;
  static constexpr int kStage = 2 * kWA + kB;
  static constexpr int kStages = kWide ? 4 : E == kGeluSquares ? 3 : 6;
  static constexpr int kRed = kStages * kStage;
  static constexpr int kBars = kRed + 2 * 4 * BN * 4;
  static constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;
};

struct WgArgs {
  int rows, k, n;     // rows of an image, depth, output columns
  int unit_tiles;     // 64-row units of an image
  int units;          // ... of the batch
  int n_tiles;        // column tiles of BN
  const float* bias;  // (n,)
  // kResidual: gamma, beta (k,) and nx (B, k), the GRN apply on A's way in
  const float* gamma;
  const float* beta;
  const float* nx;
  __nv_bfloat16* out;         // h (kGeluSquares) or the block output, (B, rows, n)
  float* part;                // kGeluSquares: (units, n) column sums of h^2
  const __nv_bfloat16* res;   // kResidual: x (B, rows, n)
};

// One block: units 2 p and 2 p + 1 (p = blockIdx.x / n_tiles; a batch with an
// odd number leaves warpgroup 1 idle on the last) by columns n0 .. n0 + BN - 1.
// Consumer warpgroup w owns unit 2 p + w; a thread holds rows g = lane / 4
// and g + 8 of its warp's 16, element 4 j + e of acc at row + 8 (e / 2),
// column n0 + 8 j + 2 (lane % 4) + (e % 2).
template <int E, int BN>
__global__ void __launch_bounds__(WgCfg<E, BN>::kThreads, WgCfg<E, BN>::kBlocks) tail_gemm_wg(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap w_map,
    const WgArgs args) {
  using Cfg = WgCfg<E, BN>;
  constexpr int kWStages = Cfg::kStages, kWStage = Cfg::kStage;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + Cfg::kBars);
  uint64_t* const empty = full + kWStages;
  const int pair = blockIdx.x / args.n_tiles;
  const int n0 = (blockIdx.x - pair * args.n_tiles) * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = min(2, args.units - 2 * pair);
  const int chunks = (args.k + kWK - 1) / kWK;

  if (tid == 0) {
    for (int st = 0; st < kWStages; ++st) {
      mbar_init(full + st, 1);            // the producer, once its copies land
      mbar_init(empty + st, 4 * live);    // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: per depth chunk each unit's A tile and the weight tile
    if constexpr (Cfg::kWide) regs_shrink<40>();
    if (warp != 8 || lane != 0) return;
    int img[2], tile[2];
    for (int w = 0; w < live; ++w) {
      const int u = 2 * pair + w;
      img[w] = u / args.unit_tiles;
      tile[w] = u - img[w] * args.unit_tiles;
    }
    for (int kc = 0; kc < chunks; ++kc) {
      const int stage = kc % kWStages;
      mbar_wait(empty + stage, ((kc / kWStages) & 1) ^ 1);
      unsigned char* const dst = smem + stage * kWStage;
      // rows past the image and depth past K read as zeros
      mbar_arrive_expect_tx(full + stage, live * kWA + Cfg::kB);
      for (int w = 0; w < live; ++w) {
        tma_load(dst + w * kWA, &a_map, kc * kWK, tile[w] * kUnit, img[w], full + stage);
      }
      tma_load(dst + 2 * kWA, &w_map, kc * kWK, n0, 0, full + stage);
    }
    return;
  }

  if constexpr (Cfg::kWide) regs_grow<232>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  if (wg >= live) return;
  const int u = 2 * pair + wg, img = u / args.unit_tiles;
  const int row_a = (u - img * args.unit_tiles) * kUnit + 16 * wq + g;  // and row_a + 8
  const int rows = args.rows, K = args.k, N = args.n;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  // the chunk before is done (at most this one in flight): its stage is free
  auto release_before = [&](int kc) {
    if (kc > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (kc - 1) % kWStages);
    }
  };
  fence_regs(acc);
  if constexpr (E == kGeluSquares) {
    for (int kc = 0; kc < chunks; ++kc) {
      const int stage = kc % kWStages;
      mbar_wait(full + stage, (kc / kWStages) & 1);
      const uint32_t a_tile = smem_addr(smem + stage * kWStage + wg * kWA);
      const uint32_t b_tile = smem_addr(smem + stage * kWStage + 2 * kWA);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        Wgmma<BN>::template ss<0, 0>(acc, desc_k_major<kWK>(a_tile, kUnit, 0, 16 * kk),
                                     desc_k_major<kWK>(b_tile, BN, 0, 16 * kk), kc > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      release_before(kc);
    }
  } else {
    // z = gamma (h nx) + beta + h in f32, rounded to bf16, written over the
    // warpgroup's h tile in the stage: thread i of the warpgroup takes the
    // eight columns 8 (i % 8) .. of rows i / 8 + 16 r, so it loads gamma,
    // beta and nx once a chunk. The tile is then A of an ordinary product
    // from shared memory (no register operand written while a product runs,
    // which ptxas would serialise).
    const float* const nx = args.nx + static_cast<size_t>(img) * K;
    const int wt = tid & 127, c8 = (wt & 7) * 8;
    // gamma, beta and nx of the thread's eight columns, loaded a chunk ahead
    float gm[8], bt[8], nv[8], gm_next[8], bt_next[8], nv_next[8];
    auto fetch = [&](int kc, float (&g)[8], float (&b)[8], float (&v)[8]) {
      const int col = kc * kWK + c8;
      if (col < K) {  // K is a multiple of 8: all eight columns or none
        load_floats(g, args.gamma + col);
        load_floats(b, args.beta + col);
        load_floats(v, nx + col);
      }
    };
    fetch(0, gm, bt, nv);
    for (int kc = 0; kc < chunks; ++kc) {
      const int stage = kc % kWStages;
      if (kc + 1 < chunks) fetch(kc + 1, gm_next, bt_next, nv_next);
      mbar_wait(full + stage, (kc / kWStages) & 1);
      unsigned char* const a_s = smem + stage * kWStage + wg * kWA;
      const bool in = kc * kWK + c8 < K;
#pragma unroll
      for (int r = 0; r < kUnit / 16; ++r) {
        uint4* const p = reinterpret_cast<uint4*>(a_s + panel_offset<kWK>(kUnit, wt / 8 + 16 * r, c8));
        float hv[8];
        unpack(*p, hv);
#pragma unroll
        for (int e = 0; e < 8; ++e) hv[e] = in ? gm[e] * (hv[e] * nv[e]) + bt[e] + hv[e] : 0.f;
        stash_vec(reinterpret_cast<__nv_bfloat16*>(p), hv);  // depth past K stays zero
      }
      fence_async_smem();
      named_barrier(1 + wg, 128);
      const uint32_t a_tile = smem_addr(a_s);
      const uint32_t b_tile = smem_addr(smem + stage * kWStage + 2 * kWA);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        Wgmma<BN>::template ss<0, 0>(acc, desc_k_major<kWK>(a_tile, kUnit, 0, 16 * kk),
                                     desc_k_major<kWK>(b_tile, BN, 0, 16 * kk), kc > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      release_before(kc);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        gm[e] = gm_next[e];
        bt[e] = bt_next[e];
        nv[e] = nv_next[e];
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const bool live_row[2] = {row_a < rows, row_a + 8 < rows};
  const size_t at_row[2] = {(static_cast<size_t>(img) * rows + row_a) * N,
                            (static_cast<size_t>(img) * rows + row_a + 8) * N};
  if constexpr (E == kGeluSquares) {
    float* const red = reinterpret_cast<float*>(smem + Cfg::kRed) + wg * 4 * BN;  // [4 warps][BN]
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * t, col = n0 + c;  // N is a multiple of 8: col + 1 < N too
      float sq0 = 0.f, sq1 = 0.f;
      if (col < N) {
        const float2 b = __ldg(reinterpret_cast<const float2*>(args.bias + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!live_row[h]) continue;
          const float v0 = round_to(gelu_sigmoid(acc[4 * j + 2 * h] + b.x), __nv_bfloat16());
          const float v1 = round_to(gelu_sigmoid(acc[4 * j + 2 * h + 1] + b.y), __nv_bfloat16());
          *reinterpret_cast<__nv_bfloat162*>(args.out + at_row[h] + col) =
              __floats2bfloat162_rn(v0, v1);
          sq0 += v0 * v0;
          sq1 += v1 * v1;
        }
      }
      // the warp's 16 rows: the eight lanes that share t
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        sq0 += __shfl_xor_sync(0xffffffffu, sq0, off);
        sq1 += __shfl_xor_sync(0xffffffffu, sq1, off);
      }
      if (g == 0) {
        red[wq * BN + c] = sq0;
        red[wq * BN + c + 1] = sq1;
      }
    }
    named_barrier(1 + wg, 128);
    for (int c = tid & 127; c < BN && n0 + c < N; c += 128) {
      args.part[static_cast<size_t>(u) * N + n0 + c] =
          red[c] + red[BN + c] + red[2 * BN + c] + red[3 * BN + c];
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live_row[h]) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col < N) {
          const float2 b = __ldg(reinterpret_cast<const float2*>(args.bias + col));
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(args.res + at_row[h] + col));
          *reinterpret_cast<__nv_bfloat162*>(args.out + at_row[h] + col) = __floats2bfloat162_rn(
              x.x + (acc[4 * j + 2 * h] + b.x), x.y + (acc[4 * j + 2 * h + 1] + b.y));
        }
      }
    }
  }
}

int row_tiles(int rows, int dtype) {
  return dtype == 0 ? (rows + kBM - 1) / kBM : (rows + kUnit - 1) / kUnit;
}

cudaError_t launch_tail_f32(const void* a, const void* x, const float* ln_scale,
                            const float* ln_bias, const void* w1, const float* b1, const void* w2,
                            const float* b2, const float* gamma, const float* beta, int batch,
                            int rows, int c, int c4, void* h, float* part, float* nx, void* out,
                            cudaStream_t stream) {
  const int tiles = row_tiles(rows, 0);
  GemmArgs g1{a, w1, b1, rows, c, c4, ln_scale, ln_bias, nullptr, h, part, nullptr};
  const dim3 grid1(tiles, (c4 + kBN - 1) / kBN, batch);
  if (ln_scale != nullptr) {
    gemm<float, kLayerNorm, kGeluSquares><<<grid1, kThreads, 0, stream>>>(g1);
  } else {
    gemm<float, kNone, kGeluSquares><<<grid1, kThreads, 0, stream>>>(g1);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grn_scale<<<batch, kThreads, 0, stream>>>(part, tiles, c4, nx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GemmArgs g2{h, w2, b2, rows, c4, c, gamma, beta, nx, out, nullptr, x};
  const dim3 grid2(tiles, (c + kBN - 1) / kBN, batch);
  gemm<float, kGrn, kResidual><<<grid2, kThreads, 0, stream>>>(g2);
  return cudaGetLastError();
}

// One product: its weight as (K, N) boxes of (64, BN), blocks of unit pairs
// by BN columns.
template <int E, int BN>
cudaError_t launch_gemm(const CUtensorMap& a_map, const void* w, WgArgs args, long long pairs,
                        cudaStream_t stream) {
  using Cfg = WgCfg<E, BN>;
  CUtensorMap w_map;
  if (rows_map(&w_map, w, args.k, args.n, 1, BN) != 0) return cudaErrorInvalidValue;
  args.n_tiles = (args.n + BN - 1) / BN;
  if (pairs * args.n_tiles > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tail_gemm_wg<E, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  tail_gemm_wg<E, BN><<<static_cast<unsigned>(pairs * args.n_tiles), Cfg::kThreads, Cfg::kSmem,
                        stream>>>(a_map, w_map, args);
  return cudaGetLastError();
}

cudaError_t launch_tail_bf16(const void* a, const void* x, const float* ln_scale,
                             const float* ln_bias, const void* w1, const float* b1,
                             const void* w2, const float* b2, const float* gamma,
                             const float* beta, int batch, int rows, int c, int c4, void* h,
                             void* y, float* part, float* nx, void* out, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int unit_tiles = row_tiles(rows, 1);
  const long long units = static_cast<long long>(batch) * unit_tiles;
  const long long pairs = (units + 1) / 2;
  cudaError_t err;
  const void* a_in = a;
  if (ln_scale != nullptr) {
    err = launch_ln_rows<T>(static_cast<const T*>(a), ln_scale, ln_bias,
                            static_cast<long long>(batch) * rows, c, static_cast<T*>(y), nullptr,
                            stream);
    if (err != cudaSuccess) return err;
    a_in = y;
  }
  CUtensorMap y_map, h_map;
  if (rows_map(&y_map, a_in, c, rows, batch, kUnit) != 0 ||
      rows_map(&h_map, h, c4, rows, batch, kUnit) != 0) {
    return cudaErrorInvalidValue;
  }
  const WgArgs g1{rows, c, c4, unit_tiles, static_cast<int>(units), 0, b1, nullptr, nullptr,
                  nullptr, static_cast<T*>(h), part, nullptr};
  err = launch_gemm<kGeluSquares, 128>(y_map, w1, g1, pairs, stream);
  if (err != cudaSuccess) return err;
  grn_scale<<<batch, kThreads, 0, stream>>>(part, unit_tiles, c4, nx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the second product 256 columns wide where C allows it
  const WgArgs g2{rows, c4, c, unit_tiles, static_cast<int>(units), 0, b2, gamma, beta, nx,
                  static_cast<T*>(out), nullptr, static_cast<const T*>(x)};
  return c >= 256 ? launch_gemm<kResidual, 256>(h_map, w2, g2, pairs, stream)
                  : launch_gemm<kResidual, 128>(h_map, w2, g2, pairs, stream);
}

}  // namespace

// C entry points bound with ctypes; each returns a cudaError_t code.
//
// xmir_convnext_plan writes the number of row tiles per image for dtype
// (0 = float32: 128 rows a tile; 1 = bfloat16: 64-row units), the middle
// extent of the partial-sum buffer xmir_convnext_tail takes.
extern "C" int xmir_convnext_plan(int rows, int dtype, int* tiles) {
  if (rows < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  *tiles = row_tiles(rows, dtype);
  return (int)cudaSuccess;
}

// One ConvNeXtV2 block tail. a is the dwconv output (ln_scale, ln_bias given:
// K9) or the already normalised input (both null: K11), (batch, rows, c); x
// the residual, (batch, rows, c); w1 (c4, c) and w2 (c, c4) in torch Linear
// layout; a, x, w1, w2, h and out of one dtype (0 = float32, 1 = bfloat16),
// all contiguous and 16-byte aligned; ln_scale, ln_bias (c,), b1, gamma,
// beta (c4,), b2 (c,) float32, 16-byte aligned. Scratch: h (batch, rows, c4)
// in the dtype; y (batch, rows, c) bfloat16 for K9 in bfloat16 (the
// normalised rows), else unread and may be null; part (batch, row tiles, c4)
// (xmir_convnext_plan) and nx (batch, c4) float32. c and c4 must be multiples
// of 8.
extern "C" int xmir_convnext_tail(const void* a, const void* x, const float* ln_scale,
                                  const float* ln_bias, const void* w1, const float* b1,
                                  const void* w2, const float* b2, const float* gamma,
                                  const float* beta, int dtype, int batch, int rows, int c,
                                  int c4, void* h, void* y, float* part, float* nx, void* out,
                                  void* stream) {
  if (batch < 1 || batch > kMaxBatch || rows < 1 || c < 8 || c % 8 != 0 || c4 < 8 ||
      c4 % 8 != 0 || (ln_scale == nullptr) != (ln_bias == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_tail_f32(a, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta, batch,
                                rows, c, c4, h, part, nx, out, s);
  }
  if (dtype == 1) {
    if (ln_scale != nullptr && y == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_tail_bf16(a, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta, batch,
                                 rows, c, c4, h, y, part, nx, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
