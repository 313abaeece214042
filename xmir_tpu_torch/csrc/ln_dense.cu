// LayerNorm fused into the projection that follows it, for Hopper (sm_90a),
// forward only.
//
// Replaces xmir_tpu/ops/ln_dense_pallas.py::_ln_qkv_pallas (K7, body
// _ln_qkv_kernel: LN(x) . W_qkv + b stored head-major as q, k, v) and
// ::_ln_dense_pallas (K8, body _ln_dense_kernel: LN(x) . W + b with an
// optional tanh-GELU). The TPU kernels keep the whole projection weight
// resident in VMEM and walk the row tiles in order.
//
// Rounding points, the TPU kernels' (:71-77, :151-165): LayerNorm in f32 with
// the fast variance, rounded to x's dtype before the product; f32
// accumulation; the bias added in f32; tanh-GELU in f32 (K8, when asked);
// one rounding to the output dtype.
//
// What bounds them: at the DINOv2 width (C = 768, B = 16, N = 1370) K7 is
// 77.6 GFLOP against 138 MB and K8 103 GFLOP against 168 MB, both bound by
// operations in bf16 (0.078 and 0.105 ms on an H100). K8's output (R, 4C)
// is 135 MB of those 168, and its epilogue takes an exp2, a reciprocal and
// a bf16 store for each of the R 4C outputs: at 128 accumulators a thread
// the epilogue is a third or more of the products' time, which a design
// that runs it with the tensor cores idle pays in full.
//
// bf16, two launches each:
//   ln_rows (gemm_tile.cuh, shared with K9 and K10)   each row normalised
//       once (f32 statistics, the fast variance, eps 1e-6) and rounded to
//       bf16 into a scratch y the wrapper allocates: 2 R C bytes each way
//       (34 MB at B = 16, ~20 us), where a tile loop would recompute each
//       row's statistics in every one of the M / 128 column tiles.
//   ln_gemm_wg   y . W^T on wgmma m64n256k16, persistent (a block per SM
//       walking items blockIdx.x, + gridDim.x, ...): a producer warpgroup
//       streams 64 x 64 boxes of y and 256 x 64 boxes of W (K-major as
//       torch's Linear stores it) by the copy engine into a four-stage ring
//       that runs on from one item to the next, and gives its registers to
//       the two consumer warpgroups (setmaxnreg: 128 accumulators a thread).
//       Rows past the tensor and columns past M read as zeros.
//     K7 (ln_gemm_wg<kHeads, false>): an item is two 64-row units (each of
//       one image: 1370 tokens are 21 units and a ragged 22nd) by 256
//       columns of 3C, both warpgroups on every item (one unit each), so a
//       stage's W box serves two units; where the unit count is odd,
//       warpgroup 1 multiplies on the last pair without storing, since a
//       product on a divergent path made ptxas serialise every product of
//       the kernel (C7518). Epilogue: + bias in f32, one rounding, each
//       column pair stored straight to its head: column j of the 3C goes to
//       tensor j / C, head (j mod C) / hd, lane j mod hd, row n of (B, H, N,
//       hd), the layout K2 reads, with no transpose pass.
//     K8 (ln_gemm_wg<kRows or kRowsGelu, true>): an item is one 64-row
//       unit of the flat (R, C) rows (only the last is ragged: 21,920 =
//       342 x 64 + 32) by 256 columns of M, and the two warpgroups take the
//       block's items in turns: the producer fills the ring in item order,
//       so warpgroup 0's items and warpgroup 1's alternate, and a pair of
//       named barriers hands the tensor cores from one to the other as soon
//       as a warpgroup has issued its last product. While one multiplies,
//       the other runs its epilogue: + bias in f32, the tanh-GELU as
//       gelu_sigmoid (gemm_tile.cuh: one ex2.approx and one rcp.approx, no
//       cancellation in the tail), one rounding, into a 64 x 256 tile of
//       its own in shared memory (128-byte swizzled panels, so that neither
//       the writes from the accumulator layout nor the reads by row meet a
//       bank conflict); then a warp a row copies the tile out as 512
//       contiguous bytes, full 128-byte lines (4-byte pairs where M is not a
//       multiple of 8), rows past R never stored. Turns won against K9's
//       first product's way of putting an epilogue under products (two
//       blocks an SM at 128 columns, both warpgroups of a block on one item):
//       at the DINOv2 shape that body read 0.3252 ms of device time against
//       0.2762 for turns, in one development call (NVIDIA H100 80GB HBM3,
//       700 W; chip_smoke.py's device_ms, PERF.md).
//   K7 takes every shape ln_qkv_eligible admits and any C that is a
//   multiple of 8 with an even head width, K8 any C that is a multiple of 8
//   and any even M (depth past C and columns past M read as zeros); x, W and
//   the outputs must be 16-byte aligned (the copy engine's rule, which the
//   wrapper checks).
//
// f32 (under XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1, K8 also under
// XMIR_FUSED_LN_MLP=1) on gemm_tile.cuh's 128 x 128 tile loop (IEEE f32
// FMAs, no TF32), each row tile's statistics recomputed by every column
// tile:
//   ln_qkv_f32   grid (row tiles of one image, 3C / 128, B), rows tiled per
//       image so that the ragged last tile is predicated and x is never
//       padded in device memory; the head-major store as above.
//   ln_dense_f32<kGelu>   grid (row tiles of R, M / 128): row-major (R, M).

#include "gemm_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxGridY = 65535;  // gridDim.y and gridDim.z

struct LnArgs {
  const float* x;     // (B, rows, K)
  const float* w;     // (N, K)
  const float* bias;  // (N,) or null
  const float* lns;   // (K,)
  const float* lnb;   // (K,)
  int rows, k, n;
  // ln_qkv_f32: out0..2 = q, k, v (B, H, rows, hd), n = 3 heads hd
  // ln_dense_f32: out0 = (rows, n)
  float* out0;
  float* out1;
  float* out2;
  int heads, hd;
};

// Calls emit(m, n, acc + bias) for the tile's live outputs, in f32.
template <typename F>
__device__ __forceinline__ void for_outputs(const float (&acc)[8][8], const float* bias_ptr,
                                            int m0, int n0, int rows, int N, F emit) {
  using Ly = Layout<float>;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + Ly::col_of(j);
    bias[j] = bias_ptr != nullptr && n < N ? bias_ptr[n] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + Ly::row_of(i);
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + Ly::col_of(j);
      if (n < N) emit(m, n, acc[i][j] + bias[j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) ln_qkv_f32(LnArgs args) {
  __shared__ TileShared<float> sm;
  const int img = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rows = args.rows, K = args.k, N = args.n;
  float acc[8][8];
  gemm_tile<float, kLayerNorm>(args.x + (size_t)img * rows * K, args.w, rows, K, N, m0, n0,
                               args.lns, args.lnb, nullptr, sm, acc);
  const int hd = args.hd, heads = args.heads, c = heads * hd;
  float* const outs[3] = {args.out0, args.out1, args.out2};
  for_outputs(acc, args.bias, m0, n0, rows, N, [&](int m, int n, float v) {
    const int part = n / c, within = n - part * c;
    const int head = within / hd, lane = within - head * hd;
    outs[part][(((size_t)img * heads + head) * rows + m) * hd + lane] = v;
  });
}

template <bool kGelu>
__global__ void __launch_bounds__(kThreads, 2) ln_dense_f32(LnArgs args) {
  __shared__ TileShared<float> sm;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rows = args.rows, K = args.k, N = args.n;
  float acc[8][8];
  gemm_tile<float, kLayerNorm>(args.x, args.w, rows, K, N, m0, n0, args.lns, args.lnb, nullptr,
                               sm, acc);
  for_outputs(acc, args.bias, m0, n0, rows, N, [&](int m, int n, float v) {
    args.out0[(size_t)m * N + n] = kGelu ? gelu_tanh(v) : v;
  });
}

int tiles_of(int n, int tile) { return (n + tile - 1) / tile; }

cudaError_t launch_qkv_f32(const LnArgs& args, int batch, cudaStream_t stream) {
  const dim3 grid(tiles_of(args.rows, kBM), tiles_of(args.n, kBN), batch);
  ln_qkv_f32<<<grid, kThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

cudaError_t launch_dense_f32(const LnArgs& args, int gelu, cudaStream_t stream) {
  const dim3 grid(tiles_of(args.rows, kBM), tiles_of(args.n, kBN), 1);
  if (gelu) {
    ln_dense_f32<true><<<grid, kThreads, 0, stream>>>(args);
  } else {
    ln_dense_f32<false><<<grid, kThreads, 0, stream>>>(args);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: ln_gemm_wg

constexpr int kUnit = 64;                   // rows a consumer warpgroup owns
constexpr int kWK = 64;                     // depth a ring stage: one 128-byte panel
constexpr int kWgN = 256;                   // output columns of an item
constexpr int kStages = 4;
constexpr int kWgThreads = 384;             // two consumer warpgroups, one producer
constexpr int kTileA = kUnit * kWK * 2;     // one unit's box of y
constexpr int kTileB = kWgN * kWK * 2;      // the weight's box
constexpr int kTileOut = kUnit * kWgN * 2;  // a warpgroup's output tile (K8)

enum WgEpilogue { kHeads = 0, kRows = 1, kRowsGelu = 2 };

// Shared memory: the ring, then (row-major epilogues) each consumer
// warpgroup's output tile, then the ring's full and empty barriers.
template <int E, bool kTurns>
struct WgPlan {
  static constexpr int kUnits = kTurns ? 1 : 2;  // 64-row units an item
  static constexpr int kStage = kUnits * kTileA + kTileB;
  static constexpr int kOut = kStages * kStage;
  static constexpr int kBars = kOut + (E == kHeads ? 0 : 2 * kTileOut);
  static constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;
  static_assert(kSmem <= 232448, "one block an SM");
};

struct WgArgs {
  int rows, k, n;       // rows of an image (K8: all R, one image), C, output columns
  int unit_tiles;       // 64-row units of an image
  int units;            // ... of the batch
  int n_tiles;          // column tiles of kWgN
  int items;            // (unit or unit pair, column tile): units (or pairs) x n_tiles
  int heads, hd;        // K7
  const float* bias;    // (n,) or null
  __nv_bfloat16* out0;  // K7: q, k, v (B, heads, rows, hd); K8: out0 (rows, n)
  __nv_bfloat16* out1;
  __nv_bfloat16* out2;
};

// Item i: units kUnits p .. (p = i / n_tiles) by columns n0 .. n0 + 255. A
// consumer thread holds rows g = lane / 4 and g + 8 of its warp's 16 of the
// unit, element 4 j + 2 h + e of acc at row + 8 h, column n0 + 8 j +
// 2 (lane % 4) + e.
template <int E, bool kTurns>
__global__ void __launch_bounds__(kWgThreads, 1) ln_gemm_wg(
    const __grid_constant__ CUtensorMap y_map, const __grid_constant__ CUtensorMap w_map,
    const WgArgs args) {
  using Plan = WgPlan<E, kTurns>;
  constexpr int kUnits = Plan::kUnits;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + Plan::kBars);
  uint64_t* const empty = full + kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = (args.k + kWK - 1) / kWK;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);  // the producer, once its copies land
      // one arrival per consumer warp that reads the stage: in turns one
      // warpgroup's, else both (an idle one's too)
      mbar_init(empty + st, 4 * kUnits);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: per depth chunk the item's boxes of y and of W
    regs_shrink<40>();
    if (warp != 8 || lane != 0) return;
    int it = 0;  // chunks issued by this block, over all its items
    for (int item = blockIdx.x; item < args.items; item += gridDim.x) {
      const int group = item / args.n_tiles;
      const int n0 = (item - group * args.n_tiles) * kWgN;
      const int live = min(kUnits, args.units - kUnits * group);
      int img[kUnits], tile[kUnits];
      for (int w = 0; w < live; ++w) {
        const int u = kUnits * group + w;
        img[w] = u / args.unit_tiles;
        tile[w] = u - img[w] * args.unit_tiles;
      }
      for (int kc = 0; kc < chunks; ++kc, ++it) {
        const int stage = it % kStages;
        mbar_wait(empty + stage, ((it / kStages) & 1) ^ 1);
        unsigned char* const dst = smem + stage * Plan::kStage;
        mbar_arrive_expect_tx(full + stage, live * kTileA + kTileB);
        for (int w = 0; w < live; ++w) {
          tma_load(dst + w * kTileA, &y_map, kc * kWK, tile[w] * kUnit, img[w], full + stage);
        }
        tma_load(dst + kUnits * kTileA, &w_map, kc * kWK, n0, 0, full + stage);
      }
    }
    return;
  }

  regs_grow<232>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int N = args.n;
  // Turns (K8): warpgroup w waits on named barrier 1 + w and hands the tensor
  // cores on with an arrival at the other's once it has issued an item's
  // last product. Warpgroup 0 goes first; the last item of the block hands
  // nothing on, so every barrier phase meets 128 waiting and 128 arriving
  // threads.
  const int mine = 1 + wg, theirs = 2 - wg;
  if (kTurns && wg == 1) named_arrive(1, 256);
  auto release = [&](int chunk) {  // the chunk's products are done: its stage is free
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + chunk % kStages);
  };
  float acc[kWgN / 2];
  // In turns warpgroup w takes the block's items w, w + 2, ...; otherwise
  // both take every item. j counts the block's items, so the item's first
  // chunk is the ring's j chunks-th.
  for (int j = kTurns ? wg : 0;; j += kTurns ? 2 : 1) {
    const int item = blockIdx.x + j * static_cast<int>(gridDim.x);
    if (item >= args.items) break;
    const int group = item / args.n_tiles;
    const int n0 = (item - group * args.n_tiles) * kWgN;
    const int u = kUnits * group + (kTurns ? 0 : wg);
#pragma unroll
    for (int i = 0; i < kWgN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    if (kTurns) named_barrier(mine, 256);
    int it = j * chunks;
    for (int kc = 0; kc < chunks; ++kc, ++it) {
      const int stage = it % kStages;
      mbar_wait(full + stage, (it / kStages) & 1);
      // an odd unit count leaves warpgroup 1 without a unit on the last pair
      // (K7): it multiplies what its slot of the stage holds and stores
      // nothing, so that no product sits on a divergent path (which ptxas
      // serialises)
      const uint32_t a_tile = smem_addr(smem + stage * Plan::kStage + (kTurns ? 0 : wg) * kTileA);
      const uint32_t b_tile = smem_addr(smem + stage * Plan::kStage + kUnits * kTileA);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        Wgmma<kWgN>::ss<0, 0>(acc, desc_k_major<kWK>(a_tile, kUnit, 0, 16 * kk),
                              desc_k_major<kWK>(b_tile, kWgN, 0, 16 * kk), kc > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kc > 0) release(it - 1);
    }
    if (kTurns && item + static_cast<int>(gridDim.x) < args.items) named_arrive(theirs, 256);
    wgmma_wait<0>();
    fence_regs(acc);
    release(it - 1);  // the item's last chunk
    if (u >= args.units) continue;

    const int img = u / args.unit_tiles;
    const int row0 = (u - img * args.unit_tiles) * kUnit;  // the unit's first row in its image
    if constexpr (E == kHeads) {
      const int rows = args.rows, hd = args.hd, heads = args.heads, c = N / 3;
      __nv_bfloat16* const outs[3] = {args.out0, args.out1, args.out2};
      const int row_a = row0 + 16 * wq + g;  // and row_a + 8
      const bool live_row[2] = {row_a < rows, row_a + 8 < rows};
#pragma unroll
      for (int j8 = 0; j8 < kWgN / 8; ++j8) {
        const int col = n0 + 8 * j8 + 2 * t;  // N is a multiple of 8: col + 1 < N too
        if (col >= N) continue;
        const float2 b = args.bias != nullptr
                             ? __ldg(reinterpret_cast<const float2*>(args.bias + col))
                             : make_float2(0.f, 0.f);
        const int part = col / c, within = col - part * c;
        const int head = within / hd, lane_hd = within - head * hd;  // hd is even: one head a pair
        __nv_bfloat16* const dst = outs[part] +
                                   ((static_cast<size_t>(img) * heads + head) * rows + row_a) * hd +
                                   lane_hd;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (live_row[h]) {
            *reinterpret_cast<__nv_bfloat162*>(dst + 8 * h * hd) = __floats2bfloat162_rn(
                acc[4 * j8 + 2 * h] + b.x, acc[4 * j8 + 2 * h + 1] + b.y);
          }
        }
      }
    } else {
      // + bias, GELU, one rounding, into the warpgroup's tile; columns past
      // N (zeros from the copy engine) are never stored
      unsigned char* const out_tile = smem + Plan::kOut + wg * kTileOut;
      named_barrier(3 + wg, 128);  // the tile before is read out
#pragma unroll
      for (int j8 = 0; j8 < kWgN / 8; ++j8) {
        const int c = 8 * j8 + 2 * t, col = n0 + c;  // N is even: col + 1 < N too
        const float2 b = args.bias != nullptr && col < N
                             ? __ldg(reinterpret_cast<const float2*>(args.bias + col))
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j8 + 2 * h] + b.x, v1 = acc[4 * j8 + 2 * h + 1] + b.y;
          if constexpr (E == kRowsGelu) {
            v0 = gelu_sigmoid(v0);
            v1 = gelu_sigmoid(v1);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              out_tile + panel_offset<kWgN>(kUnit, 16 * wq + g + 8 * h, c)) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      named_barrier(3 + wg, 128);  // the tile is in shared memory
      // a warp a row: lane l copies the row's 16 bytes at column 8 l
      const int c8 = 8 * lane, col = n0 + c8;
      const bool vec16 = N % 8 == 0;
      for (int r = wq; r < kUnit; r += 4) {
        const int row = row0 + r;
        if (row >= args.rows) break;
        const uint4 v = *reinterpret_cast<const uint4*>(out_tile + panel_offset<kWgN>(kUnit, r, c8));
        __nv_bfloat16* const dst = args.out0 + static_cast<size_t>(row) * N + col;
        if (vec16) {
          if (col < N) *reinterpret_cast<uint4*>(dst) = v;
        } else {  // rows 4-byte aligned only
          const uint32_t pair[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (col + 2 * e < N) *reinterpret_cast<uint32_t*>(dst + 2 * e) = pair[e];
          }
        }
      }
    }
  }
}

// Launches ln_gemm_wg<E, kTurns> over y (images, rows, c) against w (n, c):
// persistent, one block per SM (or per item, where there are fewer).
template <int E, bool kTurns>
cudaError_t launch_gemm_wg(const void* y, const void* w, int images, int rows, int c, int n,
                           int heads, const float* bias, void* out0, void* out1, void* out2,
                           cudaStream_t stream) {
  using Plan = WgPlan<E, kTurns>;
  CUtensorMap y_map, w_map;
  if (rows_map(&y_map, y, c, rows, images, kUnit) != 0 ||
      rows_map(&w_map, w, c, n, 1, kWgN) != 0) {
    return cudaErrorInvalidValue;
  }
  const int unit_tiles = (rows + kUnit - 1) / kUnit;
  const long long units = static_cast<long long>(images) * unit_tiles;
  const long long groups = (units + Plan::kUnits - 1) / Plan::kUnits;
  const int n_tiles = (n + kWgN - 1) / kWgN;
  if (units > 2147483647LL || groups * n_tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int items = static_cast<int>(groups * n_tiles);
  using bf16 = __nv_bfloat16;
  const WgArgs args{rows, c, n, unit_tiles, static_cast<int>(units), n_tiles, items, heads,
                    heads > 0 ? c / heads : 0, bias, static_cast<bf16*>(out0),
                    static_cast<bf16*>(out1), static_cast<bf16*>(out2)};
  cudaError_t err = cudaFuncSetAttribute(ln_gemm_wg<E, kTurns>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Plan::kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  ln_gemm_wg<E, kTurns><<<items < sms ? items : sms, kWgThreads, Plan::kSmem, stream>>>(
      y_map, w_map, args);
  return cudaGetLastError();
}

cudaError_t launch_qkv_bf16(const void* x, const float* lns, const float* lnb, const void* w,
                            const float* bias, int batch, int n_tok, int c, int heads, void* y,
                            void* q, void* k, void* v, cudaStream_t stream) {
  using T = __nv_bfloat16;
  cudaError_t err = launch_ln_rows<T>(static_cast<const T*>(x), lns, lnb,
                                      static_cast<long long>(batch) * n_tok, c,
                                      static_cast<T*>(y), nullptr, stream);
  if (err != cudaSuccess) return err;
  return launch_gemm_wg<kHeads, false>(y, w, batch, n_tok, c, 3 * c, heads, bias, q, k, v,
                                       stream);
}

cudaError_t launch_dense_bf16(const void* x, const float* lns, const float* lnb, const void* w,
                              const float* bias, int rows, int c, int m, int gelu, void* y,
                              void* out, cudaStream_t stream) {
  using T = __nv_bfloat16;
  cudaError_t err = launch_ln_rows<T>(static_cast<const T*>(x), lns, lnb, rows, c,
                                      static_cast<T*>(y), nullptr, stream);
  if (err != cudaSuccess) return err;
  if (gelu) {
    return launch_gemm_wg<kRowsGelu, true>(y, w, 1, rows, c, m, 0, bias, out, nullptr, nullptr,
                                           stream);
  }
  return launch_gemm_wg<kRows, true>(y, w, 1, rows, c, m, 0, bias, out, nullptr, nullptr,
                                     stream);
}

}  // namespace

// C entry points bound with ctypes; each returns a cudaError_t code. dtype:
// 0 = float32, 1 = bfloat16. All tensors contiguous and 16-byte aligned; lns,
// lnb and bias float32; bias may be null. y: a bfloat16 scratch for the
// normalised rows, the shape of x (bf16 only; float32 passes null).
//
// K7: x (batch, n_tok, c), w (3c, c) in torch Linear layout, q / k / v
// (batch, heads, n_tok, hd) with heads hd = c. c a multiple of 8, hd even.
extern "C" int xmir_ln_qkv(const void* x, const float* lns, const float* lnb, const void* w,
                           const float* bias, int dtype, int batch, int n_tok, int c,
                           int heads, void* y, void* q, void* k, void* v, void* stream) {
  if (batch < 1 || batch > kMaxGridY || n_tok < 1 || heads < 1 || c < 8 || c % 8 != 0 ||
      c % heads != 0 || (c / heads) % 2 != 0 || tiles_of(3 * c, kBN) > kMaxGridY) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const LnArgs args{static_cast<const float*>(x), static_cast<const float*>(w), bias, lns, lnb,
                      n_tok, c, 3 * c, static_cast<float*>(q), static_cast<float*>(k),
                      static_cast<float*>(v), heads, c / heads};
    return (int)launch_qkv_f32(args, batch, s);
  }
  if (dtype == 1) {
    if (y == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_qkv_bf16(x, lns, lnb, w, bias, batch, n_tok, c, heads, y, q, k, v, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K8: x (rows, c), w (m, c) in torch Linear layout, out (rows, m); gelu != 0
// applies the tanh-GELU. c a multiple of 8, m even.
extern "C" int xmir_ln_dense(const void* x, const float* lns, const float* lnb, const void* w,
                             const float* bias, int dtype, int rows, int c, int m, int gelu,
                             void* y, void* out, void* stream) {
  if (rows < 1 || c < 8 || c % 8 != 0 || m < 2 || m % 2 != 0 ||
      tiles_of(m, kBN) > kMaxGridY) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const LnArgs args{static_cast<const float*>(x), static_cast<const float*>(w), bias, lns, lnb,
                      rows, c, m, static_cast<float*>(out), nullptr, nullptr, 0, 0};
    return (int)launch_dense_f32(args, gelu, s);
  }
  if (dtype == 1) {
    if (y == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_dense_bf16(x, lns, lnb, w, bias, rows, c, m, gelu, y, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
