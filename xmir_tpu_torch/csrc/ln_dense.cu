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
// operations in bf16.
//
// K7 in bf16 (every DINOv2 block in inference and training), two launches:
//   ln_rows (gemm_tile.cuh)   each row normalised once (f32 statistics, the
//       fast variance, eps 1e-6) and rounded to bf16 into a (B, N, C)
//       scratch y the wrapper allocates: 2 B N C bytes each way (34 MB at
//       B = 16, ~20 us), where the tile loop below recomputes each row's
//       statistics in every one of the 3C / 128 column tiles.
//   ln_qkv_wg   y . W^T on wgmma, persistent (a block per SM): an item is
//       two 64-row units (each of one image: 1370 tokens are 21 units and a
//       ragged 22nd, whose rows past N the copy engine reads as zeros and
//       the epilogue never stores) by 256 columns of 3C; two consumer
//       warpgroups, one unit each (m64n256k16, 128 accumulators a thread),
//       and a producer warpgroup that streams the units' 64 x 64 tiles of y
//       and the 256 x 64 tiles of W (K-major as torch's Linear stores it)
//       into a four-stage ring by the copy engine and gives its registers to
//       the consumers (setmaxnreg). The ring runs on from one item to the
//       next, so the next item's loads land under this one's epilogue.
//       Epilogue: + bias in f32, one rounding, each column pair stored
//       straight to its head: column j of the 3C goes to tensor j / C, head
//       (j mod C) / hd, lane j mod hd, row n of (B, H, N, hd), the layout K2
//       reads, with no transpose pass.
//   It takes every shape ln_qkv_eligible admits and any C that is a
//   multiple of 8 with an even head width (depth past C and columns past 3C
//   read as zeros); x, W and the outputs must be 16-byte aligned (the copy
//   engine's rule, which the wrapper checks).
//
// f32 (under XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1), and K8 in both dtypes, on
// gemm_tile.cuh's 128 x 128 tile loop (mma.sync in bf16, IEEE f32 FMAs, no
// TF32), each row tile's statistics recomputed by every column tile:
//   ln_qkv<T>    grid (row tiles of one image, 3C / 128, B), rows tiled per
//       image so that the ragged last tile is predicated and x is never
//       padded in device memory; the head-major store as above.
//   ln_dense<T, kGelu>   grid (row tiles of R, M / 128): row-major (R, M).

#include "gemm_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxGridY = 65535;  // gridDim.y and gridDim.z

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// Whether acc[i][j], acc[i][j + 1] (j even) are neighbouring columns of one
// row, so that an epilogue can store them as a pair.
template <typename T>
struct Pairs;
template <>
struct Pairs<float> {
  static constexpr bool kValue = false;  // columns 16 apart
};
template <>
struct Pairs<__nv_bfloat16> {
  static constexpr bool kValue = true;  // the mma.sync fragment's column pair
};

struct LnArgs {
  const void* x;      // (B, rows, K) in T
  const void* w;      // (N, K) in T
  const float* bias;  // (N,) or null
  const float* lns;   // (K,)
  const float* lnb;   // (K,)
  int rows, k, n;
  // ln_qkv: out0..2 = q, k, v (B, H, rows, hd), n = 3 heads hd
  // ln_dense: out0 = (rows, n)
  void* out0;
  void* out1;
  void* out2;
  int heads, hd;
};

// Calls emit(i, j, m, n, v0, v1) for the tile's live outputs, v = acc + bias
// in f32: one column at a time (v1 unused, pair false) or, where the layout
// holds neighbouring columns, two (n even, n + 1 < N because N is even).
template <typename T, typename F>
__device__ __forceinline__ void for_outputs(const float (&acc)[8][8], const float* bias_ptr,
                                            int m0, int n0, int rows, int N, F emit) {
  using Ly = Layout<T>;
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
    if constexpr (Pairs<T>::kValue) {
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const int n = n0 + Ly::col_of(j);
        if (n < N) emit(m, n, acc[i][j] + bias[j], acc[i][j + 1] + bias[j + 1], true);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + Ly::col_of(j);
        if (n < N) emit(m, n, acc[i][j] + bias[j], 0.f, false);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ln_qkv(LnArgs args) {
  __shared__ TileShared<T> sm;
  const int img = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rows = args.rows, K = args.k, N = args.n;
  float acc[8][8];
  gemm_tile<T, kLayerNorm>(static_cast<const T*>(args.x) + (size_t)img * rows * K,
                           static_cast<const T*>(args.w), rows, K, N, m0, n0, args.lns,
                           args.lnb, nullptr, sm, acc);
  const int hd = args.hd, heads = args.heads, c = heads * hd;
  T* const outs[3] = {static_cast<T*>(args.out0), static_cast<T*>(args.out1),
                      static_cast<T*>(args.out2)};
  for_outputs<T>(acc, args.bias, m0, n0, rows, N,
                 [&](int m, int n, float v0, float v1, bool pair) {
                   const int part = n / c, within = n - part * c;
                   const int head = within / hd, lane = within - head * hd;
                   T* dst = outs[part] +
                            (((size_t)img * heads + head) * rows + m) * hd + lane;
                   if (pair) {
                     store2(dst, v0, v1);  // hd is even: a pair never straddles heads
                   } else {
                     store(dst, v0);
                   }
                 });
}

template <typename T, bool kGelu>
__global__ void __launch_bounds__(kThreads, 2) ln_dense(LnArgs args) {
  __shared__ TileShared<T> sm;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rows = args.rows, K = args.k, N = args.n;
  float acc[8][8];
  gemm_tile<T, kLayerNorm>(static_cast<const T*>(args.x), static_cast<const T*>(args.w), rows,
                           K, N, m0, n0, args.lns, args.lnb, nullptr, sm, acc);
  T* const out = static_cast<T*>(args.out0);
  for_outputs<T>(acc, args.bias, m0, n0, rows, N,
                 [&](int m, int n, float v0, float v1, bool pair) {
                   if constexpr (kGelu) {
                     v0 = gelu_tanh(v0);
                     v1 = gelu_tanh(v1);
                   }
                   T* dst = out + (size_t)m * N + n;
                   if (pair) {
                     store2(dst, v0, v1);
                   } else {
                     store(dst, v0);
                   }
                 });
}

int tiles_of(int n, int tile) { return (n + tile - 1) / tile; }

template <typename T>
cudaError_t launch_qkv(const LnArgs& args, int batch, cudaStream_t stream) {
  const dim3 grid(tiles_of(args.rows, kBM), tiles_of(args.n, kBN), batch);
  ln_qkv<T><<<grid, kThreads, 0, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dense(const LnArgs& args, int gelu, cudaStream_t stream) {
  const dim3 grid(tiles_of(args.rows, kBM), tiles_of(args.n, kBN), 1);
  if (gelu) {
    ln_dense<T, true><<<grid, kThreads, 0, stream>>>(args);
  } else {
    ln_dense<T, false><<<grid, kThreads, 0, stream>>>(args);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K7 in bf16

constexpr int kUnit = 64;                       // rows of one image a warpgroup owns
constexpr int kWK = 64;                         // depth a ring stage: one 128-byte panel
constexpr int kQkvBN = 256;                     // output columns a block
constexpr int kQkvStages = 4;
constexpr int kQkvA = kUnit * kWK * 2;          // one unit's tile of y
constexpr int kQkvB = kQkvBN * kWK * 2;         // the weight's tile
constexpr int kQkvStage = 2 * kQkvA + kQkvB;
constexpr int kQkvBars = kQkvStages * kQkvStage;
constexpr int kQkvSmem = kQkvBars + 2 * kQkvStages * 8 + 1024;
constexpr int kQkvThreads = 384;                // two consumer warpgroups, one producer

struct QkvArgs {
  int rows, k, n;       // tokens of an image, C, 3C
  int unit_tiles;       // 64-row units of an image
  int units;            // ... of the batch
  int n_tiles;          // column tiles of kQkvBN
  int items;            // (unit pair, column tile) items: pairs x n_tiles
  int heads, hd;
  const float* bias;    // (n,) or null
  __nv_bfloat16* out0;  // q, k, v: (B, heads, rows, hd)
  __nv_bfloat16* out1;
  __nv_bfloat16* out2;
};

// Persistent: block b takes items b, b + gridDim.x, ... in order. Item i is
// units 2 p and 2 p + 1 (p = i / n_tiles; an odd count leaves warpgroup 1
// idle on the last pair) by columns n0 .. n0 + 255. The ring runs on across
// items, so the producer loads the next item's first chunks while the
// consumers store this one. Consumer warpgroup w owns unit 2 p + w; a thread
// holds rows g = lane / 4 and g + 8 of its warp's 16, element 4 j + 2 h + e
// of acc at row + 8 h, column n0 + 8 j + 2 (lane % 4) + e.
__global__ void __launch_bounds__(kQkvThreads, 1) ln_qkv_wg(
    const __grid_constant__ CUtensorMap y_map, const __grid_constant__ CUtensorMap w_map,
    const QkvArgs args) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + kQkvBars);
  uint64_t* const empty = full + kQkvStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = (args.k + kWK - 1) / kWK;

  if (tid == 0) {
    for (int st = 0; st < kQkvStages; ++st) {
      mbar_init(full + st, 1);   // the producer, once its copies land
      mbar_init(empty + st, 8);  // one arrival per consumer warp, an idle one's too
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: per depth chunk each unit's tile of y and the weight tile
    regs_shrink<40>();
    if (warp != 8 || lane != 0) return;
    int it = 0;  // chunks issued by this block, over all its items
    for (int item = blockIdx.x; item < args.items; item += gridDim.x) {
      const int pair = item / args.n_tiles;
      const int n0 = (item - pair * args.n_tiles) * kQkvBN;
      const int live = min(2, args.units - 2 * pair);
      int img[2], tile[2];
      for (int w = 0; w < live; ++w) {
        const int u = 2 * pair + w;
        img[w] = u / args.unit_tiles;
        tile[w] = u - img[w] * args.unit_tiles;
      }
      for (int kc = 0; kc < chunks; ++kc, ++it) {
        const int stage = it % kQkvStages;
        mbar_wait(empty + stage, ((it / kQkvStages) & 1) ^ 1);
        unsigned char* const dst = smem + stage * kQkvStage;
        mbar_arrive_expect_tx(full + stage, live * kQkvA + kQkvB);
        for (int w = 0; w < live; ++w) {
          tma_load(dst + w * kQkvA, &y_map, kc * kWK, tile[w] * kUnit, img[w], full + stage);
        }
        tma_load(dst + 2 * kQkvA, &w_map, kc * kWK, n0, 0, full + stage);
      }
    }
    return;
  }

  regs_grow<232>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  const int rows = args.rows, N = args.n;
  const int hd = args.hd, heads = args.heads, c = N / 3;
  __nv_bfloat16* const outs[3] = {args.out0, args.out1, args.out2};
  float acc[kQkvBN / 2];
  int it = 0;  // chunks consumed, as the producer counts them
  for (int item = blockIdx.x; item < args.items; item += gridDim.x) {
    const int pair = item / args.n_tiles;
    const int n0 = (item - pair * args.n_tiles) * kQkvBN;
    const bool mine = wg < min(2, args.units - 2 * pair);
#pragma unroll
    for (int i = 0; i < kQkvBN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int kc = 0; kc < chunks; ++kc, ++it) {
      const int stage = it % kQkvStages;
      mbar_wait(full + stage, (it / kQkvStages) & 1);
      if (mine) {
        const uint32_t a_tile = smem_addr(smem + stage * kQkvStage + wg * kQkvA);
        const uint32_t b_tile = smem_addr(smem + stage * kQkvStage + 2 * kQkvA);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk) {
          Wgmma<kQkvBN>::ss<0, 0>(acc, desc_k_major<kWK>(a_tile, kUnit, 0, 16 * kk),
                                           desc_k_major<kWK>(b_tile, kQkvBN, 0, 16 * kk),
                                           kc > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
      }
      if (kc > 0) {  // the chunk before is done: its stage is free
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (it - 1) % kQkvStages);
      }
    }
    if (mine) wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + (it - 1) % kQkvStages);  // the item's last chunk
    if (!mine) continue;

    const int u = 2 * pair + wg, img = u / args.unit_tiles;
    const int row_a = (u - img * args.unit_tiles) * kUnit + 16 * wq + g;  // and row_a + 8
    const bool live_row[2] = {row_a < rows, row_a + 8 < rows};
#pragma unroll
    for (int j = 0; j < kQkvBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * t;  // N is a multiple of 8: col + 1 < N too
      if (col >= N) continue;
      const float2 b = args.bias != nullptr
                           ? __ldg(reinterpret_cast<const float2*>(args.bias + col))
                           : make_float2(0.f, 0.f);
      const int part = col / c, within = col - part * c;
      const int head = within / hd, lane_hd = within - head * hd;  // hd is even: one head a pair
      __nv_bfloat16* const dst =
          outs[part] + ((static_cast<size_t>(img) * heads + head) * rows + row_a) * hd + lane_hd;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (live_row[h]) {
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * h * hd) = __floats2bfloat162_rn(
              acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);
        }
      }
    }
  }
}

cudaError_t launch_qkv_bf16(const void* x, const float* lns, const float* lnb, const void* w,
                            const float* bias, int batch, int n_tok, int c, int heads, void* y,
                            void* q, void* k, void* v, cudaStream_t stream) {
  using T = __nv_bfloat16;
  cudaError_t err = launch_ln_rows<T>(static_cast<const T*>(x), lns, lnb,
                                      static_cast<long long>(batch) * n_tok, c,
                                      static_cast<T*>(y), nullptr, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap y_map, w_map;
  if (rows_map(&y_map, y, c, n_tok, batch, kUnit) != 0 ||
      rows_map(&w_map, w, c, 3 * c, 1, kQkvBN) != 0) {
    return cudaErrorInvalidValue;
  }
  const int unit_tiles = (n_tok + kUnit - 1) / kUnit;
  const long long units = static_cast<long long>(batch) * unit_tiles;
  const long long pairs = (units + 1) / 2;
  const int n_tiles = (3 * c + kQkvBN - 1) / kQkvBN;
  if (pairs * n_tiles > 2147483647LL) return cudaErrorInvalidValue;
  const int items = static_cast<int>(pairs * n_tiles);
  const QkvArgs args{n_tok, c, 3 * c, unit_tiles, static_cast<int>(units), n_tiles, items,
                     heads, c / heads, bias, static_cast<T*>(q), static_cast<T*>(k),
                     static_cast<T*>(v)};
  err = cudaFuncSetAttribute(ln_qkv_wg, cudaFuncAttributeMaxDynamicSharedMemorySize, kQkvSmem);
  if (err != cudaSuccess) return err;
  // persistent: one block per SM (or per item, where there are fewer)
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  ln_qkv_wg<<<items < sms ? items : sms, kQkvThreads, kQkvSmem, stream>>>(y_map, w_map, args);
  return cudaGetLastError();
}

}  // namespace

// C entry points bound with ctypes; each returns a cudaError_t code. dtype:
// 0 = float32, 1 = bfloat16. All tensors contiguous and 16-byte aligned; lns,
// lnb and bias float32; bias may be null.
//
// K7: x (batch, n_tok, c), w (3c, c) in torch Linear layout, q / k / v
// (batch, heads, n_tok, hd) with heads hd = c. c a multiple of 8, hd even.
// y: a (batch, n_tok, c) bfloat16 scratch for the normalised rows (bf16
// only; float32 passes null).
extern "C" int xmir_ln_qkv(const void* x, const float* lns, const float* lnb, const void* w,
                           const float* bias, int dtype, int batch, int n_tok, int c,
                           int heads, void* y, void* q, void* k, void* v, void* stream) {
  if (batch < 1 || batch > kMaxGridY || n_tok < 1 || heads < 1 || c < 8 || c % 8 != 0 ||
      c % heads != 0 || (c / heads) % 2 != 0 || tiles_of(3 * c, kBN) > kMaxGridY) {
    return (int)cudaErrorInvalidValue;
  }
  const LnArgs args{x, w, bias, lns, lnb, n_tok, c, 3 * c, q, k, v, heads, c / heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_qkv<float>(args, batch, s);
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
                             void* out, void* stream) {
  if (rows < 1 || c < 8 || c % 8 != 0 || m < 2 || m % 2 != 0 ||
      tiles_of(m, kBN) > kMaxGridY) {
    return (int)cudaErrorInvalidValue;
  }
  const LnArgs args{x, w, bias, lns, lnb, rows, c, m, out, nullptr, nullptr, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_dense<float>(args, gelu, s);
  if (dtype == 1) return (int)launch_dense<__nv_bfloat16>(args, gelu, s);
  return (int)cudaErrorInvalidValue;
}
