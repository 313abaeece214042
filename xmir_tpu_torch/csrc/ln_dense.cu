// LayerNorm fused into the projection that follows it, for Hopper (sm_90a),
// forward only.
//
// Replaces xmir_tpu/ops/ln_dense_pallas.py::_ln_qkv_pallas (K7, body
// _ln_qkv_kernel: LN(x) . W_qkv + b stored head-major as q, k, v) and
// ::_ln_dense_pallas (K8, body _ln_dense_kernel: LN(x) . W + b with an
// optional tanh-GELU). The TPU kernels keep the whole projection weight
// resident in VMEM and walk the row tiles in order; here every 128 x 128
// output tile is a block of its own (gemm_tile.cuh): its 128 rows are
// normalised on their way into shared memory, so the normalised tensor never
// goes through device memory, and the weight is read from L2.
//
// Rounding points, the TPU kernels' (:71-77, :151-165): LayerNorm in f32 with
// the fast variance, rounded to x's dtype before the product; f32
// accumulation; the bias added in f32; tanh-GELU in f32 (K8, when asked);
// one rounding to the output dtype.
//
//   ln_qkv<T>    grid (row tiles of one image, 3C / 128, B). Column j of the
//       3C-wide product goes to tensor j / C (q, k, v), head (j mod C) / hd,
//       lane j mod hd, row n of a (B, H, N, hd) tensor: the head-major
//       layout the attention kernel reads, with no transpose pass. Rows are
//       tiled per image, so the ragged last tile (N = 1370 = 10 x 128 + 90)
//       is predicated and x is never padded in device memory.
//   ln_dense<T, kGelu>   grid (row tiles of R, M / 128): row-major (R, M).
//
// What bounds them: at the DINOv2 width (C = 768, B = 16, N = 1370) K7 is
// 77.6 GFLOP against 138 MB and K8 103 GFLOP against 168 MB, both bound by
// operations in bf16. bf16 runs on the tensor cores (mma.sync m16n8k16), f32
// on IEEE f32 FMAs (no TF32). The row statistics are recomputed by every
// column tile of a row tile (x's rows come from L2); wgmma, TMA and a
// statistics pass shared between column tiles are later work.

#include "gemm_tile.cuh"

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

}  // namespace

// C entry points bound with ctypes; each returns a cudaError_t code. dtype:
// 0 = float32, 1 = bfloat16. All tensors contiguous and 16-byte aligned; lns,
// lnb and bias float32; bias may be null.
//
// K7: x (batch, n_tok, c), w (3c, c) in torch Linear layout, q / k / v
// (batch, heads, n_tok, hd) with heads hd = c. c a multiple of 8, hd even.
extern "C" int xmir_ln_qkv(const void* x, const float* lns, const float* lnb, const void* w,
                           const float* bias, int dtype, int batch, int n_tok, int c,
                           int heads, void* q, void* k, void* v, void* stream) {
  if (batch < 1 || batch > kMaxGridY || n_tok < 1 || heads < 1 || c < 8 || c % 8 != 0 ||
      c % heads != 0 || (c / heads) % 2 != 0 || tiles_of(3 * c, kBN) > kMaxGridY) {
    return (int)cudaErrorInvalidValue;
  }
  const LnArgs args{x, w, bias, lns, lnb, n_tok, c, 3 * c, q, k, v, heads, c / heads};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_qkv<float>(args, batch, s);
  if (dtype == 1) return (int)launch_qkv<__nv_bfloat16>(args, batch, s);
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
