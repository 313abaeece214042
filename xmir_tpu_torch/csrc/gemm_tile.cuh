// A 128 x 128 output tile of act(A) . W^T for Hopper (sm_90a), shared by the
// kernels whose body is "rows transformed on their way into shared memory, a
// GEMM against a torch Linear weight (out, in), an epilogue":
// the f32 bodies of convnext_block.cu (K9, K11), convnext_block_bwd.cu
// (K10) and ln_dense.cu (K7, K8). Also the LayerNorm pre-pass ``ln_rows``
// whose output the bf16 wgmma bodies of K7, K8, K9 and K10 read through the
// copy engine, and the tanh-GELU in both forms (gelu_tanh, gelu_sigmoid).
//
// gemm_tile<T, P> leaves the tile's f32 sums in acc[8][8] per thread; the
// including source adds its epilogue (Layout<T>::row_of / col_of place an
// entry in the tile). T is float (IEEE f32 FMAs, no TF32); every bf16 body
// is on wgmma (wgmma.cuh). The prologue P transforms A's rows in f32 before
// the product:
//   kNone       A as it is
//   kLayerNorm  (a - mean) * rstd * p0 + p1 over the K axis: f32 statistics
//               of the tile's rows with the fast variance
//               max(E[x^2] - mean^2, 0), eps 1e-6, taken before the depth loop
//   kGrn        p0 * (a * p2) + p1 + a (ConvNeXtV2's GRN apply)
// A's rows are tiled per image (blockIdx.z): rows past the image's last are
// predicated, never read, and contribute zeros. The loop is register-staged
// and double-buffered: the next depth chunk is loaded into registers while
// this one computes, then transformed and stored to the other shared buffer.
//
// Operands: A (rows, K) row-major and W (N, K) row-major, both K-contiguous;
// K a multiple of 8, pointers 16-byte aligned. Everything here has internal linkage: each source that
// includes the header compiles its own copy.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kBM = 128;       // rows of one image per block
constexpr int kBN = 128;       // output columns per block
constexpr int kGroups = 16;    // threads sharing an output column
constexpr float kLnEps = 1e-6f;
constexpr float kGeluK0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluK1 = 0.044715f;

enum Prologue { kNone = 0, kLayerNorm = 1, kGrn = 2 };

// Shared-memory tile geometry. Each thread loads two rows of one 16-byte
// vector per operand per stage, so a stage is 4 vectors deep. kVec: the
// elements of a 16-byte vector (ln_rows reads bf16 rows by it too).
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int kVec = 4;
  static constexpr int kBK = 16;
  static constexpr int kStride = kBK + 1;  // padded: conflict-free column reads
  static constexpr int kStage = kBM * kStride;  // one operand's stage (kBM == kBN)
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kVec = 8;
};

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// v rounded to T and widened back (the identity for f32).
__device__ __forceinline__ float round_to(float v, float) { return v; }
__device__ __forceinline__ float round_to(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// kVec floats, already representable in T, into shared memory at dst.
__device__ __forceinline__ void stash_vec(float* dst, const float (&f)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = f[e];  // odd row stride: no vector store
}
__device__ __forceinline__ void stash_vec(__nv_bfloat16* dst, const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void stash_raw(float* dst, const uint4& v) {
  float f[4];
  unpack(v, f);
  stash_vec(dst, f);
}

__device__ __forceinline__ uint4 ldg16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <int N>
__device__ __forceinline__ void load_floats(float (&f)[N], const float* p) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
    f[i] = v.x;
    f[i + 1] = v.y;
    f[i + 2] = v.z;
    f[i + 3] = v.w;
  }
}

// The block's 128 x 128 output tile is held as acc[8][8] per thread;
// row_of / col_of give an entry's place in the tile, and group_of the
// thread's place among the kGroups threads that share its columns: thread
// (ty, tx) = (t / 16, t % 16) owns rows ty + 16 i, cols tx + 16 j.
template <typename T>
struct Layout;

template <>
struct Layout<float> {
  static __device__ __forceinline__ int row_of(int i) { return (threadIdx.x >> 4) + 16 * i; }
  static __device__ __forceinline__ int col_of(int j) { return (threadIdx.x & 15) + 16 * j; }
  static __device__ __forceinline__ int group_of() { return threadIdx.x >> 4; }

  // One stage: acc += A_tile (kBM x kBK) . B_tile (kBN x kBK)^T.
  static __device__ __forceinline__ void compute(const float* as, const float* bs,
                                                 float (&acc)[8][8]) {
    constexpr int S = Tile<float>::kStride;
    const float* a = as + (threadIdx.x >> 4) * S;
    const float* b = bs + (threadIdx.x & 15) * S;
#pragma unroll
    for (int k = 0; k < Tile<float>::kBK; ++k) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a[16 * i * S + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = b[16 * j * S + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
};

__device__ __forceinline__ float gelu_tanh(float v) {
  return v * (0.5f * (1.f + tanhf(kGeluK0 * (v + kGeluK1 * v * v * v))));
}

// tanh-GELU as v sigma(2 u), u = k0 (v + k1 v^3): the same function as
// gelu_tanh, with one exp2 and one reciprocal on the special-function units
// in place of tanhf, and no cancellation in 1 + tanh(u) (where that form
// rounds 1 + tanh(u) to a multiple of 2^-24, below |GELU| ~ 1e-6, this one
// keeps the tail). The bf16 epilogues of K8 (ln_dense.cu) and K9
// (convnext_block.cu) take it.
__device__ __forceinline__ float gelu_sigmoid(float v) {
  const float u = kGeluK0 * (v + kGeluK1 * v * v * v);
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(-2.8853900817779268f * u));  // e^(-2u)
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return v * r;
}

// y = LayerNorm(a) per row, rounded to T, and (when stats is not null) the
// row's (mean, rstd): a warp a row, 16-byte vectors, f32 statistics with the
// fast variance max(E[x^2] - mean^2, 0) and eps 1e-6, as the kLayerNorm
// prologue below takes them. K7, K8 and K9 (bf16) and K10 normalise each row
// once here and feed the normalised rows to their products.
template <typename T>
__global__ void __launch_bounds__(kThreads) ln_rows(const T* __restrict__ a,
                                                    const float* __restrict__ ln_scale,
                                                    const float* __restrict__ ln_bias,
                                                    long long n_rows, int C, T* __restrict__ y,
                                                    float2* __restrict__ stats) {
  constexpr int kVec = Tile<T>::kVec;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const T* src = a + row * C;
  float s = 0.f, ss = 0.f;
  for (int k = lane * kVec; k < C; k += 32 * kVec) {
    float f[kVec];
    unpack(ldg16(src + k), f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      s += f[e];
      ss += f[e] * f[e];
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float mean = s / C;
  const float rstd = rsqrtf(fmaxf(ss / C - mean * mean, 0.f) + kLnEps);
  if (stats != nullptr && lane == 0) stats[row] = make_float2(mean, rstd);
  T* dst = y + row * C;
  for (int k = lane * kVec; k < C; k += 32 * kVec) {
    float f[kVec], sc[kVec], bi[kVec];
    unpack(ldg16(src + k), f);
    load_floats(sc, ln_scale + k);
    load_floats(bi, ln_bias + k);
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = round_to((f[e] - mean) * rstd * sc[e] + bi[e], T());
    stash_vec(dst + k, f);
  }
}

// Launches ln_rows over n_rows rows of width C (a multiple of 8).
template <typename T>
cudaError_t launch_ln_rows(const T* a, const float* ln_scale, const float* ln_bias,
                           long long n_rows, int C, T* y, float2* stats, cudaStream_t stream) {
  constexpr int per_block = kThreads / 32;
  ln_rows<T><<<static_cast<unsigned>((n_rows + per_block - 1) / per_block), kThreads, 0,
               stream>>>(a, ln_scale, ln_bias, n_rows, C, y, stats);
  return cudaGetLastError();
}

// The tile loop's shared memory: two stages of each operand, and the row
// statistics of the kLayerNorm prologue. After gemm_tile returns (its last
// barrier passed) an epilogue may reuse ``tiles``.
template <typename T>
struct TileShared {
  alignas(16) unsigned char tiles[4 * Tile<T>::kStage * sizeof(T)];
  float ln_mean[kBM], ln_rstd[kBM];
};

// acc = P(A[m0 : m0 + 128]) . W[n0 : n0 + 128]^T for one image. a_img is the
// image's (rows, K) block; p0, p1 are (K,) and p2_img this image's (K,)
// vector (kGrn only). Every thread of the block must call it.
template <typename T, int P>
__device__ __forceinline__ void gemm_tile(const T* a_img, const T* w, int rows, int K, int N,
                                          int m0, int n0, const float* p0, const float* p1,
                                          const float* p2_img, TileShared<T>& sm,
                                          float (&acc)[8][8]) {
  using Ly = Layout<T>;
  constexpr int kVec = Tile<T>::kVec, kBK = Tile<T>::kBK, kS = Tile<T>::kStride;
  constexpr int kStage = Tile<T>::kStage;
  T* const a_s = reinterpret_cast<T*>(sm.tiles);  // [2][kBM][kS]
  T* const b_s = a_s + 2 * kStage;                // [2][kBN][kS]
  float* const ln_mean = sm.ln_mean;
  float* const ln_rstd = sm.ln_rstd;
  const int lr = threadIdx.x >> 2;          // this thread stages rows lr, lr + 64
  const int lk = (threadIdx.x & 3) * kVec;  // at depth lk of the stage

  if constexpr (P == kLayerNorm) {
    // f32 statistics of the block's rows, a warp per row: mean, the fast
    // variance max(E[x^2] - mean^2, 0), rsqrt(var + eps)
    const int lane = threadIdx.x & 31;
    for (int r = threadIdx.x >> 5; r < kBM; r += kThreads / 32) {
      const int m = m0 + r;
      float s = 0.f, ss = 0.f;
      if (m < rows) {
        for (int k = lane * kVec; k < K; k += 32 * kVec) {
          float f[kVec];
          unpack(ldg16(a_img + (size_t)m * K + k), f);
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            s += f[e];
            ss += f[e] * f[e];
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
      }
      if (lane == 0) {
        const float mean = s / K;
        ln_mean[r] = mean;
        ln_rstd[r] = rsqrtf(fmaxf(ss / K - mean * mean, 0.f) + kLnEps);
      }
    }
    __syncthreads();
  }

  // Staging registers: the raw next chunk, whether each A row is live (inside
  // the image and K), and the prologue's per-depth parameters.
  uint4 ra[2], rb[2];
  bool live[2];
  float pk[P == kNone ? 1 : 3][kVec];
  auto fetch = [&](int kt) {
    const int k = kt * kBK + lk;
    const bool kin = k < K;  // K is a multiple of kVec: whole vectors
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + lr + 64 * i, n = n0 + lr + 64 * i;
      live[i] = kin && m < rows;
      ra[i] = live[i] ? ldg16(a_img + (size_t)m * K + k) : make_uint4(0, 0, 0, 0);
      rb[i] = kin && n < N ? ldg16(w + (size_t)n * K + k) : make_uint4(0, 0, 0, 0);
    }
    if constexpr (P != kNone) {
      if (kin) {
        load_floats(pk[0], p0 + k);
        load_floats(pk[1], p1 + k);
        if constexpr (P == kGrn) load_floats(pk[2], p2_img + k);
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr + 64 * i;
      T* a_dst = a_s + buf * kStage + r * kS + lk;
      if constexpr (P == kNone) {
        stash_raw(a_dst, ra[i]);
      } else {
        float f[kVec];
        unpack(ra[i], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          float v;
          if constexpr (P == kLayerNorm) {
            v = (f[e] - ln_mean[r]) * ln_rstd[r] * pk[0][e] + pk[1][e];
          } else {
            v = pk[0][e] * (f[e] * pk[2][e]) + pk[1][e] + f[e];
          }
          f[e] = live[i] ? round_to(v, T()) : 0.f;  // dead rows / depth stay zero
        }
        stash_vec(a_dst, f);
      }
      stash_raw(b_s + buf * kStage + r * kS + lk, rb[i]);
    }
  };

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int k_tiles = (K + kBK - 1) / kBK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < k_tiles) fetch(kt + 1);
    Ly::compute(a_s + buf * kStage, b_s + buf * kStage, acc);
    if (kt + 1 < k_tiles) stash(buf ^ 1);
    __syncthreads();
  }
}

}  // namespace
