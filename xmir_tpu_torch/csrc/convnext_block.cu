// ConvNeXtV2 block tail for Hopper (sm_90a): LayerNorm -> pw1 -> tanh-GELU
// -> GRN -> pw2 -> + residual, per image, forward only.
//
// Replaces xmir_tpu/ops/convnext_block_pallas.py::_block_fused_fwd (K9, body
// _ln_block_kernel) and ::convnext_mlp_grn_fused (K11, body _kernel: the same
// tail with the input already normalised). The TPU kernel keeps one image's
// whole expanded tensor h (R x 4C) in VMEM. On the H100 it does not fit: at
// 384 px stage 1 h is 9216 x 512, 9.4 MB in bf16, against 227 KB of shared
// memory per block; and GRN needs a statistic over all R rows of an image
// before any row of pw2 can start. So the tail runs as three launches:
//
//   gemm<.., kLayerNorm or kNone, kGeluSquares>   grid (row tiles, 4C / 128, B)
//       A prologue: the block's 128 rows are normalised on their way into
//       shared memory (f32 statistics with the fast variance, eps 1e-6,
//       rounded to the input dtype as _ln_block_kernel does at :101-107);
//       K11 skips it. GEMM1 against pw1, then + b1, tanh-GELU, rounded to
//       the dtype (:111) and stored as h; the same rounded values, squared
//       in f32, are summed per column over the block's rows into
//       part[image][row tile][column] (:112-114). A tile never straddles
//       two images: rows are tiled per image (blockIdx.z is the image).
//   grn_scale   one block per image: gx = sqrt(sum of the row tiles' partials
//       + 1e-12), nx = gx / (mean over the 4C columns of gx + 1e-6) (:115).
//       Every sum runs in a fixed order (no atomics): two runs give the same
//       bits.
//   gemm<.., kGrn, kResidual>   grid (row tiles, C / 128, B)
//       A prologue: z = gamma * (h * nx) + beta + h in f32, rounded to the
//       dtype (:116). GEMM2 against pw2, then out = x + (acc + b2) in f32,
//       rounded to the dtype (:117-120).
//
// What bounds it: the two GEMMs are 4 R C 4C FLOP per image (~2.4 GFLOP per
// block at 384 px, the same at every stage); h is written once and read once,
// against the plain PyTorch version's several passes over it (GEMM out, bias,
// GELU, square-sum, GRN apply). In bf16 the GEMMs run on the tensor cores
// (mma.sync m16n8k16, f32 accumulation, operands through ldmatrix); in f32
// on IEEE f32 FMAs (no TF32), as K1 does. This first version is a plain
// register-staged, double-buffered tile loop with two blocks per SM: the
// next depth chunk is loaded into registers while this one computes, then
// transformed (the prologue) and stored to the other shared buffer. wgmma,
// TMA and deeper pipelines are later work.
//
// Operands: activations (B, R, K) row-major and torch Linear weights (N, K)
// row-major, both K-contiguous, which is the row.col layout mma.sync takes:
// no transpose per call. The launches go on the caller's stream and allocate
// nothing: the wrapper (xmir_tpu_torch/ops/convnext_block.py) passes h, the
// partial sums, nx and the output.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kBM = 128;       // rows of one image per block
constexpr int kBN = 128;       // output columns per block
constexpr int kGroups = 16;    // threads sharing an output column (both layouts)
constexpr int kMaxBatch = 65535;  // gridDim.z
constexpr float kLnEps = 1e-6f;
constexpr float kGrnEps = 1e-12f;
constexpr float kGrnMeanEps = 1e-6f;
constexpr float kGeluK0 = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluK1 = 0.044715f;

enum Prologue { kNone = 0, kLayerNorm = 1, kGrn = 2 };
enum Epilogue { kGeluSquares = 0, kResidual = 1 };

// Shared-memory tile geometry per element type. Each thread loads two rows
// of one 16-byte vector per operand per stage, so a stage is 4 vectors deep.
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
  static constexpr int kBK = 32;
  static constexpr int kStride = kBK + 8;  // 80-byte rows: 16-byte aligned, ldmatrix conflict-free
  static constexpr int kStage = kBM * kStride;
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
__device__ __forceinline__ void stash_raw(__nv_bfloat16* dst, const uint4& v) {
  *reinterpret_cast<uint4*>(dst) = v;
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float& c0, float& c1, float& c2, float& c3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's 128 x 128 output tile is held as acc[8][8] per thread in both
// layouts; row_of / col_of give an entry's place in the tile, and group_of
// the thread's place among the kGroups threads that share its columns.
//
// f32: thread (ty, tx) = (t / 16, t % 16) owns rows ty + 16 i, cols tx + 16 j.
// bf16: warp (wm, wn) = (warp / 4, warp % 4) owns a 64 x 32 sub-tile as 4 x 4
// mma.sync m16n8 tiles; acc[2 mt + h][2 nt + c] is the fragment entry of
// m-tile mt, n-tile nt at row lane / 4 + 8 h, col 2 (lane % 4) + c.
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

template <>
struct Layout<__nv_bfloat16> {
  static __device__ __forceinline__ int lane() { return threadIdx.x & 31; }
  static __device__ __forceinline__ int warp() { return threadIdx.x >> 5; }
  static __device__ __forceinline__ int row_of(int i) {
    return (warp() >> 2) * 64 + (i >> 1) * 16 + (i & 1) * 8 + (lane() >> 2);
  }
  static __device__ __forceinline__ int col_of(int j) {
    return (warp() & 3) * 32 + (j >> 1) * 8 + (lane() & 3) * 2 + (j & 1);
  }
  static __device__ __forceinline__ int group_of() { return (warp() >> 2) * 8 + (lane() >> 2); }

  static __device__ __forceinline__ void compute(const __nv_bfloat16* as,
                                                 const __nv_bfloat16* bs,
                                                 float (&acc)[8][8]) {
    constexpr int S = Tile<__nv_bfloat16>::kStride;
    const int l = lane();
    // ldmatrix.x4 addresses: A, 16 rows x (k, k + 8) of one m-tile; B, two
    // n-tiles of 8 rows x (k, k + 8), giving (b0, b1) of each
    const __nv_bfloat16* a = as + ((warp() >> 2) * 64 + (l & 15)) * S + (l >> 4) * 8;
    const __nv_bfloat16* b =
        bs + ((warp() & 3) * 32 + (l & 7) + ((l >> 4) << 3)) * S + ((l >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < Tile<__nv_bfloat16>::kBK; kk += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(af[mt], a + mt * 16 * S + kk);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, b + np * 16 * S + kk);
        bf[2 * np][0] = r[0];
        bf[2 * np][1] = r[1];
        bf[2 * np + 1][0] = r[2];
        bf[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[2 * mt][2 * nt], acc[2 * mt][2 * nt + 1], acc[2 * mt + 1][2 * nt],
                   acc[2 * mt + 1][2 * nt + 1], af[mt], bf[nt][0], bf[nt][1]);
    }
  }
};

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

__device__ __forceinline__ float gelu_tanh(float v) {
  return v * (0.5f * (1.f + tanhf(kGeluK0 * (v + kGeluK1 * v * v * v))));
}

// Two blocks per SM (at most 128 registers a thread): one block's stall on
// its next chunk's loads hides behind the other's math (1.25x over one block
// per SM at every stage shape, PERF.md).
template <typename T, int P, int E>
__global__ void __launch_bounds__(kThreads, 2) gemm(GemmArgs args) {
  using Ly = Layout<T>;
  constexpr int kVec = Tile<T>::kVec, kBK = Tile<T>::kBK, kS = Tile<T>::kStride;
  constexpr int kStage = Tile<T>::kStage;
  static_assert(4 * kStage * (int)sizeof(T) >= kGroups * kBN * (int)sizeof(float),
                "the column-sum buffer reuses the tiles' shared memory");
  __shared__ __align__(16) unsigned char smem[4 * kStage * sizeof(T)];
  __shared__ float ln_mean[kBM], ln_rstd[kBM];
  T* const a_s = reinterpret_cast<T*>(smem);  // [2][kBM][kS]
  T* const b_s = a_s + 2 * kStage;            // [2][kBN][kS]

  const int img = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rows = args.rows, K = args.k, N = args.n;
  const T* a_img = static_cast<const T*>(args.a) + (size_t)img * rows * K;
  const T* w = static_cast<const T*>(args.w);
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
        load_floats(pk[0], args.p0 + k);
        load_floats(pk[1], args.p1 + k);
        if constexpr (P == kGrn) load_floats(pk[2], args.p2 + (size_t)img * K + k);
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

  float acc[8][8];
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

  // Epilogue. The tiles' shared memory is free after the last barrier.
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + Ly::col_of(j);
    bias[j] = n < N ? args.bias[n] : 0.f;
  }
  T* out = static_cast<T*>(args.out) + (size_t)img * rows * N;
  if constexpr (E == kGeluSquares) {
    float* red = reinterpret_cast<float*>(smem);  // [kGroups][kBN]
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

// nx[image][c] from the (image, row tile, c) partial sums of h^2.
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

int row_tiles(int rows) { return (rows + kBM - 1) / kBM; }

template <typename T>
cudaError_t launch_tail(const void* a, const void* x, const float* ln_scale,
                        const float* ln_bias, const void* w1, const float* b1, const void* w2,
                        const float* b2, const float* gamma, const float* beta, int batch,
                        int rows, int c, int c4, void* h, float* part, float* nx, void* out,
                        cudaStream_t stream) {
  const int tiles = row_tiles(rows);
  GemmArgs g1{a, w1, b1, rows, c, c4, ln_scale, ln_bias, nullptr, h, part, nullptr};
  const dim3 grid1(tiles, (c4 + kBN - 1) / kBN, batch);
  if (ln_scale != nullptr) {
    gemm<T, kLayerNorm, kGeluSquares><<<grid1, kThreads, 0, stream>>>(g1);
  } else {
    gemm<T, kNone, kGeluSquares><<<grid1, kThreads, 0, stream>>>(g1);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  grn_scale<<<batch, kThreads, 0, stream>>>(part, tiles, c4, nx);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  GemmArgs g2{h, w2, b2, rows, c4, c, gamma, beta, nx, out, nullptr, x};
  const dim3 grid2(tiles, (c + kBN - 1) / kBN, batch);
  gemm<T, kGrn, kResidual><<<grid2, kThreads, 0, stream>>>(g2);
  return cudaGetLastError();
}

}  // namespace

// C entry points bound with ctypes; each returns a cudaError_t code.
//
// xmir_convnext_plan writes the number of row tiles per image, the middle
// extent of the partial-sum buffer xmir_convnext_tail takes.
extern "C" int xmir_convnext_plan(int rows, int* tiles) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  *tiles = row_tiles(rows);
  return (int)cudaSuccess;
}

// One ConvNeXtV2 block tail. a is the dwconv output (ln_scale, ln_bias given:
// K9) or the already normalised input (both null: K11), (batch, rows, c); x
// the residual, (batch, rows, c); w1 (c4, c) and w2 (c, c4) in torch Linear
// layout; a, x, w1, w2, h and out of one dtype (0 = float32, 1 = bfloat16),
// all contiguous and 16-byte aligned; ln_scale, ln_bias (c,), b1, gamma,
// beta (c4,), b2 (c,) float32, 16-byte aligned. Scratch: h (batch, rows, c4)
// in the dtype, part (batch, row tiles, c4) and nx (batch, c4) float32.
// c and c4 must be multiples of 8.
extern "C" int xmir_convnext_tail(const void* a, const void* x, const float* ln_scale,
                                  const float* ln_bias, const void* w1, const float* b1,
                                  const void* w2, const float* b2, const float* gamma,
                                  const float* beta, int dtype, int batch, int rows, int c,
                                  int c4, void* h, float* part, float* nx, void* out,
                                  void* stream) {
  if (batch < 1 || batch > kMaxBatch || rows < 1 || c < 8 || c % 8 != 0 || c4 < 8 ||
      c4 % 8 != 0 || (ln_scale == nullptr) != (ln_bias == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_tail<float>(a, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma, beta,
                                   batch, rows, c, c4, h, part, nx, out, s);
  }
  if (dtype == 1) {
    return (int)launch_tail<__nv_bfloat16>(a, x, ln_scale, ln_bias, w1, b1, w2, b2, gamma,
                                           beta, batch, rows, c, c4, h, part, nx, out, s);
  }
  return (int)cudaErrorInvalidValue;
}
