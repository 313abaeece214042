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

#include "gemm_tile.cuh"

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

// Two blocks per SM (at most 128 registers a thread): one block's stall on
// its next chunk's loads hides behind the other's math (1.25x over one block
// per SM at every stage shape, PERF.md).
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
