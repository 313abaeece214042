// ConvNeXtV2 block tail backward for Hopper (sm_90a): the gradients of
// LayerNorm -> pw1 -> tanh-GELU -> GRN -> pw2 (no residual) with respect to
// the dwconv output h and the eight tail parameters, given the cotangent dy.
//
// Replaces xmir_tpu/ops/convnext_block_pallas.py::_tail_bwd_pallas (K10, body
// _bwd_tail_kernel :207-270). The TPU kernel walks the images in order, keeps
// one image's (R, 4C) intermediates in VMEM and adds the parameter gradients
// into resident f32 blocks. On the H100 blocks run in no order, an image's
// expanded tensor does not fit a block (9216 x 512 at 384 px stage 1), and
// two statistics over all R rows of an image (the GRN norm gx and
// s1 = sum dz ab) come before any row's dab. Every sum runs in a fixed order
// and nothing is added atomically, so two runs give the same bits.
//
// Rounding points, the TPU kernel's: y, ab, z and dh1 rounded to the dtype
// before their products; h1, dz, dyln and GELU'(h1) in f32; dacc in h's
// dtype. GELU: t = tanh(K0 (h1 + K1 h1^3)), ab = 0.5 h1 (1 + t), each step
// rounded on its own (no contraction into FMAs), so every pass that forms ab
// from the same h1 gets the same bits.
//
// What bounds it: five products of 2 R C 4C operations per image (10 B R C
// 4C in all: 9.66e10 a stage at B = 16, 0.098 ms of bf16 tensor-core time).
//
// bf16 (the blocks training fuses), on wgmma fed by TMA rings (wgmma.cuh);
// seven launches where C <= 256 (stages 1-2 at 384 px, the only blocks the
// training gate fuses), nine above:
//   ln_rows (gemm_tile.cuh)   each row's LayerNorm statistics once (f32, the
//       fast variance, eps 1e-6) and y rounded to bf16, written once
//       (:225-230); a pre-pass, not a block per (image, row tile), so that
//       pass 1 can split 4C between blocks (stages 3-4 have 80 and 48 units
//       of 64 rows at B = 16, fewer than the SMs)
//   tail_bwd_pass<pass 1>   per 64-row unit of one image (two a block) and
//       512 columns of 4C: h1 = y W1^T + b1 and dz = dy W2 in registers, ab
//       = GELU(h1) rounded, and per unit and column the sums of ab^2, dz ab
//       and dz (:231-248). Nothing 4C wide is written.
//   grn_bwd   a block per image, the units' sums in order: gx, nx, s1,
//       dgamma and dbeta of the image, dgx; the per-column factors of
//       dab = dz (gamma nx + 1) + ab (dgx / gx) (:236-253)
//   tail_bwd_pass<pass 2>   the same units walking all of 4C in 64-column
//       chunks: h1 and dz recomputed by the same instructions over the same
//       tiles in the same k order (ab bit-equal to pass 1's), z and dh1 =
//       dab GELU'(h1) rounded and written once, the sums of the f32 dh1 per
//       unit (db1); where C <= 256, dyln += dh1 W1[chunk] accumulated on chip
//       from dh1's tile in shared memory, and at the end the LayerNorm
//       backward of the unit's rows, each held whole by four lanes: dacc =
//       rstd (dyh - mean dyh - xhat mean(dyh xhat)), dyh = dyln lns, and the
//       unit's sums of dyln xhat and dyln (:253-270). Above C = 256 (a row of
//       dyln is more than 128 accumulators a thread) pass 2 takes 256
//       columns a block and two launches follow: tail_bwd_gemm<dyln> (dyln
//       = dh1 W1 over the flattened rows, stored in f32 with the same column
//       sums) and ln_bwd_rows.
//   tail_bwd_gemm<partial> x 2   the weight products dW2 = dy^T z and dW1 =
//       dh1^T y, whose depth is the B R rows, as partial products over a
//       fixed split of that depth; dy and dh1 are read down their rows as
//       MN-major operands, so no tile is transposed (:243-245, 260)
//   sum_jobs   the seven parameter gradients' sums over units, images and
//       depth splits, in a fixed order, one launch
// Workspace (plan_bf16): y, the statistics, z, dh1, the partial sums; 410
// MiB at stage 1, B = 16, where the first body's, with h1, dz and dyln in
// f32, took about 1 GiB.
//
// f32 (under XMIR_FUSED_MLP=1 f32) keeps the first body, a chain of fifteen
// launches on gemm_tile.cuh's tile loop (IEEE f32 FMAs, no TF32) with h1, dz
// and dyln through device memory:
//   ln_rows; gemm_bwd<kH1> h1 = y W1^T + b1 stored, the column sums of ab^2
//   per (image, 128-row tile); gemm_bwd<kDz> dz = dy W2 stored, the sums of
//   dz ab and dz; grn_bwd; dh1_pass (z and dh1 stored, db1's sums);
//   gemm_bwd<kDyln> dyln = dh1 W1 stored with the sums of dyln xhat and
//   dyln; ln_bwd_rows (dacc); two gemm_tn weight products over depth splits
//   whose tiles are transposed into shared memory; seven sum_parts.
//
// Operands: activations (B, R, K) row-major, torch Linear weights (N, K)
// row-major: w1 (4C, C), and the transposes w1t (C, 4C) and w2t (4C, C) that
// the wrapper (xmir_tpu_torch/ops/convnext_block.py) makes. The launches go on
// the caller's stream and allocate nothing: the wrapper passes a workspace of
// xmir_convnext_bwd_plan's size.

#include <algorithm>

#include "gemm_tile.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxBatch = 65535;  // gridDim.z
constexpr float kGrnEps = 1e-12f;
constexpr float kGrnMeanEps = 1e-6f;
constexpr float kGelu3K1 = 0.134145f;  // 3 K1, the GELU derivative's cubic term
constexpr int kRowWarps = kThreads / 32;  // rows per block of the row kernels
constexpr int kTargetBlocks = 528;  // blocks a weight product aims at: 2 a SM, 2 waves
constexpr int kVecs = 6;  // per-image vectors of grn_bwd: nx, gamma nx + 1, dgx / gx, dg, dbeta, dnx

enum BwdEpilogue { kH1 = 0, kDz = 1, kDyln = 2 };

__device__ __forceinline__ float gelu_t(float h1) {
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(kGeluK1, h1), h1), h1);
  return tanhf(__fmul_rn(kGeluK0, __fadd_rn(h1, cube)));
}

__device__ __forceinline__ float gelu_a(float h1, float t) {
  return __fmul_rn(__fmul_rn(0.5f, h1), __fadd_rn(1.f, t));
}

// the GELU's derivative: 0.5 (1 + t) + 0.5 h1 (1 - t^2) K0 (1 + 3 K1 h1^2) (:254-256)
__device__ __forceinline__ float gelu_grad(float h1, float t) {
  return 0.5f * (1.f + t) + 0.5f * h1 * (1.f - t * t) * kGeluK0 * (1.f + kGelu3K1 * h1 * h1);
}

struct BwdArgs {
  const void* a;         // (B, rows, K) activations in T
  const void* w;         // (N, K) weights in T
  int rows, k, n;
  const float* bias;     // kH1: b1 (N,)
  float* out;            // kH1: h1, kDz: dz, kDyln: dyln; (B, rows, N) f32
  const float* h1;       // kDz: (B, rows, N)
  const void* h;         // kDyln: the dwconv output (B, rows, N) in T
  const float2* stats;   // kDyln: (B, rows) LayerNorm mean, rstd
  float* part0;          // (B, row tiles, N): kH1 ab^2, kDz dz ab, kDyln dyln xhat
  float* part1;          // (B, row tiles, N): kDz dz, kDyln dyln
};

template <typename T, int E>
__global__ void __launch_bounds__(kThreads, 2) gemm_bwd(BwdArgs args) {
  using Ly = Layout<T>;
  static_assert(sizeof(TileShared<T>::tiles) >= 2 * kGroups * kBN * sizeof(float),
                "the column-sum buffers reuse the tiles' shared memory");
  __shared__ TileShared<T> sm;
  const int img = blockIdx.z;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int rows = args.rows, K = args.k, N = args.n;
  float acc[8][8];
  gemm_tile<T, kNone>(static_cast<const T*>(args.a) + (size_t)img * rows * K,
                      static_cast<const T*>(args.w), rows, K, N, m0, n0, nullptr, nullptr,
                      nullptr, sm, acc);

  const size_t base = (size_t)img * rows * N;
  float* red = reinterpret_cast<float*>(sm.tiles);  // [2][kGroups][kBN]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = Ly::col_of(j), n = n0 + c;
    const float bias = E == kH1 && n < N ? args.bias[n] : 0.f;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + Ly::row_of(i);
      if (m < rows && n < N) {
        const size_t at = base + (size_t)m * N + n;
        const float v = acc[i][j] + bias;
        args.out[at] = v;
        if constexpr (E == kH1) {
          const float a = round_to(gelu_a(v, gelu_t(v)), T());
          s0 += a * a;
        } else if constexpr (E == kDz) {
          const float x = args.h1[at];
          const float a = round_to(gelu_a(x, gelu_t(x)), T());
          s0 += v * a;
          s1 += v;
        } else {
          const float2 st = args.stats[(size_t)img * rows + m];
          const float xhat = (load(static_cast<const T*>(args.h) + at) - st.x) * st.y;
          s0 += v * xhat;
          s1 += v;
        }
      }
    }
    red[Ly::group_of() * kBN + c] = s0;
    red[(kGroups + Ly::group_of()) * kBN + c] = s1;
  }
  __syncthreads();
  if (threadIdx.x < kBN && n0 + (int)threadIdx.x < N) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      s0 += red[g * kBN + threadIdx.x];
      s1 += red[(kGroups + g) * kBN + threadIdx.x];
    }
    const size_t at = ((size_t)img * gridDim.x + blockIdx.x) * N + n0 + threadIdx.x;
    args.part0[at] = s0;
    if constexpr (E != kH1) args.part1[at] = s1;
  }
}

// Per image, from the row tiles' column sums: gx = sqrt(sum ab^2 + 1e-12),
// m = mean(gx) + 1e-6, nx = gx / m, s1 = sum dz ab, dnx = gamma s1,
// dgx = dnx / m - sum(dnx gx) / (m^2 4C). Writes the image's vectors
// (nx, gamma nx + 1, dgx / gx, dgamma = s1 nx, dbeta = sum dz, dnx).
__global__ void __launch_bounds__(kThreads) grn_bwd(const float* __restrict__ part_sq,
                                                    const float* __restrict__ part_s1,
                                                    const float* __restrict__ part_dz,
                                                    const float* __restrict__ gamma, int tiles,
                                                    int c4, float* __restrict__ vecs) {
  __shared__ float red[kThreads];
  const int img = blockIdx.x;
  const size_t first = (size_t)img * tiles * c4;
  float* v = vecs + (size_t)img * kVecs * c4;
  float* nx = v;
  float* ca = v + c4;
  float* cb = v + 2 * c4;
  float* dg = v + 3 * c4;
  float* dbe = v + 4 * c4;
  float* dnx = v + 5 * c4;
  auto block_sum = [&](float local) {
    red[threadIdx.x] = local;
    __syncthreads();
    for (int off = kThreads / 2; off > 0; off >>= 1) {
      if ((int)threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
      __syncthreads();
    }
    const float total = red[0];
    __syncthreads();  // red is reused
    return total;
  };
  float local = 0.f;
  for (int c = threadIdx.x; c < c4; c += kThreads) {
    float s = 0.f;
    for (int t = 0; t < tiles; ++t) s += part_sq[first + (size_t)t * c4 + c];
    const float gx = sqrtf(s + kGrnEps);
    cb[c] = gx;  // gx until the last loop
    local += gx;
  }
  const float m = block_sum(local) / c4 + kGrnMeanEps;
  local = 0.f;
  for (int c = threadIdx.x; c < c4; c += kThreads) {
    float s1 = 0.f, sd = 0.f;
    for (int t = 0; t < tiles; ++t) {
      s1 += part_s1[first + (size_t)t * c4 + c];
      sd += part_dz[first + (size_t)t * c4 + c];
    }
    const float gx = cb[c], n = gx / m, d = gamma[c] * s1;
    nx[c] = n;
    ca[c] = gamma[c] * n + 1.f;
    dg[c] = s1 * n;
    dbe[c] = sd;
    dnx[c] = d;
    local += d * gx;
  }
  const float dot = block_sum(local);
  const float denom = m * m * c4;
  for (int c = threadIdx.x; c < c4; c += kThreads) {
    const float dgx = dnx[c] / m - dot / denom;
    cb[c] = dgx / cb[c];
  }
}

// A thread per column of 4C, a block per (128-row tile, 128 columns, image):
// z and dh1 rounded to the dtype and stored, the f32 dh1 summed over the
// tile's rows in order.
template <typename T>
__global__ void __launch_bounds__(kBN) dh1_pass(const float* __restrict__ h1,
                                                const float* __restrict__ dz,
                                                const float* __restrict__ vecs,
                                                const float* __restrict__ gamma,
                                                const float* __restrict__ beta, int rows, int c4,
                                                T* __restrict__ z, T* __restrict__ dh1,
                                                float* __restrict__ part_db1) {
  const int img = blockIdx.z, n = blockIdx.y * kBN + threadIdx.x;
  if (n >= c4) return;
  const int m0 = blockIdx.x * kBM, m1 = min(m0 + kBM, rows);
  const float* v = vecs + (size_t)img * kVecs * c4;
  const float nx = v[n], ca = v[c4 + n], cb = v[2 * c4 + n], g = gamma[n], be = beta[n];
  float s = 0.f;
  for (int m = m0; m < m1; ++m) {
    const size_t at = ((size_t)img * rows + m) * c4 + n;
    const float x = h1[at], t = gelu_t(x);
    const float a = round_to(gelu_a(x, t), T());
    store(z + at, g * (a * nx) + be + a);
    const float d = (dz[at] * ca + a * cb) * gelu_grad(x, t);
    s += d;
    store(dh1 + at, d);
  }
  part_db1[((size_t)img * gridDim.x + blockIdx.x) * c4 + n] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_bwd_rows(const float* __restrict__ dyln,
                                                        const T* __restrict__ h,
                                                        const float2* __restrict__ stats,
                                                        const float* __restrict__ lns,
                                                        long long n_rows, int C,
                                                        T* __restrict__ dacc) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const float2 st = stats[row];
  const float* dr = dyln + row * C;
  const T* hr = h + row * C;
  float a = 0.f, b = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float dyh = dr[c] * lns[c], xhat = (load(hr + c) - st.x) * st.y;
    a += dyh;
    b += dyh * xhat;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  const float m1 = a / C, m2 = b / C;
  T* out = dacc + row * C;
  for (int c = lane; c < C; c += 32) {
    const float dyh = dr[c] * lns[c], xhat = (load(hr + c) - st.x) * st.y;
    store(out + c, st.y * (dyh - m1 - xhat * m2));
  }
}

struct TnArgs {
  const void* a;  // (depth, M) row-major in T
  const void* b;  // (depth, N) row-major in T
  long long depth, chunk;  // rows of the depth, rows per split
  int m, n;
  float* part;    // (splits, M, N)
};

// part[split] = A[chunk]^T B[chunk] for one 128 x 128 output tile: the
// operands' tiles are loaded along M (N) and stored transposed into the
// (row, depth) layout gemm_tile.cuh's Layout<T>::compute takes.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) gemm_tn(TnArgs args) {
  using Ly = Layout<T>;
  constexpr int kVec = Tile<T>::kVec, kBK = Tile<T>::kBK, kS = Tile<T>::kStride;
  constexpr int kStage = Tile<T>::kStage;
  constexpr int kPerRow = kBM / kVec;  // vectors along a depth row of the tile
  static_assert(2 * kThreads == kBK * kPerRow, "two vectors per thread per operand per stage");
  __shared__ TileShared<T> sm;
  T* const a_s = reinterpret_cast<T*>(sm.tiles);  // [2][kBM][kS]
  T* const b_s = a_s + 2 * kStage;                // [2][kBN][kS]
  const T* A = static_cast<const T*>(args.a);
  const T* B = static_cast<const T*>(args.b);
  const int M = args.m, N = args.n;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const long long k0 = (long long)blockIdx.z * args.chunk;
  const long long k1 = k0 + args.chunk < args.depth ? k0 + args.chunk : args.depth;
  int lk[2], lm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int v = threadIdx.x + kThreads * i;
    lk[i] = v / kPerRow;
    lm[i] = (v % kPerRow) * kVec;
  }
  uint4 ra[2], rb[2];
  auto fetch = [&](long long kb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long k = kb + lk[i];
      const bool kin = k < k1;
      const int m = m0 + lm[i], n = n0 + lm[i];
      ra[i] = kin && m < M ? ldg16(A + k * M + m) : make_uint4(0, 0, 0, 0);
      rb[i] = kin && n < N ? ldg16(B + k * N + n) : make_uint4(0, 0, 0, 0);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float fa[kVec], fb[kVec];
      unpack(ra[i], fa);
      unpack(rb[i], fb);
      T* ad = a_s + buf * kStage + lm[i] * kS + lk[i];
      T* bd = b_s + buf * kStage + lm[i] * kS + lk[i];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        store(ad + e * kS, fa[e]);  // exact: the values came from T
        store(bd + e * kS, fb[e]);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const long long k_tiles = k1 > k0 ? (k1 - k0 + kBK - 1) / kBK : 0;
  if (k_tiles > 0) {
    fetch(k0);
    stash(0);
    __syncthreads();
    for (long long kt = 0; kt < k_tiles; ++kt) {
      const int buf = kt & 1;
      if (kt + 1 < k_tiles) fetch(k0 + (kt + 1) * kBK);
      Ly::compute(a_s + buf * kStage, b_s + buf * kStage, acc);
      if (kt + 1 < k_tiles) stash(buf ^ 1);
      __syncthreads();
    }
  }
  float* part = args.part + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + Ly::row_of(i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + Ly::col_of(j);
      if (n < N) part[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// out[i] = sum over p in order of part[p * stride + i], i < n.
__global__ void __launch_bounds__(kThreads) sum_parts(const float* __restrict__ part,
                                                      int n_parts, long long stride, long long n,
                                                      float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < n_parts; ++p) s += part[(size_t)p * stride + i];
    out[i] = s;
  }
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// The depth split of a weight product of an (m, n) output over `depth` rows:
// a chunk of rows (a multiple of `align`: the tile loop's bf16 stage depth,
// 32, or the wgmma ring's, 64) per split, enough splits for about
// kTargetBlocks blocks of 128 x 128 outputs.
void depth_split(int m, int n, long long depth, int align, long long* chunk, int* splits) {
  const int tiles = cdiv(m, kBM) * cdiv(n, kBN);
  const int want = cdiv(kTargetBlocks, tiles);
  long long c = (depth + want - 1) / want;
  c = (c + align - 1) / align * align;
  *chunk = c;
  *splits = cdiv(depth, c);
}

// The workspace: byte offsets of each scratch tensor, 256-byte aligned.
struct Workspace {
  size_t y, stats, h1, dz, z, dh1, dyln, part_sq, part_s1, part_dz, part_db1, part_lns,
      part_lnb, vecs, part_w2, part_w1, total;
  long long chunk;
  int splits, tiles;
};

Workspace plan_workspace(int batch, int rows, int c, int c4, size_t elem) {
  Workspace w{};
  const size_t br = (size_t)batch * rows;
  w.tiles = cdiv(rows, kBM);
  depth_split(c, c4, (long long)br, 32, &w.chunk, &w.splits);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  const size_t tile_rows = (size_t)batch * w.tiles;
  w.y = take(br * c * elem);
  w.stats = take(br * sizeof(float2));
  w.h1 = take(br * c4 * sizeof(float));
  w.dz = take(br * c4 * sizeof(float));
  w.z = take(br * c4 * elem);
  w.dh1 = take(br * c4 * elem);
  w.dyln = take(br * c * sizeof(float));
  w.part_sq = take(tile_rows * c4 * sizeof(float));
  w.part_s1 = take(tile_rows * c4 * sizeof(float));
  w.part_dz = take(tile_rows * c4 * sizeof(float));
  w.part_db1 = take(tile_rows * c4 * sizeof(float));
  w.part_lns = take(tile_rows * c * sizeof(float));
  w.part_lnb = take(tile_rows * c * sizeof(float));
  w.vecs = take((size_t)batch * kVecs * c4 * sizeof(float));
  w.part_w2 = take((size_t)w.splits * c * c4 * sizeof(float));
  w.part_w1 = take((size_t)w.splits * c4 * c * sizeof(float));
  w.total = at;
  return w;
}

cudaError_t reduce(const float* part, int n_parts, long long stride, long long n, float* out,
                   cudaStream_t stream) {
  const int blocks = cdiv(n, kThreads) < 1024 ? cdiv(n, kThreads) : 1024;
  sum_parts<<<blocks, kThreads, 0, stream>>>(part, n_parts, stride, n, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* h, const void* dy, const float* lns, const float* lnb,
                       const void* w1, const float* b1, const void* w1t, const void* w2t,
                       const float* gamma, const float* beta, int batch, int rows, int c,
                       int c4, void* workspace, void* dacc, float* dw1, float* dw2, float* db1,
                       float* dg, float* dbe, float* dlns, float* dlnb, cudaStream_t stream) {
  const Workspace ws = plan_workspace(batch, rows, c, c4, sizeof(T));
  char* base = static_cast<char*>(workspace);
  T* y = reinterpret_cast<T*>(base + ws.y);
  float2* stats = reinterpret_cast<float2*>(base + ws.stats);
  float* h1 = reinterpret_cast<float*>(base + ws.h1);
  float* dz = reinterpret_cast<float*>(base + ws.dz);
  T* z = reinterpret_cast<T*>(base + ws.z);
  T* dh1 = reinterpret_cast<T*>(base + ws.dh1);
  float* dyln = reinterpret_cast<float*>(base + ws.dyln);
  float* part_sq = reinterpret_cast<float*>(base + ws.part_sq);
  float* part_s1 = reinterpret_cast<float*>(base + ws.part_s1);
  float* part_dz = reinterpret_cast<float*>(base + ws.part_dz);
  float* part_db1 = reinterpret_cast<float*>(base + ws.part_db1);
  float* part_lns = reinterpret_cast<float*>(base + ws.part_lns);
  float* part_lnb = reinterpret_cast<float*>(base + ws.part_lnb);
  float* vecs = reinterpret_cast<float*>(base + ws.vecs);
  float* part_w2 = reinterpret_cast<float*>(base + ws.part_w2);
  float* part_w1 = reinterpret_cast<float*>(base + ws.part_w1);
  const long long br = (long long)batch * rows;
  const int tiles = ws.tiles;
  cudaError_t err;

  if ((err = launch_ln_rows<T>(static_cast<const T*>(h), lns, lnb, br, c, y, stats, stream)) !=
      cudaSuccess) {
    return err;
  }
  const dim3 grid4(tiles, cdiv(c4, kBN), batch), grid1(tiles, cdiv(c, kBN), batch);
  BwdArgs a1{y, w1, rows, c, c4, b1, h1, nullptr, nullptr, nullptr, part_sq, nullptr};
  gemm_bwd<T, kH1><<<grid4, kThreads, 0, stream>>>(a1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  BwdArgs a2{dy, w2t, rows, c, c4, nullptr, dz, h1, nullptr, nullptr, part_s1, part_dz};
  gemm_bwd<T, kDz><<<grid4, kThreads, 0, stream>>>(a2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  grn_bwd<<<batch, kThreads, 0, stream>>>(part_sq, part_s1, part_dz, gamma, tiles, c4, vecs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dh1_pass<T><<<grid4, kBN, 0, stream>>>(h1, dz, vecs, gamma, beta, rows, c4, z, dh1, part_db1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  BwdArgs a3{dh1, w1t, rows, c4, c, nullptr, dyln, nullptr, h, stats, part_lns, part_lnb};
  gemm_bwd<T, kDyln><<<grid1, kThreads, 0, stream>>>(a3);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ln_bwd_rows<T><<<cdiv(br, kRowWarps), kThreads, 0, stream>>>(
      dyln, static_cast<const T*>(h), stats, lns, br, c, static_cast<T*>(dacc));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  TnArgs t2{dy, z, br, ws.chunk, c, c4, part_w2};
  gemm_tn<T><<<dim3(cdiv(c, kBM), cdiv(c4, kBN), ws.splits), kThreads, 0, stream>>>(t2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  TnArgs t1{dh1, y, br, ws.chunk, c4, c, part_w1};
  gemm_tn<T><<<dim3(cdiv(c4, kBM), cdiv(c, kBN), ws.splits), kThreads, 0, stream>>>(t1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long cc4 = (long long)c * c4;
  if ((err = reduce(part_w2, ws.splits, cc4, cc4, dw2, stream)) != cudaSuccess) return err;
  if ((err = reduce(part_w1, ws.splits, cc4, cc4, dw1, stream)) != cudaSuccess) return err;
  if ((err = reduce(part_db1, batch * tiles, c4, c4, db1, stream)) != cudaSuccess) return err;
  if ((err = reduce(vecs + 3 * c4, batch, kVecs * c4, c4, dg, stream)) != cudaSuccess) return err;
  if ((err = reduce(vecs + 4 * c4, batch, kVecs * c4, c4, dbe, stream)) != cudaSuccess) return err;
  if ((err = reduce(part_lns, batch * tiles, c, c, dlns, stream)) != cudaSuccess) return err;
  return reduce(part_lnb, batch * tiles, c, c, dlnb, stream);
}

// ---------------------------------------------------------------------------
// bf16

constexpr int kUnit = 64;              // rows of one image a consumer warpgroup owns
constexpr int kWK = 64;                // depth a ring stage: one 128-byte panel
constexpr int kTile64 = 64 * 64 * 2;   // one 64 x 64 bf16 tile
constexpr int kPassThreads = 384;      // two consumer warpgroups and a producer warpgroup
constexpr int kGemmThreads = 288;      // two consumer warpgroups and a producer warp

// The two passes over the expanded width 4C are one kernel. A block owns the
// 64-row units 2 p and 2 p + 1 (each of one image; consumer warpgroup w owns
// unit 2 p + w) and walks a group of chunks of 4C, S slices of 64 columns a
// chunk, each over the depth C in steps of 64. A ring stage holds both
// units' tiles of y and dy and the chunk's S tiles of W1 and of W2^T (both
// K-major). Pass 1 (kP2 false, S = 2): h1 and dz, then per unit and column
// the sums of ab^2, dz ab and dz. Pass 2 (kP2, S = 1): h1 and dz again, by
// the same instructions (m64n64k16 per 64-column slice) over the same tiles
// in the same k order, so ab is bit-equal to the ab that built gx; z and
// dh1 stored, the sums of dh1 per unit and column. Fused (CP > 0, C <= 64
// CP): pass 2 walks all of 4C and accumulates dyln = dh1 W1 on chip (CP
// panels of 64 columns of C, 32 accumulators each), from dh1's bf16 tile in
// shared memory and the chunk's CP tiles of W1^T (a slot ring of its own),
// then ends with the LayerNorm backward of its rows (dacc) and the unit's
// sums of dyln xhat and dyln.
template <bool kP2, int S, int CP>
struct PassCfg {
  static constexpr bool kFused = CP > 0;
  static constexpr int kStage = (4 + 2 * S) * kTile64;
  static constexpr int kStages = CP == 4 ? 2 : CP > 0 ? 3 : S == 1 ? 4 : 3;
  static constexpr int kW1t = kStages * kStage;                          // [2 slots][CP tiles]
  static constexpr int kDh1 = kW1t + (kFused ? 2 * CP * kTile64 : 0);    // [2 warpgroups]
  static constexpr int kSums = kP2 ? 2 : 3;  // pass 2: dh1, and ab^2 when checked
  static constexpr int kRed = kDh1 + (kFused ? 2 * kTile64 : 0);  // [2 wg][sums][4 warps][64 S]
  // the chunk's per-column vectors: b1 (pass 1); b1, gamma, beta and the
  // image's nx, gamma nx + 1, dgx / gx (pass 2), [2 wg][kVecsUsed][64 S]
  static constexpr int kVecsUsed = kP2 ? 6 : 1;
  static constexpr int kVec = kRed + 2 * kSums * 4 * 64 * S * 4;
  static constexpr int kBars = kVec + 2 * kVecsUsed * 64 * S * 4;
  static constexpr int kSmem = kBars + 2 * (kStages + 2) * 8 + 1024;
};

struct PassArgs {
  int rows, c, c4;            // rows of an image, C, 4C
  int unit_tiles, units;      // 64-row units of an image, of the batch
  int groups, group_chunks;   // column groups a unit pair takes, chunks a group
  const float* b1;            // (4C,)
  float* part0;               // (units, 4C): pass 1 sum ab^2, pass 2 sum dh1
  float* part1;               // pass 1: sum dz ab
  float* part2;               // pass 1: sum dz
  // pass 2
  const float* vecs;          // grn_bwd's (B, kVecs, 4C)
  const float* gamma;
  const float* beta;
  __nv_bfloat16* z;           // (B, R, 4C)
  __nv_bfloat16* dh1;         // (B, R, 4C)
  // fused pass 2: the LayerNorm backward
  const __nv_bfloat16* h;     // (B, R, C) the dwconv output
  const float2* stats;        // (B R) mean, rstd
  const float* lns;           // (C,)
  __nv_bfloat16* dacc;        // (B, R, C)
  float* part_lns;            // (units, C): sum dyln xhat
  float* part_lnb;            // (units, C): sum dyln
  float* part_chk;            // pass 2, or null: (units, 4C) its own sums of ab^2
};

// v summed over the eight lanes of a warp that share lane % 4 (the rows of a
// warpgroup product's fragment), and over the four that share lane / 4 (the
// columns of one row).
__device__ __forceinline__ float sum_rows8(float v) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float sum_cols4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <bool kP2, int S, int CP>
__global__ void __launch_bounds__(kPassThreads, 1) tail_bwd_pass(
    const __grid_constant__ CUtensorMap y_map, const __grid_constant__ CUtensorMap dy_map,
    const __grid_constant__ CUtensorMap w1_map, const __grid_constant__ CUtensorMap w2t_map,
    const __grid_constant__ CUtensorMap w1t_map, const PassArgs args) {
  using Cfg = PassCfg<kP2, S, CP>;
  constexpr int kStages = Cfg::kStages;
  constexpr int kCP = CP > 0 ? CP : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + Cfg::kBars);
  uint64_t* const empty = full + kStages;
  uint64_t* const wfull = empty + kStages;  // the W1^T slots (fused)
  uint64_t* const wempty = wfull + 2;
  const int pair = blockIdx.x / args.groups;
  const int chunk0 = (blockIdx.x - pair * args.groups) * args.group_chunks;
  const int chunks = min(args.group_chunks, (args.c4 + 64 * S - 1) / (64 * S) - chunk0);
  const int ksteps = (args.c + kWK - 1) / kWK;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int live = min(2, args.units - 2 * pair);

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);            // the producer, once its copies land
      mbar_init(empty + st, 4 * live);    // one arrival per consumer warp
    }
    for (int sl = 0; sl < 2; ++sl) {
      mbar_init(wfull + sl, 1);
      mbar_init(wempty + sl, 4 * live);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer
    regs_shrink<40>();
    if (warp != 8 || lane != 0) return;
    int img[2], tile[2];
    for (int w = 0; w < live; ++w) {
      const int u = 2 * pair + w;
      img[w] = u / args.unit_tiles;
      tile[w] = u - img[w] * args.unit_tiles;
    }
    for (int ch = 0; ch < chunks; ++ch) {
      const int col0 = (chunk0 + ch) * 64 * S;
      if constexpr (Cfg::kFused) {  // the chunk's W1^T tiles, for its dyln product
        const int slot = ch & 1;
        mbar_wait(wempty + slot, ((ch >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(wfull + slot, CP * kTile64);
        tma_load(smem + Cfg::kW1t + slot * CP * kTile64, &w1t_map, col0, 0, 0, wfull + slot);
      }
      for (int ks = 0; ks < ksteps; ++ks) {
        const int step = ch * ksteps + ks, stage = step % kStages;
        mbar_wait(empty + stage, ((step / kStages) & 1) ^ 1);
        unsigned char* const dst = smem + stage * Cfg::kStage;
        // rows past the image, depth past C and columns past 4C read as zeros
        mbar_arrive_expect_tx(full + stage, (2 * live + 2 * S) * kTile64);
        for (int w = 0; w < live; ++w) {
          tma_load(dst + w * kTile64, &y_map, ks * kWK, tile[w] * kUnit, img[w], full + stage);
          tma_load(dst + (2 + w) * kTile64, &dy_map, ks * kWK, tile[w] * kUnit, img[w],
                   full + stage);
        }
        for (int s = 0; s < S; ++s) {
          tma_load(dst + (4 + s) * kTile64, &w1_map, ks * kWK, col0 + 64 * s, 0, full + stage);
          tma_load(dst + (4 + S + s) * kTile64, &w2t_map, ks * kWK, col0 + 64 * s, 0,
                   full + stage);
        }
      }
    }
    return;
  }

  regs_grow<232>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  if (wg >= live) return;
  const int u = 2 * pair + wg, img = u / args.unit_tiles;
  const int row_a = (u - img * args.unit_tiles) * kUnit + 16 * wq + g;  // and row_a + 8
  const int rows = args.rows, c4 = args.c4;
  const bool live_row[2] = {row_a < rows, row_a + 8 < rows};
  const size_t row_at[2] = {static_cast<size_t>(img) * rows + row_a,
                            static_cast<size_t>(img) * rows + row_a + 8};
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float* const red = reinterpret_cast<float*>(smem + Cfg::kRed) + wg * Cfg::kSums * 4 * 64 * S;
  float* const vec = reinterpret_cast<float*>(smem + Cfg::kVec) + wg * Cfg::kVecsUsed * 64 * S;
  const float* const img_vecs = args.vecs + static_cast<size_t>(img) * kVecs * c4;
  // Thread i of the warpgroup loads entries i, i + 128, ... of the chunk's
  // vectors into registers before the products and stores them to `vec`
  // under them, so the epilogue reads no device memory.
  constexpr int kVecLoads = Cfg::kVecsUsed * 64 * S / 128;
  auto vec_source = [&](int which) -> const float* {
    switch (which) {
      case 0: return args.b1;
      case 1: return args.gamma;
      case 2: return args.beta;
      default: return img_vecs + (which - 3) * c4;  // nx, gamma nx + 1, dgx / gx
    }
  };

  float h1[S][32], dz[S][32], dyl[kCP][32];
#pragma unroll
  for (int p = 0; p < kCP; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dyl[p][i] = 0.f;
    fence_regs(dyl[p]);
  }

  // The two warpgroups take turns issuing a chunk's products (named
  // barriers 3 and 4 handed back and forth), so that one's epilogue runs
  // under the other's products. Both read every stage, so a warpgroup can
  // issue a whole chunk before the other has read any of it only if the
  // ring holds the chunk's depth: at most kStages steps (C <= 192 in pass 1,
  // C <= 128 in the fused pass 2); else they go in step.
  const bool turns = live == 2 && ksteps <= kStages;
  for (int ch = 0; ch < chunks; ++ch) {
    const int col0 = (chunk0 + ch) * 64 * S;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      fence_regs(h1[s]);
      fence_regs(dz[s]);
    }
    float vl[kVecLoads];
#pragma unroll
    for (int i = 0; i < kVecLoads; ++i) {
      const int idx = (tid & 127) + 128 * i, which = idx / (64 * S), col = col0 + idx % (64 * S);
      vl[i] = col < c4 ? __ldg(vec_source(which) + col) : 0.f;
    }
    if (turns && (wg == 1 || ch > 0)) named_barrier(3 + wg, 256);
    for (int ks = 0; ks < ksteps; ++ks) {
      const int step = ch * ksteps + ks, stage = step % kStages;
      mbar_wait(full + stage, (step / kStages) & 1);
      const uint32_t st = smem_addr(smem + stage * Cfg::kStage);
      const uint32_t a_y = st + wg * kTile64, a_dy = st + (2 + wg) * kTile64;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWK / 16; ++kk) {
        const int k16 = 16 * kk;  // the same k order in both passes: ab bit-equal
#pragma unroll
        for (int s = 0; s < S; ++s) {
          Wgmma<64>::template ss<0, 0>(
              h1[s], desc_k_major<kWK>(a_y, kUnit, 0, k16),
              desc_k_major<kWK>(st + (4 + s) * kTile64, 64, 0, k16), ks > 0 || kk > 0);
          Wgmma<64>::template ss<0, 0>(
              dz[s], desc_k_major<kWK>(a_dy, kUnit, 0, k16),
              desc_k_major<kWK>(st + (4 + S + s) * kTile64, 64, 0, k16), ks > 0 || kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (ks > 0) {
        release(empty + (step - 1) % kStages);
      } else if (Cfg::kFused && ch > 0) {
        release(wempty + ((ch - 1) & 1));  // the previous chunk's dyln product is done
      }
    }
    if (turns && (wg == 0 || ch + 1 < chunks)) named_arrive(3 + (wg ^ 1), 256);
#pragma unroll
    for (int i = 0; i < kVecLoads; ++i) vec[(tid & 127) + 128 * i] = vl[i];
    wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      fence_regs(h1[s]);
      fence_regs(dz[s]);
    }
    release(empty + (ch * ksteps + ksteps - 1) % kStages);
    named_barrier(1 + wg, 128);  // the chunk's vectors in `vec`

    if constexpr (!kP2) {
      // pass 1: per column the sums over the unit's live rows of ab^2, dz ab
      // and dz: the warp's 16 rows by shuffles, then its four warps in order
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cc = 64 * s + 8 * j + 2 * t, col = col0 + cc;
          float sq[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f}, sd[2] = {0.f, 0.f};
          if (col < c4) {  // 4C is a multiple of 8: col + 1 < 4C too
            const float2 b = *reinterpret_cast<const float2*>(vec + cc);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!live_row[h]) continue;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float x = h1[s][4 * j + 2 * h + e] + (e ? b.y : b.x);
                const float a = round_to(gelu_a(x, gelu_t(x)), __nv_bfloat16());
                const float d = dz[s][4 * j + 2 * h + e];
                sq[e] += a * a;
                s1[e] += d * a;
                sd[e] += d;
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sq[e] = sum_rows8(sq[e]);
            s1[e] = sum_rows8(s1[e]);
            sd[e] = sum_rows8(sd[e]);
          }
          if (g == 0) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              red[(0 * 4 + wq) * 64 * S + cc + e] = sq[e];
              red[(1 * 4 + wq) * 64 * S + cc + e] = s1[e];
              red[(2 * 4 + wq) * 64 * S + cc + e] = sd[e];
            }
          }
        }
      }
      named_barrier(1 + wg, 128);
      for (int cc = tid & 127; cc < 64 * S; cc += 128) {
        const int col = col0 + cc;
        if (col >= c4) continue;
        float* const outs[3] = {args.part0, args.part1, args.part2};
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float* r = red + q * 4 * 64 * S + cc;
          outs[q][static_cast<size_t>(u) * c4 + col] =
              r[0] + r[64 * S] + r[2 * 64 * S] + r[3 * 64 * S];
        }
      }
      named_barrier(1 + wg, 128);  // red is written again by the next chunk
    } else {
      // pass 2: ab as in pass 1, z = gamma (ab nx) + beta + ab and
      // dh1 = (dz (gamma nx + 1) + ab dgx / gx) GELU'(h1), both rounded and
      // stored, the f32 dh1 summed per column
      uint32_t* const dh1_tile = reinterpret_cast<uint32_t*>(smem + Cfg::kDh1 + wg * kTile64);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cc = 8 * j + 2 * t, col = col0 + cc;
        float sb[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
        uint32_t packed[2] = {0u, 0u};  // dh1 of the two rows as bf16 pairs; dead: zeros
        if (col < c4) {
          auto vec2 = [&](int which) {
            return *reinterpret_cast<const float2*>(vec + 64 * which + cc);
          };
          const float2 b = vec2(0), gm = vec2(1), bt = vec2(2), nx = vec2(3), ca = vec2(4),
                       cb = vec2(5);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!live_row[h]) continue;
            float zv[2], dv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = h1[0][4 * j + 2 * h + e] + (e ? b.y : b.x);
              const float tt = gelu_t(x);
              const float a = round_to(gelu_a(x, tt), __nv_bfloat16());
              const float g_v = e ? gm.y : gm.x, nx_v = e ? nx.y : nx.x;
              const float ca_v = e ? ca.y : ca.x, cb_v = e ? cb.y : cb.x;
              const float dz_v = dz[0][4 * j + 2 * h + e];
              zv[e] = g_v * (a * nx_v) + (e ? bt.y : bt.x) + a;
              const float d = (dz_v * ca_v + a * cb_v) * gelu_grad(x, tt);
              sb[e] += d;
              sq[e] += a * a;
              dv[e] = d;
            }
            const size_t at = row_at[h] * c4 + col;
            *reinterpret_cast<__nv_bfloat162*>(args.z + at) = __floats2bfloat162_rn(zv[0], zv[1]);
            const __nv_bfloat162 d2 = __floats2bfloat162_rn(dv[0], dv[1]);
            *reinterpret_cast<__nv_bfloat162*>(args.dh1 + at) = d2;
            packed[h] = *reinterpret_cast<const uint32_t*>(&d2);
          }
        }
        if constexpr (Cfg::kFused) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            dh1_tile[panel_offset<64>(kUnit, 16 * wq + g + 8 * h, cc) / 4] = packed[h];
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) sb[e] = sum_rows8(sb[e]);
        if (g == 0) {
          red[wq * 64 + cc] = sb[0];
          red[wq * 64 + cc + 1] = sb[1];
        }
        if (args.part_chk != nullptr) {  // pass 1's sums of ab^2, formed again here
#pragma unroll
          for (int e = 0; e < 2; ++e) sq[e] = sum_rows8(sq[e]);
          if (g == 0) {
            red[(4 + wq) * 64 + cc] = sq[0];
            red[(4 + wq) * 64 + cc + 1] = sq[1];
          }
        }
      }
      if constexpr (Cfg::kFused) fence_async_smem();  // dh1's tile, for the product below
      named_barrier(1 + wg, 128);
      for (int cc = tid & 127; cc < 64; cc += 128) {
        const int col = col0 + cc;
        if (col < c4) {
          args.part0[static_cast<size_t>(u) * c4 + col] =
              red[cc] + red[64 + cc] + red[128 + cc] + red[192 + cc];
          if (args.part_chk != nullptr) {
            args.part_chk[static_cast<size_t>(u) * c4 + col] =
                red[256 + cc] + red[320 + cc] + red[384 + cc] + red[448 + cc];
          }
        }
      }
      named_barrier(1 + wg, 128);
      if constexpr (Cfg::kFused) {
        // dyln (64 x C) += dh1 (64 x 64) . W1[chunk] (64 x C), from the W1^T slot
        const int slot = ch & 1;
        mbar_wait(wfull + slot, (ch >> 1) & 1);
        const uint32_t a_t = smem_addr(dh1_tile);
        const uint32_t b_t = smem_addr(smem + Cfg::kW1t + slot * CP * kTile64);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int p = 0; p < kCP; ++p) {
            Wgmma<64>::template ss<0, 0>(dyl[p], desc_k_major<64>(a_t, kUnit, 0, 16 * kk),
                                         desc_k_major<64>(b_t, CP * 64, 64 * p, 16 * kk),
                                         ch > 0 || kk > 0);
          }
        }
        wgmma_commit();
      }
    }
  }

  if constexpr (Cfg::kFused) {
    // the LayerNorm backward of the unit's rows, each held whole by the four
    // lanes that share lane / 4: dyh = dyln lns, xhat = (h - mean) rstd,
    // dacc = rstd (dyh - mean(dyh) - xhat mean(dyh xhat)); then per column
    // the sums of dyln xhat and dyln over the unit's rows
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < kCP; ++p) fence_regs(dyl[p]);
    const int C = args.c;
    float mean[2] = {0.f, 0.f}, rstd[2] = {0.f, 0.f}, m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (live_row[h]) {
        const float2 st = args.stats[row_at[h]];
        mean[h] = st.x;
        rstd[h] = st.y;
      }
    }
    auto xhat_of = [&](int h, int col, float (&xh)[2]) {
      const float2 hv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(args.h + row_at[h] * C + col));
      xh[0] = (hv.x - mean[h]) * rstd[h];
      xh[1] = (hv.y - mean[h]) * rstd[h];
    };
#pragma unroll
    for (int p = 0; p < kCP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + 2 * t;
        if (col >= C) continue;  // C is a multiple of 8: col + 1 < C too
        const float2 ls = __ldg(reinterpret_cast<const float2*>(args.lns + col));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!live_row[h]) continue;
          float xh[2];
          xhat_of(h, col, xh);
          const float dyh0 = dyl[p][4 * j + 2 * h] * ls.x;
          const float dyh1 = dyl[p][4 * j + 2 * h + 1] * ls.y;
          m1[h] += dyh0 + dyh1;
          m2[h] += dyh0 * xh[0] + dyh1 * xh[1];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m1[h] = sum_cols4(m1[h]) / C;
      m2[h] = sum_cols4(m2[h]) / C;
    }
    auto ln_dx = [&](float dyh, float xhat, int h) {
      return rstd[h] * (dyh - m1[h] - xhat * m2[h]);
    };
    float* const red2 = reinterpret_cast<float*>(smem + Cfg::kDh1 + wg * kTile64);  // [2][4][64 CP]
#pragma unroll
    for (int p = 0; p < kCP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + 2 * t;
        float sx[2] = {0.f, 0.f}, sy[2] = {0.f, 0.f};
        if (col < C) {
          const float2 ls = __ldg(reinterpret_cast<const float2*>(args.lns + col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!live_row[h]) continue;
            float xh[2];
            xhat_of(h, col, xh);
            const float d0 = dyl[p][4 * j + 2 * h], d1 = dyl[p][4 * j + 2 * h + 1];
            *reinterpret_cast<__nv_bfloat162*>(args.dacc + row_at[h] * C + col) =
                __floats2bfloat162_rn(ln_dx(d0 * ls.x, xh[0], h), ln_dx(d1 * ls.y, xh[1], h));
            sx[0] += d0 * xh[0];
            sx[1] += d1 * xh[1];
            sy[0] += d0;
            sy[1] += d1;
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sx[e] = sum_rows8(sx[e]);
          sy[e] = sum_rows8(sy[e]);
        }
        if (g == 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            red2[wq * 64 * kCP + col + e] = sx[e];
            red2[(4 + wq) * 64 * kCP + col + e] = sy[e];
          }
        }
      }
    }
    named_barrier(1 + wg, 128);
    for (int col = tid & 127; col < C; col += 128) {
      const float* r = red2 + col;
      args.part_lns[static_cast<size_t>(u) * C + col] =
          r[0] + r[64 * kCP] + r[2 * 64 * kCP] + r[3 * 64 * kCP];
      r += 4 * 64 * kCP;
      args.part_lnb[static_cast<size_t>(u) * C + col] =
          r[0] + r[64 * kCP] + r[2 * 64 * kCP] + r[3 * 64 * kCP];
    }
  }
}

// A product of 128 x 128 outputs over a range of its depth, for the weight
// gradients and (C > 256) dyln: two consumer warpgroups of 64 output rows
// each and a producer warp streaming the A and B tiles (two 64 x 64 boxes
// each) into a three-stage ring; two blocks an SM. A is K-major (TA 0: (M,
// K) rows) or MN-major (TA 1: (K, M) rows: the weight products read dy and
// dh1 down their rows, no transpose); B is MN-major ((K, N) rows). wgmma
// m64n128k16, both operands from shared memory.
enum GemmEpilogue { kPartial = 0, kDylnRows = 1 };

struct WgGemmArgs {
  int m, n;                  // output extent
  long long depth, chunk;    // the depth, and the depth of a split (a multiple of 64)
  int m_tiles, n_tiles;
  float* out;                // kPartial: (splits, m, n); kDylnRows: dyln (m, n)
  const __nv_bfloat16* h;    // kDylnRows: the rows of h (m, n) and their (mean, rstd);
  const float2* stats;       // per 64-row tile and column the sums of dyln xhat and
  float* part_lns;           // dyln, (m / 64, n)
  float* part_lnb;
};

struct GemmCfg {
  static constexpr int kStages = 3;
  static constexpr int kStage = 4 * kTile64;
  static constexpr int kRed = kStages * kStage;  // kDylnRows: [2 wg][2][4 warps][128]
  static constexpr int kBars = kRed + 2 * 2 * 4 * 128 * 4;
  static constexpr int kSmem = kBars + 2 * kStages * 8 + 1024;
};

template <int TA, int E>
__global__ void __launch_bounds__(kGemmThreads, 2) tail_bwd_gemm(
    const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
    const WgGemmArgs args) {
  constexpr int kStages = GemmCfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + GemmCfg::kBars);
  uint64_t* const empty = full + kStages;
  const int nt = blockIdx.x % args.n_tiles;
  const int mt = (blockIdx.x / args.n_tiles) % args.m_tiles;
  const int split = blockIdx.x / (args.n_tiles * args.m_tiles);
  const int m0 = mt * 128, n0 = nt * 128;
  const long long k0 = split * args.chunk;
  const long long k1 = k0 + args.chunk < args.depth ? k0 + args.chunk : args.depth;
  const int steps = k1 > k0 ? static_cast<int>((k1 - k0 + kWK - 1) / kWK) : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane != 0) return;
    for (int step = 0; step < steps; ++step) {
      const int stage = step % kStages;
      const int kd = static_cast<int>(k0 + static_cast<long long>(step) * kWK);
      mbar_wait(empty + stage, ((step / kStages) & 1) ^ 1);
      unsigned char* const dst = smem + stage * GemmCfg::kStage;
      mbar_arrive_expect_tx(full + stage, 4 * kTile64);
      for (int w = 0; w < 2; ++w) {
        if constexpr (TA == 1) {
          tma_load(dst + w * kTile64, &a_map, m0 + 64 * w, kd, 0, full + stage);
        } else {
          tma_load(dst + w * kTile64, &a_map, kd, m0 + 64 * w, 0, full + stage);
        }
        tma_load(dst + (2 + w) * kTile64, &b_map, n0 + 64 * w, kd, 0, full + stage);
      }
    }
    return;
  }

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int step = 0; step < steps; ++step) {
    const int stage = step % kStages;
    mbar_wait(full + stage, (step / kStages) & 1);
    const uint32_t a_tile = smem_addr(smem + stage * GemmCfg::kStage);
    const uint32_t b_tile = a_tile + 2 * kTile64;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWK / 16; ++kk) {
      const uint64_t da = TA == 1 ? desc_mn_major<128>(a_tile, 64, 16 * kk, 64 * wg)
                                  : desc_k_major<64>(a_tile + wg * kTile64, 64, 0, 16 * kk);
      Wgmma<128>::template ss<TA, 1>(acc, da, desc_mn_major<128>(b_tile, 64, 16 * kk, 0),
                                     step > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (step > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (step - 1) % kStages);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int M = args.m, N = args.n;
  const int r0 = m0 + 64 * wg + 16 * wq + g;  // and r0 + 8
  if constexpr (E == kPartial) {
    float* const out = args.out + static_cast<size_t>(split) * M * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * t;  // N is a multiple of 8: col + 1 < N too
        if (col < N) {
          *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * N + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  } else {
    // dyln's rows stored in f32 for the row kernel's LayerNorm backward, and
    // per column the sums of dyln xhat and dyln over the warpgroup's 64 rows
    float2 st[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r0 + 8 * h < M) st[h] = args.stats[r0 + 8 * h];
    }
    float* const red = reinterpret_cast<float*>(smem + GemmCfg::kRed) + wg * 2 * 4 * 128;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int cc = 8 * j + 2 * t, col = n0 + cc;
      float sx[2] = {0.f, 0.f}, sy[2] = {0.f, 0.f};
      if (col < N) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= M) continue;
          const float d0 = acc[4 * j + 2 * h], d1 = acc[4 * j + 2 * h + 1];
          *reinterpret_cast<float2*>(args.out + static_cast<size_t>(r) * N + col) =
              make_float2(d0, d1);
          const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              args.h + static_cast<size_t>(r) * N + col));
          sx[0] += d0 * ((hv.x - st[h].x) * st[h].y);
          sx[1] += d1 * ((hv.y - st[h].x) * st[h].y);
          sy[0] += d0;
          sy[1] += d1;
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sx[e] = sum_rows8(sx[e]);
        sy[e] = sum_rows8(sy[e]);
      }
      if (g == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[wq * 128 + cc + e] = sx[e];
          red[(4 + wq) * 128 + cc + e] = sy[e];
        }
      }
    }
    named_barrier(1 + wg, 128);
    const size_t tile_row = static_cast<size_t>(m0 / 64 + wg);
    for (int cc = tid & 127; cc < 128 && n0 + cc < N; cc += 128) {
      const float* r = red + cc;
      args.part_lns[tile_row * N + n0 + cc] = r[0] + r[128] + r[256] + r[384];
      r += 512;
      args.part_lnb[tile_row * N + n0 + cc] = r[0] + r[128] + r[256] + r[384];
    }
  }
}

// The parameter gradients' last sums in one launch: job blockIdx.y adds
// out[i] = sum over p < parts of part[p stride + i], i < n, in a fixed
// order: in order by one thread an output where the parts are few (the
// weight products' splits, the images), else in L interleaved runs p = q,
// q + L, ... (L = 8, or 32 from 256 parts: the units' sums), each in order,
// then the L runs in order. Consecutive threads take consecutive outputs.
struct SumJob {
  const float* part;
  long long stride, n;
  int parts;
  float* out;
};
constexpr int kSumJobs = 7;
struct SumJobs {
  SumJob job[kSumJobs];
};

__host__ __device__ __forceinline__ int sum_lanes(int parts) {
  return parts >= 256 ? 32 : parts > 16 ? 8 : 1;
}

__global__ void __launch_bounds__(256) sum_jobs(const __grid_constant__ SumJobs jobs) {
  const SumJob jb = jobs.job[blockIdx.y];
  const int lanes = sum_lanes(jb.parts), width = 256 / lanes;
  const int x = threadIdx.x % width, q = threadIdx.x / width;
  __shared__ float red[256];
  // blocks stride over the job's outputs (every thread of a block takes the
  // same number of turns, so the barrier below is reached by all)
  for (long long first = static_cast<long long>(blockIdx.x) * width; first < jb.n;
       first += static_cast<long long>(gridDim.x) * width) {
    const long long i = first + x;
    float s = 0.f;
    if (i < jb.n) {
#pragma unroll 4
      for (int p = q; p < jb.parts; p += lanes) {
        s += jb.part[static_cast<size_t>(p) * jb.stride + i];
      }
    }
    if (lanes == 1) {
      if (i < jb.n) jb.out[i] = s;
      continue;
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if (q == 0 && i < jb.n) {
      float total = 0.f;
      for (int r = 0; r < lanes; ++r) total += red[r * width + x];
      jb.out[i] = total;
    }
    __syncthreads();  // red is written again in the next turn
  }
}

// The bf16 workspace: byte offsets of each scratch tensor, 256-byte aligned.
struct WorkspaceBf16 {
  size_t y, stats, z, dh1, part_sq, part_s1, part_dz, part_db1, part_lns, part_lnb, vecs,
      part_w2, part_w1, dyln, total;
  long long chunk;
  int splits, unit_tiles, units, ln_parts, cp;
};

WorkspaceBf16 plan_bf16(int batch, int rows, int c, int c4) {
  WorkspaceBf16 w{};
  const size_t br = static_cast<size_t>(batch) * rows;
  w.unit_tiles = cdiv(rows, kUnit);
  w.units = batch * w.unit_tiles;
  w.cp = c <= 128 ? 2 : c <= 256 ? 4 : 0;  // dyln on chip where a unit's rows fit 4 panels
  w.ln_parts = w.cp > 0 ? w.units : cdiv(static_cast<long long>(br), 64);
  depth_split(c, c4, static_cast<long long>(br), 64, &w.chunk, &w.splits);
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  const size_t units = static_cast<size_t>(w.units);
  w.y = take(br * c * 2);
  w.stats = take(br * sizeof(float2));
  w.z = take(br * c4 * 2);
  w.dh1 = take(br * c4 * 2);
  w.part_sq = take(units * c4 * 4);
  w.part_s1 = take(units * c4 * 4);
  w.part_dz = take(units * c4 * 4);
  w.part_db1 = take(units * c4 * 4);
  w.part_lns = take(static_cast<size_t>(w.ln_parts) * c * 4);
  w.part_lnb = take(static_cast<size_t>(w.ln_parts) * c * 4);
  w.vecs = take(static_cast<size_t>(batch) * kVecs * c4 * 4);
  w.part_w2 = take(static_cast<size_t>(w.splits) * c * c4 * 4);
  w.part_w1 = take(static_cast<size_t>(w.splits) * c4 * c * 4);
  w.dyln = take(w.cp > 0 ? 0 : br * c * 4);
  w.total = at;
  return w;
}

template <bool kP2, int S, int CP>
cudaError_t launch_pass(const CUtensorMap& y_map, const CUtensorMap& dy_map,
                        const CUtensorMap& w1_map, const CUtensorMap& w2t_map,
                        const CUtensorMap& w1t_map, PassArgs args, int group_chunks,
                        cudaStream_t stream) {
  using Cfg = PassCfg<kP2, S, CP>;
  const int chunks = cdiv(args.c4, 64 * S);
  args.group_chunks = group_chunks < chunks ? group_chunks : chunks;
  args.groups = cdiv(chunks, args.group_chunks);
  const long long blocks = static_cast<long long>((args.units + 1) / 2) * args.groups;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tail_bwd_pass<kP2, S, CP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
  if (err != cudaSuccess) return err;
  tail_bwd_pass<kP2, S, CP><<<static_cast<unsigned>(blocks), kPassThreads, Cfg::kSmem, stream>>>(
      y_map, dy_map, w1_map, w2t_map, w1t_map, args);
  return cudaGetLastError();
}

template <int TA, int E>
cudaError_t launch_wg_gemm(const CUtensorMap& a_map, const CUtensorMap& b_map, WgGemmArgs args,
                         int splits, cudaStream_t stream) {
  args.m_tiles = cdiv(args.m, 128);
  args.n_tiles = cdiv(args.n, 128);
  const long long blocks = static_cast<long long>(args.m_tiles) * args.n_tiles * splits;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tail_bwd_gemm<TA, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, GemmCfg::kSmem);
  if (err != cudaSuccess) return err;
  tail_bwd_gemm<TA, E><<<static_cast<unsigned>(blocks), kGemmThreads, GemmCfg::kSmem, stream>>>(
      a_map, b_map, args);
  return cudaGetLastError();
}

// A weight gradient a (depth, m)^T b (depth, n) as partial products over
// depth splits, one (m, n) part each.
cudaError_t launch_wgrad(const CUtensorMap& a_rows, const CUtensorMap& b_rows, int m, int n,
                         long long depth, long long chunk, int splits, float* part,
                         cudaStream_t stream) {
  const WgGemmArgs args{m, n, depth, chunk, 0, 0, part, nullptr, nullptr, nullptr, nullptr};
  return launch_wg_gemm<1, kPartial>(a_rows, b_rows, args, splits, stream);
}

cudaError_t launch_bwd_bf16(const void* h, const void* dy, const float* lns, const float* lnb,
                            const void* w1, const float* b1, const void* w1t, const void* w2t,
                            const float* gamma, const float* beta, int batch, int rows, int c,
                            int c4, void* workspace, void* dacc, float* dw1, float* dw2,
                            float* db1, float* dg, float* dbe, float* dlns, float* dlnb,
                            float* check, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const WorkspaceBf16 ws = plan_bf16(batch, rows, c, c4);
  char* base = static_cast<char*>(workspace);
  T* y = reinterpret_cast<T*>(base + ws.y);
  float2* stats = reinterpret_cast<float2*>(base + ws.stats);
  T* z = reinterpret_cast<T*>(base + ws.z);
  T* dh1 = reinterpret_cast<T*>(base + ws.dh1);
  float* part_sq = reinterpret_cast<float*>(base + ws.part_sq);
  float* part_s1 = reinterpret_cast<float*>(base + ws.part_s1);
  float* part_dz = reinterpret_cast<float*>(base + ws.part_dz);
  float* part_db1 = reinterpret_cast<float*>(base + ws.part_db1);
  float* part_lns = reinterpret_cast<float*>(base + ws.part_lns);
  float* part_lnb = reinterpret_cast<float*>(base + ws.part_lnb);
  float* vecs = reinterpret_cast<float*>(base + ws.vecs);
  float* part_w2 = reinterpret_cast<float*>(base + ws.part_w2);
  float* part_w1 = reinterpret_cast<float*>(base + ws.part_w1);
  float* dyln = reinterpret_cast<float*>(base + ws.dyln);
  const long long br = static_cast<long long>(batch) * rows;
  if (br > 2147483647LL) return cudaErrorInvalidValue;
  cudaError_t err =
      launch_ln_rows<T>(static_cast<const T*>(h), lns, lnb, br, c, y, stats, stream);
  if (err != cudaSuccess) return err;

  // (B, R, K) activations by 64-row units of one image; the weights and the
  // flattened (B R, K) rows by 64 x 64 boxes (W1^T by 64 x 64 CP for the
  // fused pass 2)
  const int n = static_cast<int>(br);
  CUtensorMap y_map, dy_map, w1_map, w2t_map, w1t_map, y_rows, dy_rows, z_rows, dh1_rows;
  if (rows_map(&y_map, y, c, rows, batch, kUnit) != 0 ||
      rows_map(&dy_map, dy, c, rows, batch, kUnit) != 0 ||
      rows_map(&w1_map, w1, c, c4, 1, 64) != 0 || rows_map(&w2t_map, w2t, c, c4, 1, 64) != 0 ||
      rows_map(&w1t_map, w1t, c4, c, 1, ws.cp > 0 ? 64 * ws.cp : 64) != 0 ||
      rows_map(&y_rows, y, c, n, 1, 64) != 0 || rows_map(&dy_rows, dy, c, n, 1, 64) != 0 ||
      rows_map(&z_rows, z, c4, n, 1, 64) != 0 || rows_map(&dh1_rows, dh1, c4, n, 1, 64) != 0) {
    return cudaErrorInvalidValue;
  }
  PassArgs pa{};
  pa.rows = rows;
  pa.c = c;
  pa.c4 = c4;
  pa.unit_tiles = ws.unit_tiles;
  pa.units = ws.units;
  pa.b1 = b1;
  pa.part0 = part_sq;
  pa.part1 = part_s1;
  pa.part2 = part_dz;
  // pass 1: 512 columns of 4C a block, four chunks of 128
  err = launch_pass<false, 2, 0>(y_map, dy_map, w1_map, w2t_map, w1_map, pa, 4, stream);
  if (err != cudaSuccess) return err;
  grn_bwd<<<batch, kThreads, 0, stream>>>(part_sq, part_s1, part_dz, gamma, ws.unit_tiles, c4,
                                          vecs);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  pa.part0 = part_db1;
  pa.part1 = pa.part2 = nullptr;
  pa.vecs = vecs;
  pa.gamma = gamma;
  pa.beta = beta;
  pa.z = z;
  pa.dh1 = dh1;
  pa.h = static_cast<const T*>(h);
  pa.stats = stats;
  pa.lns = lns;
  pa.dacc = static_cast<T*>(dacc);
  pa.part_lns = part_lns;
  pa.part_lnb = part_lnb;
  const size_t sums = static_cast<size_t>(ws.units) * c4;
  pa.part_chk = check == nullptr ? nullptr : check + sums;
  const int all = cdiv(c4, 64);
  if (ws.cp == 2) {
    err = launch_pass<true, 1, 2>(y_map, dy_map, w1_map, w2t_map, w1t_map, pa, all, stream);
  } else if (ws.cp == 4) {
    err = launch_pass<true, 1, 4>(y_map, dy_map, w1_map, w2t_map, w1t_map, pa, all, stream);
  } else {
    // C > 256: pass 2 by groups of 256 columns; then dyln = dh1 W1 as a
    // product over the flattened rows and the LayerNorm backward by rows
    err = launch_pass<true, 1, 0>(y_map, dy_map, w1_map, w2t_map, w1_map, pa, 4, stream);
    if (err != cudaSuccess) return err;
    const WgGemmArgs ga{n, c, c4, c4, 0, 0, dyln, static_cast<const T*>(h), stats, part_lns,
                       part_lnb};
    err = launch_wg_gemm<0, kDylnRows>(dh1_rows, w1_map, ga, 1, stream);
    if (err != cudaSuccess) return err;
    ln_bwd_rows<T><<<cdiv(br, kRowWarps), kThreads, 0, stream>>>(
        dyln, static_cast<const T*>(h), stats, lns, br, c, static_cast<T*>(dacc));
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  // the weight products dW2 = dy^T z and dW1 = dh1^T y over the B R rows
  err = launch_wgrad(dy_rows, z_rows, c, c4, br, ws.chunk, ws.splits, part_w2, stream);
  if (err != cudaSuccess) return err;
  err = launch_wgrad(dh1_rows, y_rows, c4, c, br, ws.chunk, ws.splits, part_w1, stream);
  if (err != cudaSuccess) return err;
  const long long cc4 = static_cast<long long>(c) * c4;
  const SumJobs jobs{{{part_w2, cc4, cc4, ws.splits, dw2},
                      {part_w1, cc4, cc4, ws.splits, dw1},
                      {part_db1, c4, c4, ws.units, db1},
                      {vecs + 3 * c4, static_cast<long long>(kVecs) * c4, c4, batch, dg},
                      {vecs + 4 * c4, static_cast<long long>(kVecs) * c4, c4, batch, dbe},
                      {part_lns, c, c, ws.ln_parts, dlns},
                      {part_lnb, c, c, ws.ln_parts, dlnb}}};
  int blocks = 1;  // the most any job needs, at most eight waves of 132 SMs
  for (const SumJob& jb : jobs.job) {
    blocks = std::max(blocks, cdiv(jb.n, 256 / sum_lanes(jb.parts)));
  }
  blocks = std::min(blocks, 8 * 132);
  sum_jobs<<<dim3(static_cast<unsigned>(blocks), kSumJobs), 256, 0, stream>>>(jobs);
  if ((err = cudaGetLastError()) != cudaSuccess || check == nullptr) return err;
  return cudaMemcpyAsync(check, part_sq, sums * sizeof(float), cudaMemcpyDeviceToDevice, stream);
}

bool bad_shape(int batch, int rows, int c, int c4) {
  return batch < 1 || batch > kMaxBatch || rows < 1 || c < 8 || c % 8 != 0 || c4 < 8 ||
         c4 % 8 != 0;
}

}  // namespace

// C entry points bound with ctypes; each returns a cudaError_t code.
//
// xmir_convnext_bwd_plan writes the bytes of workspace xmir_convnext_bwd
// takes for these shapes and dtype (0 = float32, 1 = bfloat16).
extern "C" int xmir_convnext_bwd_plan(int batch, int rows, int c, int c4, int dtype,
                                      long long* workspace_bytes) {
  if (bad_shape(batch, rows, c, c4) || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  *workspace_bytes = dtype == 0 ? (long long)plan_workspace(batch, rows, c, c4, sizeof(float)).total
                                 : (long long)plan_bf16(batch, rows, c, c4).total;
  return (int)cudaSuccess;
}

// The backward of one ConvNeXtV2 block tail. h the dwconv output and dy the
// cotangent, (batch, rows, c); w1 (c4, c) and its transpose w1t (c, c4), w2t
// (c4, c) the transpose of w2; h, dy, w1, w1t, w2t and dacc of one dtype, all
// contiguous and 16-byte aligned; lns, lnb (c,), b1, gamma, beta (c4,)
// float32, 16-byte aligned; workspace of xmir_convnext_bwd_plan's bytes,
// 256-byte aligned. Writes dacc (batch, rows, c) in the dtype and the float32
// parameter gradients summed over the batch: dw1 (c4, c), dw2 (c, c4), db1,
// dg, dbe (c4,), dlns, dlnb (c,). c and c4 must be multiples of 8. check:
// null, or (bf16 only) a float32 (2, units, c4) buffer (units = batch x the
// 64-row units of an image) that takes pass 1's per-unit column sums of ab^2
// and pass 2's own, bit-equal when pass 2 forms ab as pass 1 did.
extern "C" int xmir_convnext_bwd(const void* h, const void* dy, const float* lns,
                                 const float* lnb, const void* w1, const float* b1,
                                 const void* w1t, const void* w2t, const float* gamma,
                                 const float* beta, int dtype, int batch, int rows, int c, int c4,
                                 void* workspace, void* dacc, float* dw1, float* dw2, float* db1,
                                 float* dg, float* dbe, float* dlns, float* dlnb, float* check,
                                 void* stream) {
  if (bad_shape(batch, rows, c, c4) || (dtype == 0 && check != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_bwd<float>(h, dy, lns, lnb, w1, b1, w1t, w2t, gamma, beta, batch, rows, c,
                                  c4, workspace, dacc, dw1, dw2, db1, dg, dbe, dlns, dlnb, s);
  }
  if (dtype == 1) {
    return (int)launch_bwd_bf16(h, dy, lns, lnb, w1, b1, w1t, w2t, gamma, beta, batch, rows, c,
                                c4, workspace, dacc, dw1, dw2, db1, dg, dbe, dlns, dlnb, check,
                                s);
  }
  return (int)cudaErrorInvalidValue;
}
