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
// s1 = sum dz ab) come before any row's dab. So the backward runs as a chain
// of launches, each owning its outputs, every sum in a fixed order and no
// atomics (two runs give the same bits):
//
//   ln_rows       a warp per row: the LayerNorm statistics (f32, the fast
//                 variance, eps 1e-6) and y = xhat lns + lnb rounded to the
//                 dtype, written once (:225-230)
//   gemm_bwd<kH1> h1 = y W1^T + b1 (f32, stored), ab = GELU(h1) rounded, the
//                 column sums of ab^2 per (image, 128-row tile) (:231-236)
//   gemm_bwd<kDz> dz = dy W2 (f32, stored); the column sums of dz ab and of
//                 dz per (image, row tile) (:241-248)
//   grn_bwd       a block per image: gx, nx, s1, dgamma and dbeta of the
//                 image, dgx; the two per-column factors of
//                 dab = dz (gamma nx + 1) + ab (dgx / gx) (:236-253)
//   dh1_pass      z = gamma ab nx + beta + ab and dh1 = dab GELU'(h1), both
//                 rounded to the dtype and stored; the column sums of the f32
//                 dh1 (db1) (:242, 253-259)
//   gemm_bwd<kDyln> dyln = dh1 W1 (f32, stored); the column sums of
//                 dyln xhat and dyln (dln_scale, dln_bias) (:261-263)
//   ln_bwd_rows   a warp per row: dacc = rstd (dyh - mean dyh - xhat
//                 mean(dyh xhat)), dyh = dyln lns, in h's dtype (:264-270)
//   gemm_tn x 2   the weight products, whose depth is the B R rows:
//                 dW2 = dy^T z and dW1 = dh1^T y. Their operands are row-major
//                 over that depth, so each 128-wide tile is transposed on its
//                 way into shared memory; the depth is split into fixed
//                 chunks, one partial product each (:243-245, 260)
//   sum_parts     the partial sums over row tiles, images and depth chunks,
//                 in order
//
// GELU: t = tanh(K0 (h1 + K1 h1^3)), ab = 0.5 h1 (1 + t), each step rounded
// on its own (no contraction into FMAs), so the three launches that recompute
// ab from the stored h1 agree bit for bit. Rounding points are the TPU
// kernel's: y, ab, z and dh1 in the dtype before their products, everything
// else f32, dacc in h's dtype.
//
// What bounds it: five products of 2 R C 4C FLOP per image (1.9e10 at 384 px
// and B = 2, the same at every stage); in bf16 they run on the tensor cores
// (mma.sync m16n8k16 through gemm_tile.cuh), in f32 on IEEE FMAs (no TF32). In
// this first version the f32 intermediates h1, dz and dyln and the rounded z
// and dh1 make round trips through device memory (about 1 GB of scratch at
// stage 1, B = 16, bf16); the weight products stage their transposed tiles
// with scalar shared-memory stores. wgmma, TMA and keeping intermediates on
// chip are later work.
//
// Operands: activations (B, R, K) row-major, torch Linear weights (N, K)
// row-major: w1 (4C, C), and the transposes w1t (C, 4C) and w2t (4C, C) that
// the wrapper (xmir_tpu_torch/ops/convnext_block.py) makes. The launches go on
// the caller's stream and allocate nothing: the wrapper passes a workspace of
// xmir_convnext_bwd_plan's size.

#include "gemm_tile.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kThreads) ln_rows(const T* __restrict__ h,
                                                    const float* __restrict__ lns,
                                                    const float* __restrict__ lnb,
                                                    long long n_rows, int C, T* __restrict__ y,
                                                    float2* __restrict__ stats) {
  constexpr int kVec = Tile<T>::kVec;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const T* hr = h + row * C;
  float s = 0.f, ss = 0.f;
  for (int k = lane * kVec; k < C; k += 32 * kVec) {
    float f[kVec];
    unpack(ldg16(hr + k), f);
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
  if (lane == 0) stats[row] = make_float2(mean, rstd);
  T* yr = y + row * C;
  for (int k = lane * kVec; k < C; k += 32 * kVec) {
    float f[kVec], p0[kVec], p1[kVec];
    unpack(ldg16(hr + k), f);
    load_floats(p0, lns + k);
    load_floats(p1, lnb + k);
#pragma unroll
    for (int e = 0; e < kVec; ++e) f[e] = round_to((f[e] - mean) * rstd * p0[e] + p1[e], T());
    stash_vec(yr + k, f);
  }
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
// a chunk of rows (a multiple of 32, the bf16 stage depth) per split, enough
// splits for about kTargetBlocks blocks.
void depth_split(int m, int n, long long depth, long long* chunk, int* splits) {
  const int tiles = cdiv(m, kBM) * cdiv(n, kBN);
  const int want = cdiv(kTargetBlocks, tiles);
  long long c = (depth + want - 1) / want;
  c = (c + 31) / 32 * 32;
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
  depth_split(c, c4, (long long)br, &w.chunk, &w.splits);
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

  ln_rows<T><<<cdiv(br, kRowWarps), kThreads, 0, stream>>>(static_cast<const T*>(h), lns, lnb,
                                                            br, c, y, stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
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

bool bad_shape(int batch, int rows, int c, int c4) {
  return batch < 1 || batch > kMaxBatch || rows < 1 || c < 8 || c % 8 != 0 || c4 < 8 ||
         c4 % 8 != 0;
}

size_t elem_size(int dtype) { return dtype == 0 ? sizeof(float) : sizeof(__nv_bfloat16); }

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
  *workspace_bytes = (long long)plan_workspace(batch, rows, c, c4, elem_size(dtype)).total;
  return (int)cudaSuccess;
}

// The backward of one ConvNeXtV2 block tail. h the dwconv output and dy the
// cotangent, (batch, rows, c); w1 (c4, c) and its transpose w1t (c, c4), w2t
// (c4, c) the transpose of w2; h, dy, w1, w1t, w2t and dacc of one dtype, all
// contiguous and 16-byte aligned; lns, lnb (c,), b1, gamma, beta (c4,)
// float32, 16-byte aligned; workspace of xmir_convnext_bwd_plan's bytes,
// 256-byte aligned. Writes dacc (batch, rows, c) in the dtype and the float32
// parameter gradients summed over the batch: dw1 (c4, c), dw2 (c, c4), db1,
// dg, dbe (c4,), dlns, dlnb (c,). c and c4 must be multiples of 8.
extern "C" int xmir_convnext_bwd(const void* h, const void* dy, const float* lns,
                                 const float* lnb, const void* w1, const float* b1,
                                 const void* w1t, const void* w2t, const float* gamma,
                                 const float* beta, int dtype, int batch, int rows, int c, int c4,
                                 void* workspace, void* dacc, float* dw1, float* dw2, float* db1,
                                 float* dg, float* dbe, float* dlns, float* dlnb, void* stream) {
  if (bad_shape(batch, rows, c, c4)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch_bwd<float>(h, dy, lns, lnb, w1, b1, w1t, w2t, gamma, beta, batch, rows, c,
                                  c4, workspace, dacc, dw1, dw2, db1, dg, dbe, dlns, dlnb, s);
  }
  if (dtype == 1) {
    return (int)launch_bwd<__nv_bfloat16>(h, dy, lns, lnb, w1, b1, w1t, w2t, gamma, beta, batch,
                                          rows, c, c4, workspace, dacc, dw1, dw2, db1, dg, dbe,
                                          dlns, dlnb, s);
  }
  return (int)cudaErrorInvalidValue;
}
