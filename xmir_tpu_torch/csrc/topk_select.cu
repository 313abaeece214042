// Exact fused similarity + top-k for k above 1024 on Hopper (sm_90a).
//
// Replaces the large-k half of xmir_tpu/ops/topk_pallas.py::fused_topk_scores
// (body _topk_kernel with _merge_candidates, which merges a (query block, k)
// candidate list with each gallery tile in k passes). It gives what topk.cu
// gives for k <= 1024: the exact top-k of q . g^T + bias[row] per query,
// sorted by value descending with ties to the lower gallery row, unfilled
// slots (-inf, 0). A sorted per-query buffer of k entries no longer fits
// shared memory (k is the whole gallery for a full ranking), so the design
// is another one:
//   score_keys   a tiled IEEE f32 FMA product (64 queries x 64 rows a block,
//                depth in ascending order in one accumulator, as topk.cu
//                sums it, so both kernels give the same values) that writes
//                one 64-bit key per (query, row): the score's bits mapped so
//                that unsigned order is float order in the high word, the
//                inverted row in the low word. Key order IS the result's
//                order, the tie rule included, and every key is unique.
//   select_sort  one block per query: an 8-pass radix select (one byte a
//                pass, from the top) finds the k-th largest key exactly; the
//                k keys at or above it are gathered into a per-query buffer,
//                padded to a power of two and sorted descending by a bitonic
//                network; then the keys are decoded.
// The keys (Q, N) and the buffers (Q, k rounded up to a power of two) live in
// device memory, 8 bytes an entry: the wrapper
// (xmir_tpu_torch/ops/topk_kernels.py) allocates them and walks the queries
// in chunks to bound them.
//
// What bounds it: 2 Q N D FLOP of f32 FMAs (215 GFLOP at Q = 1024,
// N = 100,000, D = 1024) against Q N 8 B of keys written once and read nine
// times (0.8 GB a pass): operations, then the passes over the keys. This
// first version stages single-buffered and sorts through L2; a score product
// on the tensor cores (3xTF32), a select that reads the keys fewer times and
// a sort that keeps short strides in shared memory are later work.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

using Key = unsigned long long;

constexpr int kTile = 64;           // queries, and gallery rows, per block of score_keys
constexpr int kDepth = 32;          // depth chunk staged through shared memory
constexpr int kStride = kTile + 4;  // 16-byte aligned rows
constexpr int kScoreThreads = 256;  // 16 x 16 threads, 4 x 4 scores each
constexpr int kSortThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// (score, row) -> a key whose unsigned order is (score ascending, row
// descending); -0 counts as +0, so equal scores tie.
__device__ __forceinline__ Key make_key(float score, int row) {
  unsigned u = __float_as_uint(__fadd_rn(score, 0.f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<Key>(u) << 32) | static_cast<unsigned>(~row);
}
__device__ __forceinline__ float key_score(Key key) {
  const unsigned u = static_cast<unsigned>(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
__device__ __forceinline__ int key_row(Key key) {
  return static_cast<int>(~static_cast<unsigned>(key & 0xffffffffu));
}

// Thread (ty, tx) owns queries 4 ty .. 4 ty + 3 and rows 4 tx .. 4 tx + 3 of
// the block's tile; both operands are staged depth-major.
template <typename T>
__global__ void __launch_bounds__(kScoreThreads) score_keys(
    const T* __restrict__ q, const T* __restrict__ g, const float* __restrict__ bias,
    int n_queries, int n_rows, int depth, Key* __restrict__ keys) {
  __shared__ __align__(16) float qs[kDepth][kStride];
  __shared__ __align__(16) float gs[kDepth][kStride];
  const int r0 = blockIdx.x * kTile, q0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int d0 = 0; d0 < depth; d0 += kDepth) {
    for (int e = tid; e < kTile * kDepth; e += kScoreThreads) {
      const int r = e / kDepth, d = e % kDepth;
      const bool live = d0 + d < depth;
      qs[d][r] = (live && q0 + r < n_queries)
                     ? to_f32(q[static_cast<size_t>(q0 + r) * depth + d0 + d]) : 0.f;
      gs[d][r] = (live && r0 + r < n_rows)
                     ? to_f32(g[static_cast<size_t>(r0 + r) * depth + d0 + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const float4 a4 = *reinterpret_cast<const float4*>(&qs[d][4 * ty]);
      const float4 b4 = *reinterpret_cast<const float4*>(&gs[d][4 * tx]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= n_queries) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = r0 + 4 * tx + j;
      if (row < n_rows) {
        keys[static_cast<size_t>(qi) * n_rows + row] = make_key(acc[i][j] + bias[row], row);
      }
    }
  }
}

// One block per query. keys (n_queries, n_rows); buf (n_queries, k_pad), k_pad
// the power of two at or above k.
__global__ void __launch_bounds__(kSortThreads) select_sort(
    const Key* __restrict__ keys, int n_rows, int k, int k_pad, Key* __restrict__ buf,
    float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ unsigned hist[257];  // bin 256 takes the keys outside the prefix
  __shared__ int s_bin, s_remaining;
  __shared__ unsigned s_count;
  const Key* kq = keys + static_cast<size_t>(blockIdx.x) * n_rows;
  Key* bq = buf + static_cast<size_t>(blockIdx.x) * k_pad;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_up = (n_rows + kSortThreads - 1) / kSortThreads * kSortThreads;

  // radix select: after the pass over byte p, `prefix` holds the top 8 - p
  // bytes of the k-th largest key and `remaining` its rank among the keys
  // that share them
  Key prefix = 0;
  int remaining = k;
  for (int p = 7; p >= 0; --p) {
    for (int b = tid; b < 257; b += kSortThreads) hist[b] = 0;
    __syncthreads();
    for (int i = tid; i < n_up; i += kSortThreads) {  // whole warps take each step
      int bin = 256;
      if (i < n_rows) {
        const Key key = kq[i];
        if (p == 7 || (key >> (8 * (p + 1))) == prefix) bin = static_cast<int>((key >> (8 * p)) & 255);
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin < 256 && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid == 0) {
      int above = 0, b = 255;
      for (; b > 0; --b) {
        if (above + static_cast<int>(hist[b]) >= remaining) break;
        above += static_cast<int>(hist[b]);
      }
      s_bin = b;
      s_remaining = remaining - above;
      s_count = 0;
    }
    __syncthreads();
    prefix = (prefix << 8) | static_cast<Key>(s_bin);
    remaining = s_remaining;
  }

  // the k keys at or above the k-th largest, in any order, then the padding
  for (int i = tid; i < n_up; i += kSortThreads) {
    Key key = 0;
    bool take = false;
    if (i < n_rows) {
      key = kq[i];
      take = key >= prefix;
    }
    const unsigned takers = __ballot_sync(kFull, take);
    unsigned base = 0;
    if (lane == 0 && takers) base = atomicAdd(&s_count, __popc(takers));
    base = __shfl_sync(kFull, base, 0);
    if (take) bq[base + __popc(takers & ((1u << lane) - 1u))] = key;
  }
  for (int i = k + tid; i < k_pad; i += kSortThreads) bq[i] = 0;  // below every real key
  __syncthreads();

  // bitonic sort, descending
  for (int size = 2; size <= k_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll 4
      for (int i = tid; i < k_pad / 2; i += kSortThreads) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const bool descending = (lo & size) == 0;
        const Key a = bq[lo], b = bq[hi];
        if ((a < b) == descending) {
          bq[lo] = b;
          bq[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < k; i += kSortThreads) {
    const Key key = bq[i];
    const float score = key_score(key);
    out_v[static_cast<size_t>(blockIdx.x) * k + i] = score;
    out_i[static_cast<size_t>(blockIdx.x) * k + i] = score == -CUDART_INF_F ? 0 : key_row(key);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* g, const float* bias, int n_queries, int n_rows,
                   int depth, int k, int k_pad, Key* keys, Key* buf, float* out_v, int* out_i,
                   cudaStream_t stream) {
  const dim3 grid((n_rows + kTile - 1) / kTile, (n_queries + kTile - 1) / kTile);
  score_keys<T><<<grid, kScoreThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(g), bias, n_queries, n_rows, depth, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  select_sort<<<n_queries, kSortThreads, 0, stream>>>(keys, n_rows, k, k_pad, buf, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes; returns a cudaError_t code. q (n_queries,
// depth) and g (n_rows, depth) contiguous, of one dtype (0 = float32,
// 1 = bfloat16); bias (n_rows,) float32; keys holds n_queries x n_rows and
// buf n_queries x k_pad 64-bit words, k_pad the power of two at or above k;
// out_v, out_i (n_queries, k).
extern "C" int xmir_topk_select(const void* q, const void* g, const float* bias, int dtype,
                                int n_queries, int n_rows, int depth, int k, int k_pad,
                                void* keys, void* buf, float* out_v, int* out_i, void* stream) {
  if (n_queries < 1 || n_rows < 1 || depth < 1 || k < 1 || k > n_rows || k_pad < k ||
      k_pad < 2 || (k_pad & (k_pad - 1)) != 0 || (n_queries + kTile - 1) / kTile > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(q, g, bias, n_queries, n_rows, depth, k, k_pad,
                              static_cast<Key*>(keys), static_cast<Key*>(buf), out_v, out_i, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, g, bias, n_queries, n_rows, depth, k, k_pad,
                                      static_cast<Key*>(keys), static_cast<Key*>(buf), out_v,
                                      out_i, s);
  }
  return (int)cudaErrorInvalidValue;
}
