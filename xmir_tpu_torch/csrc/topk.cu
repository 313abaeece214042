// Exact fused similarity + top-k for Hopper (sm_90a), k <= 32.
//
// Replaces xmir_tpu/ops/topk_pallas.py::fused_topk_scores (its two TPU bodies,
// _topk_kernel_pruned for k <= 128 and _topk_kernel + _merge_candidates above
// that). It computes the exact top-k of q . g^T + bias[row] per query without
// materialising the (Q, N) score matrix: ties go to the lower gallery row and
// unfilled slots are (-inf, 0). Above k = 32 the plan takes the select route
// (topk_select.cu: the same scores as ordered words, then an exact select),
// and the wrapper (xmir_tpu_torch/ops/topk_kernels.py) launches that.
//
// What bounds it: 2 Q N D operations, on the tensor cores (topk_scores.cuh:
// bf16 wgmma, or 3xTF32 in f32, three TF32 products per f32 product), 215
// GFLOP at the serving shape (Q = 1024, N = 100,000, D = 1024): 0.212 ms in
// bf16 at 989 TFLOP/s, 1.271 ms in f32 at 495 TFLOP/s; at Q = 1 the gallery's
// bytes (0.061 / 0.122 ms). The selection works on the accumulators in
// registers, so no score reaches device memory; what it costs a tile (the
// two warpgroups select at the same time, so the tensor cores wait) is the
// rest of K1's time at k = 10 (PERF.md).
//
// Design:
//   score_tiles<T, WGS, false>  (topk_scores.cuh) a block of 64 WGS queries
//                 against one split of the gallery, tile by tile. The
//                 epilogue below keeps a sorted buffer of k (value, row)
//                 pairs per query in shared memory, ordered by (value desc,
//                 row asc), and each thread keeps its two queries' k-th
//                 entries in registers. A score joins only if it ranks ahead
//                 of the k-th entry by the full (value, row) comparison
//                 (rows do not reach a thread in ascending order within a
//                 tile). A thread tests its scores eight at a time by value
//                 first, stashes up to kStash that rank ahead, and the four
//                 threads sharing a query (a quad) insert theirs in turn by
//                 a binary search; a thread with more goes on in another
//                 round. After the first tiles candidates are rare; in the
//                 first tile a floor (the quad's ceil(k / 4)-th scores) keeps
//                 the inserts near k.
//   topk_merge    one warp per query; lane l holds the heads of splits l,
//                 l + 32, ... (up to kMaxSplits) and a warp arg-max picks the
//                 next entry, the lower split winning equal values (the rule
//                 of xmir_tpu/index/gallery.py::merge_shard_candidates). With
//                 one split the block writes the result and no merge runs.
// The plan (make_plan in topk_scores.cuh, exported as xmir_topk_plan) fills
// the card at every Q: at Q <= 64 one query block and up to 132 splits (one
// a SM); at Q = 1024 and k <= 32, 8 blocks of 128 queries x 16 splits.
// Deterministic: fixed orders everywhere, no atomics; two runs are bit-equal.
// The launches go on the caller's stream and allocate nothing.

#include "topk_scores.cuh"

namespace {

// (v, i) ranks ahead of (w, j): the larger value first, then the lower row.
__device__ __forceinline__ bool ahead(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Inserts (v, i) into the sorted k-entry buffer (bv, bi), dropping the last
// entry; the caller has checked that (v, i) ranks ahead of entry k - 1.
__device__ __forceinline__ void insert_sorted(float* bv, int* bi, int k, float v, int i) {
  int p = 0, hi = k - 1;  // p: the first entry (v, i) ranks ahead of
  while (p < hi) {
    const int mid = (p + hi) >> 1;
    if (ahead(v, i, bv[mid], bi[mid])) {
      hi = mid;
    } else {
      p = mid + 1;
    }
  }
#pragma unroll 4
  for (int e = k - 1; e > p; --e) {
    bv[e] = bv[e - 1];
    bi[e] = bi[e - 1];
  }
  bv[p] = v;
  bi[p] = i;
}

template <typename T, int WGS>
struct Epilogue<T, WGS, false> {
  static constexpr int NT = Arith<T>::kNT, ACC = NT / 2, kThreads = 128 * WGS;
  float* bv;  // [64 WGS][k] values, then rows
  int* bi;
  float* sv;  // [kStash][kThreads] each thread's candidates of a tile: values
  int* sc;    // ... and their columns | h << 16
  int r[2];   // the thread's two query rows in the block
  float kth_v[2];
  int kth_i[2];

  __device__ void init(unsigned char* extra, const ScoreArgs& a, int) {
    bv = reinterpret_cast<float*>(extra);
    bi = reinterpret_cast<int*>(bv + 64 * WGS * a.k);
    sv = reinterpret_cast<float*>(bi + 64 * WGS * a.k);
    sc = reinterpret_cast<int*>(sv + kStash * kThreads);
    const int tid = threadIdx.x, lane = tid & 31;
    for (int e = lane; e < 16 * a.k; e += 32) {  // the warp's 16 queries' buffers
      bv[16 * (tid >> 5) * a.k + e] = -CUDART_INF_F;
      bi[16 * (tid >> 5) * a.k + e] = 0;
    }
    __syncwarp();
    const int base = 16 * (tid >> 5) + (lane >> 2);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      r[h] = base + 8 * h;
      kth_v[h] = -CUDART_INF_F;
      kth_i[h] = 0;
    }
  }

  __device__ void tile(float (&acc)[ACC], const ScoreArgs& a, int q0, int row0, int row_end) {
    const int tid = threadIdx.x, t = tid & 3;
    const int live_cols = row_end - row0;
    const bool live_q[2] = {q0 + r[0] < a.n_queries, q0 + r[1] < a.n_queries};
    if (!__any_sync(kFull, live_q[0])) return;  // the warp's queries are all past Q
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        const bool live = col < live_cols;  // the ragged tile: rows past the split
        const float b = live ? __ldg(a.bias + row0 + col) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          acc[4 * j + 2 * h + e] = live ? acc[4 * j + 2 * h + e] + b : -CUDART_INF_F;
        }
      }
    }
    // While a query's buffer is not full (its first tile), a floor for its
    // candidates: each thread's ceil(k / 4)-th largest distinct score of
    // the query in this tile, the least of the quad's four. The quad holds
    // k scores at or above it, so no score below it can be in the top k,
    // and the first tile inserts about k entries where it would insert
    // many times that.
    float floor_v[2] = {-CUDART_INF_F, -CUDART_INF_F};
    const bool warm = (live_q[0] && kth_v[0] == -CUDART_INF_F) ||
                      (live_q[1] && kth_v[1] == -CUDART_INF_F);
    if (__any_sync(kFull, warm)) {
      const int levels = (a.k + 3) / 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float above = CUDART_INF_F;
        for (int l = 0; l < levels; ++l) {
          float m = -CUDART_INF_F;
#pragma unroll
          for (int i = 2 * h; i < ACC; i += 4) {
            m = fmaxf(m, acc[i] < above ? acc[i] : -CUDART_INF_F);
            m = fmaxf(m, acc[i + 1] < above ? acc[i + 1] : -CUDART_INF_F);
          }
          above = m;
        }
        above = fminf(above, __shfl_xor_sync(kFull, above, 1));
        floor_v[h] = fminf(above, __shfl_xor_sync(kFull, above, 2));
      }
    }
    // rounds, until every candidate of the tile found room in the stash; a
    // round takes the thread's scores after the last one it stashed before
    for (int done = -1;;) {
      // the thread's scores that rank ahead of its queries' k-th entries, to
      // its stash: a branch-free value test over eight scores at a time
      // first (after the first tiles it fails), then the exact test
      const float thr[2] = {live_q[0] ? fmaxf(kth_v[0], floor_v[0]) : CUDART_INF_F,
                            live_q[1] ? fmaxf(kth_v[1], floor_v[1]) : CUDART_INF_F};
      int n = 0, last = done;
#pragma unroll
      for (int i8 = 0; i8 < ACC; i8 += 8) {
        bool hit = false;
#pragma unroll
        for (int i = i8; i < i8 + 8; ++i) hit |= acc[i] >= thr[(i >> 1) & 1];
        if (!hit || i8 + 7 <= done) continue;
#pragma unroll
        for (int i = i8; i < i8 + 8; ++i) {
          const int h = (i >> 1) & 1, col = 8 * (i >> 2) + 2 * t + (i & 1);
          if (i > done && acc[i] >= thr[h] && ahead(acc[i], row0 + col, kth_v[h], kth_i[h])) {
            if (n < kStash) {
              sv[n * kThreads + tid] = acc[i];
              sc[n * kThreads + tid] = col | (h << 16);
              last = i;
            }
            ++n;
          }
        }
      }
      if (!__any_sync(kFull, n > 0)) return;
      // the quad's threads insert in turn (a turn no thread of the warp
      // needs is skipped), each against its buffer's k-th entry as the
      // others' inserts left it
      for (int turn = 0; turn < 4; ++turn) {
        if (!__any_sync(kFull, t == turn && n > 0)) continue;
        if (t == turn) {
          for (int c = 0; c < min(n, kStash); ++c) {
            const float v = sv[c * kThreads + tid];
            const int packed = sc[c * kThreads + tid], h = packed >> 16;
            const int row = row0 + (packed & 0xffff);
            // h picked by a select: an index into r would put r, and the
            // object with it, in local memory
            const int qr = h ? r[1] : r[0];
            float* const bq = bv + qr * a.k;
            int* const iq = bi + qr * a.k;
            if (ahead(v, row, bq[a.k - 1], iq[a.k - 1])) insert_sorted(bq, iq, a.k, v, row);
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        kth_v[h] = bv[r[h] * a.k + a.k - 1];
        kth_i[h] = bi[r[h] * a.k + a.k - 1];
      }
      if (!__any_sync(kFull, n > kStash)) return;
      done = last;
    }
  }

  // the warp's 16 queries' buffers to (n_queries, n_splits, k)
  __device__ void finish(const ScoreArgs& a, int q0, int split) {
    __syncwarp();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int rr = 0; rr < 16; ++rr) {
      const int row = 16 * warp + rr, qi = q0 + row;
      if (qi >= a.n_queries) break;
      const size_t out = (static_cast<size_t>(qi) * a.n_splits + split) * a.k;
      for (int e = lane; e < a.k; e += 32) {
        a.part_v[out + e] = bv[row * a.k + e];
        a.part_i[out + e] = bi[row * a.k + e];
      }
    }
  }
};

constexpr int kMergeThreads = 256;
constexpr int kHeads = kMaxSplits / 32;  // split heads a lane

__global__ void __launch_bounds__(kMergeThreads) topk_merge(
    const float* __restrict__ part_v, const int* __restrict__ part_i, int n_queries,
    int n_splits, int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  const int qi = (blockIdx.x * kMergeThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (qi >= n_queries) return;  // uniform over the warp
  const size_t base = static_cast<size_t>(qi) * n_splits * k;
  int pos[kHeads];
  float hv[kHeads];
  int hi[kHeads];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    const int s = lane + 32 * h;
    pos[h] = 0;
    hv[h] = s < n_splits ? part_v[base + static_cast<size_t>(s) * k] : -CUDART_INF_F;
    hi[h] = s < n_splits ? part_i[base + static_cast<size_t>(s) * k] : 0;
  }
  for (int j = 0; j < k; ++j) {
    // this lane's best head, its lower split first on equal values
    float best = hv[0];
    int bh = 0, row = hi[0];
#pragma unroll
    for (int h = 1; h < kHeads; ++h) {
      if (hv[h] > best) {
        best = hv[h];
        bh = h;
        row = hi[h];
      }
    }
    int src = lane + 32 * bh;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, best, off);
      const int os = __shfl_xor_sync(kFull, src, off);
      const int orow = __shfl_xor_sync(kFull, row, off);
      if (ov > best || (ov == best && os < src)) {
        best = ov;
        src = os;
        row = orow;
      }
    }
    if (lane == 0) {
      out_v[static_cast<size_t>(qi) * k + j] = best;
      out_i[static_cast<size_t>(qi) * k + j] = best == -CUDART_INF_F ? 0 : row;
    }
    if (lane == (src & 31)) {  // advance the winning head
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        if (h == src >> 5) {
          ++pos[h];
          const bool more = pos[h] < k && src < n_splits;
          const size_t at = base + static_cast<size_t>(src) * k + pos[h];
          hv[h] = more ? part_v[at] : -CUDART_INF_F;
          hi[h] = more ? part_i[at] : 0;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* g, const float* bias, int n_queries, int n_rows,
                   int depth, int k, const Plan& p, void* scratch, float* part_v, int* part_i,
                   float* out_v, int* out_i, cudaStream_t stream) {
  ScoreArgs args{};
  args.bias = bias;
  args.n_queries = n_queries;
  args.n_rows = n_rows;
  args.depth = depth;
  args.k = k;
  const bool merge = p.n_splits > 1;  // one split: the block writes the result
  args.part_v = merge ? part_v : out_v;
  args.part_i = merge ? part_i : out_i;
  cudaError_t err = launch_scores<T, false>(q, g, p, args, scratch, stream);
  if (err != cudaSuccess || !merge) return err;
  const int blocks = (n_queries * 32 + kMergeThreads - 1) / kMergeThreads;
  topk_merge<<<blocks, kMergeThreads, 0, stream>>>(part_v, part_i, n_queries, p.n_splits, k,
                                                   out_v, out_i);
  return cudaGetLastError();
}

bool valid_sizes(int n_queries, int n_rows, int depth, int k, int dtype, int n_sms) {
  return n_queries >= 1 && n_rows >= 1 && depth >= 1 && k >= 1 && k <= n_rows && n_sms >= 1 &&
         (dtype == 0 || dtype == 1);
}

Plan plan_for(int n_queries, int n_rows, int depth, int k, int dtype, int n_sms) {
  return dtype == 0 ? make_plan<float>(n_queries, n_rows, depth, k, n_sms, false)
                    : make_plan<__nv_bfloat16>(n_queries, n_rows, depth, k, n_sms, false);
}

}  // namespace

// C entry points bound with ctypes; each returns a cudaError_t code.
//
// xmir_topk_plan writes the plan K1 takes for these sizes (dtype 0 = float32,
// 1 = bfloat16) on a card with n_sms SMs, as 9 ints: block_queries,
// n_splits, rows_per_split, route (0 fused, k <= 32; 1 select: the wrapper
// launches xmir_topk_select), tile_rows, stages, depth (padded for the copy
// engine where D's rows are not a multiple of 16 bytes), smem, wgs. The
// caller sizes the partial buffers (n_queries, n_splits, k) and the scratch
// (xmir_topk) from it.
extern "C" int xmir_topk_plan(int n_queries, int n_rows, int depth, int k, int dtype, int n_sms,
                              int* out) {
  if (!valid_sizes(n_queries, n_rows, depth, k, dtype, n_sms)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(n_queries, n_rows, depth, k, dtype, n_sms);
  const int fields[9] = {64 * p.wgs, p.n_splits, p.rows_per_split, p.route, p.tile_rows,
                         p.stages, p.depth, p.smem, p.wgs};
  for (int i = 0; i < 9; ++i) out[i] = fields[i];
  return (int)cudaSuccess;
}

// q (n_queries, depth) and g (n_rows, depth) contiguous, of one dtype; bias
// (n_rows,) float32; scratch holds q and g with padded rows where the plan
// pads D, then in f32 the queries' small parts: (n_queries + n_rows) x plan
// depth elements if padded, plus n_queries x plan depth floats in f32 (the
// wrapper's topk_kernels._scratch); part_v / part_i hold (n_queries,
// n_splits, k) of the plan where it has more than one split; out_v, out_i
// (n_queries, k). k <= 32: the plan's fused route.
extern "C" int xmir_topk(const void* q, const void* g, const float* bias, int dtype,
                         int n_queries, int n_rows, int depth, int k, int n_sms, void* scratch,
                         float* part_v, int* part_i, float* out_v, int* out_i, void* stream) {
  if (!valid_sizes(n_queries, n_rows, depth, k, dtype, n_sms)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(n_queries, n_rows, depth, k, dtype, n_sms);
  if (p.route != kRouteFused) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return (int)launch<float>(q, g, bias, n_queries, n_rows, depth, k, p, scratch, part_v, part_i,
                              out_v, out_i, s);
  }
  return (int)launch<__nv_bfloat16>(q, g, bias, n_queries, n_rows, depth, k, p, scratch, part_v,
                                    part_i, out_v, out_i, s);
}
