// Exact fused similarity + top-k on Hopper (sm_90a): K1', the select route
// that the plan (topk.cu: make_plan) takes above k = kFusedMaxK (32).
//
// Replaces the large-k half of xmir_tpu/ops/topk_pallas.py::fused_topk_scores
// (body _topk_kernel with _merge_candidates, which merges a (query block, k)
// candidate list with each gallery tile in k passes). It gives what topk.cu
// gives: the exact top-k of q . g^T + bias[row] per query, sorted by value
// descending with ties to the lower gallery row, unfilled slots (-inf, 0).
// topk.cu keeps a sorted per-query buffer of k entries in shared memory,
// which it takes up to k = 32; above (up to the whole gallery for a full
// ranking) the design is another one:
//   score_tiles<T, WGS, true>  (topk_scores.cuh) K1's score producer, the
//                same instructions in the same depth order (so the first
//                1024 entries equal K1's bit for bit), with an epilogue that
//                writes each score as a 32-bit word whose unsigned order is
//                the score's order (score_word); a word's row is its place.
//   select_sort  one block per query. Below k = N, a radix select on the
//                words (digits of 11, 11 and 10 bits from the top: three
//                passes) finds the k-th largest word W exactly; a gather pass
//                then takes, in row order, every word above W and the first
//                k - #above words equal to W (the lower rows win the tie).
//                At k = N there is no select: the words themselves, in row
//                order, are the list. The list is then sorted by a stable LSD
//                radix sort on the word (four passes of 8 bits, one pass of
//                histograms first), descending, the row as payload: being
//                stable, it keeps equal words in row order, so the tie rule
//                costs nothing. The last pass writes (value, row).
// Scratch (the wrapper allocates it and walks the queries in chunks to bound
// it): 4 N bytes of words and 16 k bytes of sort lists a query, and in f32 4 D
// bytes of the query's small parts. At Q = 1024, N = 100,000, D = 1024,
// k = 2048 in f32 one call peaks 443 MiB above its inputs (chip_smoke.py's
// K1' rates, torch.cuda.max_memory_allocated): 391 MiB of words, 32 of sort
// lists, 4 of small parts and the 16 MiB result (the 64-bit keys before this
// design: 814 MiB).
//
// What bounds it: 2 Q N D operations on the tensor cores (0.212 ms bf16,
// 1.271 ms f32 as 3xTF32 at Q = 1024, D = 1024), then the words: written
// once (Q N 4 B, 0.41 GB at Q = 1024), read four times below k = N (three
// histograms and the gather: 1.6 GB, ~0.5 ms) and once at k = N, and the
// sort's four passes over 8 k bytes. Deterministic: the histograms' integer
// atomics are order-free, every list is placed by prefix sums in row order.

#include "topk_scores.cuh"

namespace {

template <typename T, int WGS>
struct Epilogue<T, WGS, true> {
  static constexpr int NT = Arith<T>::kNT, ACC = NT / 2;
  int r[2];  // the thread's two query rows in the block

  __device__ void init(unsigned char*, const ScoreArgs&, int) {
    const int tid = threadIdx.x;
    r[0] = 16 * (tid >> 5) + ((tid & 31) >> 2);
    r[1] = r[0] + 8;
  }

  __device__ void tile(float (&acc)[ACC], const ScoreArgs& a, int q0, int row0, int row_end) {
    const int t = threadIdx.x & 3;
    const int live_cols = row_end - row0;
    // a thread's two neighbouring columns as one 8-byte store where the rows
    // allow it (an even N, both columns live): a warp's store then fills
    // whole 32-byte sectors
    const bool pairs = (a.n_rows & 1) == 0;
#pragma unroll
    for (int j = 0; j < NT / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= live_cols) continue;  // the ragged tile: rows past the split
      const bool both = col + 1 < live_cols;
      const float b0 = __ldg(a.bias + row0 + col);
      const float b1 = both ? __ldg(a.bias + row0 + col + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qi = q0 + r[h];
        if (qi >= a.n_queries) continue;
        uint32_t* const w = a.words + static_cast<size_t>(qi) * a.n_rows + row0 + col;
        const uint32_t w0 = score_word(acc[4 * j + 2 * h] + b0);
        const uint32_t w1 = score_word(acc[4 * j + 2 * h + 1] + b1);
        if (pairs && both) {
          *reinterpret_cast<uint2*>(w) = make_uint2(w0, w1);
        } else {
          w[0] = w0;
          if (both) w[1] = w1;
        }
      }
    }
  }

  __device__ void finish(const ScoreArgs&, int, int) {}
};

constexpr int kSortThreads = 1024;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kUnroll = 4;  // words a thread loads at once in a pass over the words

struct SortSmem {
  union {
    unsigned hist[2048];  // the select's histogram of one digit
    struct {
      unsigned short cnt[256][kSortWarps];  // a sort tile: each warp's count of a digit
      unsigned short off[256][kSortWarps];  // ... and its first place in the tile's digit run
    } tile;
  } u;
  unsigned base[4][256];  // the sort's digit histograms, then each digit's first place
  unsigned run[256];      // a sort pass: each digit's next place after this tile
  unsigned prev[256];     // ... and before it
  unsigned part[33];      // block scans: each warp's part, then the total
  unsigned scalar[3];
};

// Exclusive prefix of f over the block's threads in order; total: the count.
__device__ unsigned block_exclusive(bool f, unsigned (&part)[33], unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, f);
  if (lane == 0) part[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const unsigned c = part[lane];
    unsigned incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    part[lane] = incl - c;
    if (lane == 31) part[32] = incl;
  }
  __syncthreads();
  total = part[32];
  const unsigned r = part[warp] + __popc(ballot & ((1u << lane) - 1u));
  __syncthreads();
  return r;
}

// Inclusive prefix of v over the block's threads in order.
__device__ unsigned block_inclusive(unsigned v, unsigned (&part)[33]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned c = part[lane];
    unsigned w_incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(kFull, w_incl, off);
      if (lane >= off) w_incl += o;
    }
    part[lane] = w_incl - c;
  }
  __syncthreads();
  const unsigned r = incl + part[warp];
  __syncthreads();
  return r;
}

// One block per query. words (n_queries, n_rows); lists (n_queries, 2, k) of
// (word, row) pairs; out (n_queries, k).
__global__ void __launch_bounds__(kSortThreads) select_sort(
    const uint32_t* __restrict__ words, int n_rows, int k, uint2* __restrict__ lists,
    float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ SortSmem sm;
  const uint32_t* const wq = words + static_cast<size_t>(blockIdx.x) * n_rows;
  uint2* const la = lists + static_cast<size_t>(blockIdx.x) * 2 * k;
  uint2* const lb = la + k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const bool select = k < n_rows;

  if (select) {
    // radix select: after a pass, `prefix` holds the top bits of the k-th
    // largest word and `remaining` its rank among the words sharing them
    unsigned prefix = 0, remaining = static_cast<unsigned>(k), ties = 0;
    for (int pass = 0; pass < 3; ++pass) {
      const int shift = pass == 0 ? 21 : pass == 1 ? 10 : 0, bits = pass == 2 ? 10 : 11;
      const int bins = 1 << bits;
      for (int b = tid; b < bins; b += kSortThreads) sm.u.hist[b] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n_rows; i0 += kUnroll * kSortThreads) {  // whole warps take each step
        uint32_t w[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kSortThreads + tid;
          w[u] = i < n_rows ? wq[i] : 0u;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kSortThreads + tid;
          int bin = bins;
          if (i < n_rows && (pass == 0 || (w[u] >> (shift + bits)) == prefix)) {
            bin = static_cast<int>((w[u] >> shift) & (bins - 1));
          }
          const unsigned peers = __match_any_sync(kFull, bin);
          if (bin < bins && lane == __ffs(peers) - 1) atomicAdd(&sm.u.hist[bin], __popc(peers));
        }
      }
      __syncthreads();
      // thread t owns `per` bins from the top: bins - per (t + 1) .. bins - per t - 1
      const int per = bins / kSortThreads, hi = bins - per * tid;
      unsigned local = 0;
      for (int b = hi - 1; b >= hi - per; --b) local += sm.u.hist[b];
      const unsigned incl = block_inclusive(local, sm.part);
      unsigned acc = incl - local;
      if (acc < remaining && remaining <= incl) {
        for (int b = hi - 1; b >= hi - per; --b) {
          if (acc + sm.u.hist[b] >= remaining) {
            sm.scalar[0] = static_cast<unsigned>(b);
            sm.scalar[1] = acc;
            sm.scalar[2] = sm.u.hist[b];  // the words sharing the new prefix
            break;
          }
          acc += sm.u.hist[b];
        }
      }
      __syncthreads();
      prefix = (prefix << bits) | sm.scalar[0];
      remaining -= sm.scalar[1];
      ties = sm.scalar[2];
      __syncthreads();
    }
    // the list, in row order: every word above W = prefix, then the first
    // `remaining` of the `ties` words equal to W (all of them, mostly: then
    // one scan a tile)
    const bool all_ties = remaining == ties;
    unsigned eq_base = 0, take_base = 0;
    for (int i0 = 0; i0 < n_rows; i0 += kUnroll * kSortThreads) {
      uint32_t w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kSortThreads + tid;
        w[u] = i < n_rows ? wq[i] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kSortThreads + tid;
        const bool gt = i < n_rows && w[u] > prefix, eq = i < n_rows && w[u] == prefix;
        bool take = gt || eq;
        if (!all_ties) {
          unsigned eq_total;
          const unsigned eq_rank = eq_base + block_exclusive(eq, sm.part, eq_total);
          take = gt || (eq && eq_rank < remaining);
          eq_base += eq_total;
        }
        unsigned take_total;
        const unsigned at = take_base + block_exclusive(take, sm.part, take_total);
        if (take) la[at] = make_uint2(w[u], static_cast<unsigned>(i));
        take_base += take_total;
      }
    }
  }

  // stable LSD radix sort of the k-entry list, descending: ascending on ~word
  for (int e = tid; e < 4 * 256; e += kSortThreads) (&sm.base[0][0])[e] = 0;
  for (int e = tid; e < 256 * kSortWarps; e += kSortThreads) (&sm.u.tile.cnt[0][0])[e] = 0;
  __syncthreads();
  auto entry = [&](int i) {  // pass 0's list
    return select ? la[i] : make_uint2(wq[i], static_cast<unsigned>(i));
  };
  for (int i0 = 0; i0 < k; i0 += kSortThreads) {
    const int i = i0 + tid;
    const bool valid = i < k;
    const uint32_t key = valid ? ~entry(i).x : 0u;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int d = valid ? static_cast<int>((key >> (8 * p)) & 255u) : 256;
      const unsigned peers = __match_any_sync(kFull, d);
      if (valid && lane == __ffs(peers) - 1) atomicAdd(&sm.base[p][d], __popc(peers));
    }
  }
  __syncthreads();
  if (warp < 4) {  // each digit's first place: an exclusive scan of its histogram
    unsigned v[8], s = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = sm.base[warp][8 * lane + j];
      s += v[j];
    }
    unsigned incl = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    unsigned run = incl - s;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sm.base[warp][8 * lane + j] = run;
      run += v[j];
    }
  }
  __syncthreads();
  for (int p = 0; p < 4; ++p) {
    const uint2* const src = p == 1 || p == 3 ? lb : la;
    uint2* const dst = p == 0 || p == 2 ? lb : la;
    if (tid < 256) sm.run[tid] = sm.base[p][tid];
    __syncthreads();
    for (int i0 = 0; i0 < k; i0 += kSortThreads) {
      const int i = i0 + tid;
      const bool valid = i < k;
      uint2 en = make_uint2(0u, 0u);
      if (valid) en = p == 0 ? entry(i) : src[i];
      const int d = valid ? static_cast<int>(((~en.x) >> (8 * p)) & 255u) : 256;
      const unsigned peers = __match_any_sync(kFull, d);
      const unsigned rank = __popc(peers & lt);
      if (valid && lane == __ffs(peers) - 1) sm.u.tile.cnt[d][warp] = __popc(peers);
      __syncthreads();
      // warp w: digits 8 w .. 8 w + 7, a scan over the 32 warps' counts each
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int dd = 8 * warp + j;
        const unsigned c = sm.u.tile.cnt[dd][lane];
        sm.u.tile.cnt[dd][lane] = 0;
        unsigned incl = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const unsigned o = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += o;
        }
        sm.u.tile.off[dd][lane] = static_cast<unsigned short>(incl - c);
        if (lane == 31) {
          sm.prev[dd] = sm.run[dd];
          sm.run[dd] += incl;
        }
      }
      __syncthreads();
      if (valid) {
        const unsigned at = sm.prev[d] + sm.u.tile.off[d][warp] + rank;
        if (p < 3) {
          dst[at] = en;
        } else {
          const float score = word_score(en.x);
          out_v[static_cast<size_t>(blockIdx.x) * k + at] = score;
          out_i[static_cast<size_t>(blockIdx.x) * k + at] =
              score == -CUDART_INF_F ? 0 : static_cast<int>(en.y);
        }
      }
      __syncthreads();
    }
  }
}

// The full ranking (k = N): a stable LSD radix sort over many blocks a
// query, since one block a query leaves most of the card idle at small Q.
// Each of its four passes (8 bits of ~word each, so ascending order is the
// scores' descending order) counts the digits of chunks of kChunk entries
// (rank_counts), turns the (digit, chunk) counts of a query into first
// places in that order (rank_offsets), and places each chunk's entries
// stably, tile by tile (rank_scatter). Pass 0 reads the words (a word's row
// is its place), the last one writes (value, row).
constexpr int kChunk = 4 * kSortThreads;  // entries a block takes in a pass

__device__ __forceinline__ int digit_of(uint32_t w, int p) {
  return static_cast<int>(((~w) >> (8 * p)) & 255u);
}

// counts[(q * 256 + d) * n_chunks + c]: pass p's digit d in chunk c of query q
__global__ void __launch_bounds__(kSortThreads) rank_counts(
    const uint32_t* __restrict__ words, const uint2* __restrict__ src, int n_rows, int n_chunks,
    int p, unsigned* __restrict__ counts) {
  __shared__ unsigned hist[256];
  const int q = blockIdx.x / n_chunks, c = blockIdx.x - q * n_chunks;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 256) hist[tid] = 0;
  __syncthreads();
  const size_t base = static_cast<size_t>(q) * n_rows;
#pragma unroll
  for (int u = 0; u < kChunk / kSortThreads; ++u) {
    const int i = c * kChunk + u * kSortThreads + tid;
    int d = 256;
    if (i < n_rows) d = digit_of(p == 0 ? words[base + i] : src[base + i].x, p);
    const unsigned peers = __match_any_sync(kFull, d);
    if (d < 256 && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
  }
  __syncthreads();
  if (tid < 256) counts[(static_cast<size_t>(q) * 256 + tid) * n_chunks + c] = hist[tid];
}

// One block per query: counts -> exclusive prefix over (digit, chunk), in place.
__global__ void __launch_bounds__(kSortThreads) rank_offsets(unsigned* __restrict__ counts,
                                                             int n_chunks) {
  __shared__ unsigned part[33];
  unsigned* const cq = counts + static_cast<size_t>(blockIdx.x) * 256 * n_chunks;
  const int total = 256 * n_chunks, per = (total + kSortThreads - 1) / kSortThreads;
  const int lo = threadIdx.x * per, hi = min(total, lo + per);
  unsigned local = 0;
  for (int i = lo; i < hi; ++i) local += cq[i];
  unsigned run = block_inclusive(local, part) - local;
  for (int i = lo; i < hi; ++i) {
    const unsigned v = cq[i];
    cq[i] = run;
    run += v;
  }
}

// Chunk c of query q placed stably: each entry at its (digit, chunk)'s first
// place plus its rank among the chunk's entries of that digit.
__global__ void __launch_bounds__(kSortThreads) rank_scatter(
    const uint32_t* __restrict__ words, const uint2* __restrict__ src, uint2* __restrict__ dst,
    float* __restrict__ out_v, int* __restrict__ out_i, const unsigned* __restrict__ offsets,
    int n_rows, int n_chunks, int p) {
  __shared__ unsigned short cnt[256][kSortWarps];
  __shared__ unsigned short off[256][kSortWarps];
  __shared__ unsigned run[256], prev[256];
  const int q = blockIdx.x / n_chunks, c = blockIdx.x - q * n_chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const size_t base = static_cast<size_t>(q) * n_rows;
  if (tid < 256) {
    run[tid] = offsets[(static_cast<size_t>(q) * 256 + tid) * n_chunks + c];
    for (int w = 0; w < kSortWarps; ++w) cnt[tid][w] = 0;
  }
  __syncthreads();
  for (int u = 0; u < kChunk / kSortThreads; ++u) {
    const int i = c * kChunk + u * kSortThreads + tid;
    const bool valid = i < n_rows;
    uint2 en = make_uint2(0u, 0u);
    if (valid) en = p == 0 ? make_uint2(words[base + i], static_cast<unsigned>(i)) : src[base + i];
    const int d = valid ? digit_of(en.x, p) : 256;
    const unsigned peers = __match_any_sync(kFull, d);
    const unsigned rank = __popc(peers & lt);
    if (valid && lane == __ffs(peers) - 1) cnt[d][warp] = __popc(peers);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // warp w: digits 8 w .. 8 w + 7 over the 32 warps
      const int dd = 8 * warp + j;
      const unsigned cw = cnt[dd][lane];
      cnt[dd][lane] = 0;
      unsigned incl = cw;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      off[dd][lane] = static_cast<unsigned short>(incl - cw);
      if (lane == 31) {
        prev[dd] = run[dd];
        run[dd] += incl;
      }
    }
    __syncthreads();
    if (valid) {
      const size_t at = base + prev[d] + off[d][warp] + rank;
      if (p < 3) {
        dst[at] = en;
      } else {
        const float score = word_score(en.x);
        out_v[at] = score;
        out_i[at] = score == -CUDART_INF_F ? 0 : static_cast<int>(en.y);
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* g, const float* bias, int n_queries, int n_rows,
                   int depth, int k, int n_sms, void* scratch, uint32_t* words, uint2* lists,
                   float* out_v, int* out_i, cudaStream_t stream) {
  const Plan p = make_plan<T>(n_queries, n_rows, depth, k, n_sms, true);
  ScoreArgs args{};
  args.bias = bias;
  args.n_queries = n_queries;
  args.n_rows = n_rows;
  args.depth = depth;
  args.k = k;
  args.words = words;
  cudaError_t err = launch_scores<T, true>(q, g, p, args, scratch, stream);
  if (err != cudaSuccess) return err;
  if (k < n_rows) {
    select_sort<<<n_queries, kSortThreads, 0, stream>>>(words, n_rows, k, lists, out_v, out_i);
    return cudaGetLastError();
  }
  // the full ranking: lists holds two (n_queries, n_rows) lists, then the counts
  const int n_chunks = (n_rows + kChunk - 1) / kChunk;
  uint2* const la = lists;
  uint2* const lb = lists + static_cast<size_t>(n_queries) * n_rows;
  unsigned* const counts = reinterpret_cast<unsigned*>(lb + static_cast<size_t>(n_queries) * n_rows);
  for (int pass = 0; pass < 4; ++pass) {
    const uint2* const src = pass == 1 || pass == 3 ? lb : la;
    uint2* const dst = pass == 0 || pass == 2 ? lb : la;
    rank_counts<<<n_queries * n_chunks, kSortThreads, 0, stream>>>(words, src, n_rows, n_chunks,
                                                                    pass, counts);
    rank_offsets<<<n_queries, kSortThreads, 0, stream>>>(counts, n_chunks);
    rank_scatter<<<n_queries * n_chunks, kSortThreads, 0, stream>>>(
        words, src, dst, out_v, out_i, counts, n_rows, n_chunks, pass);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point bound with ctypes; returns a cudaError_t code. q (n_queries,
// depth) and g (n_rows, depth) contiguous, of one dtype (0 = float32,
// 1 = bfloat16); bias (n_rows,) float32; scratch as xmir_topk's; words
// n_queries x n_rows 32-bit words; lists n_queries x 2 k pairs of 32-bit
// words, and at k = n_rows also 256 x ceil(n_rows / 4096) 32-bit counts a
// query after them; out_v, out_i (n_queries, k).
extern "C" int xmir_topk_select(const void* q, const void* g, const float* bias, int dtype,
                                int n_queries, int n_rows, int depth, int k, int n_sms, void* scratch,
                                void* words, void* lists, float* out_v, int* out_i,
                                void* stream) {
  if (n_queries < 1 || n_rows < 1 || depth < 1 || k < 1 || k > n_rows || n_sms < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* const w = static_cast<uint32_t*>(words);
  uint2* const l = static_cast<uint2*>(lists);
  if (dtype == 0) {
    return (int)launch<float>(q, g, bias, n_queries, n_rows, depth, k, n_sms, scratch, w, l, out_v,
                              out_i, s);
  }
  if (dtype == 1) {
    return (int)launch<__nv_bfloat16>(q, g, bias, n_queries, n_rows, depth, k, n_sms, scratch, w, l,
                                      out_v, out_i, s);
  }
  return (int)cudaErrorInvalidValue;
}
