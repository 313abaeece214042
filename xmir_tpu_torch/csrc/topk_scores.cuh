// The score producer of K1 (topk.cu) and K1' (topk_select.cu) for Hopper
// (sm_90a): q . g^T of a block of queries against a range of gallery rows,
// one gallery tile at a time, on the tensor cores, with an epilogue that
// either selects from the accumulator registers (K1) or writes each score as
// an ordered 32-bit word (K1'). Both kernels run the same instructions in the
// same depth order, so their scores are equal bit for bit.
//
// Arithmetic. bf16: wgmma m64n256k16 with f32 accumulators. f32: 3xTF32 on
// wgmma m64n128k8. A TF32 product reads an f32 operand's sign, exponent and
// top 10 mantissa bits, so big = x with its 13 low bits cleared is what the
// product reads of x itself; small = cvt.rna.tf32(x - big) (x - big is exact
// in f32, below 2^-10 |x|). The three products big.big + big.small +
// small.big of eight stages (128 of D) go into one accumulator on the
// tensor cores, and these group sums are added in order in f32 (below); the
// dropped small.small and the rounding of small are below 2^-20 of
// |q_d g_d|. Rounding big to nearest as well would halve that at the price
// of rewriting every stage in place; the tensor cores' own sums round
// coarser either way (topk_kernels.py). The gallery rows are split in shared
// memory, on each stage as it lands, so the index stores its f32 rows as
// they are; the queries once a call. Depth is walked in ascending order, 32
// bytes a product step (16 bf16 or 8 f32 columns).
//
// Tiles. A block owns 64 or 128 queries (one or two consumer warpgroups, 64
// query rows each, wgmma's M) and one contiguous range of gallery rows (a
// split), walked in tiles of kNT rows (wgmma's N: 256 in bf16, 128 in f32).
// Each tile's depth streams through a ring of stages by the copy engine
// (TMA): a stage holds 64-byte rows (32 bf16 / 16 f32 columns) of the
// block's queries and of the tile's gallery rows, 64-byte swizzled, and in
// f32 also their small parts (the queries' split once a call by small_rows;
// three warps of the producer warpgroup write the gallery rows' once a stage
// lands, while the consumers multiply the stages before). The
// queries ride in every stage: a query row is re-read from L2 once per
// gallery tile, (64 or 128 queries) x D per kNT gallery rows.
//
// Traffic (the serving shape, Q = 1024, N = 100,000, D = 1024). The plan
// runs all blocks in one wave, the query blocks of one split side by side,
// so they walk the same gallery rows in step and device memory serves the
// gallery about once (205 MB bf16, 410 MB f32) while L2 serves it once per
// query block: 8 blocks of 128 queries, 1.6 GB bf16 / 3.3 GB f32, plus the
// queries' re-reads (0.8 GB bf16: a stage holds 128 query rows beside 256
// gallery rows in bf16, 128 in f32). The query tile does not stay resident:
// 128 x 1024 bf16 rows are 256 KB, and 64 rows (128 KB) would leave too
// little room for the ring and the k-entry buffers.
//
// Turns. The two consumer warpgroups read every stage (their queries differ,
// the gallery tile is the same), so neither can run a whole tile's products
// ahead of the other without the ring holding the tile's whole depth (32
// stages of 24 KB at D = 1024 in bf16): they multiply side by side, and their
// epilogues overlap the producer's loads of the next tile's stages.

#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "wgmma.cuh"

namespace {

constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90
constexpr int kPanelBytes = 64;     // a stage row: 32 bf16 or 16 f32 columns
constexpr int kMaxStages = 8;
constexpr int kMaxSplits = 160;     // the merge holds five split heads a lane
// K1's fused body up to here; above it the select route, which is faster
// there at the serving shape (PERF.md: each insert into a sorted k-entry
// buffer costs O(k), and a query takes O(k log(rows / k)) of them)
constexpr int kFusedMaxK = 32;
constexpr int kStash = 8;           // a consumer thread's candidates a round (fused route)
constexpr int kSplitThreads = 96;   // f32: the producer warpgroup's warps 1 .. 3 split stages
constexpr unsigned kFull = 0xffffffffu;

enum Route { kRouteFused = 0, kRouteSelect = 1 };

template <typename T>
struct Arith;
template <>
struct Arith<__nv_bfloat16> {
  static constexpr int kNT = 256;    // gallery rows a tile
  static constexpr int kSize = 2;
  static constexpr bool kSplit = false;
};
template <>
struct Arith<float> {
  static constexpr int kNT = 128;
  static constexpr int kSize = 4;
  static constexpr bool kSplit = true;  // 3xTF32: a small part beside each stage
};

struct Plan {
  int route;           // kRouteFused (k <= 32) or kRouteSelect (scores as words, then a select)
  int wgs;             // consumer warpgroups a block: 2 (128 queries) or 1 (64)
  int q_blocks;        // blocks along the queries
  int n_splits;        // gallery splits, none of them empty
  int rows_per_split;  // a multiple of the tile
  int tile_rows;       // kNT
  int stages;          // ring stages
  int depth;           // D, or D padded for the copy engine (a row of a multiple of 16 bytes)
  int smem;            // dynamic shared memory of the score kernel
};

__host__ __device__ constexpr int stage_bytes(int wgs, int nt, bool split) {
  return (64 * wgs + nt) * kPanelBytes * (split ? 2 : 1);
}

// The launch plan, for n_queries, n_rows, k >= 1: K1's route by k (keys:
// K1''s, always the select route). One block per SM (the ring and buffers
// take most of shared memory), one wave: the splits fill the SMs that the
// query blocks leave, up to kMaxSplits and one tile a split.
template <typename T>
Plan make_plan(int n_queries, int n_rows, int depth, int k, int n_sms, bool keys) {
  using A = Arith<T>;
  Plan p{};
  const bool fused = !keys && k <= kFusedMaxK;
  p.route = fused ? kRouteFused : kRouteSelect;
  p.wgs = n_queries <= 64 ? 1 : 2;
  p.q_blocks = (n_queries + 64 * p.wgs - 1) / (64 * p.wgs);
  p.tile_rows = A::kNT;
  const int tiles = (n_rows + A::kNT - 1) / A::kNT;
  const int splits = std::max(1, std::min({kMaxSplits, tiles, n_sms / p.q_blocks}));
  p.rows_per_split = (tiles + splits - 1) / splits * A::kNT;
  p.n_splits = (n_rows + p.rows_per_split - 1) / p.rows_per_split;
  const int align = 16 / A::kSize;
  p.depth = (depth + align - 1) / align * align;
  // the fused route's k-entry buffers of its queries and its threads' stashes
  const int buffers = fused ? 64 * p.wgs * k * 8 + 128 * p.wgs * kStash * 8 : 0;
  const int fixed = 1024 + 3 * kMaxStages * 8 + buffers;
  p.stages = std::min(kMaxStages, (kSmemLimit - fixed) / stage_bytes(p.wgs, A::kNT, A::kSplit));
  p.smem = fixed + p.stages * stage_bytes(p.wgs, A::kNT, A::kSplit);
  return p;
}

// score -> a word whose unsigned order is the scores' order; -0 counts as +0,
// so equal scores tie
__device__ __forceinline__ uint32_t score_word(float score) {
  const uint32_t u = __float_as_uint(__fadd_rn(score, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float word_score(uint32_t w) {
  return __uint_as_float((w & 0x80000000u) ? (w & 0x7fffffffu) : ~w);
}

struct ScoreArgs {
  const float* bias;
  int n_queries, n_rows, depth, k, q_blocks, rows_per_split, n_splits, stages;
  float* part_v;    // fused: (n_queries, n_splits, k)
  int* part_i;
  uint32_t* words;  // select route: (n_queries, n_rows)
};

// The epilogue of one tile, given its accumulators: a thread holds query
// rows r + 8 h (h = 0, 1; r = 16 warp + lane / 4 of its warpgroup's 64) and
// gallery columns 8 j + 2 (lane % 4) + e of the tile, in acc[4 j + 2 h + e].
// init runs in each consumer warp and touches only its warp's queries.
template <typename T, int WGS, bool kKeys>
struct Epilogue;

// A block's shared memory and its walk: its queries, its gallery split and
// the sequence of (tile, depth chunk) stages. Worked out again in each role
// after its register move: a value live across setmaxnreg would live in
// local memory, each use a load.
template <typename T, int WGS>
struct Walk {
  static constexpr int kNT = Arith<T>::kNT;
  static constexpr int kStage = stage_bytes(WGS, kNT, Arith<T>::kSplit);
  unsigned char* smem;
  uint64_t *full, *ready, *empty;  // ready: f32, the stage's small parts are written
  unsigned char* extra;            // the fused route's buffers and stashes
  int stages, q0, split, row_begin, row_end, n_tiles, chunks, total;

  __device__ Walk(unsigned char* raw, const ScoreArgs& a) {
    smem = align_1024(raw);
    stages = a.stages;
    full = reinterpret_cast<uint64_t*>(smem + stages * kStage);
    ready = full + kMaxStages;
    empty = ready + kMaxStages;
    extra = smem + stages * kStage + 3 * kMaxStages * 8;
    split = blockIdx.x / a.q_blocks;
    q0 = (blockIdx.x - split * a.q_blocks) * 64 * WGS;
    row_begin = split * a.rows_per_split;
    row_end = min(a.n_rows, row_begin + a.rows_per_split);
    n_tiles = (row_end - row_begin + kNT - 1) / kNT;
    chunks = (a.depth * Arith<T>::kSize + kPanelBytes - 1) / kPanelBytes;
    total = n_tiles * chunks;
  }
};

// The block: warpgroups 0 .. WGS - 1 consume, warpgroup WGS produces. The
// producer's thread 0 issues the copies as far ahead as the ring allows; in
// f32 its warps 1 .. 3 write each landed stage's small parts.
template <typename T, int WGS, bool kKeys>
__global__ void __launch_bounds__(128 * (WGS + 1), 1) score_tiles(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap qs_map,
    const __grid_constant__ CUtensorMap g_map, const ScoreArgs args) {
  using A = Arith<T>;
  constexpr int NT = A::kNT, RQ = 64 * WGS, ACC = NT / 2;
  constexpr int kStage = Walk<T, WGS>::kStage;
  constexpr int kHalf = (RQ + NT) * kPanelBytes;  // the small parts' offset in a stage
  extern __shared__ unsigned char smem_raw[];
  const int tid = threadIdx.x;

  if (tid == 0) {
    const Walk<T, WGS> w(smem_raw, args);
    for (int st = 0; st < w.stages; ++st) {
      mbar_init(w.full + st, 1);                // the copying thread, once the copies land
      mbar_init(w.ready + st, kSplitThreads);   // every splitting thread, once its share is split
      mbar_init(w.empty + st, 4 * WGS);         // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * WGS) {  // the producer
    if constexpr (WGS == 2) regs_shrink<A::kSplit ? 72 : 40>();
    const Walk<T, WGS> w(smem_raw, args);
    unsigned char* const smem = w.smem;
    uint64_t* const full = w.full;
    uint64_t* const ready = w.ready;
    uint64_t* const empty = w.empty;
    const int stages = w.stages, chunks = w.chunks, total = w.total;
    const int q0 = w.q0, row_begin = w.row_begin;
    const int ptid = tid - 128 * WGS;
    auto issue = [&](int it) {
      const int st = it % stages;
      mbar_wait(empty + st, ((it / stages) & 1) ^ 1);
      unsigned char* const dst = smem + st * kStage;
      const int tile = it / chunks, c = it - tile * chunks;
      const int col = c * (kPanelBytes / A::kSize);
      mbar_arrive_expect_tx(full + st, ((A::kSplit ? 2 : 1) * RQ + NT) * kPanelBytes);
      tma_load(dst, &q_map, col, q0, 0, full + st);
      if constexpr (A::kSplit) tma_load(dst + kHalf, &qs_map, col, q0, 0, full + st);
      tma_load(dst + RQ * kPanelBytes, &g_map, col, row_begin + tile * NT, 0, full + st);
    };
    if (ptid == 0) {  // the copies, as far ahead as the ring allows
      for (int it = 0; it < total; ++it) issue(it);
    }
    if constexpr (A::kSplit) {
      // warps 1 .. 3 of the warpgroup write the small parts of each landed
      // stage's gallery rows kHalf bytes on (the queries' small parts come
      // split by small_rows); every load of a thread's share first, then the
      // arithmetic and the stores
      if (ptid >= 32) {
        constexpr int kVecs = kHalf / 16, kFirst = RQ * kPanelBytes / 16;
        constexpr int kIters = (kVecs - kFirst + kSplitThreads - 1) / kSplitThreads;
        const int sid = ptid - 32;
        for (int it = 0; it < total; ++it) {
          const int st = it % stages;
          mbar_wait(full + st, (it / stages) & 1);
          float4* const raw = reinterpret_cast<float4*>(smem + st * kStage);
#pragma unroll
          for (int u0 = 0; u0 < kIters; u0 += 4) {
            float4 x[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int v = kFirst + sid + (u0 + u) * kSplitThreads;
              if (u0 + u < kIters && v < kVecs) x[u] = raw[v];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int v = kFirst + sid + (u0 + u) * kSplitThreads;
              if (u0 + u < kIters && v < kVecs) {
                raw[v + kVecs] = make_float4(tf32_small(x[u].x), tf32_small(x[u].y),
                                             tf32_small(x[u].z), tf32_small(x[u].w));
              }
            }
          }
          fence_async_smem();  // the writes, to the products' proxy
          mbar_arrive(ready + st);
        }
      }
    }
    return;
  }

  if constexpr (WGS == 2) regs_grow<A::kSplit ? 216 : 232>();
  const Walk<T, WGS> w(smem_raw, args);
  unsigned char* const smem = w.smem;
  uint64_t* const full = w.full;
  uint64_t* const ready = w.ready;
  uint64_t* const empty = w.empty;
  const int stages = w.stages, chunks = w.chunks, n_tiles = w.n_tiles;
  const int q0 = w.q0, row_begin = w.row_begin, row_end = w.row_end, split = w.split;
  const int lane = tid & 31, wg = tid >> 7;
  Epilogue<T, WGS, kKeys> epi;
  epi.init(w.extra, args, q0);
  float acc[ACC];
  // f32: the depth summed in groups of kGroup stages on the tensor cores, the
  // groups added in order into `total` by IEEE f32 adds. The tensor cores
  // round their f32 sums coarser than IEEE, and with one accumulator over
  // all of D that rounding adds up where every product has one sign (near-
  // collinear rows: 1.8e-5 at D = 1024 against the plain version's 1e-5
  // agreement); a group's partial sum is an eighth of the score's at D =
  // 1024, and so is its rounding. Each group ends in a drain of the
  // products, so groups are no shorter than they need to be. bf16 keeps one
  // accumulator (its agreement is 1e-2).
  constexpr int kGroup = A::kSplit ? 8 : 1 << 30;
  float total[A::kSplit ? ACC : 1];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  int it = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    for (int c = 0; c < chunks; ++c, ++it) {
      const int st = it % stages;
      mbar_wait((A::kSplit ? ready : full) + st, (it / stages) & 1);
      const uint32_t a_tile = smem_addr(smem + st * kStage);
      const uint32_t b_tile = a_tile + RQ * kPanelBytes;
      const bool group_first = c % kGroup == 0;
      const bool group_last = c % kGroup == kGroup - 1 || c == chunks - 1;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {  // two 32-byte product steps a stage
        const uint64_t da = desc_k_major<32>(a_tile, RQ, 64 * wg, 16 * kk);
        const uint64_t db = desc_k_major<32>(b_tile, NT, 0, 16 * kk);
        const int keep = !group_first || kk > 0;
        if constexpr (A::kSplit) {
          const uint64_t da_s = desc_k_major<32>(a_tile + kHalf, RQ, 64 * wg, 16 * kk);
          const uint64_t db_s = desc_k_major<32>(b_tile + kHalf, NT, 0, 16 * kk);
          WgmmaTf32x128::ss(acc, da, db, keep);    // big . big
          WgmmaTf32x128::ss(acc, da, db_s, 1);     // big . small
          WgmmaTf32x128::ss(acc, da_s, db, 1);     // small . big
        } else {
          Wgmma<256>::template ss<0, 0>(acc, da, db, keep);
        }
      }
      wgmma_commit();
      // free each stage once its products are done: the one before at a
      // group's later stages, this one at a group's end
      if (group_last) {
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) {
          if (!group_first) mbar_arrive(empty + (it - 1) % stages);
          mbar_arrive(empty + st);
        }
        if constexpr (A::kSplit) {
#pragma unroll
          for (int i = 0; i < ACC; ++i) total[i] = c < kGroup ? acc[i] : total[i] + acc[i];
        }
      } else if (!group_first) {
        wgmma_wait<1>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (it - 1) % stages);
      }
    }
    if constexpr (A::kSplit) {
      epi.tile(total, args, q0, row_begin + tile * NT, row_end);
    } else {
      epi.tile(acc, args, q0, row_begin + tile * NT, row_end);
    }
  }
  epi.finish(args, q0, split);
}

// Pads rows of `depth` elements to `padded` with zeros, for a row stride the
// copy engine can take: (rows, depth) -> (rows, padded), one element a thread.
template <typename T>
__global__ void pad_rows(const T* __restrict__ src, T* __restrict__ dst, int rows, int depth,
                         int padded) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<size_t>(rows) * padded) return;
  const int r = static_cast<int>(i / padded), d = static_cast<int>(i - static_cast<size_t>(r) * padded);
  dst[i] = d < depth ? src[static_cast<size_t>(r) * depth + d] : T(0.f);
}

// f32: the queries' small parts under 3xTF32, once a call (n elements).
__global__ void small_rows(const float* __restrict__ src, float* __restrict__ dst, size_t n) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = tf32_small(src[i]);
}

// Launches score_tiles over the plan's grid: (rows, depth) tensor maps of q
// and g in 64-byte panels, boxes of the block's queries and of one tile.
// scratch: q and g with padded rows where the plan pads D, then (f32) the
// queries' small parts (ops/topk_kernels.py::_scratch sizes it). Returns a
// cudaError_t.
template <typename T, bool kKeys>
cudaError_t launch_scores(const void* q, const void* g, const Plan& p, ScoreArgs args,
                          void* scratch, cudaStream_t stream) {
  using A = Arith<T>;
  unsigned char* free_at = static_cast<unsigned char*>(scratch);
  if (p.depth != args.depth) {  // a row stride the copy engine cannot take
    T* const qp = reinterpret_cast<T*>(free_at);
    T* const gp = qp + static_cast<size_t>(args.n_queries) * p.depth;
    const size_t nq = static_cast<size_t>(args.n_queries) * p.depth;
    const size_t ng = static_cast<size_t>(args.n_rows) * p.depth;
    pad_rows<T><<<static_cast<unsigned>((nq + 255) / 256), 256, 0, stream>>>(
        static_cast<const T*>(q), qp, args.n_queries, args.depth, p.depth);
    pad_rows<T><<<static_cast<unsigned>((ng + 255) / 256), 256, 0, stream>>>(
        static_cast<const T*>(g), gp, args.n_rows, args.depth, p.depth);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    q = qp;
    g = gp;
    args.depth = p.depth;
    free_at += static_cast<size_t>(args.n_queries + args.n_rows) * p.depth * sizeof(T);
  }
  const void* q_small = q;  // bf16: no split, the map unused
  if constexpr (A::kSplit) {
    const size_t n = static_cast<size_t>(args.n_queries) * args.depth;
    small_rows<<<static_cast<unsigned>((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const float*>(q), reinterpret_cast<float*>(free_at), n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    q_small = free_at;
  }
  const CUtensorMapDataType type =
      A::kSize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int cols = kPanelBytes / A::kSize;
  const uint64_t pitch = static_cast<uint64_t>(args.depth) * A::kSize;
  CUtensorMap q_map, qs_map, g_map;
  if (make_tensor_map(&q_map, type, q, args.depth, args.n_queries, 1, pitch,
                      pitch * args.n_queries, cols, 64 * p.wgs, CU_TENSOR_MAP_SWIZZLE_64B) != 0 ||
      make_tensor_map(&qs_map, type, q_small, args.depth, args.n_queries, 1, pitch,
                      pitch * args.n_queries, cols, 64 * p.wgs, CU_TENSOR_MAP_SWIZZLE_64B) != 0 ||
      make_tensor_map(&g_map, type, g, args.depth, args.n_rows, 1, pitch, pitch * args.n_rows,
                      cols, A::kNT, CU_TENSOR_MAP_SWIZZLE_64B) != 0) {
    return cudaErrorInvalidValue;
  }
  args.stages = p.stages;
  args.q_blocks = p.q_blocks;
  args.rows_per_split = p.rows_per_split;
  args.n_splits = p.n_splits;
  const dim3 grid(p.q_blocks * p.n_splits);
  cudaError_t err;
  if (p.wgs == 2) {
    err = cudaFuncSetAttribute(score_tiles<T, 2, kKeys>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    score_tiles<T, 2, kKeys><<<grid, 384, p.smem, stream>>>(q_map, qs_map, g_map, args);
  } else {
    err = cudaFuncSetAttribute(score_tiles<T, 1, kKeys>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    score_tiles<T, 1, kKeys><<<grid, 256, p.smem, stream>>>(q_map, qs_map, g_map, args);
  }
  return cudaGetLastError();
}

}  // namespace
