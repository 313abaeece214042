// Backward of the fused attention for the plain ViT towers on Hopper
// (sm_90a): dq, dk, dv of out = softmax(q k^T scale) v per (batch, head) from
// q, k, v, the saved output o, the cotangent g and the forward's row
// statistics, all (BH, N, hd).
//
// Replaces xmir_tpu/ops/vit_attn_pallas.py::_attention_bwd_pallas (K3, body
// _bwd_kernel). With p = softmax(scale q k^T), dp = g v^T and
// c = rowsum(p . dp) = rowsum(g . o):
//   dv = p^T g,  ds = p (dp - c),  dq = scale ds k,  dk = scale ds^T q.
// The TPU kernel keeps a head's whole K and V in VMEM, recomputes each row's
// max and sum from the full score row, and adds dk and dv up in f32 VMEM
// across a query-tile grid axis that runs in sequence. None of that carries
// over: a head's K, V and two f32 accumulators at N = 1370, hd = 64 are over
// 1 MB against 227 KB of shared memory a block, a block that streams tiles
// never sees a full score row, and blocks run in no order.
//
// Common to both dtypes: the forward (vit_attn.cu) hands over, per query row,
// the integer-valued shift m it used and the sum z of e = exp2(s - m), so no
// kernel needs a pass for the max and e is the forward's e; nothing is added
// up with atomics, and two runs are bit-equal. The (N, N) tiles never reach
// device memory.
//
// bf16, the main path (the DINOv2 train step's 12 calls). What bounds it on
// this card: 10 BH N^2 hd operations (five products) against eight (BH, N, hd)
// tensors moved once, so the tensor cores' rate: 0.233 ms at B = 16, N =
// 1370, hd = 64. The design, four launches:
//   bwd_prep_bf16  per row qs = q c, qz = q (scale / z), gz = g / z (bf16) and
//                  (m, c = rowsum(g . o)): every tile the main kernel streams
//                  is then a plain copy, and the rounding is as before;
//   bwd_bf16_wg    a persistent block per SM takes (head, 128-key) units in
//                  order: two consumer warpgroups hold 64 keys each, a
//                  producer warp streams the 64-row query tiles through a ring
//                  of three stages (two at hd 128) with the copy engine (TMA,
//                  a box per operand panel) and mbarriers. Per tile s^T and
//                  dp^T are formed once by wgmma (both operands from shared
//                  memory in the swizzled layouts of wgmma.cuh), e and t in
//                  registers, dv += e^T gz and dk += t^T qz by wgmma with e
//                  and t as A from registers, f32 accumulators in registers
//                  for the whole unit; t^T goes to shared memory and the
//                  unit's dq part t k (split by columns between the
//                  warpgroups, run under the next tile's s^T and dp^T) is
//                  staged in shared memory, where a dq warp per ring stage
//                  adds it to an f32 workspace in key-unit order by the copy
//                  engine's f32 reduction, each add waiting on a per-(head,
//                  query tile) counter that the unit before sets: 10 BH N^2 hd
//                  operations, the minimum. Units are taken in order and every
//                  block is resident, so a wait is for a unit that a running
//                  block holds or has done and cannot deadlock;
//   bwd_dq_finish  dq = (the sum) (scale / z), rounded once;
// plus a memset of the counters and of the (m, c) padding. Registers
// (-Xptxas -v, sm_90a): ptxas sizes the 384-thread block as three
// warpgroups of 168; the third (producer, dq warps) gives its registers up
// (setmaxnreg 40) and the consumers take 232, without spills at hd 16, 32,
// 64; hd 80 and 128 spill (their accumulators are larger). Shared memory
// 163 KB at hd 64 (K and V of the unit 32 KB, the ring 96 KB, t^T 32 KB).
// What bounds it now: not one part. At B = 16 the prep and finish passes
// are 0.11 ms of memory traffic; in the main kernel the products and the
// per-tile work around them (exponentials, t^T and dq staging, the
// warpgroups' barrier, the ordered adds) each cost a share, the warpgroups
// run in step so that their tensor and ALU work do not overlap (PERF.md).

// f32 (only under XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1 f32 training), three
// kernels that each own their output: rowdot (c, one warp a row); dq (one
// block per (head, 64-query tile) streams the 64-key tiles of K and V past
// it); dk, dv (one block per (head, 64-key tile) streams the 64-query tiles
// and keeps dk and dv in f32 registers). Scores and dp are computed twice
// (14 BH N^2 hd operations); IEEE f32 FMAs (no TF32), 256 threads with a 4 x
// 4 score block each.
//
// Rounding points, the TPU kernel's (:659-677) with the forward's shift in
// place of the row max: qs = q times scale log2(e) (a constant already
// rounded to q's dtype) in q's dtype; s and dp in f32; e = exp2(s - m);
// t = e (dp - c) rounded to q's dtype before both of its products; e rounded
// to q's dtype for dv; 1 / z never touches a score tile but is folded into
// the small operands: dq = (t k) (scale / z) in f32, then one rounding;
// qz = q (scale / z) and gz = g / z rounded to the input dtype; dk = t^T qz
// and dv = e^T gz summed in f32 and rounded once at the end. The plain
// PyTorch version (ops/vit_attn.py::attention_bwd_plain) writes the same out.
//
// Ragged N: dead key rows get e = 0, dead query rows are zero-filled in
// shared memory (so they add nothing to dk and dv) and are not stored. hd is
// any multiple of 8 up to 128, zero-padded in shared memory to the next
// instantiated width (16, 32, 64, 80, 128). Launches go on the caller's
// stream and allocate nothing: the wrapper hands over the scratch.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile

__device__ __forceinline__ float to_f32(float v) { return v; }

// c[row] = sum_d g[row][d] o[row][d] in f32, one warp a row.
template <typename T>
__global__ void __launch_bounds__(256) rowdot(const T* __restrict__ g, const T* __restrict__ o,
                                              float* __restrict__ c, long long rows, int hd) {
  const long long row = static_cast<long long>(blockIdx.x) * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const T* gr = g + row * hd;
  const T* orow = o + row * hd;
  float sum = 0.f;
  for (int d = lane; d < hd; d += 32) sum = fmaf(to_f32(gr[d]), to_f32(orow[d]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) c[row] = sum;
}

// Eight bf16 values times f, each product rounded once to bf16.
__device__ __forceinline__ uint4 scale8(uint4 raw, float f) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(p[i]);
    p[i] = __floats2bfloat162_rn(v.x * f, v.y * f);
  }
  return raw;
}

// ---------------------------------------------------------------------------
// bf16. Three kernels: bwd_prep_bf16 writes the operands the main kernel
// streams, bwd_bf16_wg does the five products, bwd_dq_finish scales and
// rounds dq.

// Per row: qs = q c, qz = q (scale / z), gz = g / z (each product rounded to
// bf16 once) and mc = (m, c = rowsum(g . o) in f32), a head's rows at stride
// n_pad (whole query tiles; the rows past n stay zero). L lanes a row (a
// power of two >= hd / 8), one 16-byte vector each.
template <int L>
__global__ void __launch_bounds__(256) bwd_prep_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ go,
    const __nv_bfloat16* __restrict__ o, const float2* __restrict__ stats,
    __nv_bfloat16* __restrict__ qs, __nv_bfloat16* __restrict__ qz, __nv_bfloat16* __restrict__ gz,
    float2* __restrict__ mc, long long rows, int n, int n_pad, int hd, float c, float scale) {
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / L;
  const int vc = (threadIdx.x & (L - 1)) * 8;
  const bool live = row < rows && vc < hd;
  const size_t off = live ? static_cast<size_t>(row) * hd + vc : 0;
  uint4 rq = make_uint4(0, 0, 0, 0), rg = rq, ro = rq;
  if (live) {
    rq = __ldg(reinterpret_cast<const uint4*>(q + off));
    rg = __ldg(reinterpret_cast<const uint4*>(go + off));
    ro = __ldg(reinterpret_cast<const uint4*>(o + off));
  }
  const __nv_bfloat162* pg = reinterpret_cast<const __nv_bfloat162*>(&rg);
  const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(&ro);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(pg[i]), b = __bfloat1622float2(po[i]);
    sum = fmaf(a.y, b.y, fmaf(a.x, b.x, sum));
  }
#pragma unroll
  for (int off2 = 1; off2 < L; off2 <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off2);
  if (row >= rows) return;
  const float2 st = __ldg(stats + row);
  if (live) {
    const float zinv = 1.0f / st.y;
    const uint4 rqz = scale8(rq, scale * zinv);
    *reinterpret_cast<uint4*>(qs + off) = scale8(rq, c);
    *reinterpret_cast<uint4*>(qz + off) = rqz;
    *reinterpret_cast<uint4*>(gz + off) = scale8(rg, zinv);
  }
  if (vc == 0) mc[row / n * n_pad + row % n] = make_float2(st.x, sum);
}

// One block per SM walks units of (head, 128 keys) in (head, key tile)
// order. Warpgroup w (warps 4 w .. 4 w + 3) owns keys 64 w .. 64 w + 63 of
// the unit; warp 8 streams the query tiles (qs, g, qz, gz by TMA, the rows'
// (m, c) by a bulk copy) through a ring of shared memory, each stage's
// landing counted in bytes on a full mbarrier. Per query tile each
// warpgroup forms s^T = k qs^T and dp^T = v g^T once (wgmma, both operands
// from shared memory), e and t in registers, dv += e^T gz and dk += t^T qz
// (wgmma with e, t as A from registers), and writes t^T to shared memory;
// the two warpgroups' t^T make the unit's dq part t k, of which warpgroup w
// computes the columns [n0_w, n0_w + N_w) into an f32 staging tile (the
// stage's qs and g tiles, read by then). Warp 9 + s adds the parts staged in
// ring stage s to the f32 workspace in key-unit order, off the warpgroups'
// path: it waits until the unit before has added its part of this query
// tile (a counter per (head, query tile)), adds the tile with the copy
// engine's f32 reduction (the first unit stores it), waits until that is
// done in device memory, and moves the counter on; the ring stage is free
// once the copy has read it. A wait is only ever for a unit of lower index,
// which a resident block holds or has done, so the order cannot deadlock,
// and two runs add in the same order.
constexpr int kUnitKeys = 128;
// two consumer warpgroups and a third whose warps 8 and 9 are the producer and
// the dq warp: a whole warpgroup, so that its registers can go to the others
constexpr int kBwdThreads = 12 * 32;

template <int DP>
struct BwdLayout {  // byte offsets in the block's 1024-aligned shared memory
  static constexpr int kStages = DP <= 80 ? 3 : 2;
  static constexpr int kTile = kBQ * DP * 2;          // one query tile of one operand
  static constexpr int kKV = kUnitKeys * DP * 2;      // the unit's K (or V)
  static constexpr int kK = 0, kV = kKV, kRing = 2 * kKV;  // stage s operand o: kRing + (4 s + o) kTile
  static constexpr int kT = kRing + 4 * kStages * kTile;   // t^T: [2 parities][2 warpgroups] 64 x 64
  static constexpr int kTBytes = kBK * kBQ * 2;
  static constexpr int kMc = kT + 4 * kTBytes;             // (m, c) of each stage's 64 rows
  static constexpr int kBars = kMc + kStages * kBQ * 8;
  static constexpr int kTotal = kBars + 3 * kStages * 8 + 1024;
};

// The columns of dq warpgroup w computes: whole panels, or half of a single
// panel (its rows are read from the middle).
template <int DP>
struct DqSplit {
  static constexpr int kP = Panels<DP>::kCount, kW = Panels<DP>::kWidth;
  static constexpr int kN0 = kP == 1 ? DP / 2 : kW * ((kP + 1) / 2);
  static constexpr int kN1 = DP - kN0;
};

// Warpgroup wg's dq part of one query tile: columns [n0, n0 + NW) of t k over
// the unit's 128 keys (t^T of both warpgroups from shared memory), issued
// asynchronously.
template <int DP, int NW>
__device__ __forceinline__ void dq_issue(float (&acc)[NW / 2], uint32_t t_pair, uint32_t k_tile,
                                         int n0) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kUnitKeys / 16; ++kk) {
    Wgmma<NW>::template ss<1, 1>(acc, make_desc(t_pair + kk * 16 * 128, 8192, 1024, 1),
                                 desc_mn_major<DP>(k_tile, kUnitKeys, 16 * kk, n0), kk);
  }
  wgmma_commit();
}

// Byte offset of dq element (r, c) in the f32 staging tile: boxes of 64 rows
// x 16 columns, each row 64 bytes with its 16-byte chunks swizzled by
// (r / 2) % 4, as the copy engine reads them (at most two lanes of a float2
// store meet in a bank).
__device__ __forceinline__ int staging_offset(int r, int c) {
  return (c >> 4) * (kBQ * 64) + r * 64 + ((((c & 15) >> 2) ^ ((r >> 1) & 3)) << 4) + (c & 3) * 4;
}

// The landed dq part into the staging tile that a dq warp adds to the sums,
// then handed over on `ready`.
template <int NW>
__device__ __forceinline__ void dq_hand_over(const float (&acc)[NW / 2], unsigned char* staging,
                                             uint64_t* ready, int n0, int wq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      *reinterpret_cast<float2*>(staging + staging_offset(16 * wq + g + 8 * h, n0 + 8 * j + 2 * t)) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  fence_async_smem();  // the copy engine reads the staging through the asynchronous proxy
  __syncwarp();
  if (lane == 0) mbar_arrive(ready);
}

// 2^x by the special-function unit (ex2.approx, 2 ulp; results below 2^-126
// flush to zero, which no bf16 operand or f32 sum of weights near 1 can see).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1) bwd_bf16_wg(
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __grid_constant__ CUtensorMap qs_map, const __grid_constant__ CUtensorMap g_map,
    const __grid_constant__ CUtensorMap qz_map, const __grid_constant__ CUtensorMap gz_map,
    const float2* __restrict__ mc, __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const __grid_constant__ CUtensorMap dq_map, int* __restrict__ counters, int bh, int n, int hd) {
  using L = BwdLayout<DP>;
  constexpr int VPR = DP / 8, kS = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* const empty = full + kS;
  uint64_t* const dq_ready = empty + kS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int units = (n + kUnitKeys - 1) / kUnitKeys, q_tiles = (n + kBQ - 1) / kBQ;
  const long long total = static_cast<long long>(bh) * units;

  if (tid == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(full + st, 1);      // the producer, once its copies land
      mbar_init(empty + st, 1);     // its dq warp, once its add has read the stage
      mbar_init(dq_ready + st, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the third warpgroup gives (168 - 40) x 128 registers to the consumers
    regs_shrink<40>();
    if (lane != 0 || warp - 9 >= kS) return;
    if (warp >= 9) {  // dq warp 9 + s: ring stage s's staged parts into the sums, in unit order
      const int stage = warp - 9;
      int it = 0;
      for (long long x = blockIdx.x; x < total; x += gridDim.x) {
        const int head = static_cast<int>(x / units), u = static_cast<int>(x % units);
        for (int i = 0; i < q_tiles; ++i, ++it) {
          if (it % kS != stage) continue;
          mbar_wait(dq_ready + stage, (it / kS) & 1);
          int* const cnt = counters + static_cast<size_t>(head) * q_tiles + i;
          const unsigned char* const src = smem + L::kRing + stage * 4 * L::kTile;
          while (ld_acquire_gpu(cnt) != u) {
          }
          fence_async_global();
          for (int c0 = 0; c0 < hd; c0 += 16) {  // a box of 16 columns; rows past N not written
            if (u == 0) {  // the first unit's part is the sum so far
              tma_store(&dq_map, c0, i * kBQ, head, src + c0 * (kBQ * 4));
            } else {
              tma_reduce_add(&dq_map, c0, i * kBQ, head, src + c0 * (kBQ * 4));
            }
          }
          bulk_commit();
          bulk_wait_read();
          mbar_arrive(empty + stage);
          bulk_wait();  // added in device memory: the next unit may add its part
          fence_async_global();
          __threadfence();
          st_release_gpu(cnt, u + 1);
        }
      }
      return;
    }
    // warp 8, the producer: every unit's query tiles, in the consumers' order
    using P = Panels<DP>;
    const CUtensorMap* const maps[4] = {&qs_map, &g_map, &qz_map, &gz_map};
    int it = 0;
    for (long long x = blockIdx.x; x < total; x += gridDim.x) {
      const int head = static_cast<int>(x / units);
      for (int i = 0; i < q_tiles; ++i, ++it) {
        const int stage = it % kS;
        mbar_wait(empty + stage, ((it / kS) & 1) ^ 1);
        unsigned char* const tiles = smem + L::kRing + stage * 4 * L::kTile;
        // each operand's tile, a box a panel (rows past N and columns past hd read
        // as zeros), and the tile's (m, c), zeros past N in the workspace
        mbar_arrive_expect_tx(full + stage, 4 * L::kTile + kBQ * 8);
        bulk_load(smem + L::kMc + stage * kBQ * 8, mc + (static_cast<size_t>(head) * q_tiles + i) * kBQ,
                  kBQ * 8, full + stage);
#pragma unroll
        for (int op = 0; op < 4; ++op) {
#pragma unroll
          for (int pn = 0; pn < P::kCount; ++pn) {
            tma_load(tiles + op * L::kTile + pn * kBQ * P::kRowBytes, maps[op], pn * P::kWidth,
                     i * kBQ, head, full + stage);
          }
        }
      }
    }
    return;
  }
  regs_grow<232>();

  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3, wt = tid & 127;
  unsigned char* const k_s = smem + L::kK;
  unsigned char* const v_s = smem + L::kV;
  const uint32_t k_tile = smem_addr(k_s), v_tile = smem_addr(v_s);
  const uint32_t ring = smem_addr(smem + L::kRing);
  int it = 0;
  for (long long x = blockIdx.x; x < total; x += gridDim.x) {
    const int head = static_cast<int>(x / units), u = static_cast<int>(x - static_cast<long long>(head) * units);
    const int k0 = u * kUnitKeys;
    const size_t row0 = static_cast<size_t>(head) * n;
    named_barrier(1, 256);  // the last unit's dq products have read K
    for (int idx = wt; idx < kBK * VPR; idx += 128) {  // this warpgroup's 64 keys of K and V
      const int r = kBK * wg + idx / VPR, vc = (idx % VPR) * 8;
      uint4 rk = make_uint4(0, 0, 0, 0), rv = rk;
      if (k0 + r < n && vc < hd) {
        const size_t off = (row0 + k0 + r) * hd + vc;
        rk = __ldg(reinterpret_cast<const uint4*>(k + off));
        rv = __ldg(reinterpret_cast<const uint4*>(v + off));
      }
      const uint32_t d = panel_offset<DP>(kUnitKeys, r, vc);
      *reinterpret_cast<uint4*>(k_s + d) = rk;
      *reinterpret_cast<uint4*>(v_s + d) = rv;
    }
    fence_async_smem();
    named_barrier(2 + wg, 128);

    const int key = k0 + kBK * wg + 16 * wq + g;  // this thread's key rows: key, key + 8
    const bool live_key[2] = {key < n, key + 8 < n};

    // One unit. Per query tile: s^T, dp^T (issued at the end of the tile
    // before); e and t; dv, dk; t^T shared; the dq part issued, and the next
    // tile's s^T, dp^T after it, so that the dq product runs under them; the
    // dq part handed to a dq warp at the start of the next tile. NW: the
    // warpgroup's dq columns.
    auto unit = [&](auto nw) {
      constexpr int NW = decltype(nw)::value;
      const int n0 = wg == 0 ? 0 : DqSplit<DP>::kN0;
      float dk_acc[DP / 2], dv_acc[DP / 2], s[32], dp[32], dq_part[NW / 2];
      uint32_t ef[4][4], tf[4][4];  // e^T and t^T rounded to bf16, as A fragments
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      auto issue_scores = [&](int step) {  // s^T = k qs^T, dp^T = v g^T: 64 keys x 64 queries
        const int stage = step % kS;
        mbar_wait(full + stage, (step / kS) & 1);
        const uint32_t tiles = ring + stage * 4 * L::kTile;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          Wgmma<64>::ss<0, 0>(s, desc_k_major<DP>(k_tile, kUnitKeys, kBK * wg, 16 * kk),
                              desc_k_major<DP>(tiles, kBQ, 0, 16 * kk), kk);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          Wgmma<64>::ss<0, 0>(dp, desc_k_major<DP>(v_tile, kUnitKeys, kBK * wg, 16 * kk),
                              desc_k_major<DP>(tiles + L::kTile, kBQ, 0, 16 * kk), kk);
        }
        wgmma_commit();
      };
      auto staging = [&](int stage) {  // the stage's qs and g tiles, read by then
        return smem + L::kRing + stage * 4 * L::kTile;
      };

      issue_scores(it);
      for (int i = 0; i < q_tiles; ++i, ++it) {
        const int stage = it % kS, prev = (it + kS - 1) % kS;
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(ef);
        fence_regs(tf);
        if (i > 0) {
          fence_regs(dq_part);
          dq_hand_over<NW>(dq_part, staging(prev), dq_ready + prev, n0, wq, lane);
        }
        const uint32_t tiles = ring + stage * 4 * L::kTile;

        // e = exp2(s - m), 0 on dead keys; t = e (dp - c); per query column
        const float2* const mcs = reinterpret_cast<const float2*>(smem + L::kMc) + stage * kBQ;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 mq[2] = {mcs[8 * j + 2 * t], mcs[8 * j + 2 * t + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 r = mq[e & 1];
            const float ev = live_key[e >> 1] ? exp2_fast(s[4 * j + e] - r.x) : 0.f;
            dp[4 * j + e] = ev * (dp[4 * j + e] - r.y);
            s[4 * j + e] = ev;
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ef[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
            tf[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
          }
        }
        // t^T into this warpgroup's [key][query] tile of the parity, 128-byte swizzled
        unsigned char* const tb = smem + L::kT + ((it & 1) * 2 + wg) * L::kTBytes;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wq + g + 8 * h;
            *reinterpret_cast<uint32_t*>(tb + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
                tf[j >> 1][2 * (j & 1) + h];
          }
        }

        // dv += e^T gz, dk += t^T qz
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          Wgmma<DP>::template rs<1>(dv_acc, ef[kk],
                                    desc_mn_major<DP>(tiles + 3 * L::kTile, kBQ, 16 * kk, 0), 1);
          Wgmma<DP>::template rs<1>(dk_acc, tf[kk],
                                    desc_mn_major<DP>(tiles + 2 * L::kTile, kBQ, 16 * kk, 0), 1);
        }
        wgmma_commit();
        fence_async_smem();  // t^T written through the generic proxy
        named_barrier(1, 256);  // both warpgroups' t^T are in
        dq_issue<DP, NW>(dq_part, smem_addr(smem + L::kT + (it & 1) * 2 * L::kTBytes), k_tile,
                         n0);
        if (i + 1 < q_tiles) issue_scores(it + 1);
      }
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(ef);
      fence_regs(tf);
      fence_regs(dq_part);
      const int last = (it + kS - 1) % kS;
      dq_hand_over<NW>(dq_part, staging(last), dq_ready + last, n0, wq, lane);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!live_key[h]) continue;
        const size_t off = (row0 + key + 8 * h) * hd;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < hd) {
            *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
                __floats2bfloat162_rn(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
            *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
                __floats2bfloat162_rn(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
          }
        }
      }
    };
    if (wg == 0) {
      unit(std::integral_constant<int, DqSplit<DP>::kN0>{});
    } else {
      unit(std::integral_constant<int, DqSplit<DP>::kN1>{});
    }
  }
}

// dq = (the summed t k) (scale / z), rounded once; four columns a thread.
__global__ void __launch_bounds__(256) bwd_dq_finish(const float4* __restrict__ acc,
                                                     const float2* __restrict__ stats,
                                                     __nv_bfloat16* __restrict__ dq,
                                                     long long rows, int hd, float scale) {
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int per_row = hd / 4;
  if (idx >= rows * per_row) return;
  const float sz = scale * (1.0f / __ldg(stats + idx / per_row).y);
  const float4 a = __ldg(acc + idx);
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(dq + idx * 4);
  dst[0] = __floats2bfloat162_rn(a.x * sz, a.y * sz);
  dst[1] = __floats2bfloat162_rn(a.z * sz, a.w * sz);
}

// ---------------------------------------------------------------------------
// f32: thread (ty, tx) = (tid / 16, tid % 16) owns tile rows ty + 16 i
// (i < 4), score columns tx + 16 j and output columns tx + 16 j
// (j < DP / 16). The 16 threads of a row are half a warp.

// Rows row0 .. row0 + rows - 1 of src (n rows of hd), each times f(row), into
// dst[rows][stride]; dead rows and the head's padding are zeros.
template <int DP, typename F>
__device__ __forceinline__ void load_rows_f32(float* dst, int stride, const float* src,
                                              size_t base, int row0, int rows, int n, int hd,
                                              int tid, F factor) {
  constexpr int VPR = DP / 4;
  for (int idx = tid; idx < rows * VPR; idx += 256) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n && vc < hd) {
      f = __ldg(reinterpret_cast<const float4*>(src + base + static_cast<size_t>(row0 + r) * hd +
                                                vc));
      const float m = factor(row0 + r);
      f.x *= m;
      f.y *= m;
      f.z *= m;
      f.w *= m;
    }
    float* d = dst + r * stride + vc;
    d[0] = f.x;
    d[1] = f.y;
    d[2] = f.z;
    d[3] = f.w;
  }
}

template <int DP>
__global__ void __launch_bounds__(256) bwd_dq_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ go, const float* __restrict__ stats,
    const float* __restrict__ crow, float* __restrict__ dq, int n, int hd, int q_tiles, float c,
    float scale) {
  constexpr int SQ = DP + 1;  // odd stride: conflict-free reads down a column
  constexpr int SP = kBK + 1;
  constexpr int DJ = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const q_s = reinterpret_cast<float*>(smem);  // [kBQ][SQ], q times c
  float* const g_s = q_s + kBQ * SQ;                  // [kBQ][SQ]
  float* const k_s = g_s + kBQ * SQ;                  // [kBK][SQ]
  float* const v_s = k_s + kBK * SQ;                  // [kBK][SQ]
  float* const p_s = v_s + kBK * SQ;                  // [kBQ][SP]

  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x - bh * q_tiles) * kBQ;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  auto one = [](int) { return 1.f; };

  load_rows_f32<DP>(q_s, SQ, q, base, q0, kBQ, n, hd, tid, [c](int) { return c; });
  load_rows_f32<DP>(g_s, SQ, go, base, q0, kBQ, n, hd, tid, one);

  float m_row[4], c_row[4], sz_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    m_row[i] = c_row[i] = sz_row[i] = 0.f;
    if (row < n) {
      const float2 st = __ldg(reinterpret_cast<const float2*>(stats) +
                              static_cast<size_t>(bh) * n + row);
      m_row[i] = st.x;
      sz_row[i] = scale * (1.0f / st.y);
      c_row[i] = __ldg(crow + static_cast<size_t>(bh) * n + row);
    }
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int tiles = (n + kBK - 1) / kBK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the last tile's reads are done
    load_rows_f32<DP>(k_s, SQ, k, base, k0, kBK, n, hd, tid, one);
    load_rows_f32<DP>(v_s, SQ, v, base, k0, kBK, n, hd, tid, one);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = q_s[(ty + 16 * i) * SQ + d];
        gv[i] = g_s[(ty + 16 * i) * SQ + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = k_s[(tx + 16 * j) * SQ + d];
        vv[j] = v_s[(tx + 16 * j) * SQ + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ev = k0 + tx + 16 * j < n ? exp2f(s[i][j] - m_row[i]) : 0.f;
        p_s[(ty + 16 * i) * SP + tx + 16 * j] = ev * (dp[i][j] - c_row[i]);
      }
    __syncwarp();  // a row's t is written and read by the same half warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = k_s[kk * SQ + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) dq[base + static_cast<size_t>(row) * hd + col] = acc[i][j] * sz_row[i];
    }
  }
}

// f32, dk and dv: the block's 64 keys against query tiles of BQ rows (64, or
// 32 where the head is wide, for the shared memory's sake). Thread (ty, tx)
// owns key rows ty + 16 i, query columns tx + 16 j (j < BQ / 16) of the
// transposed tiles and output columns tx + 16 j (j < DP / 16).
template <int DP, int BQ>
__global__ void __launch_bounds__(256) bwd_dkv_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ go, const float* __restrict__ stats,
    const float* __restrict__ crow, float* __restrict__ dk, float* __restrict__ dv, int n,
    int hd, int k_tiles, float c, float scale) {
  constexpr int SQ = DP + 1;
  constexpr int SP = BQ + 1;
  constexpr int DJ = DP / 16;
  constexpr int QJ = BQ / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const k_s = reinterpret_cast<float*>(smem);  // [kBK][SQ]
  float* const v_s = k_s + kBK * SQ;                  // [kBK][SQ]
  float* const qs_s = v_s + kBK * SQ;                 // [BQ][SQ], q times c
  float* const qz_s = qs_s + BQ * SQ;                 // [BQ][SQ], q scale / z
  float* const g_s = qz_s + BQ * SQ;                  // [BQ][SQ]
  float* const gz_s = g_s + BQ * SQ;                  // [BQ][SQ], g / z
  float* const pt_s = gz_s + BQ * SQ;                 // [kBK][SP], t^T
  float* const pe_s = pt_s + kBK * SP;                // [kBK][SP], e^T
  float* const m_s = pe_s + kBK * SP;                 // [BQ]
  float* const c_s = m_s + BQ;                        // [BQ]

  const int bh = blockIdx.x / k_tiles, k0 = (blockIdx.x - bh * k_tiles) * kBK;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const size_t row_base = static_cast<size_t>(bh) * n;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  auto one = [](int) { return 1.f; };
  auto zinv = [&](int row) { return 1.0f / __ldg(stats + 2 * (row_base + row) + 1); };

  load_rows_f32<DP>(k_s, SQ, k, base, k0, kBK, n, hd, tid, one);
  load_rows_f32<DP>(v_s, SQ, v, base, k0, kBK, n, hd, tid, one);

  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  const int q_tiles = (n + BQ - 1) / BQ;
  for (int tile = 0; tile < q_tiles; ++tile) {
    const int q0 = tile * BQ;
    __syncthreads();  // the last tile's reads are done
    load_rows_f32<DP>(qs_s, SQ, q, base, q0, BQ, n, hd, tid, [c](int) { return c; });
    load_rows_f32<DP>(qz_s, SQ, q, base, q0, BQ, n, hd, tid,
                      [&](int row) { return scale * zinv(row); });
    load_rows_f32<DP>(g_s, SQ, go, base, q0, BQ, n, hd, tid, one);
    load_rows_f32<DP>(gz_s, SQ, go, base, q0, BQ, n, hd, tid, zinv);
    if (tid < BQ) {  // a dead query row: zero operands, shift 0, c 0
      const bool live = q0 + tid < n;
      m_s[tid] = live ? __ldg(stats + 2 * (row_base + q0 + tid)) : 0.f;
      c_s[tid] = live ? __ldg(crow + row_base + q0 + tid) : 0.f;
    }
    __syncthreads();

    float st[4][QJ], dpt[4][QJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float kv[4], vv[4], qv[QJ], gv[QJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = k_s[(ty + 16 * i) * SQ + d];
        vv[i] = v_s[(ty + 16 * i) * SQ + d];
      }
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        qv[j] = qs_s[(tx + 16 * j) * SQ + d];
        gv[j] = g_s[(tx + 16 * j) * SQ + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < QJ; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], gv[j], dpt[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const int col = tx + 16 * j;
        const float ev = k0 + ty + 16 * i < n ? exp2f(st[i][j] - m_s[col]) : 0.f;
        pt_s[(ty + 16 * i) * SP + col] = ev * (dpt[i][j] - c_s[col]);
        pe_s[(ty + 16 * i) * SP + col] = ev;
      }
    __syncwarp();  // a key row's t and e are written and read by the same half warp

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float tv[4], ev[4], qz[DJ], gz[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        tv[i] = pt_s[(ty + 16 * i) * SP + qq];
        ev[i] = pe_s[(ty + 16 * i) * SP + qq];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        qz[j] = qz_s[qq * SQ + tx + 16 * j];
        gz[j] = gz_s[qq * SQ + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          acc_k[i][j] = fmaf(tv[i], qz[j], acc_k[i][j]);
          acc_v[i][j] = fmaf(ev[i], gz[j], acc_v[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) {
        dk[base + static_cast<size_t>(row) * hd + col] = acc_k[i][j];
        dv[base + static_cast<size_t>(row) * hd + col] = acc_v[i][j];
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *g;
  const float* stats;
  float* crow;  // f32: c per row; bf16: the workspace of bf16_workspace
  void *dq, *dk, *dv;
  int bh, n, hd;
  float c, scale;
  cudaStream_t stream;
};

// The bf16 workspace: qs, qz, gz (bh, n, hd) bf16, the dq sums (bh, n, hd)
// f32, (m, c) per row (a head's rows padded to whole query tiles), and a
// counter per (head, query tile).
struct Bf16Workspace {
  size_t qs, qz, gz, dq, mc, counters, bytes;
};

Bf16Workspace bf16_workspace(int bh, int n, int hd) {
  const size_t elems = static_cast<size_t>(bh) * n * hd;
  Bf16Workspace w;
  w.qs = 0;
  w.qz = w.qs + elems * 2;
  w.gz = w.qz + elems * 2;
  w.dq = w.gz + elems * 2;
  w.mc = w.dq + elems * 4;
  w.counters = w.mc + static_cast<size_t>(bh) * ((n + kBQ - 1) / kBQ) * kBQ * 8;
  w.bytes = w.counters + static_cast<size_t>(bh) * ((n + kBQ - 1) / kBQ) * sizeof(int);
  return w;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int L>
void launch_prep(const Args& a, const Bf16Workspace& w, long long rows) {
  using T = __nv_bfloat16;
  unsigned char* const ws = reinterpret_cast<unsigned char*>(a.crow);
  const long long threads = rows * L;
  bwd_prep_bf16<L><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.g), static_cast<const T*>(a.o),
      reinterpret_cast<const float2*>(a.stats), reinterpret_cast<T*>(ws + w.qs),
      reinterpret_cast<T*>(ws + w.qz), reinterpret_cast<T*>(ws + w.gz),
      reinterpret_cast<float2*>(ws + w.mc), rows, a.n, (a.n + kBQ - 1) / kBQ * kBQ, a.hd, a.c,
      a.scale);
}

template <int DP>
cudaError_t launch_bf16(const Args& a) {
  using T = __nv_bfloat16;
  constexpr int kSmem = BwdLayout<DP>::kTotal;
  cudaError_t err = allow_smem(bwd_bf16_wg<DP>, kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const Bf16Workspace w = bf16_workspace(a.bh, a.n, a.hd);
  unsigned char* const ws = reinterpret_cast<unsigned char*>(a.crow);
  err = cudaMemsetAsync(ws + w.mc, 0, w.bytes - w.mc, a.stream);  // (m, c) padding, counters
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.bh) * a.n;
  const int lanes = (a.hd + 7) / 8;  // lanes a row in the prep pass
  if (lanes <= 1) launch_prep<1>(a, w, rows);
  else if (lanes <= 2) launch_prep<2>(a, w, rows);
  else if (lanes <= 4) launch_prep<4>(a, w, rows);
  else if (lanes <= 8) launch_prep<8>(a, w, rows);
  else launch_prep<16>(a, w, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the streamed operands as (hd, N, BH) for the copy engine, a box a panel
  CUtensorMap maps[4];
  const void* const bases[4] = {ws + w.qs, a.g, ws + w.qz, ws + w.gz};
  for (int op = 0; op < 4; ++op) {
    if (make_tensor_map(&maps[op], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bases[op], a.hd, a.n, a.bh,
                        static_cast<uint64_t>(a.hd) * 2, static_cast<uint64_t>(a.n) * a.hd * 2,
                        Panels<DP>::kWidth, kBQ, panel_swizzle<DP>()) != 0) {
      return cudaErrorInvalidValue;
    }
  }
  // the f32 dq sums as (hd, N, BH), boxes of 16 columns x 64 rows, 64-byte swizzled
  CUtensorMap dq_map;
  if (make_tensor_map(&dq_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws + w.dq, a.hd, a.n, a.bh,
                      static_cast<uint64_t>(a.hd) * 4, static_cast<uint64_t>(a.n) * a.hd * 4, 16,
                      kBQ, CU_TENSOR_MAP_SWIZZLE_64B) != 0) {
    return cudaErrorInvalidValue;
  }
  // persistent: one block per SM (or per unit, where there are fewer)
  const long long units = static_cast<long long>(a.bh) * ((a.n + kUnitKeys - 1) / kUnitKeys);
  const int grid = static_cast<int>(units < sms ? units : sms);
  bwd_bf16_wg<DP><<<grid, kBwdThreads, kSmem, a.stream>>>(
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), maps[0], maps[1], maps[2], maps[3],
      reinterpret_cast<const float2*>(ws + w.mc),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), dq_map,
      reinterpret_cast<int*>(ws + w.counters), a.bh, a.n, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long vecs = rows * (a.hd / 4);
  bwd_dq_finish<<<static_cast<unsigned>((vecs + 255) / 256), 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(ws + w.dq), reinterpret_cast<const float2*>(a.stats),
      static_cast<T*>(a.dq), rows, a.hd, a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const Args& a) {
  constexpr int BQ = DP > 80 ? 32 : 64;
  constexpr int kSmemQ = (4 * kBQ * (DP + 1) + kBQ * (kBK + 1)) * (int)sizeof(float);
  constexpr int kSmemKV = (2 * kBK * (DP + 1) + 4 * BQ * (DP + 1) + 2 * kBK * (BQ + 1) + 2 * BQ) *
                          (int)sizeof(float);
  cudaError_t err = allow_smem(bwd_dq_f32<DP>, kSmemQ);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_dkv_f32<DP, BQ>, kSmemKV);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.bh) * a.n;
  rowdot<float><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const float*>(a.g), static_cast<const float*>(a.o), a.crow, rows, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (a.n + kBQ - 1) / kBQ;
  bwd_dq_f32<DP><<<a.bh * tiles, 256, kSmemQ, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.stats, a.crow,
      static_cast<float*>(a.dq), a.n, a.hd, tiles, a.c, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_f32<DP, BQ><<<a.bh * tiles, 256, kSmemKV, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.g), a.stats, a.crow,
      static_cast<float*>(a.dk), static_cast<float*>(a.dv), a.n, a.hd, tiles, a.c, a.scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(int dtype, const Args& a) {
  return dtype == 0 ? launch_f32<DP>(a) : launch_bf16<DP>(a);
}

}  // namespace

// Bytes of the scratch xmir_vit_attn_bwd takes as `crow`: (bh, n) float32
// for dtype 0 (float32), the bf16 kernels' workspace for dtype 1.
extern "C" int xmir_vit_attn_bwd_workspace(int dtype, int bh, int n, int hd, long long* bytes) {
  if ((dtype != 0 && dtype != 1) || bh < 1 || n < 1 || hd < 8 || hd > 128 || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  *bytes = dtype == 0 ? static_cast<long long>(bh) * n * 4
                      : static_cast<long long>(bf16_workspace(bh, n, hd).bytes);
  return 0;
}

// C entry point bound with ctypes; returns a cudaError_t code. q, k, v, o, g
// and the outputs dq, dk, dv are (bh, n, hd), contiguous, 16-byte aligned, of
// one dtype (0 = float32, 1 = bfloat16); stats (bh, n, 2) float32 holds each
// row's shift and sum as xmir_vit_attn wrote them; crow is scratch of
// xmir_vit_attn_bwd_workspace's bytes, 16-byte aligned; hd a multiple of 8 up
// to 128; c = scale log2(e), already rounded to the dtype; scale the softmax
// scale itself.
extern "C" int xmir_vit_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                 const void* g, const void* stats, void* crow, void* dq,
                                 void* dk, void* dv, int dtype, int bh, int n, int hd, float c,
                                 float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || bh < 1 || n < 1 || hd < 8 || hd > 128 || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = static_cast<long long>(bh) * ((n + kBQ - 1) / kBQ);
  if (blocks > 2147483647LL || static_cast<long long>(bh) * n / 8 >= 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{q, k, v, o, g, static_cast<const float*>(stats), static_cast<float*>(crow),
               dq, dk, dv, bh, n, hd, c, scale, static_cast<cudaStream_t>(stream)};
  if (hd <= 16) return (int)launch<16>(dtype, a);
  if (hd <= 32) return (int)launch<32>(dtype, a);
  if (hd <= 64) return (int)launch<64>(dtype, a);
  if (hd <= 80) return (int)launch<80>(dtype, a);
  return (int)launch<128>(dtype, a);
}
