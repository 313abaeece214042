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

// f32 (f32 training under XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1, and the f32
// towers of the MedSigLIP IT-Align step at hd 72). What bounds it on the
// H100: the same 10 BH N^2 hd operations, which the CUDA cores' f32 FMAs
// (67 TFLOP/s) take 3.4 ms for at B = 16 against 1.4 ms as three TF32
// products each on the tensor cores (3 x 495 TFLOP/s). So dv, dk and dq are
// 3xTF32 on wgmma (attn_bwd_f32.cuh: the split, the operand layouts), and
// the scores and dp stay on IEEE FMAs: e = exp2(s - m) scales an error of s
// up, and a row with one dominant key leaves t = e (dp - c) a residue of
// dp, which 3xTF32 moved past the f32 bounds (PERF.md). Those two products
// are then the bound: 1.4 ms of FMAs at B = 16, whose operands come from
// shared memory at 2.5 loads a product (the accumulator layout gives a
// thread two keys). An f32 tile and its small part are four times a bf16
// tile, so the design keeps the bf16 route's single pass with smaller
// pieces, four launches:
//   bwd_prep_f32       per row qs = q c and (m, c = rowsum(g . o)), the
//                      small parts of qs and g, and qz = q (scale / z),
//                      gz = g / z written transposed (hd, N) with their small
//                      parts, since TF32 reads no MN-major operand;
//   bwd_f32_wg         a persistent block per SM takes (head, 64-key) units
//                      in order: the unit's k and v stay resident (big and
//                      small, 32-128 KB), a producer warp streams the QB-row
//                      query tiles (QB = 32; 16 at hd 80, 8 at hd 128)
//                      through a ring of two stages of eight operand tiles
//                      (TMA), one stage for each of two consumer warpgroups
//                      that take the tiles in turns; per tile s^T, dp^T
//                      (IEEE FMAs), dv, dk and the dq part (3xTF32 wgmma)
//                      once each (10 BH N^2 hd operations), the dq parts
//                      added in key-unit order behind the bf16 route's
//                      per-tile counters, the warpgroups' dk, dv parts
//                      added in a fixed order at the unit's end;
//   bwd_dq_finish_f32  dq = (the sum) (scale / z);
// plus a memset of the counters. Two runs are bit-equal.
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
// instantiated width (bf16: 16, 32, 64, 80, 128; f32: 32, 64, 72, 80, 128).
// Launches go on the caller's stream and allocate nothing: the wrapper hands
// over the scratch.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_bwd_f32.cuh"
#include "attn_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile

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
// f32: bwd_prep_f32 writes the operands the main kernel streams, bwd_f32_wg
// does the five products in 3xTF32 (attn_bwd_f32.cuh), bwd_dq_finish_f32
// scales dq.

namespace tb = tf32bwd;

// dp's route: IEEE FMAs (0). A row with one dominant key leaves t = e (dp - c)
// a residue of dp, which dp on 3xTF32 (3) moved past the f32 bounds, each
// depth step's sum added in f32 or not (PERF.md); chip_faults.py plants 3.
constexpr int kDpTerms = 0;

// One block per (head, 64-query tile): c = rowsum(g . o) per row (a warp a
// row, the lanes' strided sums then a butterfly), qs = q c, the small parts
// of qs and g, and qz^T = (q (scale / z))^T, gz^T = (g / z)^T big and small
// at (hd, n_pad) a head in slot_query's order; (m, c) at n_pad rows a head.
// The rows past n are zeros in the transposed operands and in (m, c);
// `plane` is the elements of one transposed operand (its small part
// follows).
template <int DP>
__global__ void __launch_bounds__(256) bwd_prep_f32(
    const float* __restrict__ q, const float* __restrict__ go, const float* __restrict__ o,
    const float2* __restrict__ stats, float* __restrict__ qs, float* __restrict__ qs_small,
    float* __restrict__ g_small, float* __restrict__ qzt, float* __restrict__ gzt,
    float2* __restrict__ mc, int n, int n_pad, int hd, size_t plane, float c, float scale) {
  constexpr int S = DP + 1, VPR = DP / 4;
  extern __shared__ float prep_smem[];
  float* const qz_s = prep_smem;  // [64][S]
  float* const gz_s = qz_s + 64 * S;
  float* const zinv_s = gz_s + 64 * S;  // [64]
  float* const sz_s = zinv_s + 64;
  const int tiles = n_pad / 64, head = blockIdx.x / tiles, q0 = (blockIdx.x - head * tiles) * 64;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row0 = static_cast<size_t>(head) * n;
  for (int r = warp; r < 64; r += 8) {
    const int row = q0 + r;
    float sum = 0.f;
    if (row < n) {
      const size_t off = (row0 + row) * hd;
      for (int d = lane; d < hd; d += 32) sum = fmaf(go[off + d], o[off + d], sum);
    }
#pragma unroll
    for (int off2 = 16; off2 > 0; off2 >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off2);
    if (lane == 0) {
      const bool live = row < n;
      const float2 st = live ? __ldg(stats + row0 + row) : make_float2(0.f, 1.f);
      const float zinv = 1.0f / st.y;
      zinv_s[r] = live ? zinv : 0.f;
      sz_s[r] = live ? scale * zinv : 0.f;
      mc[static_cast<size_t>(head) * n_pad + row] = live ? make_float2(st.x, sum) : make_float2(0.f, 0.f);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < 64 * VPR; idx += 256) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 4, row = q0 + r;
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), gv = qv;
    if (row < n && vc < hd) {
      const size_t off = (row0 + row) * hd + vc;
      qv = __ldg(reinterpret_cast<const float4*>(q + off));
      gv = __ldg(reinterpret_cast<const float4*>(go + off));
      const float4 x = make_float4(qv.x * c, qv.y * c, qv.z * c, qv.w * c);
      *reinterpret_cast<float4*>(qs + off) = x;
      *reinterpret_cast<float4*>(qs_small + off) =
          make_float4(tf32_small(x.x), tf32_small(x.y), tf32_small(x.z), tf32_small(x.w));
      *reinterpret_cast<float4*>(g_small + off) =
          make_float4(tf32_small(gv.x), tf32_small(gv.y), tf32_small(gv.z), tf32_small(gv.w));
    }
    const float sz = sz_s[r], zinv = zinv_s[r];
    float* const qz = qz_s + r * S + vc;
    float* const gz = gz_s + r * S + vc;
    qz[0] = qv.x * sz;
    qz[1] = qv.y * sz;
    qz[2] = qv.z * sz;
    qz[3] = qv.w * sz;
    gz[0] = gv.x * zinv;
    gz[1] = gv.y * zinv;
    gz[2] = gv.z * zinv;
    gz[3] = gv.w * zinv;
  }
  __syncthreads();
  for (int idx = tid; idx < hd * 64; idx += 256) {
    const int d = idx >> 6, p = idx & 63;
    const int qr = tb::slot_query(p);
    const size_t dst = (static_cast<size_t>(head) * hd + d) * n_pad + q0 + p;
    const float x = qz_s[qr * S + d], y = gz_s[qr * S + d];
    qzt[dst] = x;
    qzt[plane + dst] = tf32_small(x);
    gzt[dst] = y;
    gzt[plane + dst] = tf32_small(y);
  }
}

template <int DP>
struct F32Layout {  // byte offsets in the block's 1024-aligned shared memory
  using C = tb::Cfg<DP>;
  using St = tb::Stage<DP>;
  static constexpr int kQB = C::kQB, kStages = C::kStages;
  static constexpr int kUnit = tb::kUnitKeys * DP * 4;  // the unit's k (or v), big or small
  static constexpr int kK = 0, kV = 2 * kUnit, kRing = 4 * kUnit;  // big, then small
  static constexpr int kMc = St::kOperands;             // in a stage: the rows' (m, c)
  static constexpr int kStage = St::kOperands + 1024;
  static constexpr int kBars = kRing + kStages * kStage;
  static constexpr int kTotal = kBars + 3 * kStages * 8 + 1024;
};

struct F32Maps {  // the copy engine's tensor maps, passed by value
  CUtensorMap qs, qs_small, g, g_small, qzt, qzt_small, gzt, gzt_small, dq;
};

// One block per SM walks units of (head, 64 keys) in (head, key tile) order.
// Warps 0-7 hold the unit's k and v (big and small); warpgroup w takes the
// query tiles of walk count w mod 2 (ring stage w): s^T and dp^T on FMAs,
// e = exp2(s - m) and t = e (dp - c) in registers, dv += e^T gz and
// dk += t^T qz with e and t as A from registers, t staged over the stage's
// consumed qs and g tiles, dq^T = k^T t^T, staged over its qz^T tiles; at
// the unit's end warpgroup 0 stores its dk, dv parts and warpgroup 1 adds its
// own. Warp 8 streams the tiles (eight operand tiles by TMA, the rows' (m, c)
// by a bulk copy); warp 9 + s adds the dq parts staged in ring stage s to the
// f32 sums in key-unit order (the bf16 kernel's counters), and frees the
// stage. Units are taken in order and every block is resident, so a wait is
// for a unit that a running block holds or has done.
template <int DP>
__global__ void __launch_bounds__(tb::kThreads, 1) bwd_f32_wg(
    const float* __restrict__ k, const float* __restrict__ v, const __grid_constant__ F32Maps maps,
    const float2* __restrict__ mc, float* __restrict__ dk, float* __restrict__ dv,
    int* __restrict__ counters, int bh, int n, int n_pad, int hd) {
  using L = F32Layout<DP>;
  using St = tb::Stage<DP>;
  constexpr int QB = L::kQB, kS = L::kStages, MT = (DP + 63) / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* const empty = full + kS;
  uint64_t* const dq_ready = empty + kS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int units = (n + tb::kUnitKeys - 1) / tb::kUnitKeys, q_tiles = (n + QB - 1) / QB;
  const long long total = static_cast<long long>(bh) * units;

  if (tid == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(full + st, 1);      // the producer, once its copies land
      mbar_init(empty + st, 1);     // its dq warp, once its add has read the stage
      mbar_init(dq_ready + st, 4);  // one arrival per warp of the tile's warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the third warpgroup gives (168 - 40) x 128 registers to the consumers
    regs_shrink<40>();
    if (lane != 0 || warp - 9 >= kS) return;
    if (warp >= 9) {  // dq warp 5 + s: ring stage s's staged parts into the sums, in unit order
      const int stage = warp - 9;
      int it = 0;
      for (long long x = blockIdx.x; x < total; x += gridDim.x) {
        const int head = static_cast<int>(x / units), u = static_cast<int>(x % units);
        for (int i = 0; i < q_tiles; ++i, ++it) {
          if (it % kS != stage) continue;
          mbar_wait(dq_ready + stage, (it / kS) & 1);
          int* const cnt = counters + static_cast<size_t>(head) * q_tiles + i;
          const unsigned char* const src = smem + L::kRing + stage * L::kStage + St::kQzT;
          while (ld_acquire_gpu(cnt) != u) {
          }
          fence_async_global();
          for (int c0 = 0; c0 < hd; c0 += 16) {  // a box of 16 columns; rows past N not written
            if (u == 0) {  // the first unit's part is the sum so far
              tma_store(&maps.dq, c0, i * QB, head, src + c0 * (QB * 4));
            } else {
              tma_reduce_add(&maps.dq, c0, i * QB, head, src + c0 * (QB * 4));
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
    using P = Panels<2 * DP>;
    const CUtensorMap* const rows[4] = {&maps.qs, &maps.qs_small, &maps.g, &maps.g_small};
    const CUtensorMap* const cols[4] = {&maps.qzt, &maps.qzt_small, &maps.gzt, &maps.gzt_small};
    int it = 0;
    for (long long x = blockIdx.x; x < total; x += gridDim.x) {
      const int head = static_cast<int>(x / units);
      for (int i = 0; i < q_tiles; ++i, ++it) {
        const int stage = it % kS;
        mbar_wait(empty + stage, ((it / kS) & 1) ^ 1);
        unsigned char* const tiles = smem + L::kRing + stage * L::kStage;
        // every box reads zeros outside its tensor, so the stage's bytes are
        // always its eight tiles; the rows' (m, c) are zeros past N
        mbar_arrive_expect_tx(full + stage, St::kOperands + QB * 8);
        bulk_load(tiles + L::kMc, mc + static_cast<size_t>(head) * n_pad + i * QB, QB * 8,
                  full + stage);
#pragma unroll
        for (int op = 0; op < 4; ++op) {
#pragma unroll
          for (int pn = 0; pn < P::kCount; ++pn) {
            tma_load(tiles + op * St::kTile + pn * QB * P::kRowBytes, rows[op], pn * P::kWidth / 2,
                     i * QB, head, full + stage);
          }
          tma_load(tiles + St::kQzT + op * St::kTile, cols[op], i * QB, 0, head, full + stage);
        }
      }
    }
    return;
  }

  regs_grow<232>();
  // warpgroup wg takes the query tiles of parity wg (of the walk's count)
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  unsigned char* const k_s = smem + L::kK;
  unsigned char* const v_s = smem + L::kV;
  auto no_norm = [](float) { return 1.f; };
  int it = 0;
  for (long long x = blockIdx.x; x < total; x += gridDim.x) {
    const int head = static_cast<int>(x / units), u = static_cast<int>(x - static_cast<long long>(head) * units);
    const int k0 = u * tb::kUnitKeys;
    const size_t row0 = static_cast<size_t>(head) * n;
    named_barrier(1, tb::kConsumers);  // the last unit's products have read k and v
    tb::load_unit<DP>(k_s, k_s + L::kUnit, k + row0 * hd, k0, n, hd, false, no_norm, tid);
    tb::load_unit<DP>(v_s, v_s + L::kUnit, v + row0 * hd, k0, n, hd, false, no_norm, tid);
    fence_async_smem();
    named_barrier(1, tb::kConsumers);

    const int key = k0 + 16 * wq + g;  // this thread's key rows: key, key + 8
    const bool live_key[2] = {key < n, key + 8 < n};
    float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
    for (int i = 0; i < q_tiles; ++i, ++it) {
      if ((it & 1) != wg) continue;
      const int stage = it % kS;
      unsigned char* const tiles = smem + L::kRing + stage * L::kStage;
      const uint32_t tiles_a = smem_addr(tiles);
      float s[QB / 2], dp[QB / 2];
      mbar_wait(full + stage, (it / kS) & 1);
      tb::scores_and_dp<DP, kDpTerms>(s, dp, k_s, v_s, L::kUnit, tiles, wq, g, t);

      // e = exp2(s - m), 0 on dead keys; t = e (dp - c); per query column
      const float2* const mcs = reinterpret_cast<const float2*>(tiles + L::kMc);
#pragma unroll
      for (int j = 0; j < QB / 8; ++j) {
        const float2 mq[2] = {mcs[8 * j + 2 * t], mcs[8 * j + 2 * t + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 r = mq[e & 1];
          const float ev = live_key[e >> 1] ? exp2f(s[4 * j + e] - r.x) : 0.f;
          dp[4 * j + e] = ev * (dp[4 * j + e] - r.y);
          s[4 * j + e] = ev;
        }
      }
      uint32_t eb[QB / 8][4], es[QB / 8][4], tb_[QB / 8][4], ts[QB / 8][4];
      tb::split_fragments<QB / 8>(s, eb, es);
      tb::split_fragments<QB / 8>(dp, tb_, ts);
      tb::issue_dkv<DP>(dv_acc, dk_acc, eb, es, tb_, ts, tiles_a);
      tb::stage_t<QB>(tiles + St::kQs, tb_, ts, wq, g, t);  // over the consumed qs, g tiles
      fence_async_smem();
      named_barrier(2 + wg, 128);  // every warp's t is in
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      fence_regs(eb);
      fence_regs(es);
      fence_regs(tb_);
      fence_regs(ts);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float dq_acc[QB / 2];
        tb::issue_dq<DP>(dq_acc, k_s, k_s + L::kUnit, tiles_a + St::kQs, mt, wq, g, t);
        tb::stage_dq<DP>(tiles + St::kQzT, dq_acc, mt, wq, g, t);  // over the consumed qz^T tiles
      }
      fence_async_smem();  // the copy engine reads the staging through the asynchronous proxy
      __syncwarp();
      if (lane == 0) mbar_arrive(dq_ready + stage);
    }

    // dk and dv: warpgroup 0's parts through the outputs, then warpgroup 1
    // adds its own to them (in that order) and stores the sums
    if (wg == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!live_key[h]) continue;
        const size_t off = (row0 + key + 8 * h) * hd;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < hd) {
            *reinterpret_cast<float2*>(dk + off + col) =
                make_float2(dk_acc[4 * j + 2 * h], dk_acc[4 * j + 2 * h + 1]);
            *reinterpret_cast<float2*>(dv + off + col) =
                make_float2(dv_acc[4 * j + 2 * h], dv_acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
    __threadfence_block();
    named_barrier(1, tb::kConsumers);
    if (wg == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!live_key[h]) continue;
        const size_t off = (row0 + key + 8 * h) * hd;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = 8 * j + 2 * t;
          if (col < hd) {
            float2* const pk = reinterpret_cast<float2*>(dk + off + col);
            float2* const pv = reinterpret_cast<float2*>(dv + off + col);
            const float2 a = *pk, b = *pv;
            *pk = make_float2(a.x + dk_acc[4 * j + 2 * h], a.y + dk_acc[4 * j + 2 * h + 1]);
            *pv = make_float2(b.x + dv_acc[4 * j + 2 * h], b.y + dv_acc[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// dq = (the summed t k) (scale / z); four columns a thread.
__global__ void __launch_bounds__(256) bwd_dq_finish_f32(const float4* __restrict__ acc,
                                                         const float2* __restrict__ stats,
                                                         float4* __restrict__ dq, long long rows,
                                                         int hd, float scale) {
  const long long idx = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int per_row = hd / 4;
  if (idx >= rows * per_row) return;
  const float sz = scale * (1.0f / __ldg(stats + idx / per_row).y);
  const float4 a = __ldg(acc + idx);
  dq[idx] = make_float4(a.x * sz, a.y * sz, a.z * sz, a.w * sz);
}

struct Args {
  const void *q, *k, *v, *o, *g;
  const float* stats;
  float* crow;  // the workspace: f32_workspace's or bf16_workspace's
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

// The f32 workspace: qs, the small parts of qs and g (bh, n, hd); qz^T, gz^T
// (bh, hd, n_pad), each big then small; (m, c) per row (bh, n_pad); the dq
// sums (bh, n, hd); a counter per (head, query tile of QB rows).
struct F32Workspace {
  size_t qs, qs_small, g_small, qzt, gzt, mc, dq, counters, bytes, plane;
};

F32Workspace f32_workspace(int bh, int n, int hd) {
  const size_t elems = static_cast<size_t>(bh) * n * hd, n_pad = (n + 63) / 64 * 64;
  const int qb = hd <= 72 ? 32 : hd <= 80 ? 16 : 8;  // tb::Cfg's query tile at hd's padded width
  F32Workspace w;
  w.plane = static_cast<size_t>(bh) * hd * n_pad * 4;
  w.qs = 0;
  w.qs_small = w.qs + elems * 4;
  w.g_small = w.qs_small + elems * 4;
  w.qzt = w.g_small + elems * 4;
  w.gzt = w.qzt + 2 * w.plane;
  w.mc = w.gzt + 2 * w.plane;
  w.dq = w.mc + static_cast<size_t>(bh) * n_pad * 8;
  w.counters = w.dq + elems * 4;
  w.bytes = w.counters + static_cast<size_t>(bh) * ((n + qb - 1) / qb) * sizeof(int);
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
  using L = F32Layout<DP>;
  constexpr int QB = L::kQB, kPrepSmem = (2 * 64 * (DP + 1) + 2 * 64) * 4;
  cudaError_t err = allow_smem(bwd_f32_wg<DP>, L::kTotal);
  if (err == cudaSuccess) err = allow_smem(bwd_prep_f32<DP>, kPrepSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const F32Workspace w = f32_workspace(a.bh, a.n, a.hd);
  unsigned char* const ws = reinterpret_cast<unsigned char*>(a.crow);
  err = cudaMemsetAsync(ws + w.counters, 0, w.bytes - w.counters, a.stream);
  if (err != cudaSuccess) return err;
  const int n_pad = (a.n + 63) / 64 * 64;
  bwd_prep_f32<DP><<<a.bh * (n_pad / 64), 256, kPrepSmem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.g),
      static_cast<const float*>(a.o), reinterpret_cast<const float2*>(a.stats),
      reinterpret_cast<float*>(ws + w.qs), reinterpret_cast<float*>(ws + w.qs_small),
      reinterpret_cast<float*>(ws + w.g_small), reinterpret_cast<float*>(ws + w.qzt),
      reinterpret_cast<float*>(ws + w.gzt), reinterpret_cast<float2*>(ws + w.mc), a.n, n_pad,
      a.hd, w.plane / 4, a.c, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the row operands as (hd, N, BH), a box a panel; the transposed ones as
  // (n_pad, hd, BH), a box of (QB, DP); the f32 dq sums as (hd, N, BH), boxes
  // of 16 columns x QB rows, 64-byte swizzled
  F32Maps maps;
  using P = Panels<2 * DP>;
  const void* const rows[4] = {ws + w.qs, ws + w.qs_small, a.g, ws + w.g_small};
  CUtensorMap* const row_maps[4] = {&maps.qs, &maps.qs_small, &maps.g, &maps.g_small};
  const void* const cols[4] = {ws + w.qzt, ws + w.qzt + w.plane, ws + w.gzt, ws + w.gzt + w.plane};
  CUtensorMap* const col_maps[4] = {&maps.qzt, &maps.qzt_small, &maps.gzt, &maps.gzt_small};
  for (int op = 0; op < 4; ++op) {
    if (make_tensor_map(row_maps[op], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rows[op], a.hd, a.n, a.bh,
                        static_cast<uint64_t>(a.hd) * 4, static_cast<uint64_t>(a.n) * a.hd * 4,
                        P::kWidth / 2, QB, panel_swizzle<2 * DP>()) != 0 ||
        make_tensor_map(col_maps[op], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cols[op], n_pad, a.hd, a.bh,
                        static_cast<uint64_t>(n_pad) * 4, static_cast<uint64_t>(n_pad) * a.hd * 4,
                        QB, DP, panel_swizzle<2 * QB>()) != 0) {
      return cudaErrorInvalidValue;
    }
  }
  if (make_tensor_map(&maps.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ws + w.dq, a.hd, a.n, a.bh,
                      static_cast<uint64_t>(a.hd) * 4, static_cast<uint64_t>(a.n) * a.hd * 4, 16,
                      QB, CU_TENSOR_MAP_SWIZZLE_64B) != 0) {
    return cudaErrorInvalidValue;
  }
  // persistent: one block per SM (or per unit, where there are fewer)
  const long long units = static_cast<long long>(a.bh) * ((a.n + tb::kUnitKeys - 1) / tb::kUnitKeys);
  const int grid = static_cast<int>(units < sms ? units : sms);
  bwd_f32_wg<DP><<<grid, tb::kThreads, L::kTotal, a.stream>>>(
      static_cast<const float*>(a.k), static_cast<const float*>(a.v), maps,
      reinterpret_cast<const float2*>(ws + w.mc), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), reinterpret_cast<int*>(ws + w.counters), a.bh, a.n, n_pad, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows_n = static_cast<long long>(a.bh) * a.n, vecs = rows_n * (a.hd / 4);
  bwd_dq_finish_f32<<<static_cast<unsigned>((vecs + 255) / 256), 256, 0, a.stream>>>(
      reinterpret_cast<const float4*>(ws + w.dq), reinterpret_cast<const float2*>(a.stats),
      static_cast<float4*>(a.dq), rows_n, a.hd, a.scale);
  return cudaGetLastError();
}


}  // namespace

// Bytes of the scratch xmir_vit_attn_bwd takes as `crow`: the f32 kernels'
// workspace for dtype 0 (float32), the bf16 kernels' for dtype 1.
extern "C" int xmir_vit_attn_bwd_workspace(int dtype, int bh, int n, int hd, long long* bytes) {
  if ((dtype != 0 && dtype != 1) || bh < 1 || n < 1 || hd < 8 || hd > 128 || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  *bytes = static_cast<long long>(dtype == 0 ? f32_workspace(bh, n, hd).bytes
                                             : bf16_workspace(bh, n, hd).bytes);
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
  if (dtype == 0) {  // f32: hd zero-padded to 32, 64, 72, 80, 128
    if (hd <= 32) return (int)launch_f32<32>(a);
    if (hd <= 64) return (int)launch_f32<64>(a);
    if (hd <= 72) return (int)launch_f32<72>(a);
    if (hd <= 80) return (int)launch_f32<80>(a);
    return (int)launch_f32<128>(a);
  }
  if (hd <= 16) return (int)launch_bf16<16>(a);
  if (hd <= 32) return (int)launch_bf16<32>(a);
  if (hd <= 64) return (int)launch_bf16<64>(a);
  if (hd <= 80) return (int)launch_bf16<80>(a);
  return (int)launch_bf16<128>(a);
}
