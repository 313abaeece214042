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
// The design here: the forward (vit_attn.cu) hands over, per query row, the
// integer-valued shift m it used and the sum z of e = exp2(s - m), so no
// kernel needs a pass for the max and e is the forward's e. The work is split
// in three kernels that each own their output, so nothing is added up with
// atomics and two runs are bit-equal:
//   rowdot   c = rowsum(g . o) in f32, one warp a row, (BH, N) f32;
//   dq       one block per (head, 64-query tile) streams the 64-key tiles of
//            K and V past it (cp.async, double-buffered) and owns its dq tile;
//   dk, dv   one block per (head, 64-key tile) streams the 64-query tiles
//            past it and keeps its dk and dv tiles in f32 registers: the TPU
//            kernel's f32 accumulation, in a fixed order.
// Scores and dp are therefore computed twice: 14 BH N^2 hd operations
// against the minimum of 10. The (N, N) tiles never reach device memory.
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
// Ragged N: dead key columns get e = 0, dead query rows are zero-filled in
// shared memory (so they add nothing to dk and dv) and are not stored. hd is
// any multiple of 8 up to 128, zero-padded in shared memory to the next
// instantiated width (16, 32, 64, 80, 128).
//
// What bounds it: 10 BH N^2 hd operations (five products) against eight
// (BH, N, hd) tensors moved once: operations. bf16 runs on the tensor cores
// (mma.sync m16n8k16 through ldmatrix, four warps a block); f32 on IEEE f32
// FMAs (no TF32), 256 threads with a 4 x 4 score block each. wgmma, TMA and a
// single pass that shares the scores are later work. Launches go on the
// caller's stream and allocate nothing.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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
// bf16, dq: four warps, warp w owns query rows 16 w .. 16 w + 15 of the tile.
// In the m16n8 fragments a thread holds rows g = lane / 4 and g + 8, columns
// 2 (lane % 4) and + 1 of every 8-column tile.
template <int DP>
__global__ void __launch_bounds__(128) bwd_dq_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ go,
    const float* __restrict__ stats, const float* __restrict__ crow,
    __nv_bfloat16* __restrict__ dq, int n, int hd, int q_tiles, float c, float scale) {
  constexpr int S = DP + 8;    // row stride: 16-byte aligned, ldmatrix conflict-free
  constexpr int VPR = DP / 8;  // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBQ][S], q times c
  __nv_bfloat16* const g_s = q_s + kBQ * S;                           // [kBQ][S]
  __nv_bfloat16* const kv_s = g_s + kBQ * S;  // [2 stages][k, v][kBK][S]

  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x - bh * q_tiles) * kBQ;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  auto prefetch = [&](int tile, int stage) {
    const int k0 = tile * kBK;
    __nv_bfloat16* ks = kv_s + stage * 2 * kBK * S;
    __nv_bfloat16* vs = ks + kBK * S;
    for (int idx = tid; idx < kBK * VPR; idx += 128) {
      const int r = idx / VPR, vc = (idx - r * VPR) * 8;
      const bool live = k0 + r < n && vc < hd;  // dead rows and the head's padding: zeros
      const size_t off = live ? base + static_cast<size_t>(k0 + r) * hd + vc : base;
      cp_async16(ks + r * S + vc, k + off, live);
      cp_async16(vs + r * S + vc, v + off, live);
    }
    cp_async_commit();
  };
  prefetch(0, 0);

  for (int idx = tid; idx < kBQ * VPR; idx += 128) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 8;
    uint4 rq = make_uint4(0, 0, 0, 0), rg = make_uint4(0, 0, 0, 0);
    if (q0 + r < n && vc < hd) {
      const size_t off = base + static_cast<size_t>(q0 + r) * hd + vc;
      rq = scale8(__ldg(reinterpret_cast<const uint4*>(q + off)), c);
      rg = __ldg(reinterpret_cast<const uint4*>(go + off));
    }
    *reinterpret_cast<uint4*>(q_s + r * S + vc) = rq;
    *reinterpret_cast<uint4*>(g_s + r * S + vc) = rg;
  }

  // this thread's two rows: shift, c and scale / z; a dead row gets 0, 0, 0
  float m_row[2], c_row[2], sz_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    m_row[h] = c_row[h] = sz_row[h] = 0.f;
    if (row < n) {
      const float2 st = __ldg(reinterpret_cast<const float2*>(stats) +
                              static_cast<size_t>(bh) * n + row);
      m_row[h] = st.x;
      sz_row[h] = scale * (1.0f / st.y);
      c_row[h] = __ldg(crow + static_cast<size_t>(bh) * n + row);
    }
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int tiles = (n + kBK - 1) / kBK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < tiles) {
      prefetch(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile has landed (and, the first time, q_s and g_s are written)
    const __nv_bfloat16* ks = kv_s + stage * 2 * kBK * S;
    const __nv_bfloat16* vs = ks + kBK * S;

    // s = qs k^T and dp = g v^T: 16 query rows x 64 keys per warp
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t qf[4], gf[4];
      const int a_off = (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(qf, q_s + a_off);
      ldmatrix_x4(gf, g_s + a_off);
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, ks + b_off);
        mma_bf16(s[2 * np], qf, r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf, r[2], r[3]);
        ldmatrix_x4(r, vs + b_off);
        mma_bf16(dp[2 * np], gf, r[0], r[1]);
        mma_bf16(dp[2 * np + 1], gf, r[2], r[3]);
      }
    }

    // t = e (dp - c), e = 0 on dead key columns
    const int k0 = tile * kBK;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool live = k0 + nt * 8 + 2 * t + (e & 1) < n;
        const float ev = live ? exp2f(s[nt][e] - m_row[h]) : 0.f;
        s[nt][e] = ev * (dp[nt][e] - c_row[h]);
      }

    // acc += t (rounded to bf16) . K
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < DP / 16; ++dd) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, ks + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + dd * 16 +
                                 (lane >> 4) * 8);
        mma_bf16(acc[2 * dd], pa, r[0], r[1]);
        mma_bf16(acc[2 * dd + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= n) continue;
    __nv_bfloat16* dst = dq + base + static_cast<size_t>(row) * hd;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(acc[dt][2 * h] * sz_row[h], acc[dt][2 * h + 1] * sz_row[h]);
      }
    }
  }
}

// bf16, dk and dv: four warps, warp w owns key rows 16 w .. 16 w + 15 of the
// block's key tile and computes the transposed tiles s^T = k qs^T and
// dp^T = v g^T, so that t^T and e^T come out as the left operands of
// dk += t^T qz and dv += e^T gz.
template <int DP>
__global__ void __launch_bounds__(128) bwd_dkv_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ go,
    const float* __restrict__ stats, const float* __restrict__ crow,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n, int hd, int k_tiles,
    float c, float scale) {
  constexpr int S = DP + 8;
  constexpr int VPR = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const k_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBK][S]
  __nv_bfloat16* const v_s = k_s + kBK * S;                           // [kBK][S]
  __nv_bfloat16* const qs_s = v_s + kBK * S;                          // [kBQ][S], q times c
  __nv_bfloat16* const qz_s = qs_s + kBQ * S;                         // [kBQ][S], q scale / z
  __nv_bfloat16* const g_s = qz_s + kBQ * S;                          // [kBQ][S]
  __nv_bfloat16* const gz_s = g_s + kBQ * S;                          // [kBQ][S], g / z
  float* const m_s = reinterpret_cast<float*>(gz_s + kBQ * S);        // [kBQ]
  float* const c_s = m_s + kBQ;                                       // [kBQ]

  const int bh = blockIdx.x / k_tiles, k0 = (blockIdx.x - bh * k_tiles) * kBK;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int idx = tid; idx < kBK * VPR; idx += 128) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 8;
    uint4 rk = make_uint4(0, 0, 0, 0), rv = make_uint4(0, 0, 0, 0);
    if (k0 + r < n && vc < hd) {
      const size_t off = base + static_cast<size_t>(k0 + r) * hd + vc;
      rk = __ldg(reinterpret_cast<const uint4*>(k + off));
      rv = __ldg(reinterpret_cast<const uint4*>(v + off));
    }
    *reinterpret_cast<uint4*>(k_s + r * S + vc) = rk;
    *reinterpret_cast<uint4*>(v_s + r * S + vc) = rv;
  }

  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dt][e] = acc_v[dt][e] = 0.f;
  const bool live_key[2] = {k0 + warp * 16 + g < n, k0 + warp * 16 + g + 8 < n};

  const int q_tiles = (n + kBQ - 1) / kBQ;
  for (int tile = 0; tile < q_tiles; ++tile) {
    const int q0 = tile * kBQ;
    __syncthreads();  // the last tile's reads are done
    for (int idx = tid; idx < kBQ * VPR; idx += 128) {
      const int r = idx / VPR, vc = (idx - r * VPR) * 8;
      uint4 rqs = make_uint4(0, 0, 0, 0), rqz = rqs, rg = rqs, rgz = rqs;
      if (q0 + r < n && vc < hd) {
        const size_t off = base + static_cast<size_t>(q0 + r) * hd + vc;
        const float zinv = 1.0f / __ldg(stats + 2 * (static_cast<size_t>(bh) * n + q0 + r) + 1);
        const uint4 rq = __ldg(reinterpret_cast<const uint4*>(q + off));
        rg = __ldg(reinterpret_cast<const uint4*>(go + off));
        rqs = scale8(rq, c);
        rqz = scale8(rq, scale * zinv);
        rgz = scale8(rg, zinv);
      }
      *reinterpret_cast<uint4*>(qs_s + r * S + vc) = rqs;
      *reinterpret_cast<uint4*>(qz_s + r * S + vc) = rqz;
      *reinterpret_cast<uint4*>(g_s + r * S + vc) = rg;
      *reinterpret_cast<uint4*>(gz_s + r * S + vc) = rgz;
    }
    if (tid < kBQ) {  // a dead query row: zero operands, shift 0, c 0
      const bool live = q0 + tid < n;
      const size_t row = static_cast<size_t>(bh) * n + q0 + tid;
      m_s[tid] = live ? __ldg(stats + 2 * row) : 0.f;
      c_s[tid] = live ? __ldg(crow + row) : 0.f;
    }
    __syncthreads();

    // s^T = k qs^T and dp^T = v g^T: 16 key rows x 64 queries per warp
    float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t kf[4], vf[4];
      const int a_off = (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8;
      ldmatrix_x4(kf, k_s + a_off);
      ldmatrix_x4(vf, v_s + a_off);
#pragma unroll
      for (int np = 0; np < kBQ / 16; ++np) {
        const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                          ((lane >> 3) & 1) * 8;
        uint32_t r[4];
        ldmatrix_x4(r, qs_s + b_off);
        mma_bf16(st[2 * np], kf, r[0], r[1]);
        mma_bf16(st[2 * np + 1], kf, r[2], r[3]);
        ldmatrix_x4(r, g_s + b_off);
        mma_bf16(dpt[2 * np], vf, r[0], r[1]);
        mma_bf16(dpt[2 * np + 1], vf, r[2], r[3]);
      }
    }

    // st <- t^T = e (dp - c), dpt <- e^T; e = 0 on dead key rows
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        const float ev = live_key[e >> 1] ? exp2f(st[nt][e] - m_s[col]) : 0.f;
        st[nt][e] = ev * (dpt[nt][e] - c_s[col]);
        dpt[nt][e] = ev;
      }

    // acc_k += t^T qz, acc_v += e^T gz (t and e rounded to bf16)
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      const uint32_t pt[4] = {pack_bf16(st[2 * kk][0], st[2 * kk][1]),
                              pack_bf16(st[2 * kk][2], st[2 * kk][3]),
                              pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
                              pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3])};
      const uint32_t pe[4] = {pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
                              pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
                              pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
                              pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < DP / 16; ++dd) {
        const int b_off = (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + dd * 16 +
                          (lane >> 4) * 8;
        uint32_t r[4];
        ldmatrix_x4_trans(r, qz_s + b_off);
        mma_bf16(acc_k[2 * dd], pt, r[0], r[1]);
        mma_bf16(acc_k[2 * dd + 1], pt, r[2], r[3]);
        ldmatrix_x4_trans(r, gz_s + b_off);
        mma_bf16(acc_v[2 * dd], pe, r[0], r[1]);
        mma_bf16(acc_v[2 * dd + 1], pe, r[2], r[3]);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live_key[h]) continue;
    const size_t off = base + static_cast<size_t>(k0 + warp * 16 + g + 8 * h) * hd;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dk + off + col) =
            __floats2bfloat162_rn(acc_k[dt][2 * h], acc_k[dt][2 * h + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + col) =
            __floats2bfloat162_rn(acc_v[dt][2 * h], acc_v[dt][2 * h + 1]);
      }
    }
  }
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
  float* crow;
  void *dq, *dk, *dv;
  int bh, n, hd;
  float c, scale;
  cudaStream_t stream;
};

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP>
cudaError_t launch_bf16(const Args& a) {
  using T = __nv_bfloat16;
  constexpr int kRow = (DP + 8) * (int)sizeof(T);
  constexpr int kSmemQ = (2 * kBQ + 4 * kBK) * kRow;
  constexpr int kSmemKV = (2 * kBK + 4 * kBQ) * kRow + 2 * kBQ * (int)sizeof(float);
  cudaError_t err = allow_smem(bwd_dq_bf16<DP>, kSmemQ);
  if (err != cudaSuccess) return err;
  err = allow_smem(bwd_dkv_bf16<DP>, kSmemKV);
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(a.bh) * a.n;
  rowdot<T><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, a.stream>>>(
      static_cast<const T*>(a.g), static_cast<const T*>(a.o), a.crow, rows, a.hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int tiles = (a.n + kBQ - 1) / kBQ;  // kBQ == kBK
  bwd_dq_bf16<DP><<<a.bh * tiles, 128, kSmemQ, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.stats, a.crow, static_cast<T*>(a.dq), a.n, a.hd, tiles, a.c,
      a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_bf16<DP><<<a.bh * tiles, 128, kSmemKV, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.stats, a.crow, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.n, a.hd, tiles, a.c, a.scale);
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

// C entry point bound with ctypes; returns a cudaError_t code. q, k, v, o, g
// and the outputs dq, dk, dv are (bh, n, hd), contiguous, 16-byte aligned, of
// one dtype (0 = float32, 1 = bfloat16); stats (bh, n, 2) float32 holds each
// row's shift and sum as xmir_vit_attn wrote them; crow is (bh, n) float32
// scratch; hd a multiple of 8 up to 128; c = scale log2(e), already rounded
// to the dtype; scale the softmax scale itself.
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
