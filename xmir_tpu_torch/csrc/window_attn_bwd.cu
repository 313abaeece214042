// Backward of the grouped-bias cosine window attention (K4) for the Swin
// towers on Hopper (sm_90a): dq, dk, dv (BH, N, hd), dbias (G, N, N) f32 and
// each folded row's alpha total (for dscale) of
// out = softmax(norm(q) norm(k)^T scale_g + bias_g) v, row i in group
// (i / g_size) % G.
//
// Replaces K5, xmir_tpu/ops/vit_attn_pallas.py::_biased_bwd_pallas (body
// _bwd_kernel_biased). Its arithmetic, which ops/vit_attn.py::
// biased_attention_bwd_plain writes out: qh, kh = q, k times their inverse
// norms in f32 (with `cosine`), rounded to the input dtype; f32 s_cos = qh kh^T;
// s2 = s_cos (scale_g log2 e) + bias log2 e (two products, one sum, no FMA);
// m the exact row max, e = exp2(s2 - m), z its f32 sum; c = rowsum(g o) and
// dp = g v^T in f32; t = e (dp - c), rounded to the input dtype before both
// of its products; dbias_g += t / z (f32 t) over the group's folded rows in
// their order; dqh = (t kh) (scale_g / z); alpha = rowsum(dqh qh32);
// dq = (dqh - qh32 alpha) / |q|; qz = qh32 scale_g / z and gz = g / z
// rounded; dkh = t^T qz, dk = (dkh - kh32 beta) / |k|; dv = e^T gz on e
// rounded. The backward recomputes its own m and z from its own s2, as the
// TPU kernel does: K4 rounds q times scale log2 e before its product, the
// backward rounds qh alone, so K4's row statistics would not normalise this
// e (and K4 saves none).
//
// What does not carry over from the TPU: there a (1, N, N) f32 dbias block
// stays resident across a group's contiguous grid steps and is added to in
// order. Blocks on the card run in no order, so the work is split in three
// kernels that each own their output; nothing is added up with atomics and
// two runs are bit-equal:
//   dq     one block per (folded row, 64-query tile) streams the window's
//          64-key tiles twice: the exact row max, then z, dp, t and dq. It
//          writes each query row's (m, 1 / z, c, alpha) to `stats`.
//   dk dv  one block per (folded row, 64-key tile) streams the query tiles
//          with those statistics and keeps dk and dv in f32 registers.
//   dbias  one block per (group, 64-query tile, 64-key tile) walks the
//          group's g_size folded rows in order, recomputing s and dp for its
//          tile, and keeps the tile's dbias in f32 registers: a fixed-order
//          reduction with no scratch beyond `stats` (BH N 16 bytes).
// Scores are computed four times and dp three times: 20 BH N^2 hd
// operations against the minimum of 10. The (N, N) tiles never reach device
// memory.
//
// What bounds it on the H100: 10 BH N^2 hd operations against eight
// (BH, N, hd) tensors (q, k, v, o, g in; dq, dk, dv out) and the bias and
// dbias tables moved once: bytes in
// bf16 at Swin-B's shapes, operations in f32. bf16 runs on mma.sync m16n8k16
// (four warps a block), f32 on IEEE f32 FMAs (no TF32), 256 threads with a
// 4 x 4 block each. wgmma, TMA, one pass that shares the scores between the
// three outputs, and sharing the bias tile's loads are later work.
//
// hd is a multiple of 8 up to 64, zero-padded in shared memory to 16, 32 or
// 64; N a multiple of 8 (ragged tiles are masked); BH == G g_size. Launches
// go on the caller's stream and allocate nothing.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;  // query rows or keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

// 1 / max(||x||, 1e-12), as the TPU kernel clamps it
__device__ __forceinline__ float inv_norm(float sum_sq) {
  return 1.f / sqrtf(fmaxf(sum_sq, 1e-24f));
}

// s2 = s_cos (scale_g log2 e) + b log2 e: two roundings, then the sum
__device__ __forceinline__ float logit2(float s, float csc, float b2) {
  return __fadd_rn(__fmul_rn(s, csc), b2);
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// The sum of squares of one bf16 vector of eight, in sequence (each square
// is exact in f32), and of one f32 vector of four.
__device__ __forceinline__ float sumsq8(uint4 raw) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    ss = fmaf(t.x, t.x, ss);
    ss = fmaf(t.y, t.y, ss);
  }
  return ss;
}
__device__ __forceinline__ float sumsq4(float4 f) {
  return fmaf(f.x, f.x, fmaf(f.y, f.y, fmaf(f.z, f.z, f.w * f.w)));
}

// A row's inverse norm: the vectors' sums of squares added in a pairwise
// tree (VPR a power of two), the order in which a row's VPR neighbouring
// lanes add them with xor shuffles in the loaders below. In bf16 this is
// ops/vit_attn.py::sum_squares bit for bit.
template <int DP>
__device__ float row_inv_norm(const bf16* row, int hd) {
  constexpr int VPR = DP / 8;
  float part[VPR];
#pragma unroll
  for (int v = 0; v < VPR; ++v) {
    part[v] = v * 8 < hd ? sumsq8(__ldg(reinterpret_cast<const uint4*>(row + v * 8))) : 0.f;
  }
#pragma unroll
  for (int w = 1; w < VPR; w <<= 1)
#pragma unroll
    for (int v = 0; v < VPR; v += 2 * w) part[v] += part[v + w];
  return inv_norm(part[0]);
}
template <int DP>
__device__ float row_inv_norm(const float* row, int hd) {
  constexpr int VPR = DP / 4;
  float part[VPR];
#pragma unroll
  for (int v = 0; v < VPR; ++v) {
    part[v] = v * 4 < hd ? sumsq4(__ldg(reinterpret_cast<const float4*>(row + v * 4))) : 0.f;
  }
#pragma unroll
  for (int w = 1; w < VPR; w <<= 1)
#pragma unroll
    for (int v = 0; v < VPR; v += 2 * w) part[v] += part[v + w];
  return inv_norm(part[0]);
}

// Rows [row0, row0 + rows) of an (n, hd) matrix into shared memory: element
// x becomes (x rn) factor(row), two f32 products, then (bf16) one rounding;
// rn is the row's inverse norm with `normalise`, else 1. Dead rows and a
// head's padding are zeros. The DP / 8 (bf16) or DP / 4 (f32) lanes of a row
// are neighbours and rows * lanes is a multiple of 32, so whole warps take
// each step of the shuffles.
template <int DP, typename F>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0, int rows, int n,
                                          int hd, bool normalise, F factor, int tid,
                                          int n_threads) {
  constexpr int S = DP + 8, VPR = DP / 8;
  for (int idx = tid; idx < rows * VPR; idx += n_threads) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 8;
    const bool live = row0 + r < n;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (live && vc < hd) {
      raw = __ldg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * hd + vc));
    }
    float rn = 1.f;
    if (normalise) {
      float ss = sumsq8(raw);
#pragma unroll
      for (int off = 1; off < VPR; off <<= 1) ss += __shfl_xor_sync(kFull, ss, off);
      rn = inv_norm(ss);
    }
    const float fac = live ? factor(row0 + r) : 0.f;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(p[i]);
      p[i] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(t.x, rn), fac),
                                   __fmul_rn(__fmul_rn(t.y, rn), fac));
    }
    *reinterpret_cast<uint4*>(dst + r * S + vc) = raw;
  }
}
template <int DP, typename F>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows, int n,
                                          int hd, bool normalise, F factor, int tid,
                                          int n_threads) {
  constexpr int SQ = DP + 1, VPR = DP / 4;
  for (int idx = tid; idx < rows * VPR; idx += n_threads) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 4;
    const bool live = row0 + r < n;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && vc < hd) {
      f = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(row0 + r) * hd + vc));
    }
    float rn = 1.f;
    if (normalise) {
      float ss = sumsq4(f);
#pragma unroll
      for (int off = 1; off < VPR; off <<= 1) ss += __shfl_xor_sync(kFull, ss, off);
      rn = inv_norm(ss);
    }
    const float fac = live ? factor(row0 + r) : 0.f;
    float* d = dst + r * SQ + vc;
    d[0] = __fmul_rn(__fmul_rn(f.x, rn), fac);
    d[1] = __fmul_rn(__fmul_rn(f.y, rn), fac);
    d[2] = __fmul_rn(__fmul_rn(f.z, rn), fac);
    d[3] = __fmul_rn(__fmul_rn(f.w, rn), fac);
  }
}

struct Params {
  const void *q, *k, *v, *o, *g;
  const float *bias, *scale;
  float4* stats;  // (bh, n): m, 1 / z, c, alpha of each query row
  void *dq, *dk, *dv;
  float* dbias;
  int n, hd, tiles, g_size, n_groups;
};

__device__ __forceinline__ int group_of(const Params& p, int bh) {
  return (bh / p.g_size) % p.n_groups;
}

// ---------------------------------------------------------------------------
// bf16: four warps; warp w owns tile rows 16 w .. 16 w + 15. In the m16n8
// fragments a thread holds rows g = lane / 4 and g + 8, columns 2 (lane % 4)
// and + 1 of every 8-column tile.

// s (+)= A B^T for 16 rows of A (fragments af) against the 64 rows of b_s
template <int DP>
__device__ __forceinline__ void mma_tile(float (&s)[kT / 8][4], const uint32_t (&af)[DP / 16][4],
                                         const bf16* b_s, int lane) {
  constexpr int S = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kT / 16; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, b_s + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                         ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], af[kk], r[0], r[1]);
      mma_bf16(s[2 * np + 1], af[kk], r[2], r[3]);
    }
  }
}

// acc += P (64 columns, rounded to bf16) . b_s (64 rows x DP)
template <int DP>
__device__ __forceinline__ void mma_acc(float (&acc)[DP / 8][4], const float (&p)[kT / 8][4],
                                        const bf16* b_s, int lane) {
  constexpr int S = DP + 8;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dd = 0; dd < DP / 16; ++dd) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, b_s + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + dd * 16 +
                               (lane >> 4) * 8);
      mma_bf16(acc[2 * dd], pa, r[0], r[1]);
      mma_bf16(acc[2 * dd + 1], pa, r[2], r[3]);
    }
  }
}

template <int DP>
__device__ __forceinline__ void load_frags(uint32_t (&f)[DP / 16][4], const bf16* a_s, int warp,
                                           int lane) {
  constexpr int S = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ldmatrix_x4(f[kk], a_s + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
  }
}

template <int DP>
__device__ __forceinline__ void zero(float (&a)[DP][4]) {
#pragma unroll
  for (int i = 0; i < DP; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = 0.f;
}

// dq and the row statistics
template <int DP, bool COS>
__global__ void __launch_bounds__(128) dq_bf16(Params p) {
  constexpr int S = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const q_s = reinterpret_cast<bf16*>(smem);  // [kT][S] qh
  bf16* const g_s = q_s + kT * S;                    // [kT][S]
  bf16* const k_s = g_s + kT * S;                    // [kT][S] kh of a key tile
  bf16* const v_s = k_s + kT * S;                    // [kT][S]
  const bf16 *q = static_cast<const bf16*>(p.q), *k = static_cast<const bf16*>(p.k),
             *v = static_cast<const bf16*>(p.v), *o = static_cast<const bf16*>(p.o),
             *go = static_cast<const bf16*>(p.g);
  const int n = p.n, hd = p.hd;
  const int bh = blockIdx.x / p.tiles, q0 = (blockIdx.x - bh * p.tiles) * kT;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int group = group_of(p, bh);
  const float sc = p.scale[group], csc = __fmul_rn(sc, kLog2e);
  const float* const bias_g = p.bias + static_cast<size_t>(group) * n * n;
  auto one = [](int) { return 1.f; };

  load_rows<DP>(q_s, q + base, q0, kT, n, hd, COS, one, tid, 128);
  load_rows<DP>(g_s, go + base, q0, kT, n, hd, false, one, tid, 128);
  int row[2];
  const float* b_row[2];
  float c_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + warp * 16 + g + 8 * h;
    b_row[h] = bias_g + static_cast<size_t>(min(row[h], n - 1)) * n;
    float sum = 0.f;  // c = rowsum(g o), the quad's four lanes sharing the row
    if (row[h] < n) {
      const size_t off = base + static_cast<size_t>(row[h]) * hd;
      for (int d = t; d < hd; d += 4) sum = fmaf(bf(go[off + d]), bf(o[off + d]), sum);
    }
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    c_row[h] = sum;
  }
  __syncthreads();
  uint32_t qf[DP / 16][4], gf[DP / 16][4];
  load_frags<DP>(qf, q_s, warp, lane);
  load_frags<DP>(gf, g_s, warp, lane);

  // the strip's logits against key tile `tile` (staged in k_s), dead keys -inf
  auto logits = [&](int tile, float (&s)[kT / 8][4]) {
    zero<kT / 8>(s);
    mma_tile<DP>(s, qf, k_s, lane);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
      const int col = tile * kT + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 b = make_float2(0.f, 0.f);
        if (col < n) b = __ldg(reinterpret_cast<const float2*>(b_row[h] + col));
        s[nt][2 * h] = col < n ? logit2(s[nt][2 * h], csc, __fmul_rn(b.x, kLog2e)) : -INFINITY;
        s[nt][2 * h + 1] =
            col + 1 < n ? logit2(s[nt][2 * h + 1], csc, __fmul_rn(b.y, kLog2e)) : -INFINITY;
      }
    }
  };

  const int tiles = p.tiles;
  float m[2] = {-INFINITY, -INFINITY};
  for (int tile = 0; tile < tiles; ++tile) {  // pass 1: the exact row max
    __syncthreads();
    load_rows<DP>(k_s, k + base, tile * kT, kT, n, hd, COS, one, tid, 128);
    __syncthreads();
    float s[kT / 8][4];
    logits(tile, s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kT / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      m[h] = fmaxf(m[h], mx);
    }
  }

  float z[2] = {0.f, 0.f};
  float acc[DP / 8][4];
  zero<DP / 8>(acc);
  for (int tile = 0; tile < tiles; ++tile) {  // pass 2: z, t and t kh
    __syncthreads();
    load_rows<DP>(k_s, k + base, tile * kT, kT, n, hd, COS, one, tid, 128);
    load_rows<DP>(v_s, v + base, tile * kT, kT, n, hd, false, one, tid, 128);
    __syncthreads();
    float s[kT / 8][4], dp[kT / 8][4];
    logits(tile, s);
    zero<kT / 8>(dp);
    mma_tile<DP>(dp, gf, v_s, lane);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float ev = exp2f(s[nt][e] - m[h]);  // 0 on dead keys
        z[h] += ev;
        s[nt][e] = ev * (dp[nt][e] - c_row[h]);
      }
    mma_acc<DP>(acc, s, k_s, lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    z[h] += __shfl_xor_sync(kFull, z[h], 1);
    z[h] += __shfl_xor_sync(kFull, z[h], 2);
    const bool live = row[h] < n;
    const float zinv = 1.f / z[h], szr = __fmul_rn(sc, zinv);
    const size_t off = base + static_cast<size_t>(min(row[h], n - 1)) * hd;
    const float qinv = COS && live ? row_inv_norm<DP>(q + off, hd) : 1.f;
    float qh[DP / 8][2], dqh[DP / 8][2], a = 0.f;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = dt * 8 + 2 * t + u;
        const float x = live && col < hd ? bf(q[off + col]) : 0.f;
        qh[dt][u] = COS ? __fmul_rn(x, qinv) : x;
        dqh[dt][u] = __fmul_rn(acc[dt][2 * h + u], szr);
        a = __fadd_rn(a, __fmul_rn(dqh[dt][u], qh[dt][u]));
      }
    a += __shfl_xor_sync(kFull, a, 1);
    a += __shfl_xor_sync(kFull, a, 2);
    if (!live) continue;
    bf16* dst = static_cast<bf16*>(p.dq) + off;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col >= hd) continue;
      float r2[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        r2[u] = COS ? __fmul_rn(__fsub_rn(dqh[dt][u], __fmul_rn(qh[dt][u], a)), qinv)
                    : dqh[dt][u];
      }
      *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(r2[0], r2[1]);
    }
    if (t == 0) p.stats[static_cast<size_t>(bh) * n + row[h]] = make_float4(m[h], zinv, c_row[h], a);
  }
}

// dk and dv: warp w owns key rows 16 w .. 16 w + 15 of the block's key tile
// and computes the transposed tiles s^T = kh qh^T and dp^T = v g^T, so that
// t^T and e^T come out as the left operands of dkh += t^T qz, dv += e^T gz.
template <int DP, bool COS>
__global__ void __launch_bounds__(128) dkv_bf16(Params p) {
  constexpr int S = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const k_s = reinterpret_cast<bf16*>(smem);  // [kT][S] kh
  bf16* const v_s = k_s + kT * S;                    // [kT][S]
  bf16* const qh_s = v_s + kT * S;                   // [kT][S] qh
  bf16* const qz_s = qh_s + kT * S;                  // [kT][S] qh32 scale / z
  bf16* const g_s = qz_s + kT * S;                   // [kT][S]
  bf16* const gz_s = g_s + kT * S;                   // [kT][S] g / z
  float* const m_s = reinterpret_cast<float*>(gz_s + kT * S);  // [kT]
  float* const c_s = m_s + kT;                                 // [kT]
  const bf16 *q = static_cast<const bf16*>(p.q), *k = static_cast<const bf16*>(p.k),
             *v = static_cast<const bf16*>(p.v), *go = static_cast<const bf16*>(p.g);
  const int n = p.n, hd = p.hd;
  const int bh = blockIdx.x / p.tiles, k0 = (blockIdx.x - bh * p.tiles) * kT;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int group = group_of(p, bh);
  const float sc = p.scale[group], csc = __fmul_rn(sc, kLog2e);
  const float* const bias_g = p.bias + static_cast<size_t>(group) * n * n;
  const float4* const st = p.stats + static_cast<size_t>(bh) * n;
  auto one = [](int) { return 1.f; };
  auto zinv = [&](int r) { return st[r].y; };
  auto szinv = [&](int r) { return __fmul_rn(sc, st[r].y); };

  load_rows<DP>(k_s, k + base, k0, kT, n, hd, COS, one, tid, 128);
  load_rows<DP>(v_s, v + base, k0, kT, n, hd, false, one, tid, 128);
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float acc_k[DP / 8][4], acc_v[DP / 8][4];
  zero<DP / 8>(acc_k);
  zero<DP / 8>(acc_v);
  __syncthreads();
  uint32_t kf[DP / 16][4], vf[DP / 16][4];
  load_frags<DP>(kf, k_s, warp, lane);
  load_frags<DP>(vf, v_s, warp, lane);

  for (int tile = 0; tile < p.tiles; ++tile) {
    const int q0 = tile * kT;
    __syncthreads();  // the last tile's reads are done
    load_rows<DP>(qh_s, q + base, q0, kT, n, hd, COS, one, tid, 128);
    load_rows<DP>(qz_s, q + base, q0, kT, n, hd, COS, szinv, tid, 128);
    load_rows<DP>(g_s, go + base, q0, kT, n, hd, false, one, tid, 128);
    load_rows<DP>(gz_s, go + base, q0, kT, n, hd, false, zinv, tid, 128);
    if (tid < kT) {  // a dead query row: shift 0, c 0
      const bool live = q0 + tid < n;
      m_s[tid] = live ? st[q0 + tid].x : 0.f;
      c_s[tid] = live ? st[q0 + tid].z : 0.f;
    }
    __syncthreads();
    float s[kT / 8][4], dp[kT / 8][4];
    zero<kT / 8>(s);
    zero<kT / 8>(dp);
    mma_tile<DP>(s, kf, qh_s, lane);
    mma_tile<DP>(dp, vf, g_s, lane);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1), kr = key[e >> 1];
        float ev = 0.f;
        if (kr < n && q0 + col < n) {
          const float b2 = __fmul_rn(__ldg(bias_g + static_cast<size_t>(q0 + col) * n + kr), kLog2e);
          ev = exp2f(logit2(s[nt][e], csc, b2) - m_s[col]);
        }
        s[nt][e] = ev * (dp[nt][e] - c_s[col]);
        dp[nt][e] = ev;
      }
    mma_acc<DP>(acc_k, s, qz_s, lane);
    mma_acc<DP>(acc_v, dp, gz_s, lane);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = key[h] < n;
    const size_t off = base + static_cast<size_t>(min(key[h], n - 1)) * hd;
    const float kinv = COS && live ? row_inv_norm<DP>(k + off, hd) : 1.f;
    float kh[DP / 8][2], b = 0.f;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = dt * 8 + 2 * t + u;
        const float x = live && col < hd ? bf(k[off + col]) : 0.f;
        kh[dt][u] = COS ? __fmul_rn(x, kinv) : x;
        b = __fadd_rn(b, __fmul_rn(acc_k[dt][2 * h + u], kh[dt][u]));
      }
    b += __shfl_xor_sync(kFull, b, 1);
    b += __shfl_xor_sync(kFull, b, 2);
    if (!live) continue;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col >= hd) continue;
      float r2[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float dkh = acc_k[dt][2 * h + u];
        r2[u] = COS ? __fmul_rn(__fsub_rn(dkh, __fmul_rn(kh[dt][u], b)), kinv) : dkh;
      }
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dk) + off + col) =
          __floats2bfloat162_rn(r2[0], r2[1]);
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.dv) + off + col) =
          __floats2bfloat162_rn(acc_v[dt][2 * h], acc_v[dt][2 * h + 1]);
    }
  }
}

// dbias: one (group, query tile, key tile) block walks the group's folded
// rows in order; the tile's sum stays in registers
template <int DP, bool COS>
__global__ void __launch_bounds__(128) dbias_bf16(Params p) {
  constexpr int S = DP + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const q_s = reinterpret_cast<bf16*>(smem);
  bf16* const g_s = q_s + kT * S;
  bf16* const k_s = g_s + kT * S;
  bf16* const v_s = k_s + kT * S;
  const bf16 *q = static_cast<const bf16*>(p.q), *k = static_cast<const bf16*>(p.k),
             *v = static_cast<const bf16*>(p.v), *go = static_cast<const bf16*>(p.g);
  const int n = p.n, hd = p.hd, tiles = p.tiles;
  const int group = blockIdx.x / (tiles * tiles), rest = blockIdx.x - group * tiles * tiles;
  const int q0 = rest / tiles * kT, k0 = (rest % tiles) * kT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const float csc = __fmul_rn(p.scale[group], kLog2e);
  const size_t tab = static_cast<size_t>(group) * n * n;
  auto one = [](int) { return 1.f; };
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float b2[kT / 8][4], acc[kT / 8][4];
#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + 2 * t + (e & 1), r = row[e >> 1];
      b2[nt][e] = r < n && col < n ? __fmul_rn(__ldg(p.bias + tab + static_cast<size_t>(r) * n + col),
                                              kLog2e)
                                   : 0.f;
      acc[nt][e] = 0.f;
    }
  for (int j = 0; j < p.g_size; ++j) {
    const int bh = group * p.g_size + j;
    const size_t base = static_cast<size_t>(bh) * n * hd;
    __syncthreads();
    load_rows<DP>(q_s, q + base, q0, kT, n, hd, COS, one, tid, 128);
    load_rows<DP>(g_s, go + base, q0, kT, n, hd, false, one, tid, 128);
    load_rows<DP>(k_s, k + base, k0, kT, n, hd, COS, one, tid, 128);
    load_rows<DP>(v_s, v + base, k0, kT, n, hd, false, one, tid, 128);
    __syncthreads();
    uint32_t af[DP / 16][4];
    float s[kT / 8][4], dp[kT / 8][4];
    zero<kT / 8>(s);
    zero<kT / 8>(dp);
    load_frags<DP>(af, q_s, warp, lane);
    mma_tile<DP>(s, af, k_s, lane);
    load_frags<DP>(af, g_s, warp, lane);
    mma_tile<DP>(dp, af, v_s, lane);
    float4 rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] = row[h] < n ? p.stats[static_cast<size_t>(bh) * n + row[h]]
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 r = rs[e >> 1];
        const bool live = row[e >> 1] < n && k0 + nt * 8 + 2 * t + (e & 1) < n;
        const float ev = live ? exp2f(logit2(s[nt][e], csc, b2[nt][e]) - r.x) : 0.f;
        acc[nt][e] = __fadd_rn(acc[nt][e], __fmul_rn(ev * (dp[nt][e] - r.z), r.y));
      }
  }
#pragma unroll
  for (int nt = 0; nt < kT / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = k0 + nt * 8 + 2 * t;
      if (row[h] < n && col < n) {
        *reinterpret_cast<float2*>(p.dbias + tab + static_cast<size_t>(row[h]) * n + col) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// f32: thread (ty, tx) = (tid / 16, tid % 16) owns tile rows ty + 16 i
// (i < 4), columns tx + 16 j (j < 4) of a 64 x 64 score tile and output
// columns tx + 16 j (j < DP / 16). The 16 threads of a row are half a warp.

// s = A B^T: rows ty + 16 i of a_s against rows tx + 16 j of b_s
template <int DP>
__device__ __forceinline__ void fma_tile(float (&s)[4][4], const float* a_s, const float* b_s,
                                         int ty, int tx) {
  constexpr int SQ = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < DP; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a_s[(ty + 16 * i) * SQ + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b_s[(tx + 16 * j) * SQ + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_kk p_s[ty + 16 i][kk] b_s[kk][tx + 16 j]
template <int DP>
__device__ __forceinline__ void fma_acc(float (&acc)[4][DP / 16], const float* p_s,
                                        const float* b_s, int ty, int tx) {
  constexpr int SQ = DP + 1, SP = kT + 1;
#pragma unroll 4
  for (int kk = 0; kk < kT; ++kk) {
    float pv[4], bv[DP / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * SP + kk];
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) bv[j] = b_s[kk * SQ + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DP / 16; ++j) acc[i][j] = fmaf(pv[i], bv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int DP, bool COS>
__global__ void __launch_bounds__(256) dq_f32(Params p) {
  constexpr int SQ = DP + 1, SP = kT + 1, DJ = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const q_s = reinterpret_cast<float*>(smem);  // [kT][SQ] qh
  float* const g_s = q_s + kT * SQ;
  float* const k_s = g_s + kT * SQ;
  float* const v_s = k_s + kT * SQ;
  float* const p_s = v_s + kT * SQ;  // [kT][SP] t
  const float *q = static_cast<const float*>(p.q), *k = static_cast<const float*>(p.k),
              *v = static_cast<const float*>(p.v), *o = static_cast<const float*>(p.o),
              *go = static_cast<const float*>(p.g);
  const int n = p.n, hd = p.hd;
  const int bh = blockIdx.x / p.tiles, q0 = (blockIdx.x - bh * p.tiles) * kT;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int group = group_of(p, bh);
  const float sc = p.scale[group], csc = __fmul_rn(sc, kLog2e);
  const float* const bias_g = p.bias + static_cast<size_t>(group) * n * n;
  auto one = [](int) { return 1.f; };

  load_rows<DP>(q_s, q + base, q0, kT, n, hd, COS, one, tid, 256);
  load_rows<DP>(g_s, go + base, q0, kT, n, hd, false, one, tid, 256);
  int row[4];
  const float* b_row[4];
  float c_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty + 16 * i;
    b_row[i] = bias_g + static_cast<size_t>(min(row[i], n - 1)) * n;
    float sum = 0.f;
    if (row[i] < n) {
      const size_t off = base + static_cast<size_t>(row[i]) * hd;
      for (int d = tx; d < hd; d += 16) sum = fmaf(go[off + d], o[off + d], sum);
    }
    c_row[i] = half_warp_sum(sum);
  }

  auto logits = [&](int tile, float (&s)[4][4]) {
    fma_tile<DP>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tile * kT + tx + 16 * j;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][j] = col < n ? logit2(s[i][j], csc, __fmul_rn(__ldg(b_row[i] + col), kLog2e))
                          : -INFINITY;
      }
    }
  };

  const int tiles = p.tiles;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int tile = 0; tile < tiles; ++tile) {  // pass 1
    __syncthreads();
    load_rows<DP>(k_s, k + base, tile * kT, kT, n, hd, COS, one, tid, 256);
    __syncthreads();
    float s[4][4];
    logits(tile, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      m[i] = fmaxf(m[i], mx);
    }
  }

  float z[4] = {0.f, 0.f, 0.f, 0.f}, acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {  // pass 2
    __syncthreads();
    load_rows<DP>(k_s, k + base, tile * kT, kT, n, hd, COS, one, tid, 256);
    load_rows<DP>(v_s, v + base, tile * kT, kT, n, hd, false, one, tid, 256);
    __syncthreads();
    float s[4][4], dp[4][4];
    logits(tile, s);
    fma_tile<DP>(dp, g_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float ev = exp2f(s[i][j] - m[i]);
        z[i] += ev;
        p_s[(ty + 16 * i) * SP + tx + 16 * j] = ev * (dp[i][j] - c_row[i]);
      }
    __syncwarp();  // a row's t is written and read by the same half warp
    fma_acc<DP>(acc, p_s, k_s, ty, tx);
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float zinv = 1.f / half_warp_sum(z[i]), szr = __fmul_rn(sc, zinv);
    const bool live = row[i] < n;
    const size_t off = base + static_cast<size_t>(min(row[i], n - 1)) * hd;
    const float qinv = COS && live ? row_inv_norm<DP>(q + off, hd) : 1.f;
    float qh[DJ], dqh[DJ], a = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      const float x = live && col < hd ? q[off + col] : 0.f;
      qh[j] = COS ? __fmul_rn(x, qinv) : x;
      dqh[j] = __fmul_rn(acc[i][j], szr);
      a = __fadd_rn(a, __fmul_rn(dqh[j], qh[j]));
    }
    a = half_warp_sum(a);
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) {
        static_cast<float*>(p.dq)[off + col] =
            COS ? __fmul_rn(__fsub_rn(dqh[j], __fmul_rn(qh[j], a)), qinv) : dqh[j];
      }
    }
    if (tx == 0) p.stats[static_cast<size_t>(bh) * n + row[i]] = make_float4(m[i], zinv, c_row[i], a);
  }
}

// dk and dv: key rows ty + 16 i of the block's tile, query columns tx + 16 j
// of the transposed tiles
template <int DP, bool COS>
__global__ void __launch_bounds__(256) dkv_f32(Params p) {
  constexpr int SQ = DP + 1, SP = kT + 1, DJ = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const k_s = reinterpret_cast<float*>(smem);  // [kT][SQ] kh
  float* const v_s = k_s + kT * SQ;
  float* const qh_s = v_s + kT * SQ;
  float* const qz_s = qh_s + kT * SQ;
  float* const g_s = qz_s + kT * SQ;
  float* const gz_s = g_s + kT * SQ;
  float* const pt_s = gz_s + kT * SQ;  // [kT][SP] t^T
  float* const pe_s = pt_s + kT * SP;  // [kT][SP] e^T
  float* const m_s = pe_s + kT * SP;   // [kT]
  float* const c_s = m_s + kT;         // [kT]
  const float *q = static_cast<const float*>(p.q), *k = static_cast<const float*>(p.k),
              *v = static_cast<const float*>(p.v), *go = static_cast<const float*>(p.g);
  const int n = p.n, hd = p.hd;
  const int bh = blockIdx.x / p.tiles, k0 = (blockIdx.x - bh * p.tiles) * kT;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int group = group_of(p, bh);
  const float sc = p.scale[group], csc = __fmul_rn(sc, kLog2e);
  const float* const bias_g = p.bias + static_cast<size_t>(group) * n * n;
  const float4* const st = p.stats + static_cast<size_t>(bh) * n;
  auto one = [](int) { return 1.f; };
  auto zinv = [&](int r) { return st[r].y; };
  auto szinv = [&](int r) { return __fmul_rn(sc, st[r].y); };

  load_rows<DP>(k_s, k + base, k0, kT, n, hd, COS, one, tid, 256);
  load_rows<DP>(v_s, v + base, k0, kT, n, hd, false, one, tid, 256);
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int tile = 0; tile < p.tiles; ++tile) {
    const int q0 = tile * kT;
    __syncthreads();
    load_rows<DP>(qh_s, q + base, q0, kT, n, hd, COS, one, tid, 256);
    load_rows<DP>(qz_s, q + base, q0, kT, n, hd, COS, szinv, tid, 256);
    load_rows<DP>(g_s, go + base, q0, kT, n, hd, false, one, tid, 256);
    load_rows<DP>(gz_s, go + base, q0, kT, n, hd, false, zinv, tid, 256);
    if (tid < kT) {
      const bool live = q0 + tid < n;
      m_s[tid] = live ? st[q0 + tid].x : 0.f;
      c_s[tid] = live ? st[q0 + tid].z : 0.f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    fma_tile<DP>(s, k_s, qh_s, ty, tx);
    fma_tile<DP>(dp, v_s, g_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kr = k0 + ty + 16 * i, col = tx + 16 * j;
        float ev = 0.f;
        if (kr < n && q0 + col < n) {
          const float b2 = __fmul_rn(__ldg(bias_g + static_cast<size_t>(q0 + col) * n + kr), kLog2e);
          ev = exp2f(logit2(s[i][j], csc, b2) - m_s[col]);
        }
        pt_s[(ty + 16 * i) * SP + col] = ev * (dp[i][j] - c_s[col]);
        pe_s[(ty + 16 * i) * SP + col] = ev;
      }
    __syncwarp();  // a key row's t and e are written and read by the same half warp
    fma_acc<DP>(acc_k, pt_s, qz_s, ty, tx);
    fma_acc<DP>(acc_v, pe_s, gz_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    const bool live = kr < n;
    const size_t off = base + static_cast<size_t>(min(kr, n - 1)) * hd;
    const float kinv = COS && live ? row_inv_norm<DP>(k + off, hd) : 1.f;
    float kh[DJ], b = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      const float x = live && col < hd ? k[off + col] : 0.f;
      kh[j] = COS ? __fmul_rn(x, kinv) : x;
      b = __fadd_rn(b, __fmul_rn(acc_k[i][j], kh[j]));
    }
    b = half_warp_sum(b);
    if (!live) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) {
        static_cast<float*>(p.dk)[off + col] =
            COS ? __fmul_rn(__fsub_rn(acc_k[i][j], __fmul_rn(kh[j], b)), kinv) : acc_k[i][j];
        static_cast<float*>(p.dv)[off + col] = acc_v[i][j];
      }
    }
  }
}

template <int DP, bool COS>
__global__ void __launch_bounds__(256) dbias_f32(Params p) {
  constexpr int SQ = DP + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const q_s = reinterpret_cast<float*>(smem);
  float* const g_s = q_s + kT * SQ;
  float* const k_s = g_s + kT * SQ;
  float* const v_s = k_s + kT * SQ;
  const float *q = static_cast<const float*>(p.q), *k = static_cast<const float*>(p.k),
              *v = static_cast<const float*>(p.v), *go = static_cast<const float*>(p.g);
  const int n = p.n, hd = p.hd, tiles = p.tiles;
  const int group = blockIdx.x / (tiles * tiles), rest = blockIdx.x - group * tiles * tiles;
  const int q0 = rest / tiles * kT, k0 = (rest % tiles) * kT;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float csc = __fmul_rn(p.scale[group], kLog2e);
  const size_t tab = static_cast<size_t>(group) * n * n;
  auto one = [](int) { return 1.f; };
  float b2[4][4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
      b2[i][j] = r < n && col < n
                     ? __fmul_rn(__ldg(p.bias + tab + static_cast<size_t>(r) * n + col), kLog2e)
                     : 0.f;
      acc[i][j] = 0.f;
    }
  for (int jb = 0; jb < p.g_size; ++jb) {
    const int bh = group * p.g_size + jb;
    const size_t base = static_cast<size_t>(bh) * n * hd;
    __syncthreads();
    load_rows<DP>(q_s, q + base, q0, kT, n, hd, COS, one, tid, 256);
    load_rows<DP>(g_s, go + base, q0, kT, n, hd, false, one, tid, 256);
    load_rows<DP>(k_s, k + base, k0, kT, n, hd, COS, one, tid, 256);
    load_rows<DP>(v_s, v + base, k0, kT, n, hd, false, one, tid, 256);
    __syncthreads();
    float s[4][4], dp[4][4];
    fma_tile<DP>(s, q_s, k_s, ty, tx);
    fma_tile<DP>(dp, g_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const float4 rs = r < n ? p.stats[static_cast<size_t>(bh) * n + r]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool live = r < n && k0 + tx + 16 * j < n;
        const float ev = live ? exp2f(logit2(s[i][j], csc, b2[i][j]) - rs.x) : 0.f;
        acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(ev * (dp[i][j] - rs.z), rs.y));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
      if (r < n && col < n) p.dbias[tab + static_cast<size_t>(r) * n + col] = acc[i][j];
    }
}

template <typename K>
cudaError_t launch(K kernel, int blocks, int threads, int smem, cudaStream_t stream,
                   const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DP, bool COS>
cudaError_t launch_all(int dtype, int bh, const Params& p, cudaStream_t stream) {
  const int rows = bh * p.tiles, tables = p.n_groups * p.tiles * p.tiles;
  cudaError_t err;
  if (dtype == 1) {
    constexpr int kTile = kT * (DP + 8) * (int)sizeof(bf16);
    err = launch(dq_bf16<DP, COS>, rows, 128, 4 * kTile, stream, p);
    if (err != cudaSuccess) return err;
    err = launch(dkv_bf16<DP, COS>, rows, 128, 6 * kTile + 2 * kT * (int)sizeof(float), stream, p);
    if (err != cudaSuccess) return err;
    return launch(dbias_bf16<DP, COS>, tables, 128, 4 * kTile, stream, p);
  }
  constexpr int kTile = kT * (DP + 1) * (int)sizeof(float);
  constexpr int kP = kT * (kT + 1) * (int)sizeof(float);
  err = launch(dq_f32<DP, COS>, rows, 256, 4 * kTile + kP, stream, p);
  if (err != cudaSuccess) return err;
  err = launch(dkv_f32<DP, COS>, rows, 256, 6 * kTile + 2 * kP + 2 * kT * (int)sizeof(float),
               stream, p);
  if (err != cudaSuccess) return err;
  return launch(dbias_f32<DP, COS>, tables, 256, 4 * kTile, stream, p);
}

template <int DP>
cudaError_t launch_width(int dtype, int cosine, int bh, const Params& p, cudaStream_t stream) {
  return cosine ? launch_all<DP, true>(dtype, bh, p, stream)
                : launch_all<DP, false>(dtype, bh, p, stream);
}

}  // namespace

// C entry point bound with ctypes; returns a cudaError_t code. q, k, v, o, g
// and the outputs dq, dk, dv are (bh, n, hd), contiguous, 16-byte aligned, of
// one dtype (0 = float32, 1 = bfloat16); bias and the output dbias (groups, n,
// n) float32; scale (groups,) float32; stats (bh, n, 4) float32, written with
// each query row's (m, 1 / z, c, alpha). hd a multiple of 8 up to 64, n a
// multiple of 8, bh == groups * g_size. Three kernels, in order.
extern "C" int xmir_window_attn_bwd(const void* q, const void* k, const void* v, const void* o,
                                    const void* g, const float* bias, const float* scale,
                                    void* stats, void* dq, void* dk, void* dv, float* dbias,
                                    int dtype, int cosine, int bh, int n, int hd, int groups,
                                    int g_size, void* stream) {
  if ((dtype != 0 && dtype != 1) || n < 8 || n % 8 != 0 || hd < 8 || hd > 64 || hd % 8 != 0 ||
      groups < 1 || g_size < 1 || static_cast<long long>(groups) * g_size != bh) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (n + kT - 1) / kT;
  if (static_cast<long long>(bh) * tiles > 2147483647LL ||
      static_cast<long long>(groups) * tiles * tiles > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  const Params p{q, k, v, o, g, bias, scale, static_cast<float4*>(stats), dq, dk, dv, dbias,
                 n, hd, tiles, g_size, groups};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 16) return (int)launch_width<16>(dtype, cosine, bh, p, s);
  if (hd <= 32) return (int)launch_width<32>(dtype, cosine, bh, p, s);
  return (int)launch_width<64>(dtype, cosine, bh, p, s);
}
