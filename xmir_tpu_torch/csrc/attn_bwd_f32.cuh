// The f32 routes of the attention backwards K3 (vit_attn_bwd.cu) and K5
// (window_attn_bwd.cu) on Hopper (sm_90a): the pieces their main kernels
// share. Both walk units of (row, 64 keys): the unit's keys and values stay
// resident, two consumer warpgroups take the row's query tiles of QB rows in
// turns from a ring that a producer warp fills by the copy engine (TMA); per
// query tile every score and dp is formed once and feeds dv, dk (accumulated
// in registers over the unit, the two warpgroups' parts added in a fixed
// order at its end) and the unit's dq part (added into an f32 sum in a fixed
// order by a dq warp per ring stage). The scores (and K3's dp) run on the
// CUDA cores' FMAs, whose operands come from shared memory: two warpgroups
// keep two warps on each scheduler.
//
// Arithmetic. dv, dk and dq (and K5's dp) on the tensor cores in 3xTF32
// (wgmma .tf32): x = big + small with big = x itself (a TF32 product reads
// its sign, exponent and top 10 mantissa bits, x with its 13 low bits
// cleared) and small = tf32_small(x); big . big + big . small + small . big
// misses small . small and the two small parts' roundings, below 2^-19 of
// |x y| a product (about 2^-20 at worst on random operands), against 2^-24
// of an FMA; the tensor cores' own sums truncate, coarser again. The scores
// stay on IEEE FMAs in K2's order (kScoreTerms 0): e = exp2(s - m) turns an
// absolute error of s into a relative error of e, and 3xTF32 scores moved
// K3's gradients past the f32 bounds at logits below -128 (PERF.md). kScoreTerms and kProductTerms name the terms taken
// (chip_faults.py plants 2 and 1, and the scores on 3xTF32).
//
// Operand layouts (TF32 takes no transpose: both shared operands K-major):
//   dp^T = v g^T                 M = the unit's 64 keys, N = QB queries, depth
//                                hd: A the resident [64][DP] tile, B the
//                                streamed [QB][DP] tile (big and small each;
//                                s^T = k qs^T and K3's dp read the same tiles
//                                on FMAs);
//   dv += e^T gz, dk += t^T qz   M = keys, N = DP, depth QB: A = e^T, t^T from
//                                the accumulators in registers (split there),
//                                B the streamed [DP][QB] tiles qz^T, gz^T that
//                                the prep pass writes transposed, each group
//                                of 8 queries in the A fragments' column order
//                                (slot_query);
//   dq^T = k^T t^T               M = DP (one or two 64-row tiles), N = QB,
//                                depth the unit's 64 keys: A = k^T read from
//                                the resident k tiles into registers, B = t
//                                staged [QB][64 keys] over the stage's
//                                consumed qs and g tiles.
// The unit's dq part is staged over the consumed qz^T tiles for the dq warp.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {
namespace tf32bwd {

constexpr int kUnitKeys = 64;  // keys of one unit: a consumer warpgroup's M
// warps 0-7 the two consumer warpgroups (232 registers each by setmaxnreg),
// warps 8-11 the third, which gives its registers up: warp 8 the producer,
// 9 + s the dq warp of ring stage s
constexpr int kThreads = 384;
constexpr int kConsumers = 256;

// 3xTF32: big . big + big . small + small . big (2: small . big dropped; 1:
// big . big alone). The scores stay on IEEE FMAs (0): e = exp2(s - m) turns
// an absolute error of s into a relative error of e, and 3xTF32 scores moved
// K3's gradients past their f32 bounds at logits below -128 (PERF.md).
constexpr int kScoreTerms = 0;    // s^T
constexpr int kProductTerms = 3;  // dv, dk, dq (and K5's dp)

// Query tile rows by padded head width: what fits beside the resident k and
// v (big and small) in 227 KB. The ring has two stages, one a consumer
// warpgroup (the tile of walk count `it` is warpgroup it % 2's, in stage
// it % 2), so that each stage's mbarriers see one warpgroup's phases in order.
template <int DP>
struct Cfg {
  static constexpr int kQB = DP <= 72 ? 32 : DP <= 80 ? 16 : 8;
  static constexpr int kStages = 2;
};

// Byte offset of f32 element (r, c) of a tile of `rows` rows and C columns in
// the panel layout (wgmma.cuh: the layout of 2 C bf16 columns).
template <int C>
__device__ __forceinline__ uint32_t tile_offset(int rows, int r, int c) {
  return panel_offset<2 * C>(rows, r, 2 * c);
}

// K-major descriptor of depth step kk (8 f32 columns) of a tile of `rows`
// rows and C columns, from row r0 on.
template <int C>
__device__ __forceinline__ uint64_t desc(uint32_t tile, int rows, int r0, int kk) {
  return desc_k_major<2 * C>(tile, rows, r0, 16 * kk);
}

// The streamed operands of one ring stage: qs (K5: qh) and g as [QB][DP],
// qz^T and gz^T as [DP][QB], each big then small; then the kernel's extras.
template <int DP>
struct Stage {
  static constexpr int kQB = Cfg<DP>::kQB;
  static constexpr int kTile = kQB * DP * 4;
  static constexpr int kQs = 0, kG = 2 * kTile, kQzT = 4 * kTile, kGzT = 6 * kTile;
  static constexpr int kOperands = 8 * kTile;
  static constexpr int kTBytes = kQB * kUnitKeys * 4;  // t staged: [QB][64] big, then small
};

// The query in column p of a [DP][QB] tile: each group of 8 permuted, even
// queries first, as an accumulator holds columns 2 (lane % 4) and + 1 of
// each 8, which the A fragment takes as its columns lane % 4 and + 4.
__device__ __forceinline__ int slot_query(int p) {
  return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
}

// D (64 x N) (+)= A B over STEPS depth steps, the terms of the split: a(part,
// kk) and b(part, kk) the descriptors of step kk's big (part 0) and small
// (part 1) tiles. acc0 = 0 overwrites D.
template <int N, int STEPS, int TERMS, typename DA, typename DB>
__device__ __forceinline__ void product_ss(float (&d)[N / 2], DA a, DB b, int acc0) {
  int acc = acc0;
  if (TERMS >= 2) {
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk, acc = 1) WgmmaTf32<N>::ss(d, a(0, kk), b(1, kk), acc);
  }
  if (TERMS >= 3) {
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk, acc = 1) WgmmaTf32<N>::ss(d, a(1, kk), b(0, kk), acc);
  }
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk, acc = 1) WgmmaTf32<N>::ss(d, a(0, kk), b(0, kk), acc);
}

// The same with A from registers: ab, as the big and small fragments.
template <int N, int STEPS, int TERMS, typename DB>
__device__ __forceinline__ void product_rs(float (&d)[N / 2], const uint32_t (&ab)[STEPS][4],
                                           const uint32_t (&as)[STEPS][4], DB b, int acc0) {
  int acc = acc0;
  if (TERMS >= 2) {
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk, acc = 1) WgmmaTf32<N>::rs(d, ab[kk], b(1, kk), acc);
  }
  if (TERMS >= 3) {
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk, acc = 1) WgmmaTf32<N>::rs(d, as[kk], b(0, kk), acc);
  }
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk, acc = 1) WgmmaTf32<N>::rs(d, ab[kk], b(0, kk), acc);
}

// A 64 x (8 STEPS) accumulator (e^T or t^T: keys by queries) as A fragments,
// big and small: step kk's columns 8 kk + 2 (lane % 4), + 1 become the
// fragment's lane % 4, + 4 (slot_query).
template <int STEPS>
__device__ __forceinline__ void split_fragments(const float (&x)[4 * STEPS],
                                                uint32_t (&big)[STEPS][4],
                                                uint32_t (&small)[STEPS][4]) {
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const float v[4] = {x[4 * kk], x[4 * kk + 2], x[4 * kk + 1], x[4 * kk + 3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      big[kk][i] = __float_as_uint(v[i]);
      small[kk][i] = __float_as_uint(tf32_small(v[i]));
    }
  }
}

// Rows [r0, r0 + 64) of an (n, hd) f32 matrix into a [64][DP] tile, big and
// small, zeros past n and hd; with `normalise` each row times its inverse
// norm (inv_norm of the sum of squares, the DP / 4 lanes of a row adding
// their vectors' by xor shuffles: row_inv_norm's pairwise order). The
// kConsumers threads; with `normalise` DP / 4 is a power of two.
template <int DP, typename Norm>
__device__ __forceinline__ void load_unit(unsigned char* big, unsigned char* small,
                                          const float* src, int r0, int n, int hd, bool normalise,
                                          Norm inv_norm_of, int wt) {
  constexpr int VPR = DP / 4;
#pragma unroll 2
  for (int idx = wt; idx < kUnitKeys * VPR; idx += kConsumers) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n && vc < hd) {
      f = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(r0 + r) * hd + vc));
    }
    if (normalise) {
      float ss = fmaf(f.x, f.x, fmaf(f.y, f.y, fmaf(f.z, f.z, f.w * f.w)));
#pragma unroll
      for (int off = 1; off < VPR; off <<= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      const float rn = inv_norm_of(ss);
      f = make_float4(__fmul_rn(f.x, rn), __fmul_rn(f.y, rn), __fmul_rn(f.z, rn),
                      __fmul_rn(f.w, rn));
    }
    const uint32_t off = tile_offset<DP>(kUnitKeys, r, vc);
    *reinterpret_cast<float4*>(big + off) = f;
    *reinterpret_cast<float4*>(small + off) =
        make_float4(tf32_small(f.x), tf32_small(f.y), tf32_small(f.z), tf32_small(f.w));
  }
}

// Columns [c0, c0 + C) of A^T B, added to s: the thread's keys 16 wq + g, + 8
// (rows of the resident tile a) and queries 8 j + 2 t, + 1 (rows of the
// stage's tile b) on IEEE FMAs in d order (as the f32 FMA loops before),
// four columns (one 16-byte chunk) a step, in the accumulator layout.
template <int DP, int C>
__device__ __forceinline__ void fma_columns(float (&s)[Cfg<DP>::kQB / 2], const unsigned char* a,
                                            const unsigned char* b, int c0, int wq, int g, int t) {
  constexpr int QB = Cfg<DP>::kQB;
  const int ka = 16 * wq + g;
#pragma unroll 2
  for (int c = c0; c < c0 + C; c += 4) {
    const float4 k0 = *reinterpret_cast<const float4*>(a + tile_offset<DP>(kUnitKeys, ka, c));
    const float4 k1 = *reinterpret_cast<const float4*>(a + tile_offset<DP>(kUnitKeys, ka + 8, c));
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float4 q = *reinterpret_cast<const float4*>(b + tile_offset<DP>(QB, 8 * j + 2 * t + u, c));
        float& x = s[4 * j + u];
        float& y = s[4 * j + 2 + u];
        x = fmaf(k0.x, q.x, x);
        x = fmaf(k0.y, q.y, x);
        x = fmaf(k0.z, q.z, x);
        x = fmaf(k0.w, q.w, x);
        y = fmaf(k1.x, q.x, y);
        y = fmaf(k1.y, q.y, y);
        y = fmaf(k1.z, q.z, y);
        y = fmaf(k1.w, q.w, y);
      }
    }
  }
}

// s^T = k qs^T and dp^T = v g^T of one query tile from the unit's resident k
// and v (big at k_s / v_tile, small one `small_step` further) and the
// stage's qs and g tiles. s on IEEE FMAs (kScoreTerms 0), the order of K2's
// f32 loop, so that e = exp2(s - m) is the forward's e. dp on IEEE FMAs
// (DP_TERMS 0: K3, where a row with one dominant key leaves t = e (dp - c)
// a residue of dp that 3xTF32 does not hold within the f32 bounds) or on
// 3xTF32 (DP_TERMS 3: K5) with each depth step's big . big in a fresh
// accumulator, added to dp in f32 (round to nearest), and the cross terms in
// an accumulator of their own (the tensor cores' sums truncate); its depth
// steps run under the FMA columns of s, a step ahead.
template <int DP, int DP_TERMS>
__device__ __forceinline__ void scores_and_dp(float (&s)[Cfg<DP>::kQB / 2],
                                              float (&dp)[Cfg<DP>::kQB / 2],
                                              const unsigned char* k_s, const unsigned char* v_s,
                                              uint32_t small_step, const unsigned char* stage,
                                              int wq, int g, int t) {
  using S = Stage<DP>;
  constexpr int QB = Cfg<DP>::kQB, STEPS = DP / 8;
  const uint32_t k_tile = smem_addr(k_s), v_tile = smem_addr(v_s), st = smem_addr(stage);
  auto a = [&](uint32_t tile, int part, int kk) {
    return desc<DP>(tile + part * small_step, kUnitKeys, 0, kk);
  };
  auto b = [&](int op, int part, int kk) { return desc<DP>(st + op + part * S::kTile, QB, 0, kk); };
#pragma unroll
  for (int i = 0; i < QB / 2; ++i) s[i] = dp[i] = 0.f;
  if (kScoreTerms > 0) {  // s on the tensor cores, one accumulator
    wgmma_fence();
    product_ss<QB, STEPS, kScoreTerms>(
        s, [&](int part, int kk) { return a(k_tile, part, kk); },
        [&](int part, int kk) { return b(S::kQs, part, kk); }, 0);
    wgmma_commit();
  }
  if (DP_TERMS == 0) {
    if (kScoreTerms == 0) fma_columns<DP, DP>(s, k_s, stage + S::kQs, 0, wq, g, t);
    fma_columns<DP, DP>(dp, v_s, stage + S::kG, 0, wq, g, t);
    wgmma_wait<0>();
    fence_regs(s);
    return;
  }
  float step[2][QB / 2], cross[QB / 2];
  auto issue = [&](int kk) {
    wgmma_fence();
    WgmmaTf32<QB>::ss(step[kk & 1], a(v_tile, 0, kk), b(S::kG, 0, kk), 0);
    if (DP_TERMS >= 2) WgmmaTf32<QB>::ss(cross, a(v_tile, 0, kk), b(S::kG, 1, kk), kk);
    if (DP_TERMS >= 3) WgmmaTf32<QB>::ss(cross, a(v_tile, 1, kk), b(S::kG, 0, kk), 1);
    wgmma_commit();
  };
  issue(0);
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    if (kk + 1 < STEPS) issue(kk + 1);
    if (kScoreTerms == 0) fma_columns<DP, 8>(s, k_s, stage + S::kQs, 8 * kk, wq, g, t);
    if (kk + 1 < STEPS) {
      wgmma_wait<1>();
    } else {
      wgmma_wait<0>();
    }
    fence_regs(step[kk & 1]);
#pragma unroll
    for (int i = 0; i < QB / 2; ++i) dp[i] += step[kk & 1][i];
  }
  fence_regs(s);
  if (DP_TERMS >= 2) {
    fence_regs(cross);
#pragma unroll
    for (int i = 0; i < QB / 2; ++i) dp[i] += cross[i];
  }
}

// dv += e^T gz, dk += t^T qz (issued, committed).
template <int DP>
__device__ __forceinline__ void issue_dkv(float (&dv)[DP / 2], float (&dk)[DP / 2],
                                          const uint32_t (&eb)[Cfg<DP>::kQB / 8][4],
                                          const uint32_t (&es)[Cfg<DP>::kQB / 8][4],
                                          const uint32_t (&tb)[Cfg<DP>::kQB / 8][4],
                                          const uint32_t (&ts)[Cfg<DP>::kQB / 8][4],
                                          uint32_t stage) {
  using S = Stage<DP>;
  constexpr int QB = Cfg<DP>::kQB;
  wgmma_fence();
  product_rs<DP, QB / 8, kProductTerms>(
      dv, eb, es, [&](int part, int kk) { return desc<QB>(stage + S::kGzT + part * S::kTile, DP, 0, kk); },
      1);
  product_rs<DP, QB / 8, kProductTerms>(
      dk, tb, ts, [&](int part, int kk) { return desc<QB>(stage + S::kQzT + part * S::kTile, DP, 0, kk); },
      1);
  wgmma_commit();
}

// t, from its fragments, into the stage's [QB][64 keys] tiles (big, then
// small): the dq product's B operand. Thread (wq, g, t) holds keys 16 wq + g,
// + 8 of queries 8 kk + 2 t, + 1.
template <int QB>
__device__ __forceinline__ void stage_t(unsigned char* dst, const uint32_t (&fb)[QB / 8][4],
                                        const uint32_t (&fs)[QB / 8][4], int wq, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < QB / 8; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = tile_offset<kUnitKeys>(QB, 8 * kk + 2 * t + (i >> 1), 16 * wq + g + 8 * (i & 1));
      *reinterpret_cast<uint32_t*>(dst + off) = fb[kk][i];
      *reinterpret_cast<uint32_t*>(dst + QB * kUnitKeys * 4 + off) = fs[kk][i];
    }
  }
}

// dq^T rows [64 mt, 64 mt + 64) = k^T t^T over the unit's 64 keys (issued,
// committed): A, k^T, read from the resident k tiles (big, small) into
// registers; rows past DP are zeros.
template <int DP>
__device__ __forceinline__ void issue_dq(float (&acc)[Cfg<DP>::kQB / 2], const unsigned char* kb,
                                         const unsigned char* ks, uint32_t t_tile, int mt, int wq,
                                         int g, int t) {
  constexpr int QB = Cfg<DP>::kQB, STEPS = kUnitKeys / 8;
  uint32_t ab[STEPS][4], as[STEPS][4];
  const int d0 = 64 * mt + 16 * wq + g;
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + 8 * (i & 1), key = 8 * kk + t + 4 * (i >> 1);
      ab[kk][i] = as[kk][i] = 0u;
      if (d < DP) {
        const uint32_t off = tile_offset<DP>(kUnitKeys, key, d);
        ab[kk][i] = *reinterpret_cast<const uint32_t*>(kb + off);
        as[kk][i] = *reinterpret_cast<const uint32_t*>(ks + off);
      }
    }
  }
  wgmma_fence();
  product_rs<QB, STEPS, kProductTerms>(
      acc, ab, as, [&](int part, int kk) { return desc<kUnitKeys>(t_tile + part * QB * kUnitKeys * 4, QB, 0, kk); },
      0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(ab);
  fence_regs(as);
}

// Byte offset of dq element (q, d) in the f32 staging tile: boxes of QB rows
// x 16 columns, each row 64 bytes with its 16-byte chunks swizzled by
// (q / 2) % 4, as the copy engine reads them (64-byte swizzle).
template <int QB>
__device__ __forceinline__ int dq_offset(int q, int d) {
  return (d >> 4) * (QB * 64) + q * 64 + ((((d & 15) >> 2) ^ ((q >> 1) & 3)) << 4) + (d & 3) * 4;
}

// dq^T rows [64 mt, 64 mt + 64) into the staging tile (rows below DP).
template <int DP>
__device__ __forceinline__ void stage_dq(unsigned char* dst, const float (&acc)[Cfg<DP>::kQB / 2],
                                         int mt, int wq, int g, int t) {
  constexpr int QB = Cfg<DP>::kQB;
#pragma unroll
  for (int j = 0; j < QB / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 64 * mt + 16 * wq + g + 8 * (e >> 1), q = 8 * j + 2 * t + (e & 1);
      if (d < DP) *reinterpret_cast<float*>(dst + dq_offset<QB>(q, d)) = acc[4 * j + e];
    }
  }
}

}  // namespace tf32bwd
}  // namespace
