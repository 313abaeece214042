// Fused attention for the plain ViT towers on Hopper (sm_90a), the forward:
// out = softmax(q k^T scale) v per (batch, head), q / k / v (BH, N, hd). With
// a stats pointer it also writes each query row's shift m (the integer-valued
// running max below) and sum z, (BH, N, 2) f32, which the backward
// (vit_attn_bwd.cu) reads in place of a pass for the row max.
//
// Replaces xmir_tpu/ops/vit_attn_pallas.py::_attention_fwd_pallas (K2, body
// _kernel). The TPU kernel keeps a head's whole K and V in VMEM and runs one
// softmax pass per query tile. On the H100 a head's K + V at N = 1370,
// hd = 64 are 2 x 175 KB in bf16 (700 KB in f32) against 227 KB of shared
// memory a block, so this kernel streams 64-key tiles of K and V past a
// 64-query tile with an online softmax: a running max m and sum z per query
// row and a rescaled accumulator. One block per (head, query tile): 192 heads
// x 22 tiles at batch 16 fill the 132 SMs many times over. The (N, N) scores
// never reach device memory. The ragged last key tile is masked with -inf and
// the ragged last query rows are predicated: nothing is padded in device
// memory and there is no padding algebra.
//
// Rounding points, the TPU kernel's (:123-159): q is multiplied by
// scale log2(e), a constant already rounded to q's dtype by the caller, in
// q's dtype; scores, max, exp2 and the row sum z are f32; z sums the
// unrounded e while the value product takes e rounded to v's dtype; the
// output is (e . v) / z, divided in f32 after the product, then rounded.
//
// The running max is kept integer-valued (the ceiling of the largest score
// so far), so every rescale factor 2^(m_old - m_new) is an exact power of
// two: rescaling commutes with the rounding of e to bf16 and with the f32
// sums, and the streamed result equals a single pass that shifts each row by
// ceil(row max) up to the order of its f32 sums. That is what the plain
// PyTorch version (ops/vit_attn.py::attention_plain) computes, so the two can
// be held close on the card. e lies in (0, 1] as with the exact max.
//
// What bounds it: 4 BH N^2 hd FLOP (92 GFLOP at batch 16) against 4 BH N hd
// elements moved (135 MB in bf16): operations. bf16 runs on the tensor cores
// (mma.sync m16n8k16 through ldmatrix, K and V tiles double-buffered with
// cp.async; four warps of 16 query rows each); f32 on IEEE f32 FMAs (no
// TF32), 256 threads with a 4 x 4 score block each. wgmma, TMA and warp
// specialisation are later work.
//
// hd is any multiple of 8 up to 128; a head is zero-padded in shared memory
// to the next instantiated width (16, 32, 64, 80, 128). Launches go on the
// caller's stream and allocate nothing.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per streamed tile

// 2^d for an integer-valued d <= 0; 0 below 2^-126 and for d = -inf (the
// first tile, when the accumulators are still zero).
__device__ __forceinline__ float pow2i(float d) {
  return d < -126.f ? 0.f : __int_as_float((static_cast<int>(d) + 127) << 23);
}

// bf16: four warps, warp w owns query rows 16 w .. 16 w + 15 of the tile.
// In the m16n8 fragments a thread holds rows g = lane / 4 and g + 8, columns
// 2 (lane % 4) and + 1 of every 8-column tile.
template <int DP>
__global__ void __launch_bounds__(128) attn_bf16(const __nv_bfloat16* __restrict__ q,
                                                 const __nv_bfloat16* __restrict__ k,
                                                 const __nv_bfloat16* __restrict__ v,
                                                 __nv_bfloat16* __restrict__ o,
                                                 float* __restrict__ stats, int n, int hd,
                                                 int q_tiles, float c) {
  constexpr int S = DP + 8;    // row stride: 16-byte aligned, ldmatrix conflict-free
  constexpr int VPR = DP / 8;  // 16-byte vectors per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [kBQ][S]
  __nv_bfloat16* const kv_s = q_s + kBQ * S;  // [2 stages][k, v][kBK][S]

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

  // the query tile, times c in bf16 (the product of two bf16 values is exact
  // in f32, so one rounding), into shared memory
  for (int idx = tid; idx < kBQ * VPR; idx += 128) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < n && vc < hd) {
      raw = __ldg(reinterpret_cast<const uint4*>(q + base + static_cast<size_t>(q0 + r) * hd + vc));
    }
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      p[i] = __floats2bfloat162_rn(f.x * c, f.y * c);
    }
    *reinterpret_cast<uint4*>(q_s + r * S + vc) = raw;
  }
  __syncthreads();
  uint32_t qf[DP / 16][4];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int dt = 0; dt < DP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, z_run[2] = {0.f, 0.f};

  const int tiles = (n + kBK - 1) / kBK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < tiles) {
      prefetch(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv_s + stage * 2 * kBK * S;
    const __nv_bfloat16* vs = ks + kBK * S;

    // scores: 16 query rows x 64 keys per warp, as 8 column tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < kBK / 16; ++np) {
        uint32_t r[4];
        ldmatrix_x4(r, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                           ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(s[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }
    const int k0 = tile * kBK;
    if (k0 + kBK > n) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + 2 * t + (e & 1) >= n) s[nt][e] = -INFINITY;
    }

    // online softmax of rows g (h = 0) and g + 8 (h = 1)
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], ceilf(mx));
      alpha[h] = pow2i(m_run[h] - m_new);
      m_run[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBK / 8; ++nt) {
        const float e0 = exp2f(s[nt][2 * h] - m_new), e1 = exp2f(s[nt][2 * h + 1] - m_new);
        s[nt][2 * h] = e0;
        s[nt][2 * h + 1] = e1;
        sum += e0 + e1;
      }
      z_run[h] = z_run[h] * alpha[h] + sum;  // this thread's share of the row's z
    }
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += e (rounded to bf16) . V
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * S + dp * 16 +
                                 (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float z = z_run[h];
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row >= n) continue;
    if (stats != nullptr && t == 0) {
      *reinterpret_cast<float2*>(stats + 2 * (static_cast<size_t>(bh) * n + row)) =
          make_float2(m_run[h], z);
    }
    __nv_bfloat16* dst = o + base + static_cast<size_t>(row) * hd;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const int col = dt * 8 + 2 * t;
      if (col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) =
            __floats2bfloat162_rn(acc[dt][2 * h] / z, acc[dt][2 * h + 1] / z);
      }
    }
  }
}

// f32: thread (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i
// (i < 4), score columns tx + 16 j (j < 4) and output columns tx + 16 j
// (j < DP / 16). The 16 threads of a row are half a warp.
template <int DP>
__global__ void __launch_bounds__(256) attn_f32(const float* __restrict__ q,
                                                const float* __restrict__ k,
                                                const float* __restrict__ v,
                                                float* __restrict__ o,
                                                float* __restrict__ stats, int n, int hd,
                                                int q_tiles, float c) {
  constexpr int SQ = DP + 1;    // odd stride: conflict-free reads down a column
  constexpr int SP = kBK + 1;
  constexpr int VPR = DP / 4;   // 16-byte vectors per row
  constexpr int DJ = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const q_s = reinterpret_cast<float*>(smem);  // [kBQ][SQ]
  float* const k_s = q_s + kBQ * SQ;                  // [kBK][SQ]
  float* const v_s = k_s + kBK * SQ;                  // [kBK][DP]
  float* const p_s = v_s + kBK * DP;                  // [kBQ][SP]

  const int bh = blockIdx.x / q_tiles, q0 = (blockIdx.x - bh * q_tiles) * kBQ;
  const size_t base = static_cast<size_t>(bh) * n * hd;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  auto load_row_vec = [&](const float* src, int row, int vc) {
    if (row < n && vc < hd) {
      return __ldg(reinterpret_cast<const float4*>(src + base + static_cast<size_t>(row) * hd + vc));
    }
    return make_float4(0.f, 0.f, 0.f, 0.f);
  };
  for (int idx = tid; idx < kBQ * VPR; idx += 256) {
    const int r = idx / VPR, vc = (idx - r * VPR) * 4;
    const float4 f = load_row_vec(q, q0 + r, vc);
    float* dst = q_s + r * SQ + vc;
    dst[0] = f.x * c;
    dst[1] = f.y * c;
    dst[2] = f.z * c;
    dst[3] = f.w * c;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  float m_run[4], z_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    z_run[i] = 0.f;
  }

  const int tiles = (n + kBK - 1) / kBK;
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();  // the last tile's reads are done
    for (int idx = tid; idx < kBK * VPR; idx += 256) {
      const int r = idx / VPR, vc = (idx - r * VPR) * 4;
      const float4 fk = load_row_vec(k, k0 + r, vc);
      float* dst = k_s + r * SQ + vc;
      dst[0] = fk.x;
      dst[1] = fk.y;
      dst[2] = fk.z;
      dst[3] = fk.w;
      *reinterpret_cast<float4*>(v_s + r * DP + vc) = load_row_vec(v, k0 + r, vc);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * SQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * SQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    if (k0 + kBK > n) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j >= n) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[i], ceilf(mx));
      const float alpha = pow2i(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp2f(s[i][j] - m_new);
        p_s[(ty + 16 * i) * SP + tx + 16 * j] = e;
        sum += e;
      }
      z_run[i] = z_run[i] * alpha + sum;  // this thread's share of the row's z
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row's e is written and read by the same half warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = v_s[kk * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float z = z_run[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) z += __shfl_xor_sync(0xffffffffu, z, off);
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    if (stats != nullptr && tx == 0) {
      *reinterpret_cast<float2*>(stats + 2 * (static_cast<size_t>(bh) * n + row)) =
          make_float2(m_run[i], z);
    }
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) o[base + static_cast<size_t>(row) * hd + col] = acc[i][j] / z;
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* stats,
                        int bh, int n, int hd, float c, cudaStream_t stream) {
  constexpr int kSmem = (kBQ + 4 * kBK) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(attn_bf16<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (n + kBQ - 1) / kBQ;
  attn_bf16<DP><<<bh * q_tiles, 128, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), stats, n, hd,
      q_tiles, c);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* stats,
                       int bh, int n, int hd, float c, cudaStream_t stream) {
  constexpr int kSmem =
      (kBQ * (DP + 1) + kBK * (DP + 1) + kBK * DP + kBQ * (kBK + 1)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_f32<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int q_tiles = (n + kBQ - 1) / kBQ;
  attn_f32<DP><<<bh * q_tiles, 256, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), stats, n, hd, q_tiles, c);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, void* o,
                   float* stats, int bh, int n, int hd, float c, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<DP>(q, k, v, o, stats, bh, n, hd, c, stream);
  return launch_bf16<DP>(q, k, v, o, stats, bh, n, hd, c, stream);
}

}  // namespace

// C entry point bound with ctypes; returns a cudaError_t code. q, k, v, o
// (bh, n, hd) contiguous, 16-byte aligned, of one dtype (0 = float32,
// 1 = bfloat16); hd a multiple of 8 up to 128; c = scale log2(e), already
// rounded to the dtype; stats null or (bh, n, 2) float32, 8-byte aligned.
extern "C" int xmir_vit_attn(const void* q, const void* k, const void* v, void* o, void* stats,
                             int dtype, int bh, int n, int hd, float c, void* stream) {
  if ((dtype != 0 && dtype != 1) || bh < 1 || n < 1 || hd < 8 || hd > 128 || hd % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = static_cast<long long>(bh) * ((n + kBQ - 1) / kBQ);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (hd <= 16) return (int)launch<16>(dtype, q, k, v, o, st, bh, n, hd, c, s);
  if (hd <= 32) return (int)launch<32>(dtype, q, k, v, o, st, bh, n, hd, c, s);
  if (hd <= 64) return (int)launch<64>(dtype, q, k, v, o, st, bh, n, hd, c, s);
  if (hd <= 80) return (int)launch<80>(dtype, q, k, v, o, st, bh, n, hd, c, s);
  return (int)launch<128>(dtype, q, k, v, o, st, bh, n, hd, c, s);
}
