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
// memory a block, so this kernel streams key tiles of K and V past a query
// tile with an online softmax: a running max m and sum z per query row and a
// rescaled accumulator. The (N, N) scores never reach device memory. The
// ragged last key tile is masked with -inf and the ragged last query rows are
// predicated: nothing is padded in device memory and there is no padding
// algebra.
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
// elements moved (135 MB in bf16): operations, and beside them one exp2 a
// score (BH N^2 = 360 M at batch 16, about as long on the special-function
// units as the products on the tensor cores).
//
// bf16 (every DINOv2 block, serving and training), attn_bf16_wg: one
// persistent block per SM walks items of 128 query rows of one head, the
// items of a head side by side. Two consumer warpgroups own 64 rows each
// (wgmma m64); a producer warpgroup, of which one thread copies, streams the
// key tiles (128 keys, 64 at hd > 64) of K and V by the copy engine (a TMA box
// per 16 / 32 / 64-column panel; keys past N and columns past hd read as
// zeros) into a ring of up to six stages in the swizzled panel layout of
// wgmma.cuh, behind full and empty mbarriers, and gives its registers to the
// consumers (setmaxnreg: ptxas sizes the 384-thread block at 168 a thread,
// too few for S, O, e and q at once, and would serialise the products). Each
// warp stages its 16 query rows times c in bf16 (one rounding) and keeps them
// as wgmma's register A operand. Turn kt of a warpgroup issues S = (q c) K^T
// of tile kt and then O += e V of tile kt - 1 (e rounded to bf16 as register
// A, V MN-major from shared memory), in two commit groups: the softmax of S
// runs while the value product is still on the tensor cores; O is rescaled
// and the stage released once it is done. The producer runs on into the
// next item's tiles under an item's last turns and epilogue. The two
// warpgroups take turns on the tensor cores (two named barriers handed back
// and forth), so that one warpgroup's softmax also runs under the other's
// products. The exponentials are ex2.approx (exp2_approx). f32 (only under
// XMIR_FLASH_ATTN=1 XMIR_FUSED_LN=1) keeps its IEEE f32 FMA loop (no TF32),
// 64 query rows a block, 256 threads with a 4 x 4 score block each.
//
// hd is any multiple of 8 up to 128; a head is zero-padded in shared memory
// to the next instantiated width (16, 32, 64, 80, 128). Launches go on the
// caller's stream and allocate nothing; the bf16 launch makes its two tensor
// maps on the host.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 64;  // f32: query rows per block
constexpr int kBK = 64;  // f32: keys per streamed tile

// 2^d for an integer-valued d <= 0; 0 below 2^-126 and for d = -inf (the
// first tile, when the accumulators are still zero).
__device__ __forceinline__ float pow2i(float d) {
  return d < -126.f ? 0.f : __int_as_float((static_cast<int>(d) + 127) << 23);
}

// 2^x by the special-function unit (ex2.approx.ftz: 2 ulp, results below
// 2^-126 flushed to 0), for the bf16 body: one instruction a score, where
// exp2f adds the handling of denormal results. An e below 2^-126 changes
// neither z (at least 1/2) nor the value product by a bit that survives.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// bf16: the block's shape and its shared memory (byte offsets from a
// 1024-aligned start): the ring of K and V tiles, each warp's 16 query rows
// at stride DP + 8 for ldmatrix, then full[stages] and empty[stages].
constexpr int kWgRows = 128;    // query rows a block: two consumer warpgroups of 64
constexpr int kWgThreads = 384;  // and a producer warpgroup (one thread of it copies)
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

template <int DP>
struct WgFwd {
  static constexpr int kKeys = DP <= 64 ? 128 : 64;  // keys a tile: S is 64 x kKeys a warpgroup
  static constexpr int kTile = kKeys * DP * 2;       // one K or V tile
  static constexpr int kQBytes = 8 * 16 * (DP + 8) * 2;
  // as many stages as fit, up to 6: a tile's copy is in flight for several
  // tiles' products, and the consumers hold two stages at a time
  static constexpr int kStages =
      (kSmemLimit - kQBytes - 1024 - 128) / (2 * kTile) < 6
          ? (kSmemLimit - kQBytes - 1024 - 128) / (2 * kTile) : 6;
  static constexpr int kQ = kStages * 2 * kTile;
  static constexpr int kBars = kQ + kQBytes;
  static constexpr int kTotal = kBars + 2 * kStages * 8 + 1024;
  static_assert(kStages >= 3 && kTotal <= kSmemLimit, "the ring does not fit");
};

// Warpgroup w (warps 4 w .. 4 w + 3) owns rows q0 + 64 w .. q0 + 64 w + 63 of
// the block's tile; in the accumulators a thread holds rows g = lane / 4 and
// g + 8 of its warp's 16, element 4 j + e at row + 8 (e / 2), column
// 8 j + 2 (lane % 4) + (e % 2).
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1) attn_bf16_wg(
    const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ o,
    float* __restrict__ stats, int n, int hd, int q_tiles, int items, float c) {
  using L = WgFwd<DP>;
  using P = Panels<DP>;
  constexpr int BK = L::kKeys, VPR = DP / 8, S = DP + 8, kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* const smem = align_1024(smem_raw);
  uint64_t* const full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* const empty = full + L::kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (n + BK - 1) / BK;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + st, 1);   // the producer, once its copies land
      mbar_init(empty + st, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: the head's key tiles of K and V, in order
    // the third warpgroup gives (168 - 40) x 128 registers to the consumers:
    // ptxas sizes the block as three warpgroups of 168, too few for S, O,
    // e and q at once (it would serialise the products)
    regs_shrink<40>();
    if (warp != 8 || lane != 0) return;
    int it = 0;  // ring tiles so far, over the block's items
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const int bh = w / q_tiles;
      for (int kt = 0; kt < tiles; ++kt, ++it) {
        const int stage = it % kStages;
        mbar_wait(empty + stage, ((it / kStages) & 1) ^ 1);
        unsigned char* const dst = smem + stage * 2 * L::kTile;
        mbar_arrive_expect_tx(full + stage, 2 * L::kTile);
#pragma unroll
        for (int p = 0; p < P::kCount; ++p) {
          tma_load(dst + p * BK * P::kRowBytes, &k_map, p * P::kWidth, kt * BK, bh, full + stage);
          tma_load(dst + L::kTile + p * BK * P::kRowBytes, &v_map, p * P::kWidth, kt * BK, bh,
                   full + stage);
        }
      }
    }
    return;
  }

  regs_grow<232>();
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t = lane & 3;
  __nv_bfloat16* const q_w = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ) + warp * 16 * S;

  // Turns on the tensor cores: warpgroup w waits on barrier 1 + w and hands
  // the turn on with an arrival at the other's. Warpgroup 0 goes first;
  // warpgroup 1's last turn of the block hands nothing on, so every barrier
  // phase meets 128 waiting and 128 arriving threads; both warpgroups take
  // the same turns for every item, so the order carries across items.
  const int mine = 1 + wg, theirs = 2 - wg;
  if (wg == 1) named_arrive(1, 256);
  // The block's items (head, 128-row query tile) in turn, blockIdx.x apart:
  // the producer streams the next item's tiles under this one's last turns
  // and epilogue. it0: ring tiles taken before this item.
  int it0 = 0;
  for (int w = blockIdx.x; w < items; w += gridDim.x, it0 += tiles) {
    const int bh = w / q_tiles, q0 = (w - bh * q_tiles) * kWgRows;
    const bool last_item = w + static_cast<int>(gridDim.x) >= items;
    const size_t base = static_cast<size_t>(bh) * n * hd;
    const int row0 = q0 + 64 * wg + 16 * wq;  // this warp's 16 query rows

    // the warp's query rows times c in bf16 (the product of two bf16 values is
    // exact in f32, so one rounding), as register A fragments
    __syncwarp();  // the last item's fragments are read
    for (int idx = lane; idx < 16 * VPR; idx += 32) {
      const int r = idx / VPR, vc = (idx - r * VPR) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (row0 + r < n && vc < hd) {
        raw = __ldg(reinterpret_cast<const uint4*>(q + base +
                                                   static_cast<size_t>(row0 + r) * hd + vc));
      }
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        p[i] = __floats2bfloat162_rn(f.x * c, f.y * c);
      }
      *reinterpret_cast<uint4*>(q_w + r * S + vc) = raw;
    }
    __syncwarp();
    uint32_t qf[DP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      ldmatrix_x4(qf[kk], q_w + (lane & 15) * S + kk * 16 + (lane >> 4) * 8);
    }

    float acc[DP / 2], s[BK / 2];
    uint32_t pf[BK / 16][4];  // e of the tile before, rounded to bf16, as A fragments
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY}, z_run[2] = {0.f, 0.f};

    // Turn kt issues S of tile kt and then O += e V of tile kt - 1, in two
    // commit groups: the softmax of S runs while the value product is still on
    // the tensor cores, and O is rescaled once that product is done. The first
    // turn has no value product and the last no S; the flags are compile-time,
    // so no branch of the program surrounds a product (ptxas serialises
    // products on divergent paths).
    auto turn = [&](int kt, auto with_s, auto with_pv) {
      constexpr bool kWithS = decltype(with_s)::value, kWithPv = decltype(with_pv)::value;
      const int it = it0 + kt;
      const int stage = it % kStages, prev = (it + kStages - 1) % kStages;
      if constexpr (kWithS) mbar_wait(full + stage, (it / kStages) & 1);
      named_barrier(mine, 256);
      // every register the products read is written before the fence (ties
      // the rescale and the packing of e above it)
      fence_regs(acc);
      fence_regs(pf);
      fence_regs(s);
      fence_regs(qf);
      wgmma_fence();
      if constexpr (kWithS) {  // S = (q c) K^T of this tile
        const uint32_t k_tile = smem_addr(smem + stage * 2 * L::kTile);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          Wgmma<BK>::template rs<0>(s, qf[kk], desc_k_major<DP>(k_tile, BK, 0, 16 * kk), kk);
        }
      }
      wgmma_commit();
      if constexpr (kWithPv) {  // O += e V of the tile before
        const uint32_t v_tile = smem_addr(smem + prev * 2 * L::kTile + L::kTile);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          Wgmma<DP>::template rs<1>(acc, pf[kk], desc_mn_major<DP>(v_tile, BK, 16 * kk, 0), 1);
        }
      }
      wgmma_commit();
      if (kWithS || wg == 0 || !last_item) named_arrive(theirs, 256);

      float alpha[2] = {1.f, 1.f};
      if constexpr (kWithS) {
        wgmma_wait<1>();  // S is in
        fence_regs(s);
        const int k0 = kt * BK;
        if (k0 + BK > n) {  // the ragged last tile: dead keys (read as zeros) to -inf
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            if (k0 + 8 * (i >> 2) + 2 * t + (i & 1) >= n) s[i] = -INFINITY;
          }
        }
        // online softmax of rows g (h = 0) and g + 8 (h = 1); max and sum in
        // four interleaved partials, not one chain
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            mx[j & 3] = fmaxf(mx[j & 3], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
          }
          float m = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const float m_new = fmaxf(m_run[h], ceilf(m));
          alpha[h] = pow2i(m_run[h] - m_new);
          m_run[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = exp2_approx(s[i] - m_run[(i >> 1) & 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // this thread's share of z: the unrounded e
          float sm[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) sm[j & 3] += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
          z_run[h] = z_run[h] * alpha[h] + ((sm[0] + sm[1]) + (sm[2] + sm[3]));
        }
      }
      wgmma_wait<0>();  // the value product is in: O may be rescaled, pf rewritten
      fence_regs(acc);
      fence_regs(pf);
      fence_regs(qf);
      if constexpr (kWithPv) {  // the tile before is read: its stage is free
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + prev);
      }
      if constexpr (kWithS) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pf[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
          }
        }
      }
    };
    using Yes = std::true_type;
    using No = std::false_type;
    turn(0, Yes{}, No{});
    for (int kt = 1; kt < tiles; ++kt) turn(kt, Yes{}, Yes{});
    turn(tiles, No{}, Yes{});

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float z = z_run[h];
      z += __shfl_xor_sync(0xffffffffu, z, 1);
      z += __shfl_xor_sync(0xffffffffu, z, 2);
      const int row = row0 + g + 8 * h;
      if (row >= n) continue;
      if (stats != nullptr && t == 0) {
        *reinterpret_cast<float2*>(stats + 2 * (static_cast<size_t>(bh) * n + row)) =
            make_float2(m_run[h], z);
      }
      __nv_bfloat16* dst = o + base + static_cast<size_t>(row) * hd;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + 2 * t;
        if (col < hd) {
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h] / z, acc[4 * j + 2 * h + 1] / z);
        }
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
  using L = WgFwd<DP>;
  cudaError_t err = cudaFuncSetAttribute(attn_bf16_wg<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kTotal);
  if (err != cudaSuccess) return err;
  // K and V as (hd, N, BH) for the copy engine, a box a panel of one key tile
  CUtensorMap maps[2];
  const void* const bases[2] = {k, v};
  for (int i = 0; i < 2; ++i) {
    if (make_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, bases[i], hd, n, bh,
                        static_cast<uint64_t>(hd) * 2, static_cast<uint64_t>(n) * hd * 2,
                        Panels<DP>::kWidth, L::kKeys, panel_swizzle<DP>()) != 0) {
      return cudaErrorInvalidValue;
    }
  }
  // persistent: one block per SM (or per item, where there are fewer)
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int q_tiles = (n + kWgRows - 1) / kWgRows, items = bh * q_tiles;
  attn_bf16_wg<DP><<<items < sms ? items : sms, kWgThreads, L::kTotal, stream>>>(
      maps[0], maps[1], static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o),
      stats, n, hd, q_tiles, items, c);
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
