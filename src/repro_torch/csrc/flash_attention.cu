// Contiguous GQA flash attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py, _fa_kernel): causal or
// bidirectional attention over a contiguous K/V, GQA by
// kv_head = h / (H / Hk), the KV and query tails masked.
//
// Function: q (B, Sq, H, D), k/v (B, Sk, Hk, D), all bf16 or all f32;
// out (B, Sq, H, D) in q's type.  Query row i (position i) attends to
// keys j < Sk, and j <= i when causal (top-left aligned: both positions
// count from 0, as the reference).  Query prep as the reference:
// f32(q) * D^-0.5 (on the tensor cores the scale multiplies the f32
// score instead, in log2 units for exp2); the online softmax (m_safe
// guard, corr = exp(min(m - m_safe, 0))) and the accumulator in f32;
// one rounding to the output type at the end.
//
// What bounds it: operations.  4 * D flops per query-key pair the mask
// keeps (~0.55 TFLOP at causal 8192, H = 32), against ~0.1 GB of q, k,
// v and out: far above the card's balance point, so the flops belong on
// the tensor cores (f32 FMAs on the CUDA cores run ~15x below their
// bf16 rate), and at the full bf16 rate only through wgmma.
//
// Three kernels; the caller names one (flash_attention_launch's `path`,
// chosen by kernels/flash_attention.flash_path from dtype and D) and the
// launcher refuses a shape that kernel does not take:
//
// PATH_WGMMA, flash_attn_wgmma_kernel (bf16, D = 64 or 128): one block
// per (b, h, 128 query rows) of 2 consumer warpgroups (64 rows each) and
// one producer warp.  The producer's lane 0 loads the block's Q once and
// keeps a ring of 2 K/V stages of 128 keys full with TMA tensor loads
// (128-byte swizzle, 64-column boxes, the tails zero-filled by the
// TMA), each stage's K and V signalled by its own mbarrier and released
// by an `empty` mbarrier that all 256 consumer threads arrive on.  Each
// consumer warpgroup computes S = Q K^T (64 x 128 f32) with wgmma from
// shared memory (both operands K-major), the online softmax in
// registers, and O += P V with wgmma taking P from registers: the
// accumulator layout of S is the mma.sync A-fragment layout of each
// warp's 16 rows, so P needs no trip through shared memory; V is the
// MN-major (transposed) B operand straight from its TMA tile.  The two
// warpgroups take turns on the tensor cores (two mbarriers): a turn
// issues P V of tile t - 1, waits for it, and issues S of tile t; the
// softmax of t runs while the other warpgroup's turn keeps the tensor
// cores busy, and one product in flight at a time keeps only O and S
// (or O and P) in registers (ptxas holds the kernel to 168 a thread).
// P goes in as two bf16 terms (hi = bf16(p), lo = bf16(p - hi)): one
// bf16 rounding of p puts early causal rows, which average a few keys,
// 2 bf16 ulps off the plain version at causal 8192 (max |diff| 0.0078
// against the bar 2^-7 |ref| + 2e-3); the pair carries ~16 bits of p.
// This changes rounding, not the function; the plain version beside
// the wrapper is the reference for the tolerance.
// A causal block stops at its last row's tile, and the blocks of the
// longest causal walks are launched first (the query block is the
// grid's slow axis, counted from the end).
//
// PATH_MMA, flash_attn_kernel (bf16, D % 16 == 0, D <= 128; serves the
// head sizes the wgmma kernel does not take): one block of 4 warps per
// (b, h, 64 query rows), 16 rows a warp.  K/V tiles of 64 keys stay bf16
// in shared memory, filled by cp.async 16 bytes a thread into a ring of
// 2 stages, chunks XOR-swizzled; ldmatrix feeds bf16 mma.sync m16n8k16
// with f32 accumulators for S = Q K^T (Q fragments held in registers)
// and for O += P V, P as two bf16 terms as above.  A warp skips a tile
// past its own last row (an exact no-op of the update).
//
// PATH_FMA, flash_attn_fma_kernel (f32, and any other D % 4 == 0 up to
// 256): f32 FMAs on the CUDA cores, one block of 4 warps per (b, h, 16
// query rows), lane j computing key j's dot product of a 32-key f32
// tile, P.V with lane t owning columns t + 32c.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "tc_sm90.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // query rows per block
constexpr int BK = 32;                       // keys per tile, one a lane
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DPL, bool CAUSAL>
__global__ void __launch_bounds__(WARPS * 32)
flash_attn_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int Sq,
                  int Sk, int H, int Hk, int D, float qscale) {
  extern __shared__ __align__(16) float smem[];
  const int ldk = D + 4;
  float* qs = smem;                // (ROWS, D) pre-scaled queries
  float* ks = qs + ROWS * D;       // (BK, ldk)
  float* vs = ks + BK * ldk;       // (BK, D)

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hk);
  const int q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int idx = threadIdx.x; idx < ROWS * D; idx += WARPS * 32) {
    const int r = idx / D, d = idx % D, qi = q0 + r;
    qs[idx] = qi < Sq
        ? __fmul_rn(to_f(q[(((size_t)b * Sq + qi) * H + h) * D + d]),
                    qscale)
        : 0.0f;
  }

  float acc[ROWS_PER_WARP][DPL], m[ROWS_PER_WARP], l[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.0f;
  }
  const int row0 = warp * ROWS_PER_WARP;  // this warp's first tile row

  const int kend = CAUSAL ? min(Sk, q0 + ROWS) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BK * D; idx += WARPS * 32) {
      const int j = idx / D, d = idx % D, kp = k0 + j;
      const size_t src = (((size_t)b * Sk + kp) * Hk + hk) * D + d;
      ks[j * ldk + d] = kp < Sk ? to_f(k[src]) : 0.0f;
      vs[idx] = kp < Sk ? to_f(v[src]) : 0.0f;
    }
    __syncthreads();

    // scores: lane j <-> key k0 + j, full dot products
    float s[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) s[i] = 0.0f;
    for (int d = 0; d < D; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(&ks[lane * ldk + d]);
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&qs[(row0 + i) * D + d]);
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    const int kp = k0 + lane;
    float p[ROWS_PER_WARP];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int qpos = q0 + row0 + i;
      const bool ok = kp < Sk && (!CAUSAL || qpos >= kp);
      const float si = ok ? s[i] : NEG_INF;
      const float mj = fmaxf(m[i], warp_max(si));
      const float m_safe = fmaxf(mj, -1e29f);
      p[i] = expf(si - m_safe);
      const float corr = expf(fminf(m[i] - m_safe, 0.0f));
      l[i] = l[i] * corr + warp_sum(p[i]);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
      m[i] = mj;
    }

    // P.V: lane t owns columns t + 32c
    for (int j = 0; j < BK; ++j) {
      float vv[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? vs[j * D + d] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int qi = q0 + row0 + i;
    if (qi >= Sq) continue;  // the query tail
    const float inv = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D)
        from_f(&out[(((size_t)b * Sq + qi) * H + h) * D + d],
               acc[i][c] / inv);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core kernel (bf16, D % 16 == 0, D <= DP)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;    // query rows per block, 16 a warp
constexpr int BKEY = 64;  // keys per tile
constexpr int FST = 2;    // cp.async ring stages

template <int DP>
constexpr int tc_smem() {
  return FST * 2 * BKEY * DP * 2;  // K and V tiles, bf16
}

template <int DP, bool CAUSAL>
__global__ void __launch_bounds__(WARPS * 32)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                  int Hk, int D, float qscale) {
  using namespace tc;
  constexpr int ROWB = DP * 2;
  constexpr int TILE = BKEY * ROWB;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t base = smem_u32(smem_tc);
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int hk = h / (H / Hk);
  // the longest causal walks first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int rw = q0 + warp * 16;  // this warp's first row

  uint32_t qa[DP / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw + g4 + 8 * i;
    const __nv_bfloat16* qrow = q + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = ks * 16 + hf * 8 + 2 * t4;
        qa[ks][i + 2 * hf] =
            (row < Sq && d < D)
                ? *reinterpret_cast<const uint32_t*>(qrow + d)
                : 0u;
      }
    }
  }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  // scores in log2 units: exp(x) = exp2(x * log2(e))
  const float sl2 = qscale * 1.4426950408889634f;
  const int kend = CAUSAL ? min(Sk, q0 + BQ) : Sk;
  const int ntiles = (kend + BKEY - 1) / BKEY;
  const int chunks = D / 8;
  auto load_tile = [&](int t) {
    const uint32_t kb = base + (t % FST) * 2 * TILE, vb = kb + TILE;
    for (int u = threadIdx.x; u < BKEY * chunks; u += WARPS * 32) {
      const int key = u / chunks, c = u % chunks, kp = t * BKEY + key;
      const size_t src =
          (((size_t)b * Sk + min(kp, Sk - 1)) * Hk + hk) * D + c * 8;
      const uint32_t off = swz(0, key, c, ROWB);
      cp16(kb + off, k + src, kp < Sk ? 16 : 0);
      cp16(vb + off, v + src, kp < Sk ? 16 : 0);
    }
    cp_commit();
  };

  load_tile(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BKEY;
    const uint32_t kb = base + (t % FST) * 2 * TILE, vb = kb + TILE;
    if (!CAUSAL || k0 <= rw + 15) {
      const int mi = lane >> 3;
      float sc[BKEY / 8][4];
#pragma unroll
      for (int n = 0; n < BKEY / 8; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        if (ks * 16 >= D) break;
#pragma unroll
        for (int np = 0; np < BKEY / 16; ++np) {
          uint32_t b0, b1, b2, b3;
          const int key = np * 16 + (mi >> 1) * 8 + (lane & 7);
          ldsm_x4(swz(kb, key, 2 * ks + (mi & 1), ROWB), b0, b1, b2, b3);
          mma16816(sc[2 * np], qa[ks], b0, b1);
          mma16816(sc[2 * np + 1], qa[ks], b2, b3);
        }
      }
      // a tile below the diagonal and inside Sk needs no mask
      const bool masked = (CAUSAL && k0 + BKEY - 1 > rw) || k0 + BKEY > Sk;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rw + g4 + 8 * i;
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < BKEY / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = sc[n][2 * i + e] * sl2;
            if (masked) {
              const int kp = k0 + n * 8 + 2 * t4 + e;
              if (kp >= Sk || (CAUSAL && kp > row)) x = NEG_INF;
            }
            sc[n][2 * i + e] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mj = fmaxf(m[i], mx);
        const float ms = fmaxf(mj, -1e29f);
        float rs = 0.0f;
#pragma unroll
        for (int n = 0; n < BKEY / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = exp2f(sc[n][2 * i + e] - ms);
            sc[n][2 * i + e] = p;
            rs += p;
          }
        }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        const float corr = exp2f(fminf(m[i] - ms, 0.0f));
        l[i] = l[i] * corr + rs;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
        m[i] = mj;
      }
#pragma unroll
      for (int kk = 0; kk < BKEY / 16; ++kk) {
        // A fragments of P (rows g4 / g4 + 8, keys 2t.. / 8 + 2t..) as
        // hi + lo bf16 terms
        uint32_t ph[4], pl[4];
        split2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
        const int key = kk * 16 + (mi & 1) * 8 + (lane & 7);
        uint32_t vf[DP / 16][4];
#pragma unroll
        for (int nd = 0; nd < DP / 16; ++nd)
          if (nd * 16 < D)
            ldsm_x4_t(swz(vb, key, 2 * nd + (mi >> 1), ROWB), vf[nd][0],
                      vf[nd][1], vf[nd][2], vf[nd][3]);
        // every column block with hi, then with lo: no MMA waits on the
        // one before it
#pragma unroll
        for (int t = 0; t < 2; ++t) {
#pragma unroll
          for (int nd = 0; nd < DP / 16; ++nd) {
            if (nd * 16 >= D) break;
            mma16816(acc[2 * nd], t ? pl : ph, vf[nd][0], vf[nd][1]);
            mma16816(acc[2 * nd + 1], t ? pl : ph, vf[nd][2], vf[nd][3]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw + g4 + 8 * i;
    if (row >= Sq) continue;  // the query tail
    const float inv = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
            acc[n][2 * i] / inv, acc[n][2 * i + 1] / inv);
    }
  }
}

template <int DP, bool CAUSAL>
int go_tc(dim3 grid, cudaStream_t st, const void* q, const void* k,
          const void* v, void* out, int Sq, int Sk, int H, int Hk, int D,
          float qscale) {
  auto kern = flash_attn_kernel<DP, CAUSAL>;
  constexpr int smem = tc_smem<DP>();
  static bool opted_in = false;  // above 48 KB: once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  kern<<<grid, WARPS * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), Sq, Sk, H, Hk, D, qscale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// wgmma kernel (bf16, D = 64 * DH)
// ---------------------------------------------------------------------------

constexpr int WQ = 128;                 // query rows per block
constexpr int WKEY = 128;               // keys per K/V stage
constexpr int WST = 2;                  // K/V ring stages
constexpr int WCONS = 2 * 128;          // consumer threads (2 warpgroups)
constexpr int WTHREADS = WCONS + 32;    // + the producer warp
constexpr int HALF_Q = WQ * 128;        // one 64-column half of Q, bytes
constexpr int HALF_KV = WKEY * 128;     // one 64-column half of a K/V tile

// shared-memory layout (offsets from a 1024-byte aligned base): Q
// [half][128 rows][64], then K and V [stage][half][128 keys][64], each
// 128-byte swizzled by the TMA; then the mbarriers q_full, full_k[WST],
// full_v[WST], empty[WST], turn[2]
template <int DH>
struct WgLayout {
  static constexpr int K = DH * HALF_Q;
  static constexpr int V = K + WST * DH * HALF_KV;
  static constexpr int BAR = V + WST * DH * HALF_KV;
  static constexpr int BYTES = BAR + 8 * (3 + 3 * WST) + 1024;  // + align
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(WTHREADS, 1)
flash_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                        int H, int Hk, float sl2) {
  using namespace tc;
  using L = WgLayout<DH>;
  constexpr int D = 64 * DH;
  extern __shared__ unsigned char smem_wg[];
  const uint32_t base = (smem_u32(smem_wg) + 1023u) & ~1023u;
  const uint32_t q_full = base + L::BAR;
  const uint32_t full_k = q_full + 8;        // + 8 * stage
  const uint32_t full_v = full_k + 8 * WST;  // + 8 * stage
  const uint32_t empty = full_v + 8 * WST;   // + 8 * stage
  const uint32_t turn = empty + 8 * WST;     // + 8 * warpgroup

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int hk = h / (H / Hk);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WQ;  // longest walks first
  const int kend = CAUSAL ? min(Sk, q0 + WQ) : Sk;
  const int ntiles = (kend + WKEY - 1) / WKEY;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < WST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, WCONS);
    }
    mbar_init(turn, WCONS / 2);
    mbar_init(turn + 8, WCONS / 2);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WCONS / 32) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(q_full, DH * HALF_Q);
      for (int hf = 0; hf < DH; ++hf)
        tma_load_4d(base + hf * HALF_Q, &tq, q_full, 64 * hf, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % WST;
        // the stage's previous tile (t - WST) released by every consumer
        if (t >= WST) mbar_wait(empty + 8 * s, (t / WST - 1) & 1);
        const uint32_t kb = base + L::K + s * DH * HALF_KV;
        const uint32_t vb = base + L::V + s * DH * HALF_KV;
        mbar_expect_tx(full_k + 8 * s, DH * HALF_KV);
        for (int hf = 0; hf < DH; ++hf)
          tma_load_4d(kb + hf * HALF_KV, &tk, full_k + 8 * s, 64 * hf, hk,
                      t * WKEY, b);
        mbar_expect_tx(full_v + 8 * s, DH * HALF_KV);
        for (int hf = 0; hf < DH; ++hf)
          tma_load_4d(vb + hf * HALF_KV, &tv, full_v + 8 * s, 64 * hf, hk,
                      t * WKEY, b);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = q0 + 64 * wg + 16 * (warp % 4);  // this warp's first row
  const uint32_t qa = base + wg * 64 * 128;       // its rows of each half

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  uint32_t pa[2][WKEY / 16][4];  // P of the last tile, hi and lo terms

  // The two warpgroups take turns on the tensor cores (mbarrier turn[w]
  // completes a phase when all 128 threads of the other one arrive).
  // Turn t issues P V of tile t - 1, waits for it, then issues S of tile
  // t; the softmax of t then runs while the other warpgroup's turn keeps
  // the tensor cores busy.  Every warpgroup walks all ntiles tiles (with
  // WQ == WKEY == 128 a causal block's last tile reaches into both
  // warpgroups' rows), so both take ntiles + 1 turns; warpgroup 1 hands
  // over the first turn, and only warpgroup 0 hands on after its last.
  mbar_wait(q_full, 0);
  if (wg == 1) mbar_arrive(turn);
  for (int t = 0; t <= ntiles; ++t) {
    mbar_wait(turn + 8 * wg, t & 1);
    if (t > 0) {  // O += P V of tile t - 1
      const int s = (t - 1) % WST;
      mbar_wait(full_v + 8 * s, ((t - 1) / WST) & 1);
      const uint32_t vb = base + L::V + s * DH * HALF_KV;
      wg_fence();
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
#pragma unroll
        for (int kk = 0; kk < WKEY / 16; ++kk) {
          const uint64_t dv = wg_desc(vb + kk * 16 * 128, HALF_KV, 1024);
          if constexpr (DH == 2)
            wgmma_rs_n128_t(o, pa[pt][kk], dv);
          else
            wgmma_rs_n64_t(o, pa[pt][kk], dv);
        }
      }
      wg_commit();
      wg_wait<0>();
      wg_pin<D / 2>(o);
      wg_pin<2 * WKEY / 4>(&pa[0][0][0]);
      mbar_arrive(empty + 8 * s);
    }
    if (t == ntiles) {
      if (wg == 0) mbar_arrive(turn + 8);
      break;
    }
    // S = Q K^T of tile t
    const int s = t % WST, k0 = t * WKEY;
    mbar_wait(full_k + 8 * s, (t / WST) & 1);
    const uint32_t kb = base + L::K + s * DH * HALF_KV;
    float sc[WKEY / 2];
#pragma unroll
    for (int i = 0; i < WKEY / 2; ++i) sc[i] = 0.0f;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;  // 16 columns = 32 bytes
      wgmma_ss_n128(sc, wg_desc(qa + (ks / 4) * HALF_Q + off, 16, 1024),
                    wg_desc(kb + (ks / 4) * HALF_KV + off, 16, 1024),
                    ks > 0);
    }
    wg_commit();
    mbar_arrive(turn + 8 * (1 - wg));
    wg_wait<0>();
    wg_pin<WKEY / 2>(sc);

    // the online softmax; a tile below the diagonal and inside Sk needs
    // no mask
    const bool masked = (CAUSAL && k0 + WKEY - 1 > rw) || k0 + WKEY > Sk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = rw + g + 8 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < WKEY / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = sc[4 * j + 2 * i + e] * sl2;
          if (masked) {
            const int kp = k0 + 8 * j + 2 * t4 + e;
            if (kp >= Sk || (CAUSAL && kp > row)) x = NEG_INF;
          }
          sc[4 * j + 2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mj = fmaxf(m[i], mx);
      const float ms = fmaxf(mj, -1e29f);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < WKEY / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = ex2(sc[4 * j + 2 * i + e] - ms);
          sc[4 * j + 2 * i + e] = p;
          rs += p;
        }
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float corr = ex2(fminf(m[i] - ms, 0.0f));
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * i] *= corr;
        o[4 * j + 2 * i + 1] *= corr;
      }
      m[i] = mj;
    }
    // P as A fragments: keys 16kk.. of rows g / g + 8 are
    // sc[8kk .. 8kk + 7], in the order a0..a3 wants
#pragma unroll
    for (int kk = 0; kk < WKEY / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], pa[0][kk][r],
               pa[1][kk][r]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rw + g + 8 * i;
    if (row >= Sq) continue;  // the query tail
    const float inv = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] / inv,
                                o[4 * j + 2 * i + 1] / inv);
  }
}

// a bf16 (B, S, heads, D) tensor as a 4-d map, boxes of 64 columns x
// `rows` positions of one head, 128-byte swizzled; positions past S read
// as zeros
bool tensor_map(CUtensorMap* map, const void* p, int B, int S, int heads,
                int D, int rows) {
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH, bool CAUSAL>
int go_wg(const CUtensorMap& tq, const CUtensorMap& tk,
          const CUtensorMap& tv, void* out, int B, int Sq, int Sk, int H,
          int Hk, float sl2, cudaStream_t st) {
  auto kern = flash_attn_wgmma_kernel<DH, CAUSAL>;
  constexpr int smem = WgLayout<DH>::BYTES;
  static bool opted_in = false;  // above 48 KB: once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid(B * H, (Sq + WQ - 1) / WQ);
  kern<<<grid, WTHREADS, smem, st>>>(tq, tk, tv,
                                     static_cast<__nv_bfloat16*>(out), Sq,
                                     Sk, H, Hk, sl2);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int go_wg_dh(bool causal, const CUtensorMap& tq, const CUtensorMap& tk,
             const CUtensorMap& tv, void* out, int B, int Sq, int Sk, int H,
             int Hk, float sl2, cudaStream_t st) {
  return causal ? go_wg<DH, true>(tq, tk, tv, out, B, Sq, Sk, H, Hk, sl2, st)
                : go_wg<DH, false>(tq, tk, tv, out, B, Sq, Sk, H, Hk, sl2,
                                   st);
}

template <typename T, int DPL, bool CAUSAL>
int go(dim3 grid, size_t smem, cudaStream_t st, const void* q,
       const void* k, const void* v, void* out, int Sq, int Sk, int H,
       int Hk, int D, float qscale) {
  auto kern = flash_attn_fma_kernel<T, DPL, CAUSAL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, WARPS * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hk, D,
      qscale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DPL>
int go_causal(bool causal, dim3 grid, size_t smem, cudaStream_t st,
              const void* q, const void* k, const void* v, void* out,
              int Sq, int Sk, int H, int Hk, int D, float qscale) {
  return causal ? go<T, DPL, true>(grid, smem, st, q, k, v, out, Sq, Sk, H,
                                   Hk, D, qscale)
                : go<T, DPL, false>(grid, smem, st, q, k, v, out, Sq, Sk,
                                    H, Hk, D, qscale);
}

template <typename T>
int go_dpl(bool causal, dim3 grid, size_t smem, cudaStream_t st,
           const void* q, const void* k, const void* v, void* out, int Sq,
           int Sk, int H, int Hk, int D, float qscale) {
  const int dpl = (D + 31) / 32;
  if (dpl <= 1)
    return go_causal<T, 1>(causal, grid, smem, st, q, k, v, out, Sq, Sk, H,
                           Hk, D, qscale);
  if (dpl <= 2)
    return go_causal<T, 2>(causal, grid, smem, st, q, k, v, out, Sq, Sk, H,
                           Hk, D, qscale);
  if (dpl <= 4)
    return go_causal<T, 4>(causal, grid, smem, st, q, k, v, out, Sq, Sk, H,
                           Hk, D, qscale);
  return go_causal<T, 8>(causal, grid, smem, st, q, k, v, out, Sq, Sk, H,
                         Hk, D, qscale);
}

enum { PATH_FMA = 0, PATH_MMA = 1, PATH_WGMMA = 2 };

}  // namespace

// Shapes as in the header; D % 4 == 0 and D <= 256, H % Hk == 0, B >= 1,
// Sq, Sk >= 1; bf16 = 1 for bf16 tensors, 0 for f32.  `path` names the
// kernel (PATH_WGMMA: bf16, D = 64 or 128, Sq / 128 <= 65535;
// PATH_MMA: bf16, D % 16 == 0, D <= 128, B * H <= 65535; PATH_FMA:
// B * H <= 65535).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape the named kernel does not take (or a
// tensor map cuTensorMapEncodeTiled refuses).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int H, int Hk, int D,
                                      int causal, int bf16, float qscale,
                                      int path, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (D < 4 || D > 256 || D % 4 != 0 || Hk < 1 || H % Hk != 0 || B < 1 ||
      Sq < 1 || Sk < 1)
    return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == PATH_WGMMA) {
    if (!bf16 || (D != 64 && D != 128) || (Sq + WQ - 1) / WQ > 65535)
      return bad;
    CUtensorMap tq, tk, tv;
    if (!tensor_map(&tq, q, B, Sq, H, D, WQ) ||
        !tensor_map(&tk, k, B, Sk, Hk, D, WKEY) ||
        !tensor_map(&tv, v, B, Sk, Hk, D, WKEY))
      return bad;
    const float sl2 = qscale * 1.4426950408889634f;
    return D == 64 ? go_wg_dh<1>(causal, tq, tk, tv, out, B, Sq, Sk, H, Hk,
                                 sl2, st)
                   : go_wg_dh<2>(causal, tq, tk, tv, out, B, Sq, Sk, H, Hk,
                                 sl2, st);
  }
  if ((long long)B * H > 65535) return bad;
  if (path == PATH_MMA) {
    if (!bf16 || D % 16 != 0 || D > 128) return bad;
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    if (D <= 64)
      return causal ? go_tc<64, true>(grid, st, q, k, v, out, Sq, Sk, H, Hk,
                                      D, qscale)
                    : go_tc<64, false>(grid, st, q, k, v, out, Sq, Sk, H, Hk,
                                       D, qscale);
    return causal ? go_tc<128, true>(grid, st, q, k, v, out, Sq, Sk, H, Hk,
                                     D, qscale)
                  : go_tc<128, false>(grid, st, q, k, v, out, Sq, Sk, H, Hk,
                                      D, qscale);
  }
  if (path != PATH_FMA) return bad;
  const dim3 grid((Sq + ROWS - 1) / ROWS, B * H);
  const size_t smem = sizeof(float) * (ROWS * D + BK * (D + 4) + BK * D);
  return bf16 ? go_dpl<__nv_bfloat16>(causal, grid, smem, st, q, k, v, out,
                                      Sq, Sk, H, Hk, D, qscale)
              : go_dpl<float>(causal, grid, smem, st, q, k, v, out, Sq, Sk,
                              H, Hk, D, qscale);
}
