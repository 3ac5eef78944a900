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
// f32(q) * D^-0.5; scores, the online softmax (m_safe guard, corr =
// exp(min(m - m_safe, 0))) and the accumulator in f32; one rounding to
// the output type at the end.
//
// Design: one block of 4 warps per (b, h, 16 query rows); each warp owns
// 4 rows.  The Pallas kernel carried (m, l, acc) across the sequential
// KV grid axis in VMEM; here a loop inside the block walks the KV tiles
// of 32 keys, staged in shared memory as f32, with the running (m, l,
// acc) in registers.  Lane j computes the full dot product of key j
// (K tile rows padded to D + 4 floats so the lanes' float4 reads do not
// share a bank; the query rows are broadcast reads), so the tile's max
// and sum are warp reductions; for P.V lane t owns output columns
// t + 32c and takes p_j by shuffle.  A causal block stops at its last
// query row's position: the tiles past it are an exact no-op of the
// update (p = 0, corr = 1).  The softmax is taken per 32-key tile, which
// changes rounding, not the function; the plain version beside the
// wrapper is the reference for the tolerance.
//
// Bound: operations (4 * D flops per query-key pair the mask keeps; the
// K/V of one head is re-read per 16-row tile, from L2).  This first
// kernel uses no tensor cores: f32 FMAs on the CUDA cores set its time.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

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
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
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

template <typename T, int DPL, bool CAUSAL>
int go(dim3 grid, size_t smem, cudaStream_t st, const void* q,
       const void* k, const void* v, void* out, int Sq, int Sk, int H,
       int Hk, int D, float qscale) {
  auto kern = flash_attn_kernel<T, DPL, CAUSAL>;
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

}  // namespace

// Shapes as in the header; D % 4 == 0 and D <= 256, H % Hk == 0,
// B * H <= 65535, Sq, Sk >= 1; bf16 = 1 for bf16 tensors, 0 for f32.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a shape the kernel does not take).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int H, int Hk, int D,
                                      int causal, int bf16, float qscale,
                                      void* stream) {
  if (D < 4 || D > 256 || D % 4 != 0 || Hk < 1 || H % Hk != 0 || B < 1 ||
      Sq < 1 || Sk < 1 || (long long)B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Sq + ROWS - 1) / ROWS, B * H);
  const size_t smem = sizeof(float) * (ROWS * D + BK * (D + 4) + BK * D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? go_dpl<__nv_bfloat16>(causal, grid, smem, st, q, k, v, out,
                                      Sq, Sk, H, Hk, D, qscale)
              : go_dpl<float>(causal, grid, smem, st, q, k, v, out, Sq, Sk,
                              H, Hk, D, qscale);
}
