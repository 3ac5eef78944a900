// TiM ternary matmul for Hopper (sm_90a): one templated kernel for the
// single-phase, two-phase and bit-serial products, over dense int8 or
// 2-bit packed ternary weights, with the optional per-L=16-block ADC
// clamp (n_max).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/tim_matmul.py:
//   tim_matmul_pallas                   (_tim_kernel, dense)
//   tim_matmul_packed_pallas            (_tim_kernel, packed)
//   tim_matmul_fused_pallas             (_tim_kernel_fused, two-phase)
//   tim_matmul_bitserial_fused_pallas   (_tim_kernel_bitserial)
//
// Function (x: (M, K) int8 codes, W: (K, N) ternary codes, w1/w2: (N,)
// f32 per-column scales, i1/i2: f32 input scales read from device):
//   S = x @ W, T = |x| @ |W|   (int32, exact)
//   out = i * (cs*S + ct*T),  cs = (w1+w2)*0.5, ct = (w1-w2)*0.5
// Two-phase: pos = max(x,0), neg = max(-x,0) against one W read, each
// phase's epilogue rounded to the output type before p1 - p2.
// Bit-serial without n_max: sum_b (plane_b @ W) << b == codes @ W
// exactly in int32, so the codes go through one product; with n_max
// every plane is its own clamped access (S, T shifted by b).
// Under n_max the (n, k) = ((T+S)/2, (T-S)/2) counts of each 16-row
// block are clamped at n_max before accumulating (T is always kept).
//
// Design: two launches.  Pass 1: a 64x64 output tile per block of 256
// threads, each thread 4x4 outputs, over one slice of K (the TPU grid's
// sequential K axis and its VMEM accumulators become a loop over
// register accumulators; K is split across blocks until the grid holds
// ~4 blocks per SM, since M = 128 rows alone give 2 row tiles), the
// slices' int32 sums added into a workspace with integer atomics
// (exact, order-free).  Pass 2: the f32 epilogue, one thread per
// output.  X and
// W tiles (64 K-codes each) are staged in shared memory, W transposed
// so 4 consecutive K codes of a column are one 32-bit word; packed
// weights are unpacked to int8 as the tile lands.  Products are
// __dp4a (4 int8 MACs per instruction); phase masks, |x|, |W| and bit
// planes are per-byte SIMD ops on the 32-bit words.
//
// Bound: at the serving shape (M = 128 rows) the weight bytes dominate
// the traffic, so the card's bound is memory (a packed 4096x13696
// weight is 14 MB, ~4 us at 3.35 TB/s; int8 ~17 us).  This first
// kernel is limited by dp4a issue rate instead (no tensor cores, W
// re-read once per 64-row tile); the f32 epilogue uses __fmul_rn /
// __fadd_rn in the plain version's order so the two agree bit for bit.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int BKP = BK + 4;      // padded row: 17 words, conflict-free
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int L_BLOCK = 16;

enum { MODE_SINGLE = 0, MODE_PHASES = 1, MODE_BITS = 2 };

// 4 two-bit fields (00 -> 0, 01 -> +1, 11 -> -1) -> 4 int8 codes
__device__ __forceinline__ int decode4(unsigned byte) {
  unsigned out = 0;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    unsigned fld = (byte >> (2 * f)) & 3u;
    unsigned code = fld == 1u ? 0x01u : (fld == 3u ? 0xFFu : 0u);
    out |= code << (8 * f);
  }
  return static_cast<int>(out);
}

__device__ __forceinline__ int vabs(int a) {
  return static_cast<int>(__vabsss4(static_cast<unsigned>(a)));
}

__device__ __forceinline__ int vpos(int a) {
  return static_cast<int>(__vmaxs4(static_cast<unsigned>(a), 0u));
}

__device__ __forceinline__ int vneg(int a) {
  return static_cast<int>(
      __vmaxs4(__vnegss4(static_cast<unsigned>(a)), 0u));
}

// the pass's activation word: phase mask or bit plane of 4 codes
template <int MODE>
__device__ __forceinline__ int pass_word(int xa, int ps) {
  if (MODE == MODE_PHASES) return ps == 0 ? vpos(xa) : vneg(xa);
  if (MODE == MODE_BITS)
    return static_cast<int>((static_cast<unsigned>(xa) >> ps) & 0x01010101u);
  return xa;
}

__device__ __forceinline__ float epilogue(int s, int t, float cs, float ct,
                                          bool need_t, float scale) {
  float v = __fmul_rn(cs, __int2float_rn(s));
  if (need_t) v = __fadd_rn(v, __fmul_rn(ct, __int2float_rn(t)));
  return __fmul_rn(scale, v);
}

__device__ __forceinline__ float round_to(float v, const float*) {
  return v;
}
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Pass 1: int32 partial sums of one (64x64 output tile, K range) pair,
// added into the zeroed workspace acc[plane][M][N] (planes: S of each
// accumulator, then T of each).  Integer atomics are exact and their
// order cannot change the sum.
template <int MODE, bool PACKED, bool CLAMP>
__global__ void __launch_bounds__(THREADS)
tim_accumulate(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
               int* __restrict__ acc, int M, int N, int K,
               int tiles_per_split, int need_t_flag, int n_max, int bits) {
  __shared__ __align__(16) int8_t xs[BM * BKP];
  __shared__ __align__(16) int8_t ws[BN * BKP];  // transposed: ws[n][k]
  constexpr int NACC = MODE == MODE_PHASES ? 2 : 1;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool need_t = CLAMP || need_t_flag;

  int s_acc[NACC][4][4], t_acc[NACC][4][4];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s_acc[a][i][j] = t_acc[a][i][j] = 0;

  const int k_begin = blockIdx.z * tiles_per_split * BK;
  const int k_end = min(K, k_begin + tiles_per_split * BK);
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int b = tid; b < BM * BK; b += THREADS) {
      const int r = b / BK, kk = b % BK;
      const int m = m0 + r, k = k0 + kk;
      xs[r * BKP + kk] = (m < M && k < K) ? x[(size_t)m * K + k] : 0;
    }
    if (PACKED) {
      // BK/4 packed rows; each byte holds codes k = 4p .. 4p+3
      for (int b = tid; b < (BK / 4) * BN; b += THREADS) {
        const int p = b / BN, c = b % BN;
        const int kp = k0 / 4 + p, n = n0 + c;
        const unsigned byte =
            (kp < K / 4 && n < N) ? w[(size_t)kp * N + n] : 0u;
        *reinterpret_cast<int*>(&ws[c * BKP + 4 * p]) = decode4(byte);
      }
    } else {
      const int8_t* wd = reinterpret_cast<const int8_t*>(w);
      for (int b = tid; b < BK * BN; b += THREADS) {
        const int kk = b / BN, c = b % BN;
        const int k = k0 + kk, n = n0 + c;
        ws[c * BKP + kk] = (k < K && n < N) ? wd[(size_t)k * N + n] : 0;
      }
    }
    __syncthreads();

    if (!CLAMP) {
#pragma unroll 4
      for (int kk = 0; kk < BK; kk += 4) {
        int xa[4], wb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          xa[i] = *reinterpret_cast<const int*>(&xs[(ty + 16 * i) * BKP + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wb[j] = *reinterpret_cast<const int*>(&ws[(tx + 16 * j) * BKP + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (MODE == MODE_PHASES) {
              const int p = vpos(xa[i]), q = vneg(xa[i]);
              s_acc[0][i][j] = __dp4a(p, wb[j], s_acc[0][i][j]);
              s_acc[NACC - 1][i][j] = __dp4a(q, wb[j], s_acc[NACC - 1][i][j]);
              if (need_t) {
                const int aw = vabs(wb[j]);
                t_acc[0][i][j] = __dp4a(p, aw, t_acc[0][i][j]);
                t_acc[NACC - 1][i][j] = __dp4a(q, aw, t_acc[NACC - 1][i][j]);
              }
            } else {
              s_acc[0][i][j] = __dp4a(xa[i], wb[j], s_acc[0][i][j]);
              if (need_t) {
                // bit-serial codes are non-negative: |x| == x
                const int ax = MODE == MODE_BITS ? xa[i] : vabs(xa[i]);
                t_acc[0][i][j] = __dp4a(ax, vabs(wb[j]), t_acc[0][i][j]);
              }
            }
          }
        }
      }
    } else {
      const int npass =
          MODE == MODE_BITS ? bits : (MODE == MODE_PHASES ? 2 : 1);
      for (int lb = 0; lb < BK; lb += L_BLOCK) {
        for (int ps = 0; ps < npass; ++ps) {
          int bs[4][4], bt[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) bs[i][j] = bt[i][j] = 0;
#pragma unroll
          for (int kk = lb; kk < lb + L_BLOCK; kk += 4) {
            int xa[4], wb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              xa[i] = pass_word<MODE>(*reinterpret_cast<const int*>(
                                          &xs[(ty + 16 * i) * BKP + kk]),
                                      ps);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wb[j] = *reinterpret_cast<const int*>(
                  &ws[(tx + 16 * j) * BKP + kk]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int ax = MODE == MODE_SINGLE ? vabs(xa[i]) : xa[i];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                bs[i][j] = __dp4a(xa[i], wb[j], bs[i][j]);
                bt[i][j] = __dp4a(ax, vabs(wb[j]), bt[i][j]);
              }
            }
          }
          const int a = MODE == MODE_PHASES ? ps : 0;
          const int sh = MODE == MODE_BITS ? ps : 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int n = min((bt[i][j] + bs[i][j]) / 2, n_max);
              const int k = min((bt[i][j] - bs[i][j]) / 2, n_max);
              s_acc[a][i][j] += (n - k) * (1 << sh);
              t_acc[a][i][j] += (n + k) * (1 << sh);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t plane = (size_t)M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      int* dst = acc + (size_t)m * N + n;
#pragma unroll
      for (int a = 0; a < NACC; ++a) {
        atomicAdd(dst + a * plane, s_acc[a][i][j]);
        if (need_t) atomicAdd(dst + (NACC + a) * plane, t_acc[a][i][j]);
      }
    }
  }
}

// Pass 2: the f32 epilogue of each output from the finished sums.
template <int MODE, typename OutT>
__global__ void tim_epilogue(const int* __restrict__ acc,
                             const float* __restrict__ w1,
                             const float* __restrict__ w2,
                             const float* __restrict__ iscale,
                             OutT* __restrict__ out, int M, int N,
                             int need_t) {
  constexpr int NACC = MODE == MODE_PHASES ? 2 : 1;
  const size_t plane = (size_t)M * N;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= plane) return;
  const int n = static_cast<int>(idx % N);
  const float a = w1[n], b = w2[n];
  const float cs = __fmul_rn(__fadd_rn(a, b), 0.5f);
  const float ct = __fmul_rn(__fsub_rn(a, b), 0.5f);
  const int s0 = acc[idx];
  const int t0 = need_t ? acc[idx + NACC * plane] : 0;
  float v = epilogue(s0, t0, cs, ct, need_t, iscale[0]);
  if (MODE == MODE_PHASES) {
    const int s1 = acc[idx + plane];
    const int t1 = need_t ? acc[idx + 3 * plane] : 0;
    const float p2 = round_to(epilogue(s1, t1, cs, ct, need_t, iscale[1]),
                              out);
    v = __fsub_rn(round_to(v, out), p2);
  }
  store(out + idx, v);
}

constexpr int TARGET_BLOCKS = 4 * 132;  // ~4 blocks per H100 SM

struct Args {
  const int8_t* x;
  const uint8_t* w;
  int* acc;
  int M, N, K, need_t, n_max, bits;
};

template <int MODE, bool PACKED, bool CLAMP>
void launch_acc(const Args& a, cudaStream_t st) {
  // split K so that M = 128 rows still fill the card: without it a
  // 128 x 4096 output is 128 blocks of 8 warps, one per SM
  const int mt = (a.M + BM - 1) / BM, nt = (a.N + BN - 1) / BN;
  const int tiles = (a.K + BK - 1) / BK;
  int splits = (TARGET_BLOCKS + mt * nt - 1) / (mt * nt);
  splits = std::max(1, std::min(splits, tiles));
  const int per = (tiles + splits - 1) / splits;
  splits = (tiles + per - 1) / per;
  dim3 grid(nt, mt, splits);
  tim_accumulate<MODE, PACKED, CLAMP><<<grid, THREADS, 0, st>>>(
      a.x, a.w, a.acc, a.M, a.N, a.K, per, a.need_t, a.n_max, a.bits);
}

template <int MODE, bool PACKED>
void launch_clamp(const Args& a, cudaStream_t st) {
  if (a.n_max >= 0)
    launch_acc<MODE, PACKED, true>(a, st);
  else
    launch_acc<MODE, PACKED, false>(a, st);
}

template <int MODE>
void launch_mode(const Args& a, bool packed, const float* w1, const float* w2,
                 const float* iscale, void* out, bool out_bf16,
                 cudaStream_t st) {
  if (packed)
    launch_clamp<MODE, true>(a, st);
  else
    launch_clamp<MODE, false>(a, st);
  const size_t total = (size_t)a.M * a.N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const int need_t = a.need_t || a.n_max >= 0;
  if (out_bf16)
    tim_epilogue<MODE, __nv_bfloat16><<<blocks, threads, 0, st>>>(
        a.acc, w1, w2, iscale, static_cast<__nv_bfloat16*>(out), a.M, a.N,
        need_t);
  else
    tim_epilogue<MODE, float><<<blocks, threads, 0, st>>>(
        a.acc, w1, w2, iscale, static_cast<float*>(out), a.M, a.N, need_t);
}

}  // namespace

// x: (M, K) int8; w: (K, N) int8, or (K/4, N) uint8 when packed (K is
// then the padded code count, a multiple of 4); iscale: device f32 [i1]
// or [i1, i2]; acc: a zeroed int32 workspace of (S, T) planes — one S
// plane per accumulator (2 for the two-phase mode), then as many T
// planes when T is kept (need_t, or any n_max) — each M x N; out:
// (M, N) bf16 or f32.  n_max < 0 means no clamp.  Returns
// cudaGetLastError() after the two launches.
extern "C" int tim_matmul_launch(const void* x, const void* w,
                                 const void* w1, const void* w2,
                                 const void* iscale, void* acc, void* out,
                                 int M, int N, int K, int mode, int packed,
                                 int need_t, int n_max, int bits,
                                 int out_bf16, void* stream) {
  Args a{static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
         static_cast<int*>(acc), M, N, K, need_t, n_max, bits};
  auto* f1 = static_cast<const float*>(w1);
  auto* f2 = static_cast<const float*>(w2);
  auto* is = static_cast<const float*>(iscale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_SINGLE:
      launch_mode<MODE_SINGLE>(a, packed, f1, f2, is, out, out_bf16, st);
      break;
    case MODE_PHASES:
      launch_mode<MODE_PHASES>(a, packed, f1, f2, is, out, out_bf16, st);
      break;
    case MODE_BITS:
      launch_mode<MODE_BITS>(a, packed, f1, f2, is, out, out_bf16, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
