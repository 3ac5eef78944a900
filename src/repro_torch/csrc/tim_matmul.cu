// TiM ternary matmul for Hopper (sm_90a): one templated kernel for the
// single-phase, two-phase and bit-serial products, over dense int8 or
// 2-bit packed ternary weights, with the optional per-L=16-block ADC
// clamp (n_max); an s8 tensor-core kernel for the products without the
// clamp; and a swap-AB s8 wgmma kernel for the single-phase product of
// packed weights without T.
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
// |x| and -x wrap per byte as int8 arithmetic does (|-128| = -128,
// max(-(-128), 0) = 0), as in the Pallas kernels.
//
// Bound: at the serving shape (M = 128 rows) the weight bytes dominate
// the traffic, so the card's bound is memory (a packed 4096x13696
// weight is 14 MB, ~4 us at 3.35 TB/s; int8 ~17 us), or the s8
// operations where T and two phases make 4 products.  Both kernels
// evaluate the f32 epilogue with __fmul_rn / __fadd_rn in the plain
// version's order, so kernel and plain version agree bit for bit.
//
// tim_tc (tim_tc_launch; no clamp, K % 16 == 0, N % 16 == 0): one block
// of 8 warps per 128 rows (all of M <= 128, so each W tile leaves HBM
// once) and 128 columns (single-phase and bit-serial: warp tiles of 64 x
// 32, S and T in 2 x 64 s32 accumulators a thread) or 64 (two-phase:
// warp tiles of 32 x 32, so that its 4 products, S and T of each phase,
// also fit in 128), over a range of K.  A ring of 4 stages of 128 K
// codes (x 128 x 128 bytes, W 128 x 128 or 64 codes, or a quarter of
// that packed) is filled by 16-byte cp.async copies.  s8 mma.sync
// m16n8k32 (s32 accumulators, exact) wants both operands K-major.
// Dense W is stored N-major: ldmatrix.trans of b16 pairs of W bytes,
// with the lanes' row addresses picking K rows {0,1,4,5,..} and
// {2,3,6,7,..}, hands each thread two K-pairs of two adjacent columns,
// and two __byte_perm turn them into the B fragments of an even and an
// odd column (a 4 x 4 byte transpose in registers; the W tile's 16-byte
// chunks are XOR-swizzled by those K rows, so the loads are free of
// bank conflicts).  Packed W needs no transpose: a byte holds 4
// consecutive K codes of one column, which decoded in byte order are
// one B-fragment register; a thread's 32-bit load of 4 adjacent columns'
// bytes gives its register of 4 n8 blocks (its MMA column l stands for
// column 4l + j of block j), and two __byte_perm per register decode it
// (the staged rows are padded so those loads are conflict-free).  The
// two-phase product takes pos and neg from each x fragment by per-byte
// SIMD; T takes |x| (or pos, neg) and |W| of the same fragments.  Where
// the grid of column tiles fills the card (the caller's `splits` = 1),
// the epilogue runs on the accumulators and writes out directly;
// otherwise K is cut into `splits` slices whose int32 sums go into a
// zeroed workspace by integer atomics (exact, order-free), and
// tim_epilogue finishes.
//
// tim_wg (tim_wg_launch; row 2: single-phase, packed W, no T, no clamp,
// K % 16 == 0, N % 16 == 0): out^T = W^T x^T on wgmma, the only route to
// the card's full s8 rate.  For 8-bit types wgmma takes both operands
// K-major; swapping A and B makes that free on both sides.  A = W^T
// comes from registers: an s8 A-fragment register holds 4 consecutive K
// codes of one wgmma row, here one W column, which is exactly one packed
// byte decoded (decode_b, two __byte_perm), so the decode needs no
// shared-memory pass and no transpose.  B = x^T comes from shared
// memory: x (M, K) row-major is already K-major for B, and its TMA box
// of 128 K codes is one 128-byte swizzle row.  The token count is
// wgmma's N (the token tile NT = 8 .. 128, the smallest power of two
// that holds M, 128-row tiles above), so small M wastes no 64-row tile.
// One block of 2 consumer warpgroups (64 W columns each, as wgmma rows)
// and a producer warp per 128 columns, NT tokens and a slice of K: the
// producer's lane 0 keeps a ring of stages (x tile + packed W tile,
// 128-byte swizzled) full by TMA, with full / empty mbarriers; each
// consumer warpgroup issues 4 wgmma m64nNTk32 per stage behind the
// previous stage's, waits for that stage's alone, and decodes the next
// stage's fragments while its own run.  Rows of x past M
// and K past the end are zero-filled by the TMA and never stored.  The
// epilogue goes through an output tile in shared memory, so out is
// written in 16-byte rows; where the column tiles do not fill the card
// the caller cuts K into slices (int32 atomics into a zeroed workspace,
// then tim_epilogue), as for tim_tc.  Bound: s8 operations at M = 128 (14.4
// G at (4096, 13696): 7.3 us), the 14 MB of packed W (4.2 us) at small
// M.
//
// tim_accumulate + tim_epilogue (everything else): two launches.  Pass
// 1: a 64x64 output tile per block of 256 threads, each thread 4x4
// outputs, over one slice of K (the TPU grid's sequential K axis and
// its VMEM accumulators become a loop over register accumulators; K is
// split across blocks until the grid holds ~4 blocks per SM, since M =
// 128 rows alone give 2 row tiles), the slices' int32 sums added into a
// workspace with integer atomics.  Pass 2: the f32 epilogue, one thread
// per output.  X and W tiles (64 K-codes each) are staged in shared
// memory, W transposed so 4 consecutive K codes of a column are one
// 32-bit word; packed weights are unpacked to int8 as the tile lands.
// Products are __dp4a (4 int8 MACs per instruction); phase masks, |x|,
// |W| and bit planes are per-byte SIMD ops on the 32-bit words.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "tc_sm90.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int BKP = BK + 4;      // padded row: 17 words, conflict-free
constexpr int THREADS = 256;     // 16 x 16 threads, 4 x 4 outputs each
constexpr int L_BLOCK = 16;

enum { MODE_SINGLE = 0, MODE_PHASES = 1, MODE_BITS = 2 };

// Four packed bytes, byte j holding codes 4p .. 4p + 3 of column j, to
// four words of 4 int8 codes b[j] (byte f = field f: code 4p + f; for
// the tc kernel, s8 B-fragment registers) and |W| in ab[j].  Each field
// picks a byte of a 4-entry table (00 -> 0, 01 -> 1, 10 (reserved) ->
// 0, 11 -> -1) by __byte_perm.
template <bool ABS>
__device__ __forceinline__ void decode_b(uint32_t w, uint32_t* b,
                                         uint32_t* ab) {
  uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  lo = (lo | (lo << 2)) & 0x33333333u;   // byte j: nibbles f0, f1
  hi = (hi | (hi << 2)) & 0x33333333u;   // byte j: nibbles f2, f3
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t sel = __byte_perm(lo, hi, j | ((j + 4) << 4));
    b[j] = __byte_perm(0xFF000100u, 0u, sel);
    if (ABS) ab[j] = __byte_perm(0x01000100u, 0u, sel);
  }
}

// one packed byte -> its 4 int8 codes
__device__ __forceinline__ int decode4(unsigned byte) {
  uint32_t b[4];
  decode_b<false>(byte, b, nullptr);
  return static_cast<int>(b[0]);
}

// |x|, max(x, 0) and max(-x, 0) of 4 int8 codes, each byte wrapping
// as int8 arithmetic does (the Pallas kernels take them in int8):
// |-128| = -128 and -(-128) = -128, so max(-(-128), 0) = 0
__device__ __forceinline__ int vabs(int a) {
  return static_cast<int>(__vabs4(static_cast<unsigned>(a)));
}

__device__ __forceinline__ int vpos(int a) {
  return static_cast<int>(__vmaxs4(static_cast<unsigned>(a), 0u));
}

__device__ __forceinline__ int vneg(int a) {
  return static_cast<int>(
      __vmaxs4(__vneg4(static_cast<unsigned>(a)), 0u));
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
              if (need_t)   // bit-serial codes too: |x| == x on [0, 127]
                t_acc[0][i][j] =
                    __dp4a(vabs(xa[i]), vabs(wb[j]), t_acc[0][i][j]);
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

// Pass 2 as a launch (after pass 1 or a K-split tensor-core product)
template <int MODE>
int launch_epilogue(const int* acc, const float* w1, const float* w2,
                    const float* iscale, void* out, int M, int N,
                    int need_t, bool out_bf16, cudaStream_t st) {
  const size_t total = (size_t)M * N;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  if (out_bf16)
    tim_epilogue<MODE, __nv_bfloat16><<<blocks, 256, 0, st>>>(
        acc, w1, w2, iscale, static_cast<__nv_bfloat16*>(out), M, N, need_t);
  else
    tim_epilogue<MODE, float><<<blocks, 256, 0, st>>>(
        acc, w1, w2, iscale, static_cast<float*>(out), M, N, need_t);
  return static_cast<int>(cudaGetLastError());
}

struct Args {
  const int8_t* x;
  const uint8_t* w;
  int* acc;
  int M, N, K, need_t, n_max, bits, sms;
};

template <int MODE, bool PACKED, bool CLAMP>
void launch_acc(const Args& a, cudaStream_t st) {
  // split K so that M = 128 rows still fill the card: without it a
  // 128 x 4096 output is 128 blocks of 8 warps, one per SM
  const int mt = (a.M + BM - 1) / BM, nt = (a.N + BN - 1) / BN;
  const int tiles = (a.K + BK - 1) / BK;
  const int target = 4 * a.sms;  // ~4 blocks per SM
  int splits = (target + mt * nt - 1) / (mt * nt);
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
  launch_epilogue<MODE>(a.acc, w1, w2, iscale, out, a.M, a.N,
                        a.need_t || a.n_max >= 0, out_bf16, st);
}

// ---------------------------------------------------------------------------
// s8 tensor-core kernel (no clamp): single-phase (and bit-serial) or
// two-phase, dense int8 or 2-bit packed W
// ---------------------------------------------------------------------------

constexpr int TM = 128;                      // rows per block
constexpr int TK = 128;                      // K codes per stage
constexpr int TST = 4;                       // cp.async ring stages
constexpr int TTHREADS = 256;                // 8 warps

// Block and warp tiles of one instance.  The single-phase product keeps
// 2 x 64 s32 accumulators per thread with T (S and T of a 64 x 32 warp
// tile); the two-phase one has 4 products (S and T of each phase), so
// its warps take 32 x 32 and its blocks 128 x 64, which keeps it at 128.
template <int MODE, bool PACKED>
struct TcTile {
  static constexpr int WM = MODE == MODE_PHASES ? 32 : 64;  // warp rows
  static constexpr int WARPS_M = TM / WM;
  static constexpr int BN = 32 * (TTHREADS / 32 / WARPS_M);  // block cols
  static constexpr int MT = WM / 16;                         // m16 tiles
  static constexpr int NP = MODE == MODE_PHASES ? 2 : 1;     // phases
  // staged W: dense, TK rows of BN codes (16-byte chunks XOR-swizzled);
  // packed, TK / 4 rows of BN bytes padded by 32, so that the 4 rows a
  // warp reads at once start 8 banks apart
  static constexpr int WROW = PACKED ? BN + 32 : BN;
  static constexpr int STAGE = TM * TK + (PACKED ? TK / 4 : TK) * WROW;
  static constexpr int SMEM = TST * STAGE;
};

// dense W tile row k: its 16-byte chunk c sits at c ^ wsw<BN>(k), so that
// the K rows one ldmatrix reads ({0,1,4,5,8,9,12,13} or those + 2) hit 8
// distinct 16-byte bank groups (rows of 128 bytes, or of 64: two rows
// per 128 bytes)
template <int BN>
__device__ __forceinline__ int wsw(int k) {
  return BN == 128 ? (k & 1) | ((k >> 1) & 6) : (k >> 2) & 3;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// MODE_SINGLE (the bit-serial product too, see tim_tc_launch) or
// MODE_PHASES; PACKED: W as (K/4, N) bytes; SPLIT: int32 sums into the
// workspace (planes: S of each phase, then T of each) instead of the
// fused epilogue.
template <int MODE, bool PACKED, bool NEED_T, bool SPLIT, typename OutT>
__global__ void __launch_bounds__(TTHREADS, 1)
tim_tc(const int8_t* __restrict__ x, const uint8_t* __restrict__ w,
       const float* __restrict__ w1, const float* __restrict__ w2,
       const float* __restrict__ iscale, int* __restrict__ acc,
       OutT* __restrict__ out, int M, int N, int K, int tiles_per_split) {
  using namespace tc;
  using S = TcTile<MODE, PACKED>;
  constexpr int MT = S::MT, NP = S::NP, BN = S::BN;
  // |x| of the single-phase fragment for T (two-phase: pos and neg are
  // non-negative, their own |x|)
  constexpr bool XT = NEED_T && MODE != MODE_PHASES;
  extern __shared__ __align__(128) unsigned char smem_t[];
  const uint32_t base = smem_u32(smem_t);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp % S::WARPS_M, wn = warp / S::WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * BN;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int ktiles = min(tiles_per_split, (K + TK - 1) / TK - kt0);

  // Rows of x past M and columns of W past N are left unloaded: a row
  // (column) of the products depends only on its own row (column) of x
  // (W), and those outputs are not stored.  x past K is zero-filled,
  // which zeroes every product term past K whatever W holds there.
  auto load = [&](int kt, int stage) {
    const int k0 = (kt0 + kt) * TK;
    const uint32_t xs = base + stage * S::STAGE, ws = xs + TM * TK;
    for (int u = tid; u < TM * TK / 16; u += TTHREADS) {
      const int r = u / (TK / 16), c = u % (TK / 16);
      const int m = m0 + r, k = k0 + 16 * c;
      if (m < M)
        cp16(xs + r * TK + ((c ^ (r & 7)) << 4),
             x + (size_t)m * K + min(k, K - 16), k < K ? 16 : 0);
    }
    for (int u = tid; u < (PACKED ? TK / 4 : TK) * BN / 16; u += TTHREADS) {
      const int kk = u / (BN / 16), c = u % (BN / 16);
      const int n = n0 + 16 * c;
      if (PACKED) {
        const int kp = k0 / 4 + kk;
        if (kp < K / 4 && n < N)
          cp16(ws + kk * S::WROW + 16 * c, w + (size_t)kp * N + n, 16);
      } else {
        const int k = k0 + kk;
        if (k < K && n < N)
          cp16(ws + kk * BN + ((c ^ wsw<BN>(kk)) << 4),
               w + (size_t)k * N + n, 16);
      }
    }
  };

  // [phase][m16 tile][n8 block j][fragment].  Dense W: block j = 2h + p
  // holds columns 16h + 2l + p (l = 0..7 its MMA column); packed: 4l + j.
  int s_acc[NP][MT][4][4], t_acc[NEED_T ? NP : 1][NEED_T ? MT : 1][4][4];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s_acc[p][i][j][e] = 0;
          if (NEED_T) t_acc[NEED_T ? p : 0][NEED_T ? i : 0][j][e] = 0;
        }

#pragma unroll
  for (int i = 0; i < TST - 1; ++i) {
    if (i < ktiles) load(i, i);
    cp_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_wait<TST - 2>();
    __syncthreads();  // tile kt landed; the stage of kt - 1 is free
    if (kt + TST - 1 < ktiles) load(kt + TST - 1, (kt + TST - 1) % TST);
    cp_commit();
    const uint32_t xs = base + (kt % TST) * S::STAGE, ws = xs + TM * TK;
#pragma unroll
    for (int ks = 0; ks < TK / 32; ++ks) {
      // B fragments (b0, b1) of this warp's 32 columns, and of |W|
      uint32_t bf[2][4], ab[2][4];
      if (PACKED) {
        // thread (g, t): b0 of block j is codes 4t .. 4t + 3 of this K
        // step's 32 in column 4g + j, one byte of packed row 8 ks + t;
        // b1 the same 16 codes on.  Two 32-bit loads, no transpose.
        const unsigned char* wp = smem_t + (ws - base) + 32 * wn + 4 * g;
#pragma unroll
        for (int f = 0; f < 2; ++f)
          decode_b<NEED_T>(*reinterpret_cast<const uint32_t*>(
                               wp + (8 * ks + 4 * f + t) * S::WROW),
                           bf[f], ab[f]);
      } else {
        // ldmatrix.trans of b16 pairs hands each thread two K-pairs of
        // two adjacent columns; two __byte_perm make the B fragments of
        // the even and the odd column (a 4 x 4 byte transpose)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 2 * wn + h, i = lane >> 3, r = lane & 7;
          const int kk =
              ks * 32 + 16 * (i >> 1) + 2 * (i & 1) + (r & 1) + 4 * (r >> 1);
          uint32_t r0, r1, r2, r3;
          ldsm_x4_t(ws + kk * BN + ((c ^ wsw<BN>(kk)) << 4), r0, r1, r2, r3);
          bf[0][2 * h] = __byte_perm(r0, r1, 0x6420);
          bf[1][2 * h] = __byte_perm(r2, r3, 0x6420);
          bf[0][2 * h + 1] = __byte_perm(r0, r1, 0x7531);
          bf[1][2 * h + 1] = __byte_perm(r2, r3, 0x7531);
        }
        if (NEED_T)
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int j = 0; j < 4; ++j) ab[f][j] = vabs(bf[f][j]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row0 = S::WM * wm + 16 * mt;
        if (m0 + row0 >= M) continue;  // warp-uniform: rows not stored
        uint32_t a[4];
        const int r = row0 + (lane & 7) + 8 * ((lane >> 3) & 1);
        const int c = 2 * ks + (lane >> 4);
        ldsm_x4(xs + r * TK + ((c ^ (r & 7)) << 4), a[0], a[1], a[2], a[3]);
        // the activation fragment of each phase, and its |x| for T
        uint32_t xa[NP][4], xt[XT ? 4 : 1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (MODE == MODE_PHASES) {
            xa[0][e] = vpos(a[e]);
            xa[NP - 1][e] = vneg(a[e]);
          } else {
            xa[0][e] = a[e];
            if (XT) xt[XT ? e : 0] = vabs(a[e]);
          }
        }
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            mma16832_s8(s_acc[p][mt][j], xa[p], bf[0][j], bf[1][j]);
            if (NEED_T)
              mma16832_s8(t_acc[NEED_T ? p : 0][NEED_T ? mt : 0][j],
                          XT ? xt : xa[p], ab[0][j], ab[1][j]);
          }
      }
    }
  }
  cp_wait<0>();

  // thread (g, t) holds rows g and g + 8 of each m16 tile, 8 columns in
  // two groups q of 4 adjacent ones: dense 16q + 4t + i (block 2q +
  // (i & 1), fragment i >> 1), packed 8t + 4q + i (block i, fragment q);
  // fragments 2 and 3 are row g + 8's
  const float i1 = SPLIT ? 0.0f : iscale[0];
  const float i2 = SPLIT || NP == 1 ? 0.0f : iscale[1];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int n = n0 + 32 * wn + (PACKED ? 8 * t + 4 * q : 16 * q + 4 * t);
    if (n >= N) continue;  // N % 16 == 0: all 4 columns in or out
    float cs[4] = {0, 0, 0, 0}, ct[4] = {0, 0, 0, 0};
    if (!SPLIT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = w1[n + i], b = w2[n + i];
        cs[i] = __fmul_rn(__fadd_rn(a, b), 0.5f);
        ct[i] = __fmul_rn(__fsub_rn(a, b), 0.5f);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + S::WM * wm + 16 * mt + g + 8 * hr;
        if (m >= M) continue;
        const size_t idx = (size_t)m * N + n, plane = (size_t)M * N;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = PACKED ? i : 2 * q + (i & 1);
          const int e = (PACKED ? q : i >> 1) + 2 * hr;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int sv = s_acc[p][mt][j][e];
            const int tv =
                NEED_T ? t_acc[NEED_T ? p : 0][NEED_T ? mt : 0][j][e] : 0;
            if (SPLIT) {
              atomicAdd(acc + p * plane + idx + i, sv);
              if (NEED_T) atomicAdd(acc + (NP + p) * plane + idx + i, tv);
            } else if (p == 0) {
              v[i] = epilogue(sv, tv, cs[i], ct[i], NEED_T, i1);
            } else {
              // each phase rounded to the output type before p1 - p2
              const float p2 =
                  round_to(epilogue(sv, tv, cs[i], ct[i], NEED_T, i2), out);
              v[i] = __fsub_rn(round_to(v[i], out), p2);
            }
          }
        }
        if (!SPLIT) store4(out + idx, v);
      }
    }
  }
}

template <int MODE, bool PACKED, bool NEED_T, bool SPLIT, typename OutT>
int go_tc(const int8_t* x, const uint8_t* w, const float* w1,
          const float* w2, const float* iscale, int* acc, void* out, int M,
          int N, int K, int splits, cudaStream_t st) {
  using S = TcTile<MODE, PACKED>;
  auto kern = tim_tc<MODE, PACKED, NEED_T, SPLIT, OutT>;
  static bool opted_in = false;  // above 48 KB: once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int ktiles = (K + TK - 1) / TK;
  const int per = (ktiles + splits - 1) / splits;
  const dim3 grid((N + S::BN - 1) / S::BN, (M + TM - 1) / TM,
                  (ktiles + per - 1) / per);
  kern<<<grid, TTHREADS, S::SMEM, st>>>(x, w, w1, w2, iscale, acc,
                                        static_cast<OutT*>(out), M, N, K,
                                        per);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool PACKED, bool NEED_T>
int go_tc_out(const int8_t* x, const uint8_t* w, const float* w1,
              const float* w2, const float* iscale, int* acc, void* out,
              int M, int N, int K, int splits, bool out_bf16,
              cudaStream_t st) {
  if (splits > 1) {
    const int e = go_tc<MODE, PACKED, NEED_T, true, float>(
        x, w, w1, w2, iscale, acc, out, M, N, K, splits, st);
    if (e != 0) return e;
    return launch_epilogue<MODE>(acc, w1, w2, iscale, out, M, N, NEED_T,
                                 out_bf16, st);
  }
  return out_bf16 ? go_tc<MODE, PACKED, NEED_T, false, __nv_bfloat16>(
                        x, w, w1, w2, iscale, acc, out, M, N, K, 1, st)
                  : go_tc<MODE, PACKED, NEED_T, false, float>(
                        x, w, w1, w2, iscale, acc, out, M, N, K, 1, st);
}

template <int MODE, bool PACKED>
int go_tc_t(const int8_t* x, const uint8_t* w, const float* w1,
            const float* w2, const float* iscale, int* acc, void* out,
            int M, int N, int K, int need_t, int splits, bool out_bf16,
            cudaStream_t st) {
  return need_t ? go_tc_out<MODE, PACKED, true>(x, w, w1, w2, iscale, acc,
                                                out, M, N, K, splits,
                                                out_bf16, st)
                : go_tc_out<MODE, PACKED, false>(x, w, w1, w2, iscale, acc,
                                                 out, M, N, K, splits,
                                                 out_bf16, st);
}

template <int MODE>
int go_tc_p(const int8_t* x, const uint8_t* w, const float* w1,
            const float* w2, const float* iscale, int* acc, void* out,
            int M, int N, int K, int packed, int need_t, int splits,
            bool out_bf16, cudaStream_t st) {
  return packed ? go_tc_t<MODE, true>(x, w, w1, w2, iscale, acc, out, M, N,
                                      K, need_t, splits, out_bf16, st)
                : go_tc_t<MODE, false>(x, w, w1, w2, iscale, acc, out, M,
                                       N, K, need_t, splits, out_bf16, st);
}

// ---------------------------------------------------------------------------
// swap-AB s8 wgmma kernel: the single-phase product of packed W without T
// or the clamp, as out^T = W^T x^T
// ---------------------------------------------------------------------------

constexpr int WG_COLS = 128;                     // W columns per block
constexpr int WG_TK = 128;                       // K codes per stage
constexpr int WG_CONS = 256;                     // 2 consumer warpgroups
constexpr int WG_THREADS = WG_CONS + 32;         // + the producer warp
constexpr int WG_WBYTES = WG_TK / 4 * WG_COLS;   // packed W stage: 32 x 128

// Shared memory of the instance with token tile NT (offsets from a
// 1024-byte aligned base): a ring of STAGES stages, each the x tile (NT
// tokens x 128 K codes) and the packed W tile (32 packed rows x 128
// columns), both 128-byte swizzled by the TMA; the output tile (NT rows
// of 128 values of OutT, padded by 16 bytes) reuses the ring after the
// last product; then the mbarriers full[STAGES], empty[STAGES].
template <int NT, typename OutT>
struct WgLayout {
  static constexpr int XBYTES = NT * WG_TK;
  static constexpr int STAGE = XBYTES + WG_WBYTES;
  static constexpr int STAGES =
      160 * 1024 / STAGE < 16 ? 160 * 1024 / STAGE : 16;
  static constexpr int PITCH = WG_COLS * static_cast<int>(sizeof(OutT)) + 16;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BAR = RING > NT * PITCH ? RING : NT * PITCH;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + align
};

// The A fragments of one stage for thread (g, t) of warp `chunk` (its 16
// columns are 16 chunk .. 16 chunk + 15 of the block's 128): K step ks
// needs packed rows 8 ks + t (a0, a1) and 8 ks + 4 + t (a2, a3), at the
// two columns that stand for its rows g and g + 8, the bytes 2g and 2g +
// 1 of the warp's 16.  Two 16-bit loads per K step, one word of 4
// packed bytes, decoded by decode_b straight into a0 .. a3.  The TMA's
// 128-byte swizzle puts 16-byte chunk c of packed row r at c ^ (r & 7):
// the 4 rows t = 0..3 a warp reads at once sit in 4 distinct chunks, so
// the loads are free of bank conflicts.
__device__ __forceinline__ void wg_decode(const unsigned char* ws,
                                          int chunk, int g, int t,
                                          uint32_t (&a)[WG_TK / 32][4]) {
  const unsigned char* p0 = ws + t * 128 + ((chunk ^ t) << 4) + 2 * g;
  const unsigned char* p1 =
      ws + (t + 4) * 128 + ((chunk ^ (t + 4)) << 4) + 2 * g;
#pragma unroll
  for (int ks = 0; ks < WG_TK / 32; ++ks) {
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(p0 + 1024 * ks);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(p1 + 1024 * ks);
    decode_b<false>(lo | (hi << 16), a[ks], nullptr);
  }
}

// OutT float / __nv_bfloat16: the epilogue fused, out (M, N); OutT int:
// the block's int32 sums over its K slice added into the zeroed
// workspace out (M, N) (tim_epilogue finishes).
template <int NT, typename OutT>
__global__ void __launch_bounds__(WG_THREADS, 1)
tim_wg(const __grid_constant__ CUtensorMap tx,
       const __grid_constant__ CUtensorMap tw, const float* __restrict__ w1,
       const float* __restrict__ w2, const float* __restrict__ iscale,
       OutT* __restrict__ out, int M, int N, int K, int tiles_per_split) {
  using namespace tc;
  using L = WgLayout<NT, OutT>;
  constexpr bool SPLIT = std::is_same<OutT, int>::value;
  extern __shared__ unsigned char smem_w[];
  const uint32_t raw = smem_u32(smem_w);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* const gbase = smem_w + (base - raw);
  const uint32_t full = base + L::BAR, empty = full + 8 * L::STAGES;
  const int n0 = blockIdx.x * WG_COLS, m0 = blockIdx.y * NT;
  const int kt0 = blockIdx.z * tiles_per_split;
  const int ktiles = min(tiles_per_split, (K + WG_TK - 1) / WG_TK - kt0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG_CONS / 32);  // one arrival a warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WG_CONS / 32) {  // the producer warp
    if (lane == 0) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % L::STAGES;
        // the stage's previous tile released by every consumer
        if (kt >= L::STAGES)
          mbar_wait(empty + 8 * s, (kt / L::STAGES - 1) & 1);
        const uint32_t xs = base + s * L::STAGE;
        mbar_expect_tx(full + 8 * s, L::STAGE);
        tma_load_2d(xs, &tx, full + 8 * s, (kt0 + kt) * WG_TK, m0);
        tma_load_2d(xs + L::XBYTES, &tw, full + 8 * s, n0,
                    (kt0 + kt) * (WG_TK / 4));
      }
    }
    return;
  }

  // warp `chunk` (warpgroup chunk / 4) computes rows 16 (chunk % 4) ..
  // of its warpgroup's 64 = the block's columns 16 chunk + 2g (row g)
  // and 16 chunk + 2g + 1 (row g + 8)
  const int chunk = warp, g = lane >> 2, t = lane & 3;
  int acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
  uint32_t a[2][WG_TK / 32][4];  // the A fragments of two stages

  // One stage: queue its 4 products behind the previous stage's (the
  // same accumulators), wait for the previous stage's alone, release
  // that stage, and decode the next stage's fragments into the
  // registers it read while this stage's products run.
  auto step = [&](int kt, uint32_t (&cur)[WG_TK / 32][4],
                  uint32_t (&nxt)[WG_TK / 32][4]) {
    const uint32_t xs = base + (kt % L::STAGES) * L::STAGE;
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < WG_TK / 32; ++ks)
      wgmma_s8_rs<NT>(acc, cur[ks], wg_desc(xs + 32 * ks, 16, 1024));
    wg_commit();
    wg_wait<1>();
    wg_pin<4 * WG_TK / 32>(&nxt[0][0]);
    __syncwarp();
    if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % L::STAGES));
    if (kt + 1 < ktiles) {
      const int s1 = (kt + 1) % L::STAGES;
      mbar_wait(full + 8 * s1, ((kt + 1) / L::STAGES) & 1);
      wg_decode(gbase + s1 * L::STAGE + L::XBYTES, chunk, g, t, nxt);
    }
  };
  mbar_wait(full, 0);
  wg_decode(gbase + L::XBYTES, chunk, g, t, a[0]);
  for (int kt = 0; kt < ktiles; kt += 2) {
    step(kt, a[0], a[1]);
    if (kt + 1 < ktiles) step(kt + 1, a[1], a[0]);
  }
  wg_wait<0>();
  wg_pin<NT / 2>(acc);

  // Epilogue: the transposed accumulator (rows = columns, columns =
  // tokens: d[4j + e] is token 8j + 2t + e of column c, d[4j + 2 + e]
  // of column c + 1) goes to an output tile in shared memory, pairs of
  // columns at once (row pitch = 16 mod 64 bytes: the 4 tokens 2t of a
  // store land 32 bytes apart, free of bank conflicts), then out in
  // 16-byte rows (the workspace: one int a thread, each warp's atomics
  // on 128 contiguous bytes).
  named_sync(1, WG_CONS);  // every warpgroup is done with the ring
  const int c = 16 * chunk + 2 * g;
  float cs0 = 0.0f, cs1 = 0.0f, i1 = 0.0f;
  if (!SPLIT) {
    if (n0 + c < N) {  // N % 16 == 0: both columns in or out
      cs0 = __fmul_rn(__fadd_rn(w1[n0 + c], w2[n0 + c]), 0.5f);
      cs1 = __fmul_rn(__fadd_rn(w1[n0 + c + 1], w2[n0 + c + 1]), 0.5f);
    }
    i1 = iscale[0];
  }
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      unsigned char* dst =
          gbase + (8 * j + 2 * t + e) * L::PITCH + c * sizeof(OutT);
      const int s0 = acc[4 * j + e], s1 = acc[4 * j + 2 + e];
      if constexpr (SPLIT) {
        *reinterpret_cast<int2*>(dst) = make_int2(s0, s1);
      } else {
        const float v0 = epilogue(s0, 0, cs0, 0.0f, false, i1);
        const float v1 = epilogue(s1, 0, cs1, 0.0f, false, i1);
        if constexpr (std::is_same<OutT, float>::value)
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  named_sync(1, WG_CONS);
  const int rows = min(NT, M - m0);
  if constexpr (SPLIT) {
    for (int i = tid; i < rows * WG_COLS; i += WG_CONS) {
      const int r = i / WG_COLS, cc = i % WG_COLS;
      if (n0 + cc < N)
        atomicAdd(out + (size_t)(m0 + r) * N + n0 + cc,
                  *reinterpret_cast<const int*>(gbase + r * L::PITCH +
                                                4 * cc));
    }
  } else {
    constexpr int VPC = 16 / sizeof(OutT);  // values per 16 bytes
    constexpr int CPR = WG_COLS / VPC;      // 16-byte chunks per row
    for (int i = tid; i < rows * CPR; i += WG_CONS) {
      const int r = i / CPR, cc = (i % CPR) * VPC;
      if (n0 + cc < N)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + cc) =
            *reinterpret_cast<const uint4*>(gbase + r * L::PITCH +
                                            cc * sizeof(OutT));
    }
  }
}

// a (rows, cols) byte matrix as a 2-d tensor map, boxes of 128 bytes x
// `box_rows` rows, 128-byte swizzled; reads past either edge give zeros
bool byte_map(CUtensorMap* map, const void* p, int rows, int cols,
              int box_rows) {
  const tc::EncodeTiled enc = tc::encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NT, typename OutT>
int go_wg(const CUtensorMap& tx, const CUtensorMap& tw, const float* w1,
          const float* w2, const float* iscale, void* out, int M, int N,
          int K, int splits, cudaStream_t st) {
  auto kern = tim_wg<NT, OutT>;
  constexpr int smem = WgLayout<NT, OutT>::BYTES;
  static bool opted_in = false;  // above 48 KB: once per instantiation
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const int ktiles = (K + WG_TK - 1) / WG_TK;
  const int per = (ktiles + splits - 1) / splits;
  const dim3 grid((N + WG_COLS - 1) / WG_COLS, (M + NT - 1) / NT,
                  (ktiles + per - 1) / per);
  kern<<<grid, WG_THREADS, smem, st>>>(tx, tw, w1, w2, iscale,
                                       static_cast<OutT*>(out), M, N, K,
                                       per);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int go_wg_out(const CUtensorMap& tx, const CUtensorMap& tw, const float* w1,
              const float* w2, const float* iscale, int* acc, void* out,
              int M, int N, int K, int splits, bool out_bf16,
              cudaStream_t st) {
  if (splits > 1) {
    const int e =
        go_wg<NT, int>(tx, tw, w1, w2, iscale, acc, M, N, K, splits, st);
    if (e != 0) return e;
    return launch_epilogue<MODE_SINGLE>(acc, w1, w2, iscale, out, M, N, 0,
                                        out_bf16, st);
  }
  return out_bf16 ? go_wg<NT, __nv_bfloat16>(tx, tw, w1, w2, iscale, out, M,
                                             N, K, 1, st)
                  : go_wg<NT, float>(tx, tw, w1, w2, iscale, out, M, N, K, 1,
                                     st);
}

}  // namespace

// x: (M, K) int8; w: (K, N) int8, or (K/4, N) uint8 when packed (K is
// then the padded code count, a multiple of 4); iscale: device f32 [i1]
// or [i1, i2]; acc: a zeroed int32 workspace of (S, T) planes — one S
// plane per accumulator (2 for the two-phase mode), then as many T
// planes when T is kept (need_t, or any n_max) — each M x N; out:
// (M, N) bf16 or f32.  n_max < 0 means no clamp.  sms: the card's
// streaming multiprocessors, which K is split to fill.  Returns
// cudaGetLastError() after the two launches.
extern "C" int tim_matmul_launch(const void* x, const void* w,
                                 const void* w1, const void* w2,
                                 const void* iscale, void* acc, void* out,
                                 int M, int N, int K, int mode, int packed,
                                 int need_t, int n_max, int bits,
                                 int out_bf16, int sms, void* stream) {
  Args a{static_cast<const int8_t*>(x), static_cast<const uint8_t*>(w),
         static_cast<int*>(acc), M, N, K, need_t, n_max, bits, sms};
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

// The s8 tensor-core product without the clamp (tim_tc above): x (M, K)
// int8; w (K, N) int8, or (K/4, N) uint8 when packed; K % 16 == 0 and
// N % 16 == 0, rows 16-byte aligned; mode 0 (single), 1 (two-phase,
// iscale [i1, i2]) or 2 (bit-serial: without the clamp sum_b (plane_b @
// W) << b == codes @ W, and T likewise with |codes| == codes, exactly in
// int32, so it is the single-phase product of the codes); splits: the
// number of K slices (1: the epilogue fused, acc unused; > 1: acc a
// zeroed int32 workspace of the S plane of each phase, then as many T
// planes when need_t, each M x N).  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int tim_tc_launch(const void* x, const void* w, const void* w1,
                             const void* w2, const void* iscale, void* acc,
                             void* out, int M, int N, int K, int mode,
                             int packed, int need_t, int splits,
                             int out_bf16, void* stream) {
  if (M < 1 || N < 16 || K < 16 || N % 16 != 0 || K % 16 != 0 ||
      splits < 1 || splits > (K + TK - 1) / TK ||
      (splits > 1 && acc == nullptr) || (M + TM - 1) / TM > 65535 ||
      mode < MODE_SINGLE || mode > MODE_BITS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* xs = static_cast<const int8_t*>(x);
  auto* ws = static_cast<const uint8_t*>(w);
  auto* f1 = static_cast<const float*>(w1);
  auto* f2 = static_cast<const float*>(w2);
  auto* is = static_cast<const float*>(iscale);
  auto* ac = static_cast<int*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == MODE_PHASES)
    return go_tc_p<MODE_PHASES>(xs, ws, f1, f2, is, ac, out, M, N, K, packed,
                                need_t, splits, out_bf16, st);
  return go_tc_p<MODE_SINGLE>(xs, ws, f1, f2, is, ac, out, M, N, K, packed,
                              need_t, splits, out_bf16, st);
}

// The swap-AB wgmma product (tim_wg above): the single-phase product of
// x (M, K) int8 and packed w (K/4, N) uint8, without T or the clamp;
// K % 16 == 0, N % 16 == 0, x and w 16-byte aligned; nt: the token tile
// (8, 16, 32, 64 or 128 rows of x a block); splits: the number of K
// slices (1: the epilogue fused, acc unused; > 1: acc a zeroed int32
// workspace (M, N)).  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape it does not take (or a tensor map
// cuTensorMapEncodeTiled refuses).
extern "C" int tim_wg_launch(const void* x, const void* w, const void* w1,
                             const void* w2, const void* iscale, void* acc,
                             void* out, int M, int N, int K, int nt,
                             int splits, int out_bf16, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if ((nt != 8 && nt != 16 && nt != 32 && nt != 64 && nt != 128) || M < 1 ||
      N < 16 || K < 16 || N % 16 != 0 || K % 16 != 0 || splits < 1 ||
      splits > (K + WG_TK - 1) / WG_TK || (splits > 1 && acc == nullptr) ||
      (M + nt - 1) / nt > 65535)
    return bad;
  CUtensorMap tx, tw;
  if (!byte_map(&tx, x, M, K, nt) || !byte_map(&tw, w, K / 4, N, WG_TK / 4))
    return bad;
  auto* f1 = static_cast<const float*>(w1);
  auto* f2 = static_cast<const float*>(w2);
  auto* is = static_cast<const float*>(iscale);
  auto* ac = static_cast<int*>(acc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nt) {
    case 8:
      return go_wg_out<8>(tx, tw, f1, f2, is, ac, out, M, N, K, splits,
                          out_bf16, st);
    case 16:
      return go_wg_out<16>(tx, tw, f1, f2, is, ac, out, M, N, K, splits,
                           out_bf16, st);
    case 32:
      return go_wg_out<32>(tx, tw, f1, f2, is, ac, out, M, N, K, splits,
                           out_bf16, st);
    case 64:
      return go_wg_out<64>(tx, tw, f1, f2, is, ac, out, M, N, K, splits,
                           out_bf16, st);
    case 128:
      return go_wg_out<128>(tx, tw, f1, f2, is, ac, out, M, N, K, splits,
                            out_bf16, st);
    default:
      return bad;
  }
}
