// Paged GQA attention for Hopper (sm_90a): split-KV walk on tensor cores,
// the block-table gather inside the kernel.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/paged_attention.py
// that share _paged_attn_kernel:
//  * paged_attention_pallas for normalize=True with an uncompacted
//    table, causal or not, bf16/f32 queries, bf16/f32 or int8 KV;
//  * paged_packed_attention_pallas, the token-packed layout's T
//    single-token queries (seg != null);
//  * paged_attention_pallas for normalize=False with logical_blocks /
//    entry_valid, the compacted partials of the block-sharded path
//    (logical_blocks != null).
// All three go through paged_attention_run.
//
// Function: q (B, Sq, H, D) bf16 or f32; K/V pools (nb, bs, Hk, D) bf16
// or f32, or int8 codes with (nb, bs, Hk) bf16 scales; tables (B, nblk)
// int32; kv_valid_len (B,), q_offset (B,) int32.  Query row r of KV head
// hk is (qi = r / G, g = r % G), head h = hk*G + g, at position
// q_offset[b] + qi; it attends to logical positions kpos < kv_valid_len
// (and kpos <= its position when causal).  Query prep as the reference:
// f32(q) * D^-0.5 (on the tensor cores the scale multiplies the f32
// score instead).  int8 KV as kv_dequantize: f32(code) * f32(scale),
// rounded to the query type.  Fully masked rows come out 0, never NaN.
//
// What bounds it: memory.  Each slot's valid K/V is read once (at the
// mixed step ~0.0024 ms of HBM time for ~8 MB; at decode_32k ~0.17 ms
// for one shard's 0.55 GB), a few hundred flops per byte below the
// card's balance point.  What keeps a kernel from that bound here: the
// longest cache's walk when one block walks a whole table (the critical
// path), dot products off the tensor cores, and loads that do not
// overlap the math.
//
// Design:
//  * Split-KV (flash-decoding).  A row's table entries are cut into R
//    ranges of E entries, E = max(ceil(256 / bs), ceil(nblk / 32)), so
//    R <= 32 and a range holds >= 256 positions.  The boundaries depend
//    only on nblk, bs and the entry index (never on B, T or the SM
//    count), so a packed token and its padded-grid row walk the same
//    ranges and merge them in the same order: packed == mixed, bit for
//    bit.  One warp owns (16 query rows, one range) and writes f32
//    partials (m, l, acc) to scratch; paged_merge_kernel then merges a
//    row's ranges in ascending order by the log-sum-exp identity of
//    distrib/decode_attn._lse_merge.  A range where a row has nothing
//    valid writes only m = -1e30 and is skipped by the merge (adding it
//    would add exact zeros).
//  * Tensor cores.  Rows are ordered qi-major (r = qi*G + g), so at
//    chatglm3-6b's G = 16 a 16-row tile is the 16 heads of one query
//    position.  S = Q K^T and O += P V run as bf16 mma.sync m16n8k16
//    with f32 accumulators, 16 keys a step.  P goes in as three bf16
//    terms (hi = bf16(p), mid, lo: the rounding residues), so P V
//    carries p to f32 precision.  One bf16 rounding of p misses the
//    partials' f32 bars (1e-5, 1e-4, 1e-4) on short rows; two terms
//    (~2^-18 |p|) meet them but flip enough bf16 outputs, against the
//    f32 plain route, to move the first-step logits of ternary policies
//    through 28 layers (chip_smoke.py's kernel-vs-plain check).
//  * Staging.  Each warp runs its own ring of 3 stages of 16 keys in
//    shared memory, filled by cp.async 16 bytes a lane (chunks XOR-
//    swizzled against bank conflicts; ldmatrix feeds the MMAs).  Keys
//    are addressed one by one through the table, so any block size
//    works (block_size 64 included) and shared memory does not grow
//    with it.  int8 codes are staged raw and dequantized to bf16 in
//    shared memory just before use, exactly as the reference rounds.
//  * f32 queries (or a head size the tensor path does not take: D % 16
//    != 0 or D > 128) run paged_attn_fma_kernel: the same ranges,
//    partials and merge, with 4 rows a warp and f32 FMAs on the CUDA
//    cores; no TF32.
//
// Exactness of the masked work: a key past a row's position or length
// has p = 0 and, once the row has a valid key, corr = 1, so the update
// leaves (m, l, acc) unchanged bit for bit; a row's result depends only
// on its own query, position, length and table row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_sm90.cuh"

namespace {

using namespace tc;

constexpr int WARPS = 4;
constexpr int KT = 16;       // keys per tensor-core step
constexpr int NST = 3;       // cp.async ring depth (per warp)
constexpr int FROWS = 4;     // query rows per warp on the FMA path
constexpr int FDPL = 8;      // FMA path: D <= 32 * FDPL
constexpr float NEG_INF = -1e30f;

enum KvType { KV_BF16 = 0, KV_F32 = 1, KV_INT8 = 2 };

struct Args {
  const void *q, *k, *v;
  const __nv_bfloat16 *ks, *vs;
  const int *tbl, *seg, *vlen, *qoff, *lblk, *sel;
  float *pm, *pl, *pacc;  // scratch (rows, R), (rows, R), (rows, R, D)
  void* out;
  float *o_acc, *m_out, *l_out;
  int Sq, H, Hk, D, nb, bs, nslots, nblk, E, R;
  float qscale;
};

// ---------------------------------------------------------------------------
// small device helpers
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ size_t shfl_size(size_t v, int src) {
  const unsigned hi = __shfl_sync(0xffffffffu, (unsigned)(v >> 32), src);
  const unsigned lo = __shfl_sync(0xffffffffu, (unsigned)v, src);
  return (static_cast<size_t>(hi) << 32) | lo;
}

// ---------------------------------------------------------------------------
// the range a warp walks
// ---------------------------------------------------------------------------

// Per-warp work item: (b, hk, row tile, range r).  Walk indices w run
// over [e_begin * bs, e_end * bs): entry e = w / bs, offset j = w % bs.
struct Walk {
  int b, hk, G, gsq, trow, vl, qo, row0, r, w_begin, w_end, kend;
};

template <bool CAUSAL, bool PARTIAL, int TROWS>
__device__ __forceinline__ bool make_walk(const Args& a, int warp,
                                          Walk& w) {
  w.b = blockIdx.z;
  w.hk = blockIdx.y;
  w.G = a.H / a.Hk;
  w.gsq = w.G * a.Sq;
  const int ntiles = (w.gsq + TROWS - 1) / TROWS;
  const int item = blockIdx.x * WARPS + warp;
  if (item >= ntiles * a.R) return false;
  const int tile = item % ntiles;
  w.r = item / ntiles;
  w.row0 = tile * TROWS;
  w.trow = a.seg ? min(max(a.seg[w.b], 0), a.nslots - 1) : w.b;
  w.vl = a.vlen[w.b];
  w.qo = a.qoff[w.b];
  // the last position any row of the tile needs
  int kend = w.vl;
  if (CAUSAL) {
    const int qi_max = (min(w.row0 + TROWS, w.gsq) - 1) / w.G;
    kend = min(kend, w.qo + qi_max + 1);
  }
  w.kend = kend;
  const int e_begin = w.r * a.E;
  int e_end = min(a.nblk, e_begin + a.E);
  if (!PARTIAL) e_end = min(e_end, kend > 0 ? (kend + a.bs - 1) / a.bs : 0);
  w.w_begin = e_begin * a.bs;
  w.w_end = max(e_end, e_begin) * a.bs;
  if (PARTIAL) {
    // cut the walk to the first..last live entry of the range (a
    // compacted table keeps its live entries in front)
    const int lane = threadIdx.x % 32;
    int lo = 0x7fffffff, hi = -1;
    for (int e = e_begin + lane; e < e_end; e += 32) {
      const size_t ti = (size_t)w.trow * a.nblk + e;
      if (a.sel[ti] > 0 && a.lblk[ti] * a.bs < kend) {
        lo = min(lo, e);
        hi = max(hi, e);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (hi < 0) {
      w.w_end = w.w_begin;
    } else {
      w.w_begin = lo * a.bs;
      w.w_end = (hi + 1) * a.bs;
    }
  }
  return true;
}

// the logical position of walk index wi (-1: not a live key of the tile)
// and its pool row ((pb * bs + j) * Hk + hk)
template <bool PARTIAL>
__device__ __forceinline__ int key_of(const Args& a, const Walk& w, int wi,
                                      size_t& prow) {
  prow = 0;
  if (wi >= w.w_end) return -1;
  const int e = wi / a.bs, j = wi - e * a.bs;
  const size_t ti = (size_t)w.trow * a.nblk + e;
  int kpos = wi;
  if (PARTIAL) {
    if (a.sel[ti] <= 0) return -1;
    kpos = a.lblk[ti] * a.bs + j;
  }
  if (kpos >= w.kend) return -1;
  const int pb = min(max(a.tbl[ti], 0), a.nb - 1);
  prow = ((size_t)pb * a.bs + j) * a.Hk + w.hk;
  return kpos;
}

// m for every row of the tile; l and acc where the row had a valid key
__device__ __forceinline__ size_t scratch_row(const Args& a, const Walk& w,
                                              int r) {
  return ((size_t)(w.b * a.Hk + w.hk) * w.gsq + r) * a.R + w.r;
}

// ---------------------------------------------------------------------------
// tensor-core walk (bf16 queries, bf16 or int8 KV, D % 16 == 0, D <= DP)
// ---------------------------------------------------------------------------

template <int DP, bool QUANT>
struct Smem {
  static constexpr int ROWB = DP * 2;                  // bf16 row bytes
  static constexpr int TILE = KT * ROWB;               // one K or V tile
  static constexpr int RAW = QUANT ? KT * DP : 0;      // int8 codes tile
  static constexpr int STAGE = QUANT ? 2 * RAW : 2 * TILE;
  static constexpr int CONV = QUANT ? 2 * TILE : 0;    // dequantized K, V
  static constexpr int META = NST * KT * 4 * (QUANT ? 2 : 1);
  static constexpr int WARP = NST * STAGE + CONV + META;
};

template <int DP, bool QUANT, bool CAUSAL, bool PARTIAL>
__global__ void __launch_bounds__(WARPS * 32)
paged_attn_kernel(const Args a) {
  using S = Smem<DP, QUANT>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Walk w;
  if (!make_walk<CAUSAL, PARTIAL, 16>(a, warp, w)) return;

  unsigned char* mine = smem + warp * S::WARP;
  const uint32_t ring = smem_u32(mine);
  const uint32_t conv = ring + NST * S::STAGE;
  int* kp_s = reinterpret_cast<int*>(mine + NST * S::STAGE + S::CONV);
  int* pr_s = kp_s + NST * KT;  // QUANT: each key's scale index

  const int D = a.D;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int G = w.G;

  // Q fragments (rows row0 + g4, row0 + g4 + 8), zero past gsq or D
  uint32_t qa[DP / 16][4];
  int qpos[2];
  bool live[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = w.row0 + g4 + 8 * i;
    live[i] = r < w.gsq;
    const int qi = live[i] ? r / G : 0, g = live[i] ? r % G : 0;
    qpos[i] = w.qo + qi;
    const __nv_bfloat16* qrow =
        static_cast<const __nv_bfloat16*>(a.q) +
        (((size_t)w.b * a.Sq + qi) * a.H + w.hk * G + g) * D;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = ks * 16 + hf * 8 + 2 * t4;
        qa[ks][i + 2 * hf] =
            (live[i] && d < D)
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

  // producer: stage the next live tile of the walk into stage s
  const int kk = lane & 15, half = lane >> 4;
  const size_t esz = QUANT ? 1 : 2;
  const int chunks = static_cast<int>(D * esz / 16);  // per key row
  int nxt = w.w_begin;
  int issued = 0;
  auto try_issue = [&]() {
    while (nxt < w.w_end) {
      const int w0 = nxt;
      nxt += KT;
      size_t prow;
      const int kpos = key_of<PARTIAL>(a, w, w0 + kk, prow);
      if (__ballot_sync(0xffffffffu, kpos >= 0) == 0u) continue;
      const int s = issued % NST;
      const uint32_t kb = ring + s * S::STAGE;
      const uint32_t vb = kb + (QUANT ? S::RAW : S::TILE);
      const unsigned char* ksrc =
          static_cast<const unsigned char*>(a.k) + prow * D * esz;
      const unsigned char* vsrc =
          static_cast<const unsigned char*>(a.v) + prow * D * esz;
      const int nbytes = kpos >= 0 ? 16 : 0;
      for (int c = half; c < chunks; c += 2) {
        const uint32_t off = QUANT ? (uint32_t)(kk * DP + c * 16)
                                   : swz(0, kk, c, S::ROWB);
        cp16(kb + off, ksrc + c * 16, nbytes);
        cp16(vb + off, vsrc + c * 16, nbytes);
      }
      if (half == 0) {
        kp_s[s * KT + kk] = kpos;
        if (QUANT) pr_s[s * KT + kk] = static_cast<int>(prow);
      }
      ++issued;
      break;
    }
    cp_commit();
  };

#pragma unroll
  for (int i = 0; i < NST - 1; ++i) try_issue();

  for (int c = 0; c < issued; ++c) {
    try_issue();
    cp_wait<NST - 1>();
    __syncwarp();
    const int s = c % NST;
    uint32_t kb = ring + s * S::STAGE;
    uint32_t vb = kb + S::TILE;
    if (QUANT) {
      // dequantize the raw codes into the bf16 buffers: 16 codes a step
      const unsigned char* raw = mine + s * S::STAGE;
      for (int u = lane; u < 2 * KT * (D / 16); u += 32) {
        const int which = u / (KT * (D / 16));  // 0: K, 1: V
        const int rem = u % (KT * (D / 16));
        const int key = rem / (D / 16), c16 = rem % (D / 16);
        const int pr = pr_s[s * KT + key];
        const float sc = __bfloat162float((which ? a.vs : a.ks)[pr]);
        const int4 codes = *reinterpret_cast<const int4*>(
            raw + which * S::RAW + key * DP + c16 * 16);
        const int8_t* cb = reinterpret_cast<const int8_t*>(&codes);
        uint32_t wv[8];
#pragma unroll
        for (int x = 0; x < 8; ++x)
          wv[x] = pack_bf16(
              __float2bfloat16_rn(__fmul_rn(static_cast<float>(cb[2 * x]),
                                            sc)),
              __float2bfloat16_rn(
                  __fmul_rn(static_cast<float>(cb[2 * x + 1]), sc)));
        unsigned char* dst = mine + NST * S::STAGE + which * S::TILE;
        *reinterpret_cast<uint4*>(dst + swz(0, key, 2 * c16, S::ROWB)) =
            make_uint4(wv[0], wv[1], wv[2], wv[3]);
        *reinterpret_cast<uint4*>(dst + swz(0, key, 2 * c16 + 1, S::ROWB)) =
            make_uint4(wv[4], wv[5], wv[6], wv[7]);
      }
      __syncwarp();
      kb = conv;
      vb = conv + S::TILE;
    }

    // S = Q K^T over the 16 keys: two n-blocks of 8
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int mi = lane >> 3;
      const int key = (mi >> 1) * 8 + (lane & 7);
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        if (ks * 16 >= D) break;
        uint32_t b0, b1, b2, b3;
        ldsm_x4(swz(kb, key, 2 * ks + (mi & 1), S::ROWB), b0, b1, b2, b3);
        mma16816(sc[0], qa[ks], b0, b1);
        mma16816(sc[1], qa[ks], b2, b3);
      }
    }

    // online softmax per row (rows g4: i = 0, g4 + 8: i = 1)
    int kp[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      kp[2 * n] = kp_s[s * KT + n * 8 + 2 * t4];
      kp[2 * n + 1] = kp_s[s * KT + n * 8 + 2 * t4 + 1];
    }
    uint32_t phi[4], pmid[4], plo[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = kp[2 * n + e];
          const bool ok = k >= 0 && (!CAUSAL || k <= qpos[i]);
          x[2 * n + e] = ok ? sc[n][2 * i + e] * a.qscale : NEG_INF;
        }
      }
      float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mj = fmaxf(m[i], mx);
      const float ms = fmaxf(mj, -1e29f);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = expf(x[e] - ms);
      const float corr = expf(fminf(m[i] - ms, 0.0f));
      float rs = (p[0] + p[1]) + (p[2] + p[3]);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
      m[i] = mj;
      // A fragment of P: a0 (row g4, keys 2t..), a1 (row g4+8, keys
      // 2t..), a2 (row g4, keys 8+2t..), a3 (row g4+8, keys 8+2t..)
      split3(p[0], p[1], phi[i], pmid[i], plo[i]);
      split3(p[2], p[3], phi[i + 2], pmid[i + 2], plo[i + 2]);
    }

    // O += P V: V^T fragments by ldmatrix.trans, 16 columns each; each
    // P term runs over every column block before the next term, so no
    // MMA waits on the one before it
    {
      const int mi = lane >> 3;
      const int key = (mi & 1) * 8 + (lane & 7);
      uint32_t vf[DP / 16][4];
#pragma unroll
      for (int nd = 0; nd < DP / 16; ++nd)
        if (nd * 16 < D)
          ldsm_x4_t(swz(vb, key, 2 * nd + (mi >> 1), S::ROWB), vf[nd][0],
                    vf[nd][1], vf[nd][2], vf[nd][3]);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const uint32_t* pt = t == 0 ? plo : t == 1 ? pmid : phi;
#pragma unroll
        for (int nd = 0; nd < DP / 16; ++nd) {
          if (nd * 16 >= D) break;
          mma16816(acc[2 * nd], pt, vf[nd][0], vf[nd][1]);
          mma16816(acc[2 * nd + 1], pt, vf[nd][2], vf[nd][3]);
        }
      }
    }
    __syncwarp();
  }
  cp_wait<0>();

  // partials of this range
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    const size_t sr = scratch_row(a, w, w.row0 + g4 + 8 * i);
    if (t4 == 0) {
      a.pm[sr] = m[i];
      if (m[i] != NEG_INF) a.pl[sr] = l[i];
    }
    if (m[i] == NEG_INF) continue;
    float* dst = a.pacc + sr * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<float2*>(dst + d) =
            make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// FMA walk (f32 queries; bf16 queries at a head size the tensor path does
// not take).  Lane j holds the score of key j of a 32-key step; lane t
// owns columns t + 32c.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float ld_f(const T* p, size_t i);
template <>
__device__ __forceinline__ float ld_f(const float* p, size_t i) {
  return p[i];
}
template <>
__device__ __forceinline__ float ld_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename QT, typename KVT>
__device__ __forceinline__ float kv_val(const void* pool, size_t i,
                                        float scale) {
  if constexpr (sizeof(KVT) == 1) {
    const float x =
        __fmul_rn(static_cast<float>(static_cast<const int8_t*>(pool)[i]),
                  scale);
    if constexpr (sizeof(QT) == 2)
      return __bfloat162float(__float2bfloat16_rn(x));
    return x;
  } else {
    return ld_f(static_cast<const KVT*>(pool), i);
  }
}

template <typename QT, typename KVT, bool CAUSAL, bool PARTIAL>
__global__ void __launch_bounds__(WARPS * 32)
paged_attn_fma_kernel(const Args a) {
  constexpr bool QUANT = sizeof(KVT) == 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Walk w;
  if (!make_walk<CAUSAL, PARTIAL, FROWS>(a, warp, w)) return;
  const int D = a.D, G = w.G;

  float qr[FROWS][FDPL], acc[FROWS][FDPL], m[FROWS], l[FROWS];
  int qpos[FROWS];
  bool live[FROWS];
#pragma unroll
  for (int i = 0; i < FROWS; ++i) {
    const int r = w.row0 + i;
    live[i] = r < w.gsq;
    const int qi = live[i] ? r / G : 0, g = live[i] ? r % G : 0;
    qpos[i] = w.qo + qi;
    m[i] = NEG_INF;
    l[i] = 0.0f;
    const size_t qb = (((size_t)w.b * a.Sq + qi) * a.H + w.hk * G + g) * D;
#pragma unroll
    for (int c = 0; c < FDPL; ++c) {
      const int d = lane + 32 * c;
      acc[i][c] = 0.0f;
      qr[i][c] = (live[i] && d < D)
                     ? __fmul_rn(ld_f(static_cast<const QT*>(a.q), qb + d),
                                 a.qscale)
                     : 0.0f;
    }
  }

  for (int w0 = w.w_begin; w0 < w.w_end; w0 += 32) {
    size_t prow;
    const int kpos = key_of<PARTIAL>(a, w, w0 + lane, prow);
    const unsigned live_keys = __ballot_sync(0xffffffffu, kpos >= 0);
    if (live_keys == 0u) continue;
    float sk = 1.0f, sv = 1.0f;
    if (QUANT && kpos >= 0) {
      sk = __bfloat162float(a.ks[prow]);
      sv = __bfloat162float(a.vs[prow]);
    }
    float my_s[FROWS];
#pragma unroll
    for (int i = 0; i < FROWS; ++i) my_s[i] = NEG_INF;
    for (int j = 0; j < 32; ++j) {
      if (!(live_keys >> j & 1u)) continue;  // warp-uniform
      const size_t pj = shfl_size(prow, j);
      const float skj = __shfl_sync(0xffffffffu, sk, j);
      const int kj = __shfl_sync(0xffffffffu, kpos, j);
      float kv[FDPL];
#pragma unroll
      for (int c = 0; c < FDPL; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < D ? kv_val<QT, KVT>(a.k, pj * D + d, skj) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < FROWS; ++i) {
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < FDPL; ++c) part = fmaf(qr[i][c], kv[c], part);
        const float s = warp_sum(part);
        const bool ok = !CAUSAL || kj <= qpos[i];
        if (lane == j && ok) my_s[i] = s;
      }
    }
    float p[FROWS];
#pragma unroll
    for (int i = 0; i < FROWS; ++i) {
      const float mj = fmaxf(m[i], warp_max(my_s[i]));
      const float ms = fmaxf(mj, -1e29f);
      p[i] = expf(my_s[i] - ms);
      const float corr = expf(fminf(m[i] - ms, 0.0f));
      l[i] = l[i] * corr + warp_sum(p[i]);
#pragma unroll
      for (int c = 0; c < FDPL; ++c) acc[i][c] *= corr;
      m[i] = mj;
    }
    for (int j = 0; j < 32; ++j) {
      if (!(live_keys >> j & 1u)) continue;
      const size_t pj = shfl_size(prow, j);
      const float svj = __shfl_sync(0xffffffffu, sv, j);
      float vv[FDPL];
#pragma unroll
      for (int c = 0; c < FDPL; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? kv_val<QT, KVT>(a.v, pj * D + d, svj) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < FROWS; ++i) {
        const float pij = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < FDPL; ++c) acc[i][c] = fmaf(pij, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < FROWS; ++i) {
    if (!live[i]) continue;
    const size_t sr = scratch_row(a, w, w.row0 + i);
    if (lane == 0) {
      a.pm[sr] = m[i];
      if (m[i] != NEG_INF) a.pl[sr] = l[i];
    }
    if (m[i] == NEG_INF) continue;
#pragma unroll
    for (int c = 0; c < FDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D) a.pacc[sr * D + d] = acc[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// merge: one warp per query row, its ranges in ascending order
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename OT, bool PARTIAL>
__global__ void __launch_bounds__(256)
paged_merge_kernel(const Args a, int B) {
  const int G = a.H / a.Hk, gsq = G * a.Sq;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * a.Hk * gsq) return;
  const int r = static_cast<int>(row % gsq);
  const int bh = static_cast<int>(row / gsq);  // b * Hk + hk
  const int b = bh / a.Hk, hk = bh % a.Hk;
  const int qi = r / G, g = r % G;
  const float* pm = a.pm + row * a.R;
  const float* pl = a.pl + row * a.R;
  float M = NEG_INF;
  for (int i = 0; i < a.R; ++i) M = fmaxf(M, pm[i]);
  const float Ms = fmaxf(M, -1e29f);
  float L = 0.0f, O[FDPL];
#pragma unroll
  for (int c = 0; c < FDPL; ++c) O[c] = 0.0f;
  for (int i = 0; i < a.R; ++i) {
    const float mi = pm[i];
    if (mi == NEG_INF) continue;  // nothing valid in this range
    const float cr = expf(fmaxf(mi, -1e29f) - Ms);
    L = fmaf(cr, pl[i], L);
    const float* src = a.pacc + (row * a.R + i) * a.D;
#pragma unroll
    for (int c = 0; c < FDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < a.D) O[c] = fmaf(cr, src[d], O[c]);
    }
  }
  if constexpr (PARTIAL) {
    // (B, Hk, G, Sq) rows
    const size_t o_row = ((size_t)bh * G + g) * a.Sq + qi;
#pragma unroll
    for (int c = 0; c < FDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < a.D) a.o_acc[o_row * a.D + d] = O[c];
    }
    if (lane == 0) {
      a.m_out[o_row] = M;
      a.l_out[o_row] = L;
    }
  } else {
    const float inv = fmaxf(L, 1e-30f);
    OT* out = static_cast<OT*>(a.out) +
              (((size_t)b * a.Sq + qi) * a.H + hk * G + g) * a.D;
#pragma unroll
    for (int c = 0; c < FDPL; ++c) {
      const int d = lane + 32 * c;
      if (d < a.D) store_out(out + d, O[c] / inv);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int DP, bool QUANT, bool CAUSAL, bool PARTIAL>
cudaError_t tc_walk(dim3 grid, cudaStream_t st, const Args& a) {
  auto kern = paged_attn_kernel<DP, QUANT, CAUSAL, PARTIAL>;
  constexpr int smem = WARPS * Smem<DP, QUANT>::WARP;
  static bool opted_in = false;  // above 48 KB: once per instantiation
  if (smem > 48 * 1024 && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    opted_in = true;
  }
  kern<<<grid, WARPS * 32, smem, st>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t tc_dp(dim3 grid, cudaStream_t st, const Args& a, bool quant,
                  bool causal, bool partial) {
  if (partial)  // bf16 KV only
    return causal ? tc_walk<DP, false, true, true>(grid, st, a)
                  : tc_walk<DP, false, false, true>(grid, st, a);
  if (quant)
    return causal ? tc_walk<DP, true, true, false>(grid, st, a)
                  : tc_walk<DP, true, false, false>(grid, st, a);
  return causal ? tc_walk<DP, false, true, false>(grid, st, a)
                : tc_walk<DP, false, false, false>(grid, st, a);
}

template <typename QT, typename KVT>
cudaError_t fma_walk(dim3 grid, cudaStream_t st, const Args& a, bool causal,
                     bool partial) {
  auto kern = partial ? (causal ? paged_attn_fma_kernel<QT, KVT, true, true>
                                : paged_attn_fma_kernel<QT, KVT, false, true>)
                      : (causal ? paged_attn_fma_kernel<QT, KVT, true, false>
                                : paged_attn_fma_kernel<QT, KVT, false, false>);
  kern<<<grid, WARPS * 32, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// The one entry point of the three routes.  q_f32: 0 bf16, 1 f32 (q and
// out); kv_type: 0 bf16, 1 f32, 2 int8 (with k_scale / v_scale).  seg
// (T,) set: packed queries (Sq = 1; tables are (nslots, nblk) per slot).
// logical_blocks / entry_valid (B, nblk) set: the partials route, which
// writes o_acc (B, Hk, G, Sq, D), m_out, l_out (B, Hk, G, Sq) f32 instead
// of out.  Scratch: pm, pl (B * Hk * G * Sq, R) and pacc (..., R, D) f32,
// R = ceil(nblk / E).  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for operands the kernels do not take).
extern "C" int paged_attention_run(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* seg, const void* vlen, const void* qoff,
    const void* logical_blocks, const void* entry_valid, void* out,
    void* o_acc, void* m_out, void* l_out, void* pm, void* pl, void* pacc,
    int B, int Sq, int H, int Hk, int D, int nb, int bs, int nslots,
    int nblk, int E, int R, int causal, int q_f32, int kv_type,
    float qscale, void* stream) {
  const bool partial = logical_blocks != nullptr;
  const bool quant = kv_type == KV_INT8;
  if (D < 1 || D > 32 * FDPL || bs < 1 || Hk < 1 || H % Hk != 0 ||
      nslots < 1 || nblk < 1 || E < 1 || R != (nblk + E - 1) / E ||
      R > 64 || B < 1 || B > 65535 || Sq < 1 || kv_type < 0 ||
      kv_type > 2 || (partial && (quant || entry_valid == nullptr)) ||
      (!q_f32 && kv_type == KV_F32) || (quant && !k_scale) ||
      (seg && Sq != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.ks = static_cast<const __nv_bfloat16*>(k_scale);
  a.vs = static_cast<const __nv_bfloat16*>(v_scale);
  a.tbl = static_cast<const int*>(tables);
  a.seg = static_cast<const int*>(seg);
  a.vlen = static_cast<const int*>(vlen);
  a.qoff = static_cast<const int*>(qoff);
  a.lblk = static_cast<const int*>(logical_blocks);
  a.sel = static_cast<const int*>(entry_valid);
  a.pm = static_cast<float*>(pm);
  a.pl = static_cast<float*>(pl);
  a.pacc = static_cast<float*>(pacc);
  a.out = out;
  a.o_acc = static_cast<float*>(o_acc);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.Sq = Sq;
  a.H = H;
  a.Hk = Hk;
  a.D = D;
  a.nb = nb;
  a.bs = bs;
  a.nslots = nslots;
  a.nblk = nblk;
  a.E = E;
  a.R = R;
  a.qscale = qscale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int gsq = (H / Hk) * Sq;

  const bool tc = !q_f32 && D % 16 == 0 && D <= 128;
  const int trows = tc ? 16 : FROWS;
  const long long items = (long long)((gsq + trows - 1) / trows) * R;
  const long long nx = (items + WARPS - 1) / WARPS;
  if (nx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nx), Hk, B);
  cudaError_t e;
  if (tc)
    e = D <= 64 ? tc_dp<64>(grid, st, a, quant, causal, partial)
                : tc_dp<128>(grid, st, a, quant, causal, partial);
  else if (q_f32)
    e = kv_type == KV_F32
            ? fma_walk<float, float>(grid, st, a, causal, partial)
        : kv_type == KV_BF16
            ? fma_walk<float, __nv_bfloat16>(grid, st, a, causal, partial)
            : fma_walk<float, int8_t>(grid, st, a, causal, false);
  else
    e = quant ? fma_walk<__nv_bfloat16, int8_t>(grid, st, a, causal, false)
              : fma_walk<__nv_bfloat16, __nv_bfloat16>(grid, st, a, causal,
                                                       partial);
  if (e != cudaSuccess) return static_cast<int>(e);

  const long long rows = (long long)B * Hk * gsq;
  const dim3 mgrid(static_cast<unsigned>((rows + 7) / 8));
  if (partial)
    paged_merge_kernel<float, true><<<mgrid, 256, 0, st>>>(a, B);
  else if (q_f32)
    paged_merge_kernel<float, false><<<mgrid, 256, 0, st>>>(a, B);
  else
    paged_merge_kernel<__nv_bfloat16, false><<<mgrid, 256, 0, st>>>(a, B);
  return static_cast<int>(cudaGetLastError());
}
