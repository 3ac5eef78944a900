// Paged GQA attention for Hopper (sm_90a): the block-table gather runs
// inside the kernel.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/paged_attention.py
// that share _paged_attn_kernel:
//  * paged_attention_pallas for normalize=True with an uncompacted
//    table, causal or not, bf16 or int8 KV (paged_attention_launch);
//  * paged_packed_attention_pallas, the token-packed layout's T
//    single-token queries (paged_packed_attention_launch);
//  * paged_attention_pallas for normalize=False with logical_blocks /
//    entry_valid, the compacted partials of the block-sharded path
//    (paged_attention_partials_launch).
//
// Function: q (B, Sq, H, D) bf16; K/V pools (nb, bs, Hk, D) bf16, or
// int8 codes with (nb, bs, Hk) bf16 scales; tables (B, nblk) int32;
// kv_valid_len (B,), q_offset (B,) int32.  Query row r of KV head hk is
// (g = r / Sq, qi = r % Sq), head h = hk*G + g, at position
// q_offset[b] + qi; it attends to logical positions kpos < kv_valid_len
// (and kpos <= its position when causal).  Query prep as the reference:
// f32(q) * D^-0.5.  int8 KV as kv_dequantize: f32(code) * f32(scale),
// rounded to bf16, back to f32.  Fully masked rows come out 0 (the
// m_safe guard), never NaN.
//
// Design: one block of 4 warps per (16 query rows, KV head, slot).  The
// Pallas kernel assembled a (G*Sq, chunk_kv) f32 score tile in VMEM
// (~1 MiB at the serving shape), which does not fit shared memory; here
// each block walks its slot's table itself, stages one physical KV
// block (bs <= 32 positions) in shared memory as f32, and runs the
// online-softmax update per KV block.  Lane j of a warp holds the score
// of key j, so the block max/sum are warp reductions and p stays in
// registers.  The walk stops at the last block holding a valid
// position, so work follows kv_valid_len, not the table width.  The
// softmax is taken per KV block instead of per chunk_kv positions,
// which changes rounding (not the function); the plain version beside
// the wrapper is the reference for the tolerance.
//
// Packed queries: q (T, 1, H, D) with per-token seg_ids, kv_valid_len
// and q_offset (T,); token t reads row clamp(seg[t], 0, slots-1) of the
// per-SLOT table (slots, nblk) inside the kernel, so no (T, nblk)
// gathered table exists.  It is the same compiled kernel with Sq = 1
// and a table-row indirection: every token row runs exactly the mixed
// route's per-row arithmetic, and since blocks past a row's position are
// masked to an exact no-op there (p = 0, corr = 1), a packed token's
// output equals the mixed grid's output for that token bit for bit.
// Tokens of one slot each re-read that slot's K/V (from L2 after the
// first), a cost the padded grid's shared 16-row tile does not pay.
//
// Un-normalized partials over a compacted table (PARTIAL): the branch of
// _paged_attn_kernel with compacted=True, normalize=False, which
// distrib/decode_attn.sharded_paged_mixed_attention feeds its
// cross-shard log-sum-exp merge (paged_attention_partials_launch).
// Table entry e of a row covers logical block logical_blocks[row, e]
// (positions lblk*bs + j) and counts only where entry_valid[row, e] > 0;
// the kernel writes the running acc (B, Hk, G, Sq, D), the raw running
// max m (-1e30 where nothing is valid) and l (B, Hk, G, Sq), all f32,
// where the normalized route writes bf16(acc / l).  The walk visits all
// nblk entries and skips, without staging it, an entry that is invalid
// or starts at or past kv_valid_len: such an entry is an exact no-op of
// the update (p = 0, corr = 1, or l = acc = 0 while nothing is valid),
// so a shard's work follows its own valid blocks, 1/n of the cache.
// bf16 KV only (the sharded path passes no scales).
//
// Bound: memory (each slot's valid K/V bytes are read once per 16-row
// tile, from L2 after the first; for the partials, each shard's valid
// blocks once); this first kernel is limited by its warp-shuffle dot
// products instead.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // query rows per block
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

template <int DPL, bool QUANT, bool CAUSAL, bool PARTIAL>
__global__ void __launch_bounds__(WARPS * 32)
paged_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const void* __restrict__ k_pool,
                  const void* __restrict__ v_pool,
                  const __nv_bfloat16* __restrict__ k_scale,
                  const __nv_bfloat16* __restrict__ v_scale,
                  const int* __restrict__ tables,
                  const int* __restrict__ seg,
                  const int* __restrict__ vlen_arr,
                  const int* __restrict__ qoff_arr,
                  const int* __restrict__ lblocks,
                  const int* __restrict__ entry_valid,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ o_acc, float* __restrict__ m_out,
                  float* __restrict__ l_out, int Sq, int H, int Hk,
                  int D, int nb, int bs, int nslots, int nblk,
                  float qscale) {
  extern __shared__ float smem[];
  float* ks = smem;            // (bs, D)
  float* vs = smem + bs * D;   // (bs, D)

  const int b = blockIdx.z, hk = blockIdx.y;
  const int G = H / Hk, gsq = G * Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int vl = vlen_arr[b], qo = qoff_arr[b];
  // the table row: the slot itself, or (packed) the token's segment
  const int row = seg ? min(max(seg[b], 0), nslots - 1) : b;

  float qr[ROWS_PER_WARP][DPL], acc[ROWS_PER_WARP][DPL];
  float m[ROWS_PER_WARP], l[ROWS_PER_WARP];
  int qpos[ROWS_PER_WARP];
  bool live[ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = blockIdx.x * ROWS + warp * ROWS_PER_WARP + i;
    live[i] = r < gsq;
    const int g = live[i] ? r / Sq : 0, qi = live[i] ? r % Sq : 0;
    qpos[i] = qo + qi;
    const int h = hk * G + g;
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      acc[i][c] = 0.0f;
      qr[i][c] = (live[i] && d < D)
          ? __fmul_rn(__bfloat162float(
                          q[(((size_t)b * Sq + qi) * H + h) * D + d]),
                      qscale)
          : 0.0f;
    }
  }

  const int nblocks = PARTIAL ? nblk : min(nblk, (vl + bs - 1) / bs);
  for (int e = 0; e < nblocks; ++e) {
    int lb = e;  // the logical block of entry e
    if constexpr (PARTIAL) {
      lb = lblocks[(size_t)row * nblk + e];
      // block-uniform: an exact no-op entry is skipped, not staged
      if (entry_valid[(size_t)row * nblk + e] <= 0 ||
          lb >= (vl + bs - 1) / bs)
        continue;
    }
    const int pb = min(max(tables[(size_t)row * nblk + e], 0), nb - 1);
    __syncthreads();
    for (int idx = threadIdx.x; idx < bs * D; idx += WARPS * 32) {
      const int j = idx / D, d = idx % D;
      const size_t row = ((size_t)pb * bs + j) * Hk + hk;
      float kv, vv;
      if (QUANT) {
        const float sk = __bfloat162float(k_scale[row]);
        const float sv = __bfloat162float(v_scale[row]);
        const int8_t* kc = static_cast<const int8_t*>(k_pool);
        const int8_t* vc = static_cast<const int8_t*>(v_pool);
        kv = __bfloat162float(__float2bfloat16_rn(
            __fmul_rn(static_cast<float>(kc[row * D + d]), sk)));
        vv = __bfloat162float(__float2bfloat16_rn(
            __fmul_rn(static_cast<float>(vc[row * D + d]), sv)));
      } else {
        kv = __bfloat162float(
            static_cast<const __nv_bfloat16*>(k_pool)[row * D + d]);
        vv = __bfloat162float(
            static_cast<const __nv_bfloat16*>(v_pool)[row * D + d]);
      }
      ks[idx] = kv;
      vs[idx] = vv;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      if (!live[i]) continue;  // warp-uniform
      float my_s = NEG_INF;    // lane j keeps the score of key j
      for (int j = 0; j < bs; ++j) {
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < D) part = fmaf(qr[i][c], ks[j * D + d], part);
        }
        const float s = warp_sum(part);
        const int kpos = lb * bs + j;
        const bool ok = kpos < vl && (!CAUSAL || qpos[i] >= kpos);
        if (lane == j) my_s = ok ? s : NEG_INF;
      }
      const float mj = fmaxf(m[i], warp_max(my_s));
      const float m_safe = fmaxf(mj, -1e29f);
      const float p = lane < bs ? expf(my_s - m_safe) : 0.0f;
      const float corr = expf(fminf(m[i] - m_safe, 0.0f));
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
      for (int j = 0; j < bs; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int d = lane + 32 * c;
          if (d < D) acc[i][c] = fmaf(pj, vs[j * D + d], acc[i][c]);
        }
      }
      m[i] = mj;
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    if (!live[i]) continue;
    const int r = blockIdx.x * ROWS + warp * ROWS_PER_WARP + i;
    if constexpr (PARTIAL) {
      // (B, Hk, G, Sq) rows: r = g * Sq + qi within KV head hk
      const size_t o_row = ((size_t)b * Hk + hk) * gsq + r;
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        if (d < D) o_acc[o_row * D + d] = acc[i][c];
      }
      if (lane == 0) {
        m_out[o_row] = m[i];
        l_out[o_row] = l[i];
      }
      continue;
    }
    const int g = r / Sq, qi = r % Sq, h = hk * G + g;
    const float inv = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < D)
        out[(((size_t)b * Sq + qi) * H + h) * D + d] =
            __float2bfloat16_rn(acc[i][c] / inv);
    }
  }
}

// Every operand of one launch, so that the instantiation is chosen in
// one place.
struct Launch {
  dim3 grid;
  size_t smem;
  cudaStream_t st;
  const __nv_bfloat16 *q, *ks, *vs;
  const void *k, *v;
  const int *tbl, *seg, *vlen, *qoff, *lblk, *sel;
  __nv_bfloat16* out;
  float *o_acc, *m_out, *l_out;
  int Sq, H, Hk, D, nb, bs, nslots, nblk;
  float qscale;
};

template <int DPL, bool QUANT, bool CAUSAL, bool PARTIAL>
void go(const Launch& a) {
  paged_attn_kernel<DPL, QUANT, CAUSAL, PARTIAL>
      <<<a.grid, WARPS * 32, a.smem, a.st>>>(
          a.q, a.k, a.v, a.ks, a.vs, a.tbl, a.seg, a.vlen, a.qoff, a.lblk,
          a.sel, a.out, a.o_acc, a.m_out, a.l_out, a.Sq, a.H, a.Hk, a.D,
          a.nb, a.bs, a.nslots, a.nblk, a.qscale);
}

// the partials are instantiated for bf16 KV only
template <int DPL>
void go_dpl(const Launch& a, bool quant, bool causal, bool partial) {
  if (partial)
    causal ? go<DPL, false, true, true>(a) : go<DPL, false, false, true>(a);
  else if (quant)
    causal ? go<DPL, true, true, false>(a) : go<DPL, true, false, false>(a);
  else
    causal ? go<DPL, false, true, false>(a) : go<DPL, false, false, false>(a);
}

int launch(Launch a, int B, int causal, int quant, int partial) {
  if (a.D < 1 || a.D > 256 || a.bs < 1 || a.bs > 32 || a.Hk < 1 ||
      a.H % a.Hk != 0 || a.nslots < 1 || (partial && quant))
    return static_cast<int>(cudaErrorInvalidValue);
  const int gsq = (a.H / a.Hk) * a.Sq;
  a.grid = dim3((gsq + ROWS - 1) / ROWS, a.Hk, B);
  a.smem = 2 * sizeof(float) * a.bs * a.D;
  if (a.smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int dpl = (a.D + 31) / 32;
  if (dpl <= 1)
    go_dpl<1>(a, quant, causal, partial);
  else if (dpl <= 2)
    go_dpl<2>(a, quant, causal, partial);
  else if (dpl <= 4)
    go_dpl<4>(a, quant, causal, partial);
  else
    go_dpl<8>(a, quant, causal, partial);
  return static_cast<int>(cudaGetLastError());
}

Launch operands(const void* q, const void* k_pool, const void* v_pool,
                const void* tables, const void* vlen, const void* qoff,
                int Sq, int H, int Hk, int D, int nb, int bs, int nblk,
                float qscale, void* stream) {
  Launch a{};
  a.st = static_cast<cudaStream_t>(stream);
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k_pool;
  a.v = v_pool;
  a.tbl = static_cast<const int*>(tables);
  a.vlen = static_cast<const int*>(vlen);
  a.qoff = static_cast<const int*>(qoff);
  a.Sq = Sq;
  a.H = H;
  a.Hk = Hk;
  a.D = D;
  a.nb = nb;
  a.bs = bs;
  a.nblk = nblk;
  a.qscale = qscale;
  return a;
}

}  // namespace

// Shapes as in the header; D <= 256, bs <= 32, bs * D <= 6144 (the two
// staged f32 tiles fit 48 KB of shared memory), H % Hk == 0.  Each
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// a shape the kernel does not take).
extern "C" int paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* vlen, const void* qoff, void* out, int B, int Sq, int H,
    int Hk, int D, int nb, int bs, int nblk, int causal, int quant,
    float qscale, void* stream) {
  Launch a = operands(q, k_pool, v_pool, tables, vlen, qoff, Sq, H, Hk, D,
                      nb, bs, nblk, qscale, stream);
  a.ks = static_cast<const __nv_bfloat16*>(k_scale);
  a.vs = static_cast<const __nv_bfloat16*>(v_scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.nslots = B;
  return launch(a, B, causal, quant, 0);
}

// Token-packed: q (T, 1, H, D); tables (nslots, nblk) per slot; seg,
// vlen, qoff (T,).  Always causal.
extern "C" int paged_packed_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* seg, const void* vlen, const void* qoff, void* out, int T,
    int H, int Hk, int D, int nb, int bs, int nslots, int nblk, int quant,
    float qscale, void* stream) {
  if (seg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Launch a = operands(q, k_pool, v_pool, tables, vlen, qoff, 1, H, Hk, D,
                      nb, bs, nblk, qscale, stream);
  a.ks = static_cast<const __nv_bfloat16*>(k_scale);
  a.vs = static_cast<const __nv_bfloat16*>(v_scale);
  a.seg = static_cast<const int*>(seg);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.nslots = nslots;
  return launch(a, T, 1, quant, 0);
}

// Partials over a compacted table: tables, logical_blocks, entry_valid
// (B, nblk) int32; bf16 pools; o_acc (B, Hk, G, Sq, D), m_out and l_out
// (B, Hk, G, Sq) f32.
extern "C" int paged_attention_partials_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* tables, const void* logical_blocks, const void* entry_valid,
    const void* vlen, const void* qoff, void* o_acc, void* m_out,
    void* l_out, int B, int Sq, int H, int Hk, int D, int nb, int bs,
    int nblk, int causal, float qscale, void* stream) {
  if (logical_blocks == nullptr || entry_valid == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a = operands(q, k_pool, v_pool, tables, vlen, qoff, Sq, H, Hk, D,
                      nb, bs, nblk, qscale, stream);
  a.lblk = static_cast<const int*>(logical_blocks);
  a.sel = static_cast<const int*>(entry_valid);
  a.o_acc = static_cast<float*>(o_acc);
  a.m_out = static_cast<float*>(m_out);
  a.l_out = static_cast<float*>(l_out);
  a.nslots = B;
  return launch(a, B, causal, 0, 1);
}
