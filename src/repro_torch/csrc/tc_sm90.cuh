// Tensor-core building blocks shared by the kernels (sm_90a): cp.async
// 16-byte copies, ldmatrix, bf16 mma.sync m16n8k16 with f32 accumulators,
// s8 mma.sync m16n8k32 with s32 accumulators, the XOR swizzle of 16-byte
// chunks in shared memory, and the Hopper pieces: mbarriers, TMA tensor
// loads (and, on the host, cuTensorMapEncodeTiled), bf16 wgmma (f32
// accumulators) from 128-byte-swizzled shared memory descriptors, s8
// wgmma (s32 accumulators) with A from registers, and wgmma's fence /
// commit / wait.
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; nbytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(nbytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col); not
// volatile, so that independent MMAs may be interleaved
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two f32 values as hi + lo bf16 pairs (hi = bf16(x), lo = bf16(x -
// hi)): an A fragment that carries ~16 bits of each value
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// three bf16 terms (hi, mid, lo; x - hi - mid - lo ~ 2^-27 |x|): an A
// fragment whose three MMAs carry x to f32 precision
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  split2(x0 - hf.x, x1 - hf.y, mid, lo);
}

// a bf16 tile row: 16-byte chunk c of key row kk sits at (c ^ (kk & 7))
__device__ __forceinline__ uint32_t swz(uint32_t base, int kk, int c,
                                        int rowb) {
  return base + kk * rowb + ((c ^ (kk & 7)) << 4);
}

// D (16x8 s32) += A (16x32 s8, row) * B (32x8 s8, col): exact integer
// sums
__device__ __forceinline__ void mma16832_s8(int* d, const uint32_t* a,
                                            uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Hopper: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// arrive and expect `bytes` more of transactions (the TMA loads that
// complete this phase)
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed; a phase that
// never completes (a copy that was never issued) traps after 2^26
// polls, which the launch reports as an error, instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++polls == (1u << 26)) __trap();
  } while (!done);
}

// TMA: one box of a 4-d tensor map (coordinates innermost first) into
// shared memory; completion is counted on `bar` in bytes
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// TMA: one box of a 2-d tensor map (coordinates innermost first)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// barrier `id` (1..15) over the first `threads` threads of the block
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (the TMA's
// CU_TENSOR_MAP_SWIZZLE_128B layout: rows of 128 bytes, 16-byte chunk c
// of row r at c ^ (r & 7), 8-row groups of 1024 bytes; tiles 1024-byte
// aligned).  K-major operands: sbo = 1024 (next 8 rows), lbo unused.
// MN-major operands: lbo = the next 64-element block along M/N, sbo =
// 1024 (next 8 rows along K).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

// 2^x by the SFU (ex2.approx, ~2 ulp; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers that an in-flight wgmma reads or writes: the compiler must
// neither read an accumulator nor reuse an A register before the wait
// that follows; this empty asm pins each one in place after it.
template <int N>
__device__ __forceinline__ void wg_pin(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wg_pin(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void wg_pin(int* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define TC_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TC_D32 TC_D8(0), TC_D8(8), TC_D8(16), TC_D8(24)
#define TC_D64 TC_D32, TC_D8(32), TC_D8(40), TC_D8(48), TC_D8(56)
#define TC_R32                                  \
  "%0, %1, %2, %3, %4, %5, %6, %7, "            \
  "%8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, "    \
  "%24, %25, %26, %27, %28, %29, %30, %31"
#define TC_R64                                  \
  TC_R32 ", "                                   \
  "%32, %33, %34, %35, %36, %37, %38, %39, "    \
  "%40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, "    \
  "%56, %57, %58, %59, %60, %61, %62, %63"

// One warpgroup: D (64 x 128 f32) (+)= A (64 x 16 bf16) * B (16 x 128
// bf16), A and B from shared memory, both K-major; accumulate = 0
// overwrites D.  Thread (warp w, lane l) holds rows 16w + l/4 (+8) and
// columns 8j + 2(l%4) (+1) as d[4j .. 4j+3].
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TC_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : TC_D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// One warpgroup: D (64 x N f32) += A (64 x 16 bf16, registers: the
// mma.sync m16n8k16 A fragment of each warp's 16 rows) * B (16 x N bf16,
// shared memory, MN-major: the N values of one K row contiguous).
__device__ __forceinline__ void wgmma_rs_n128_t(float* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" TC_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TC_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64_t(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" TC_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TC_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// One warpgroup: D (64 x N s32) += A (64 x 32 s8, registers: the
// mma.sync m16n8k32 A fragment of each warp's 16 rows, a0 / a1 rows g /
// g + 8 at K 4t .. 4t + 3, a2 / a3 the same at K 16 + 4t ..) * B (32 x N
// s8, shared memory, K-major: the 32 K bytes of one column contiguous,
// 128-byte swizzled), exact.  Thread (warp w, lane l) holds rows 16w +
// l/4 (+8) and columns 8j + 2(l%4) (+1) as d[4j .. 4j+3].  N = 8, 16, 32,
// 64 or 128.
#define TC_I4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define TC_I8(i) TC_I4(i), TC_I4(i + 4)
#define TC_I16(i) TC_I8(i), TC_I8(i + 8)
#define TC_I32(i) TC_I16(i), TC_I16(i + 16)
#define TC_I64 TC_I32(0), TC_I32(32)
#define TC_R4 "%0, %1, %2, %3"
#define TC_R8 TC_R4 ", %4, %5, %6, %7"
#define TC_R16 TC_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(int* d, const uint32_t* a,
                                            uint64_t db);
template <>
__device__ __forceinline__ void wgmma_s8_rs<8>(int* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {" TC_R4
      "}, {%4, %5, %6, %7}, %8, p;\n}\n"
      : TC_I4(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<16>(int* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {" TC_R8
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : TC_I8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<32>(int* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {" TC_R16
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : TC_I16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<64>(int* d, const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" TC_R32
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : TC_I32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<128>(int* d, const uint32_t* a,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" TC_R64
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : TC_I64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef TC_D8
#undef TC_D32
#undef TC_D64
#undef TC_R32
#undef TC_R64
#undef TC_I4
#undef TC_I8
#undef TC_I16
#undef TC_I32
#undef TC_I64
#undef TC_R4
#undef TC_R8
#undef TC_R16

// ---------------------------------------------------------------------------
// host: cuTensorMapEncodeTiled, found through the CUDA runtime's
// entry-point query (no link against libcuda)
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled",
                                     reinterpret_cast<void**>(&fn), 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                            reinterpret_cast<void**>(&fn), cudaEnableDefault,
                            &found);
#endif
    if (found != cudaDriverEntryPointSuccess) fn = nullptr;
  }
  return fn;
}

}  // namespace tc
