// Hopper building blocks shared by sym_cov.cu and flash_attn.cu: TMA loads,
// mbarriers, wgmma descriptors and the wgmma instructions those kernels
// issue, as inline PTX for sm_90a (no library), and the host's encoder of
// a TMA tensor map.
//
// The encoder, cuTensorMapEncodeTiled, is a driver entry point. It is
// reached through the runtime's cudaGetDriverEntryPoint, so a library that
// includes this header still links the runtime alone (no -lcuda); cuda.h
// is read for its types.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// --------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes a phase after `count` arrivals (and, where an
// arrival set an expected transaction count, after that many bytes).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spins until the phase of parity `parity` has completed: a consumer waits
// with its phase bit (0 first), a producer on an empty slot with the
// complement (so its first wait on each slot passes). A wait that outlasts
// 2^26 polls (seconds) traps, so a barrier that can never complete fails
// the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) asm volatile("trap;\n");
  }
}

// TMA: the box of `map` at coordinates (innermost first) into shared memory
// at dst, completing `bytes` of bar's expected transactions. Box elements
// outside the tensor are written as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory layouts of a wgmma operand: TMA's 128- and 64-byte swizzles.
constexpr uint32_t kSwizzle128 = 1;
constexpr uint32_t kSwizzle64 = 2;

// wgmma matrix descriptor of an operand at shared address `addr` (on the
// swizzle's 1024- or 512-byte pattern, or inside one of its rows for a
// K-major operand's later k16 steps). K-major: sbo is the byte stride
// between 8-row groups, lbo unused. MN-major: lbo is the byte stride
// between swizzle atoms along M or N (64 or 32 values), sbo between 8-row
// groups along K.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator across the wait.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A named barrier over the first `threads` threads of the block.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D(64 x 128) = A B (+ D where scale_d != 0), A and B from shared memory
// (descriptors da, db); trans-a 1, trans-b 1 (1: MN-major).
#define KFAC_WGMMA_SS_N128_TT(FN, TY)                                          \
  __device__ __forceinline__ void FN(float (&d)[64], uint64_t da, uint64_t db,    \
                                     int scale_d) {                                \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                              \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"            \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
        "}, %64, %65, p, 1, 1, 1, 1;\n}\n"                                \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                                         \
        : "l"(da), "l"(db), "r"(scale_d));                                    \
  }

// D(64 x 64) = A B (+ D where scale_d != 0), A and B from shared memory
// (descriptors da, db); trans-a 0, trans-b 0 (1: MN-major).
#define KFAC_WGMMA_SS_N64_NN(FN, TY)                                          \
  __device__ __forceinline__ void FN(float (&d)[32], uint64_t da, uint64_t db,    \
                                     int scale_d) {                                \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                              \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                                                         \
        : "l"(da), "l"(db), "r"(scale_d));                                    \
  }

// D(64 x 32) = A B (+ D where scale_d != 0), A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// (descriptor db), trans-b 1.
#define KFAC_WGMMA_RS_N32_T(FN, TY)                                          \
  __device__ __forceinline__ void FN(float (&d)[16], const uint32_t (&a)[4],      \
                                     uint64_t db, int scale_d) {                   \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                              \
        "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"            \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"  \
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)); \
  }

// D(64 x 64) = A B (+ D where scale_d != 0), A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// (descriptor db), trans-b 1.
#define KFAC_WGMMA_RS_N64_T(FN, TY)                                          \
  __device__ __forceinline__ void FN(float (&d)[32], const uint32_t (&a)[4],      \
                                     uint64_t db, int scale_d) {                   \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                              \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"  \
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)); \
  }

// D(64 x 128) = A B (+ D where scale_d != 0), A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// (descriptor db), trans-b 1.
#define KFAC_WGMMA_RS_N128_T(FN, TY)                                          \
  __device__ __forceinline__ void FN(float (&d)[64], const uint32_t (&a)[4],      \
                                     uint64_t db, int scale_d) {                   \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                              \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"            \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"  \
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)); \
  }

// D(64 x 256) = A B (+ D where scale_d != 0), A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// (descriptor db), trans-b 1.
#define KFAC_WGMMA_RS_N256_T(FN, TY)                                          \
  __device__ __forceinline__ void FN(float (&d)[128], const uint32_t (&a)[4],      \
                                     uint64_t db, int scale_d) {                   \
    asm volatile(                                                              \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                              \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"            \
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "  \
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "  \
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "  \
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "  \
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"  \
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"              \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])                                                         \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)); \
  }

KFAC_WGMMA_SS_N128_TT(ss_n128_tt_bf16, "bf16")
KFAC_WGMMA_SS_N128_TT(ss_n128_tt_f16, "f16")
KFAC_WGMMA_SS_N64_NN(ss_n64_nn_bf16, "bf16")
KFAC_WGMMA_SS_N64_NN(ss_n64_nn_f16, "f16")
KFAC_WGMMA_RS_N32_T(rs_n32_t_bf16, "bf16")
KFAC_WGMMA_RS_N32_T(rs_n32_t_f16, "f16")
KFAC_WGMMA_RS_N64_T(rs_n64_t_bf16, "bf16")
KFAC_WGMMA_RS_N64_T(rs_n64_t_f16, "f16")
KFAC_WGMMA_RS_N128_T(rs_n128_t_bf16, "bf16")
KFAC_WGMMA_RS_N128_T(rs_n128_t_f16, "f16")
KFAC_WGMMA_RS_N256_T(rs_n256_t_bf16, "bf16")
KFAC_WGMMA_RS_N256_T(rs_n256_t_f16, "f16")

// The instructions above by operand type T (__nv_bfloat16 or __half).
template <typename T>
struct Wgmma;
template <>
struct Wgmma<__nv_bfloat16> {
  static __device__ __forceinline__ void ss_n128_tt(float (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
    ss_n128_tt_bf16(d, da, db, scale_d);
  }
  static __device__ __forceinline__ void ss_n64_nn(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
    ss_n64_nn_bf16(d, da, db, scale_d);
  }
  static __device__ __forceinline__ void rs_t(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    rs_n32_t_bf16(d, a, db, scale_d);
  }
  static __device__ __forceinline__ void rs_t(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    rs_n64_t_bf16(d, a, db, scale_d);
  }
  static __device__ __forceinline__ void rs_t(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    rs_n128_t_bf16(d, a, db, scale_d);
  }
  static __device__ __forceinline__ void rs_t(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    rs_n256_t_bf16(d, a, db, scale_d);
  }
};
template <>
struct Wgmma<__half> {
  static __device__ __forceinline__ void ss_n128_tt(float (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
    ss_n128_tt_f16(d, da, db, scale_d);
  }
  static __device__ __forceinline__ void ss_n64_nn(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
    ss_n64_nn_f16(d, da, db, scale_d);
  }
  static __device__ __forceinline__ void rs_t(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    rs_n32_t_f16(d, a, db, scale_d);
  }
  static __device__ __forceinline__ void rs_t(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    rs_n64_t_f16(d, a, db, scale_d);
  }
  static __device__ __forceinline__ void rs_t(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    rs_n128_t_f16(d, a, db, scale_d);
  }
  static __device__ __forceinline__ void rs_t(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
    rs_n256_t_f16(d, a, db, scale_d);
  }
};

// ----------------------------------------------------------------- host

// The TMA element type of T.
template <typename T>
struct TmaType;
template <>
struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, looked up once; null if the
// driver lacks it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tiled TMA map of a `rank`-D tensor of 16-bit values: dims and box
// innermost first, strides (bytes) of dims 1.. . Rows of the box are
// swizzled by `swizzle`; elements outside the tensor read as zeros.
// Returns cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t encode_map(CUtensorMap* map, CUtensorMapDataType type,
                              int rank, const void* base,
                              const cuuint64_t* dims, const cuuint64_t* strides,
                              const cuuint32_t* box,
                              CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorInvalidValue;
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult res =
      fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims,
         strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
