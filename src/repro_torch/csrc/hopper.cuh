// Hopper (sm_90a) building blocks for the hand-written kernels: shared
// addresses, mbarriers, TMA tensor copies, warpgroup register moves, and
// wgmma descriptors and products.  Device code only; the tensor maps are
// encoded on the host by the kernel's own entry point.
#pragma once

#include <cuda.h>   // CUtensorMap (the type; no driver call is made here)
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the other threads and to the
// copy engine; then a __syncthreads.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also tells the barrier to expect `bytes` from copies.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.  (No
// watchdog `__trap` here: an exit path inside a warpgroup's branch keeps
// ptxas from giving that branch the registers its setmaxnreg asks for.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// ------------------------------------------------------------ TMA copies

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Copy the box at coordinates (c0 innermost .. c3) of a rank-4 map into
// shared memory at `dst`; completion is counted in bytes on `bar`.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy shared memory at `src` to the box at (c0 .. c3); elements outside
// the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

// Close this thread's group of stores issued so far.
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until every committed store of this thread has read its shared
// memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's ordinary shared-memory writes before later copies
// and wgmma reads (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------ warpgroup registers

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor.  layout: 1 = 128-byte swizzle, 2 =
// 64-byte, 3 = 32-byte; lbo and sbo in bytes.  For a K-major operand sbo
// is the step between groups of 8 rows (lbo is unused); for an MN-major
// one, lbo is the step between swizzle-wide column blocks and sbo the
// step between groups of 8 rows of K.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// A compiler barrier on registers that an asynchronous wgmma reads or
// writes: their uses cannot move across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

template <typename T>
struct WgmmaType;
template <>
struct WgmmaType<__nv_bfloat16> { static constexpr bool kBf16 = true; };
template <>
struct WgmmaType<__half> { static constexpr bool kBf16 = false; };

#define REPRO_ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, float32) = a . b^T (+ d when scale_d): a is 64 x 16 and b
// 128 x 16, both K-major in shared memory, at descriptors a and b moved
// by kOffA and kOffB bytes (immediates: no descriptor per step is kept
// in a register).
#define REPRO_WGMMA_SS_N128(TY)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"                               \
      "setp.ne.b32 p, %66, 0;\n"                                            \
      "add.s64 da, %64, %67;\nadd.s64 db, %65, %68;\n"                      \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26,"    \
      " %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "       \
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"    \
      " %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "      \
      "da, db, p, 1, 1, 0, 0;\n}\n"                                         \
      : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8),                                 \
        REPRO_ACC8(d, 16), REPRO_ACC8(d, 24),                               \
        REPRO_ACC8(d, 32), REPRO_ACC8(d, 40),                               \
        REPRO_ACC8(d, 48), REPRO_ACC8(d, 56)                                \
      : "l"(a), "l"(b), "r"(scale_d), "n"(kOffA >> 4), "n"(kOffB >> 4))

template <typename T, int kOffA, int kOffB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  if constexpr (WgmmaType<T>::kBf16) {
    REPRO_WGMMA_SS_N128("bf16");
  } else {
    REPRO_WGMMA_SS_N128("f16");
  }
}

// d (64 x N, float32) = a . b (+ d when scale_d): a is 64 x 16 in
// registers (the m16n8k16 A layout in each warp's 16 rows), b 16 x N in
// shared memory, MN-major, at descriptor b moved by kOffB bytes.
#define REPRO_WGMMA_RS_N16(TY)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\n.reg .b64 db;\n"                                   \
      "setp.ne.b32 p, %13, 0;\nadd.s64 db, %12, %14;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, db, p, 1, "    \
      "1, 1;\n}\n"                                                          \
      : REPRO_ACC8(d, 0)                                                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),                 \
        "r"(scale_d), "n"(kOffB >> 4))

template <typename T, int kOffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (WgmmaType<T>::kBf16) {
    REPRO_WGMMA_RS_N16("bf16");
  } else {
    REPRO_WGMMA_RS_N16("f16");
  }
}

#define REPRO_WGMMA_RS_N32(TY)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\n.reg .b64 db;\n"                                   \
      "setp.ne.b32 p, %21, 0;\nadd.s64 db, %20, %22;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
      "%14, %15}, {%16, %17, %18, %19}, db, p, 1, 1, 1;\n}\n"               \
      : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8)                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),                 \
        "r"(scale_d), "n"(kOffB >> 4))

template <typename T, int kOffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (WgmmaType<T>::kBf16) {
    REPRO_WGMMA_RS_N32("bf16");
  } else {
    REPRO_WGMMA_RS_N32("f16");
  }
}

#define REPRO_WGMMA_RS_N64(TY)                                              \
  asm volatile(                                                             \
      "{\n.reg .pred p;\n.reg .b64 db;\n"                                   \
      "setp.ne.b32 p, %37, 0;\nadd.s64 db, %36, %38;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "           \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26,"    \
      " %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, db, p, 1, 1, "      \
      "1;\n}\n"                                                             \
      : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8),                                 \
        REPRO_ACC8(d, 16), REPRO_ACC8(d, 24)                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),                 \
        "r"(scale_d), "n"(kOffB >> 4))

template <typename T, int kOffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (WgmmaType<T>::kBf16) {
    REPRO_WGMMA_RS_N64("bf16");
  } else {
    REPRO_WGMMA_RS_N64("f16");
  }
}

#define REPRO_WGMMA_RS_N128(TY)                                             \
  asm volatile(                                                             \
      "{\n.reg .pred p;\n.reg .b64 db;\n"                                   \
      "setp.ne.b32 p, %69, 0;\nadd.s64 db, %68, %70;\n"                     \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "       \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26,"    \
      " %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "       \
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"    \
      " %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "      \
      "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"                          \
      : REPRO_ACC8(d, 0), REPRO_ACC8(d, 8),                                 \
        REPRO_ACC8(d, 16), REPRO_ACC8(d, 24),                               \
        REPRO_ACC8(d, 32), REPRO_ACC8(d, 40),                               \
        REPRO_ACC8(d, 48), REPRO_ACC8(d, 56)                                \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),                 \
        "r"(scale_d), "n"(kOffB >> 4))

template <typename T, int kOffB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (WgmmaType<T>::kBf16) {
    REPRO_WGMMA_RS_N128("bf16");
  } else {
    REPRO_WGMMA_RS_N128("f16");
  }
}

// ------------------------------------------------------- integer wgmma

#define REPRO_ACC8_U32(d, i)                                               \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),              \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x 256, int32) += a . b: a is 64 x 32 unsigned bytes in registers
// (each warp's 16 rows in the m16n8k32 A layout: register 0 holds bytes
// 4q..4q+3 of row g, 1 the same of row g + 8, 2 and 3 bytes 16 + 4q..
// of rows g and g + 8, for lane 4g + q), b 256 x 32 unsigned bytes in
// shared memory, K-major, at descriptor b moved by kOffB bytes.  Integer
// operands must be K-major (no transpose); scale_d 0 overwrites d.
template <int kOffB>
__device__ __forceinline__ void wgmma_rs_u8_n256(uint32_t (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %133, 0;\nadd.s64 db, %132, %134;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, db, p;\n}\n"
      : REPRO_ACC8_U32(d, 0),
        REPRO_ACC8_U32(d, 8),
        REPRO_ACC8_U32(d, 16),
        REPRO_ACC8_U32(d, 24),
        REPRO_ACC8_U32(d, 32),
        REPRO_ACC8_U32(d, 40),
        REPRO_ACC8_U32(d, 48),
        REPRO_ACC8_U32(d, 56),
        REPRO_ACC8_U32(d, 64),
        REPRO_ACC8_U32(d, 72),
        REPRO_ACC8_U32(d, 80),
        REPRO_ACC8_U32(d, 88),
        REPRO_ACC8_U32(d, 96),
        REPRO_ACC8_U32(d, 104),
        REPRO_ACC8_U32(d, 112),
        REPRO_ACC8_U32(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(kOffB >> 4));
}

}  // namespace hopper
