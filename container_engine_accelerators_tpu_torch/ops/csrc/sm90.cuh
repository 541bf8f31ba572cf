// Copyright 2026 The TPU Accelerator Stack Authors.
// SPDX-License-Identifier: Apache-2.0
//
// Hopper (sm_90a) building blocks as inline PTX: mbarriers, TMA tile loads,
// wgmma shared-memory descriptors and the wgmma instructions for the two
// 16-bit element types (bf16 and f16), and register rebalancing between
// warpgroups. Header-only, no CUDA driver library: a kernel source includes
// it and stays a plain-C-interface build.
//
// Shared-memory tiles are in the layout a TMA load with 128-byte (or, for
// 64-byte rows, 64-byte) swizzle writes: row r of a box at r * row_bytes,
// its 16-byte chunks permuted within each group of 8 rows. A tile wider
// than 128 bytes is loaded as several such boxes ("atoms") side by side.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

// The tensor-core kernels' element types: __nv_bfloat16 and __half, each
// stored as 16 bits and multiplied with f32 accumulation.
template <typename E>
constexpr bool kIsF16 = std::is_same<E, __half>::value;

// Two f32 values rounded to a pair of E (round to nearest even), lo in the
// low half: the packing of P, dS and every 16-bit output.
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsF16<E>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of TMA traffic in this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes)
      : "memory");
}

// Spins until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 passes at once.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA --------------------------------------------------------------

// Loads the box at (c0, c1, c2) (innermost first) of a rank-3 tensor map
// into shared memory and reports its bytes to `bar`. Elements outside the
// tensor are written as zeros. `tmap` is a __grid_constant__ parameter.
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------

// Swizzle codes of the wgmma descriptor (bits 62-63).
constexpr int kSwizzle128B = 1;
constexpr int kSwizzle64B = 2;

// Shared-memory matrix descriptor. `lbo` and `sbo` are byte offsets:
// K-major swizzled operands use only `sbo`, the step between groups of 8
// rows (8 * row_bytes); MN-major (transposed) swizzled operands use `lbo`
// for the step between atoms along M/N and `sbo` for the step between
// groups of 8 rows along K. Atoms must be 1024-byte aligned; the start
// address may move inside an atom by multiples of 32 bytes (one k16 step
// of a K-major operand).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

// The descriptor of the matrix `bytes` (a multiple of 16) further on in
// shared memory. The start address is the low field, so this is one add
// as long as the address stays below 256 KB, as all of shared memory does.
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc,
                                                 uint32_t bytes) {
  return desc + (bytes >> 4);
}

// Orders this thread's earlier register and shared-memory writes before
// the wgmma instructions that follow (needed whenever the accumulator or
// A registers were touched by ordinary instructions).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, f32, in registers) += A (64 x 16) * B (16 x N), inputs of the
// 16-bit element type E (bf16 or f16: the .bf16 and .f16 kinds run at one
// rate, with f32 accumulators).
// WgmmaSS: A and B from shared-memory descriptors, both K-major.
// WgmmaRS: A from registers (4 x 32 bits a thread, the layout of a
// 64 x 16 slice of an f32 accumulator packed to pairs of E, see pack2),
// B from a descriptor. TransB = 1 reads B as MN-major. scale_d = 0
// overwrites D.
//
// Accumulator layout: warp w of the warpgroup holds rows 16w + lane / 4
// and 16w + lane / 4 + 8; register 4j + i holds column 8j + 2 (lane % 4)
// + (i & 1) of the row 16w + lane / 4 + 8 (i >> 1).
template <int N, int TransB, typename E = __nv_bfloat16>
struct WgmmaSS;
template <int N, int TransB, typename E = __nv_bfloat16>
struct WgmmaRS;

// The asm operands: an accumulator of R f32 registers from d[i] on.
#define SM90_ACC4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SM90_ACC8(d, i) SM90_ACC4(d, i), SM90_ACC4(d, i + 4)
#define SM90_ACC16(d, i) SM90_ACC8(d, i), SM90_ACC8(d, i + 8)
#define SM90_ACC32(d, i) SM90_ACC16(d, i), SM90_ACC16(d, i + 16)
#define SM90_ACC64(d, i) SM90_ACC32(d, i), SM90_ACC32(d, i + 32)
#define SM90_ACC128(d, i) SM90_ACC64(d, i), SM90_ACC64(d, i + 64)

#define SM90_REGS4 \
  "%0, %1, %2, %3"
#define SM90_REGS8 \
  "%0, %1, %2, %3, %4, %5, %6, %7"
#define SM90_REGS16 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15"
#define SM90_REGS32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31"
#define SM90_REGS64 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_REGS128 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127"

// The instruction text of an SS product (d = %0.., then da, db, scale_d,
// TransB at operands A, B, S, T) and of an RS product (a at A0..A3).
#define SM90_SS_ASM(N, TY, REGS, A, B, S, T)                          \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" S ", 0;\n"                    \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " "      \
  "{" REGS "}, %" A ", %" B ", p, 1, 1, 0, %" T ";\n}\n"
#define SM90_RS_ASM(N, TY, REGS, A0, A1, A2, A3, B, S, T)             \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" S ", 0;\n"                    \
  "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY " "      \
  "{" REGS "}, {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" B             \
  ", p, 1, 1, %" T ";\n}\n"

#define SM90_WGMMA_SS(N, R, REGS, ACC, A, B, S, T)                        \
  template <int TransB, typename E>                                       \
  struct WgmmaSS<N, TransB, E> {                                          \
    static __device__ __forceinline__ void mma(float (&d)[R], uint64_t da, \
                                               uint64_t db, int scale_d) { \
      if constexpr (kIsF16<E>) {                                          \
        asm volatile(SM90_SS_ASM(#N, "f16", REGS, A, B, S, T)             \
                     : ACC(d, 0)                                          \
                     : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));      \
      } else {                                                            \
        asm volatile(SM90_SS_ASM(#N, "bf16", REGS, A, B, S, T)            \
                     : ACC(d, 0)                                          \
                     : "l"(da), "l"(db), "r"(scale_d), "n"(TransB));      \
      }                                                                   \
    }                                                                     \
  };

#define SM90_WGMMA_RS(N, R, REGS, ACC, A0, A1, A2, A3, B, S, T)           \
  template <int TransB, typename E>                                       \
  struct WgmmaRS<N, TransB, E> {                                          \
    static __device__ __forceinline__ void mma(float (&d)[R],             \
                                               const uint32_t (&a)[4],    \
                                               uint64_t db, int scale_d) { \
      if constexpr (kIsF16<E>) {                                          \
        asm volatile(                                                     \
            SM90_RS_ASM(#N, "f16", REGS, A0, A1, A2, A3, B, S, T)         \
            : ACC(d, 0)                                                   \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),        \
              "r"(scale_d), "n"(TransB));                                 \
      } else {                                                            \
        asm volatile(                                                     \
            SM90_RS_ASM(#N, "bf16", REGS, A0, A1, A2, A3, B, S, T)        \
            : ACC(d, 0)                                                   \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),        \
              "r"(scale_d), "n"(TransB));                                 \
      }                                                                   \
    }                                                                     \
  };

SM90_WGMMA_SS(32, 16, SM90_REGS16, SM90_ACC16, "16", "17", "18", "19")
SM90_WGMMA_SS(64, 32, SM90_REGS32, SM90_ACC32, "32", "33", "34", "35")
SM90_WGMMA_SS(128, 64, SM90_REGS64, SM90_ACC64, "64", "65", "66", "67")
SM90_WGMMA_RS(8, 4, SM90_REGS4, SM90_ACC4, "4", "5", "6", "7", "8", "9", "10")
SM90_WGMMA_RS(16, 8, SM90_REGS8, SM90_ACC8, "8", "9", "10", "11", "12", "13", "14")
SM90_WGMMA_RS(32, 16, SM90_REGS16, SM90_ACC16, "16", "17", "18", "19", "20", "21", "22")
SM90_WGMMA_RS(64, 32, SM90_REGS32, SM90_ACC32, "32", "33", "34", "35", "36", "37", "38")
SM90_WGMMA_RS(128, 64, SM90_REGS64, SM90_ACC64, "64", "65", "66", "67", "68", "69", "70")
SM90_WGMMA_RS(256, 128, SM90_REGS128, SM90_ACC128, "128", "129", "130", "131", "132", "133", "134")

#undef SM90_WGMMA_RS
#undef SM90_WGMMA_SS
#undef SM90_RS_ASM
#undef SM90_SS_ASM
#undef SM90_REGS4
#undef SM90_REGS8
#undef SM90_REGS16
#undef SM90_REGS32
#undef SM90_REGS64
#undef SM90_REGS128
#undef SM90_ACC128
#undef SM90_ACC64
#undef SM90_ACC32
#undef SM90_ACC16
#undef SM90_ACC8
#undef SM90_ACC4

// ---- thread-block clusters --------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives, then waits for the
// rest: shared-memory writes before it are visible to any block's reads
// of them after it. All threads of a warp execute it together.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The 16 bytes at `p`, an address in this block's shared memory, read from
// the same address in the shared memory of the cluster's block `rank`.
__device__ __forceinline__ float4 ld_cluster_f32x4(const void* p,
                                                   uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// ---- warp specialisation ----------------------------------------------

// Hands registers back (producer warpgroup) or takes them (consumers).
// Every warp of the warpgroup executes it, on a path that never rejoins
// the other roles.
template <int Regs>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

template <int Regs>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(Regs));
}

}  // namespace sm90
