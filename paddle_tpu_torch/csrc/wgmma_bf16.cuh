// Hopper's warpgroup product on bf16 operands from shared memory, with the
// mbarrier and TMA helpers that feed it; used by conv1x1_dw_bf16.cu.
// sm_90a only (wgmma exists for that target alone).
//
// wgmma.mma_async.m64nNk16.f32.bf16.bf16: the four warps of a warpgroup
// add A[64 x 16] . B[16 x N] into f32 accumulators held N / 2 to a thread
// (value i of thread l in warp w: row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2, the m16n8 layout of mma.sync
// repeated over N / 8 column blocks). Both operands come from shared
// memory through 64-bit descriptors. With scale-d 0 the instruction
// ignores the accumulators' old values: a fresh partial sum.
//
// Operand layout: MN-major with the 128-byte swizzle. A "slab" holds 64
// values of the M (or N) dimension for each of R rows of K: row k is 128
// contiguous bytes at slab + 128 k, and its eight 16-byte chunks are
// permuted, chunk c stored at chunk position c ^ (k % 8). That is what
// TMA writes for a box of {64 values, R rows} under
// CU_TENSOR_MAP_SWIZZLE_128B; the slab must start on a 1024-byte boundary
// (the swizzle reads address bits 4-9). In the descriptor of such an
// operand (transposed, "MN-major", which wgmma takes for 16-bit types
// only) the leading byte offset is the
// distance between slabs along M or N (64 values apart), and the stride
// byte offset the distance between groups of 8 rows of K (1024 bytes
// here). A k16 step is two such groups: the next one starts 2048 bytes
// further, still on the swizzle's 1024-byte period, so no base offset.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The descriptor of an MN-major, 128-byte-swizzled operand at shared
// address addr (1024-byte aligned); lbo, sbo in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define WG_R8(b)                                                        \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),       \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (+)= A . B over one m64nNk16 step, A and B both MN-major (the two
// transpose flags set); the old d is ignored unless accumulate.
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da,
                                    uint64_t db, bool accumulate);

template <>
__device__ __forceinline__ void mma<64>(float (&d)[32], uint64_t da,
                                        uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24)
      : "l"(da), "l"(db), "r"((int)accumulate));
}

template <>
__device__ __forceinline__ void mma<128>(float (&d)[64], uint64_t da,
                                         uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 1, 1;\n}\n"
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),
        WG_R8(48), WG_R8(56)
      : "l"(da), "l"(db), "r"((int)accumulate));
}

#undef WG_R8

// Keeps the compiler from moving reads or writes of d across the
// asynchronous product (wgmma's registers are not visible to it as such).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives once and adds bytes to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ---------------------------------------------------------------------

// Copies the box at (c0, c1) (innermost coordinate first) of the tensor
// map into shared memory at dst, completing its bytes on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

}  // namespace wgmma
