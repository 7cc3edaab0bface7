// Hopper's warpgroup product on bf16 operands, with the mbarrier, TMA
// and register helpers that feed it; used by conv1x1_dw_bf16.cu,
// flash_fwd.cu (flash_fwd_bf16 on 16-byte aligned operands) and
// ln_matmul.cu (ln_matmul_bf16 on 16-byte aligned operands). sm_90a only
// (wgmma and setmaxnreg exist for that target alone).
//
// wgmma.mma_async.m64nNk16.f32.bf16.bf16: the four warps of a warpgroup
// add A[64 x 16] . B[16 x N] into f32 accumulators held N / 2 to a thread
// (value i of thread l in warp w: row 16 w + l / 4 + 8 ((i / 2) % 2),
// column 8 (i / 4) + 2 (l % 4) + i % 2, the m16n8 layout of mma.sync
// repeated over N / 8 column blocks). B always comes from shared memory
// through a 64-bit descriptor; A from shared memory too (mma_ss) or from
// four 32-bit registers a thread (mma_rs: the m16n8k16 A fragment of
// mma.sync, warp w holding rows 16 w .. 16 w + 15, so an earlier
// product's accumulators pack into it value by value). With scale-d 0 the
// instruction ignores the accumulators' old values: a fresh partial sum.
//
// Shared-memory operands, all with the 128-byte swizzle. A "slab" is a
// run of 128-byte rows, row r at slab + 128 r, whose eight 16-byte chunks
// are permuted: chunk c stored at chunk position c ^ (r % 8). That is what
// TMA writes for a box of {64 values, R rows} under
// CU_TENSOR_MAP_SWIZZLE_128B; the slab must start on a 1024-byte boundary
// (the swizzle reads address bits 4-9), and the descriptor's base offset
// stays 0.
//   - MN-major ("transposed", which wgmma takes for 16-bit types only;
//     desc_sw128): a slab row holds 64 values of M (or N) for one k. The
//     leading byte offset is the distance between slabs along M or N (64
//     values apart), the stride byte offset the distance between groups
//     of 8 rows of K (1024 bytes). A k16 step is two such groups: the next
//     one starts 2048 bytes further, on the swizzle's 1024-byte period.
//   - K-major (desc_k128): a slab row holds 64 values of K for one row of
//     M (or N), so a slab covers 64 of K. The stride byte offset is the
//     distance between groups of 8 rows of M or N (1024 bytes); the
//     leading byte offset is unused (a k16 step reads 32 bytes of a
//     128-byte row) and set to 1, as CUTLASS sets it
//     (cute/arch/mma_sm90_desc.hpp: layout_type 1 = SW128 at bits 62-63,
//     start address >> 4 at bits 0-13, LBO >> 4 at 16-29, SBO >> 4 at
//     32-45). The k16 step kk starts 32 kk bytes into the row: the
//     hardware applies the swizzle to the address it forms, so the step
//     moves the start address alone; the next 64 of K is the next slab.
//
// Threads that write an operand into shared memory with ordinary stores
// before wgmma reads it make the writes visible to the async proxy first
// (fence_proxy_async, then a barrier among the writers and readers).

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

// The descriptor of a K-major, 128-byte-swizzled operand whose rows of M
// (or N) are 128 bytes apart, at shared address addr: a slab's start (on
// a 1024-byte boundary) plus 32 bytes for each k16 step into it.
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
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
#define WG_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31}"
#define WG_D64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

template <int TA, int TB>
__device__ __forceinline__ void mma_ss64(float (&d)[32], uint64_t da,
                                         uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24)
      : "l"(da), "l"(db), "r"((int)accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void mma_ss128(float (&d)[64], uint64_t da,
                                          uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, %67, %68;\n}\n"
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),
        WG_R8(48), WG_R8(56)
      : "l"(da), "l"(db), "r"((int)accumulate), "n"(TA), "n"(TB));
}

// d (+)= A . B over one m64nNk16 step, A and B from shared memory; TA, TB
// the transpose flags (1: MN-major, 0: K-major); the old d is ignored
// unless accumulate.
template <int N, int TA, int TB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t da,
                                       uint64_t db, bool accumulate) {
  static_assert(N == 64 || N == 128, "m64n64k16 or m64n128k16");
  if constexpr (N == 64)
    mma_ss64<TA, TB>(d, da, db, accumulate);
  else
    mma_ss128<TA, TB>(d, da, db, accumulate);
}

// Both operands MN-major (conv1x1_dw_bf16.cu: x^T and dy as they land).
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da,
                                    uint64_t db, bool accumulate) {
  mma_ss<N, 1, 1>(d, da, db, accumulate);
}

// d (+)= A . B over one m64nNk16 step, A from registers (a[0..3]: rows
// g and g + 8 of the warp's 16, k 2t, 2t + 1 and 2t + 8, 2t + 9, as
// mma.sync's m16n8k16 A fragment), B from shared memory, TB its
// transpose flag.
template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const unsigned (&a)[4], uint64_t db,
                                       bool accumulate) {
  static_assert(N == 64 || N == 128, "m64n64k16 or m64n128k16");
  if constexpr (N == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"((int)accumulate), "n"(TB));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),
          WG_R8(48), WG_R8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"((int)accumulate), "n"(TB));
}

#undef WG_R8
#undef WG_D32
#undef WG_D64

// Makes this thread's ordinary stores to shared memory visible to the
// async proxy (wgmma's operand reads, TMA); a barrier then orders them
// before the reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Hands registers between warpgroups: each warpgroup of a block runs one
// of the two (all its warps), the producer giving up what the consumers
// take.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier ID among the block's first N threads (the consumer warpgroups;
// ID 0 is __syncthreads's).
template <int ID, int N>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(N) : "memory");
}

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

// Arrives once if pred, predicated inside the instruction: no branch, so a
// warp's lanes do not diverge here while a wgmma group is in flight.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"((int)pred)
      : "memory");
}

// Waits until the phase of parity `parity` has completed. The spin is a
// loop inside the asm (as CUTLASS's ClusterBarrier::wait): a C++ loop on
// each lane's own test is a divergent path to ptxas, and a divergent path
// while a wgmma group is in flight makes it serialise every wgmma (C7518).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
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

// As tma_load_2d for a 3-D map: the box at (c0, c1, c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// -- tensor maps (host) ------------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its
// address, so a library needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 tensor of `rank` dimensions (innermost first: dims,
// the byte strides of dims 1.. in strides, each a multiple of 16, base
// 16-byte aligned) whose boxes (box, innermost 64 values) land
// 128-byte-swizzled; reads past any edge fill zeros.
inline cudaError_t bf16_map(CUtensorMap* map, const void* base, int rank,
                            const cuuint64_t* dims, const cuuint64_t* strides,
                            const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
      const_cast<void*>(base), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a row-major bf16 [rows, cols] (16-byte aligned, cols a
// multiple of 8) whose boxes are 64 columns by box_rows rows.
inline cudaError_t rows_map(CUtensorMap* map, const void* t, int rows,
                            int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return bf16_map(map, t, 2, dims, strides, box);
}

}  // namespace wgmma
