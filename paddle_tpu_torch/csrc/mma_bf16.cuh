// bf16 fragment arithmetic and 4-byte cp.async staging for sm_90a, used
// by conv1x1_dw_bf16.cu's mma.sync route.
//
// mma.sync.m16n8k16 takes bf16 operands and adds their products into f32
// accumulators. The operands come from shared memory through ldmatrix: an
// 8 x 8 matrix of 16-bit values whose rows are 16 contiguous bytes, one
// row address per lane. With .trans each lane receives a column pair in
// place of a row pair, which turns a tile stored with the contraction
// dimension outermost ([k][m] or [k][n], as rows of x and dy are) into the
// fragments mma.sync wants (A row-major, B column-major): the transpose
// costs no instruction of its own.
//
// Products of bf16 values are exact in f32, so each mma is a sum of exact
// products rounded in f32; the tensor cores truncate that sum into the
// accumulator as they do for TF32 (see gemm_f32.cuh on accumulation), so a
// caller keeps each chain short and adds it into its own sum by FADD.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace bf16mma {

// 4 bytes from gmem to smem, zero-filled when !pred (gmem must still be a
// valid address then; the caller passes its base pointer). 16-byte
// operands take the wgmma route's TMA copies instead.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
}

// Four 8 x 8 matrices of 16-bit values, transposed: lanes 8i..8i+7 give
// the row addresses of matrix i, which lands in r[i].
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* smem_row) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a . b over one m16n8k16 tile of bf16 operands; with first, d = a . b
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2], bool first) {
  if (first)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace bf16mma
