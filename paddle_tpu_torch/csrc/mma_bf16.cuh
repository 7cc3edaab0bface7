// bf16 fragment arithmetic and cp.async staging for sm_90a, used by
// conv1x1_dw_bf16.cu's mma.sync route, the bf16 flash kernels
// (flash_tiles.cuh) and ln_matmul.cu's bf16 product.
//
// mma.sync.m16n8k16 takes bf16 operands and adds their products into f32
// accumulators. The operands come from shared memory through ldmatrix: an
// 8 x 8 matrix of 16-bit values whose rows are 16 contiguous bytes, one
// row address per lane. With .trans each lane receives a column pair in
// place of a row pair, which turns a tile stored with the contraction
// dimension outermost ([k][m] or [k][n], as rows of x and dy are) into the
// fragments mma.sync wants (A row-major, B column-major): the transpose
// costs no instruction of its own. Without .trans a lane receives a row
// pair: the fragments of a tile stored with the contraction dimension
// innermost ([m][k] or [n][k], as rows of Q and K are).
//
// A product whose A operand is an earlier product's f32 accumulator (P or
// dS in flash attention) takes it from registers: the m16n8 accumulator
// holds row g, columns 2t and 2t + 1 where the m16n8k16 A fragment wants
// k = 2t and 2t + 1, so two neighbouring accumulator tiles pack, value by
// value, into one A fragment (a_from_acc), each value rounded to nearest
// even (cvt.rn.bf16x2.f32, the rounding of torch's .to(torch.bfloat16) and
// of XLA's convert; keeping the high 16 bits would truncate).
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

// 16 bytes from gmem to smem, zero-filled when !pred (as cp_async4).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

// Four 8 x 8 matrices of 16-bit values: lanes 8i..8i+7 give the row
// addresses of matrix i, which lands in r[i], lane l holding row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* smem_row) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Two such matrices: lanes 0-7 and 8-15 give the row addresses (the
// other lanes' addresses are ignored but must be valid).
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2],
                                            const void* smem_row) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// Two transposed matrices (as ldmatrix_x4_trans, lanes 0-15).
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const void* smem_row) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// lo and hi rounded to bf16 (nearest, ties to even) in one word, lo in
// the low half: the order of k within a fragment register.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The m16n8k16 A fragment over k = 16 columns from the two m16n8 f32
// accumulator tiles x0 (columns 0-7) and x1 (columns 8-15) of the same
// 16 rows, each value rounded to bf16: a0 (row g, k 2t, 2t+1) is x0's c0,
// c1; a1 (row g + 8) x0's c2, c3; a2, a3 the same of x1.
__device__ __forceinline__ void a_from_acc(const float (&x0)[4],
                                           const float (&x1)[4],
                                           unsigned (&a)[4]) {
  a[0] = pack_bf16x2(x0[0], x0[1]);
  a[1] = pack_bf16x2(x0[2], x0[3]);
  a[2] = pack_bf16x2(x1[0], x1[1]);
  a[3] = pack_bf16x2(x1[2], x1[3]);
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
