// Split-TF32 fragment arithmetic and cp.async staging for sm_90a, shared by
// the GEMM mainloop (gemm_f32.cuh: conv1x1_dw.cu, ln_matmul.cu) and the
// flash-attention backward (flash_bwd.cu).
//
// Each f32 operand value v is split as v = hi + lo with hi = rna_tf32(v)
// and lo = rna_tf32(v - hi) (round to nearest, ties away, as
// cvt.rna.tf32.f32 rounds; see tf32_rna), and a . b becomes
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi: three mma.sync.m16n8k8.f32.tf32 into
// one f32 accumulator, the small terms first (mma3). The numerics, and why
// every caller sums at most 32 products of a chain in a fresh partial, are
// set out at the top of gemm_f32.cuh.

#pragma once

#include <cuda_runtime.h>

namespace tf32x3 {

// VEC floats from gmem to smem, zero-filled when !pred (gmem must still be
// a valid address then; the caller passes its base pointer).
template <int VEC>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(pred ? 16 : 0)
                 : "memory");
  } else {
    static_assert(VEC == 1, "4- or 16-byte copies");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(pred ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero: cvt.rna.tf32.f32's rounding for every finite v, in two integer ops
// (ptxas expands the cvt into a longer compare-and-select sequence)
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo, both TF32 bit patterns
__device__ __forceinline__ void split_tf32(float v, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += a . b over one m16n8k8 tile; with first, d = a . b
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2], bool first) {
  if (first)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
          "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a . b at f32 accuracy from split operands (with first, d = a . b):
// a_lo.b_hi, a_hi.b_lo, a_hi.b_hi; a_lo.b_lo is dropped
__device__ __forceinline__ void mma3(float (&d)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4],
                                     const unsigned (&bh)[2],
                                     const unsigned (&bl)[2], bool first) {
  mma_tf32(d, al, bh, first);
  mma_tf32(d, ah, bl, false);
  mma_tf32(d, ah, bh, false);
}

}  // namespace tf32x3
