// One block-tile product C[BM x BN] += A . B over a K range, float32 in and
// out, on Hopper's tensor cores at float32 accuracy; shared by
// conv1x1_dw.cu and ln_matmul.cu.
//
// Numerics: split TF32 ("3xTF32"). Each f32 operand value v is split as
// v = hi + lo with hi = rna_tf32(v) and lo = rna_tf32(v - hi) (round to
// nearest, ties away, as cvt.rna.tf32.f32 rounds; see tf32_rna), and
// a . b becomes a_lo.b_hi + a_hi.b_lo + a_hi.b_hi: three
// mma.sync.m16n8k8.f32.tf32 into one f32 accumulator, the small terms
// first. hi keeps 11 significant bits, lo the next 11; the dropped a_lo.b_lo
// and the residue v - hi - lo are about 2^-22 of |a||b|, on the order of
// f32's own rounding, so the product holds the port's f32 gates where one
// TF32 product (about three decimal digits) would not. It is the GPU's
// counterpart of the TPU's multi-pass bf16 "HIGH" precision. Bound: three
// TF32 products, 3 * 2 * M * N * K operations against 495 TFLOP/s (the
// H100 reaches about 320 TFLOP/s of TF32 through mma.sync:
// tools/mma_tf32_peak.py).
//
// Accumulation: the tensor cores add an mma's products into its f32
// accumulator with truncation, not rounding to nearest, so a long chain of
// mma into one accumulator drifts toward zero. Over a 4,054-row split of
// conv1x1_dw (about 1,500 mma per fragment) that drift reached 2.6e-5 of
// the largest |dW| on the card, ten times the CUDA-core kernel's error,
// and moved ResNet-50's loss curve past its gate. So each 32-row k-tile's
// 12 mma per fragment start from zero in a partial sum, and the partial is
// added to the block's accumulator with an ordinary f32 FADD (round to
// nearest): the truncation then acts on sums of 32 products only.
//
// Why mma.sync and not wgmma: wgmma reads TF32 operands from shared memory
// only K-major (transposed layouts exist for 16-bit types only), and here
// the operands arrive the other way round: conv1x1_dw contracts over M,
// the strided dimension of both x [M, Cin] and dy [M, Cout], and
// ln_matmul's w [K, N] is N-major. mma.sync fragments are loaded by plain
// 32-bit shared-memory loads from any layout padded against bank
// conflicts, and the hi/lo split happens in registers as they load. wgmma
// and TMA belong with bf16 operands, where 16-bit transposes exist.
//
// Staging: cp.async copies (16 bytes where the wrapper found the operands
// aligned, else 4; out-of-range chunks zero-filled) into a ring of STAGES
// shared-memory stages, one commit group per stage, so tile k + STAGES - 1
// loads while tile k computes; one __syncthreads per stage. The ring is
// dynamic shared memory above 48 KB: each entry point raises the kernel's
// limit with cudaFuncSetAttribute before its launch.
//
// The caller supplies the loader: a struct with
//   load(float* stage, int kt)  issue this thread's cp.async for k-tile kt
//                               (A at stage[0], B at stage[A_FLOATS])
//   fixup(float* stage, int kt) after this thread's copies of kt landed,
//                               rewrite the chunks it copied (ln_matmul
//                               normalises x there; conv1x1_dw does nothing)
// A is held k-major (As[k][m], conv1x1_dw: rows of x) or m-major
// (As[m][k], ln_matmul: rows of x); B is always Bs[k][n].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace gemm_f32 {

using namespace tf32x3;  // cp_async, split_tf32, mma_tf32

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MIN_BLOCKS_,
          bool A_KMAJOR_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = 32;
  static constexpr int WM = WM_, WN = WN_;    // warp tile
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr bool A_KMAJOR = A_KMAJOR_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = 32 * (BM / WM) * WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;  // mma tiles per warp
  // row pitches in floats: 16-byte rows for cp.async, and fragment loads
  // free of bank conflicts (pitch = 8 mod 32 where lanes walk k by t and
  // m or n by g; pitch = 4 mod 32 where they walk m by g and k by t)
  static constexpr int LDA = A_KMAJOR ? BM + 8 : BK + 4;
  static constexpr int A_FLOATS = A_KMAJOR ? BK * LDA : BM * LDA;
  static constexpr int LDB = BN + 8;
  static constexpr int STAGE_FLOATS = A_FLOATS + BK * LDB;
  static constexpr int LDC = BN + 8;    // epilogue staging of C
  static constexpr int SMEM_BYTES =
      4 * (STAGES * STAGE_FLOATS > BM * LDC ? STAGES * STAGE_FLOATS
                                            : BM * LDC);
};

// The two tile instances the wrappers choose from (paddle_tpu_torch/nn/
// gemm_f32.py: TILES): 128 x 128 with 8 warps of 64 x 32 and 4 stages,
// one block an SM (the partial and the full accumulator take 128
// registers a thread); 64 x 64 with 4 warps of 32 x 32 and 4 stages,
// three blocks an SM.
template <bool A_KMAJOR>
using Large = Cfg<128, 128, 64, 32, 4, 1, A_KMAJOR>;
template <bool A_KMAJOR>
using Small = Cfg<64, 64, 32, 32, 4, 3, A_KMAJOR>;

// Sets acc to this block's A . B over k-tiles [0, ktiles). Thread layout
// of acc[i][j][e] (the m16n8 accumulator fragment): row wm + 16 i + g
// (+ 8 for e >= 2), column wn + 8 j + 2 t + (e & 1), with g = lane / 4,
// t = lane % 4 and (wm, wn) the warp's corner. Each k-tile's 12 mma per
// fragment go into a fresh partial sum, added to acc with one FADD (see
// the note on accumulation at the top). Leaves smem free for reuse.
template <class C, class Loader>
__device__ __forceinline__ void mainloop(const Loader& ld, int ktiles,
                                         float* smem,
                                         float (&acc)[C::MI][C::NI][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WARPS_N * C::WM, wn = warp % C::WARPS_N * C::WN;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < ktiles) ld.load(smem + s * C::STAGE_FLOATS, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<C::STAGES - 2>();          // this thread's copies of kt
    const float* sa = smem + (kt % C::STAGES) * C::STAGE_FLOATS;
    const float* sb = sa + C::A_FLOATS;
    ld.fixup(smem + (kt % C::STAGES) * C::STAGE_FLOATS, kt);
    __syncthreads();       // all copies of kt visible; kt - 1 fully read
    const int next = kt + C::STAGES - 1;     // into the stage kt - 1 used
    if (next < ktiles) ld.load(smem + (next % C::STAGES) * C::STAGE_FLOATS,
                               next);
    cp_async_commit();
    float part[C::MI][C::NI][4];
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 8) {
      unsigned bh[C::NI][2], bl[C::NI][2];
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          split_tf32(sb[(kk + t + 4 * h) * C::LDB + wn + 8 * j + g], bh[j][h],
                     bl[j][h]);
#pragma unroll
      for (int i = 0; i < C::MI; ++i) {
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // (g, t) (g+8, t) (g, t+4) (g+8, t+4)
          const int r = wm + 16 * i + g + 8 * (e & 1);
          const int k = kk + t + 4 * (e >> 1);
          split_tf32(C::A_KMAJOR ? sa[k * C::LDA + r] : sa[r * C::LDA + k],
                     ah[e], al[e]);
        }
#pragma unroll
        for (int j = 0; j < C::NI; ++j) {    // the small terms first
          mma_tf32(part[i][j], al, bh[j], kk == 0);
          mma_tf32(part[i][j], ah, bl[j], false);
          mma_tf32(part[i][j], ah, bh[j], false);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Writes acc to out[row0 + r][col0 + c] (row pitch ld) for rows < rows and
// columns < cols, through smem so that each thread stores whole VEC-float
// pieces of rows; VEC = 4 needs cols % 4 == 0 and a 16-byte aligned out.
template <class C, int VEC>
__device__ __forceinline__ void store(const float (&acc)[C::MI][C::NI][4],
                                      float* smem, float* __restrict__ out,
                                      int rows, int cols, int ld, int row0,
                                      int col0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WARPS_N * C::WM, wn = warp % C::WARPS_N * C::WN;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            &smem[(wm + 16 * i + g + 8 * h) * C::LDC + wn + 8 * j + 2 * t]) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
  __syncthreads();
  constexpr int PER_ROW = C::BN / VEC;
  static_assert(C::BM * PER_ROW % C::NT == 0, "whole stores per thread");
#pragma unroll 4
  for (int q = 0; q < C::BM * PER_ROW / C::NT; ++q) {
    const int p = threadIdx.x + q * C::NT;
    const int r = p / PER_ROW, c = p % PER_ROW * VEC;
    const int row = row0 + r, col = col0 + c;
    if (row >= rows || col >= cols) continue;
    float* dst = out + (size_t)row * ld + col;
    const float* src = &smem[r * C::LDC + c];
    if constexpr (VEC == 4)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else
      *dst = *src;
  }
}

constexpr int RED_PARTS = 8;   // rows of threads summing one column

// The second pass of a product split over its contraction (conv1x1_dw.cu,
// conv1x1_dw_bf16.cu): out[i] = sum over s of part[s][i]. Thread row p
// sums splits [p * splits / 8, (p + 1) * splits / 8) in increasing order,
// then row 0 adds the eight partial sums in increasing p. Fixed by n and
// splits, so two runs are bit-equal.
__global__ void __launch_bounds__(32 * RED_PARTS)
split_reduce(const float* __restrict__ part, float* __restrict__ out, int n,
             int splits) {
  __shared__ float partial[RED_PARTS][32];
  const int i = blockIdx.x * 32 + threadIdx.x, p = threadIdx.y;
  float sum = 0.f;
  if (i < n) {
    const int s1 = (int)((long long)(p + 1) * splits / RED_PARTS);
    for (int s = (int)((long long)p * splits / RED_PARTS); s < s1; ++s)
      sum += part[(size_t)s * n + i];
  }
  partial[p][threadIdx.x] = sum;
  __syncthreads();
  if (p != 0 || i >= n) return;
#pragma unroll
  for (int q = 1; q < RED_PARTS; ++q) sum += partial[q][threadIdx.x];
  out[i] = sum;
}

inline cudaError_t launch_split_reduce(const float* part, float* out, int n,
                                       int splits, cudaStream_t st) {
  split_reduce<<<(n + 31) / 32, dim3(32, RED_PARTS), 0, st>>>(part, out, n,
                                                              splits);
  return cudaGetLastError();
}

// split_reduce over four neighbouring outputs a thread, for n4 = n / 4
// float4s (n a multiple of 4, part and out 16-byte aligned): the same
// additions in the same order for every output, so the same bits, with
// 16-byte loads and a quarter of the blocks. (conv1x1_dw_bf16.cu; at
// n = 2^20 and two splits the scalar kernel's 32,768 blocks took 24 us on
// the H100, about as long as the product.)
__global__ void __launch_bounds__(32 * RED_PARTS)
split_reduce4(const float4* __restrict__ part, float4* __restrict__ out,
              int n4, int splits) {
  __shared__ float4 partial[RED_PARTS][32];
  const int i = blockIdx.x * 32 + threadIdx.x, p = threadIdx.y;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n4) {
    const int s1 = (int)((long long)(p + 1) * splits / RED_PARTS);
    for (int s = (int)((long long)p * splits / RED_PARTS); s < s1; ++s) {
      const float4 v = part[(size_t)s * n4 + i];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
  }
  partial[p][threadIdx.x] = sum;
  __syncthreads();
  if (p != 0 || i >= n4) return;
#pragma unroll
  for (int q = 1; q < RED_PARTS; ++q) {
    const float4 v = partial[q][threadIdx.x];
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  out[i] = sum;
}

// split_reduce4 where n and the pointers allow it, else split_reduce.
inline cudaError_t launch_split_reduce_vec(const float* part, float* out,
                                           int n, int splits,
                                           cudaStream_t st) {
  if (n % 4 || reinterpret_cast<uintptr_t>(part) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return launch_split_reduce(part, out, n, splits, st);
  const int n4 = n / 4;
  split_reduce4<<<(n4 + 31) / 32, dim3(32, RED_PARTS), 0, st>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
      n4, splits);
  return cudaGetLastError();
}

// Raises kernel's dynamic shared-memory limit to C::SMEM_BYTES.
template <class C, class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              C::SMEM_BYTES);
}

}  // namespace gemm_f32
