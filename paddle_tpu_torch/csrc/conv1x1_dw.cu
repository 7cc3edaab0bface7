// Weight gradient of a 1x1 convolution, dW = x^T . dy, float32, for sm_90a.
//
// Replaces paddle_tpu/nn/pallas_conv.py:_dw_kernel (launched by dw_pallas,
// the dW half of conv1x1's VJP): x [M, Cin] and dy [M, Cout], both
// row-major with M = batch * height * width, give dW [Cin, Cout] summed
// over M in f32.
//
// What bounds it on the H100: the products run on the tensor cores in
// split TF32 (gemm_f32.cuh: three TF32 products per f32 product, f32
// accuracy), 3 * 2 * M * Cin * Cout operations against 495 TFLOP/s. Over
// the 36 calls of a ResNet-50 step at batch 128 that is close to the bytes
// (8.5 GB at 3.35 TB/s): operations bound the wide late stages, bytes the
// early [401408, 64] shapes.
//
// The trouble is the shape: the output is tiny and M is huge (401,408 rows
// into a [64, 64] output at the first stage). The TPU kernel walks M on its
// sequential grid and accumulates one output tile in place; on the H100
// one block per output tile would leave 131 of 132 SMs idle. So M is split
// too: block (j, i, s) owns the output tile (i, j) over the rows
// [s * M / splits, (s + 1) * M / splits) of split s, and runs the shared
// mainloop (gemm_f32.cuh) over them in 32-row k-tiles: A = x^T, staged
// k-major from whole rows of x, B = dy, from whole rows of dy, so every
// copy reads rows, coalesced, and the transpose costs nothing. The tile is
// 128 x 128 where Cin and Cout reach 128, else 64 x 64; the wrapper
// (paddle_tpu_torch/nn/cuda_conv.py) picks it, the split count (one wave of
// resident blocks) and the copy width (16 bytes when both operands' rows
// and base pointers allow it, else 4). With
// more than one split the partial tiles go to a workspace
// [splits, Cin, Cout] and a second pass (split_reduce, gemm_f32.cuh)
// sums them in a fixed order: no atomics, so two runs are bit-equal. M,
// Cin and Cout need not be multiples of anything: rows and columns past
// the edge load as zeros.
//
// Next step (the mainloop runs at about half the mma.sync rate; every
// warp re-splits each fragment value it loads): split each value once as
// it lands in shared memory, into hi and lo planes that one block an SM
// has room for. Later: bf16 operands on wgmma/TMA.
// A persistent stream-K split in place of the second pass.

#include "gemm_f32.cuh"

namespace {

using namespace gemm_f32;

// Copies of the rows [m_begin + 32 kt, ...) of x (columns ci0..) and dy
// (columns co0..) into a stage, both as [k][channel].
template <class C, int VEC>
struct DwLoader {
  const float* __restrict__ x;
  const float* __restrict__ dy;
  int Cin, Cout, ci0, co0;
  long long m_begin, m_end;

  template <int W, int PITCH>
  __device__ __forceinline__ void rows(float* dst,
                                       const float* __restrict__ src,
                                       int width, int c0, int kt) const {
    constexpr int PER_ROW = W / VEC;
    static_assert(C::BK * PER_ROW % C::NT == 0, "whole copies per thread");
#pragma unroll
    for (int q = 0; q < C::BK * PER_ROW / C::NT; ++q) {
      const int p = threadIdx.x + q * C::NT;
      const int r = p / PER_ROW, c = p % PER_ROW * VEC;
      const long long m = m_begin + (long long)kt * C::BK + r;
      const bool live = m < m_end && c0 + c < width;
      cp_async<VEC>(dst + r * PITCH + c, live ? src + m * width + c0 + c : src,
                    live);
    }
  }

  __device__ __forceinline__ void load(float* stage, int kt) const {
    rows<C::BM, C::LDA>(stage, x, Cin, ci0, kt);
    rows<C::BN, C::LDB>(stage + C::A_FLOATS, dy, Cout, co0, kt);
  }

  __device__ __forceinline__ void fixup(float*, int) const {}
};

template <class C, int VEC>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
dw_tiles(const float* __restrict__ x, const float* __restrict__ dy,
         float* __restrict__ out, int M, int Cin, int Cout, int splits) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.z;
  DwLoader<C, VEC> ld{x, dy, Cin, Cout, (int)blockIdx.y * C::BM,
                      (int)blockIdx.x * C::BN, (long long)s * M / splits,
                      (long long)(s + 1) * M / splits};
  const int ktiles = (int)((ld.m_end - ld.m_begin + C::BK - 1) / C::BK);
  float acc[C::MI][C::NI][4];
  mainloop<C>(ld, ktiles, smem, acc);
  store<C, VEC>(acc, smem, out + (size_t)s * Cin * Cout, Cin, Cout, Cout,
                ld.ci0, ld.co0);
}

template <class C, int VEC>
cudaError_t launch_tiles(const float* x, const float* dy, float* tiles, int M,
                         int Cin, int Cout, int splits, cudaStream_t st) {
  const cudaError_t err = allow_smem<C>(dw_tiles<C, VEC>);
  if (err != cudaSuccess) return err;
  const dim3 grid((Cout + C::BN - 1) / C::BN, (Cin + C::BM - 1) / C::BM,
                  splits);
  dw_tiles<C, VEC><<<grid, C::NT, C::SMEM_BYTES, st>>>(x, dy, tiles, M, Cin,
                                                       Cout, splits);
  return cudaGetLastError();
}

}  // namespace

// x: [M, Cin], dy: [M, Cout], out: [Cin, Cout], all float32 and
// contiguous; work: [splits, Cin, Cout] float32 when splits > 1 (unused
// otherwise). tile: 0 for 128 x 128 output tiles, 1 for 64 x 64; vec: 4
// for 16-byte copies (x, dy 16-byte aligned, Cin and Cout multiples of 4),
// else 1. Split s covers rows [s * M / splits, (s + 1) * M / splits).
// Returns a cudaError_t.
extern "C" int conv1x1_dw_f32(const void* x, const void* dy, void* out,
                              void* work, int M, int Cin, int Cout,
                              int splits, int tile, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = Cin * Cout;
  if (M == 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n, st);
  if ((tile != 0 && tile != 1) || (vec != 1 && vec != 4) || splits < 1)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dy);
  float* tiles = static_cast<float*>(splits > 1 ? work : out);
  cudaError_t err;
  if (tile == 0)
    err = vec == 4 ? launch_tiles<Large<true>, 4>(xf, df, tiles, M, Cin, Cout,
                                                  splits, st)
                   : launch_tiles<Large<true>, 1>(xf, df, tiles, M, Cin, Cout,
                                                  splits, st);
  else
    err = vec == 4 ? launch_tiles<Small<true>, 4>(xf, df, tiles, M, Cin, Cout,
                                                  splits, st)
                   : launch_tiles<Small<true>, 1>(xf, df, tiles, M, Cin, Cout,
                                                  splits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)launch_split_reduce(tiles, static_cast<float*>(out), n,
                                  splits, st);
}
