// Fused LayerNorm and matrix product, out = LayerNorm(x) @ w, float32, for
// sm_90a.
//
// Replaces paddle_tpu/nn/fused_ln.py:_ln_matmul_kernel (launched by
// fused_ln_matmul): x [M, K], w [K, N], optional scale and bias [K]; each
// row of x is normalised with its f32 mean and variance (two passes, as
// jnp.var computes it) and 1 / sqrt(var + eps), scaled and shifted, and
// multiplied with w, the sum over K in f32.
//
// What bounds it on the H100: the product runs on the tensor cores in
// split TF32 (gemm_f32.cuh: three TF32 products per f32 product, f32
// accuracy); at the transformer width (x [16384, 512], w [512, 512] or
// [512, 2048]) its 3 * 2 * M * K * N operations against 495 TFLOP/s
// outweigh its 4 * (M*K + K*N + M*N + 2K) bytes, so operations bound it.
//
// Design: two launches from one entry point. ln_stats takes each row's
// statistics once (a warp per row, shuffle sums: the mean, then the mean
// of squared deviations from it, the op order of the TPU kernel's
// jnp.mean / jnp.var) into a [2, M] workspace of the wrapper's: mean, then
// 1 / sqrt(var + eps). ln_gemm copies its rows' statistics into shared
// memory, then runs the shared mainloop: the A stage
// is a [BM][BK] tile of raw x rows, copied by cp.async; once its own
// copies have landed each thread normalises the pieces it copied in place,
// (x - mean) * rstd * scale + bias, before the stage's barrier, and the
// fragments split into TF32 halves as they load. The normalised [M, K]
// tensor never reaches device memory: that is the point of the fusion.
// The epilogue stages C in shared memory and stores whole 16-byte pieces
// of rows where N allows. Rows, columns and K past the edge load as zeros
// (normalised K-padding is written as zero), so no shape needs to be a
// multiple of the tile. The wrapper (paddle_tpu_torch/nn/fused_ln.py)
// picks the tile (128 x 128 where the output fills the card with them,
// else 64 x 64) and the copy width (16 bytes when x, w, scale and bias
// allow it, else 4).
//
// Next step (the mainloop runs at about half the mma.sync rate; every
// warp re-splits each fragment value it loads): split each value once as
// it lands in shared memory, into hi and lo planes that one block an SM
// has room for. Later: bf16 operands on wgmma/TMA.

#include "gemm_f32.cuh"

namespace {

using namespace gemm_f32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int STATS_WARPS = 8;

// stats[m] = mean of row m, stats[M + m] = 1 / sqrt(var + eps).
__global__ void __launch_bounds__(32 * STATS_WARPS)
ln_stats(const float* __restrict__ x, float* __restrict__ stats, int M, int K,
         float eps) {
  const int m = blockIdx.x * STATS_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const float* row = x + (size_t)m * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += row[k];
  const float mean = warp_sum(s) / K;
  float q = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = row[k] - mean;
    q = fmaf(d, d, q);
  }
  const float var = warp_sum(q) / K;
  if (lane == 0) {
    stats[m] = mean;
    stats[M + m] = 1.f / sqrtf(var + eps);
  }
}

// Copies rows m0.. of x (columns 32 kt..) as As[m][k] and rows 32 kt.. of
// w (columns n0..) as Bs[k][n]; fixup normalises this thread's x pieces.
template <class C, int VEC>
struct LnLoader {
  const float* __restrict__ x;
  const float* __restrict__ w;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  const float* mean;   // the block's rows, in shared memory
  const float* rstd;
  int M, K, N, m0, n0;

  static constexpr int A_ROW = C::BK / VEC, B_ROW = C::BN / VEC;
  static_assert(C::BM * A_ROW % C::NT == 0 && C::BK * B_ROW % C::NT == 0,
                "whole copies per thread");

  __device__ __forceinline__ void load(float* stage, int kt) const {
#pragma unroll
    for (int q = 0; q < C::BM * A_ROW / C::NT; ++q) {
      const int p = threadIdx.x + q * C::NT;
      const int r = p / A_ROW, c = p % A_ROW * VEC;
      const int m = m0 + r, k = kt * C::BK + c;
      const bool live = m < M && k < K;
      cp_async<VEC>(stage + r * C::LDA + c, live ? x + (size_t)m * K + k : x,
                    live);
    }
    float* bs = stage + C::A_FLOATS;
#pragma unroll
    for (int q = 0; q < C::BK * B_ROW / C::NT; ++q) {
      const int p = threadIdx.x + q * C::NT;
      const int r = p / B_ROW, c = p % B_ROW * VEC;
      const int k = kt * C::BK + r, n = n0 + c;
      const bool live = k < K && n < N;
      cp_async<VEC>(bs + r * C::LDB + c, live ? w + (size_t)k * N + n : w,
                    live);
    }
  }

  // VEC entries of scale or bias from k (past K, or without one: fill)
  __device__ __forceinline__ void affine(const float* __restrict__ a, int k,
                                         float fill, float (&out)[VEC]) const {
    if constexpr (VEC == 4) {
      if (a != nullptr && k < K) {     // K % 4 == 0, a 16-byte aligned
        const float4 v = *reinterpret_cast<const float4*>(a + k);
        out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
        return;
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = a != nullptr && k + e < K ? a[k + e] : fill;
  }

  // The pieces of the A stage this thread copied in load(stage, kt). A
  // thread's pieces share their columns (NT is a multiple of A_ROW), so
  // scale and bias load once.
  __device__ __forceinline__ void fixup(float* stage, int kt) const {
    static_assert(C::NT % A_ROW == 0, "one column per thread");
    const int c = threadIdx.x % A_ROW * VEC, k = kt * C::BK + c;
    float sc[VEC], bi[VEC];
    affine(scale, k, 1.f, sc);
    affine(bias, k, 0.f, bi);
#pragma unroll
    for (int q = 0; q < C::BM * A_ROW / C::NT; ++q) {
      const int r = (threadIdx.x + q * C::NT) / A_ROW, m = m0 + r;
      float* v = stage + r * C::LDA + c;
      const bool row = m < M;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float y = (v[e] - mean[r]) * rstd[r];
        if (scale != nullptr) y *= sc[e];
        if (bias != nullptr) y += bi[e];
        v[e] = row && k + e < K ? y : 0.f;
      }
    }
  }
};

template <class C, int VEC>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
ln_gemm(const float* __restrict__ x, const float* __restrict__ w,
        const float* __restrict__ scale, const float* __restrict__ bias,
        const float* __restrict__ stats, float* __restrict__ out, int M, int K,
        int N) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float row_stats[2][C::BM];
  const int m0 = blockIdx.y * C::BM;
  for (int r = threadIdx.x; r < C::BM; r += C::NT) {
    const bool row = m0 + r < M;
    row_stats[0][r] = row ? stats[m0 + r] : 0.f;
    row_stats[1][r] = row ? stats[M + m0 + r] : 0.f;
  }
  __syncthreads();
  const LnLoader<C, VEC> ld{x, w, scale, bias, row_stats[0], row_stats[1],
                            M, K, N, m0, (int)blockIdx.x * C::BN};
  float acc[C::MI][C::NI][4];
  mainloop<C>(ld, (K + C::BK - 1) / C::BK, smem, acc);
  store<C, VEC>(acc, smem, out, M, N, N, ld.m0, ld.n0);
}

template <class C, int VEC>
cudaError_t launch_gemm(const float* x, const float* w, const float* scale,
                        const float* bias, const float* stats, float* out,
                        int M, int K, int N, cudaStream_t st) {
  const cudaError_t err = allow_smem<C>(ln_gemm<C, VEC>);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  ln_gemm<C, VEC><<<grid, C::NT, C::SMEM_BYTES, st>>>(x, w, scale, bias,
                                                      stats, out, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// x: [M, K], w: [K, N], out: [M, N], scale and bias: [K] or null; stats:
// a [2, M] float32 workspace; all float32 and contiguous. tile: 0 for
// 128 x 128 output tiles, 1 for 64 x 64; vec: 4 for 16-byte copies (x, w,
// scale and bias 16-byte aligned, K and N multiples of 4), else 1.
// Returns a cudaError_t.
extern "C" int ln_matmul_f32(const void* x, const void* w, const void* scale,
                             const void* bias, void* out, void* stats, int M,
                             int K, int N, float eps, int tile, int vec,
                             void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if ((tile != 0 && tile != 1) || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* sf = static_cast<float*>(stats);
  ln_stats<<<(M + STATS_WARPS - 1) / STATS_WARPS, 32 * STATS_WARPS, 0, st>>>(
      xf, sf, M, K, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* wf = static_cast<const float*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  if (tile == 0)
    err = vec == 4 ? launch_gemm<Large<false>, 4>(xf, wf, sc, bi, sf, of, M,
                                                  K, N, st)
                   : launch_gemm<Large<false>, 1>(xf, wf, sc, bi, sf, of, M,
                                                  K, N, st);
  else
    err = vec == 4 ? launch_gemm<Small<false>, 4>(xf, wf, sc, bi, sf, of, M,
                                                  K, N, st)
                   : launch_gemm<Small<false>, 1>(xf, wf, sc, bi, sf, of, M,
                                                  K, N, st);
  return (int)err;
}
