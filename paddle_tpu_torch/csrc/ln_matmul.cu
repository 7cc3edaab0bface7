// Fused LayerNorm and matrix product, out = LayerNorm(x) @ w, float32, for
// sm_90a.
//
// Replaces paddle_tpu/nn/fused_ln.py:_ln_matmul_kernel (launched by
// fused_ln_matmul): x [M, K], w [K, N], optional scale and bias [K]; each
// row of x is normalised with its f32 mean and variance (two passes, as
// jnp.var computes it) and 1 / sqrt(var + eps), scaled and shifted, and
// multiplied with w, the sum over K in f32.
//
// What bounds it on the H100: float32 operands have no tensor-core route
// without TF32, so the product runs on CUDA-core FMAs (67 TFLOP/s); at the
// transformer width (x [16384, 512], w [512, 512] or [512, 2048]) it does
// 2 * M * K * N operations against 4 * (M*K + K*N + M*N + 2K) bytes, and
// operations bound it.
//
// Design: one block per 64 x 64 output tile, 256 threads as a 16 x 16 grid
// with a 4 x 4 patch of the tile each in registers. The block first takes
// the statistics of its 64 rows (eight warps, a row per warp at a time,
// shuffle sums: the mean, then the mean of squared deviations from it)
// into shared memory. Then the K loop loads 16 columns of those rows,
// normalises each value as it loads it, (x - mean) * rstd * scale + bias,
// and stores the normalised tile transposed in shared memory beside the
// matching 16 rows of w, whose outer products it adds. The normalised
// [M, K] tensor is never written to device memory: that is the point of
// the fusion. As in the TPU kernel the statistics are recomputed for every
// N-tile; the grid walks N fastest, so the blocks that share a row tile run
// together and find its rows in L2. Rows, columns and K past the edge load
// as zeros, so no shape needs to be a multiple of the tile.
//
// Left for later work: wgmma/TMA pipelines, bf16 operands.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int XS_LD = BM + 4;  // breaks the bank pattern of the
                               // transposed store, keeps float4 alignment

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(NT)
ln_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int M, int K, int N, float eps) {
  __shared__ float mean_s[BM];
  __shared__ float rstd_s[BM];
  __shared__ __align__(16) float xs[BK][XS_LD];  // normalised x, k-major
  __shared__ __align__(16) float ws[BK][BN];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int r = warp; r < BM; r += NT / 32) {
    const int m = m0 + r;
    float mean = 0.f, var = 0.f;
    if (m < M) {
      const float* row = x + (size_t)m * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += row[k];
      mean = warp_sum(s) / K;
      float q = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = row[k] - mean;
        q = fmaf(d, d, q);
      }
      var = warp_sum(q) / K;
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = 1.f / sqrtf(var + eps);
    }
  }
  __syncthreads();

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r, k = k0 + c;
      float v = 0.f;
      if (m < M && k < K) {
        v = (x[(size_t)m * K + k] - mean_s[r]) * rstd_s[r];
        if (scale != nullptr) v *= scale[k];
        if (bias != nullptr) v += bias[k];
      }
      xs[c][r] = v;
    }
    for (int i = threadIdx.x; i < BK * BN; i += NT) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      ws[r][c] = (k < K && n < N) ? w[(size_t)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&ws[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// x: [M, K], w: [K, N], out: [M, N], scale and bias: [K] or null; all
// float32 and contiguous. Returns a cudaError_t.
extern "C" int ln_matmul_f32(const void* x, const void* w, const void* scale,
                             const void* bias, void* out, int M, int K, int N,
                             float eps, void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  ln_matmul_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(out), M, K, N, eps);
  return (int)cudaGetLastError();
}
