// Weight gradient of a 1x1 convolution, dW = x^T . dy, float32, for sm_90a.
//
// Replaces paddle_tpu/nn/pallas_conv.py:_dw_kernel (launched by dw_pallas,
// the dW half of conv1x1's VJP): x [M, Cin] and dy [M, Cout], both
// row-major with M = batch * height * width, give dW [Cin, Cout] summed
// over M in f32.
//
// What bounds it on the H100: the path runs it on float32 operands, which
// have no tensor-core route without TF32 (about three decimal digits lost
// against the f32 reference), so the work is CUDA-core FMAs (67 TFLOP/s).
// Over the 36 calls of a ResNet-50 step at batch 128 the two bounds are
// close: 0.54 TFLOP against 8.5 GB, operations for the wide late stages,
// bytes for the early [401408, 64] shapes.
//
// The trouble is the shape: the output is tiny and M is huge (401,408 rows
// into a [64, 64] output at the first stage). The TPU kernel walks M on its
// sequential grid and accumulates one output tile in place; on the H100
// one block per output tile would leave 131 of 132 SMs idle. So M is split
// too: block (j, i, s) owns the 64 x 64 output tile (i, j) over the rows of
// split s, 256 threads as a 16 x 16 grid with a 4 x 4 patch of the tile
// each in registers. It stages 32-row slices of x and dy in shared memory
// (both operands are row-major [M, C], so every load reads whole rows,
// coalesced, and the transpose costs nothing) and adds their outer
// products. With more than one split the partial tiles go to a workspace
// [splits, Cin, Cout] and a second pass sums them in split order, one
// thread per output entry. No atomics: the order of every sum is fixed by
// the shapes and the split count, so two runs are bit-equal. The wrapper
// (paddle_tpu_torch/nn/cuda_conv.py) picks the split count from the SM
// count and allocates the workspace. M, Cin and Cout need not be multiples
// of anything: rows and columns past the edge load as zeros.
//
// Left for later work: double-buffered (cp.async / TMA) loads, bf16
// operands on wgmma.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;  // output tile TILE x TILE per block
constexpr int ROWS = 32;  // rows of M staged per shared-memory step
constexpr int NT = 256;   // 16 x 16 threads, a 4 x 4 patch each

__global__ void __launch_bounds__(NT)
dw_tiles(const float* __restrict__ x, const float* __restrict__ dy,
         float* __restrict__ out, int M, int Cin, int Cout,
         int rows_per_split) {
  __shared__ __align__(16) float xs[ROWS][TILE];
  __shared__ __align__(16) float gs[ROWS][TILE];
  const int co0 = blockIdx.x * TILE;
  const int ci0 = blockIdx.y * TILE;
  const long long m_begin = (long long)blockIdx.z * rows_per_split;
  const long long m_end = min((long long)M, m_begin + rows_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long m0 = m_begin; m0 < m_end; m0 += ROWS) {
    for (int i = threadIdx.x; i < ROWS * TILE; i += NT) {
      const int r = i / TILE, c = i % TILE;
      const long long m = m0 + r;
      const bool live = m < m_end;
      xs[r][c] = (live && ci0 + c < Cin) ? x[m * Cin + ci0 + c] : 0.f;
      gs[r][c] = (live && co0 + c < Cout) ? dy[m * Cout + co0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < ROWS; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* o = out + (size_t)blockIdx.z * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= Cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < Cout) o[(size_t)ci * Cout + co] = acc[i][j];
    }
  }
}

// out[i] = sum over s of part[s][i], s in increasing order.
__global__ void dw_reduce(const float* __restrict__ part,
                          float* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int k = 1; k < splits; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

}  // namespace

// x: [M, Cin], dy: [M, Cout], out: [Cin, Cout], all float32 and contiguous;
// work: [splits, Cin, Cout] float32 when splits > 1 (unused otherwise).
// Split s covers rows [s * rows_per_split, (s + 1) * rows_per_split) of M;
// splits * rows_per_split >= M. Returns a cudaError_t.
extern "C" int conv1x1_dw_f32(const void* x, const void* dy, void* out,
                              void* work, int M, int Cin, int Cout,
                              int splits, int rows_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = Cin * Cout;
  if (M == 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n, st);
  float* tiles = static_cast<float*>(splits > 1 ? work : out);
  const dim3 grid((Cout + TILE - 1) / TILE, (Cin + TILE - 1) / TILE, splits);
  dw_tiles<<<grid, NT, 0, st>>>(static_cast<const float*>(x),
                                static_cast<const float*>(dy), tiles, M, Cin,
                                Cout, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  dw_reduce<<<(n + 255) / 256, 256, 0, st>>>(tiles, static_cast<float*>(out),
                                             n, splits);
  return (int)cudaGetLastError();
}
