// Weight gradient of a 1x1 convolution on bf16 operands, dW = x^T . dy
// summed in f32, for sm_90a.
//
// Replaces paddle_tpu/nn/pallas_conv.py:_dw_kernel as the bfloat16_compute
// policy runs it: ResNet's activations and weights are bf16 there, so
// dw_pallas receives bf16 x [M, Cin] and dy [M, Cout] (row-major, M = batch
// * height * width) and returns dW [Cin, Cout] in f32 (which the caller
// then rounds to the weight's bf16).
//
// What bounds it on the H100: bytes at the early stages, where M is
// 401,408 rows and Cin, Cout are 64-256, and operations at the late ones
// (2 * M * Cin * Cout at the card's bf16 mma.sync rate,
// tools/mma_bf16_peak.py). Over the 36 calls of a ResNet-50 step at batch
// 128 the operands are 4.2 GB, about 1.3 ms at 3.35 TB/s.
//
// Design: the split of M and the tile instances of the f32 kernel
// (conv1x1_dw.cu; the wrapper, paddle_tpu_torch/nn/cuda_conv.py, plans
// both from the shapes and the SM count): block (j, i, s) owns the output
// tile (i, j) over the rows [s * M / splits, (s + 1) * M / splits) of split
// s, and walks them in 32-row k-tiles staged by cp.async into a ring of
// shared-memory stages. Both operands are stored with the contraction
// dimension M outermost, so a stage holds whole rows of x and dy, copied
// coalesced, and ldmatrix.trans (mma_bf16.cuh) forms the A = x^T and B = dy
// fragments from them. Each k-tile's two mma.sync.m16n8k16 per fragment
// start from zero in a partial sum that one FADD adds into the block's f32
// accumulator, as gemm_f32.cuh does for TF32 (the tensor cores truncate a
// long chain). With more than one split the partial tiles go to a
// workspace [splits, Cin, Cout] and split_reduce (gemm_f32.cuh) sums them
// in a fixed order: no atomics, so two runs are bit-equal. M, Cin and Cout
// need not be multiples of anything: rows and columns past the edge load
// as zeros.
//
// Copies: 16 bytes (8 values) where both operands' base pointers are
// 16-byte aligned and Cin, Cout are multiples of 8; else 4 bytes where
// both are 4-byte aligned and Cin, Cout are even; else plain 2-byte loads
// and stores (a view at an odd element offset, or an odd channel count),
// which cp.async cannot copy.
//
// Next step: wgmma with TMA, whose transposed 16-bit shared-memory
// layouts take these M-major tiles directly.

#include <cuda_bf16.h>

#include "gemm_f32.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, BK = 32;
  static constexpr int WM = WM_, WN = WN_;    // warp tile
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = 32 * (BM / WM) * WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;  // mma tiles per warp
  // row pitches in bf16 values: 16-byte rows for cp.async and ldmatrix,
  // and a pitch of 4 words mod 32 so that the eight rows of an ldmatrix
  // matrix fall in distinct banks
  static constexpr int LDA = BM + 8, LDB = BN + 8;
  static constexpr int A_ELEMS = BK * LDA;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr int LDC = BN + 8;    // epilogue staging of C, floats
  static constexpr int SMEM_BYTES =
      2 * STAGES * STAGE_ELEMS > 4 * BM * LDC ? 2 * STAGES * STAGE_ELEMS
                                              : 4 * BM * LDC;
  static_assert(NI % 2 == 0, "B fragments load two n8 tiles at a time");
};

// The instances (paddle_tpu_torch/nn/gemm_bf16.py: TILES): 128 x 128 with
// 8 warps of 64 x 32, one block an SM (the partial and the full
// accumulator take 128 registers a thread); 64 x 64 with 4 warps of
// 32 x 32, four blocks an SM.
using Large = Cfg<128, 128, 64, 32, 4, 1>;
using Small = Cfg<64, 64, 32, 32, 4, 4>;

// Copies of the rows [m_begin + 32 kt, ...) of x (columns ci0..) and dy
// (columns co0..) into a stage, both as [k][channel]. VEC values a copy:
// 8 (cp.async of 16 bytes), 2 (4 bytes) or 1 (a plain load and store).
template <class C, int VEC>
struct Loader {
  const bf16* __restrict__ x;
  const bf16* __restrict__ dy;
  int Cin, Cout, ci0, co0;
  long long m_begin, m_end;

  template <int W, int PITCH>
  __device__ __forceinline__ void rows(bf16* dst, const bf16* __restrict__ src,
                                       int width, int c0, int kt) const {
    constexpr int PER_ROW = W / VEC;
    static_assert(C::BK * PER_ROW % C::NT == 0, "whole copies per thread");
#pragma unroll
    for (int q = 0; q < C::BK * PER_ROW / C::NT; ++q) {
      const int p = threadIdx.x + q * C::NT;
      const int r = p / PER_ROW, c = p % PER_ROW * VEC;
      const long long m = m_begin + (long long)kt * C::BK + r;
      const bool live = m < m_end && c0 + c < width;
      const bf16* from = live ? src + m * width + c0 + c : src;
      if constexpr (VEC == 1)
        dst[r * PITCH + c] = live ? *from : __float2bfloat16(0.f);
      else
        bf16mma::cp_async<2 * VEC>(dst + r * PITCH + c, from, live);
    }
  }

  __device__ __forceinline__ void load(bf16* stage, int kt) const {
    rows<C::BM, C::LDA>(stage, x, Cin, ci0, kt);
    rows<C::BN, C::LDB>(stage + C::A_ELEMS, dy, Cout, co0, kt);
  }
};

// Sets acc to this block's x^T . dy over k-tiles [0, ktiles), in the
// m16n8 accumulator layout of gemm_f32.cuh's mainloop (row wm + 16 i + g
// (+ 8 for e >= 2), column wn + 8 j + 2 t + (e & 1)). Leaves smem free.
template <class C, class L>
__device__ __forceinline__ void mainloop(const L& ld, int ktiles, bf16* smem,
                                         float (&acc)[C::MI][C::NI][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WARPS_N * C::WM, wn = warp % C::WARPS_N * C::WN;
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8; A's
  // four matrices are (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
  // (m 8-15, k 8-15) of a 16 x 16 tile, B's (k 0-7, n 0-7), (k 8-15,
  // n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15) of two n8 tiles
  const int q = lane / 8, r8 = lane % 8;
  const int a_k = r8 + 8 * (q / 2), a_m = wm + 8 * (q % 2);
  const int b_k = r8 + 8 * (q % 2), b_n = wn + 8 * (q / 2);
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < ktiles) ld.load(smem + s * C::STAGE_ELEMS, s);
    tf32x3::cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    tf32x3::cp_async_wait<C::STAGES - 2>();   // this thread's copies of kt
    __syncthreads();       // all copies of kt visible; kt - 1 fully read
    const bf16* sa = smem + (kt % C::STAGES) * C::STAGE_ELEMS;
    const bf16* sb = sa + C::A_ELEMS;
    const int next = kt + C::STAGES - 1;        // into the stage kt - 1 used
    if (next < ktiles) ld.load(smem + (next % C::STAGES) * C::STAGE_ELEMS,
                               next);
    tf32x3::cp_async_commit();
    float part[C::MI][C::NI][4];
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      unsigned b[C::NI][2];
#pragma unroll
      for (int j = 0; j < C::NI; j += 2) {
        unsigned r[4];
        bf16mma::ldmatrix_x4_trans(r, sb + (kk + b_k) * C::LDB + b_n + 8 * j);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < C::MI; ++i) {
        unsigned a[4];
        bf16mma::ldmatrix_x4_trans(a, sa + (kk + a_k) * C::LDA + a_m + 16 * i);
#pragma unroll
        for (int j = 0; j < C::NI; ++j)
          bf16mma::mma_bf16(part[i][j], a, b[j], kk == 0);
      }
    }
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  tf32x3::cp_async_wait<0>();
  __syncthreads();
}

template <class C, int VEC>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
dw_tiles_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dy,
              float* __restrict__ out, int M, int Cin, int Cout, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int s = blockIdx.z;
  Loader<C, VEC> ld{x, dy, Cin, Cout, (int)blockIdx.y * C::BM,
                    (int)blockIdx.x * C::BN, (long long)s * M / splits,
                    (long long)(s + 1) * M / splits};
  const int ktiles = (int)((ld.m_end - ld.m_begin + C::BK - 1) / C::BK);
  float acc[C::MI][C::NI][4];
  mainloop<C>(ld, ktiles, reinterpret_cast<bf16*>(smem_raw), acc);
  // 16-byte copies imply Cout % 8 == 0: whole float4 stores of the output
  gemm_f32::store<C, VEC == 8 ? 4 : 1>(
      acc, reinterpret_cast<float*>(smem_raw), out + (size_t)s * Cin * Cout,
      Cin, Cout, Cout, ld.ci0, ld.co0);
}

template <class C, int VEC>
cudaError_t launch_tiles(const bf16* x, const bf16* dy, float* tiles, int M,
                         int Cin, int Cout, int splits, cudaStream_t st) {
  const cudaError_t err = gemm_f32::allow_smem<C>(dw_tiles_bf16<C, VEC>);
  if (err != cudaSuccess) return err;
  const dim3 grid((Cout + C::BN - 1) / C::BN, (Cin + C::BM - 1) / C::BM,
                  splits);
  dw_tiles_bf16<C, VEC><<<grid, C::NT, C::SMEM_BYTES, st>>>(x, dy, tiles, M,
                                                            Cin, Cout, splits);
  return cudaGetLastError();
}

template <class C>
cudaError_t launch_vec(int vec, const bf16* x, const bf16* dy, float* tiles,
                       int M, int Cin, int Cout, int splits, cudaStream_t st) {
  if (vec == 8) return launch_tiles<C, 8>(x, dy, tiles, M, Cin, Cout, splits,
                                          st);
  if (vec == 2) return launch_tiles<C, 2>(x, dy, tiles, M, Cin, Cout, splits,
                                          st);
  return launch_tiles<C, 1>(x, dy, tiles, M, Cin, Cout, splits, st);
}

}  // namespace

// x: [M, Cin], dy: [M, Cout], both bf16 and contiguous; out: [Cin, Cout]
// float32; work: [splits, Cin, Cout] float32 when splits > 1 (unused
// otherwise). tile: 0 for 128 x 128 output tiles, 1 for 64 x 64; vec: 8
// for 16-byte copies (x, dy 16-byte aligned, Cin and Cout multiples of 8),
// 2 for 4-byte copies (4-byte aligned, even Cin and Cout), else 1. Split s
// covers rows [s * M / splits, (s + 1) * M / splits). Returns a
// cudaError_t. (The suffix names the result's type, as the other entries'
// do.)
extern "C" int conv1x1_dw_bf16_f32(const void* x, const void* dy, void* out,
                                   void* work, int M, int Cin, int Cout,
                                   int splits, int tile, int vec,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = Cin * Cout;
  if (M == 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * (size_t)n, st);
  if ((tile != 0 && tile != 1) || (vec != 1 && vec != 2 && vec != 8) ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* db = static_cast<const bf16*>(dy);
  float* tiles = static_cast<float*>(splits > 1 ? work : out);
  const cudaError_t err =
      tile == 0
          ? launch_vec<Large>(vec, xb, db, tiles, M, Cin, Cout, splits, st)
          : launch_vec<Small>(vec, xb, db, tiles, M, Cin, Cout, splits, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)gemm_f32::launch_split_reduce(tiles, static_cast<float*>(out),
                                            n, splits, st);
}
