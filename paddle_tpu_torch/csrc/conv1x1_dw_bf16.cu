// Weight gradient of a 1x1 convolution on bf16 operands, dW = x^T . dy
// summed in f32, for sm_90a.
//
// Replaces paddle_tpu/nn/pallas_conv.py:_dw_kernel as the bfloat16_compute
// policy runs it: ResNet's activations and weights are bf16 there, so
// dw_pallas receives bf16 x [M, Cin] and dy [M, Cout] (row-major, M = batch
// * height * width) and returns dW [Cin, Cout] in f32 (which the caller
// then rounds to the weight's bf16).
//
// What bounds it on the H100: bytes. Over the 36 calls of a ResNet-50 step
// at batch 128 the operands are 4.27 GB, 1.305 ms at 3.35 TB/s; the
// 2 * M * Cin * Cout operations take 0.55 ms at the data sheet's 989
// TFLOP/s of bf16, which only wgmma reaches.
//
// Design: two routes, picked by the wrapper's plan from the operands'
// shapes and pointers (paddle_tpu_torch/nn/gemm_bf16.py), both counted as
// conv1x1_dw_bf16 launches.
//
// wgmma (x and dy 16-byte aligned, Cin and Cout multiples of 8: every
// call of a ResNet-50 step). Block (j, i, s) owns the output tile (i, j)
// over the 64-row k-blocks of split s. One producer warp streams each
// k-block's rows of x and dy into a ring of shared-memory stages by TMA
// (a tensor map per operand, encoded on the host per call), completing
// on an mbarrier per stage; the stages land 128-byte-swizzled with the
// contraction dimension M outermost, which wgmma reads as transposed
// ("MN-major") bf16 operands, so x^T costs nothing (wgmma_bf16.cuh).
// Consumer warpgroups of 64 output rows run m64nNk16 on them: TMA takes
// the copies and their address arithmetic off the warps, and one wgmma
// does the work of 64 mma.sync and their ldmatrix, so the warps' issue
// slots no longer bound the kernel as they bound the mma.sync route (a
// third of the bound on the H100).
//
// Precision: each k-block of 64 rows starts its chain of four wgmma from
// zero (scale-d 0) in a partial accumulator, and after wgmma.wait_group
// the partial is added into a second f32 accumulator by FADD. The tensor
// cores truncate as they add into an accumulator (see gemm_f32.cuh), so a
// chain over a whole split of M would drift; chains of 64 products keep
// the error near 1e-6 of max |dW| at M = 401,408 on the H100.
//
// mma.sync (the views TMA cannot load: base pointers at a 2- or 4-byte
// offset, odd channel counts). Block (j, i, s) walks rows
// [s * M / splits, (s + 1) * M / splits) in 32-row k-tiles staged by
// 4-byte cp.async or plain 2-byte loads, ldmatrix.trans forms the x^T and
// dy fragments of mma.sync.m16n8k16 (mma_bf16.cuh), each k-tile into a
// fresh partial added by FADD.
//
// Both routes: with more than one split the partial tiles go to a
// workspace [splits, Cin, Cout] and split_reduce (gemm_f32.cuh; four
// outputs a thread where Cin * Cout allows) sums them in a fixed order: no
// atomics, so two runs are bit-equal. M, Cin and Cout need not be
// multiples of anything: rows and columns past the edge load as zeros.

#include <cuda_bf16.h>

#include "gemm_f32.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

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

// The mma.sync instances (paddle_tpu_torch/nn/gemm_bf16.py: MMA_TILES):
// 128 x 128 with 8 warps of 64 x 32, one block an SM (the partial and the
// full accumulator take 128 registers a thread); 64 x 64 with 4 warps of
// 32 x 32, three blocks an SM (at four, 128 registers a thread, the
// plain-load instance spilled 236 bytes).
using Large = Cfg<128, 128, 64, 32, 4, 1>;
using Small = Cfg<64, 64, 32, 32, 4, 3>;

// Copies of the rows [m_begin + 32 kt, ...) of x (columns ci0..) and dy
// (columns co0..) into a stage, both as [k][channel]. VEC values a copy:
// 2 (cp.async of 4 bytes) or 1 (a plain load and store).
template <class C, int VEC>
struct Loader {
  const bf16* __restrict__ x;
  const bf16* __restrict__ dy;
  int Cin, Cout, ci0, co0;
  long long m_begin, m_end;

  template <int W, int PITCH>
  __device__ __forceinline__ void rows(bf16* dst, const bf16* __restrict__ src,
                                       int width, int c0, int kt) const {
    constexpr int PER_ROW = W / VEC, N = C::BK * PER_ROW / C::NT;
    static_assert(C::BK * PER_ROW % C::NT == 0, "whole copies per thread");
    auto copy = [&](int q) {
      const int p = threadIdx.x + q * C::NT;
      const int r = p / PER_ROW, c = p % PER_ROW * VEC;
      const long long m = m_begin + (long long)kt * C::BK + r;
      const bool live = m < m_end && c0 + c < width;
      const bf16* from = live ? src + m * width + c0 + c : src;
      if constexpr (VEC == 1)
        dst[r * PITCH + c] = live ? *from : __float2bfloat16(0.f);
      else
        bf16mma::cp_async4(dst + r * PITCH + c, from, live);
    };
    if constexpr (VEC == 1) {
      // four plain loads in flight at a time: all of them at once spilled
      // the small instance's registers
#pragma unroll 4
      for (int q = 0; q < N; ++q) copy(q);
    } else {
#pragma unroll
      for (int q = 0; q < N; ++q) copy(q);
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
  gemm_f32::store<C, 1>(
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
  if (vec == 2) return launch_tiles<C, 2>(x, dy, tiles, M, Cin, Cout, splits,
                                          st);
  return launch_tiles<C, 1>(x, dy, tiles, M, Cin, Cout, splits, st);
}


// -- the wgmma route -----------------------------------------------------

// An output tile of BM x BN over k-blocks of BK = 64 rows of M. Each of the
// BM / 64 consumer warpgroups owns 64 rows of the tile (m64nBNk16); one more
// warp produces: one of its threads issues the TMA copies of each k-block
// into a ring of STAGES stages, each with a "full" mbarrier (the copies'
// bytes landed) and an "empty" one (every consumer warp is done with it).
// A stage holds the k-block's rows of x (BM channels) and dy (BN channels)
// as 128-byte-swizzled slabs of 64 channels (wgmma_bf16.cuh): A's slabs
// first, then B's.
template <int BM_, int BN_, int STAGES_, int MIN_BLOCKS_>
struct WgCfg {
  static constexpr int BM = BM_, BN = BN_, BK = 64;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int CONSUMERS = 128 * (BM / 64);
  static constexpr int NT = CONSUMERS + 32;     // and the producer warp
  static constexpr int SLAB = BK * 128;         // bytes: 64 channels x BK
  static constexpr int A_BYTES = BM / 64 * SLAB, B_BYTES = BN / 64 * SLAB;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // the stages from a 1024-byte boundary (the swizzle's period), then the
  // 2 x STAGES barriers
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES;
  static_assert(BM % 64 == 0 && BN % 64 == 0, "whole slabs");
};

// The wgmma instances (paddle_tpu_torch/nn/gemm_bf16.py: WGMMA_TILES):
// 128 x 128 with two consumer warpgroups, one block an SM (128 KB of
// stages); 64 x 64 with one, three blocks an SM (64 KB each), for the
// 64-channel outputs.
using WgLarge = WgCfg<128, 128, 4, 1>;
using WgSmall = WgCfg<64, 64, 4, 3>;

// The k-blocks [kb0, kb1) of split s: an equal share of ceil(M / BK).
__device__ __forceinline__ void split_kblocks(int M, int bk, int splits,
                                              int s, int& kb0, int& kb1) {
  const long long kbs = (M + (long long)bk - 1) / bk;
  kb0 = (int)(kbs * s / splits);
  kb1 = (int)(kbs * (s + 1) / splits);
}

// Sets part to this warpgroup's x^T . dy over the k-block staged at shared
// address stage: four m64nBNk16 steps, the first from zero, waited for.
template <class C>
__device__ __forceinline__ void wg_product(uint32_t stage, int wg,
                                           float (&part)[C::BN / 2]) {
  const uint64_t da = wgmma::desc_sw128(stage + wg * C::SLAB, C::SLAB, 1024);
  const uint64_t db = wgmma::desc_sw128(stage + C::A_BYTES, C::SLAB, 1024);
  wgmma::fence_operand(part);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)     // 2048 bytes a k16 step
    wgmma::mma<C::BN>(part, da + 128 * kk, db + 128 * kk, kk > 0);
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(part);
}

// Writes a warpgroup's accumulators to out[row][col] (rows < Cin, columns
// < Cout; Cout even, so float2 stores).
template <class C>
__device__ __forceinline__ void wg_store(const float (&acc)[C::BN / 2],
                                         float* __restrict__ out, int Cin,
                                         int Cout, int row0, int co0) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int row = row0 + 16 * (t / 32) + lane / 4;
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j) {
    const int col = co0 + 8 * j + 2 * (lane % 4);
    if (col >= Cout) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < Cin)
        *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * Cout + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
dw_wgmma(const __grid_constant__ CUtensorMap xmap,
         const __grid_constant__ CUtensorMap dymap, float* __restrict__ out,
         int M, int Cin, int Cout, int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* stages =
      smem_raw + (1024 - wgmma::smem_addr(smem_raw) % 1024) % 1024;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + C::STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + C::STAGES;
  const int ci0 = blockIdx.y * C::BM, co0 = blockIdx.x * C::BN;
  int kb0, kb1;
  split_kblocks(M, C::BK, splits, blockIdx.z, kb0, kb1);
  const int n = kb1 - kb0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      wgmma::mbar_init(&full[i], 1);
      wgmma::mbar_init(&empty[i], C::CONSUMERS / 32);
    }
    wgmma::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= C::CONSUMERS) {    // the producer warp
    if (threadIdx.x == C::CONSUMERS)
      for (int k = 0; k < n; ++k) {
        const int st = k % C::STAGES, m0 = (kb0 + k) * C::BK;
        if (k >= C::STAGES)             // its previous k-block consumed
          wgmma::mbar_wait(&empty[st], (k / C::STAGES - 1) & 1);
        unsigned char* a = stages + st * C::STAGE_BYTES;
        wgmma::mbar_expect_tx(&full[st], C::STAGE_BYTES);
#pragma unroll
        for (int j = 0; j < C::BM / 64; ++j)
          wgmma::tma_load_2d(a + j * C::SLAB, &xmap, &full[st],
                             ci0 + 64 * j, m0);
#pragma unroll
        for (int j = 0; j < C::BN / 64; ++j)
          wgmma::tma_load_2d(a + C::A_BYTES + j * C::SLAB, &dymap, &full[st],
                             co0 + 64 * j, m0);
      }
    return;
  }
  const int wg = threadIdx.x / 128;
  float acc[C::BN / 2], part[C::BN / 2];
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0.f;
  for (int k = 0; k < n; ++k) {
    const int st = k % C::STAGES;
    wgmma::mbar_wait(&full[st], (k / C::STAGES) & 1);
    wg_product<C>(wgmma::smem_addr(stages + st * C::STAGE_BYTES), wg, part);
    if (threadIdx.x % 32 == 0) wgmma::mbar_arrive(&empty[st]);
    // the partial of at most 64 rows into the sum by FADD (the tensor
    // cores truncate a long chain, see gemm_f32.cuh)
#pragma unroll
    for (int i = 0; i < C::BN / 2; ++i) acc[i] += part[i];
  }
  wg_store<C>(acc, out + (size_t)blockIdx.z * Cin * Cout, Cin, Cout,
              ci0 + 64 * wg, co0);
}

template <class C>
cudaError_t launch_wgmma(const bf16* x, const bf16* dy, float* tiles, int M,
                         int Cin, int Cout, int splits, cudaStream_t st) {
  CUtensorMap xmap, dymap;
  cudaError_t err = wgmma::rows_map(&xmap, x, M, Cin, C::BK);
  if (err == cudaSuccess) err = wgmma::rows_map(&dymap, dy, M, Cout, C::BK);
  if (err == cudaSuccess) err = gemm_f32::allow_smem<C>(dw_wgmma<C>);
  if (err != cudaSuccess) return err;
  const dim3 grid((Cout + C::BN - 1) / C::BN, (Cin + C::BM - 1) / C::BM,
                  splits);
  dw_wgmma<C><<<grid, C::NT, C::SMEM_BYTES, st>>>(xmap, dymap, tiles, M, Cin,
                                                  Cout, splits);
  return cudaGetLastError();
}

}  // namespace

// x: [M, Cin], dy: [M, Cout], both bf16 and contiguous; out: [Cin, Cout]
// float32; work: [splits, Cin, Cout] float32 when splits > 1 (unused
// otherwise). vec picks the route: 8 for wgmma (x, dy 16-byte aligned, Cin
// and Cout multiples of 8), where split s covers the 64-row k-blocks
// [s * KB / splits, (s + 1) * KB / splits) of KB = ceil(M / 64); 2 (4-byte
// cp.async: 4-byte aligned, even Cin and Cout) or 1 (plain loads) for
// mma.sync, where split s covers rows [s * M / splits, (s + 1) * M /
// splits). tile: 0 for the route's 128 x 128 instance, 1 for its 64 x 64
// one. Returns a cudaError_t. (The suffix names the result's type, as the
// other entries' do.)
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
  cudaError_t err;
  if (vec == 8)
    err = tile == 0
              ? launch_wgmma<WgLarge>(xb, db, tiles, M, Cin, Cout, splits, st)
              : launch_wgmma<WgSmall>(xb, db, tiles, M, Cin, Cout, splits, st);
  else
    err = tile == 0
              ? launch_vec<Large>(vec, xb, db, tiles, M, Cin, Cout, splits, st)
              : launch_vec<Small>(vec, xb, db, tiles, M, Cin, Cout, splits,
                                  st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)gemm_f32::launch_split_reduce_vec(
      tiles, static_cast<float*>(out), n, splits, st);
}
