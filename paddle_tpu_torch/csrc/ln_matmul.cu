// Fused LayerNorm and matrix product, out = LayerNorm(x) @ w, for sm_90a:
// float32 operands in split TF32, and bfloat16 operands on bf16 mma.sync
// (ln_matmul_bf16, after the f32 kernel).
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
// has room for.
//
// bf16 operands (ln_matmul_bf16): _ln_matmul_kernel on bf16 x and w takes
// the same f32 statistics, rounds the normalised y to x's dtype before the
// product (fused_ln.py:75) and writes the output in x's dtype. Here the
// statistics pass reads bf16 rows. 16-byte aligned operands (K and N
// multiples of 8, K up to 1280) take the wgmma route described at the end
// of the file; the views TMA cannot load take mma.sync: the A stage is a
// [BM][64]
// tile of raw bf16 x rows, which each thread normalises in f32 where it
// copied them, two values a 32-bit word, and rounds to bf16 (nearest
// even) in place before the stage's barrier; A comes by ldmatrix, w's
// [64][BN] tile by ldmatrix.trans, and each 64-deep k-tile's four
// mma.sync.m16n8k16 a fragment start a fresh partial added by FADD. The
// f32 accumulator goes to bf16 at the store. The wrapper passes scale and
// bias as f32 (widened if bf16).

#include "gemm_f32.cuh"
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace gemm_f32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int STATS_WARPS = 8;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }

// stats[m] = mean of row m, stats[M + m] = 1 / sqrt(var + eps), from x's
// values widened to f32 (float or bf16).
template <class E>
__global__ void __launch_bounds__(32 * STATS_WARPS)
ln_stats(const E* __restrict__ x, float* __restrict__ stats, int M, int K,
         float eps) {
  const int m = blockIdx.x * STATS_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const E* row = x + (size_t)m * K;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += widen(row[k]);
  const float mean = warp_sum(s) / K;
  float q = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = widen(row[k]) - mean;
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

// ---------------------------------------------------------------------------
// bfloat16 operands (ln_matmul_bf16)
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int WM_, int WN_, int STAGES_, int MIN_BLOCKS_>
struct BCfg {
  static constexpr int BM = BM_, BN = BN_, BK = 64;
  static constexpr int WM = WM_, WN = WN_;    // warp tile
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NT = 32 * (BM / WM) * WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;  // mma tiles per warp
  // row pitches in bf16 values: 16-byte rows for cp.async and ldmatrix,
  // and 36 or 68 words a row (4 mod 32), so that the eight rows of an
  // ldmatrix matrix fall in distinct banks
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static constexpr int A_ELEMS = BM * LDA;         // x rows, [m][k]
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * LDB;
  static constexpr int LDC = BN + 8;    // epilogue staging of C, floats
  static constexpr int SMEM_BYTES =
      2 * STAGES * STAGE_ELEMS > 4 * BM * LDC ? 2 * STAGES * STAGE_ELEMS
                                              : 4 * BM * LDC;
  static_assert(NI % 2 == 0, "B fragments load two n8 tiles at a time");
};

// The instances, by the index the entry point takes (the f32 kernel's
// tiles, nn/gemm_f32.py: TILES): 128 x 128 with 8 warps of 64 x 32, one
// block an SM, 4 stages (140 KB); 64 x 64 with 4 warps of 32 x 32, three
// an SM, 3 stages (54 KB).
using BLarge = BCfg<128, 128, 64, 32, 4, 1>;
using BSmall = BCfg<64, 64, 32, 32, 3, 3>;

// Copies rows m0.. of x (columns 32 kt..) as As[m][k] and rows 32 kt.. of
// w (columns n0..) as Bs[k][n], VEC bf16 values a copy: 2 (4-byte
// cp.async) or 1 (a plain load and store; 16-byte aligned operands take
// the wgmma route below); fixup
// normalises this thread's x pieces in f32 and rounds them to bf16.
template <class C, int VEC>
struct LnLoaderB {
  const bf16* __restrict__ x;
  const bf16* __restrict__ w;
  const float* __restrict__ scale;
  const float* __restrict__ bias;
  const float* mean;   // the block's rows, in shared memory
  const float* rstd;
  int M, K, N, m0, n0;

  static constexpr int A_ROW = C::BK / VEC, B_ROW = C::BN / VEC;
  static_assert(C::BM * A_ROW % C::NT == 0 && C::BK * B_ROW % C::NT == 0,
                "whole copies per thread");

  __device__ __forceinline__ void copy(bf16* dst, const bf16* src,
                                       bool live) const {
    if constexpr (VEC == 2)
      bf16mma::cp_async4(dst, live ? src : x, live);
    else
      *dst = live ? *src : __float2bfloat16(0.f);
  }

  __device__ __forceinline__ void load(bf16* stage, int kt) const {
    const auto a = [&](int q) {
      const int p = threadIdx.x + q * C::NT;
      const int r = p / A_ROW, c = p % A_ROW * VEC;
      const int m = m0 + r, k = kt * C::BK + c;
      copy(stage + r * C::LDA + c, x + (size_t)m * K + k, m < M && k < K);
    };
    const auto b = [&](int q) {
      const int p = threadIdx.x + q * C::NT;
      const int r = p / B_ROW, c = p % B_ROW * VEC;
      const int k = kt * C::BK + r, n = n0 + c;
      copy(stage + C::A_ELEMS + r * C::LDB + c, w + (size_t)k * N + n,
           k < K && n < N);
    };
    if constexpr (VEC == 1) {
      // plain loads, four in flight at a time (all at once would spill)
#pragma unroll 4
      for (int q = 0; q < C::BM * A_ROW / C::NT; ++q) a(q);
#pragma unroll 4
      for (int q = 0; q < C::BK * B_ROW / C::NT; ++q) b(q);
    } else {
#pragma unroll
      for (int q = 0; q < C::BM * A_ROW / C::NT; ++q) a(q);
#pragma unroll
      for (int q = 0; q < C::BK * B_ROW / C::NT; ++q) b(q);
    }
  }

  // The pieces of the A stage this thread copied in load(stage, kt): one
  // column range per thread (NT is a multiple of A_ROW), so scale and bias
  // load once; y = (x - mean) * rstd * scale + bias in f32, rounded to
  // bf16 to nearest even, zero past M and K; two values a 32-bit word
  // where a piece holds whole words.
  __device__ __forceinline__ void fixup(bf16* stage, int kt) const {
    static_assert(C::NT % A_ROW == 0, "one column per thread");
    const int c = threadIdx.x % A_ROW * VEC, k = kt * C::BK + c;
    float sc[VEC], bi[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      sc[e] = scale != nullptr && k + e < K ? scale[k + e] : 1.f;
      bi[e] = bias != nullptr && k + e < K ? bias[k + e] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < C::BM * A_ROW / C::NT; ++q) {
      const int r = (threadIdx.x + q * C::NT) / A_ROW;
      bf16* v = stage + r * C::LDA + c;
      const bool row = m0 + r < M;
      const float mu = mean[r], rs = rstd[r];
      const auto y = [&](float val, int e) {
        float t = (val - mu) * rs;
        if (scale != nullptr) t *= sc[e];
        if (bias != nullptr) t += bi[e];
        return row && k + e < K ? t : 0.f;
      };
      if constexpr (VEC == 1) {
        v[0] = __float2bfloat16_rn(y(__bfloat162float(v[0]), 0));
      } else {
        // one 4-byte access, two values
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(v));
        *reinterpret_cast<unsigned*>(v) =
            bf16mma::pack_bf16x2(y(f.x, 0), y(f.y, 1));
      }
    }
  }
};

// Sets acc to this block's y . w over k-tiles [0, ktiles), in the m16n8
// accumulator layout of gemm_f32.cuh's mainloop. Leaves smem free.
template <class C, class L>
__device__ __forceinline__ void mainloop_bf16(const L& ld, int ktiles,
                                              bf16* smem,
                                              float (&acc)[C::MI][C::NI][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / C::WARPS_N * C::WM, wn = warp % C::WARPS_N * C::WN;
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8; A's
  // four matrices (no .trans) are (m 0-7, k 0-7), (m 8-15, k 0-7),
  // (m 0-7, k 8-15), (m 8-15, k 8-15); B's (.trans) (k 0-7, n 0-7),
  // (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const int q = lane / 8, r8 = lane % 8;
  const int a_m = r8 + 8 * (q % 2), a_k = 8 * (q / 2);
  const int b_k = r8 + 8 * (q % 2), b_n = 8 * (q / 2);
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < ktiles) ld.load(smem + s * C::STAGE_ELEMS, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<C::STAGES - 2>();          // this thread's copies of kt
    bf16* stage = smem + (kt % C::STAGES) * C::STAGE_ELEMS;
    ld.fixup(stage, kt);
    __syncthreads();       // all of kt normalised; kt - 1 fully read
    const bf16* sa = stage;
    const bf16* sb = sa + C::A_ELEMS;
    const int next = kt + C::STAGES - 1;     // into the stage kt - 1 used
    if (next < ktiles) ld.load(smem + (next % C::STAGES) * C::STAGE_ELEMS,
                               next);
    cp_async_commit();
    float part[C::MI][C::NI][4];
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      unsigned b[C::NI][2];
#pragma unroll
      for (int j = 0; j < C::NI; j += 2) {
        unsigned r[4];
        bf16mma::ldmatrix_x4_trans(
            r, sb + (kk + b_k) * C::LDB + wn + 8 * j + b_n);
        b[j][0] = r[0];
        b[j][1] = r[1];
        b[j + 1][0] = r[2];
        b[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < C::MI; ++i) {
        unsigned a[4];
        bf16mma::ldmatrix_x4(a, sa + (wm + 16 * i + a_m) * C::LDA + kk + a_k);
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
  cp_async_wait<0>();
  __syncthreads();
}

// Writes acc, rounded to bf16, to out [rows, cols] at (row0, col0) through
// smem, VEC values a store (8: cols % 8 == 0; 2: cols even; out 16-byte
// aligned).
template <class C, int VEC>
__device__ __forceinline__ void store_bf16(const float (&acc)[C::MI][C::NI][4],
                                           float* smem, bf16* __restrict__ out,
                                           int rows, int cols, int row0,
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
    bf16* dst = out + (size_t)row * cols + col;
    const float* src = &smem[r * C::LDC + c];
    if constexpr (VEC == 2) {
      *reinterpret_cast<unsigned*>(dst) = bf16mma::pack_bf16x2(src[0], src[1]);
    } else {
      *dst = __float2bfloat16_rn(*src);
    }
  }
}

template <class C, int VEC>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
ln_gemm_bf16(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const float* __restrict__ scale, const float* __restrict__ bias,
             const float* __restrict__ stats, bf16* __restrict__ out, int M,
             int K, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float row_stats[2][C::BM];
  const int m0 = blockIdx.y * C::BM;
  for (int r = threadIdx.x; r < C::BM; r += C::NT) {
    const bool row = m0 + r < M;
    row_stats[0][r] = row ? stats[m0 + r] : 0.f;
    row_stats[1][r] = row ? stats[M + m0 + r] : 0.f;
  }
  __syncthreads();
  const LnLoaderB<C, VEC> ld{x, w, scale, bias, row_stats[0], row_stats[1],
                             M, K, N, m0, (int)blockIdx.x * C::BN};
  float acc[C::MI][C::NI][4];
  mainloop_bf16<C>(ld, (K + C::BK - 1) / C::BK,
                   reinterpret_cast<bf16*>(smem_raw), acc);
  store_bf16<C, VEC>(acc, reinterpret_cast<float*>(smem_raw), out, M, N,
                     ld.m0, ld.n0);
}

template <class C, int VEC>
cudaError_t launch_gemm_bf16(const bf16* x, const bf16* w, const float* scale,
                             const float* bias, const float* stats, bf16* out,
                             int M, int K, int N, cudaStream_t st) {
  const cudaError_t err = allow_smem<C>(ln_gemm_bf16<C, VEC>);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  ln_gemm_bf16<C, VEC><<<grid, C::NT, C::SMEM_BYTES, st>>>(
      x, w, scale, bias, stats, out, M, K, N);
  return cudaGetLastError();
}

template <class C>
cudaError_t by_vec_bf16(int vec, const bf16* x, const bf16* w,
                        const float* scale, const float* bias,
                        const float* stats, bf16* out, int M, int K, int N,
                        cudaStream_t st) {
  if (vec == 2)
    return launch_gemm_bf16<C, 2>(x, w, scale, bias, stats, out, M, K, N, st);
  return launch_gemm_bf16<C, 1>(x, w, scale, bias, stats, out, M, K, N, st);
}


// -- the wgmma route (16-byte aligned x and w) -------------------------------
//
// What held the mma.sync kernel above back on the H100: every 128 x 128
// output block normalised its own [128, 64] x tiles (with N = 2048, each x
// value 16 times) beside 64 mma.sync a warp, fed by ldmatrix, at about a
// sixth of the wgmma rate (114 TFLOP/s against 989). Here:
//   - A block owns a strip of BM rows of x, all of K. Its producer
//     warpgroup's first thread loads the strip raw by TMA (one box of 64
//     K values, 128 bytes, by BM rows per 64 of K: K-major slabs with the
//     128-byte swizzle, rows past M and columns past K zero) and walks w
//     through a ring of STAGES stages of [64 k, BN n] tiles by TMA (w is
//     [K, N] with N contiguous: MN-major slabs, as conv1x1_dw_bf16's
//     operands).
//   - The consumer warpgroups take each row's statistics from the strip
//     (two threads a row: the f32 mean, then the mean of squared
//     deviations from it, as ln_stats computes them for the mma.sync
//     route; a separate launch over x cost a tenth of the call) and
//     normalise the strip once, in place: the chunk at position p of row
//     r holds columns 8 (p ^ (r % 8)) onward of its slab, (x - mean) *
//     rstd * scale + bias in f32 (scale and bias read as f32 or bf16),
//     rounded to bf16 nearest even, zero past M and K. Each writer fences
//     its stores to the async proxy, and a barrier among the consumers
//     orders them before the first wgmma.
//   - Then every N tile the block owns: per 64-deep k-block a chain of
//     four m64nBNk16 wgmma (y K-major, w MN-major) into a fresh partial,
//     added by FADD (the tensor cores truncate a long chain), k-blocks
//     two at a time so that the second one's chain is queued while the
//     first one's is added; stored as bf16 pairs straight from the
//     accumulators, while the producer already loads the next tile's
//     stages.
// Each x value is read and normalised once per block that reads it, and
// w passes through shared memory once per strip.

template <int BM_, int STAGES_>
struct LnW {
  static constexpr int BM = BM_, BN = 128, BK = 64, STAGES = STAGES_;
  static constexpr int WG = BM / 64, CONSUMERS = 128 * WG;
  static constexpr int NT = CONSUMERS + 128;       // and the producer
  static constexpr int X_SLAB = BM * 128;          // bytes: a k-block
  static constexpr int W_SLAB = BK * 128;          // 64 columns of w
  static constexpr int W_STAGE = BN / 64 * W_SLAB;
  // the strip of KB k-blocks and the stages from a 1024-byte boundary,
  // then 2 STAGES + 1 barriers
  static constexpr int FIXED = 1024 + STAGES * W_STAGE + 8 * (2 * STAGES + 1);
  // beside 8 BM bytes of static shared memory (the rows' statistics)
  static constexpr int KB_MAX = (232448 - 8 * BM - FIXED) / X_SLAB;
  static constexpr int smem_bytes(int kb) { return FIXED + kb * X_SLAB; }
  static_assert(BM % 64 == 0 && KB_MAX >= 1, "whole warpgroups, a k-block");
};

// The instances (nn/fused_ln.py: WGMMA_LN, by index): a strip of 128 rows
// (two consumer warpgroups) for K up to 10 k-blocks (640), of 64 rows (one)
// for K up to 20 (1280). Four w stages of 16 KB (three were slower at w
// [512, 2048]: tools/bf16_compare.py ln_stages3).
using LnLarge = LnW<128, 4>;
using LnSmall = LnW<64, 4>;

// scale or bias entry k: f32, or bf16 widened
__device__ __forceinline__ float affine_at(const void* a, int k, bool bf) {
  return bf ? __bfloat162float(__ldg(static_cast<const bf16*>(a) + k))
            : __ldg(static_cast<const float*>(a) + k);
}

template <class C>
__global__ void __launch_bounds__(C::NT, 1)
ln_gemm_wgmma(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap,
              const void* __restrict__ scale, const void* __restrict__ bias,
              int affine_bf16, bf16* __restrict__ out, int M, int K, int N,
              float eps, int splits) {
  __shared__ float row_mean[C::BM], row_rstd[C::BM];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* strip =
      smem_raw + (1024 - wgmma::smem_addr(smem_raw) % 1024) % 1024;
  const int KB = (K + C::BK - 1) / C::BK;
  unsigned char* ring = strip + KB * C::X_SLAB;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::W_STAGE);
  uint64_t* empty = full + C::STAGES;
  uint64_t* xbar = empty + C::STAGES;
  const int m0 = blockIdx.y * C::BM;
  // this block's N tiles: an equal share of them
  const int tiles = (N + C::BN - 1) / C::BN;
  const int nt0 = (int)((long long)tiles * blockIdx.x / splits);
  const int nt1 = (int)((long long)tiles * (blockIdx.x + 1) / splits);
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      wgmma::mbar_init(&full[i], 1);
      wgmma::mbar_init(&empty[i], C::CONSUMERS / 32);
    }
    wgmma::mbar_init(xbar, 1);
    wgmma::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= C::CONSUMERS) {
    wgmma::setmaxnreg_dec<40>();
    if (threadIdx.x == C::CONSUMERS) {
      wgmma::mbar_expect_tx(xbar, KB * C::X_SLAB);
      for (int kb = 0; kb < KB; ++kb)
        wgmma::tma_load_2d(strip + kb * C::X_SLAB, &xmap, xbar, 64 * kb, m0);
      int it = 0;
      for (int nt = nt0; nt < nt1; ++nt)
        for (int kb = 0; kb < KB; ++kb, ++it) {
          const int st = it % C::STAGES;
          if (it >= C::STAGES)
            wgmma::mbar_wait(&empty[st], (it / C::STAGES - 1) & 1);
          unsigned char* s = ring + st * C::W_STAGE;
          wgmma::mbar_expect_tx(&full[st], C::W_STAGE);
#pragma unroll
          for (int j = 0; j < C::BN / 64; ++j)
            wgmma::tma_load_2d(s + j * C::W_SLAB, &wmap, &full[st],
                               nt * C::BN + 64 * j, 64 * kb);
        }
    }
  } else {
    wgmma::setmaxnreg_inc<232>();
    const int ct = threadIdx.x, wg = ct / 128, lane = ct % 32;
    wgmma::mbar_wait(xbar, 0);
    // each row's statistics from the strip itself, as ln_stats takes them
    // (the f32 mean, then the mean of squared deviations from it, and
    // 1 / sqrt(var + eps)): two threads a row over alternate 16-byte
    // chunks, combined by a shuffle (K % 8 == 0: a chunk lies wholly
    // inside K or wholly past it)
    {
      static_assert(C::CONSUMERS == 2 * C::BM, "two threads a row");
      const int r = ct / 2;
      const auto chunk = [&](int kb, int c, float (&f)[8]) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            strip + kb * C::X_SLAB + 128 * r + 16 * (c ^ (r % 8)));
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          f[2 * e] = v.x, f[2 * e + 1] = v.y;
        }
      };
      float sum = 0.f;
      for (int kb = 0; kb < KB; ++kb)
        for (int c = ct % 2; c < 8; c += 2) {
          float f[8];
          chunk(kb, c, f);        // columns past K landed as zeros
#pragma unroll
          for (int e = 0; e < 8; ++e) sum += f[e];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float mean = sum / K;
      float sq = 0.f;
      for (int kb = 0; kb < KB; ++kb)
        for (int c = ct % 2; c < 8; c += 2) {
          if (64 * kb + 8 * c >= K) continue;
          float f[8];
          chunk(kb, c, f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = f[e] - mean;
            sq = fmaf(d, d, sq);
          }
        }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      if (ct % 2 == 0) {
        row_mean[r] = mean;
        row_rstd[r] = 1.f / sqrtf(sq / K + eps);
      }
    }
    wgmma::bar_sync<1, C::CONSUMERS>();
    // normalise the strip: thread ct takes column chunk c = ct % 8 of each
    // k-block, rows ct / 8 + CONSUMERS / 8 * q
    const int c = ct % 8;
    const bool bf = affine_bf16 != 0;
    for (int kb = 0; kb < KB; ++kb) {
      const int k = 64 * kb + 8 * c;
      float sc[8], bi[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sc[e] = scale != nullptr && k + e < K ? affine_at(scale, k + e, bf)
                                              : 1.f;
        bi[e] = bias != nullptr && k + e < K ? affine_at(bias, k + e, bf)
                                             : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 8 * C::BM / C::CONSUMERS; ++q) {
        const int r = ct / 8 + C::CONSUMERS / 8 * q, m = m0 + r;
        uint4* v = reinterpret_cast<uint4*>(strip + kb * C::X_SLAB + 128 * r +
                                            16 * (c ^ (r % 8)));
        uint4 u = *v;
        unsigned w[4] = {u.x, u.y, u.z, u.w};
        const float mu = row_mean[r], rs = row_rstd[r];
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[e / 2]));
          float y0 = (f.x - mu) * rs, y1 = (f.y - mu) * rs;
          if (scale != nullptr) y0 *= sc[e], y1 *= sc[e + 1];
          if (bias != nullptr) y0 += bi[e], y1 += bi[e + 1];
          w[e / 2] = bf16mma::pack_bf16x2(m < M && k + e < K ? y0 : 0.f,
                                          m < M && k + e + 1 < K ? y1 : 0.f);
        }
        *v = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    wgmma::fence_proxy_async();
    wgmma::bar_sync<1, C::CONSUMERS>();
    const uint32_t ya = wgmma::smem_addr(strip) + wg * 64 * 128;
    const int row = m0 + 64 * wg + 16 * (ct % 128 / 32) + lane / 4;
    // k-block kb of the block's it-th: its stage, then its chain of four
    // m64nBNk16 (y K-major, w MN-major: 2048 bytes a k16 step) into a
    // fresh partial, one wgmma group
    const auto issue = [&](float (&part)[C::BN / 2], int kb, int it) {
      const int st = it % C::STAGES;
      wgmma::mbar_wait(&full[st], (it / C::STAGES) & 1);
      const uint32_t wa = wgmma::smem_addr(ring + st * C::W_STAGE);
      const uint32_t xa = ya + kb * C::X_SLAB;
      wgmma::fence_operand(part);    // before wgmma.fence (C7514)
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma::mma_ss<C::BN, 0, 1>(
            part, wgmma::desc_k128(xa + 32 * kk),
            wgmma::desc_sw128(wa + 2048 * kk, C::W_SLAB, 1024), kk > 0);
      wgmma::commit();
    };
    const auto add = [&](float (&acc)[C::BN / 2], float (&part)[C::BN / 2],
                         int it) {
      wgmma::fence_operand(part);
      wgmma::mbar_arrive_if(&empty[it % C::STAGES], lane == 0);
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) acc[i] += part[i];
    };
    int it = 0;
    for (int nt = nt0; nt < nt1; ++nt) {
      float acc[C::BN / 2];
#pragma unroll
      for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0.f;
      // k-blocks two at a time: the second one's chain is issued before
      // the first one's partial is added, so the tensor cores have work
      // queued; no group stays in flight from one pair to the next (an
      // accumulator in flight across a loop's back edge made ptxas
      // serialise every wgmma)
      for (int kb = 0; kb < KB; kb += 2) {
        float p0[C::BN / 2], p1[C::BN / 2];
        const bool two = kb + 1 < KB;
        issue(p0, kb, it);
        if (two) {
          issue(p1, kb + 1, it + 1);
          wgmma::wait<1>();
        } else {
          wgmma::wait<0>();
        }
        add(acc, p0, it++);
        if (two) {
          wgmma::wait<0>();
          add(acc, p1, it++);
        }
      }
      const int col0 = nt * C::BN + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row + 8 * h >= M) continue;
        bf16* dst = out + (size_t)(row + 8 * h) * N;
#pragma unroll
        for (int j = 0; j < C::BN / 8; ++j)
          if (col0 + 8 * j < N)
            *reinterpret_cast<unsigned*>(dst + col0 + 8 * j) =
                bf16mma::pack_bf16x2(acc[4 * j + 2 * h],
                                     acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <class C>
cudaError_t launch_wgmma(const bf16* x, const bf16* w, const void* scale,
                         const void* bias, int affine_bf16, bf16* out, int M,
                         int K, int N, float eps, int splits,
                         cudaStream_t st) {
  const int kb = (K + C::BK - 1) / C::BK;
  if (kb > C::KB_MAX || splits < 1) return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  cudaError_t err = wgmma::rows_map(&xmap, x, M, K, C::BM);
  if (err == cudaSuccess) err = wgmma::rows_map(&wmap, w, K, N, C::BK);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ln_gemm_wgmma<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::smem_bytes(kb));
  if (err != cudaSuccess) return err;
  const dim3 grid(splits, (M + C::BM - 1) / C::BM);
  ln_gemm_wgmma<C><<<grid, C::NT, C::smem_bytes(kb), st>>>(
      xmap, wmap, scale, bias, affine_bf16, out, M, K, N, eps, splits);
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
  ln_stats<float><<<(M + STATS_WARPS - 1) / STATS_WARPS, 32 * STATS_WARPS,
                    0, st>>>(xf, sf, M, K, eps);
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

// x: [M, K], w: [K, N], out: [M, N], all bfloat16; scale and bias: [K]
// or null, float32, or bfloat16 where affine_bf16 (the wgmma route only);
// stats: a [2, M] float32 workspace (the mma.sync route's; the wgmma route
// takes each row's statistics from its strip); all contiguous. vec picks
// the route: 8 for wgmma (x and w 16-byte aligned, K and N multiples of
// 8), tile 0 (LnLarge, K up to 640) or 1 (LnSmall, K up to 1280), N split
// into as many shares as fill one wave of the card's SMs with ceil(M /
// BM) strips; 2 (4-byte copies: 4-byte aligned, K and N even) or 1 (plain
// loads) for mma.sync, tile 0 for 128 x 128 output tiles, 1 for 64 x 64.
// Returns a cudaError_t.
extern "C" int ln_matmul_bf16_f32(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, void* stats, int M, int K, int N,
                                  float eps, int tile, int vec, void* stream,
                                  int affine_bf16) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if ((tile != 0 && tile != 1) || (vec != 1 && vec != 2 && vec != 8) ||
      (affine_bf16 && vec != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  if (vec == 8) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    // nn/fused_ln.py: ln_bf16_plan's splits
    const int bm = tile == 0 ? LnLarge::BM : LnSmall::BM;
    const int strips = (M + bm - 1) / bm, tiles = (N + 127) / 128;
    const int fill = sms / strips;
    const int splits = fill < 1 ? 1 : fill < tiles ? fill : tiles;
    return (int)(tile == 0
                     ? launch_wgmma<LnLarge>(xb, wb, scale, bias, affine_bf16,
                                             ob, M, K, N, eps, splits, st)
                     : launch_wgmma<LnSmall>(xb, wb, scale, bias, affine_bf16,
                                             ob, M, K, N, eps, splits, st));
  }
  float* sf = static_cast<float*>(stats);
  ln_stats<bf16><<<(M + STATS_WARPS - 1) / STATS_WARPS, 32 * STATS_WARPS,
                   0, st>>>(xb, sf, M, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  return (int)(tile == 0
                   ? by_vec_bf16<BLarge>(vec, xb, wb, sc, bi, sf, ob, M, K,
                                         N, st)
                   : by_vec_bf16<BSmall>(vec, xb, wb, sc, bi, sf, ob, M, K,
                                         N, st));
}

// Dynamic shared memory of wgmma instance tile for K, or -1 past its K.
extern "C" int ln_matmul_wgmma_smem_bytes(int K, int tile) {
  const int kb = (K + 63) / 64;
  if (tile == 0) return kb <= LnLarge::KB_MAX ? LnLarge::smem_bytes(kb) : -1;
  if (tile == 1) return kb <= LnSmall::KB_MAX ? LnSmall::smem_bytes(kb) : -1;
  return -1;
}
