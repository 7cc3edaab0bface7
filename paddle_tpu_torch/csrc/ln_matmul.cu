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
// statistics pass reads bf16 rows; the product's A stage is a [BM][64]
// tile of raw bf16 x rows, which each thread normalises in f32 where it
// copied them, two values a 32-bit word, and rounds to bf16 (nearest
// even) in place before the stage's barrier; A comes by ldmatrix, w's
// [64][BN] tile by ldmatrix.trans, and each 64-deep k-tile's four
// mma.sync.m16n8k16 a fragment start a fresh partial added by FADD. The
// f32 accumulator goes to bf16 at the store. The wrapper passes scale and
// bias as f32 (widened if bf16).

#include "gemm_f32.cuh"
#include "mma_bf16.cuh"

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
// w (columns n0..) as Bs[k][n], VEC bf16 values a copy: 8 (16-byte
// cp.async), 2 (4-byte cp.async) or 1 (a plain load and store); fixup
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
    if constexpr (VEC == 8)
      bf16mma::cp_async16(dst, live ? src : x, live);
    else if constexpr (VEC == 2)
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
        unsigned w[VEC / 2];                   // one 16- or 4-byte access
        if constexpr (VEC == 8) {
          const uint4 u = *reinterpret_cast<const uint4*>(v);
          w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
        } else {
          w[0] = *reinterpret_cast<const unsigned*>(v);
        }
#pragma unroll
        for (int e = 0; e < VEC; e += 2) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[e / 2]));
          w[e / 2] = bf16mma::pack_bf16x2(y(f.x, e), y(f.y, e + 1));
        }
        if constexpr (VEC == 8)
          *reinterpret_cast<uint4*>(v) = make_uint4(w[0], w[1], w[2], w[3]);
        else
          *reinterpret_cast<unsigned*>(v) = w[0];
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
    if constexpr (VEC == 8) {
      uint4 v;
      v.x = bf16mma::pack_bf16x2(src[0], src[1]);
      v.y = bf16mma::pack_bf16x2(src[2], src[3]);
      v.z = bf16mma::pack_bf16x2(src[4], src[5]);
      v.w = bf16mma::pack_bf16x2(src[6], src[7]);
      *reinterpret_cast<uint4*>(dst) = v;
    } else if constexpr (VEC == 2) {
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
  if (vec == 8)
    return launch_gemm_bf16<C, 8>(x, w, scale, bias, stats, out, M, K, N, st);
  if (vec == 2)
    return launch_gemm_bf16<C, 2>(x, w, scale, bias, stats, out, M, K, N, st);
  return launch_gemm_bf16<C, 1>(x, w, scale, bias, stats, out, M, K, N, st);
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
// float32 or null; stats: a [2, M] float32 workspace; all contiguous.
// tile: 0 for 128 x 128 output tiles, 1 for 64 x 64; vec: 8 for 16-byte
// copies (x and w 16-byte aligned, K and N multiples of 8), 2 for 4-byte
// ones (4-byte aligned, K and N even), else 1. Returns a cudaError_t.
extern "C" int ln_matmul_bf16_f32(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* out, void* stats, int M, int K, int N,
                                  float eps, int tile, int vec,
                                  void* stream) {
  if (M == 0 || N == 0) return (int)cudaGetLastError();
  if ((tile != 0 && tile != 1) || (vec != 1 && vec != 2 && vec != 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  float* sf = static_cast<float*>(stats);
  ln_stats<bf16><<<(M + STATS_WARPS - 1) / STATS_WARPS, 32 * STATS_WARPS,
                   0, st>>>(xb, sf, M, K, eps);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bf16* wb = static_cast<const bf16*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  bf16* ob = static_cast<bf16*>(out);
  return (int)(tile == 0
                   ? by_vec_bf16<BLarge>(vec, xb, wb, sc, bi, sf, ob, M, K,
                                         N, st)
                   : by_vec_bf16<BSmall>(vec, xb, wb, sc, bi, sf, ob, M, K,
                                         N, st));
}
