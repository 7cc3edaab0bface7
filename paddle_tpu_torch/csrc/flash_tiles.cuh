// The tile machinery the flash-attention kernels share (flash_fwd.cu,
// flash_bwd.cu): a block owns C::ROWS resident rows and walks the other
// side's rows in streamed tiles of C::BS rows through a cp.async ring of
// C::STAGES stages, skipping whole tiles whose segment ids cannot meet its
// own (_block_needed / _seg_block_relevant).
//
// float32 operands: the resident rows are split once into TF32 hi and lo
// planes as they land; scores against a streamed tile run in split TF32
// (mma_tf32.cuh) in partials of 32 along D. A kernel's Cfg C names D,
// ROWS, NT (threads), BS, STAGES, STAGE (floats a stage), LD (row pitch in
// floats, D + 4: 16-byte rows for cp.async and fragment loads free of
// bank conflicts), NJ (score n-tiles of a streamed part), ND (accumulator
// n-tiles) and CHUNKS (score partials in flight).
//
// bfloat16 operands (the bf16 kernels' Cfg: LD is the pitch in bf16
// values, D + 8, so that the eight 16-byte rows of an ldmatrix fall in
// distinct banks): the streamed rows land raw by 16- or 4-byte cp.async
// (stage_rows over the element type), each warp's resident A fragments
// stay in registers (a_rows), and every product is one
// mma.sync.m16n8k16 bf16 with f32 accumulators (mma_bf16.cuh) in place of
// three TF32 ones: scores_bf16 in partials of 32 along D, accumulate_bf16
// with P (or dS) packed from the score accumulators, rounded to bf16 to
// nearest even, as the JAX kernels round p.astype(v.dtype), and one fresh
// partial a tile. Each partial is added to its f32 sum by FADD: the
// tensor cores truncate as they add (gemm_f32.cuh).

#pragma once

#include <climits>
#include <cmath>
#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace flash_tiles {

using namespace tf32x3;
using bf16 = __nv_bfloat16;

// Calls f with pieces of WIDE elements where a.vec says every operand
// allows 16-byte copies (4 floats, 8 bf16 values), else of NARROW (4-byte
// copies: 1 float, 2 bf16 values): one uniform branch, so both widths
// share the kernel's compute.
template <int WIDE = 4, int NARROW = 1, class A, class F>
__device__ __forceinline__ void by_width(const A& a, const F& f) {
  if (a.vec == WIDE)
    f(std::integral_constant<int, WIDE>());
  else
    f(std::integral_constant<int, NARROW>());
}

// BYTES (16 or 4) from gmem to smem by cp.async, zero-filled when !pred.
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(void* smem, const void* gmem,
                                               bool pred) {
  static_assert(BYTES == 16 || BYTES == 4, "16- or 4-byte copies");
  cp_async<BYTES / 4>(static_cast<float*>(smem),
                      static_cast<const float*>(gmem), pred);
}

// Rows [row0, row0 + ROWS) of a [T, D] matrix, split into TF32 hi and lo
// planes of pitch LD; rows past T are zero.
template <class C, int VEC>
__device__ __forceinline__ void load_split(unsigned* hi, unsigned* lo,
                                           const float* __restrict__ src,
                                           int row0, int T) {
  constexpr int PER_ROW = C::D / VEC;
  for (int i = threadIdx.x; i < C::ROWS * PER_ROW; i += C::NT) {
    const int r = i / PER_ROW, c = i % PER_ROW * VEC;
    const bool live = row0 + r < T;
    const float* p = src + (size_t)(row0 + r) * C::D + c;
    const int at = r * C::LD + c;
    if constexpr (VEC == 4) {
      const float4 x = live ? __ldg(reinterpret_cast<const float4*>(p))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      uint4 h, l;
      split_tf32(x.x, h.x, l.x);
      split_tf32(x.y, h.y, l.y);
      split_tf32(x.z, h.z, l.z);
      split_tf32(x.w, h.w, l.w);
      *reinterpret_cast<uint4*>(hi + at) = h;
      *reinterpret_cast<uint4*>(lo + at) = l;
    } else {
      split_tf32(live ? __ldg(p) : 0.f, hi[at], lo[at]);
    }
  }
}

// Copies of rows [row0, row0 + BS) of a [T, D] matrix of E (float or
// bf16) into a stage matrix of pitch LD, VEC values a copy (16 or 4
// bytes); rows past T zero-filled.
template <class C, int VEC, class E>
__device__ __forceinline__ void stage_rows(E* dst, const E* __restrict__ src,
                                           int row0, int T) {
  constexpr int PER_ROW = C::D / VEC;
  for (int i = threadIdx.x; i < C::BS * PER_ROW; i += C::NT) {
    const int r = i / PER_ROW, c = i % PER_ROW * VEC;
    const bool live = row0 + r < T;
    cp_async_bytes<VEC * sizeof(E)>(
        dst + r * C::LD + c,
        live ? src + (size_t)(row0 + r) * C::D + c : src, live);
  }
}

// Copies of entries [row0, row0 + BS) of a [T] vector (4 bytes each);
// entries past T zero-filled.
template <class C>
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int T) {
  for (int i = threadIdx.x; i < C::BS; i += C::NT) {
    const bool live = row0 + i < T;
    cp_async<1>(dst + i, live ? src + row0 + i : src, live);
  }
}

// (min, max) segment id over rows [row0, row0 + n) below T, in every lane
// of the calling warp; (INT_MAX, INT_MIN) for no rows. Warp-uniform as
// ptxas sees it (no branch on a lane's own values; the result broadcast
// from lane 0): the wgmma forward looks for its next tile while a wgmma
// group is in flight, and a divergent path there makes ptxas serialise
// every wgmma.
__device__ __forceinline__ int2 seg_range(const int* __restrict__ seg,
                                          int row0, int n, int T) {
  int mn = INT_MAX, mx = INT_MIN;
  for (int r = threadIdx.x % 32; r < n; r += 32) {
    const bool live = row0 + r < T;
    const int s = __ldg(seg + min(row0 + r, T - 1));
    mn = live ? min(mn, s) : mn;
    mx = live ? max(mx, s) : mx;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  return make_int2(__shfl_sync(0xffffffffu, mn, 0),
                   __shfl_sync(0xffffffffu, mx, 0));
}

// Whether rows with ids in a and rows with ids in b can hold a visible
// pair (_seg_block_relevant).
__device__ __forceinline__ bool seg_meet(int2 a, int2 b) {
  return a.x <= b.y && a.y >= b.x && a.y > 0 && b.y > 0;
}

// The first streamed tile of BS rows in [t, end) whose segment ids meet
// the block's own range (t itself without segments); end if none.
template <int BS>
__device__ __forceinline__ int next_tile(const int* __restrict__ seg,
                                         int2 own, int t, int end, int T) {
  if (!seg) return t;
  for (; t < end; ++t)
    if (seg_meet(own, seg_range(seg, t * BS, BS, T))) break;
  return t;
}

// acc[j] = the warp's 16 resident rows (wrow + g, + 8) against streamed
// rows 8 j + g of tile, over D: the resident side from its hi/lo planes,
// the streamed side split as it loads, in partials of 32 d. CHUNKS
// partials run at once, so a warp has CHUNKS * NJ independent mma chains;
// they are added in the order of d, as one at a time would be.
template <class C>
__device__ __forceinline__ void scores(float (&acc)[C::NJ][4],
                                       const unsigned* __restrict__ hi,
                                       const unsigned* __restrict__ lo,
                                       const float* __restrict__ tile,
                                       int wrow, int g, int t) {
  constexpr int CC = C::CHUNKS;
#pragma unroll
  for (int c0 = 0; c0 < C::D; c0 += 32 * CC) {
    float part[CC][C::NJ][4];
#pragma unroll
    for (int kk = 0; kk < 32; kk += 8) {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int k = c0 + 32 * cc + kk;
        unsigned ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // (g, t) (g+8, t) (g, t+4) (g+8, t+4)
          const int at = (wrow + g + 8 * (e & 1)) * C::LD + k + t + 4 * (e >> 1);
          ah[e] = hi[at];
          al[e] = lo[at];
        }
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          unsigned bh[2], bl[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            split_tf32(tile[(8 * j + g) * C::LD + k + t + 4 * h], bh[h],
                       bl[h]);
          mma3(part[cc][j], ah, al, bh, bl, kk == 0);
        }
      }
    }
#pragma unroll
    for (int cc = 0; cc < CC; ++cc)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = c0 + cc == 0 ? part[cc][j][e]
                                   : acc[j][e] + part[cc][j][e];
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x by ex2.approx.ftz: exp(y) as 2^(y * log2 e), the log2 e folded into
// the caller's FFMA; results below 2^-126 flush to 0 and -inf gives 0 (a
// masked pair)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x (a score accumulator) as the split A fragments of a product over its
// columns: k-step j takes columns 8 j .. 8 j + 7 with k = t standing for
// column 2 t and k = t + 4 for 2 t + 1, so a0..a3 are the accumulator's
// own c0, c2, c1, c3.
template <class C>
__device__ __forceinline__ void a_frags(const float (&x)[C::NJ][4],
                                        unsigned (&h)[C::NJ][4],
                                        unsigned (&l)[C::NJ][4]) {
#pragma unroll
  for (int j = 0; j < C::NJ; ++j) {
    split_tf32(x[j][0], h[j][0], l[j][0]);
    split_tf32(x[j][2], h[j][1], l[j][1]);
    split_tf32(x[j][1], h[j][2], l[j][2]);
    split_tf32(x[j][3], h[j][3], l[j][3]);
  }
}

// acc = acc * corr + A . tile over the tile's NJ * 8 rows, one fresh
// partial per 8 columns: A from a_frags, tile rows 8 j + 2 t + h in
// a_frags' k order, columns 8 n + g. corr (a row's rescale, by h) folds in
// by one FFMA; at corr = 1 that rounds once, as acc + partial does.
template <class C>
__device__ __forceinline__ void accumulate(float (&acc)[C::ND][4],
                                           const unsigned (&ah)[C::NJ][4],
                                           const unsigned (&al)[C::NJ][4],
                                           const float* __restrict__ tile,
                                           const float (&corr)[2], int g,
                                           int t) {
#pragma unroll
  for (int n = 0; n < C::ND; ++n) {
    float part[4];
#pragma unroll
    for (int j = 0; j < C::NJ; ++j) {
      unsigned bh[2], bl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        split_tf32(tile[(8 * j + 2 * t + h) * C::LD + 8 * n + g], bh[h],
                   bl[h]);
      mma3(part, ah[j], al[j], bh, bl, j == 0);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = fmaf(acc[n][e], corr[e >> 1], part[e]);
  }
}

// Writes the warp's rows row0 + g (+ 8) of acc, times mul[h], to out
// (rows below T).
template <class C>
__device__ __forceinline__ void store_rows(const float (&acc)[C::ND][4],
                                           float* __restrict__ out, int row0,
                                           int T, const float (&mul)[2],
                                           int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int n = 0; n < C::ND; ++n)
      *reinterpret_cast<float2*>(out + (size_t)row * C::D + 8 * n + 2 * t) =
          make_float2(acc[n][2 * h] * mul[h], acc[n][2 * h + 1] * mul[h]);
  }
}

// The streamed-tile loop: tiles from first to end in order, those
// next_tile keeps, through the cp.async ring; load(stage, i) issues this
// thread's copies of tile i, body(stage, i) computes on it. setup() (the
// resident planes) runs while the first copies are in flight, and only if
// there is a tile.
template <class C, class Setup, class Load, class Body>
__device__ __forceinline__ void stream(float* ring, const int* seg, int2 own,
                                       int first, int end, int T,
                                       const Setup& setup, const Load& load,
                                       const Body& body) {
  int pend[C::STAGES - 1];       // tiles in flight, oldest first
  int nt = next_tile<C::BS>(seg, own, first, end, T);
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    pend[s] = nt;
    if (nt < end) {
      load(ring + s * C::STAGE, nt);
      nt = next_tile<C::BS>(seg, own, nt + 1, end, T);
    }
    cp_async_commit();
  }
  if (pend[0] < end) setup();
  for (int slot = 0; pend[0] < end; slot = (slot + 1) % C::STAGES) {
    const int cur = pend[0];
    cp_async_wait<C::STAGES - 2>();    // this thread's copies of cur
    __syncthreads();  // everyone's copies and planes visible; last tile read
    if (nt < end) load(ring + (slot + C::STAGES - 1) % C::STAGES * C::STAGE,
                       nt);
    cp_async_commit();
#pragma unroll
    for (int s = 0; s + 1 < C::STAGES - 1; ++s) pend[s] = pend[s + 1];
    pend[C::STAGES - 2] = nt;
    if (nt < end) nt = next_tile<C::BS>(seg, own, nt + 1, end, T);
    body(ring + slot * C::STAGE, cur);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// bfloat16 operands
// ---------------------------------------------------------------------------

// The m16n8k16 A fragments of the warp's 16 rows row0 + g (+ 8) of a
// [T, D] bf16 matrix over all of D, straight from global memory in 4-byte
// loads (the wrappers require 4-byte aligned operands); rows past T are
// zero. af[kk] covers columns 16 kk .. 16 kk + 15: a0 (row g, columns
// 2t, 2t + 1), a1 (row g + 8), a2 and a3 the same 8 columns on.
template <int D>
__device__ __forceinline__ void a_rows(unsigned (&af)[D / 16][4],
                                       const bf16* __restrict__ src,
                                       int row0, int T, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    const unsigned* p =
        reinterpret_cast<const unsigned*>(src + (size_t)min(row, T - 1) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      af[kk][h] = row < T ? __ldg(p + 8 * kk + t) : 0u;
      af[kk][2 + h] = row < T ? __ldg(p + 8 * kk + 4 + t) : 0u;
    }
  }
}

// acc[j] = the warp's 16 resident rows (A fragments af) against rows
// 8 j + g of a bf16 stage matrix (pitch C::LD), over D, one mma a 16-wide
// k-step, in partials of 32 d each added by FADD in the order of d. B
// comes by ldmatrix without .trans (a row of the tile is a column of B):
// one x4 gives two n8 tiles' fragments, matrices (n 0-7, k 0-7),
// (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15).
template <class C>
__device__ __forceinline__ void scores_bf16(float (&acc)[C::NJ][4],
                                            const unsigned (&af)[C::D / 16][4],
                                            const bf16* __restrict__ tile) {
  static_assert(C::NJ % 2 == 0, "two n8 tiles a B load");
  const int lane = threadIdx.x % 32;
  const int n_off = lane % 8 + 8 * (lane / 16), k_off = 8 * (lane / 8 % 2);
#pragma unroll
  for (int c0 = 0; c0 < C::D / 16; c0 += 2) {
    float part[C::NJ][4];
#pragma unroll
    for (int kk = c0; kk < c0 + 2; ++kk)
#pragma unroll
      for (int j = 0; j < C::NJ; j += 2) {
        unsigned r[4];
        bf16mma::ldmatrix_x4(r, tile + (8 * j + n_off) * C::LD + 16 * kk
                                    + k_off);
        const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
        bf16mma::mma_bf16(part[j], af[kk], b0, kk == c0);
        bf16mma::mma_bf16(part[j + 1], af[kk], b1, kk == c0);
      }
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = c0 == 0 ? part[j][e] : acc[j][e] + part[j][e];
  }
}

// acc[n] += A . tile[:, col0 + 8 n ..] over the tile's NJ * 8 rows, for N
// n-tiles: A the packed bf16 fragments of a 16 x (NJ * 8) operand (a[kc]
// its columns 16 kc ..), the tile's rows its k, read by ldmatrix.trans
// (matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
// (k 8-15, n 8-15)); one fresh partial per n-tile a tile, added by FADD.
template <class C, int N>
__device__ __forceinline__ void accumulate_frags(
    float (&acc)[N][4], const unsigned (&a)[C::NJ / 2][4],
    const bf16* __restrict__ tile, int col0) {
  static_assert(N % 2 == 0, "two n8 tiles a B load");
  const int lane = threadIdx.x % 32;
  const int k_off = lane % 8 + 8 * (lane / 8 % 2), n_off = 8 * (lane / 16);
#pragma unroll
  for (int n = 0; n < N; n += 2) {
    float part0[4], part1[4];
#pragma unroll
    for (int kc = 0; kc < C::NJ / 2; ++kc) {
      unsigned r[4];
      bf16mma::ldmatrix_x4_trans(
          r, tile + (16 * kc + k_off) * C::LD + col0 + 8 * n + n_off);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      bf16mma::mma_bf16(part0, a[kc], b0, kc == 0);
      bf16mma::mma_bf16(part1, a[kc], b1, kc == 0);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[n][e] += part0[e];
      acc[n + 1][e] += part1[e];
    }
  }
}

// acc[n] += round_bf16(P) . tile[:, col0 + 8 n ..]: P (or dS) the f32
// score accumulators of the warp's 16 rows against the tile's rows, each
// value rounded to nearest even as it packs (mma_bf16.cuh: a_from_acc).
template <class C, int N>
__device__ __forceinline__ void accumulate_bf16(float (&acc)[N][4],
                                                const float (&p)[C::NJ][4],
                                                const bf16* __restrict__ tile,
                                                int col0) {
  unsigned a[C::NJ / 2][4];
#pragma unroll
  for (int kc = 0; kc < C::NJ / 2; ++kc)
    bf16mma::a_from_acc(p[2 * kc], p[2 * kc + 1], a[kc]);
  accumulate_frags<C, N>(acc, a, tile, col0);
}

// Writes the warp's rows row0 + g (+ 8) of acc, times mul[h], rounded to
// bf16 (nearest even), into columns 8 n + 2t of out (row pitch ld; rows
// below T): one 4-byte store a pair.
template <int N>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[N][4],
                                                bf16* __restrict__ out,
                                                int row0, int T, int ld,
                                                const float (&mul)[2], int g,
                                                int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int n = 0; n < N; ++n)
      *reinterpret_cast<unsigned*>(out + (size_t)row * ld + 8 * n + 2 * t) =
          bf16mma::pack_bf16x2(acc[n][2 * h] * mul[h],
                               acc[n][2 * h + 1] * mul[h]);
  }
}

}  // namespace flash_tiles
