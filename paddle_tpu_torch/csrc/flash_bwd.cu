// Flash-attention backward for sm_90a: two kernels on the tensor cores,
// over float32 operands in split TF32 and over bfloat16 operands on bf16
// mma.sync (at the end of the file).
//
// Replaces paddle_tpu/nn/pallas_attention.py:_dq_kernel and _dkv_kernel
// (launched by _flash_backward). Given q, k, v [B, H, T, D], the upstream
// gradient dO [B, H, T, D], the forward's per-row log-sum-exp LSE [B, H, T]
// and delta = rowsum(dO * O) [B, H, T] (computed by the caller, as the TPU
// path computes it outside Pallas), they rebuild p = exp(q.k^T * scale -
// LSE) tile by tile and write
//   flash_bwd_dq:  dq = scale * sum_k ds . k
//   flash_bwd_dkv: dk = scale * sum_q ds^T . q,  dv = sum_q p^T . dO
// with ds = p * (dO.v^T - delta), under optional causal masking and
// packed-sequence segment ids [B, T] (1-based, 0 = padding) shared across
// heads.
//
// What bounds it on the H100: operations. At the training shape
// [8, 4, 2048, 128] causal the kernels' own functions need 51.6 (dq: s,
// dp, ds.k) and 68.8 GFLOP (dk/dv: s, dp, p^T.dO, ds^T.q) against 269 MB.
// On f32 CUDA cores (67 TFLOP/s) that is 0.77 + 1.03 ms, 44% of SDPA's f32
// backward before anything else counts, so every product runs on the
// tensor cores instead, in split TF32 (mma_tf32.cuh: three TF32 mma.sync
// per f32 product, f32 accuracy): 3 * 2 * M * N * K against 495 TFLOP/s,
// 0.31 + 0.42 ms, or 0.48 + 0.64 ms at the 321 TFLOP/s the card's mma.sync
// reaches (tools/mma_tf32_peak.py).
//
// Design, shared by both kernels. A block owns ROWS resident rows (query
// rows in dq, key rows in dk/dv) and walks the other side's rows in
// streamed tiles of BS <= 32 rows:
//   - The two resident operands (Q and dO in dq, K and V in dk/dv) are
//     reused by every streamed tile, so they are split into TF32 hi and lo
//     planes once, as they land, and their fragments load ready-split. The
//     streamed tiles are split in registers as their fragments load.
//   - Streamed tiles (K and V, or Q, dO, LSE and delta) and their segment
//     ids land by cp.async in a ring of STAGES stages, 16-byte copies where
//     the wrapper found every operand 16-byte aligned, else 4-byte ones:
//     tile t + 1 loads while tile t computes, one barrier a tile.
//   - Warps work in pairs, each pair on 16 resident rows: one warp forms
//     the scores s = q.k^T (then p), the other dp = dO.v^T (then dp -
//     delta), so neither loads the other's operands; they swap the two
//     16 x BS tiles once through shared memory (a barrier of the pair
//     alone), and each then accumulates half of D. Two accumulators of 16
//     rows x D = 128 would take 128 registers a thread (dk and dv), so the
//     halves keep the kernels clear of spills at 8 warps an SM.
//   - The scores contract over D in partials of 32, all D / 32 in flight
//     (independent mma chains); the accumulating products (dq += ds.k, or
//     dv += p^T.dO and dk += ds^T.q) contract over the streamed tile, one
//     fresh partial each. Each partial is added to its f32 accumulator
//     with an ordinary FADD: the tensor cores truncate as they add, and a
//     long chain into one accumulator drifts (gemm_f32.cuh).
//   - p and ds stay in registers: the mma accumulator holds columns 2t and
//     2t + 1 of its row where the next product's A fragment wants k = t
//     and t + 4, so that product takes its k order permuted the same way
//     (k = t is column 2t, k = t + 4 is 2t + 1) in both operands.
//   - p = 2^(s * scale * log2 e - LSE * log2 e) by ex2.approx.ftz, one FFMA
//     and one MUFU; on tiles whose every pair is visible the masks are not
//     formed at all.
// Masked pairs get a score of -inf, so p = 0 for them and for padding rows
// (whose LSE is about -1e30); rows past T load as zeros, are masked the
// same way and are never written. Whole streamed tiles are skipped by the
// forward's rules, the causal cone and segment-id ranges that cannot meet
// (_block_needed / _seg_block_relevant); every warp finds the next tile
// alike, so the skip costs no barrier. Within a tile a pair whose 16 rows
// the causal cone hides skips its products.
//
//   flash_bwd_dq:  Q, dO, LSE and delta resident, K and V streamed; under
//                  causal masking the blocks take the query tiles from the
//                  last (longest) one.
//   flash_bwd_dkv: K and V resident, Q, dO, LSE and delta streamed; under
//                  causal masking key tile 0 (the longest) goes first and
//                  key tile t starts at the query tile holding row t.
//
// Why two kernels and no atomics: dq sums over key tiles and dk/dv over
// query tiles, each inside one block in a fixed order, so every run gives
// the same bits. Without a ds buffer each kernel recomputes s and dp
// (seven products where five would do). The whole backward
// (paddle_tpu_torch/nn/cuda_attention.py: flash_attention_bwd) runs dk/dv
// first and has it store ds in a [B * H, T, T] buffer where the plan
// allows (T % 4 == 0 and at most 1 GiB, the rise of a step's peak memory
// it may cost; 512 MiB at the training shape); dq then reads its tiles of
// ds back (flash_bwd_dq_ds_kernel) and runs only ds.k: five products,
// still one writer per value and a fixed order, so still the same bits.
//
// The host plan (flash_bwd_plan there) picks the instance from the shapes
// alone: Large (8 warps, 64 rows, streamed tiles of 32) unless its blocks
// would leave the card under one wave, then Small (4 warps, 32 rows,
// tiles of 16); and whether ds is stored.

#include "flash_tiles.cuh"

namespace {

using namespace flash_tiles;

template <int D_, int WARPS_, int BS_, int STAGES_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int D = D_, WARPS = WARPS_, BS = BS_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int ROWS = 8 * WARPS, NT = 32 * WARPS;  // 16 rows a pair
  static constexpr int NJ = BS / 8;   // score n-tiles; k-steps of the rest
  static constexpr int ND = D / 16;   // accumulator n-tiles: half of D
  static constexpr int CHUNKS = D / 32;  // score partials (32 d) in flight
  // row pitch in floats: 16-byte rows for cp.async, and fragment loads free
  // of bank conflicts (pitch = 4 mod 32)
  static constexpr int LD = D + 4;
  static constexpr int PLANE = ROWS * LD;        // a resident hi or lo plane
  static constexpr int TILE = BS * LD;           // a streamed matrix
  // a stage: two matrices, then LSE, delta and segment ids of BS rows
  static constexpr int STAGE = 2 * TILE + 3 * BS;
  // the pairs' exchange: each warp's score fragments, a float4 a lane
  static constexpr int XCHG = WARPS * NJ * 128;
  static constexpr int SMEM_BYTES =
      4 * (4 * PLANE + STAGES * STAGE + XCHG);
  static_assert(WARPS % 2 == 0 && WARPS <= 8, "pairs of warps");
  static_assert(BS % 16 == 0 && BS <= 32, "partials of at most 32 rows");
  static_assert(SMEM_BYTES <= 232448, "shared memory a block may use");
};

// The instances (paddle_tpu_torch/nn/cuda_attention.py: _BWD_TILES, by the
// index the entry points take): Large, 8 warps over 64 resident rows and
// streamed tiles of 32, at D = 128 215 KB (one block an SM); Small, 4 warps
// over 32 rows and tiles of 16, 103 KB (two an SM); at D = 64, 119 KB (one)
// and 55 KB (three, by registers).
template <int D>
using Large = Cfg<D, 8, 32, 2, 1>;
template <int D>
using Small = Cfg<D, 4, 16, 2, D == 64 ? 3 : 2>;

struct Args {
  const float *q, *k, *v;
  const int* seg;
  const float *dout, *lse, *delta;
  float *dq, *dk, *dv;
  float* ds;    // [B * H, T, T]: dk/dv writes its ds there, dq reads it
  int B, H, T;
  float scale;
  int causal;
  int vec;      // 4: 16-byte copies (q, k, v, dout 16-byte aligned), or 1
};

// The warp pair's exchange: x goes to this warp's slot of xchg, and the
// partner's fragments (same rows, the other product) come back in y, after
// a barrier of the pair's 64 threads alone (named barrier 1 + pair).
template <class C>
__device__ __forceinline__ void swap_pair(float* xchg,
                                          const float (&x)[C::NJ][4],
                                          float (&y)[C::NJ][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < C::NJ; ++j)
    *reinterpret_cast<float4*>(xchg + (warp * C::NJ + j) * 128 + 4 * lane) =
        make_float4(x[j][0], x[j][1], x[j][2], x[j][3]);
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + warp / 2) : "memory");
#pragma unroll
  for (int j = 0; j < C::NJ; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(
        xchg + ((warp ^ 1) * C::NJ + j) * 128 + 4 * lane);
    y[j][0] = v.x;
    y[j][1] = v.y;
    y[j][2] = v.z;
    y[j][3] = v.w;
  }
}

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_bwd_dq_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  unsigned* qh = reinterpret_cast<unsigned*>(smem);
  unsigned* ql = qh + C::PLANE;
  unsigned* gh = ql + C::PLANE;                // dO
  unsigned* gl = gh + C::PLANE;
  float* ring = smem + 4 * C::PLANE;
  float* xchg = ring + C::STAGES * C::STAGE;
  const int T = a.T, BH = a.B * a.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int half = threadIdx.x / 32 % 2;       // 0: s, 1: dp; half of D
  const int wrow = 16 * (threadIdx.x / 64);
  const int bh = blockIdx.x % BH, rank = blockIdx.x / BH;
  const int n_rt = (T + C::ROWS - 1) / C::ROWS;
  const int q0 = (a.causal ? n_rt - 1 - rank : rank) * C::ROWS;
  const size_t base = (size_t)bh * T * C::D;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;

  const int n_st = (T + C::BS - 1) / C::BS;
  const int end = a.causal ? min((q0 + C::ROWS - 1) / C::BS + 1, n_st) : n_st;
  const int2 own = seg ? seg_range(seg, q0, C::ROWS, T) : make_int2(0, 0);
  const auto load = [&](float* st, int kt) {
    by_width(a, [&](auto vec) {
      stage_rows<C, decltype(vec)::value>(st, a.k + base, kt * C::BS, T);
      stage_rows<C, decltype(vec)::value>(st + C::TILE, a.v + base,
                                          kt * C::BS, T);
    });
    if (seg)
      stage_vec<C>(st + 2 * C::TILE + 2 * C::BS,
                   reinterpret_cast<const float*>(seg), kt * C::BS, T);
  };

  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float one[2] = {1.f, 1.f};  // accumulate rescales nothing
  const float sl2e = a.scale * LOG2E;
  int qrow[2], qseg[2];
  float lse_r[2], delta_r[2];                  // LSE as -lse * log2 e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wrow + g + 8 * h;
    const bool live = row < T;
    qrow[h] = row;
    lse_r[h] = live ? -a.lse[(size_t)bh * T + row] * LOG2E : 0.f;
    delta_r[h] = live ? a.delta[(size_t)bh * T + row] : 0.f;
    qseg[h] = seg && live ? seg[row] : 0;
  }
  const auto setup = [&] {
    by_width(a, [&](auto vec) {
      load_split<C, decltype(vec)::value>(qh, ql, a.q + base, q0, T);
      load_split<C, decltype(vec)::value>(gh, gl, a.dout + base, q0, T);
    });
  };
  stream<C>(ring, seg, own, 0, end, T, setup, load, [&](const float* st,
                                                        int kt) {
    const int k0 = kt * C::BS;
    // a pair whose rows lie past T, or see no key of the tile, skips it
    if (q0 + wrow >= T || (a.causal && k0 > q0 + wrow + 15)) return;
    // s = Q . K^T in one warp of the pair, dp = dO . V^T in the other
    float x[C::NJ][4], y[C::NJ][4];
    scores<C>(x, half ? gh : qh, half ? gl : ql, st + half * C::TILE, wrow,
              g, t);
    const int* kseg =
        reinterpret_cast<const int*>(st + 2 * C::TILE + 2 * C::BS);
    // every pair of the tile visible: in T, inside the cone, no segments
    const bool inside = !seg && k0 + C::BS <= T && q0 + wrow + 16 <= T &&
                        (!a.causal || k0 + C::BS - 1 <= q0 + wrow);
    if (half) {                                     // dp - delta
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] -= delta_r[e >> 1];
    } else if (inside) {                            // p
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[j][e] = exp2_ftz(fmaf(x[j][e], sl2e, lse_r[e >> 1]));
    } else {                                        // p, masked
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 8 * j + 2 * t + (e & 1);
          const int kj = k0 + col;
          bool vis = qrow[h] < T && kj < T;
          if (a.causal) vis = vis && kj <= qrow[h];
          if (seg) vis = vis && kseg[col] == qseg[h] && qseg[h] > 0;
          x[j][e] =
              exp2_ftz(vis ? fmaf(x[j][e], sl2e, lse_r[h]) : -INFINITY);
        }
    }
    swap_pair<C>(xchg, x, y);
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] *= y[j][e];  // ds = p * (dp - d)
    unsigned dh[C::NJ][4], dl[C::NJ][4];
    a_frags<C>(x, dh, dl);
    accumulate<C>(acc, dh, dl, st + half * (C::D / 2), one, g, t);  // += ds . K
  });
  const float sc[2] = {a.scale, a.scale};
  store_rows<C>(acc, a.dq + base + half * (C::D / 2), q0 + wrow, T, sc, g, t);
}

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_bwd_dkv_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  unsigned* kh = reinterpret_cast<unsigned*>(smem);
  unsigned* kl = kh + C::PLANE;
  unsigned* vh = kl + C::PLANE;
  unsigned* vl = vh + C::PLANE;
  float* ring = smem + 4 * C::PLANE;
  float* xchg = ring + C::STAGES * C::STAGE;
  const int T = a.T, BH = a.B * a.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int half = threadIdx.x / 32 % 2;       // 0: s^T, 1: dp^T; half of D
  const int wrow = 16 * (threadIdx.x / 64);
  const int bh = blockIdx.x % BH;
  const int k0 = blockIdx.x / BH * C::ROWS;
  const size_t base = (size_t)bh * T * C::D;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;

  const int end = (T + C::BS - 1) / C::BS;
  const int first = a.causal ? k0 / C::BS : 0;
  const int2 own = seg ? seg_range(seg, k0, C::ROWS, T) : make_int2(0, 0);
  const float* lse = a.lse + (size_t)bh * T;
  const float* delta = a.delta + (size_t)bh * T;
  const auto load = [&](float* st, int qt) {
    const int r0 = qt * C::BS;
    by_width(a, [&](auto vec) {
      stage_rows<C, decltype(vec)::value>(st, a.q + base, r0, T);
      stage_rows<C, decltype(vec)::value>(st + C::TILE, a.dout + base, r0,
                                          T);
    });
    stage_vec<C>(st + 2 * C::TILE, lse, r0, T);
    stage_vec<C>(st + 2 * C::TILE + C::BS, delta, r0, T);
    if (seg)
      stage_vec<C>(st + 2 * C::TILE + 2 * C::BS,
                   reinterpret_cast<const float*>(seg), r0, T);
  };

  float dk[C::ND][4], dv[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float one[2] = {1.f, 1.f};  // accumulate rescales nothing
  const float sl2e = a.scale * LOG2E;
  int krow[2], kseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    krow[h] = k0 + wrow + g + 8 * h;
    kseg[h] = seg && krow[h] < T ? seg[krow[h]] : 0;
  }
  const auto setup = [&] {
    by_width(a, [&](auto vec) {
      load_split<C, decltype(vec)::value>(kh, kl, a.k + base, k0, T);
      load_split<C, decltype(vec)::value>(vh, vl, a.v + base, k0, T);
    });
  };
  stream<C>(ring, seg, own, first, end, T, setup, load, [&](const float* st,
                                                            int qt) {
    const int q0 = qt * C::BS;
    // a pair whose rows lie past T, or that no query of the tile sees,
    // skips it
    if (k0 + wrow >= T || (a.causal && q0 + C::BS - 1 < k0 + wrow)) return;
    const float* Ls = st + 2 * C::TILE;
    const float* Dl = Ls + C::BS;
    const int* qseg = reinterpret_cast<const int*>(Dl + C::BS);
    // s^T = K . Q^T in one warp of the pair, dp^T = V . dO^T in the other
    float x[C::NJ][4], y[C::NJ][4];
    scores<C>(x, half ? vh : kh, half ? vl : kl, st + half * C::TILE, wrow,
              g, t);
    // every pair of the tile visible: in T, inside the cone, no segments
    const bool inside = !seg && q0 + C::BS <= T && k0 + wrow + 16 <= T &&
                        (!a.causal || k0 + wrow + 15 <= q0);
    if (half) {                                     // dp - delta
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] -= Dl[8 * j + 2 * t + (e & 1)];
    } else if (inside) {                            // p
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[j][e] = exp2_ftz(fmaf(x[j][e], sl2e,
                                  -Ls[8 * j + 2 * t + (e & 1)] * LOG2E));
    } else {                                        // p, masked
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 8 * j + 2 * t + (e & 1);
          const int qi = q0 + col;
          bool vis = krow[h] < T && qi < T;
          if (a.causal) vis = vis && krow[h] <= qi;
          if (seg) vis = vis && qseg[col] == kseg[h] && kseg[h] > 0;
          x[j][e] = exp2_ftz(vis ? fmaf(x[j][e], sl2e, -Ls[col] * LOG2E)
                                 : -INFINITY);
        }
    }
    swap_pair<C>(xchg, x, y);
    float p[C::NJ][4], ds[C::NJ][4];
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = half ? y[j][e] : x[j][e];
        ds[j][e] = x[j][e] * y[j][e];               // p * (dp - delta)
      }
    if (a.ds && half) {      // ds[q][k] for dq's own product (five products)
      float* out = a.ds + (size_t)bh * T * T;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1), kj = krow[e >> 1];
          if (qi < T && kj < T) out[(size_t)qi * T + kj] = ds[j][e];
        }
    }
    const int col0 = half * (C::D / 2);
    {
      unsigned fh[C::NJ][4], fl[C::NJ][4];
      a_frags<C>(p, fh, fl);
      accumulate<C>(dv, fh, fl, st + C::TILE + col0, one, g, t);  // += p^T . dO
    }
    unsigned fh[C::NJ][4], fl[C::NJ][4];
    a_frags<C>(ds, fh, fl);
    accumulate<C>(dk, fh, fl, st + col0, one, g, t);         // += ds^T . Q
  });
  const int col0 = half * (C::D / 2);
  const float sc[2] = {a.scale, a.scale};
  store_rows<C>(dk, a.dk + base + col0, k0 + wrow, T, sc, g, t);
  store_rows<C>(dv, a.dv + base + col0, k0 + wrow, T, one, g, t);
}

// flash_bwd_dq from the ds that flash_bwd_dkv stored: no resident planes,
// a stage holds a K tile and the block's [ROWS x BS] tile of ds; only the
// product dq += ds . K runs (ds masked by visibility, so entries dk/dv did
// not write are never used).
template <class C>
struct FromDs : C {
  // ds rows: 16-byte pitch, and float2 fragment loads free of bank
  // conflicts (pitch = 8 or 24 mod 32)
  static constexpr int LDDS = C::BS + 8;
  static constexpr int STAGE = C::TILE + C::ROWS * LDDS + C::BS;
  static constexpr int SMEM_BYTES = 4 * C::STAGES * STAGE;
};

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_bwd_dq_ds_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, BH = a.B * a.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int half = threadIdx.x / 32 % 2;       // half of D
  const int wrow = 16 * (threadIdx.x / 64);
  const int bh = blockIdx.x % BH, rank = blockIdx.x / BH;
  const int n_rt = (T + C::ROWS - 1) / C::ROWS;
  const int q0 = (a.causal ? n_rt - 1 - rank : rank) * C::ROWS;
  const size_t base = (size_t)bh * T * C::D;
  const float* ds = a.ds + (size_t)bh * T * T;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;

  const int n_st = (T + C::BS - 1) / C::BS;
  const int end = a.causal ? min((q0 + C::ROWS - 1) / C::BS + 1, n_st) : n_st;
  const int2 own = seg ? seg_range(seg, q0, C::ROWS, T) : make_int2(0, 0);
  const auto load = [&](float* st, int kt) {
    const int k0 = kt * C::BS;
    by_width(a, [&](auto vec) {
      constexpr int VEC = decltype(vec)::value;
      stage_rows<C, VEC>(st, a.k + base, k0, T);
      constexpr int PER_ROW = C::BS / VEC;       // ds rows (T % 4 == 0)
      for (int i = threadIdx.x; i < C::ROWS * PER_ROW; i += C::NT) {
        const int r = i / PER_ROW, c = i % PER_ROW * VEC;
        const bool live = q0 + r < T && k0 + c < T;
        cp_async<VEC>(st + C::TILE + r * C::LDDS + c,
                      live ? ds + (size_t)(q0 + r) * T + k0 + c : ds, live);
      }
    });
    if (seg)
      stage_vec<C>(st + C::TILE + C::ROWS * C::LDDS,
                   reinterpret_cast<const float*>(seg), k0, T);
  };

  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float one[2] = {1.f, 1.f};  // accumulate rescales nothing
  int qrow[2], qseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qrow[h] = q0 + wrow + g + 8 * h;
    qseg[h] = seg && qrow[h] < T ? seg[qrow[h]] : 0;
  }
  stream<C>(smem, seg, own, 0, end, T, [] {}, load, [&](const float* st,
                                                        int kt) {
    const int k0 = kt * C::BS;
    if (q0 + wrow >= T || (a.causal && k0 > q0 + wrow + 15)) return;
    const float* dsS = st + C::TILE;
    const int* kseg = reinterpret_cast<const int*>(dsS + C::ROWS * C::LDDS);
    float x[C::NJ][4];     // ds in the score accumulator's layout
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(
            dsS + (wrow + g + 8 * h) * C::LDDS + 8 * j + 2 * t);
        x[j][2 * h] = v.x;
        x[j][2 * h + 1] = v.y;
      }
    // every pair of the tile visible: in T, inside the cone, no segments
    const bool inside = !seg && k0 + C::BS <= T && q0 + wrow + 16 <= T &&
                        (!a.causal || k0 + C::BS - 1 <= q0 + wrow);
    if (!inside) {
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 8 * j + 2 * t + (e & 1);
          const int kj = k0 + col;
          bool vis = qrow[h] < T && kj < T;
          if (a.causal) vis = vis && kj <= qrow[h];
          if (seg) vis = vis && kseg[col] == qseg[h] && qseg[h] > 0;
          x[j][e] = vis ? x[j][e] : 0.f;
        }
    }
    unsigned dh[C::NJ][4], dl[C::NJ][4];
    a_frags<C>(x, dh, dl);
    accumulate<C>(acc, dh, dl, st + half * (C::D / 2), one, g, t);  // += ds . K
  });
  const float sc[2] = {a.scale, a.scale};
  store_rows<C>(acc, a.dq + base + half * (C::D / 2), q0 + wrow, T, sc, g, t);
}

template <class C, class Kernel, class A>
cudaError_t launch_kernel(Kernel kernel, const A& a, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into per kernel
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // one block per (b*h, resident tile), b*h fastest: all first tiles
  // (the longest under causal masking) start before any second one
  const long long blocks =
      (long long)a.B * a.H * ((a.T + C::ROWS - 1) / C::ROWS);
  kernel<<<(unsigned)blocks, C::NT, C::SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <bool DKV, class C>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  if constexpr (DKV) {
    return launch_kernel<C>(flash_bwd_dkv_kernel<C>, a, stream);
  } else {
    if (a.ds)
      return launch_kernel<FromDs<C>>(flash_bwd_dq_ds_kernel<FromDs<C>>, a,
                                      stream);
    return launch_kernel<C>(flash_bwd_dq_kernel<C>, a, stream);
  }
}

template <bool DKV, int D>
cudaError_t dispatch(const Args& a, int tile, cudaStream_t stream) {
  if (a.vec != 4 && a.vec != 1) return cudaErrorInvalidValue;
  if (tile == 0) return launch<DKV, Large<D>>(a, stream);
  if (tile == 1) return launch<DKV, Small<D>>(a, stream);
  return cudaErrorInvalidValue;
}

template <bool DKV>
int run(const Args& a, int D, int tile, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(dispatch<DKV, 64>(a, tile, st));
  if (D == 128) return static_cast<int>(dispatch<DKV, 128>(a, tile, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// bfloat16 operands (flash_bwd_dq_bf16, flash_bwd_dkv_bf16)
// ---------------------------------------------------------------------------
//
// _dq_kernel and _dkv_kernel on bf16 q, k, v and dO, with the f32 LSE and
// delta: p = exp(s - LSE) and ds = p * (dp - delta) in f32 as above; p is
// rounded to bf16 before dv += p^T . dO, ds before dk += ds^T . q and
// dq += ds . k (pallas_attention.py:199, 243, 249), every sum in f32; the
// scale is applied once, at the write, and dq, dk and dv are written in
// bf16. The design is the f32 kernels' (warp pairs, one forming s and p,
// the other dp - delta, swapping their f32 tiles; each accumulating half
// of D; the same skips, masks and order), with bf16 operands:
//   - each warp's resident A fragments (Q or dO in dq, K or V in dk/dv:
//     one operand a warp) load from global memory once, into registers;
//     there are no resident planes;
//   - streamed tiles land raw by 16- or 4-byte cp.async and feed the
//     scores by ldmatrix and the accumulating products by ldmatrix.trans;
//   - every product is one bf16 mma.sync.m16n8k16 into f32 (flash_tiles.cuh:
//     scores_bf16, accumulate_bf16), the scores in partials of 32 of D,
//     the accumulators one fresh partial a tile, added by FADD;
//   - p and ds pack from the score accumulators into A fragments, rounded
//     to nearest even.
// The stored ds is bf16, ds[q][k] as dk/dv rounds it for its own product:
// ds.astype(k.dtype) and ds.astype(q.dtype) are the same rounding, so dq
// from the stored ds multiplies what it would have formed itself, at half
// the f32 buffer's bytes; its rows are read 16 bytes at a time, so the
// plan stores it only where T % 8 == 0. No atomics: reruns are bit-equal.

template <int D_, int WARPS_, int BS_, int STAGES_, int MIN_BLOCKS_>
struct CfgB {
  static constexpr int D = D_, WARPS = WARPS_, BS = BS_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int ROWS = 8 * WARPS, NT = 32 * WARPS;  // 16 rows a pair
  static constexpr int NJ = BS / 8;   // score n-tiles
  static constexpr int ND = D / 16;   // accumulator n-tiles: half of D
  static constexpr int LD = D + 8;    // row pitch in bf16 values
  static constexpr int TILE = BS * LD;  // a streamed matrix, bf16 values
  // a stage in floats: two bf16 matrices, then LSE, delta and segment ids
  static constexpr int STAGE = TILE + 3 * BS;
  static constexpr int XCHG = WARPS * NJ * 128;  // the pairs' exchange
  static constexpr int SMEM_BYTES = 4 * (STAGES * STAGE + XCHG);
  static_assert(WARPS % 2 == 0 && WARPS <= 8, "pairs of warps");
  static_assert(BS % 16 == 0 && BS <= 32, "k-steps of 16 rows");
  static_assert(SMEM_BYTES <= 232448, "shared memory a block may use");
};

// The instances (nn/cuda_attention.py: _BWD_TILES_BF16, by index): Large,
// 8 warps over 64 resident rows and streamed tiles of 32, one block an SM;
// Small, 4 warps over 32 rows and tiles of 16, two an SM. At D = 128 51
// and 23 KB of shared memory (the dq-from-ds kernel's four stages: 56
// and 24 KB).
template <int D>
using LargeB = CfgB<D, 8, 32, 2, 1>;
template <int D>
using SmallB = CfgB<D, 4, 16, 2, 2>;

struct ArgsB {
  const bf16 *q, *k, *v;
  const int* seg;
  const bf16* dout;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv;
  bf16* ds;     // [B * H, T, T]: dk/dv writes its ds there, dq reads it
  int B, H, T;
  float scale;
  int causal;
  int vec;      // 8: 16-byte copies (q, k, v, dout 16-byte aligned), or 2
};

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_bwd_dq_bf16_kernel(const ArgsB a) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* xchg = ring + C::STAGES * C::STAGE;
  const int T = a.T, BH = a.B * a.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int half = threadIdx.x / 32 % 2;       // 0: s, 1: dp; half of D
  const int wrow = 16 * (threadIdx.x / 64);
  const int bh = blockIdx.x % BH, rank = blockIdx.x / BH;
  const int n_rt = (T + C::ROWS - 1) / C::ROWS;
  const int q0 = (a.causal ? n_rt - 1 - rank : rank) * C::ROWS;
  const size_t base = (size_t)bh * T * C::D;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;

  const int n_st = (T + C::BS - 1) / C::BS;
  const int end = a.causal ? min((q0 + C::ROWS - 1) / C::BS + 1, n_st) : n_st;
  const int2 own = seg ? seg_range(seg, q0, C::ROWS, T) : make_int2(0, 0);
  const auto load = [&](float* st, int kt) {
    bf16* kv = reinterpret_cast<bf16*>(st);
    by_width<8, 2>(a, [&](auto vec) {
      stage_rows<C, decltype(vec)::value>(kv, a.k + base, kt * C::BS, T);
      stage_rows<C, decltype(vec)::value>(kv + C::TILE, a.v + base,
                                          kt * C::BS, T);
    });
    if (seg)
      stage_vec<C>(st + C::TILE + 2 * C::BS,
                   reinterpret_cast<const float*>(seg), kt * C::BS, T);
  };

  unsigned af[C::D / 16][4];                   // Q, or dO
  a_rows<C::D>(af, (half ? a.dout : a.q) + base, q0 + wrow, T, g, t);
  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float sl2e = a.scale * LOG2E;
  int qrow[2], qseg[2];
  float lse_r[2], delta_r[2];                  // LSE as -lse * log2 e
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wrow + g + 8 * h;
    const bool live = row < T;
    qrow[h] = row;
    lse_r[h] = live ? -a.lse[(size_t)bh * T + row] * LOG2E : 0.f;
    delta_r[h] = live ? a.delta[(size_t)bh * T + row] : 0.f;
    qseg[h] = seg && live ? seg[row] : 0;
  }
  stream<C>(ring, seg, own, 0, end, T, [] {}, load, [&](const float* st,
                                                          int kt) {
    const int k0 = kt * C::BS;
    if (q0 + wrow >= T || (a.causal && k0 > q0 + wrow + 15)) return;
    const bf16* kv = reinterpret_cast<const bf16*>(st);
    // s = Q . K^T in one warp of the pair, dp = dO . V^T in the other
    float x[C::NJ][4], y[C::NJ][4];
    scores_bf16<C>(x, af, kv + half * C::TILE);
    const int* kseg = reinterpret_cast<const int*>(st + C::TILE + 2 * C::BS);
    const bool inside = !seg && k0 + C::BS <= T && q0 + wrow + 16 <= T &&
                        (!a.causal || k0 + C::BS - 1 <= q0 + wrow);
    if (half) {                                     // dp - delta
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] -= delta_r[e >> 1];
    } else {                                        // p
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 8 * j + 2 * t + (e & 1);
          const int kj = k0 + col;
          bool vis = true;
          if (!inside) {
            vis = qrow[h] < T && kj < T;
            if (a.causal) vis = vis && kj <= qrow[h];
            if (seg) vis = vis && kseg[col] == qseg[h] && qseg[h] > 0;
          }
          x[j][e] =
              exp2_ftz(vis ? fmaf(x[j][e], sl2e, lse_r[h]) : -INFINITY);
        }
    }
    swap_pair<C>(xchg, x, y);
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] *= y[j][e];  // ds = p * (dp - d)
    accumulate_bf16<C, C::ND>(acc, x, kv, half * (C::D / 2));  // += ds . K
  });
  const float sc[2] = {a.scale, a.scale};
  store_rows_bf16<C::ND>(acc, a.dq + base + half * (C::D / 2), q0 + wrow, T,
                         C::D, sc, g, t);
}

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_bwd_dkv_bf16_kernel(const ArgsB a) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  float* xchg = ring + C::STAGES * C::STAGE;
  const int T = a.T, BH = a.B * a.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int half = threadIdx.x / 32 % 2;       // 0: s^T, 1: dp^T; half of D
  const int wrow = 16 * (threadIdx.x / 64);
  const int bh = blockIdx.x % BH;
  const int k0 = blockIdx.x / BH * C::ROWS;
  const size_t base = (size_t)bh * T * C::D;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;

  const int end = (T + C::BS - 1) / C::BS;
  const int first = a.causal ? k0 / C::BS : 0;
  const int2 own = seg ? seg_range(seg, k0, C::ROWS, T) : make_int2(0, 0);
  const float* lse = a.lse + (size_t)bh * T;
  const float* delta = a.delta + (size_t)bh * T;
  const auto load = [&](float* st, int qt) {
    const int r0 = qt * C::BS;
    bf16* qd = reinterpret_cast<bf16*>(st);
    by_width<8, 2>(a, [&](auto vec) {
      stage_rows<C, decltype(vec)::value>(qd, a.q + base, r0, T);
      stage_rows<C, decltype(vec)::value>(qd + C::TILE, a.dout + base, r0,
                                          T);
    });
    stage_vec<C>(st + C::TILE, lse, r0, T);
    stage_vec<C>(st + C::TILE + C::BS, delta, r0, T);
    if (seg)
      stage_vec<C>(st + C::TILE + 2 * C::BS,
                   reinterpret_cast<const float*>(seg), r0, T);
  };

  unsigned af[C::D / 16][4];                   // K, or V
  a_rows<C::D>(af, (half ? a.v : a.k) + base, k0 + wrow, T, g, t);
  float dk[C::ND][4], dv[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float sl2e = a.scale * LOG2E;
  int krow[2], kseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    krow[h] = k0 + wrow + g + 8 * h;
    kseg[h] = seg && krow[h] < T ? seg[krow[h]] : 0;
  }
  const int col0 = half * (C::D / 2);
  stream<C>(ring, seg, own, first, end, T, [] {}, load, [&](const float* st,
                                                              int qt) {
    const int q0 = qt * C::BS;
    if (k0 + wrow >= T || (a.causal && q0 + C::BS - 1 < k0 + wrow)) return;
    const bf16* qd = reinterpret_cast<const bf16*>(st);
    const float* Ls = st + C::TILE;
    const float* Dl = Ls + C::BS;
    const int* qseg = reinterpret_cast<const int*>(Dl + C::BS);
    // s^T = K . Q^T in one warp of the pair, dp^T = V . dO^T in the other
    float x[C::NJ][4], y[C::NJ][4];
    scores_bf16<C>(x, af, qd + half * C::TILE);
    const bool inside = !seg && q0 + C::BS <= T && k0 + wrow + 16 <= T &&
                        (!a.causal || k0 + wrow + 15 <= q0);
    if (half) {                                     // dp - delta
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] -= Dl[8 * j + 2 * t + (e & 1)];
    } else {                                        // p
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 8 * j + 2 * t + (e & 1);
          const int qi = q0 + col;
          bool vis = true;
          if (!inside) {
            vis = krow[h] < T && qi < T;
            if (a.causal) vis = vis && krow[h] <= qi;
            if (seg) vis = vis && qseg[col] == kseg[h] && kseg[h] > 0;
          }
          x[j][e] = exp2_ftz(vis ? fmaf(x[j][e], sl2e, -Ls[col] * LOG2E)
                                 : -INFINITY);
        }
    }
    swap_pair<C>(xchg, x, y);
    float p[C::NJ][4];
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[j][e] = half ? y[j][e] : x[j][e];
        x[j][e] *= y[j][e];                         // ds = p * (dp - delta)
      }
    if (a.ds && half) {   // bf16 ds[q][k] for dq's own product
      bf16* out = a.ds + (size_t)bh * T * T;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1), kj = krow[e >> 1];
          if (qi < T && kj < T)
            out[(size_t)qi * T + kj] = __float2bfloat16_rn(x[j][e]);
        }
    }
    accumulate_bf16<C, C::ND>(dv, p, qd + C::TILE, col0);  // += p^T . dO
    accumulate_bf16<C, C::ND>(dk, x, qd, col0);            // += ds^T . Q
  });
  const float sc[2] = {a.scale, a.scale}, one[2] = {1.f, 1.f};
  store_rows_bf16<C::ND>(dk, a.dk + base + col0, k0 + wrow, T, C::D, sc, g,
                         t);
  store_rows_bf16<C::ND>(dv, a.dv + base + col0, k0 + wrow, T, C::D, one, g,
                         t);
}

// flash_bwd_dq_bf16 from the bf16 ds that flash_bwd_dkv_bf16 stored: a
// stage holds a K tile and the block's [ROWS x BS] tile of ds, whose
// 4-byte words are dq's A fragments as they stand (masked by visibility,
// so entries dk/dv did not write are never used); only dq += ds . K runs.
template <class C>
struct FromDsB : C {
  // four stages: the kernel reads ds and K and runs one product, so it
  // waits on memory; more tiles in flight hide that
  static constexpr int STAGES = 4;
  // ds rows: 16-byte pitch, and 4-byte fragment loads free of bank
  // conflicts (pitch = 20 or 12 words)
  static constexpr int LDDS = C::BS + 8;
  static constexpr int STAGE = C::TILE / 2 + C::ROWS * LDDS / 2 + C::BS;
  static constexpr int SMEM_BYTES = 4 * STAGES * STAGE;
};

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_bwd_dq_ds_bf16_kernel(const ArgsB a) {
  extern __shared__ __align__(16) float smem[];
  const int T = a.T, BH = a.B * a.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int half = threadIdx.x / 32 % 2;       // half of D
  const int wrow = 16 * (threadIdx.x / 64);
  const int bh = blockIdx.x % BH, rank = blockIdx.x / BH;
  const int n_rt = (T + C::ROWS - 1) / C::ROWS;
  const int q0 = (a.causal ? n_rt - 1 - rank : rank) * C::ROWS;
  const size_t base = (size_t)bh * T * C::D;
  const bf16* ds = a.ds + (size_t)bh * T * T;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;

  const int n_st = (T + C::BS - 1) / C::BS;
  const int end = a.causal ? min((q0 + C::ROWS - 1) / C::BS + 1, n_st) : n_st;
  const int2 own = seg ? seg_range(seg, q0, C::ROWS, T) : make_int2(0, 0);
  // a stage: K at bf16 0, ds at bf16 TILE, segment ids at float
  // TILE / 2 + ROWS * LDDS / 2
  const auto load = [&](float* st, int kt) {
    const int k0 = kt * C::BS;
    bf16* kt_s = reinterpret_cast<bf16*>(st);
    by_width<8, 2>(a, [&](auto vec) {
      constexpr int VEC = decltype(vec)::value;
      stage_rows<C, VEC>(kt_s, a.k + base, k0, T);
      constexpr int PER_ROW = C::BS / VEC;       // ds rows (T % 8 == 0)
      for (int i = threadIdx.x; i < C::ROWS * PER_ROW; i += C::NT) {
        const int r = i / PER_ROW, c = i % PER_ROW * VEC;
        const bool live = q0 + r < T && k0 + c < T;
        cp_async_bytes<2 * VEC>(
            kt_s + C::TILE + r * C::LDDS + c,
            live ? ds + (size_t)(q0 + r) * T + k0 + c : ds, live);
      }
    });
    if (seg)
      stage_vec<C>(st + C::TILE / 2 + C::ROWS * C::LDDS / 2,
                   reinterpret_cast<const float*>(seg), k0, T);
  };

  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  int qrow[2], qseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qrow[h] = q0 + wrow + g + 8 * h;
    qseg[h] = seg && qrow[h] < T ? seg[qrow[h]] : 0;
  }
  stream<C>(smem, seg, own, 0, end, T, [] {}, load, [&](const float* st,
                                                          int kt) {
    const int k0 = kt * C::BS;
    if (q0 + wrow >= T || (a.causal && k0 > q0 + wrow + 15)) return;
    const bf16* kt_s = reinterpret_cast<const bf16*>(st);
    const bf16* dsS = kt_s + C::TILE;
    const int* kseg = reinterpret_cast<const int*>(
        st + C::TILE / 2 + C::ROWS * C::LDDS / 2);
    const bool inside = !seg && k0 + C::BS <= T && q0 + wrow + 16 <= T &&
                        (!a.causal || k0 + C::BS - 1 <= q0 + wrow);
    // ds's A fragments: word r of a[kc] holds row g + 8 (r & 1), columns
    // 16 kc + 8 (r >> 1) + 2t and the next
    unsigned af[C::NJ / 2][4];
#pragma unroll
    for (int kc = 0; kc < C::NJ / 2; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1, col = 16 * kc + 8 * (r >> 1) + 2 * t;
        unsigned w = *reinterpret_cast<const unsigned*>(
            dsS + (wrow + g + 8 * h) * C::LDDS + col);
        if (!inside) {
          unsigned keep = 0u;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int kj = k0 + col + b;
            bool vis = qrow[h] < T && kj < T;
            if (a.causal) vis = vis && kj <= qrow[h];
            if (seg) vis = vis && kseg[col + b] == qseg[h] && qseg[h] > 0;
            keep |= vis ? 0xffffu << (16 * b) : 0u;
          }
          w &= keep;
        }
        af[kc][r] = w;
      }
    accumulate_frags<C, C::ND>(acc, af, kt_s, half * (C::D / 2));  // += ds.K
  });
  const float sc[2] = {a.scale, a.scale};
  store_rows_bf16<C::ND>(acc, a.dq + base + half * (C::D / 2), q0 + wrow, T,
                         C::D, sc, g, t);
}

template <bool DKV, class C>
cudaError_t launch_bf16(const ArgsB& a, cudaStream_t stream) {
  if constexpr (DKV) {
    return launch_kernel<C>(flash_bwd_dkv_bf16_kernel<C>, a, stream);
  } else {
    if (a.ds)
      return launch_kernel<FromDsB<C>>(flash_bwd_dq_ds_bf16_kernel<FromDsB<C>>,
                                       a, stream);
    return launch_kernel<C>(flash_bwd_dq_bf16_kernel<C>, a, stream);
  }
}

template <bool DKV, int D>
cudaError_t dispatch_bf16(const ArgsB& a, int tile, cudaStream_t stream) {
  if (a.vec != 8 && a.vec != 2) return cudaErrorInvalidValue;
  if (tile == 0) return launch_bf16<DKV, LargeB<D>>(a, stream);
  if (tile == 1) return launch_bf16<DKV, SmallB<D>>(a, stream);
  return cudaErrorInvalidValue;
}

template <bool DKV>
int run_bf16(const ArgsB& a, int D, int tile, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(dispatch_bf16<DKV, 64>(a, tile, st));
  if (D == 128) return static_cast<int>(dispatch_bf16<DKV, 128>(a, tile, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, dout, dq: [B, H, T, D] float32, contiguous. seg: [B, T] int32
// or null. lse, delta: [B, H, T] float32. ds: null, or [B * H, T, T]
// float32 that flash_bwd_dkv_f32 filled on these inputs (then only
// ds . k runs; T % 4 == 0). tile: 0 (Large) or 1 (Small); vec: 4 (16-byte
// copies: q, k, v and dout 16-byte aligned) or 1. Returns a cudaError_t
// (0 = launched).
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* seg, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                void* ds, int B, int H, int T, int D,
                                float scale, int causal, int tile, int vec,
                                void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const int*>(seg),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<const float*>(delta), static_cast<float*>(dq),
               nullptr, nullptr, static_cast<float*>(ds), B, H, T, scale,
               causal, vec};
  return run<false>(a, D, tile, stream);
}

// As flash_bwd_dq_f32, writing dk and dv [B, H, T, D] float32, and with a
// non-null ds [B * H, T, T] also ds[q][k] of every tile it visits.
extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* seg, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, void* ds, int B, int H, int T,
                                 int D, float scale, int causal, int tile,
                                 int vec, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const int*>(seg),
               static_cast<const float*>(dout), static_cast<const float*>(lse),
               static_cast<const float*>(delta), nullptr,
               static_cast<float*>(dk), static_cast<float*>(dv),
               static_cast<float*>(ds), B, H, T, scale, causal, vec};
  return run<true>(a, D, tile, stream);
}

// Dynamic shared memory of instance tile at head dim D (both kernels), or
// -1: the plan's figure is checked against it.
extern "C" int flash_bwd_smem_bytes(int D, int tile) {
  if (D == 64) return tile == 0 ? Large<64>::SMEM_BYTES
                                : tile == 1 ? Small<64>::SMEM_BYTES : -1;
  if (D == 128) return tile == 0 ? Large<128>::SMEM_BYTES
                                 : tile == 1 ? Small<128>::SMEM_BYTES : -1;
  return -1;
}

// q, k, v, dout, dq: [B, H, T, D] bfloat16, contiguous. seg: [B, T] int32
// or null. lse, delta: [B, H, T] float32. ds: null, or [B * H, T, T]
// bfloat16 that flash_bwd_dkv_bf16_f32 filled on these inputs (then only
// ds . k runs; T % 8 == 0, 16-byte aligned). tile: 0 (LargeB) or 1
// (SmallB); vec: 8 (16-byte copies: q, k, v and dout 16-byte aligned) or 2
// (4-byte aligned). Returns a cudaError_t (0 = launched).
extern "C" int flash_bwd_dq_bf16_f32(const void* q, const void* k,
                                     const void* v, const void* seg,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq, void* ds,
                                     int B, int H, int T, int D, float scale,
                                     int causal, int tile, int vec,
                                     void* stream) {
  const ArgsB a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const int*>(seg),
                static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), static_cast<bf16*>(dq),
                nullptr, nullptr, static_cast<bf16*>(ds), B, H, T, scale,
                causal, vec};
  return run_bf16<false>(a, D, tile, stream);
}

// As flash_bwd_dq_bf16_f32, writing dk and dv [B, H, T, D] bfloat16, and
// with a non-null ds [B * H, T, T] bfloat16 also ds[q][k] of every tile it
// visits.
extern "C" int flash_bwd_dkv_bf16_f32(const void* q, const void* k,
                                      const void* v, const void* seg,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dk, void* dv,
                                      void* ds, int B, int H, int T, int D,
                                      float scale, int causal, int tile,
                                      int vec, void* stream) {
  const ArgsB a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const int*>(seg),
                static_cast<const bf16*>(dout), static_cast<const float*>(lse),
                static_cast<const float*>(delta), nullptr,
                static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                static_cast<bf16*>(ds), B, H, T, scale, causal, vec};
  return run_bf16<true>(a, D, tile, stream);
}

// Dynamic shared memory of bf16 instance tile at head dim D (both
// kernels), or -1.
extern "C" int flash_bwd_bf16_smem_bytes(int D, int tile) {
  if (D == 64) return tile == 0 ? LargeB<64>::SMEM_BYTES
                                : tile == 1 ? SmallB<64>::SMEM_BYTES : -1;
  if (D == 128) return tile == 0 ? LargeB<128>::SMEM_BYTES
                                 : tile == 1 ? SmallB<128>::SMEM_BYTES : -1;
  return -1;
}
