// Flash-attention backward for sm_90a: two kernels on the tensor cores,
// over float32 operands in split TF32 and over bfloat16 operands (after
// the f32 kernels) on wgmma fed by TMA where they are 16-byte aligned,
// else on bf16 mma.sync; and, for bf16 operands, delta = rowsum(dO * O)
// in one pass (flash_bwd_delta_kernel, at the end).
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
#include "wgmma_bf16.cuh"

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
//   - streamed tiles land raw by 4-byte cp.async (these kernels take the
//     views TMA cannot load, 4 bytes off a 16-byte boundary; aligned
//     operands go to the wgmma kernels below) and feed the scores by
//     ldmatrix and the accumulating products by ldmatrix.trans;
//   - every product is one bf16 mma.sync.m16n8k16 into f32 (flash_tiles.cuh:
//     scores_bf16, accumulate_bf16), the scores in partials of 32 of D,
//     the accumulators one fresh partial a tile, added by FADD;
//   - p and ds pack from the score accumulators into A fragments, rounded
//     to nearest even.
// The stored ds is bf16, ds[q][k] as dk/dv rounds it for its own product:
// ds.astype(k.dtype) and ds.astype(q.dtype) are the same rounding, so dq
// from the stored ds multiplies what it would have formed itself, at half
// the f32 buffer's bytes; the wgmma kernels read its rows by TMA, 16
// bytes apart, so the plan stores it only where T % 8 == 0. No atomics:
// reruns are bit-equal.

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
    stage_rows<C, 2>(kv, a.k + base, kt * C::BS, T);
    stage_rows<C, 2>(kv + C::TILE, a.v + base, kt * C::BS, T);
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
    stage_rows<C, 2>(qd, a.q + base, r0, T);
    stage_rows<C, 2>(qd + C::TILE, a.dout + base, r0, T);
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
    stage_rows<C, 2>(kt_s, a.k + base, k0, T);
    constexpr int PER_ROW = C::BS / 2;         // ds rows, 4 bytes a copy
    for (int i = threadIdx.x; i < C::ROWS * PER_ROW; i += C::NT) {
      const int r = i / PER_ROW, c = i % PER_ROW * 2;
      const bool live = q0 + r < T && k0 + c < T;
      cp_async_bytes<4>(kt_s + C::TILE + r * C::LDDS + c,
                        live ? ds + (size_t)(q0 + r) * T + k0 + c : ds,
                        live);
    }
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
  if (tile == 0) return launch_bf16<DKV, LargeB<D>>(a, stream);
  if (tile == 1) return launch_bf16<DKV, SmallB<D>>(a, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16 operands on wgmma fed by TMA (16-byte aligned operands)
// ---------------------------------------------------------------------------
//
// The same three functions on Hopper's warpgroup product. What held the
// mma.sync kernels above back was issue, as it held the forward's back:
// per tile a warp ran its bf16 mma.sync with their ldmatrix, cp.async and
// the FADDs of the partials, 93 TFLOP/s of 8 D a pair for dk/dv against
// the card's 989. Here one m64nNk16 wgmma does the work of 4 N / 8
// mma.sync and their ldmatrix, and TMA takes the copies and their address
// arithmetic off the warps (wgmma_bf16.cuh):
//   - A block owns ROWS = 64 WG resident rows (key rows in dk/dv, query
//     rows in dq): WG consumer warpgroups of 64 rows and a producer
//     warpgroup, of which one warp walks the tiles and issues every TMA
//     load (setmaxnreg gives the producer's registers to the consumers).
//   - The resident operands (K and V in dk/dv, Q and dO in dq) land once
//     by TMA; the streamed tiles of BS = 64 rows (Q and dO, or K and V, or
//     the stored ds and K) through a ring of stages, each with a "full"
//     and an "empty" mbarrier. Every matrix lands as TMA's 128-byte
//     swizzle writes a box of {64 values, rows}: a 64-column slab per 64
//     of D, K-major as the scores read it and MN-major as the accumulating
//     products read the same bytes (the transpose flag). The tensor maps
//     are 3-D ({D, T, B * H}; the ds buffer {T, T, B * H}), so rows past T
//     land as zeros. The producer warp's lanes also write each stage's row
//     vectors (-LSE log2 e, delta and segment ids of its 64 rows; a row
//     past T gets -inf, so its p is 0) with ordinary stores and arrive on
//     the stage's full barrier beside the copies' bytes.
//   - Tiles whose segment ids cannot meet the block's are skipped by
//     producer and consumers alike (next_tile), in the mma.sync kernels'
//     order; both warpgroups take every tile of the block's (under causal
//     masking the cone hides a block's first tile from its second
//     warpgroup's keys: its p is 0 there), so no branch differs between a
//     warpgroup's warps around a product.
//   - dk/dv, per tile and warpgroup, five products: S^T = K . Q^T and
//     dP^T = V . dO^T as SS wgmma with both operands K-major, a fresh
//     chain per 64 of D added by FADD in the order of D; P^T = 2^(s scale
//     log2 e - LSE log2 e) in f32, masked only on the tiles that cross the
//     causal diagonal or carry segments; dS^T = P^T (dP^T - delta) in
//     f32; both packed into bf16 A fragments straight from the
//     accumulators (cvt.rn.bf16x2.f32), then dV += P^T . dO and dK +=
//     dS^T . Q as register-A wgmma with dO and Q MN-major, each one fresh
//     chain over the tile's 64 queries added by FADD, 64 columns of D at a
//     time. The registers bound it at D = 128: dK and dV take 128 of a
//     consumer's 240, and P^T, dP^T and dP^T's second chain 96 more. P^T
//     is formed before dP^T is issued and the products go 64 columns of
//     D at a time, which keeps the two-warpgroup instance clear of
//     spills (with P^T formed while dP^T ran and the products 128
//     columns wide, both instances spilled 292-404 bytes); the
//     one-warpgroup instance still spilled 72 bytes, so there P^T's f32
//     values wait in shared memory (a thread's own 128 bytes, free of
//     bank conflicts) while dP^T runs. The products of a warpgroup run
//     one after the other; the block's two warpgroups overlap each other.
//     Every group is retired within its iteration.
//   - The stored ds: ds[q][k] of every tile dk/dv visits, from the packed
//     dS^T (2-byte stores, predicated in the instruction: rows past T are
//     not written), issued while dV's product runs.
//   - dq from the stored ds: the block's ROWS x 64 tile of ds (K-major:
//     its rows are queries) and a K tile (MN-major) land by TMA, and only
//     dQ += dS . K runs, SS, one fresh chain a tile. The kernel waits on
//     memory (168 MB at the training shape), so its ring holds DS_STAGES
//     tiles in flight. A tile all of whose pairs are visible is read as
//     it stands (dk/dv wrote every entry of it); on the others each
//     warpgroup first zeroes, in shared memory, the entries its pairs do
//     not see (dk/dv may have skipped them: the buffer is not cleared),
//     then fences them to the async proxy.
//   - dq recomputing: Q and dO resident, K and V streamed; S = Q . K^T and
//     dP = dO . V^T as in dk/dv, dQ += dS . K register-A with K MN-major.
// The scale is applied once, at the write; dq, dk and dv are written in
// bf16 from the f32 sums. One writer per value and a fixed order: reruns
// are bit-equal.

// Resident rows ROWS = 64 WG, streamed tiles of BS = 64 rows through
// STAGES stages (DS_STAGES for dq from the stored ds).
template <int D_, int WG_, int STAGES_, int DS_STAGES_>
struct CfgBW {
  static constexpr int D = D_, WG = WG_, STAGES = STAGES_;
  static constexpr int DS_STAGES = DS_STAGES_;
  static constexpr int ROWS = 64 * WG, BS = 64;
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int NT = CONSUMERS + 128;      // and the producer
  static constexpr int SLABS = D / 64;            // 64-column slabs a row
  static constexpr int R_SLAB = ROWS * 128;       // bytes: a resident slab
  static constexpr int S_SLAB = BS * 128;         // a streamed slab
  static constexpr int RES = SLABS * R_SLAB;      // a resident matrix
  static constexpr int TILE = SLABS * S_SLAB;     // a streamed matrix
  // a stage's row vectors: -LSE log2 e, delta and segment ids of its BS
  // rows (768 bytes), padded to the swizzle's 1024-byte period
  static constexpr int VECS = 1024;
  static constexpr int STAGE = 2 * TILE + VECS;
  static constexpr int NS = BS / 2, NO = D / 2;   // accumulators a thread
  // dk/dv of the one-warpgroup instance at D = 128 parks each consumer
  // thread's P^T (NS floats) in shared memory while dP^T runs: kept in
  // registers, it spilled 72 bytes there (the two-warpgroup instance
  // does not spill, and ran 6% faster without the stash)
  static constexpr bool STASH = SLABS == 2 && WG == 1;
  static constexpr int PSTASH = STASH ? 4 * CONSUMERS * NS : 0;
  // two resident matrices, the stages and the stash from a 1024-byte
  // boundary, then 2 STAGES + 1 barriers
  static constexpr int SMEM_BYTES =
      1024 + 2 * RES + STAGES * STAGE + PSTASH + 8 * (2 * STAGES + 1);
  // dq from the stored ds: a stage holds the block's ROWS x BS tile of
  // ds, a K tile and the keys' segment ids; the block's own segment ids
  // and 2 DS_STAGES barriers follow the ring
  static constexpr int DS_TILE = ROWS * 128;
  static constexpr int DS_STAGE = DS_TILE + TILE + VECS;
  static constexpr int DS_SMEM_BYTES =
      1024 + DS_STAGES * DS_STAGE + 4 * ROWS + 8 * 2 * DS_STAGES;
  static_assert(NS == 32, "P^T stashed as 32 floats a thread");
  static_assert(D == 64 || D == 128, "whole slabs, wgmma widths");
  static_assert(SMEM_BYTES <= 232448 && DS_SMEM_BYTES <= 232448,
                "shared memory a block may use");
};

// The instances (nn/cuda_attention.py: _BWD_TILES_WGMMA, by index):
// LargeBW, two consumer warpgroups over 128 resident rows; SmallBW, one
// over 64, for shapes that leave LargeBW under a wave. Three stages (a
// tile's products take longer than its copies), six for dq from the
// stored ds; one block an SM (at D = 128 LargeBW takes 168 KB, and 204 KB
// for dq from ds).
template <int D>
using LargeBW = CfgBW<D, 2, 3, 6>;
template <int D>
using SmallBW = CfgBW<D, 1, 3, 6>;

// registers a thread after setmaxnreg: the producer warpgroup's and the
// consumers' (4 * 32 * 24 + 8 * 32 * 240 = 64,512 of the SM's 65,536)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

struct ArgsBW {
  const int* seg;
  const float *lse, *delta;
  bf16 *dq, *dk, *dv, *ds;
  int B, H, T;
  float scale;
  int causal;
};

// Column of value i of a thread's m64nN accumulators (lane quad t).
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// Issues acc (+ part at D = 128) = the warpgroup's 64 resident rows (the
// K-major slabs at ra, R_SLAB apart) against the 64 streamed rows at sa
// (S_SLAB apart), over D: one wgmma group, a fresh chain per 64 of D.
// sum_partials adds the chains by FADD in the order of D once the group
// is waited for.
template <class C>
__device__ __forceinline__ void issue_rows(float (&acc)[C::NS],
                                           float (&part)[C::NS], uint32_t ra,
                                           uint32_t sa) {
  // the operands' fences before wgmma.fence: an instruction that writes
  // an accumulator inside the group makes ptxas serialise (C7514)
  wgmma::fence_operand(acc);
  if constexpr (C::SLABS == 2) wgmma::fence_operand(part);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma::mma_ss<C::BS, 0, 0>(acc, wgmma::desc_k128(ra + 32 * kk),
                               wgmma::desc_k128(sa + 32 * kk), kk > 0);
  if constexpr (C::SLABS == 2) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::mma_ss<C::BS, 0, 0>(
          part, wgmma::desc_k128(ra + C::R_SLAB + 32 * kk),
          wgmma::desc_k128(sa + C::S_SLAB + 32 * kk), kk > 0);
  }
  wgmma::commit();
}

template <class C>
__device__ __forceinline__ void sum_partials(float (&acc)[C::NS],
                                             float (&part)[C::NS]) {
  wgmma::fence_operand(acc);
  if constexpr (C::SLABS == 2) {
    wgmma::fence_operand(part);
#pragma unroll
    for (int i = 0; i < C::NS; ++i) acc[i] += part[i];
  }
}

// Issues part = a . B[:, 64 columns], B's slab at sa read MN-major: one
// fresh chain of four k16 steps (16 streamed rows, 2048 bytes, each).
template <class C>
__device__ __forceinline__ void issue_rs64(float (&part)[32],
                                           unsigned (&a)[4][4], uint32_t sa) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[kc][r])::"memory");
  wgmma::fence_operand(part);
  wgmma::fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    wgmma::mma_rs<64, 1>(part, a[kc],
                         wgmma::desc_sw128(sa + 2048 * kc, C::S_SLAB, 1024),
                         kc > 0);
  wgmma::commit();
}

// sum[32 h + i] += part[i] (columns 64 h on of sum's m64nD layout) once
// part's group is waited for.
template <int N>
__device__ __forceinline__ void add_half(float (&sum)[N], float (&part)[32],
                                         int h) {
  wgmma::fence_operand(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[32 * h + i] += part[i];
}

// A consumer thread's 32 floats to its own part of buf and back: float4
// j of thread x at buf + 4 (CONSUMERS j + x), free of bank conflicts.
template <class C>
__device__ __forceinline__ void stash(float* buf, const float (&v)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
    reinterpret_cast<float4*>(buf)[C::CONSUMERS * j + threadIdx.x] =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
}
template <class C>
__device__ __forceinline__ void unstash(const float* buf, float (&v)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 f =
        reinterpret_cast<const float4*>(buf)[C::CONSUMERS * j + threadIdx.x];
    v[4 * j] = f.x;
    v[4 * j + 1] = f.y;
    v[4 * j + 2] = f.z;
    v[4 * j + 3] = f.w;
  }
}

// sum += part once part's group is waited for.
template <int N>
__device__ __forceinline__ void add_partial(float (&sum)[N],
                                            float (&part)[N]) {
  wgmma::fence_operand(part);
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] += part[i];
}

// Writes a warpgroup's 64 x D f32 sums, times scale, as bf16 rows
// row[h] of out (rows past T are not written).
template <class C>
__device__ __forceinline__ void store_bf16_rows(const float (&acc)[C::NO],
                                                bf16* out, const int (&row)[2],
                                                int T, float scale, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= T) continue;
#pragma unroll
    for (int j = 0; j < C::D / 8; ++j)
      *reinterpret_cast<unsigned*>(out + (size_t)row[h] * C::D + 8 * j +
                                   2 * t) =
          bf16mma::pack_bf16x2(acc[4 * j + 2 * h] * scale,
                               acc[4 * j + 2 * h + 1] * scale);
  }
}

// A 2-byte store if pred, predicated inside the instruction (no branch
// while a wgmma group is in flight).
__device__ __forceinline__ void st_b16_if(uint64_t addr, unsigned short v,
                                          bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p st.global.b16 [%0], %1;\n}\n" ::"l"(addr),
      "h"(v), "r"((int)pred)
      : "memory");
}

// Named barrier id among one consumer warpgroup's 128 threads.
__device__ __forceinline__ void bar_warpgroup(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// The producer warp's part of a stage: waits until stage it % stages is
// free (its tile of `stages` ago released by every consumer warp).
__device__ __forceinline__ void claim_stage(uint64_t* empty, int it,
                                            int stages) {
  if (it >= stages)
    wgmma::mbar_wait(&empty[it % stages], (it / stages - 1) & 1);
}

template <class C>
__global__ void __launch_bounds__(C::NT, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const ArgsBW a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ks =
      smem_raw + (1024 - wgmma::smem_addr(smem_raw) % 1024) % 1024;
  unsigned char* vs = ks + C::RES;
  unsigned char* ring = vs + C::RES;
  float* pstash = reinterpret_cast<float*>(ring + C::STAGES * C::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE +
                                               C::PSTASH);
  uint64_t* empty = full + C::STAGES;
  uint64_t* resbar = empty + C::STAGES;
  const int T = a.T, BH = a.B * a.H;
  const int bh = blockIdx.x % BH;
  const int k0 = blockIdx.x / BH * C::ROWS;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;
  // query tiles: under causal masking from the one holding key k0
  const int end = (T + C::BS - 1) / C::BS;
  const int first = a.causal ? k0 / C::BS : 0;
  const int2 own = seg ? seg_range(seg, k0, C::ROWS, T) : make_int2(0, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      wgmma::mbar_init(&full[i], 32);           // the producer warp's lanes
      wgmma::mbar_init(&empty[i], C::CONSUMERS / 32);
    }
    wgmma::mbar_init(resbar, 1);
    wgmma::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= C::CONSUMERS) {
    // the producer warpgroup: its first warp walks the tiles (next_tile
    // takes a whole warp), lane 0 issues the copies, every lane writes
    // two rows of each stage's vectors
    wgmma::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < C::CONSUMERS + 32) {
      const int lane = threadIdx.x % 32;
      const bool lead = lane == 0;
      if (lead) {
        wgmma::mbar_expect_tx(resbar, 2 * C::RES);
#pragma unroll
        for (int c = 0; c < C::SLABS; ++c) {
          wgmma::tma_load_3d(ks + c * C::R_SLAB, &kmap, resbar, 64 * c, k0,
                             bh);
          wgmma::tma_load_3d(vs + c * C::R_SLAB, &vmap, resbar, 64 * c, k0,
                             bh);
        }
      }
      const float* lse = a.lse + (size_t)bh * T;
      const float* delta = a.delta + (size_t)bh * T;
      int it = 0;
      for (int qt = next_tile<C::BS>(seg, own, first, end, T); qt < end;
           qt = next_tile<C::BS>(seg, own, qt + 1, end, T), ++it) {
        const int r0 = qt * C::BS;
        float ml[2], dl[2];
        int sg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + lane + 32 * e;
          const bool live = r < T;
          ml[e] = live ? -__ldg(lse + r) * LOG2E : -INFINITY;
          dl[e] = live ? __ldg(delta + r) : 0.f;
          sg[e] = seg && live ? __ldg(seg + r) : 0;
        }
        claim_stage(empty, it, C::STAGES);
        const int st = it % C::STAGES;
        unsigned char* s = ring + st * C::STAGE;
        float* vec = reinterpret_cast<float*>(s + 2 * C::TILE);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          vec[lane + 32 * e] = ml[e];
          vec[C::BS + lane + 32 * e] = dl[e];
          reinterpret_cast<int*>(vec)[2 * C::BS + lane + 32 * e] = sg[e];
        }
        if (lead) {
          wgmma::mbar_expect_tx(&full[st], 2 * C::TILE);
#pragma unroll
          for (int c = 0; c < C::SLABS; ++c) {
            wgmma::tma_load_3d(s + c * C::S_SLAB, &qmap, &full[st], 64 * c,
                               r0, bh);
            wgmma::tma_load_3d(s + C::TILE + c * C::S_SLAB, &domap,
                               &full[st], 64 * c, r0, bh);
          }
        } else {
          wgmma::mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    wgmma::setmaxnreg_inc<CONSUMER_REGS>();
    // warp-uniform as ptxas sees it (a lane's broadcast): the branches
    // around wgmma below must be, or ptxas serialises every wgmma
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int warp = threadIdx.x % 128 / 32;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int kw = k0 + 64 * wg;               // the warpgroup's first key
    int krow[2], kseg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      krow[h] = kw + 16 * warp + g + 8 * h;
      kseg[h] = seg && krow[h] < T ? seg[krow[h]] : 0;
    }
    const uint32_t ka = wgmma::smem_addr(ks) + wg * 64 * 128;
    const uint32_t va = wgmma::smem_addr(vs) + wg * 64 * 128;
    const float sl2e = a.scale * LOG2E;
    // ds[q][k] of this head (bytes; a null a.ds stores nothing)
    const uint64_t ds_base =
        reinterpret_cast<uint64_t>(a.ds) + 2 * (uint64_t)bh * T * T;
    float dk[C::NO], dv[C::NO];
#pragma unroll
    for (int i = 0; i < C::NO; ++i) dk[i] = dv[i] = 0.f;
    wgmma::mbar_wait(resbar, 0);
    int it = 0;
    for (int qt = next_tile<C::BS>(seg, own, first, end, T); qt < end;
         qt = next_tile<C::BS>(seg, own, qt + 1, end, T), ++it) {
      const int q0 = qt * C::BS, st = it % C::STAGES;
      const unsigned char* stage = ring + st * C::STAGE;
      const uint32_t qa = wgmma::smem_addr(stage), oa = qa + C::TILE;
      const float* mlse = reinterpret_cast<const float*>(stage + 2 * C::TILE);
      const float* dlt = mlse + C::BS;
      const int* qsg = reinterpret_cast<const int*>(dlt + C::BS);
      wgmma::mbar_wait(&full[st], (it / C::STAGES) & 1);
      float s[C::NS], x[C::NS];
      issue_rows<C>(s, x, ka, qa);             // S^T = K . Q^T
      wgmma::wait<0>();
      sum_partials<C>(s, x);
      // P^T; every pair of the tile visible (the warpgroup's keys at or
      // before its first query, no segments): no masks (a
      // warpgroup-uniform branch)
      const bool inside = !seg && (!a.causal || kw + 63 <= q0);
      if (inside) {
#pragma unroll
        for (int i = 0; i < C::NS; ++i)
          s[i] = exp2_ftz(fmaf(s[i], sl2e, mlse[acc_col(i, t)]));
      } else {
#pragma unroll
        for (int i = 0; i < C::NS; ++i) {
          const int h = (i >> 1) & 1, c = acc_col(i, t);
          bool vis = !a.causal || krow[h] <= q0 + c;
          if (seg) vis = vis && qsg[c] == kseg[h] && kseg[h] > 0;
          s[i] = exp2_ftz(vis ? fmaf(s[i], sl2e, mlse[c]) : -INFINITY);
        }
      }
      // P^T as bf16 A fragments over the tile's queries (k16 step kc:
      // rows g, g + 8, queries 16 kc + 2t, + 1, then + 8, + 9)
      unsigned pa[4][4], da[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kc][r] = bf16mma::pack_bf16x2(s[8 * kc + 2 * r],
                                           s[8 * kc + 2 * r + 1]);
      // P^T's f32 values wait in shared memory while dP^T runs, where the
      // instance would spill (dK, dV, P^T, dP^T and its second chain take
      // 224 registers at D = 128)
      if constexpr (C::STASH) stash<C>(pstash, s);
      float dp[C::NS];
      issue_rows<C>(dp, x, va, oa);            // dP^T = V . dO^T
      wgmma::wait<0>();
      sum_partials<C>(dp, x);
      if constexpr (C::STASH) unstash<C>(pstash, s);
      // dS^T = P^T (dP^T - delta), packed as P^T
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kc + 2 * r, c = acc_col(i, t);
          da[kc][r] = bf16mma::pack_bf16x2(
              s[i] * (dp[i] - dlt[c]), s[i + 1] * (dp[i + 1] - dlt[c + 1]));
        }
      // dV += P^T . dO and dK += dS^T . Q, 64 columns of D at a time (a
      // 32-register partial each)
#pragma unroll
      for (int h = 0; h < C::SLABS; ++h) {
        float part[32];
        issue_rs64<C>(part, pa, oa + h * C::S_SLAB);
        if (h == 0) {
          // ds[q][k] as dk's product rounds it, while the partial runs
#pragma unroll
          for (int kc = 0; kc < 4; ++kc)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int q = q0 + 16 * kc + 8 * (r >> 1) + 2 * t;
              const int k = krow[r & 1];
              const bool ok = a.ds != nullptr && k < T;
              const uint64_t at = ds_base + 2 * ((uint64_t)q * T + k);
              st_b16_if(at, (unsigned short)(da[kc][r] & 0xffffu),
                        ok && q < T);
              st_b16_if(at + 2 * (uint64_t)T,
                        (unsigned short)(da[kc][r] >> 16), ok && q + 1 < T);
            }
        }
        wgmma::wait<0>();
        add_half(dv, part, h);
      }
#pragma unroll
      for (int h = 0; h < C::SLABS; ++h) {
        float part[32];
        issue_rs64<C>(part, da, qa + h * C::S_SLAB);
        wgmma::wait<0>();
        add_half(dk, part, h);
      }
      wgmma::mbar_arrive_if(&empty[st], lane == 0);
    }
    store_bf16_rows<C>(dk, a.dk + (size_t)bh * T * C::D, krow, T, a.scale,
                       t);
    store_bf16_rows<C>(dv, a.dv + (size_t)bh * T * C::D, krow, T, 1.f, t);
  }
}

// dq from the ds that flash_bwd_dkv_wgmma_kernel stored.
template <class C>
__global__ void __launch_bounds__(C::NT, 1)
flash_bwd_dq_ds_wgmma_kernel(const __grid_constant__ CUtensorMap dsmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const ArgsBW a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + (1024 - wgmma::smem_addr(smem_raw) % 1024) % 1024;
  int* qsg = reinterpret_cast<int*>(ring + C::DS_STAGES * C::DS_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(qsg + C::ROWS);
  uint64_t* empty = full + C::DS_STAGES;
  const int T = a.T, BH = a.B * a.H;
  const int bh = blockIdx.x % BH, rank = blockIdx.x / BH;
  const int n_rt = (T + C::ROWS - 1) / C::ROWS;
  const int q0 = (a.causal ? n_rt - 1 - rank : rank) * C::ROWS;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;
  const int n_kt = (T + C::BS - 1) / C::BS;
  const int end = a.causal ? min((q0 + C::ROWS - 1) / C::BS + 1, n_kt) : n_kt;
  const int2 own = seg ? seg_range(seg, q0, C::ROWS, T) : make_int2(0, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::DS_STAGES; ++i) {
      wgmma::mbar_init(&full[i], 32);
      wgmma::mbar_init(&empty[i], C::CONSUMERS / 32);
    }
    wgmma::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= C::CONSUMERS) {
    wgmma::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < C::CONSUMERS + 32) {
      const int lane = threadIdx.x % 32;
      int it = 0;
      for (int kt = next_tile<C::BS>(seg, own, 0, end, T); kt < end;
           kt = next_tile<C::BS>(seg, own, kt + 1, end, T), ++it) {
        const int k0 = kt * C::BS;
        int sg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = k0 + lane + 32 * e;
          sg[e] = seg && r < T ? __ldg(seg + r) : 0;
        }
        claim_stage(empty, it, C::DS_STAGES);
        const int st = it % C::DS_STAGES;
        unsigned char* s = ring + st * C::DS_STAGE;
        int* ksg = reinterpret_cast<int*>(s + C::DS_TILE + C::TILE);
#pragma unroll
        for (int e = 0; e < 2; ++e) ksg[lane + 32 * e] = sg[e];
        if (lane == 0) {
          wgmma::mbar_expect_tx(&full[st], C::DS_TILE + C::TILE);
          wgmma::tma_load_3d(s, &dsmap, &full[st], k0, q0, bh);
#pragma unroll
          for (int c = 0; c < C::SLABS; ++c)
            wgmma::tma_load_3d(s + C::DS_TILE + c * C::S_SLAB, &kmap,
                               &full[st], 64 * c, k0, bh);
        } else {
          wgmma::mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    wgmma::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int warp = threadIdx.x % 128 / 32, tid = threadIdx.x % 128;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * wg;               // the warpgroup's first row
    for (int i = threadIdx.x; i < C::ROWS; i += C::CONSUMERS)
      qsg[i] = seg && q0 + i < T ? seg[q0 + i] : 0;
    wgmma::bar_sync<1, C::CONSUMERS>();
    float dq[C::NO];
#pragma unroll
    for (int i = 0; i < C::NO; ++i) dq[i] = 0.f;
    int it = 0;
    for (int kt = next_tile<C::BS>(seg, own, 0, end, T); kt < end;
         kt = next_tile<C::BS>(seg, own, kt + 1, end, T), ++it) {
      const int k0 = kt * C::BS, st = it % C::DS_STAGES;
      unsigned char* stage = ring + st * C::DS_STAGE;
      unsigned char* tile = stage + wg * 64 * 128;   // its 64 rows of ds
      wgmma::mbar_wait(&full[st], (it / C::DS_STAGES) & 1);
      // every pair visible (the tile's keys at or before the warpgroup's
      // first row, no segments): dk/dv wrote every entry. Else zero what
      // the rows do not see: a row of 128 bytes holds 64 keys, 16-byte
      // chunk c at chunk position c ^ (row % 8)
      if (a.seg || (a.causal && k0 + 63 > r0)) {
        const int* ksg =
            reinterpret_cast<const int*>(stage + C::DS_TILE + C::TILE);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int idx = tid + 128 * j, row = idx >> 3, pos = idx & 7;
          const int c = pos ^ (row & 7), q = r0 + row;
          const int qs = qsg[64 * wg + row];
          uint4* p = reinterpret_cast<uint4*>(tile + 128 * row + 16 * pos);
          uint4 w = *p;
          unsigned* wv = reinterpret_cast<unsigned*>(&w);
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            const int kj = 8 * c + b;
            bool vis = !a.causal || k0 + kj <= q;
            if (seg) vis = vis && ksg[kj] == qs && qs > 0;
            wv[b / 2] &= vis ? 0xffffffffu
                             : (b & 1) ? 0x0000ffffu : 0xffff0000u;
          }
          *p = w;
        }
        wgmma::fence_proxy_async();
        bar_warpgroup(2 + wg);
      }
      const uint32_t da = wgmma::smem_addr(tile);
      const uint32_t kb = wgmma::smem_addr(stage + C::DS_TILE);
      float part[C::NO];
      wgmma::fence_operand(part);
      wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)                // dQ's partial: dS . K
        wgmma::mma_ss<C::D, 0, 1>(
            part, wgmma::desc_k128(da + 32 * kk),
            wgmma::desc_sw128(kb + 2048 * kk, C::S_SLAB, 1024), kk > 0);
      wgmma::commit();
      wgmma::wait<0>();
      add_partial(dq, part);
      wgmma::mbar_arrive_if(&empty[st], lane == 0);
    }
    int qrow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) qrow[h] = r0 + 16 * warp + g + 8 * h;
    store_bf16_rows<C>(dq, a.dq + (size_t)bh * T * C::D, qrow, T, a.scale,
                       t);
  }
}

// dq recomputing s and dp (no stored ds).
template <class C>
__global__ void __launch_bounds__(C::NT, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const ArgsBW a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + (1024 - wgmma::smem_addr(smem_raw) % 1024) % 1024;
  unsigned char* os = qs + C::RES;
  unsigned char* ring = os + C::RES;
  // (the stash of CfgBW's layout is dk/dv's; this kernel leaves it idle)
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE +
                                               C::PSTASH);
  uint64_t* empty = full + C::STAGES;
  uint64_t* resbar = empty + C::STAGES;
  const int T = a.T, BH = a.B * a.H;
  const int bh = blockIdx.x % BH, rank = blockIdx.x / BH;
  const int n_rt = (T + C::ROWS - 1) / C::ROWS;
  const int q0 = (a.causal ? n_rt - 1 - rank : rank) * C::ROWS;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;
  const int n_kt = (T + C::BS - 1) / C::BS;
  const int end = a.causal ? min((q0 + C::ROWS - 1) / C::BS + 1, n_kt) : n_kt;
  const int2 own = seg ? seg_range(seg, q0, C::ROWS, T) : make_int2(0, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      wgmma::mbar_init(&full[i], 32);
      wgmma::mbar_init(&empty[i], C::CONSUMERS / 32);
    }
    wgmma::mbar_init(resbar, 1);
    wgmma::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= C::CONSUMERS) {
    wgmma::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < C::CONSUMERS + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        wgmma::mbar_expect_tx(resbar, 2 * C::RES);
#pragma unroll
        for (int c = 0; c < C::SLABS; ++c) {
          wgmma::tma_load_3d(qs + c * C::R_SLAB, &qmap, resbar, 64 * c, q0,
                             bh);
          wgmma::tma_load_3d(os + c * C::R_SLAB, &domap, resbar, 64 * c, q0,
                             bh);
        }
      }
      int it = 0;
      for (int kt = next_tile<C::BS>(seg, own, 0, end, T); kt < end;
           kt = next_tile<C::BS>(seg, own, kt + 1, end, T), ++it) {
        const int k0 = kt * C::BS;
        int sg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = k0 + lane + 32 * e;
          sg[e] = seg && r < T ? __ldg(seg + r) : 0;
        }
        claim_stage(empty, it, C::STAGES);
        const int st = it % C::STAGES;
        unsigned char* s = ring + st * C::STAGE;
        int* ksg = reinterpret_cast<int*>(s + 2 * C::TILE);
#pragma unroll
        for (int e = 0; e < 2; ++e) ksg[lane + 32 * e] = sg[e];
        if (lane == 0) {
          wgmma::mbar_expect_tx(&full[st], 2 * C::TILE);
#pragma unroll
          for (int c = 0; c < C::SLABS; ++c) {
            wgmma::tma_load_3d(s + c * C::S_SLAB, &kmap, &full[st], 64 * c,
                               k0, bh);
            wgmma::tma_load_3d(s + C::TILE + c * C::S_SLAB, &vmap,
                               &full[st], 64 * c, k0, bh);
          }
        } else {
          wgmma::mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    wgmma::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
    const int warp = threadIdx.x % 128 / 32;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * wg;               // the warpgroup's first row
    int qrow[2], qseg[2];
    float mlse[2], dlt[2];                     // -LSE log2 e, delta
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * warp + g + 8 * h;
      const bool live = row < T;
      qrow[h] = row;
      mlse[h] = live ? -a.lse[(size_t)bh * T + row] * LOG2E : -INFINITY;
      dlt[h] = live ? a.delta[(size_t)bh * T + row] : 0.f;
      qseg[h] = seg && live ? seg[row] : 0;
    }
    const uint32_t qa = wgmma::smem_addr(qs) + wg * 64 * 128;
    const uint32_t oa = wgmma::smem_addr(os) + wg * 64 * 128;
    const float sl2e = a.scale * LOG2E;
    float dq[C::NO];
#pragma unroll
    for (int i = 0; i < C::NO; ++i) dq[i] = 0.f;
    wgmma::mbar_wait(resbar, 0);
    int it = 0;
    for (int kt = next_tile<C::BS>(seg, own, 0, end, T); kt < end;
         kt = next_tile<C::BS>(seg, own, kt + 1, end, T), ++it) {
      const int k0 = kt * C::BS, st = it % C::STAGES;
      const unsigned char* stage = ring + st * C::STAGE;
      const uint32_t kta = wgmma::smem_addr(stage), vta = kta + C::TILE;
      const int* ksg = reinterpret_cast<const int*>(stage + 2 * C::TILE);
      wgmma::mbar_wait(&full[st], (it / C::STAGES) & 1);
      float s[C::NS], x[C::NS], dp[C::NS];
      issue_rows<C>(s, x, qa, kta);            // S = Q . K^T
      wgmma::wait<0>();
      sum_partials<C>(s, x);
      issue_rows<C>(dp, x, oa, vta);           // dP = dO . V^T
      const bool inside = !seg && (!a.causal || k0 + 63 <= r0);
      if (inside) {
#pragma unroll
        for (int i = 0; i < C::NS; ++i)
          s[i] = exp2_ftz(fmaf(s[i], sl2e, mlse[(i >> 1) & 1]));
      } else {
#pragma unroll
        for (int i = 0; i < C::NS; ++i) {
          const int h = (i >> 1) & 1, c = acc_col(i, t);
          bool vis = !a.causal || k0 + c <= qrow[h];
          if (seg) vis = vis && ksg[c] == qseg[h] && qseg[h] > 0;
          s[i] = exp2_ftz(vis ? fmaf(s[i], sl2e, mlse[h]) : -INFINITY);
        }
      }
      wgmma::wait<0>();
      sum_partials<C>(dp, x);
      unsigned da[4][4];                       // dS = P (dP - delta)
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kc + 2 * r, h = r & 1;
          da[kc][r] = bf16mma::pack_bf16x2(s[i] * (dp[i] - dlt[h]),
                                           s[i + 1] * (dp[i + 1] - dlt[h]));
        }
#pragma unroll
      for (int h = 0; h < C::SLABS; ++h) {     // dQ += dS . K
        float part[32];
        issue_rs64<C>(part, da, kta + h * C::S_SLAB);
        wgmma::wait<0>();
        add_half(dq, part, h);
      }
      wgmma::mbar_arrive_if(&empty[st], lane == 0);
    }
    store_bf16_rows<C>(dq, a.dq + (size_t)bh * T * C::D, qrow, T, a.scale,
                       t);
  }
}

// The maps of [B * H, T, D] bf16 tensors as {D, T, B * H}: boxes of 64
// columns by `rows` rows of one head, rows past T filled with zeros.
inline cudaError_t head_maps(CUtensorMap* maps, const bf16* const* src,
                             const int* rows, int n, int B, int H, int T,
                             int D) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T,
                              (cuuint64_t)B * H};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  for (int i = 0; i < n; ++i) {
    const cuuint32_t box[3] = {64, (cuuint32_t)rows[i], 1};
    const cudaError_t err =
        wgmma::bf16_map(&maps[i], src[i], 3, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <class K>
cudaError_t opt_in(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <bool DKV, class C>
cudaError_t launch_wgmma(const ArgsB& b, cudaStream_t stream) {
  const ArgsBW a{b.seg, b.lse, b.delta, b.dq, b.dk, b.dv, b.ds,
                 b.B, b.H, b.T, b.scale, b.causal};
  const unsigned blocks =
      (unsigned)((long long)b.B * b.H * ((b.T + C::ROWS - 1) / C::ROWS));
  CUtensorMap maps[4];
  cudaError_t err;
  if (DKV || !b.ds) {
    // dk/dv: K and V resident, Q and dO streamed; dq: the reverse
    const bf16* src[4] = {b.q, b.k, b.v, b.dout};
    const int rows[4] = {DKV ? C::BS : C::ROWS, DKV ? C::ROWS : C::BS,
                         DKV ? C::ROWS : C::BS, DKV ? C::BS : C::ROWS};
    err = head_maps(maps, src, rows, 4, b.B, b.H, b.T, C::D);
    if (err != cudaSuccess) return err;
    const auto kernel = DKV ? flash_bwd_dkv_wgmma_kernel<C>
                            : flash_bwd_dq_wgmma_kernel<C>;
    err = opt_in(kernel, C::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, C::NT, C::SMEM_BYTES, stream>>>(maps[0], maps[1],
                                                     maps[2], maps[3], a);
    return cudaGetLastError();
  }
  // dq from the stored ds: ds[q][k] as {T (keys), T (queries), B * H},
  // boxes of 64 keys by ROWS queries
  const cuuint64_t dims[3] = {(cuuint64_t)b.T, (cuuint64_t)b.T,
                              (cuuint64_t)b.B * b.H};
  const cuuint64_t strides[2] = {(cuuint64_t)b.T * 2,
                                 (cuuint64_t)b.T * b.T * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)C::ROWS, 1};
  err = wgmma::bf16_map(&maps[0], b.ds, 3, dims, strides, box);
  if (err != cudaSuccess) return err;
  const int rows[1] = {C::BS};
  err = head_maps(&maps[1], &b.k, rows, 1, b.B, b.H, b.T, C::D);
  if (err != cudaSuccess) return err;
  err = opt_in(flash_bwd_dq_ds_wgmma_kernel<C>, C::DS_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_ds_wgmma_kernel<C><<<blocks, C::NT, C::DS_SMEM_BYTES,
                                    stream>>>(maps[0], maps[1], a);
  return cudaGetLastError();
}

template <bool DKV, int D>
cudaError_t dispatch_wgmma(const ArgsB& a, int tile, cudaStream_t stream) {
  if (tile == 0) return launch_wgmma<DKV, LargeBW<D>>(a, stream);
  if (tile == 1) return launch_wgmma<DKV, SmallBW<D>>(a, stream);
  return cudaErrorInvalidValue;
}

// vec picks the route: 8, wgmma (q, k, v, dout and the outputs 16-byte
// aligned); 2, mma.sync on 4-byte copies.
template <bool DKV>
int run_bf16(const ArgsB& a, int D, int tile, int vec, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    if (D == 64) return static_cast<int>(dispatch_wgmma<DKV, 64>(a, tile, st));
    if (D == 128)
      return static_cast<int>(dispatch_wgmma<DKV, 128>(a, tile, st));
  } else if (vec == 2) {
    if (D == 64) return static_cast<int>(dispatch_bf16<DKV, 64>(a, tile, st));
    if (D == 128)
      return static_cast<int>(dispatch_bf16<DKV, 128>(a, tile, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// delta = rowsum(dO * O) in f32 over bf16 O and dO [rows, D]: a warp a
// row, each lane two values at a time (4-byte loads: any view the flash
// wrappers take), four rows a warp with their loads issued together; the
// products are exact in f32 and summed by FFMA, then across the warp.
// Replaces no Pallas kernel: paddle_tpu/nn/pallas_attention.py:439
// computes delta outside its kernels, in XLA; PyTorch's
// (do.float() * o.float()).sum(-1) wrote and read two f32 copies of both
// tensors. Bound by bytes (4 D + 4 bytes a row).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const unsigned* __restrict__ o,
                       const unsigned* __restrict__ dout,
                       float* __restrict__ delta, int rows) {
  constexpr int W = D / 64, R = 4;             // pairs a lane, rows a warp
  const int lane = threadIdx.x % 32;
  const int row0 = (blockIdx.x * 8 + threadIdx.x / 32) * R;
  unsigned ov[R][W], dv[R][W];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const bool live = row0 + r < rows;
      const size_t at =
          (size_t)(live ? row0 + r : 0) * (D / 2) + lane + 32 * w;
      ov[r][w] = live ? __ldg(o + at) : 0u;
      dv[r][w] = live ? __ldg(dout + at) : 0u;
    }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      acc = fmaf(__uint_as_float(ov[r][w] << 16),
                 __uint_as_float(dv[r][w] << 16), acc);
      acc = fmaf(__uint_as_float(ov[r][w] & 0xffff0000u),
                 __uint_as_float(dv[r][w] & 0xffff0000u), acc);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0 && row0 + r < rows) delta[row0 + r] = acc;
  }
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
// ds . k runs; T % 8 == 0, 16-byte aligned). vec picks the route: 8 for
// wgmma (q, k, v, dout and the outputs 16-byte aligned), tile 0 (LargeBW)
// or 1 (SmallBW); 2 for mma.sync on 4-byte copies (4-byte aligned), tile 0
// (LargeB) or 1 (SmallB). Returns a cudaError_t (0 = launched).
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
                causal};
  return run_bf16<false>(a, D, tile, vec, stream);
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
                static_cast<bf16*>(ds), B, H, T, scale, causal};
  return run_bf16<true>(a, D, tile, vec, stream);
}

// Dynamic shared memory of bf16 mma.sync instance tile at head dim D
// (both kernels), or -1.
extern "C" int flash_bwd_bf16_smem_bytes(int D, int tile) {
  if (D == 64) return tile == 0 ? LargeB<64>::SMEM_BYTES
                                : tile == 1 ? SmallB<64>::SMEM_BYTES : -1;
  if (D == 128) return tile == 0 ? LargeB<128>::SMEM_BYTES
                                 : tile == 1 ? SmallB<128>::SMEM_BYTES : -1;
  return -1;
}

// Dynamic shared memory of bf16 wgmma instance tile at head dim D, or -1:
// of flash_bwd_dkv_wgmma_kernel and flash_bwd_dq_wgmma_kernel (from_ds 0)
// or of flash_bwd_dq_ds_wgmma_kernel (from_ds 1).
extern "C" int flash_bwd_wgmma_smem_bytes(int D, int tile, int from_ds) {
  if (D == 64)
    return tile == 0 ? (from_ds ? LargeBW<64>::DS_SMEM_BYTES
                                : LargeBW<64>::SMEM_BYTES)
           : tile == 1 ? (from_ds ? SmallBW<64>::DS_SMEM_BYTES
                                  : SmallBW<64>::SMEM_BYTES)
                       : -1;
  if (D == 128)
    return tile == 0 ? (from_ds ? LargeBW<128>::DS_SMEM_BYTES
                                : LargeBW<128>::SMEM_BYTES)
           : tile == 1 ? (from_ds ? SmallBW<128>::DS_SMEM_BYTES
                                  : SmallBW<128>::SMEM_BYTES)
                       : -1;
  return -1;
}

// o, dout: [rows, D] bfloat16, contiguous, 4-byte aligned; delta: [rows]
// float32. delta = rowsum(dout * o) in f32. Returns a cudaError_t.
extern "C" int flash_bwd_delta_bf16_f32(const void* o, const void* dout,
                                        void* delta, int rows, int D,
                                        void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* ow = static_cast<const unsigned*>(o);
  const unsigned* dw = static_cast<const unsigned*>(dout);
  float* out = static_cast<float*>(delta);
  const unsigned blocks = (unsigned)((rows + 31) / 32);
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  if (D == 64)
    flash_bwd_delta_kernel<64><<<blocks, 256, 0, st>>>(ow, dw, out, rows);
  else if (D == 128)
    flash_bwd_delta_kernel<128><<<blocks, 256, 0, st>>>(ow, dw, out, rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
