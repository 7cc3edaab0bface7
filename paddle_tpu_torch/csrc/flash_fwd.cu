// Flash-attention forward for sm_90a: float32 operands on the tensor cores
// in split TF32, and bfloat16 operands on bf16 mma.sync (at the end of the
// file).
//
// Replaces paddle_tpu/nn/pallas_attention.py:_attn_kernel (launched by
// _flash_forward): blockwise online-softmax attention over [B, H, T, D]
// that writes O [B, H, T, D] and the per-row log-sum-exp LSE [B, H, T]
// (which the backward, flash_bwd.cu, consumes), with optional causal
// masking and packed-sequence segment ids [B, T] (1-based, 0 = padding)
// shared across heads.
//
// What bounds it on the H100: operations. At the training shape
// [8, 4, 2048, 128] causal its two products need 34.4 GFLOP (4 * D per
// visible pair) against 34 MB; on f32 CUDA cores (67 TFLOP/s) that is
// 0.51 ms, more than half of SDPA's f32 forward, so both products run on
// the tensor cores in split TF32 (mma_tf32.cuh: three TF32 mma.sync per
// f32 product, f32 accuracy): 3 * 34.4 GFLOP against 495 TFLOP/s, 0.21 ms,
// or 0.32 ms at the 321 TFLOP/s the card's mma.sync reaches
// (tools/mma_tf32_peak.py).
//
// Design (the tile machinery is flash_tiles.cuh's, shared with the
// backward):
//   - A block owns RG groups of 16 query rows; each group's rows are taken
//     by KS warps, the warp of split s taking keys [s * SUB, (s + 1) * SUB)
//     of every streamed tile of BS = KS * SUB keys. A row's running max m,
//     sum l and O accumulator stay in its warp's registers, and P never
//     goes through shared memory; with KS > 1 the splits' (m, l, O) meet
//     once, at the end, through the ring (split 0 takes the others in
//     order). The large instance has KS = 1; the small one, for shapes
//     with too few rows of 16 to fill the card, KS = 2, so that each row
//     has two warps walking its keys.
//   - Q is resident: split once into TF32 hi and lo planes as it lands, so
//     its A fragments load ready-split.
//   - K and V tiles of BS rows, with their segment ids, land by cp.async in
//     a ring of STAGES stages (16-byte copies where the wrapper found q, k
//     and v 16-byte aligned, else 4-byte ones in the same kernel): tile
//     t + 1 loads while tile t computes, one barrier a tile. Each warp
//     splits the K and V values it reads as their fragments load (a split
//     once a block, at one more barrier a tile, measured slower: PERF.md
//     section 6).
//   - S = Q . K^T contracts over D in partials of 32, all D / 32 in flight,
//     each partial added to the f32 scores by FADD: the tensor cores
//     truncate as they add, and a long chain into one accumulator drifts
//     (gemm_f32.cuh).
//   - The online softmax runs on the accumulator fragments: a row lives in
//     a quad of lanes, so its tile max takes two shuffles; each lane keeps
//     its own part of l, summed over the quad once at the end. p =
//     2^(s * scale * log2 e - m * log2 e) by ex2.approx.ftz (one FMUL, one
//     FFMA, one MUFU), the scale applied before the max so that any sign
//     of scale keeps the masks. Masks are formed only on tiles that cross
//     the causal diagonal, a segment or T; whole key tiles are skipped by
//     the causal cone and by segment-id ranges that cannot meet
//     (_block_needed / _seg_block_relevant), and a warp whose 16 rows the
//     cone hides from a tile skips its products but meets the barriers.
//   - O += P . V keeps P in registers, split hi/lo there: the accumulator
//     holds columns 2t and 2t + 1 of its row where the A fragment wants
//     k = t and t + 4, so V's B fragments are read in that permuted k
//     order (row 8 j + 2 t + h). One fresh partial a tile per 8 columns,
//     folded in as acc = acc * corr + partial (one FFMA): the rescale by
//     corr costs nothing extra.
//   - Epilogue: O / max(l, 1e-30) and LSE = m + ln(max(l, 1e-30)), m
//     starting at -1e30: a row with no visible key writes zeros and an LSE
//     of -1e30, as flash_attention_plain defines them.
//
// Masked pairs get a score of -inf, so p = 0 for them; K and V rows past T
// land as zeros and are masked; query rows past T are computed and never
// written. The host plan (flash_fwd_plan in nn/cuda_attention.py) picks
// the instance from the shapes alone: Large (8 warps, 128 rows) unless its
// blocks would leave the card under one wave, then Small (4 warps, 32
// rows, two key splits). Under causal masking the blocks take the query
// tiles from the last (longest) one. One writer per output value and a
// fixed order: every run gives the same bits.

#include "flash_tiles.cuh"

namespace {

using namespace flash_tiles;

constexpr float NEG = -1e30f;

// RG row groups of 16 query rows; each takes its keys in KS splits, a warp
// a split: of every streamed tile of BS = KS * SUB rows, the warp of split
// s takes rows [s * SUB, (s + 1) * SUB).
template <int D_, int RG_, int KS_, int SUB_, int STAGES_, int MIN_BLOCKS_>
struct Cfg {
  static constexpr int D = D_, RG = RG_, KS = KS_, SUB = SUB_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WARPS = RG * KS, NT = 32 * WARPS;
  static constexpr int ROWS = 16 * RG, BS = KS * SUB;
  static constexpr int NJ = SUB / 8;     // score n-tiles; P . V k-steps
  static constexpr int ND = D / 8;       // output n-tiles
  static constexpr int CHUNKS = D / 32;  // score partials (32 d) in flight
  static constexpr int LD = D + 4;       // row pitch in floats
  static constexpr int PLANE = ROWS * LD;          // a Q hi or lo plane
  static constexpr int TILE = BS * LD;             // a streamed matrix
  static constexpr int STAGE = 2 * TILE + BS;      // K, V, segment ids
  static constexpr int SMEM_BYTES = 4 * (2 * PLANE + STAGES * STAGE);
  // the splits' row states merged at the end, through the ring: a float4
  // a lane for each 8 columns of acc and one for (m, l), a warp of each
  // split past the first
  static constexpr int MERGE = (KS - 1) * RG * 32 * 4 * (D / 8 + 1);
  static_assert(SUB % 8 == 0 && SUB <= 32, "partials of at most 32 rows");
  static_assert(MERGE <= STAGES * STAGE, "the merge fits the ring");
  static_assert(SMEM_BYTES <= 232448, "shared memory a block may use");
};

// The instances (paddle_tpu_torch/nn/cuda_attention.py: _FWD_TILES, by the
// index the entry point takes): Large, 8 warps over 128 query rows and K/V
// tiles of 32, at D = 128 203 KB, at D = 64 105 KB (one block an SM: at
// two, ptxas's cap of 128 registers spills); Small, 4 warps over 32 rows,
// two key splits of 16 rows a tile of 32, 102 KB and 52 KB (two an SM,
// by shared memory at D = 128 and by registers at D = 64). Where Large
// would leave the card under a wave there are few rows of 16 to share
// out: the splits give each row two warps.
template <int D>
using Large = Cfg<D, 8, 1, 32, 2, 1>;
template <int D>
using Small = Cfg<D, 2, 2, 16, 2, 2>;

struct Args {
  const float *q, *k, *v;
  const int* seg;
  float *o, *lse;
  int B, H, T;
  float scale;
  int causal;
  int vec;      // 4: 16-byte copies (q, k, v 16-byte aligned), or 1
};

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_fwd_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  unsigned* qh = reinterpret_cast<unsigned*>(smem);
  unsigned* ql = qh + C::PLANE;
  float* ring = smem + 2 * C::PLANE;
  const int T = a.T, BH = a.B * a.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int warp = threadIdx.x / 32, split = warp / C::RG;
  const int wrow = 16 * (warp % C::RG), sub0 = split * C::SUB;
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
      stage_vec<C>(st + 2 * C::TILE, reinterpret_cast<const float*>(seg),
                   kt * C::BS, T);
  };
  const auto setup = [&] {
    by_width(a, [&](auto vec) {
      load_split<C, decltype(vec)::value>(qh, ql, a.q + base, q0, T);
    });
  };

  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this lane's columns
  int qrow[2], qseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qrow[h] = q0 + wrow + g + 8 * h;
    qseg[h] = seg && qrow[h] < T ? seg[qrow[h]] : 0;
  }
  stream<C>(ring, seg, own, 0, end, T, setup, load, [&](const float* st,
                                                        int kt) {
    const int k0 = kt * C::BS + sub0;        // the warp's first key
    // a warp whose rows lie past T, or see no key of its part, skips it
    if (q0 + wrow >= T || k0 >= T || (a.causal && k0 > q0 + wrow + 15))
      return;
    float s[C::NJ][4];
    scores<C>(s, qh, ql, st + sub0 * C::LD, wrow, g, t);
    // every key of its part in T, inside the warp's cone, no segments
    const bool inside = !seg && k0 + C::SUB <= T &&
                        (!a.causal || k0 + C::SUB - 1 <= q0 + wrow);
    float mx[2] = {-INFINITY, -INFINITY};
    if (inside) {
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= a.scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    } else {
      const int* kseg =
          reinterpret_cast<const int*>(st + 2 * C::TILE) + sub0;
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, col = 8 * j + 2 * t + (e & 1);
          const int kj = k0 + col;
          bool vis = kj < T;
          if (a.causal) vis = vis && kj <= qrow[h];
          if (seg) vis = vis && kseg[col] == qseg[h] && qseg[h] > 0;
          s[j][e] = vis ? s[j][e] * a.scale : -INFINITY;
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
    }
    float corr[2], mneg[2];                  // mneg: -m * log2 e
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = exp2_ftz((m[h] - m_new) * LOG2E);
      m[h] = m_new;
      mneg[h] = -m_new * LOG2E;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_ftz(fmaf(s[j][e], LOG2E, mneg[e >> 1]));
        l[e >> 1] += s[j][e];
      }
    unsigned ph[C::NJ][4], pl[C::NJ][4];
    a_frags<C>(s, ph, pl);
    accumulate<C>(acc, ph, pl, st + C::TILE + sub0 * C::LD, corr, g, t);
  });
  if constexpr (C::KS > 1) {
    // the first split's warp takes the others' (m, l, acc) lane by lane
    // (same rows, same columns), in split order
    __syncthreads();                         // the ring is free
    float4* x = reinterpret_cast<float4*>(ring) + lane;
    const auto at = [&](int s) {
      return x + ((s - 1) * C::RG + warp % C::RG) * 32 * (C::ND + 1);
    };
    if (split) {
      float4* p = at(split);
#pragma unroll
      for (int n = 0; n < C::ND; ++n)
        p[32 * n] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      p[32 * C::ND] = make_float4(m[0], m[1], l[0], l[1]);
    }
    __syncthreads();
    if (split) return;
#pragma unroll
    for (int s = 1; s < C::KS; ++s) {
      const float4* p = at(s);
      const float4 ml = p[32 * C::ND];
      const float mo[2] = {ml.x, ml.y}, lo[2] = {ml.z, ml.w};
      float cs[2], co[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], mo[h]);
        cs[h] = exp2_ftz((m[h] - m_new) * LOG2E);
        co[h] = exp2_ftz((mo[h] - m_new) * LOG2E);
        l[h] = fmaf(lo[h], co[h], l[h] * cs[h]);
        m[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < C::ND; ++n) {
        const float4 y = p[32 * n];
        const float ye[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[n][e] = fmaf(ye[e], co[e >> 1], acc[n][e] * cs[e >> 1]);
      }
    }
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float lf = fmaxf(lr, 1e-30f);
    inv[h] = 1.f / lf;
    if (t == 0 && qrow[h] < T)
      a.lse[(size_t)bh * T + qrow[h]] = m[h] + logf(lf);
  }
  store_rows<C>(acc, a.o + base, q0 + wrow, T, inv, g, t);
}

template <class C>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted into per kernel
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  // one block per (b*h, query tile), b*h fastest: all first tiles (the
  // longest under causal masking) start before any second one
  const long long blocks =
      (long long)a.B * a.H * ((a.T + C::ROWS - 1) / C::ROWS);
  flash_fwd_kernel<C><<<(unsigned)blocks, C::NT, C::SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(const Args& a, int tile, cudaStream_t stream) {
  if (a.vec != 4 && a.vec != 1) return cudaErrorInvalidValue;
  if (tile == 0) return launch<Large<D>>(a, stream);
  if (tile == 1) return launch<Small<D>>(a, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16 operands (flash_fwd_bf16)
// ---------------------------------------------------------------------------
//
// _attn_kernel on bf16 q, k, v: the scores are f32 sums of exact bf16
// products, p = exp(s - m) stays f32 for the row sum l, and p is rounded
// to bf16 before O += p . V (pallas_attention.py:151); O is written in
// bf16 and the LSE in f32.
//
// Where p is rounded decides what the output is: rounding exp(s - m) with
// a running max, as a one-pass online softmax over key tiles does, and
// rescaling later differs from rounding it against the row's final max
// (flash_attention_plain; JAX at its default blocks, one key block per
// row up to T = 1024) in 16-28% of the outputs at T = 256 and key tiles of
// 64. So the kernel makes two passes over the row's keys. The first
// computes S = Q . K^T alone (no V) and each row's max m over its visible
// scores; the second computes S again, bit for bit the same, p = 2^(s
// log2 e - m log2 e) with that final m, l += p, and O += bf16(p) . V with
// no rescaling at all. The max pass costs 2 D of the 6 D operations a
// visible pair takes (4 D in one pass).
//
// Design: a block of RG warps owns 16 * RG query rows, a warp 16 of them
// and every key of each streamed tile of BS keys, in steps of SUB = 32
// keys (a score tile of 16 x 64 and its partials spilled at D = 128).
// Each warp's Q fragments
// load from global memory once, into registers (Q is read by nobody
// else). K (and in the second pass V) tiles land raw by cp.async in the
// ring of flash_tiles.cuh, 16-byte copies where q, k and v are 16-byte
// aligned, else 4-byte ones; the fragments come by ldmatrix (K rows as B
// columns for S; V by ldmatrix.trans for P . V). S contracts over D in
// partials of 32, P . V in one fresh partial a step per 8 columns, each
// added by FADD. P is packed from the score accumulators straight into A
// fragments (mma_bf16.cuh: a_from_acc), so it never passes through shared
// memory. Masks, the causal cone and segment skips, the -1e30 floor of m,
// the 1e-30 clamp of l and the epilogue are the f32 kernel's.

// RG warps of 16 query rows each, key tiles of BS rows taken SUB at a
// time.
template <int D_, int RG_, int BS_, int STAGES_, int MIN_BLOCKS_>
struct CfgB {
  static constexpr int D = D_, RG = RG_, BS = BS_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int NT = 32 * RG, ROWS = 16 * RG;
  static constexpr int SUB = 32;         // keys a step
  static constexpr int NJ = SUB / 8;     // score n-tiles of a step
  static constexpr int ND = D / 8;       // output n-tiles
  static constexpr int LD = D + 8;       // row pitch in bf16 values
  static constexpr int TILE = BS * LD;   // a streamed matrix, bf16 values
  // a stage in floats: K and V (two matrices of bf16), segment ids
  static constexpr int STAGE = TILE + BS;
  static constexpr int SMEM_BYTES = 4 * STAGES * STAGE;
  static_assert(BS % SUB == 0, "whole steps a tile");
  static_assert(SMEM_BYTES <= 232448, "shared memory a block may use");
};

// The instances (nn/cuda_attention.py: _FWD_TILES_BF16, by index): Large,
// 8 warps over 128 rows, key tiles of 64, one block an SM (at D = 128 the
// Q fragments, the O accumulator and a 32-key step's scores take 255
// registers a thread, 176 at D = 64); Small, 4 warps over 64 rows, two
// blocks an SM, for shapes that leave Large under a wave. At D = 128 70
// KB of shared memory a block, at D = 64 37 KB.
template <int D>
using LargeB = CfgB<D, 8, 64, 2, 1>;
template <int D>
using SmallB = CfgB<D, 4, 64, 2, 2>;

struct ArgsB {
  const bf16 *q, *k, *v;
  const int* seg;
  bf16* o;
  float* lse;
  int B, H, T;
  float scale;
  int causal;
  int vec;      // 8: 16-byte copies (q, k, v 16-byte aligned), or 2
};

template <class C>
__global__ void __launch_bounds__(C::NT, C::MIN_BLOCKS)
flash_fwd_bf16_kernel(const ArgsB a) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;
  const int T = a.T, BH = a.B * a.H;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wrow = 16 * (threadIdx.x / 32);
  const int bh = blockIdx.x % BH, rank = blockIdx.x / BH;
  const int n_rt = (T + C::ROWS - 1) / C::ROWS;
  const int q0 = (a.causal ? n_rt - 1 - rank : rank) * C::ROWS;
  const size_t base = (size_t)bh * T * C::D;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;

  const int n_st = (T + C::BS - 1) / C::BS;
  const int end = a.causal ? min((q0 + C::ROWS - 1) / C::BS + 1, n_st) : n_st;
  const int2 own = seg ? seg_range(seg, q0, C::ROWS, T) : make_int2(0, 0);
  // a stage: K at bf16 0, V at bf16 TILE, segment ids at float TILE
  const auto load = [&](float* st, int kt, bool with_v) {
    bf16* kv = reinterpret_cast<bf16*>(st);
    by_width<8, 2>(a, [&](auto vec) {
      constexpr int VEC = decltype(vec)::value;
      stage_rows<C, VEC>(kv, a.k + base, kt * C::BS, T);
      if (with_v) stage_rows<C, VEC>(kv + C::TILE, a.v + base, kt * C::BS, T);
    });
    if (seg)
      stage_vec<C>(st + C::TILE, reinterpret_cast<const float*>(seg),
                   kt * C::BS, T);
  };

  unsigned qf[C::D / 16][4];
  a_rows<C::D>(qf, a.q + base, q0 + wrow, T, g, t);
  int qrow[2], qseg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qrow[h] = q0 + wrow + g + 8 * h;
    qseg[h] = seg && qrow[h] < T ? seg[qrow[h]] : 0;
  }
  // s = the warp's scaled scores against keys [sub * SUB, + SUB) of tile
  // kt, -inf where masked; false where the warp's rows lie past T or see
  // no key of the step
  const auto tile_scores = [&](const float* st, int kt, int sub,
                               float (&s)[C::NJ][4]) {
    const int k0 = kt * C::BS + sub * C::SUB;
    if (q0 + wrow >= T || k0 >= T || (a.causal && k0 > q0 + wrow + 15))
      return false;
    scores_bf16<C>(s, qf,
                   reinterpret_cast<const bf16*>(st) + sub * C::SUB * C::LD);
    // every key of the step in T, inside the warp's cone, no segments
    const bool inside = !seg && k0 + C::SUB <= T &&
                        (!a.causal || k0 + C::SUB - 1 <= q0 + wrow);
    const int* kseg =
        reinterpret_cast<const int*>(st + C::TILE) + sub * C::SUB;
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = 8 * j + 2 * t + (e & 1);
        bool vis = true;
        if (!inside) {
          vis = k0 + col < T;
          if (a.causal) vis = vis && k0 + col <= qrow[h];
          if (seg) vis = vis && kseg[col] == qseg[h] && qseg[h] > 0;
        }
        s[j][e] = vis ? s[j][e] * a.scale : -INFINITY;
      }
    return true;
  };

  // pass 1: each row's max over its visible scores
  float m[2] = {NEG, NEG};
  stream<C>(ring, seg, own, 0, end, T, [] {},
            [&](float* st, int kt) { load(st, kt, false); },
            [&](const float* st, int kt) {
#pragma unroll 1  // steps one after the other: interleaved, they spill
              for (int sub = 0; sub < C::BS / C::SUB; ++sub) {
                float s[C::NJ][4];
                if (!tile_scores(st, kt, sub, s)) continue;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  float mx = -INFINITY;
#pragma unroll
                  for (int j = 0; j < C::NJ; ++j)
                    mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
                  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
                  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
                  m[h] = fmaxf(m[h], mx);
                }
              }
            });
  __syncthreads();           // every warp is done with the ring
  // pass 2: p = exp(s - m) against the final m, l += p, O += bf16(p) . V
  float mneg[2], l[2] = {0.f, 0.f};          // l: this lane's columns
#pragma unroll
  for (int h = 0; h < 2; ++h) mneg[h] = -m[h] * LOG2E;
  float acc[C::ND][4];
#pragma unroll
  for (int n = 0; n < C::ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  stream<C>(ring, seg, own, 0, end, T, [] {},
            [&](float* st, int kt) { load(st, kt, true); },
            [&](const float* st, int kt) {
#pragma unroll 1  // steps one after the other: interleaved, they spill
              for (int sub = 0; sub < C::BS / C::SUB; ++sub) {
                float s[C::NJ][4];
                if (!tile_scores(st, kt, sub, s)) continue;
#pragma unroll
                for (int j = 0; j < C::NJ; ++j)
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    s[j][e] = exp2_ftz(fmaf(s[j][e], LOG2E, mneg[e >> 1]));
                    l[e >> 1] += s[j][e];
                  }
                accumulate_bf16<C, C::ND>(
                    acc, s, reinterpret_cast<const bf16*>(st) + C::TILE
                                + sub * C::SUB * C::LD, 0);
              }
            });
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lr = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float lf = fmaxf(lr, 1e-30f);
    inv[h] = 1.f / lf;
    if (t == 0 && qrow[h] < T)
      a.lse[(size_t)bh * T + qrow[h]] = m[h] + logf(lf);
  }
  store_rows_bf16<C::ND>(acc, a.o + base, q0 + wrow, T, C::D, inv, g, t);
}

template <class C>
cudaError_t launch_bf16(const ArgsB& a, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)a.B * a.H * ((a.T + C::ROWS - 1) / C::ROWS);
  flash_fwd_bf16_kernel<C>
      <<<(unsigned)blocks, C::NT, C::SMEM_BYTES, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_bf16(const ArgsB& a, int tile, cudaStream_t stream) {
  if (a.vec != 8 && a.vec != 2) return cudaErrorInvalidValue;
  if (tile == 0) return launch_bf16<LargeB<D>>(a, stream);
  if (tile == 1) return launch_bf16<SmallB<D>>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, o: [B, H, T, D] float32, contiguous. seg: [B, T] int32 or null.
// lse: [B, H, T] float32. tile: 0 (Large) or 1 (Small); vec: 4 (16-byte
// copies: q, k and v 16-byte aligned) or 1. Returns a cudaError_t
// (0 = launched).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             const void* seg, void* o, void* lse, int B,
                             int H, int T, int D, float scale, int causal,
                             int tile, int vec, void* stream) {
  const Args a{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const int*>(seg),
               static_cast<float*>(o), static_cast<float*>(lse), B, H, T,
               scale, causal, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(dispatch<64>(a, tile, st));
  if (D == 128) return static_cast<int>(dispatch<128>(a, tile, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of instance tile at head dim D, or -1: the plan's
// figure is checked against it.
extern "C" int flash_fwd_smem_bytes(int D, int tile) {
  if (D == 64) return tile == 0 ? Large<64>::SMEM_BYTES
                                : tile == 1 ? Small<64>::SMEM_BYTES : -1;
  if (D == 128) return tile == 0 ? Large<128>::SMEM_BYTES
                                 : tile == 1 ? Small<128>::SMEM_BYTES : -1;
  return -1;
}

// q, k, v, o: [B, H, T, D] bfloat16, contiguous. seg: [B, T] int32 or
// null. lse: [B, H, T] float32. tile: 0 (LargeB) or 1 (SmallB); vec: 8
// (16-byte copies: q, k and v 16-byte aligned) or 2 (4-byte aligned).
// Returns a cudaError_t (0 = launched).
extern "C" int flash_fwd_bf16_f32(const void* q, const void* k,
                                  const void* v, const void* seg, void* o,
                                  void* lse, int B, int H, int T, int D,
                                  float scale, int causal, int tile, int vec,
                                  void* stream) {
  const ArgsB a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const int*>(seg),
                static_cast<bf16*>(o), static_cast<float*>(lse), B, H, T,
                scale, causal, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return static_cast<int>(dispatch_bf16<64>(a, tile, st));
  if (D == 128) return static_cast<int>(dispatch_bf16<128>(a, tile, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of bf16 instance tile at head dim D, or -1.
extern "C" int flash_fwd_bf16_smem_bytes(int D, int tile) {
  if (D == 64) return tile == 0 ? LargeB<64>::SMEM_BYTES
                                : tile == 1 ? SmallB<64>::SMEM_BYTES : -1;
  if (D == 128) return tile == 0 ? LargeB<128>::SMEM_BYTES
                                 : tile == 1 ? SmallB<128>::SMEM_BYTES : -1;
  return -1;
}
