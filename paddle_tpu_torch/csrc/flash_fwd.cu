// Flash-attention forward for sm_90a: float32 operands on the tensor cores
// in split TF32, and bfloat16 operands (after the f32 kernel) on wgmma fed
// by TMA where they are 16-byte aligned, else on bf16 mma.sync.
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
#include "wgmma_bf16.cuh"

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
// else). K (and in the second pass V) tiles land raw by 4-byte cp.async
// in the ring of flash_tiles.cuh (this kernel takes the views TMA cannot
// load, 4 bytes off a 16-byte boundary; aligned operands go to the wgmma
// kernel below); the fragments come by ldmatrix (K rows as B
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
    stage_rows<C, 2>(kv, a.k + base, kt * C::BS, T);
    if (with_v) stage_rows<C, 2>(kv + C::TILE, a.v + base, kt * C::BS, T);
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
  if (tile == 0) return launch_bf16<LargeB<D>>(a, stream);
  if (tile == 1) return launch_bf16<SmallB<D>>(a, stream);
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// bfloat16 operands on wgmma fed by TMA (flash_fwd_bf16, 16-byte aligned)
// ---------------------------------------------------------------------------
//
// The same two passes, on Hopper's warpgroup product. What held the
// mma.sync kernel above back on the H100 was issue: per 32 keys a warp ran
// 96 mma.sync beside about four times as many other instructions (FADDs of
// the partials, ldmatrix, masks, exponentials), one block of 8 warps an SM
// at 255 registers, 85 TFLOP/s against 989. Here one m64nNk16 wgmma does
// the work of 4 N / 8 mma.sync and their ldmatrix, and TMA takes the
// copies and their address arithmetic off the warps:
//   - A block owns ROWS = 64 WG query rows: WG consumer warpgroups of 64
//     rows and a producer warpgroup, of which one warp issues every TMA
//     load (setmaxnreg gives the producer's registers to the consumers).
//   - Q lands once by TMA: a 64-column slab per 64 of D, K-major (D is
//     the contiguous dimension of Q and K), 128-byte swizzle. K and V
//     tiles of BS = 64 keys land the same way through a ring of STAGES
//     stages, each with a "full" and an "empty" mbarrier; the max pass
//     loads K alone, 2 BS keys a stage. The tensor maps are 3-D ({D, T,
//     B * H}), so rows past T of a head land as zeros. Whole tiles whose
//     segment ids cannot meet the block's are skipped by producer and
//     consumers alike (next_tile).
//   - S = Q . K^T: SS wgmma with both operands K-major (m64n128k16 in the
//     max pass, m64n64k16 in the main pass), a fresh partial per 64 of D
//     (each chain of four k16 steps starts from zero), the partials added
//     by FADD in the order of D, in both passes (the max pass's wider
//     tiles change which products share an instruction, not the chains
//     of any score). Scale and the row max (two quad shuffles: a row lives in a
//     quad of lanes) run on the accumulators; the causal, T and segment
//     masks only on the tiles that need them (formed on every tile, they
//     took more time than the products), the keys' segment ids loaded
//     two a lane and shuffled to their columns (a load per score cost
//     more than the rest of the kernel). A warpgroup owns its rows' m in
//     full.
//   - Pass 2: p = 2^(s log2 e - m log2 e) in f32 against the final m,
//     l += p, P packed into bf16 A fragments by cvt.rn.bf16x2.f32 straight
//     from the score accumulators, then O's partial over the tile by
//     register-A wgmma with V MN-major (the transpose flag), one fresh
//     partial per tile of 64 keys and 64 output columns, added to O by
//     FADD. No rescale.
//   - Overlap within a warpgroup: the main pass issues the next tile's S
//     between the two halves of P . V (O, P, a partial and the next S
//     take 176 of a consumer's 240 registers at D = 128). ptxas
//     serialises every wgmma of the kernel (notes C7510-C7520) if a group
//     may stay in flight across a loop's back edge or out of a loop, if a
//     branch around a wgmma differs between a warpgroup's warps, or if
//     waits sit in branches it cannot relate: every group here is retired
//     within its iteration, by waits on every path (an empty group where
//     there is no next tile).
//   - Both warpgroups take every tile of the block's (the causal cone
//     hides the block's last tile of 64 keys from the first warpgroup's
//     rows; its scores there are all masked, p = 0): no branch around a
//     product.
// The masks, the -1e30 floor of m, the 1e-30 clamp of l and the epilogue
// are the kernels' above.

// MAIN_PASS false leaves the max pass alone (O written as zeros): how
// tools/bf16_compare.py times the max pass apart.
constexpr bool MAIN_PASS = true;

template <int D_, int WG_, int BS_, int STAGES_>
struct CfgW {
  static constexpr int D = D_, WG = WG_, BS = BS_, STAGES = STAGES_;
  static constexpr int ROWS = 64 * WG;            // query rows a block
  static constexpr int CONSUMERS = 128 * WG;
  static constexpr int NT = CONSUMERS + 128;      // and the producer
  static constexpr int SLABS = D / 64;            // 64-column slabs a row
  static constexpr int Q_SLAB = ROWS * 128;       // bytes
  static constexpr int KV_SLAB = BS * 128;
  static constexpr int Q_BYTES = SLABS * Q_SLAB;
  static constexpr int K_BYTES = SLABS * KV_SLAB;  // a K or V tile
  static constexpr int STAGE = 2 * K_BYTES;
  // Q and the stages from a 1024-byte boundary, then 2 STAGES + 1
  // barriers
  static constexpr int SMEM_BYTES =
      1024 + Q_BYTES + STAGES * STAGE + 8 * (2 * STAGES + 1);
  static constexpr int NS = BS / 2, NO = D / 2;   // accumulators a thread
  // keys a max-pass tile: that pass loads K alone, and K of 2 BS keys
  // fills a stage
  static constexpr int BS1 = 2 * BS;
  static_assert(BS == 64, "P . V over one 64-key chain a tile");
  static_assert(SLABS * BS1 * 128 == STAGE, "a max-pass tile fills a stage");
  static_assert(D == 64 || D == 128, "whole slabs, wgmma widths");
  static_assert(SMEM_BYTES <= 232448, "shared memory a block may use");
};

// The instances (nn/cuda_attention.py: _FWD_TILES_WGMMA, by index):
// LargeW, two consumer warpgroups over 128 rows; SmallW, one over 64
// rows, for shapes that leave LargeW under a wave. Key tiles of 64, four
// stages; one block an SM (161 KB of shared memory at D = 128 for LargeW).
template <int D>
using LargeW = CfgW<D, 2, 64, 4>;
template <int D>
using SmallW = CfgW<D, 1, 64, 4>;

// registers a thread after setmaxnreg: the producer warpgroup's and the
// consumers' (4 * 32 * 24 + 8 * 32 * 240 = 64,512 of the SM's 65,536)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

struct ArgsW {
  const int* seg;
  bf16* o;
  float* lse;
  int B, H, T;
  float scale;
  int causal;
};

// Issues s (+ part at D = 128) = this warpgroup's 64 rows of Q (Q slabs
// at qa) against the BS keys of the K tile at ka, one wgmma group: a
// fresh chain per 64 of D. The caller waits for the group, then
// sum_scores adds the partials by FADD in the order of D.
template <class C, int N>
__device__ __forceinline__ void issue_scores(float (&s)[N / 2],
                                             float (&part)[N / 2],
                                             uint32_t qa, uint32_t ka) {
  // the operands' fences before wgmma.fence: an instruction that writes
  // an accumulator inside the group makes ptxas serialise (C7514)
  wgmma::fence_operand(s);
  if constexpr (C::SLABS == 2) wgmma::fence_operand(part);
  wgmma::fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma::mma_ss<N, 0, 0>(s, wgmma::desc_k128(qa + 32 * kk),
                           wgmma::desc_k128(ka + 32 * kk), kk > 0);
  if constexpr (C::SLABS == 2) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::mma_ss<N, 0, 0>(
          part, wgmma::desc_k128(qa + C::Q_SLAB + 32 * kk),
          wgmma::desc_k128(ka + N * 128 + 32 * kk), kk > 0);
  }
  wgmma::commit();
}

template <class C, int NS>
__device__ __forceinline__ void sum_scores(float (&s)[NS], float (&part)[NS]) {
  wgmma::fence_operand(s);
  if constexpr (C::SLABS == 2) {
    wgmma::fence_operand(part);
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] += part[i];
  }
}

template <class C>
__global__ void __launch_bounds__(C::NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const ArgsW a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* qs =
      smem_raw + (1024 - wgmma::smem_addr(smem_raw) % 1024) % 1024;
  unsigned char* ring = qs + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;
  const int T = a.T, BH = a.B * a.H;
  const int bh = blockIdx.x % BH, rank = blockIdx.x / BH;
  const int n_rt = (T + C::ROWS - 1) / C::ROWS;
  const int q0 = (a.causal ? n_rt - 1 - rank : rank) * C::ROWS;
  const int* seg = a.seg ? a.seg + (size_t)(bh / a.H) * T : nullptr;
  // the tiles of the main pass (BS keys) and of the max pass (BS1), up to
  // the causal cone's end
  const int end = a.causal ? min((q0 + C::ROWS - 1) / C::BS + 1,
                                 (T + C::BS - 1) / C::BS)
                           : (T + C::BS - 1) / C::BS;
  const int end1 = a.causal ? min((q0 + C::ROWS - 1) / C::BS1 + 1,
                                  (T + C::BS1 - 1) / C::BS1)
                            : (T + C::BS1 - 1) / C::BS1;
  const int2 own =
      seg ? seg_range(seg, q0, C::ROWS, T) : make_int2(0, 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::STAGES; ++i) {
      wgmma::mbar_init(&full[i], 1);
      wgmma::mbar_init(&empty[i], C::CONSUMERS / 32);
    }
    wgmma::mbar_init(qbar, 1);
    wgmma::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= C::CONSUMERS) {
    // the producer warpgroup: its first warp walks the tiles (next_tile
    // takes a whole warp), lane 0 issues the copies
    wgmma::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < C::CONSUMERS + 32) {
      const bool lead = threadIdx.x == C::CONSUMERS;
      if (lead) {
        wgmma::mbar_expect_tx(qbar, C::Q_BYTES);
#pragma unroll
        for (int c = 0; c < C::SLABS; ++c)
          wgmma::tma_load_3d(qs + c * C::Q_SLAB, &qmap, qbar, 64 * c, q0, bh);
      }
      int it = 0;
      // waits until stage `it` is free, then (lead) expects its bytes
      const auto claim = [&](int it, int bytes) {
        const int st = it % C::STAGES;
        if (it >= C::STAGES)           // its tile of STAGES ago consumed
          wgmma::mbar_wait(&empty[st], (it / C::STAGES - 1) & 1);
        if (lead) wgmma::mbar_expect_tx(&full[st], bytes);
        return ring + st * C::STAGE;
      };
      // the max pass: K of BS1 keys a stage, a slab per 64 of D of BS1
      // rows, each as two boxes of BS rows
      for (int kt = next_tile<C::BS1>(seg, own, 0, end1, T); kt < end1;
           kt = next_tile<C::BS1>(seg, own, kt + 1, end1, T), ++it) {
        unsigned char* s = claim(it, C::STAGE);
        if (lead)
#pragma unroll
          for (int c = 0; c < 2 * C::SLABS; ++c)
            wgmma::tma_load_3d(s + c * C::KV_SLAB, &kmap, &full[it % C::STAGES],
                               64 * (c / 2), kt * C::BS1 + C::BS * (c % 2),
                               bh);
      }
      // the main pass: K and V of BS keys a stage
      for (int kt = next_tile<C::BS>(seg, own, 0, end, T);
           MAIN_PASS && kt < end;
           kt = next_tile<C::BS>(seg, own, kt + 1, end, T), ++it) {
        unsigned char* s = claim(it, C::STAGE);
        if (lead)
#pragma unroll
          for (int c = 0; c < C::SLABS; ++c) {
            wgmma::tma_load_3d(s + c * C::KV_SLAB, &kmap, &full[it % C::STAGES],
                               64 * c, kt * C::BS, bh);
            wgmma::tma_load_3d(s + C::K_BYTES + c * C::KV_SLAB, &vmap,
                               &full[it % C::STAGES], 64 * c, kt * C::BS, bh);
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
    const int row0 = q0 + 64 * wg, wrow = row0 + 16 * warp;
    int qrow[2], qseg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qrow[h] = wrow + g + 8 * h;
      qseg[h] = seg && qrow[h] < T ? seg[qrow[h]] : 0;
    }
    const uint32_t qa = wgmma::smem_addr(qs) + wg * 64 * 128;
    const auto stage_of = [&](int it) {
      return wgmma::smem_addr(ring + it % C::STAGES * C::STAGE);
    };
    // waits for stage it's copies, then issues the S of the tile staged
    // there (its width from sc's: BS or BS1 keys)
    const auto issue = [&](auto& sc, auto& pc, int it) {
      constexpr int N = 2 * std::extent<std::remove_reference_t<
                                decltype(sc)>>::value;
      wgmma::mbar_wait(&full[it % C::STAGES], (it / C::STAGES) & 1);
      issue_scores<C, N>(sc, pc, qa, stage_of(it));
    };
    // once the S of the tile from key k0 on has landed: s = the scaled
    // scores, -inf where masked
    const auto finish = [&](auto& sc, auto& pc, int k0) {
      constexpr int NS = std::extent<std::remove_reference_t<
                             decltype(sc)>>::value;
      sum_scores<C>(sc, pc);
      // every key of the tile in T and inside the warpgroup's cone, no
      // segments: no masks (the branch is warpgroup-uniform: a branch
      // that differs between its warps while a wgmma group is in flight
      // makes ptxas serialise every wgmma)
      const bool inside = !seg && k0 + 2 * NS <= T &&
                          (!a.causal || k0 + 2 * NS - 1 <= row0);
      if (inside) {
#pragma unroll
        for (int i = 0; i < NS; ++i) sc[i] *= a.scale;
        return;
      }
      // the keys' segment ids: a lane loads two of every 64, and each
      // column's id comes from the lane that loaded it by a shuffle (a
      // load per score cost more than the rest of the kernel)
      int kid[NS / 32][2];
#pragma unroll
      for (int q = 0; q < NS / 32; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 64 * q + 2 * lane + e;
          kid[q][e] = seg && key < T ? __ldg(seg + key) : 0;
        }
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int h = (i >> 1) & 1, kj = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        bool vis = kj < T;
        if (a.causal) vis = vis && kj <= qrow[h];
        if (seg) {
          const int id = __shfl_sync(0xffffffffu, kid[i / 32][i & 1],
                                     4 * (i / 4 % 8) + t);
          vis = vis && qseg[h] > 0 && id == qseg[h];
        }
        sc[i] = vis ? sc[i] * a.scale : -INFINITY;
      }
    };
    // releases tile it's stage once its products have read it
    const auto release = [&](int it) {
      wgmma::mbar_arrive_if(&empty[it % C::STAGES], lane == 0);
    };
    wgmma::mbar_wait(qbar, 0);
    // pass 1: each row's max over its visible scores, in tiles of BS1
    // keys (n128 products, half the barrier rounds of BS), one tile's S
    // waited for before the next is issued (two tiles of BS in flight at
    // once measured slower on the card than one at a time)
    float m[2] = {NEG, NEG};
    int it = 0;
    for (int kt = next_tile<C::BS1>(seg, own, 0, end1, T); kt < end1;
         kt = next_tile<C::BS1>(seg, own, kt + 1, end1, T), ++it) {
      float s1[C::BS1 / 2], p1[C::BS1 / 2];
      issue(s1, p1, it);
      wgmma::wait<0>();
      finish(s1, p1, kt * C::BS1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < C::BS1 / 2; i += 4)
          mx = fmaxf(mx, fmaxf(s1[i + 2 * h], s1[i + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m[h] = fmaxf(m[h], mx);
      }
      release(it);
    }
    const auto next_of = [&](int from) {
      return next_tile<C::BS>(seg, own, from, end, T);
    };
    // pass 2: p = exp(s - m) against the final m, l += p, O += bf16(p) . V.
    // P . V goes in halves of 64 output columns (a 32-register partial
    // each), so that the next tile's S fits beside O, P and a partial: the
    // next tile's S is issued right after the first half, and its masks
    // are applied while the second half runs. Every group is retired
    // within its iteration.
    float o[C::NO], l[2] = {0.f, 0.f};        // l: this lane's columns
#pragma unroll
    for (int i = 0; i < C::NO; ++i) o[i] = 0.f;
    if constexpr (MAIN_PASS) {
      float mneg[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) mneg[h] = -m[h] * LOG2E;
      float s[C::NS], sp[C::NS];
      int kt = next_of(0);
      if (kt < end) {
        issue(s, sp, it);
        wgmma::wait<0>();
        finish(s, sp, kt * C::BS);
      }
      // issues part = P . V[:, 64 h .. 64 h + 63], V's slab h at va: one
      // fresh chain of four k16 steps (16 keys, 2048 bytes, each)
      const auto pv_half = [&](float (&part)[32], const unsigned (&pa)[4][4],
                               uint32_t va) {
        wgmma::fence_operand(part);
        wgmma::fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma::mma_rs<64, 1>(
              part, pa[kc],
              wgmma::desc_sw128(va + 2048 * kc, C::KV_SLAB, 1024), kc > 0);
        wgmma::commit();
      };
      // o[32 h + i] is column 64 h + the m64n64 column of value i
      const auto add_half = [&](float (&part)[32], int h) {
        wgmma::fence_operand(part);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[32 * h + i] += part[i];
      };
      while (kt < end) {
        const int nk = next_of(kt + 1);
        const bool next = nk < end;
        unsigned pa[4][4];
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float& p = s[8 * kc + e];
            p = exp2_ftz(fmaf(p, LOG2E, mneg[(e >> 1) & 1]));
            l[(e >> 1) & 1] += p;
          }
          // the k16 A fragment of keys 16 kc..: rows g, g + 8, keys 2t,
          // 2t + 1, then 2t + 8, 2t + 9
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kc][r] = bf16mma::pack_bf16x2(s[8 * kc + 2 * r],
                                             s[8 * kc + 2 * r + 1]);
        }
        const uint32_t va = stage_of(it) + C::K_BYTES;
        float part[32];
        pv_half(part, pa, va);
        if (next)                      // as in pass 1: a group either way
          issue(s, sp, it + 1);
        else
          wgmma::commit();
        wgmma::wait<1>();
        add_half(part, 0);
        if constexpr (C::SLABS == 2) {
          float part1[32];
          pv_half(part1, pa, va + C::KV_SLAB);
          wgmma::wait<1>();
          if (next) finish(s, sp, nk * C::BS);
          wgmma::wait<0>();
          add_half(part1, 1);
        } else {
          wgmma::wait<0>();
          if (next) finish(s, sp, nk * C::BS);
        }
        release(it);
        kt = nk;
        ++it;
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
    bf16* out = a.o + (size_t)bh * T * C::D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (qrow[h] >= T) continue;
#pragma unroll
      for (int j = 0; j < C::D / 8; ++j)
        *reinterpret_cast<unsigned*>(out + (size_t)qrow[h] * C::D + 8 * j +
                                     2 * t) =
            bf16mma::pack_bf16x2(o[4 * j + 2 * h] * inv[h],
                                 o[4 * j + 2 * h + 1] * inv[h]);
    }
  }
}

template <class C>
cudaError_t launch_wgmma(const ArgsB& b, cudaStream_t stream) {
  // [B * H, T, D] as {D, T, B * H}: a box of 64 columns by rows of one
  // head, rows past T filled with zeros
  CUtensorMap maps[3];
  const bf16* src[3] = {b.q, b.k, b.v};
  const cuuint64_t dims[3] = {(cuuint64_t)C::D, (cuuint64_t)b.T,
                              (cuuint64_t)b.B * b.H};
  const cuuint64_t strides[2] = {(cuuint64_t)C::D * 2,
                                 (cuuint64_t)b.T * C::D * 2};
  for (int i = 0; i < 3; ++i) {
    const cuuint32_t box[3] = {64, (cuuint32_t)(i ? C::BS : C::ROWS), 1};
    const cudaError_t err =
        wgmma::bf16_map(&maps[i], src[i], 3, dims, strides, box);
    if (err != cudaSuccess) return err;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const ArgsW a{b.seg, b.o, b.lse, b.B, b.H, b.T, b.scale, b.causal};
  const long long blocks =
      (long long)b.B * b.H * ((b.T + C::ROWS - 1) / C::ROWS);
  flash_fwd_wgmma_kernel<C><<<(unsigned)blocks, C::NT, C::SMEM_BYTES,
                              stream>>>(maps[0], maps[1], maps[2], a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_wgmma(const ArgsB& a, int tile, cudaStream_t stream) {
  if (tile == 0) return launch_wgmma<LargeW<D>>(a, stream);
  if (tile == 1) return launch_wgmma<SmallW<D>>(a, stream);
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
// null. lse: [B, H, T] float32. vec picks the route: 8 for wgmma (q, k,
// v and o 16-byte aligned), tile 0 (LargeW) or 1 (SmallW); 2 for
// mma.sync on 4-byte copies (4-byte aligned), tile 0 (LargeB) or 1
// (SmallB). Returns a cudaError_t (0 = launched).
extern "C" int flash_fwd_bf16_f32(const void* q, const void* k,
                                  const void* v, const void* seg, void* o,
                                  void* lse, int B, int H, int T, int D,
                                  float scale, int causal, int tile, int vec,
                                  void* stream) {
  const ArgsB a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<const int*>(seg),
                static_cast<bf16*>(o), static_cast<float*>(lse), B, H, T,
                scale, causal};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 8) {
    if (D == 64) return static_cast<int>(dispatch_wgmma<64>(a, tile, st));
    if (D == 128) return static_cast<int>(dispatch_wgmma<128>(a, tile, st));
  } else if (vec == 2) {
    if (D == 64) return static_cast<int>(dispatch_bf16<64>(a, tile, st));
    if (D == 128) return static_cast<int>(dispatch_bf16<128>(a, tile, st));
  }
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

// Dynamic shared memory of wgmma instance tile at head dim D, or -1.
extern "C" int flash_fwd_wgmma_smem_bytes(int D, int tile) {
  if (D == 64) return tile == 0 ? LargeW<64>::SMEM_BYTES
                                : tile == 1 ? SmallW<64>::SMEM_BYTES : -1;
  if (D == 128) return tile == 0 ? LargeW<128>::SMEM_BYTES
                                 : tile == 1 ? SmallW<128>::SMEM_BYTES : -1;
  return -1;
}
