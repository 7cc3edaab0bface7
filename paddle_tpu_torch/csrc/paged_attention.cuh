// Paged attention rows over a paged KV pool, for sm_90a, as split-context
// ("flash-decoding") kernels: the body behind paged_decode.cu (one query
// row per slot) and paged_span.cu (Q consecutive query rows per slot,
// causal within the span). Queries, scores, the softmax state and the
// output are float32; the pool holds float32, bfloat16, or int8 values
// with f32 row scales (the Pool kind, a template parameter).
//
// Replaces the shared body of paddle_tpu/nn/pallas_attention.py's
// _paged_decode_kernel and _paged_span_kernel, over each pool dtype they
// take. Row j of slot s is the query at position pos = start[s] + j; it
// sees the pool positions <= pos of the blocks the slot's table row
// names. Rows j >= n[s] are padding and a slot with n == 0 is inactive:
// both get zeros. Decode is the span with Q = 1, start = length - 1 and
// n = (length > 0).
//
// What bounds it on the H100: bytes. Each key and value row is used for
// 2 * D flops per query row, far below the card's operations-per-byte
// balance, so the floor is the K/V bytes the spans cover (bf16: 2 bytes
// per element; int8: 1 byte plus one f32 scale per row) over 3.35 TB/s.
// At serving sizes the real enemy is latency: a few hundred KB spread
// over a few slots.
//
// Design, two launches per call (three for bf16 pools):
// 1. partials_kernel: the context is cut into fixed partitions of P
//    positions (the wrapper's plan: P a whole number of pool blocks, from
//    bs alone; 128 at bs 16). One block of 128 threads per (slot, tile of R
//    rows, head, partition) computes each live row's softmax partial (m,
//    l, acc[D]) over the partition, so a slot's context is walked by
//    ceil(len / P) blocks at once instead of one block serially. The
//    grid's partition count comes from the table width; a block past its
//    rows' last position returns without writing, so the host reads no
//    per-slot value. The block reads its span and its partition's table
//    entries in one round trip, then starts the partition's rows as
//    cp.async copies into a two-stage ring: K, then V, by 16-byte copies.
//    An int8 or bf16 pool lands raw and is widened to f32 in shared memory
//    (int8: __fmul_rn(float(q), s), its f32 scales landing by 4-byte
//    copies, strided by H; bf16: __bfloat162float, exact). The scores and
//    the softmax run while V is in flight. Each (row, key) score is one
//    fmaf chain over D; each row's max and sum are one warp's shuffles; p
//    = exp(s - m) is computed once into shared memory for both the sum and
//    the PV product, which a thread per (row, float4 column chunk)
//    accumulates over the keys in order. A span's R rows share each staged
//    partition, so a chunk of Q rows reads the context ceil(Q / R) times.
// 2. merge_kernel: each row merges its ceil((min(pos, W - 1) + 1) / P)
//    partials in the fixed order k = 0, 1, ... and divides by max(l,
//    1e-30), a warp per (row, head). No atomics: reruns are bit-equal.
//
// bf16 pools. JAX rounds p to V's dtype before p.V (p.astype(vb.dtype),
// pallas_attention.py:631, 763) and sums l over the unrounded p, and so
// do this kernel and the plain version. Rounding is not linear, so p must
// be rounded against the max the yardstick rounds against, the row's own
// max over every position it sees (paged_decode_plain): rounding
// exp(s - m_k) against each partition's max and rescaling at the merge
// moved the output by up to 4e-4 from the plain version (a CPU model of
// the two orders at 8 heads, D 64, lengths to 1024). So a bf16 call
// first runs partials_kernel as a max pass over K alone, which writes
// each row's partition max into the record's first pad float; the main
// pass takes M = max of the row's partition maxima (exact in any order),
// p = exp(s - M), l += p, and rounds p to bf16 for the fmaf chain of p.V.
// Every record then carries m = M, so the merge's factors exp(m_k - M)
// are exactly 1 and the merge is the plain in-order sum.
//
// K crosses from the pool once: the max pass also stores each live row's
// scaled, masked f32 scores over its partition in a scores workspace
// (past the records in the same allocation, [S, Q, H, parts, SP] with SP
// = P rounded up to 4 floats, so a row's scores are contiguous and 16-byte
// aligned; masked keys -inf). The main pass (pv_kernel) stages V alone:
// its rows' stored scores land by cp.async where K sat, so it reads the
// very f32 values a recomputation would give, with no K copy, no widening
// of K, no query tile and no score chain; p, l, the records and the merge
// are what they were, and its shared memory (stored scores, row state,
// raw V rows widened in registers, __bfloat162float, exact) is a fifth to
// a sixth of the max pass's at D 128, so more blocks share an SM. At
// these sizes latency bounds it, not bytes: it loads its rows' partition
// maxima before its copies land, not one row after another behind them,
// and issues the shared-memory loads of eight keys before their fmaf
// chain (each row's chain still over the keys in order). The
// merge stays a launch of its own: folding it into the main pass (the
// last block of a row tile to arrive on a counter merging the tile's
// rows) took longer on the card than the launch it saved.
//
// Bit-equality contract: row j of a span equals the decode kernel at
// length start + j + 1 bit for bit. The partition boundaries are a
// function of the position only (P depends on bs alone), so both compute
// the same partials over the same partitions: every operation of a row
// (explicit fmaf/__fmul_rn, the score chain, the warp's max and sum trees,
// the PV order, the merge order) is the same whatever R, Q and the other
// rows are. Keys a tile covers past a row's position are masked to -inf:
// the row's max stays, exp(-inf) = 0 adds exactly 0 to the sum, and
// fmaf(0, v, acc) = acc on finite pools, so a longer tile changes nothing.
// A partition wholly past a row is never merged for it; were it merged, its
// (m, l, acc) = (-1e30, 0, 0) would add exactly 0.
//
// Left for later work: tensor cores for the span's QK^T and PV (a span row
// and a decode row would have to take the same mma route), TMA loads, and
// a bf16 branch with no max pass (p rounded against the row's final max
// some other way).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>

namespace paged {

constexpr int NT = 128;               // threads per block, both kernels
constexpr int NW = NT / 32;
constexpr int MAX_BLOCKS = NT;        // pool blocks a partition may span
constexpr float NEG = -1e30f;

// the pool's element kind; the codes are the wrappers'
// (paddle_tpu_torch/nn/cuda_attention.py: POOL_F32, POOL_INT8, POOL_BF16)
enum Pool : int { F32 = 0, INT8 = 1, BF16 = 2 };

// bytes of one element of a pool that lands raw in shared memory before
// it is widened (an f32 pool lands in place)
__host__ __device__ constexpr int raw_bytes(int pool) {
  return pool == INT8 ? 1 : pool == BF16 ? 2 : 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of partials_kernel, in bytes from the base, every
// region on a 16-byte boundary; the wrapper's plan
// (paddle_tpu_torch/nn/cuda_attention.py:paged_plan) computes the same
// total.
struct Layout {
  int ks, vs, qs, ss, st, kraw, vraw, ksc, vsc, total;
  static __host__ __device__ int up16(int b) { return (b + 15) / 16 * 16; }
  __host__ __device__ Layout(int D, int R, int P, int pool) {
    const int eb = raw_bytes(pool);
    const bool quant = pool == INT8;
    ks = 0;                                   // [P][D + 4] f32 (padded)
    vs = ks + 4 * P * (D + 4);                // [P][D] f32
    qs = vs + 4 * P * D;                      // [R][D] f32
    ss = qs + 4 * R * D;                      // [R][P] scores, then p
    st = up16(ss + 4 * R * P);                // [2][R] m, l, then
    kraw = up16(st + 8 * R + 4 * MAX_BLOCKS);  // [P / bs] pool blocks
    // int8 and bf16: [P][D] raw K, [P][D] raw V; int8: [P] K and [P] V
    // scales
    vraw = kraw + eb * P * D;
    ksc = vraw + eb * P * D;
    vsc = up16(ksc + (quant ? 4 * P : 0));
    total = up16(vsc + (quant ? 4 * P : 0));
  }
};

// floats between two rows of the bf16 pools' stored scores: P rounded up
// to whole 16-byte pieces
__host__ __device__ constexpr int score_pitch(int P) {
  return (P + 3) / 4 * 4;
}

// Shared-memory layout of pv_kernel (the bf16 pools' main pass): no K, no
// raw K, no query tile and no f32 V; the plan's pv_smem is its total.
struct PvLayout {
  int ss, st, vraw, total;
  __host__ __device__ PvLayout(int D, int R, int P) {
    ss = 0;                                          // [R][SP] scores, p
    st = Layout::up16(ss + 4 * R * score_pitch(P));  // [2][R] m, l, then
    vraw = Layout::up16(st + 8 * R + 4 * MAX_BLOCKS);  // [P / bs] blocks
    total = Layout::up16(vraw + 2 * P * D);          // [P][D] raw bf16 V
  }
};

// The bf16 pools' stored scores in the workspace past the records, [S *
// Q, H, parts, SP] f32. SQ = S * Q.
__device__ __forceinline__ float* scores_of(float* ws, int SQ, int H,
                                            int parts, int D) {
  return ws + (size_t)SQ * H * parts * (D + 4);
}

// Start this thread's cp.async copies of the partition's rows [p0, p1) of
// one pool (and, int8, its scales) into shared memory: an f32 pool into
// the padded f32 rows (pitch floats apart), an int8 or bf16 pool raw, D
// elements a row.
template <int D, int KIND>
__device__ __forceinline__ void stage_rows(const void* pool,
                                           const float* scales, void* rows,
                                           float* srows, const int* blk_sm,
                                           int p0, int p1, int bs, int H,
                                           int h, int pitch) {
  constexpr int EB = KIND == F32 ? 4 : raw_bytes(KIND);
  constexpr int CP = D * EB / 16;     // 16-byte pieces of a row
  for (int i = threadIdx.x; i < (p1 - p0) * CP; i += NT) {
    const int li = i / CP, cc = i % CP, pos = p0 + li;
    const size_t row =
        ((size_t)blk_sm[li / bs] * bs + pos % bs) * H + h;
    if constexpr (KIND == F32)
      cp_async16(static_cast<float*>(rows) + li * pitch + cc * 4,
                 static_cast<const float*>(pool) + row * D + cc * 4);
    else
      cp_async16(static_cast<char*>(rows) + li * D * EB + cc * 16,
                 static_cast<const char*>(pool) + row * D * EB + cc * 16);
  }
  if constexpr (KIND == INT8) {
    for (int li = threadIdx.x; li < p1 - p0; li += NT) {
      const int pos = p0 + li;
      cp_async4(srows + li,
                scales + ((size_t)blk_sm[li / bs] * bs + pos % bs) * H + h);
    }
  }
  cp_async_commit();
}

// A partition's landed raw rows as f32: int8 __fmul_rn(float(q), s), bf16
// __bfloat162float (exact).
template <int D, int KIND>
__device__ __forceinline__ void widen_rows(const void* raw, const float* sc,
                                           float* out, int n, int pitch) {
  for (int i = threadIdx.x; i < n * D; i += NT) {
    const int li = i / D, d = i % D;
    if constexpr (KIND == INT8)
      out[li * pitch + d] = __fmul_rn(
          static_cast<float>(static_cast<const signed char*>(raw)[li * D + d]),
          sc[li]);
    else
      out[li * pitch + d] = __bfloat162float(
          static_cast<const __nv_bfloat16*>(raw)[li * D + d]);
  }
}

// p as JAX's p.astype(bfloat16) then widened back for the product
__device__ __forceinline__ float round_bf16(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// acc += p * v for four bf16 values of V (widened exactly), one fmaf each
__device__ __forceinline__ void fma_quad(float4& acc, float p, uint2 raw) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  acc.x = fmaf(p, lo.x, acc.x);
  acc.y = fmaf(p, lo.y, acc.y);
  acc.z = fmaf(p, hi.x, acc.z);
  acc.w = fmaf(p, hi.y, acc.w);
}

// One (slot, row tile, head, partition) block: each live row's softmax
// partial over the partition's positions, written to the workspace
// record [row][h][k] = (acc[D], m, l, max, -). With MAXPASS (bf16 pools'
// first launch) it stages K alone and writes only each row's max over the
// partition, into the record's third float past acc, and the row's scores
// into the scores workspace; pv_kernel then takes the row's max over all
// its partitions from the records and its scores from there.
template <int D, int R, int KIND, bool MAXPASS>
__global__ void __launch_bounds__(NT)
partials_kernel(const float* __restrict__ q, const void* __restrict__ pk,
                const void* __restrict__ pv, const float* __restrict__ sk,
                const float* __restrict__ sv, const int* __restrict__ tables,
                const int* __restrict__ start, const int* __restrict__ count,
                float* __restrict__ ws, int N, int bs, int H, int MB, int Q,
                int P, float scale) {
  // bf16 pools run MAXPASS here and their main pass in pv_kernel
  static_assert((KIND == BF16) == MAXPASS, "bf16 pools: max pass only");
  constexpr int C = D / 4;          // float4 chunks per row
  constexpr int RP = NT / C;        // rows a PV pass covers
  constexpr int RPT = (R + RP - 1) / RP;   // PV rows per thread
  constexpr int RB = R < 4 ? R : 4;        // rows per score task
  constexpr bool RAW = KIND != F32;        // lands raw, widened in smem
  const int tiles = (Q + R - 1) / R;
  const int s = blockIdx.x / tiles, r0 = (blockIdx.x % tiles) * R;
  const int h = blockIdx.y, k = blockIdx.z;
  const int tid = threadIdx.x;
  const int parts = gridDim.z;
  const int* tbl = tables + (size_t)s * MB;
  // the partition's table entries, loaded beside the slot's span so the
  // two reads share one round trip (P is a whole number of pool blocks)
  const int jb = k * (P / bs) + tid;
  const int entry = tid < P / bs && jb < MB ? tbl[jb] : 0;
  int st, cnt;
  if (count == nullptr) {           // decode: start holds the lengths
    const int length = start[s];
    st = length - 1;
    cnt = length > 0 ? 1 : 0;
  } else {
    st = start[s];
    cnt = min(count[s], Q);
  }
  const int rows = min(R, cnt - r0);
  const int W = MB * bs;
  if (rows <= 0) return;
  const int last = min(st + r0 + rows - 1, W - 1);
  const int p0 = k * P;
  if (last < p0) return;            // every row ends before the partition
  const int p1 = min(p0 + P, last + 1), nk = p1 - p0;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(D, R, P, KIND);
  float* Ks = reinterpret_cast<float*>(smem + lay.ks);
  float* Vs = reinterpret_cast<float*>(smem + lay.vs);
  float4* Qs4 = reinterpret_cast<float4*>(smem + lay.qs);
  float* Ss = reinterpret_cast<float*>(smem + lay.ss);
  float* m_sm = reinterpret_cast<float*>(smem + lay.st);
  float* l_sm = m_sm + R;
  int* blk_sm = reinterpret_cast<int*>(l_sm + R);   // [P / bs] pool blocks
  float* ksc = reinterpret_cast<float*>(smem + lay.ksc);
  float* vsc = reinterpret_cast<float*>(smem + lay.vsc);
  if (tid < P / bs) blk_sm[tid] = min(max(entry, 0), N - 1);
  __syncthreads();

  // the two-stage ring: K (and its scales) lands first, V second; the
  // scores and the softmax run while V is still in flight
  stage_rows<D, KIND>(pk, sk, RAW ? (void*)(smem + lay.kraw) : (void*)Ks,
                      ksc, blk_sm, p0, p1, bs, H, h, D + 4);
  if constexpr (!MAXPASS)
    stage_rows<D, KIND>(pv, sv, RAW ? (void*)(smem + lay.vraw) : (void*)Vs,
                        vsc, blk_sm, p0, p1, bs, H, h, D);

  // the tile's query rows (zeros past the live rows)
  const size_t qrow = (size_t)s * Q + r0;       // first row of [S * Q]
  const float4* q4 = reinterpret_cast<const float4*>(q);
  for (int i = tid; i < R * C; i += NT)
    Qs4[i] = i / C < rows ? q4[((qrow + i / C) * H + h) * C + i % C]
                          : make_float4(0.f, 0.f, 0.f, 0.f);

  if constexpr (MAXPASS)
    cp_async_wait<0>();             // this thread's K copies (no V)
  else
    cp_async_wait<1>();             // this thread's K copies
  __syncthreads();                  // everyone's
  if constexpr (RAW) {
    widen_rows<D, KIND>(smem + lay.kraw, ksc, Ks, nk, D + 4);
    __syncthreads();
  }

  // scores: one task per (group of RB rows, key), each an fmaf chain over
  // D; keys past a row's position are -inf
  const int ng = (rows + RB - 1) / RB;
  for (int task = tid; task < ng * nk; task += NT) {
    const int rg = (task / nk) * RB, i = task % nk;
    const float4* k4 = reinterpret_cast<const float4*>(Ks + i * (D + 4));
    float dot[RB];
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const float4 qv = Qs4[(rg + b) * C], kv = k4[0];
      dot[b] = fmaf(qv.w, kv.w, fmaf(qv.z, kv.z,
               fmaf(qv.y, kv.y, __fmul_rn(qv.x, kv.x))));
    }
#pragma unroll
    for (int cc = 1; cc < C; ++cc) {
      const float4 kv = k4[cc];
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const float4 qv = Qs4[(rg + b) * C + cc];
        dot[b] = fmaf(qv.w, kv.w, fmaf(qv.z, kv.z,
                 fmaf(qv.y, kv.y, fmaf(qv.x, kv.x, dot[b]))));
      }
    }
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      const int r = rg + b;
      if (r < rows) {
        const float sc = p0 + i <= st + r0 + r ? __fmul_rn(dot[b], scale)
                                               : -INFINITY;
        Ss[r * P + i] = sc;
        if constexpr (MAXPASS)
          scores_of(ws, gridDim.x / tiles * Q, H, parts, D)
              [(((qrow + r) * H + h) * parts + k) * score_pitch(P) + i] = sc;
      }
    }
  }
  __syncthreads();

  // a warp per row: max (floored at -1e30) and sum by shuffles, and
  // p = exp(s - m) once, for the sum and the PV product
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < rows; r += NW) {
    float* sr = Ss + r * P;
    float* rec = ws + ((qrow + r) * H + h) * (size_t)parts * (D + 4);
    float mx = NEG;
    for (int i = lane; i < nk; i += 32) mx = fmaxf(mx, sr[i]);
    for (int off = 16; off; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if constexpr (MAXPASS) {
      if (lane == 0) rec[k * (D + 4) + D + 2] = mx;
      continue;
    }
    float rs = 0.f;
    for (int i = lane; i < nk; i += 32) {
      const float p = expf(sr[i] - mx);
      rs += p;
      sr[i] = p;
    }
    for (int off = 16; off; off >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    if (lane == 0) {
      m_sm[r] = mx;
      l_sm[r] = rs;
    }
  }
  if constexpr (MAXPASS) return;

  cp_async_wait<0>();               // this thread's V copies
  __syncthreads();                  // everyone's, and the p rows
  if constexpr (RAW) {
    widen_rows<D, KIND>(smem + lay.vraw, vsc, Vs, nk, D);
    __syncthreads();
  }

  // PV: a thread per (row, column chunk), keys in order
  const int c = tid % C, rr = tid / C;
  const float4* V4 = reinterpret_cast<const float4*>(Vs);
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = rr + u * RP;
    if (r >= rows) break;
    const float* pr = Ss + r * P;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < nk; ++i) {
      const float p = pr[i];
      const float4 v4 = V4[i * C + c];
      av.x = fmaf(p, v4.x, av.x);
      av.y = fmaf(p, v4.y, av.y);
      av.z = fmaf(p, v4.z, av.z);
      av.w = fmaf(p, v4.w, av.w);
    }
    float* rec = ws + (((qrow + r) * H + h) * parts + k) * (D + 4);
    reinterpret_cast<float4*>(rec)[c] = av;
    if (c == 0) {
      rec[D] = m_sm[r];
      rec[D + 1] = l_sm[r];
    }
  }
}

// One warp per (row, head): the row's partials merged in partition order,
// or zeros for padding rows and inactive slots. Lane t reads the (m, l) of
// partitions t, t + 32, ...; the max is a warp reduction (exact in any
// order); then l and each lane's D / 32 columns of acc run one fmaf chain
// over k = 0, 1, ... with f_k = exp(m_k - M) passed by shuffle, so the
// records' loads do not wait on the chain.
template <int D>
__global__ void __launch_bounds__(NT)
merge_kernel(const float* __restrict__ ws, const int* __restrict__ start,
             const int* __restrict__ count, float* __restrict__ out,
             int S, int Q, int H, int W, int P, int parts) {
  constexpr int V = D / 32;         // columns per lane: 2 or 4
  const int wid = blockIdx.x * NW + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (wid >= S * Q * H) return;     // whole warps
  const int row = wid / H, h = wid % H;
  const int s = row / Q, j = row % Q;
  int st, cnt;
  if (count == nullptr) {
    const int length = start[s];
    st = length - 1;
    cnt = length > 0 ? 1 : 0;
  } else {
    st = start[s];
    cnt = min(count[s], Q);
  }
  float* o = out + (size_t)wid * D + lane * V;
  float a[V];
#pragma unroll
  for (int v = 0; v < V; ++v) a[v] = 0.f;
  // padding, an inactive slot, no table, or a row before position 0: no
  // visible key, zeros as the plain version gives
  if (j >= cnt || W == 0 || st + j < 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = 0.f;
    return;
  }
  const int K = min(st + j, W - 1) / P + 1;
  const float* rec = ws + (size_t)wid * parts * (D + 4);
  float M = -INFINITY;
  for (int k = lane; k < K; k += 32) M = fmaxf(M, rec[k * (D + 4) + D]);
  for (int off = 16; off; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float l = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int kk = k0 + lane, nk = min(32, K - k0);
    float f = 0.f, lk = 0.f;
    if (kk < K) {
      f = expf(rec[kk * (D + 4) + D] - M);
      lk = rec[kk * (D + 4) + D + 1];
    }
    for (int i = 0; i < nk; ++i) {
      const float fi = __shfl_sync(0xffffffffu, f, i);
      const float li = __shfl_sync(0xffffffffu, lk, i);
      const float* rk = rec + (k0 + i) * (D + 4) + lane * V;
      l = fmaf(li, fi, l);
#pragma unroll
      for (int v = 0; v < V; ++v) a[v] = fmaf(rk[v], fi, a[v]);
    }
  }
  const float lf = fmaxf(l, 1e-30f);
#pragma unroll
  for (int v = 0; v < V; ++v) o[v] = a[v] / lf;
}

// The bf16 pools' main pass: the (slot, row tile, head, partition) block of
// partials_kernel's grid, staging V alone. Its live rows' scores over the
// partition land as the max pass stored them (by cp.async, 16-byte pieces;
// the pieces past nk carry values no loop reads), so every p is computed
// from the f32 score partials_kernel would compute; M is the row's max over
// its partitions from the max pass's records, p = exp(s - M), l sums the
// unrounded p, and p rounded to bf16 runs the in-order fmaf chain of p.V on
// V rows widened in registers (exact).
template <int D, int R>
__global__ void __launch_bounds__(NT)
pv_kernel(const void* __restrict__ pv, const int* __restrict__ tables,
          const int* __restrict__ start, const int* __restrict__ count,
          float* __restrict__ ws, int N, int bs, int H, int MB, int Q,
          int P) {
  constexpr int C = D / 4;          // bf16 quads per row
  constexpr int RP = NT / C;        // rows a PV pass covers
  constexpr int RPT = (R + RP - 1) / RP;   // PV rows per thread
  constexpr int RW = (R + NW - 1) / NW;    // softmax rows per warp
  const int tiles = (Q + R - 1) / R;
  const int s = blockIdx.x / tiles, r0 = (blockIdx.x % tiles) * R;
  const int h = blockIdx.y, k = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int parts = gridDim.z, SQ = gridDim.x / tiles * Q;
  const int SP = score_pitch(P);
  const int* tbl = tables + (size_t)s * MB;
  const int jb = k * (P / bs) + tid;
  const int entry = tid < P / bs && jb < MB ? tbl[jb] : 0;
  int st, cnt;
  if (count == nullptr) {           // decode: start holds the lengths
    const int length = start[s];
    st = length - 1;
    cnt = length > 0 ? 1 : 0;
  } else {
    st = start[s];
    cnt = min(count[s], Q);
  }
  const int rows = min(R, cnt - r0);
  const int W = MB * bs;
  if (rows <= 0) return;
  const int last = min(st + r0 + rows - 1, W - 1);
  const int p0 = k * P;
  if (last < p0) return;            // every row ends before the partition
  const int p1 = min(p0 + P, last + 1), nk = p1 - p0;
  const size_t qrow = (size_t)s * Q + r0;       // first row of [S * Q]
  // the max pass's partition maxima of this warp's rows: a row's first 32
  // partitions load at once, before the copies below, and land while they
  // are in flight (one round trip for every row instead of one a row)
  float mx[RW];
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp + j * NW;
    mx[j] = r < rows && lane <= min(st + r0 + r, W - 1) / P
        ? ws[(((qrow + r) * H + h) * parts + lane) * (D + 4) + D + 2] : NEG;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const PvLayout lay(D, R, P);
  float* Ss = reinterpret_cast<float*>(smem + lay.ss);
  float* m_sm = reinterpret_cast<float*>(smem + lay.st);
  float* l_sm = m_sm + R;
  int* blk_sm = reinterpret_cast<int*>(l_sm + R);   // [P / bs] pool blocks
  if (tid < P / bs) blk_sm[tid] = min(max(entry, 0), N - 1);
  // the stored scores first (they need no table entry), then V
  const float* sc = scores_of(ws, SQ, H, parts, D);
  const int n4 = (nk + 3) / 4;
  for (int i = tid; i < rows * n4; i += NT) {
    const int r = i / n4, c4 = i % n4;
    cp_async16(Ss + r * SP + 4 * c4,
               sc + (((qrow + r) * H + h) * parts + k) * SP + 4 * c4);
  }
  cp_async_commit();
  __syncthreads();                  // the pool blocks
  stage_rows<D, BF16>(pv, nullptr, smem + lay.vraw, nullptr, blk_sm, p0, p1,
                      bs, H, h, D);
  cp_async_wait<1>();               // this thread's scores
  __syncthreads();                  // everyone's

  // a warp per row: M, the row's max over all its partitions (exact in any
  // order), from the maxima above and any past the first 32; p = exp(s -
  // M) once, for the sum and the PV product
#pragma unroll
  for (int j = 0; j < RW; ++j) {
    const int r = warp + j * NW;
    if (r >= rows) break;
    float* sr = Ss + r * SP;
    const float* rec = ws + ((qrow + r) * H + h) * (size_t)parts * (D + 4);
    const int K = min(st + r0 + r, W - 1) / P + 1;
    float m = mx[j];
    for (int kk = lane + 32; kk < K; kk += 32)
      m = fmaxf(m, rec[kk * (D + 4) + D + 2]);
    for (int off = 16; off; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float rs = 0.f;
    for (int i = lane; i < nk; i += 32) {
      const float p = expf(sr[i] - m);
      rs += p;
      sr[i] = round_bf16(p);
    }
    for (int off = 16; off; off >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, off);
    if (lane == 0) {
      m_sm[r] = m;
      l_sm[r] = rs;
    }
  }
  cp_async_wait<0>();               // this thread's V copies
  __syncthreads();                  // everyone's, and the p rows

  // PV: a thread per (row, column quad), keys in order, eight at a time
  // with their shared-memory loads issued first
  const int c = tid % C, rr = tid / C;
  const uint2* V2 = reinterpret_cast<const uint2*>(smem + lay.vraw);
#pragma unroll
  for (int u = 0; u < RPT; ++u) {
    const int r = rr + u * RP;
    if (r >= rows) break;
    const float* pr = Ss + r * SP;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f);
    int i = 0;
    for (; i + 8 <= nk; i += 8) {
      float p[8];
      uint2 raw[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        p[t] = pr[i + t];
        raw[t] = V2[(i + t) * C + c];
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) fma_quad(av, p[t], raw[t]);
    }
    for (; i < nk; ++i) fma_quad(av, pr[i], V2[i * C + c]);
    float* rec = ws + (((qrow + r) * H + h) * parts + k) * (D + 4);
    reinterpret_cast<float4*>(rec)[c] = av;
    if (c == 0) {
      rec[D] = m_sm[r];
      rec[D + 1] = l_sm[r];
    }
  }
}

// Launch one kernel on the call's grid with NT threads, opting into its
// dynamic shared memory first.
template <typename... Params, typename... Args>
cudaError_t launch_kernel(void (*kern)(Params...), dim3 grid, int smem,
                          cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int D, int R, int KIND>
cudaError_t launch(const float* q, const void* pk, const void* pv,
                   const float* sk, const float* sv, const int* tables,
                   const int* start, const int* count, float* out, float* ws,
                   int S, int Q, int H, int N, int bs, int MB, int P,
                   float scale, cudaStream_t stream) {
  const int W = MB * bs, parts = (W + P - 1) / P;
  if (S * Q == 0) return cudaSuccess;
  if (P <= 0 || P % bs || P / bs > MAX_BLOCKS || parts > 65535
      || H > 65535)
    return cudaErrorInvalidValue;
  const Layout lay(D, R, P, KIND);
  if (parts > 0) {
    const dim3 grid((unsigned)S * ((Q + R - 1) / R), H, parts);
    // bf16 pools: the max pass, then pv_kernel
    cudaError_t e = launch_kernel(
        partials_kernel<D, R, KIND, KIND == BF16>, grid, lay.total, stream,
        q, pk, pv, sk, sv, tables, start, count, ws, N, bs, H, MB, Q, P,
        scale);
    if (e != cudaSuccess) return e;
    if constexpr (KIND == BF16) {
      e = launch_kernel(pv_kernel<D, R>, grid, PvLayout(D, R, P).total,
                        stream, pv, tables, start, count, ws, N, bs, H, MB,
                        Q, P);
      if (e != cudaSuccess) return e;
    }
  }
  const unsigned rows_h = (unsigned)S * Q * H;   // one merge warp each
  merge_kernel<D><<<(rows_h + NW - 1) / NW, NT, 0, stream>>>(
      ws, start, count, out, S, Q, H, W, P, parts);
  return cudaGetLastError();
}

// The head-dim and row-tile dispatch both sources export through: R = 1
// for Q = 1, else R = RMAX; a head dim other than 64 or 128 is refused.
template <int RMAX, int KIND>
int dispatch(int D, const void* q, const void* pk, const void* pv,
             const void* sk, const void* sv, const void* tables,
             const void* start, const void* count, void* out, void* ws,
             int S, int Q, int H, int N, int bs, int MB, int P, float scale,
             void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* skf = static_cast<const float*>(sk);
  const float* svf = static_cast<const float*>(sv);
  const int* tb = static_cast<const int*>(tables);
  const int* stp = static_cast<const int*>(start);
  const int* cnp = static_cast<const int*>(count);
  float* of = static_cast<float*>(out);
  float* wf = static_cast<float*>(ws);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(DD, RR)                                                 \
  launch<DD, RR, KIND>(qf, pk, pv, skf, svf, tb, stp, cnp, of, wf, S, Q, H, \
                       N, bs, MB, P, scale, st)
  if (Q == 1 || RMAX == 1) {
    if (D == 64) return PAGED_LAUNCH(64, 1);
    if (D == 128) return PAGED_LAUNCH(128, 1);
  } else {
    if (D == 64) return PAGED_LAUNCH(64, RMAX);
    if (D == 128) return PAGED_LAUNCH(128, RMAX);
  }
#undef PAGED_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace paged
