// Paged attention rows over a paged KV pool, float32, for sm_90a: the one
// kernel body behind paged_decode.cu (one query row per slot) and
// paged_span.cu (Q consecutive query rows per slot, causal within the span).
//
// Replaces the shared body of paddle_tpu/nn/pallas_attention.py's
// _paged_decode_kernel and _paged_span_kernel, plain and int8 ("quant")
// pools alike. Row j of slot s is the query at position start[s] + j; it
// sees the pool positions <= start[s] + j of the blocks the slot's table
// row names, with an online softmax (running max from -1e30, sum clamped at
// 1e-30 at the end). A slot with n == 0 writes zeros on every row, whatever
// its start; rows >= n are padding, computed like the others and ignored
// by the caller. Decode is the span with Q = 1, start = length - 1 and
// n = (length > 0).
//
// What bounds it on the H100: bytes. Each key and value row is read once
// per block of rows and used for 2 * D flops per query row, far below the
// card's operations-per-byte balance, so the floor is the K/V bytes the
// spans cover (int8: 1 byte per element plus one f32 scale per row) over
// 3.35 TB/s.
//
// Design: one thread block per (head, slot, tile of R query rows), 128
// threads; a thread owns one float4 column chunk c of D and a key group g.
// The block reads its own table row and span (the TPU kernel's scalar
// prefetch) and walks ceil((start + n) / bs) pool blocks (clamped to the
// table width). For each pool block it stages the [bs, D] K and V tiles
// in shared memory; an int8 pool is loaded as char4 and multiplied by the
// row's f32 scale there (k = float(q) * s, as the TPU kernel does), so no
// dequantized copy ever reaches HBM. Scores come from per-chunk dot
// products reduced across the chunk's lanes with warp shuffles; thread r
// keeps row r's running max and sum; every thread keeps float4 partial
// accumulators for each row, summed across key groups at the end.
//
// Bit-equality contract: every query row runs the same sequence of f32
// operations whatever R, Q and the other rows are (explicit fmaf/__fmul_rn,
// the same key-to-group partition, shuffle tree, serial max and sum order,
// and cross-group sum), so row j of a span equals the decode kernel run at
// length start + j + 1 bit for bit. A pool block that is fully masked for a
// row leaves its state unchanged: the max stays, exp(-inf) = 0, and
// fmaf(0, v, acc) = acc on finite pools.
//
// Left for later work: split-K over the context (flash-decoding) to fill
// more SMs, double-buffered block loads, one K/V pass for all rows of a
// long span, tensor cores for the span's QK^T and PV.

#pragma once

#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace paged {

constexpr int NT = 128;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, __fmul_rn(a.x, b.x))));
}

__device__ __forceinline__ float4 deq4(const char4 v, const float s) {
  return make_float4(__fmul_rn(static_cast<float>(v.x), s),
                     __fmul_rn(static_cast<float>(v.y), s),
                     __fmul_rn(static_cast<float>(v.z), s),
                     __fmul_rn(static_cast<float>(v.w), s));
}

// One pool block's online-softmax step for one query row: folds the row's
// bs scores into its running max m and sum l, and returns the factor that
// rescales the row's old accumulator.
__device__ __forceinline__ float row_step(const float* sr, int bs, float& m,
                                          float& l) {
  float mx = -INFINITY;
  for (int i = 0; i < bs; ++i) mx = fmaxf(mx, sr[i]);
  const float m_new = fmaxf(m, mx);
  const float corr = expf(m - m_new);
  float rs = 0.f;
  for (int i = 0; i < bs; ++i) rs += expf(sr[i] - m_new);
  l = fmaf(l, corr, rs);
  m = m_new;
  return corr;
}

// Row (blk, r, h) of a [N, bs, H, D] pool, chunk cc, as f32.
template <bool INT8>
__device__ __forceinline__ float4 load_row4(const void* pool,
                                            const float* scales, size_t row,
                                            int C, int cc) {
  if constexpr (INT8) {
    const char4 v = static_cast<const char4*>(pool)[row * C + cc];
    return deq4(v, scales[row]);
  } else {
    return static_cast<const float4*>(pool)[row * C + cc];
  }
}

template <int D, int R, bool INT8>
__global__ void __launch_bounds__(NT)
rows_kernel(const float* __restrict__ q, const void* __restrict__ pk,
            const void* __restrict__ pv, const float* __restrict__ sk,
            const float* __restrict__ sv, const int* __restrict__ tables,
            const int* __restrict__ start, const int* __restrict__ count,
            float* __restrict__ out, int N, int bs, int H, int MB, int Q,
            float scale) {
  constexpr int C = D / 4;      // float4 chunks per row: 16 or 32 lanes
  constexpr int G = NT / C;     // key groups
  extern __shared__ float4 sm4[];
  float4* Ks = sm4;                               // [bs][C]
  float4* Vs = Ks + bs * C;                       // [bs][C]
  float4* Qs = Vs + bs * C;                       // [R][C]
  float4* red = Qs + R * C;                       // [G][C]
  float* s_sm = reinterpret_cast<float*>(red + G * C);   // [R][bs]
  // per-row state: thread r keeps row r's and shares it through shared
  // memory; a one-row block (decode) keeps it in every thread's registers
  // instead, each thread running the row's serial pass itself
  float* m_sm = s_sm + R * bs;                    // [R] running max
  float* l_sm = m_sm + R;                         // [R] running sum
  float* c_sm = l_sm + R;                         // [R] this block's rescale
  float m1 = NEG, l1 = 0.f, c1 = 1.f;

  const int h = blockIdx.x, s = blockIdx.y, r0 = blockIdx.z * R;
  const int c = threadIdx.x % C, g = threadIdx.x / C;
  const int rows = min(R, Q - r0);
  int st, cnt;
  if (count == nullptr) {       // decode: start holds the lengths
    const int length = start[s];
    st = length - 1;
    cnt = length > 0 ? 1 : 0;
  } else {
    st = start[s];
    cnt = count[s];
  }
  const size_t qrow = (size_t)s * Q + r0;         // first row of [S * Q]
  float4* o4 = reinterpret_cast<float4*>(out);
  if (cnt <= 0) {
    for (int i = threadIdx.x; i < rows * C; i += NT)
      o4[((qrow + i / C) * H + h) * C + i % C] =
          make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float4* q4 = reinterpret_cast<const float4*>(q);
  for (int i = threadIdx.x; i < rows * C; i += NT)
    Qs[i] = q4[((qrow + i / C) * H + h) * C + i % C];
  if (threadIdx.x < R) {
    m_sm[threadIdx.x] = NEG;
    l_sm[threadIdx.x] = 0.f;
  }
  const int nblk = min((st + cnt + bs - 1) / bs, MB);
  const int* tbl = tables + (size_t)s * MB;

  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j = 0; j < nblk; ++j) {
    const int blk = min(max(tbl[j], 0), N - 1);
    for (int i = threadIdx.x; i < bs * C; i += NT) {
      const size_t row = ((size_t)blk * bs + i / C) * H + h;
      Ks[i] = load_row4<INT8>(pk, sk, row, C, i % C);
      Vs[i] = load_row4<INT8>(pv, sv, row, C, i % C);
    }
    __syncthreads();

    // scores of every (row, key) pair; every thread runs the same trip
    // count, so the shuffles see full warps
    for (int p0 = 0; p0 < rows * bs; p0 += G) {
      const int p = p0 + g;
      const int r = p / bs, i = p % bs;
      float part = 0.f;
      if (p < rows * bs) part = dot4(Qs[r * C + c], Ks[i * C + c]);
      for (int off = C / 2; off; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (c == 0 && p < rows * bs)
        s_sm[p] = j * bs + i <= st + r0 + r ? __fmul_rn(part, scale)
                                             : -INFINITY;
    }
    __syncthreads();

    if constexpr (R == 1) {
      c1 = row_step(s_sm, bs, m1, l1);
    } else {
      if (threadIdx.x < rows) {
        const int r = threadIdx.x;
        float m = m_sm[r], l = l_sm[r];
        c_sm[r] = row_step(s_sm + r * bs, bs, m, l);
        m_sm[r] = m;
        l_sm[r] = l;
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) break;
      const float corr = R == 1 ? c1 : c_sm[r];
      const float m_new = R == 1 ? m1 : m_sm[r];
      float4 a = acc[r];
      a.x = __fmul_rn(a.x, corr);
      a.y = __fmul_rn(a.y, corr);
      a.z = __fmul_rn(a.z, corr);
      a.w = __fmul_rn(a.w, corr);
      for (int i = g; i < bs; i += G) {
        const float p = expf(s_sm[r * bs + i] - m_new);
        const float4 v4 = Vs[i * C + c];
        a.x = fmaf(p, v4.x, a.x);
        a.y = fmaf(p, v4.y, a.y);
        a.z = fmaf(p, v4.z, a.z);
        a.w = fmaf(p, v4.w, a.w);
      }
      acc[r] = a;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) break;
    red[g * C + c] = acc[r];
    __syncthreads();
    if (threadIdx.x < C) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int gg = 0; gg < G; ++gg) {
        const float4 a = red[gg * C + c];
        sum.x += a.x; sum.y += a.y; sum.z += a.z; sum.w += a.w;
      }
      const float lf = fmaxf(R == 1 ? l1 : l_sm[r], 1e-30f);
      o4[((qrow + r) * H + h) * C + c] =
          make_float4(sum.x / lf, sum.y / lf, sum.z / lf, sum.w / lf);
    }
    __syncthreads();
  }
}

template <int D, int R>
constexpr size_t smem_bytes(int bs) {
  return (size_t)(2 * bs * (D / 4) + R * (D / 4) + NT) * sizeof(float4)
         + (size_t)(R * bs + 3 * R) * sizeof(float);
}

template <int D, int R, bool INT8>
cudaError_t launch_rows(const float* q, const void* pk, const void* pv,
                        const float* sk, const float* sv, const int* tables,
                        const int* start, const int* count, float* out,
                        int S, int Q, int H, int N, int bs, int MB,
                        float scale, cudaStream_t stream) {
  const dim3 grid(H, S, (Q + R - 1) / R);
  rows_kernel<D, R, INT8><<<grid, NT, smem_bytes<D, R>(bs), stream>>>(
      q, pk, pv, sk, sv, tables, start, count, out, N, bs, H, MB, Q, scale);
  return cudaGetLastError();
}

// The head-dim dispatch both sources export through; a head dim other than
// 64 or 128 is refused.
template <int R, bool INT8>
int dispatch(int D, const void* q, const void* pk, const void* pv,
             const void* sk, const void* sv, const void* tables,
             const void* start, const void* count, void* out, int S, int Q,
             int H, int N, int bs, int MB, float scale, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* skf = static_cast<const float*>(sk);
  const float* svf = static_cast<const float*>(sv);
  const int* tb = static_cast<const int*>(tables);
  const int* stp = static_cast<const int*>(start);
  const int* cnp = static_cast<const int*>(count);
  float* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_rows<64, R, INT8>(qf, pk, pv, skf, svf, tb, stp, cnp, of, S,
                                    Q, H, N, bs, MB, scale, st);
  if (D == 128)
    return launch_rows<128, R, INT8>(qf, pk, pv, skf, svf, tb, stp, cnp, of,
                                     S, Q, H, N, bs, MB, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace paged
