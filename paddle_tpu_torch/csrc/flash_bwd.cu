// Flash-attention backward, float32, for sm_90a: two kernels.
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
// heads. The two kernels split the work the TPU way (dq over key tiles,
// dk/dv over query tiles) rather than accumulating dq with atomics, so
// every run gives the same bits.
//
// What bounds it on the H100: the path runs it on float32 operands, and
// float32 has no tensor-core route without TF32 (about three decimal
// digits), so the products are CUDA-core FMAs at about 67 TFLOP/s. At the
// training shape [8, 4, 2048, 128] causal the backward needs five products
// per visible query-key pair, 85.9 GFLOP against 269 MB: operations bound
// it (1.28 ms), not bytes (0.08 ms). This design does seven products (s
// and dO.v^T are recomputed in both kernels) to keep the split free of
// atomics.
//
// Design, shared by both kernels: 256 threads as a 16 x 16 grid over a
// 64 x 64 tile of pairs, each thread owning a 4 x 4 patch (rows ty*4 + i,
// columns tx + 16*j) and the matching 4 rows x D/16 columns of its
// accumulators in registers. Tiles of 64 rows are staged in shared memory
// with rows padded to D + 1 floats, so the column reads of the score
// products hit distinct banks; the p / ds tile goes through shared memory
// once for the accumulating products. Masked pairs get a score of -inf,
// so p = 0 for them and for padding rows (whose LSE is about -1e30); rows
// past T are masked the same way and never written. Whole tiles are
// skipped by the forward's rules: the causal cone, and segment-id ranges
// that cannot meet (_block_needed / _seg_block_relevant). Both kernels
// take far more shared memory than the default 48 KB (at D = 128: dq
// 149 KB, dk/dv 166 KB), opted into with cudaFuncSetAttribute, so one
// block runs per SM.
//
//   flash_bwd_dq:  one block per (b*h, 64-row query tile); Q, dO, LSE and
//                  delta stay resident, K and V tiles stream through the
//                  loop that replaces the TPU's sequential key-block axis.
//                  Under causal masking the grid walks the query tiles from
//                  the last (longest) one.
//   flash_bwd_dkv: one block per (b*h, 64-row key tile); K and V stay
//                  resident, Q, dO, LSE and delta tiles stream. Under
//                  causal masking key tile t starts at query tile t.
//
// Left for later work: wgmma/TMA pipelines, bf16, fusing delta into a
// prologue, more blocks per SM.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

// Rows [row0, row0 + ROWS) of a [T, D] matrix into shared memory with row
// stride ld; rows past T are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int row0, int T) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T)
      val = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    float* d = dst + r * ld + c;
    d[0] = val.x; d[1] = val.y; d[2] = val.z; d[3] = val.w;
  }
}

// min and max segment id over the live rows of a 64-row tile; warp 0 only.
__device__ __forceinline__ void seg_range(const int* __restrict__ seg,
                                          int row0, int T, int* out) {
  int mn = INT_MAX, mx = INT_MIN;
  for (int r = threadIdx.x; r < 64; r += 32) {
    if (row0 + r < T) {
      const int s = seg[row0 + r];
      mn = min(mn, s);
      mx = max(mx, s);
    }
  }
  for (int off = 16; off; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (threadIdx.x == 0) { out[0] = mn; out[1] = mx; }
}

// Whether a query tile with ids in [r[0], r[1]] and a key tile with ids in
// [r[2], r[3]] can hold a visible pair (_seg_block_relevant).
__device__ __forceinline__ bool seg_tiles_meet(const int* r) {
  return r[0] <= r[3] && r[1] >= r[2] && r[1] > 0 && r[3] > 0;
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * BQ * (D + 1) + BQ * (BK + 1);
}

template <int D>
constexpr int dkv_smem_floats() {
  return 4 * BQ * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ seg,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int T, float scale, int causal) {
  constexpr int CPT = D / 16;               // dq columns per thread
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                         // [BQ][LD]
  float* dOs = Qs + BQ * LD;                // [BQ][LD]
  float* Ks = dOs + BQ * LD;                // [BK][LD]
  float* Vs = Ks + BK * LD;                 // [BK][LD]
  float* dSs = Vs + BK * LD;                // [BQ][BK + 1]
  __shared__ int srange[4];                 // q min, q max, k min, k max

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int qt = causal ? (gridDim.x - 1 - blockIdx.x) : blockIdx.x;
  const int q0 = qt * BQ;
  const size_t base = (size_t)bh * T * D;
  const int* segb = seg ? seg + (size_t)(bh / H) * T : nullptr;

  load_tile<D, BQ>(Qs, LD, q + base, q0, T);
  load_tile<D, BQ>(dOs, LD, dout + base, q0, T);

  float lse_r[4], delta_r[4];
  int qseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lse_r[i] = row < T ? lse[(size_t)bh * T + row] : 0.f;
    delta_r[i] = row < T ? delta[(size_t)bh * T + row] : 0.f;
    qseg[i] = (segb && row < T) ? segb[row] : 0;
  }
  if (segb && threadIdx.x < 32) seg_range(segb, q0, T, srange);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int n_kt_all = (T + BK - 1) / BK;
  const int n_kt = causal ? min(qt + 1, n_kt_all) : n_kt_all;  // BQ == BK
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (segb) {
      __syncthreads();
      if (threadIdx.x < 32) seg_range(segb, k0, T, srange + 2);
      __syncthreads();
      if (!seg_tiles_meet(srange)) continue;
    }
    load_tile<D, BK>(Ks, LD, k + base, k0, T);
    load_tile<D, BK>(Vs, LD, v + base, k0, T);
    __syncthreads();

    // s = Q.K^T and dp = dO.V^T over this tile, a 4 x 4 patch each
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty * 4 + i) * LD + d];
        g[i] = dOs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Ks[(tx + 16 * j) * LD + d];
        w[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }

    // ds = p * (dp - delta), p = exp(s * scale - LSE), masked pairs p = 0
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool vis = qi < T && kj < T;
        if (causal) vis = vis && kj <= qi;
        if (segb) {
          const int ks = kj < T ? segb[kj] : 0;
          vis = vis && ks == qseg[i] && ks > 0;
        }
        const float sv = vis ? s[i][j] * scale : -INFINITY;
        const float p = expf(sv - lse_r[i]);
        dSs[(ty * 4 + i) * (BK + 1) + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

    // dq += ds . K
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty * 4 + i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float kv = Ks[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      dq[base + (size_t)row * D + tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int T, float scale,
                     int causal) {
  constexpr int CPT = D / 16;               // dk / dv columns per thread
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                         // [BK][LD]
  float* Vs = Ks + BK * LD;                 // [BK][LD]
  float* Qs = Vs + BK * LD;                 // [BQ][LD]
  float* dOs = Qs + BQ * LD;                // [BQ][LD]
  float* Ps = dOs + BQ * LD;                // [BK][BQ + 1]  p^T
  float* dSs = Ps + BK * (BQ + 1);          // [BK][BQ + 1]  ds^T
  float* Ls = dSs + BK * (BQ + 1);          // [BQ]  LSE of the query tile
  float* Dl = Ls + BQ;                      // [BQ]  delta of the query tile
  __shared__ int srange[4];                 // q min, q max, k min, k max

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int bh = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * BK;
  const size_t base = (size_t)bh * T * D;
  const int* segb = seg ? seg + (size_t)(bh / H) * T : nullptr;

  load_tile<D, BK>(Ks, LD, k + base, k0, T);
  load_tile<D, BK>(Vs, LD, v + base, k0, T);

  int kseg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    kseg[i] = (segb && row < T) ? segb[row] : 0;
  }
  if (segb && threadIdx.x < 32) seg_range(segb, k0, T, srange + 2);

  float dk_acc[4][CPT], dv_acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) { dk_acc[i][c] = 0.f; dv_acc[i][c] = 0.f; }

  const int n_qt = (T + BQ - 1) / BQ;
  for (int qt = causal ? kt : 0; qt < n_qt; ++qt) {   // BQ == BK
    const int q0 = qt * BQ;
    if (segb) {
      __syncthreads();
      if (threadIdx.x < 32) seg_range(segb, q0, T, srange);
      __syncthreads();
      if (!seg_tiles_meet(srange)) continue;
    }
    load_tile<D, BQ>(Qs, LD, q + base, q0, T);
    load_tile<D, BQ>(dOs, LD, dout + base, q0, T);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool live = q0 + r < T;
      Ls[r] = live ? lse[(size_t)bh * T + q0 + r] : 0.f;
      Dl[r] = live ? delta[(size_t)bh * T + q0 + r] : 0.f;
    }
    __syncthreads();

    // s^T = K.Q^T and dp^T = V.dO^T: key rows ty*4 + i, query cols tx + 16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) { s[i][j] = 0.f; dp[i][j] = 0.f; }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], w[4], b[4], g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Ks[(ty * 4 + i) * LD + d];
        w[i] = Vs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Qs[(tx + 16 * j) * LD + d];
        g[j] = dOs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], g[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kj = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int qi = q0 + qc;
        bool vis = qi < T && kj < T;
        if (causal) vis = vis && kj <= qi;
        if (segb) {
          const int qs = qi < T ? segb[qi] : 0;
          vis = vis && qs == kseg[i] && qs > 0;
        }
        const float sv = vis ? s[i][j] * scale : -INFINITY;
        const float p = expf(sv - Ls[qc]);
        Ps[(ty * 4 + i) * (BQ + 1) + qc] = p;
        dSs[(ty * 4 + i) * (BQ + 1) + qc] = p * (dp[i][j] - Dl[qc]);
      }
    }
    __syncthreads();

    // dv += p^T . dO and dk += ds^T . Q
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Ps[(ty * 4 + i) * (BQ + 1) + qq];
        ds[i] = dSs[(ty * 4 + i) * (BQ + 1) + qq];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float g = dOs[qq * LD + tx + 16 * c];
        const float qv = Qs[qq * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(p[i], g, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= T) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const size_t at = base + (size_t)row * D + tx + 16 * c;
      dk[at] = dk_acc[i][c] * scale;
      dv[at] = dv_acc[i][c];
    }
  }
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v,
                      const int* seg, const float* dout, const float* lse,
                      const float* delta, float* dq, int B, int H, int T,
                      float scale, int causal, cudaStream_t stream) {
  const int bytes = dq_smem_floats<D>() * (int)sizeof(float);
  // above 48 KB a block's shared memory must be opted into per kernel
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<D><<<grid, NT, bytes, stream>>>(
      q, k, v, seg, dout, lse, delta, dq, H, T, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v,
                       const int* seg, const float* dout, const float* lse,
                       const float* delta, float* dk, float* dv, int B, int H,
                       int T, float scale, int causal, cudaStream_t stream) {
  const int bytes = dkv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<D><<<grid, NT, bytes, stream>>>(
      q, k, v, seg, dout, lse, delta, dk, dv, H, T, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dq: [B, H, T, D] float32, contiguous. seg: [B, T] int32
// or null. lse, delta: [B, H, T] float32. Returns a cudaError_t (0 =
// launched).
extern "C" int flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                const void* seg, const void* dout,
                                const void* lse, const void* delta, void* dq,
                                int B, int H, int T, int D, float scale,
                                int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* sg = static_cast<const int*>(seg);
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* out = static_cast<float*>(dq);
  if (D == 64)
    return launch_dq<64>(qf, kf, vf, sg, gf, lf, df, out, B, H, T, scale,
                         causal, st);
  if (D == 128)
    return launch_dq<128>(qf, kf, vf, sg, gf, lf, df, out, B, H, T, scale,
                          causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd_dq_f32, writing dk and dv [B, H, T, D] float32.
extern "C" int flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                 const void* seg, const void* dout,
                                 const void* lse, const void* delta, void* dk,
                                 void* dv, int B, int H, int T, int D,
                                 float scale, int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const int* sg = static_cast<const int*>(seg);
  const float* gf = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  if (D == 64)
    return launch_dkv<64>(qf, kf, vf, sg, gf, lf, df, dkf, dvf, B, H, T,
                          scale, causal, st);
  if (D == 128)
    return launch_dkv<128>(qf, kf, vf, sg, gf, lf, df, dkf, dvf, B, H, T,
                           scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
