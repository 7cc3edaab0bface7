// Paged span attention (Q consecutive query tokens per slot, causal within
// the span), float32, for sm_90a.
//
// Replaces paddle_tpu/nn/pallas_attention.py:_paged_span_kernel (launched
// by paged_span_attention), plain and int8 pools: the speculative verify
// tick (Q = 1 + k) and chunked prefill (Q = chunk) attend the slot's own
// pool pages, row j of slot s at position start[s] + j seeing positions
// <= start[s] + j. n[s] == 0 writes zeros on every row; rows >= n[s] are
// padding. Blocks of R = 8 query rows each walk the slot's table up to
// ceil((start + n) / bs) pool blocks, so a long chunk re-reads the slot's
// K/V once per 8 rows (mostly from L2).
//
// The body is paged_attention.cuh's rows kernel, the same one
// paged_decode.cu runs with one row per block: every row's f32 operation
// sequence is the decode kernel's at length start + j + 1, so Q = 1 is
// bit-equal to paged_decode and so is each row of a wider span. The
// header's notes give the design and what bounds it (bytes).

#include "paged_attention.cuh"

namespace {
constexpr int kRows = 8;        // query rows per thread block
}  // namespace

// q, out: [S, Q, H, D] float32; pk, pv: [N, bs, H, D] float32; tables:
// [S, MB] int32; start, n: [S] int32. All contiguous. Returns a
// cudaError_t.
extern "C" int paged_span_f32(const void* q, const void* pk, const void* pv,
                              const void* tables, const void* start,
                              const void* n, void* out, int S, int Q, int H,
                              int D, int N, int bs, int MB, float scale,
                              void* stream) {
  return paged::dispatch<kRows, false>(D, q, pk, pv, nullptr, nullptr, tables,
                                       start, n, out, S, Q, H, N, bs, MB,
                                       scale, stream);
}

// As paged_span_f32 with int8 pools pk, pv [N, bs, H, D] and their f32 row
// scales sk, sv [N, bs, H].
extern "C" int paged_span_int8_f32(const void* q, const void* pk,
                                   const void* pv, const void* sk,
                                   const void* sv, const void* tables,
                                   const void* start, const void* n,
                                   void* out, int S, int Q, int H, int D,
                                   int N, int bs, int MB, float scale,
                                   void* stream) {
  return paged::dispatch<kRows, true>(D, q, pk, pv, sk, sv, tables, start, n,
                                      out, S, Q, H, N, bs, MB, scale, stream);
}
