// Paged span attention (Q consecutive query tokens per slot, causal within
// the span), float32 queries and output, for sm_90a.
//
// Replaces paddle_tpu/nn/pallas_attention.py:_paged_span_kernel (launched
// by paged_span_attention), over f32, bf16 and int8 pools: the speculative
// verify tick (Q = 1 + k) and chunked prefill (Q = chunk) attend the
// slot's own pool pages, row j of slot s at position start[s] + j seeing
// positions <= start[s] + j. n[s] == 0 writes zeros on every row; rows >= n[s] are
// padding and get zeros. Blocks of R = 16 query rows (one row at Q = 1)
// share each staged K/V partition, so a chunk of Q rows reads the slot's
// K/V ceil(Q / 16) times (the TPU kernel keeps all Q rows in one block; 16
// rows keep the grid wide enough to fill the card).
//
// The body is paged_attention.cuh's split-context pair, the one
// paged_decode.cu runs with one row per block: every row's f32 operation
// sequence is the decode kernel's at length start + j + 1, so Q = 1 is
// bit-equal to paged_decode and so is each row of a wider span. The
// header's notes give the design and what bounds it (bytes).

#include "paged_attention.cuh"

namespace {
constexpr int kRows = 16;       // query rows per thread block (Q > 1)
}  // namespace

// q, out: [S, Q, H, D] float32; pk, pv: [N, bs, H, D] float32; tables:
// [S, MB] int32; start, n: [S] int32; ws: the partials workspace, [S, Q, H,
// ceil(MB * bs / part), D + 4] float32; part: the plan's partition size in
// positions, a multiple of bs. All contiguous. Returns a cudaError_t.
extern "C" int paged_span_f32(const void* q, const void* pk, const void* pv,
                              const void* tables, const void* start,
                              const void* n, void* out, void* ws, int S,
                              int Q, int H, int D, int N, int bs, int MB,
                              int part, float scale, void* stream) {
  return paged::dispatch<kRows, paged::F32>(D, q, pk, pv, nullptr, nullptr, tables,
                                       start, n, out, ws, S, Q, H, N, bs, MB,
                                       part, scale, stream);
}

// As paged_span_f32 with int8 pools pk, pv [N, bs, H, D] and their f32 row
// scales sk, sv [N, bs, H].
extern "C" int paged_span_int8_f32(const void* q, const void* pk,
                                   const void* pv, const void* sk,
                                   const void* sv, const void* tables,
                                   const void* start, const void* n,
                                   void* out, void* ws, int S, int Q, int H,
                                   int D, int N, int bs, int MB, int part,
                                   float scale, void* stream) {
  return paged::dispatch<kRows, paged::INT8>(D, q, pk, pv, sk, sv, tables, start, n,
                                      out, ws, S, Q, H, N, bs, MB, part, scale,
                                      stream);
}

// As paged_span_f32 with bf16 pools pk, pv [N, bs, H, D]; ws holds the
// records, then the max pass's scores [S, Q, H, parts, part rounded up to
// 4] float32 (PagedPlan.workspace_numel).
extern "C" int paged_span_bf16_f32(const void* q, const void* pk,
                                   const void* pv, const void* tables,
                                   const void* start, const void* n,
                                   void* out, void* ws, int S, int Q, int H,
                                   int D, int N, int bs, int MB, int part,
                                   float scale, void* stream) {
  return paged::dispatch<kRows, paged::BF16>(D, q, pk, pv, nullptr, nullptr,
                                             tables, start, n, out, ws, S, Q,
                                             H, N, bs, MB, part, scale,
                                             stream);
}

// The partials kernel's dynamic shared memory in bytes for head dim D, row
// tile R, partition size part and pool kind (0 f32, 1 int8, 2 bf16): the
// figure the wrapper's plan must reproduce.
extern "C" int paged_smem_bytes(int D, int R, int part, int pool) {
  return paged::Layout(D, R, part, pool).total;
}

// pv_kernel's (the bf16 pools' main pass) dynamic shared memory in bytes
// for head dim D, row tile R and partition size part: the plan's pv_smem.
extern "C" int paged_pv_smem_bytes(int D, int R, int part) {
  return paged::PvLayout(D, R, part).total;
}
