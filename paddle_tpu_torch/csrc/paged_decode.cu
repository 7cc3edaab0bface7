// Paged decode attention (one query token per slot), float32 queries and
// output, for sm_90a.
//
// Replaces paddle_tpu/nn/pallas_attention.py:_paged_decode_kernel
// (launched by paged_decode_attention), over f32, bf16 and int8 pools: for
// each (slot, head) the single new-token query attends the pool blocks
// that the slot's row of the block table names, with an online softmax
// over the slot's ragged length; positions at or past the length are
// masked and a length-0 slot writes zeros. An int8 pool's rows are
// dequantized with their f32 scales in shared memory, never in HBM; a bf16
// pool's rows are widened there, and p is rounded to bf16 before p.V as
// JAX rounds it. A table entry outside [0, N) is clamped, as XLA's gather
// clamps.
//
// The body is paged_attention.cuh's split-context pair (partials over
// fixed partitions of the context, then an in-order merge) with one row
// per block (R = 1): decode at length L is the span row at start L - 1, so
// paged_span.cu's rows are bit-equal to this kernel at start + j + 1. The
// header's notes give the design and what bounds it (bytes).

#include "paged_attention.cuh"

// q, out: [S, H, D] float32; pk, pv: [N, bs, H, D] float32; tables: [S, MB]
// int32; lengths: [S] int32; ws: the partials workspace, [S, 1, H,
// ceil(MB * bs / part), D + 4] float32; part: the plan's partition size in
// positions, a multiple of bs. All contiguous. Returns a cudaError_t.
extern "C" int paged_decode_f32(const void* q, const void* pk, const void* pv,
                                const void* tables, const void* lengths,
                                void* out, void* ws, int S, int H, int D,
                                int N, int bs, int MB, int part, float scale,
                                void* stream) {
  return paged::dispatch<1, paged::F32>(D, q, pk, pv, nullptr, nullptr, tables,
                                   lengths, nullptr, out, ws, S, 1, H, N, bs,
                                   MB, part, scale, stream);
}

// As paged_decode_f32 with int8 pools pk, pv [N, bs, H, D] and their f32
// row scales sk, sv [N, bs, H].
extern "C" int paged_decode_int8_f32(const void* q, const void* pk,
                                     const void* pv, const void* sk,
                                     const void* sv, const void* tables,
                                     const void* lengths, void* out,
                                     void* ws, int S, int H, int D, int N,
                                     int bs, int MB, int part, float scale,
                                     void* stream) {
  return paged::dispatch<1, paged::INT8>(D, q, pk, pv, sk, sv, tables, lengths,
                                  nullptr, out, ws, S, 1, H, N, bs, MB, part,
                                  scale, stream);
}

// As paged_decode_f32 with bf16 pools pk, pv [N, bs, H, D]; ws holds the
// records, then the max pass's scores [S, 1, H, parts, part rounded up to
// 4] float32 (PagedPlan.workspace_numel).
extern "C" int paged_decode_bf16_f32(const void* q, const void* pk,
                                     const void* pv, const void* tables,
                                     const void* lengths, void* out,
                                     void* ws, int S, int H, int D, int N,
                                     int bs, int MB, int part, float scale,
                                     void* stream) {
  return paged::dispatch<1, paged::BF16>(D, q, pk, pv, nullptr, nullptr,
                                         tables, lengths, nullptr, out, ws,
                                         S, 1, H, N, bs, MB, part, scale,
                                         stream);
}
