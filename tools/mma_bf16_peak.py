#!/usr/bin/env python3
"""The card's rate for ``mma.sync.m16n8k16`` bf16 products with f32
accumulators, the instruction ``conv1x1_dw_bf16``'s mainloop
(``paddle_tpu_torch/csrc/conv1x1_dw_bf16.cu``) runs on.

    python3 tools/mma_bf16_peak.py

Builds a kernel in which every warp issues nothing but independent
``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` (16 accumulators a
warp, so the pipe never waits on a result), at 2, 4 and 8 warps an SM
sub-partition, times each with CUDA events and prints one JSON line per
occupancy: bf16 TFLOP/s and its share of the data-sheet 989 TFLOP/s
(dense bf16, which the H100 reaches only through ``wgmma``).
``chip_smoke.py`` calls :func:`measure` for the bound of
``conv1x1_dw_bf16`` by operations. Builds and times the kernel with
``tools/mma_tf32_peak.py``'s ``occupancy_rows``. Needs a card and
``nvcc``; builds into a temporary directory.
"""

import json
import sys
from pathlib import Path

SRC = r"""
#include <cuda_runtime.h>
__global__ void mma_peak(float* out, int iters) {
  float acc[16][4];
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // pairs of small bf16 values that keep the sums finite
  const unsigned a[4] = {0x3c003c00u + threadIdx.x, 0x3c003c00u,
                         0x3c013c01u, 0x3c023c02u};
  const unsigned b[2] = {0x3c003c00u, 0x3c033c03u + threadIdx.x};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(void* out, int blocks, int threads, int iters,
                   void* stream) {
  mma_peak<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
"""

DATASHEET_BF16_TFLOPS = 989.0


def measure(torch):
    """One row per occupancy (2, 4 and 8 warps an SM sub-partition, two
    blocks an SM): ``{"warps_per_sub_partition", "ms", "bf16_tflops",
    "share_of_989"}``, timed on the current card."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mma_tf32_peak import occupancy_rows
    rows = []
    for row in occupancy_rows(torch, SRC, 2 * 16 * 8 * 16):
        tf = row.pop("tflops")
        rows.append({**row, "bf16_tflops": tf,
                     "share_of_989": tf / DATASHEET_BF16_TFLOPS})
    return rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("mma_bf16_peak: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from mma_tf32_peak import card_line
    print(card_line())
    for row in measure(torch):
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
