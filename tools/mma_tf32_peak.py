#!/usr/bin/env python3
"""The card's rate for ``mma.sync.m16n8k8`` TF32 products, the instruction
the split-TF32 mainloop (``paddle_tpu_torch/csrc/gemm_f32.cuh``) runs on.

    python3 tools/mma_tf32_peak.py

Builds a kernel in which every warp issues nothing but independent
``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` (16 accumulators a
warp, so the pipe never waits on a result), at 2, 4 and 8 warps an SM
sub-partition, times each with CUDA events and prints one JSON line per
occupancy: TF32 TFLOP/s, its share of the data-sheet 495 TFLOP/s (dense
TF32, which the H100 reaches only through ``wgmma``), and a third of it,
the ceiling of f32-accurate work on three TF32 products. Needs a card and
``nvcc``; builds into a temporary directory.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

SRC = r"""
#include <cuda_runtime.h>
__global__ void mma_peak(float* out, int iters) {
  float acc[16][4];
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // small TF32 bit patterns that keep the sums finite
  const unsigned a[4] = {0x3c000000u + (threadIdx.x << 13), 0x3c000000u,
                         0x3c002000u, 0x3c004000u};
  const unsigned b[2] = {0x3c000000u, 0x3c006000u + (threadIdx.x << 13)};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
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


def occupancy_rows(torch, src, mma_flops):
    """Builds ``src`` (a kernel ``run(out, blocks, threads, iters,
    stream)`` in which each warp issues 16 independent ``mma.sync`` of
    ``mma_flops`` operations per iteration) and times it at 2, 4 and 8
    warps an SM sub-partition, two blocks an SM: one row per occupancy,
    ``{"warps_per_sub_partition", "ms", "tflops"}``."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from paddle_tpu_torch.utils.cuda_build import NVCC_FLAGS, _nvcc
    with tempfile.TemporaryDirectory() as d:
        cu, lib = Path(d) / "mma_peak.cu", Path(d) / "libmma_peak.so"
        cu.write_text(src)
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(cu)],
                       check=True, capture_output=True)
        fn = ctypes.CDLL(str(lib)).run
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms, iters = torch.cuda.get_device_properties(0).multi_processor_count, \
        4096
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for warps_per_smsp in (2, 4, 8):
        threads = 128 * warps_per_smsp // 2      # two blocks an SM
        blocks = 2 * sms
        out = torch.empty(blocks * threads, device="cuda")
        for _ in range(2):                       # warm-up
            if fn(out.data_ptr(), blocks, threads, iters, stream) != 0:
                raise RuntimeError("mma peak: launch failed")
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        if fn(out.data_ptr(), blocks, threads, iters, stream) != 0:
            raise RuntimeError("mma peak: launch failed")
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        flops = blocks * threads // 32 * iters * 16 * mma_flops
        rows.append({"warps_per_sub_partition": warps_per_smsp, "ms": ms,
                     "tflops": flops / ms / 1e9})
    return rows


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def main():
    import torch
    if not torch.cuda.is_available():
        print("mma_tf32_peak: no CUDA device visible", file=sys.stderr)
        return 2
    print(card_line())
    for row in occupancy_rows(torch, SRC, 2 * 16 * 8 * 8):
        tf = row.pop("tflops")
        print(json.dumps({**row, "tf32_tflops": tf,
                          "share_of_495": tf / 495,
                          "f32_accurate_tflops_3x": tf / 3}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
