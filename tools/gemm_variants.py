#!/usr/bin/env python3
"""Times conv1x1_dw and ln_matmul (chip_smoke.py's phase 7: the 15 shapes
of a ResNet-50 step and x [16384, 512] by w [512, 512] and [512, 2048])
for the tree's split-TF32 mainloop and for variants of it, each built
from an edited copy of paddle_tpu_torch/csrc/ in one process on one card:

    python3 tools/gemm_variants.py [variant ...]

Variants (edits of csrc/gemm_f32.cuh and csrc/mma_tf32.cuh, its
fragment arithmetic):
  cvt_split   the TF32 rounding by cvt.rna.tf32.f32 instead of two
              integer ops
  lo_trunc    lo passed to the tensor cores unrounded (they read its top
              19 bits)
  no_partial  every mma of a split into one accumulator, no per-k-tile
              partial sums
Prints, per variant, one JSON line: the step's summed conv1x1_dw time, the
ln_matmul times, and conv1x1_dw's error over max |plain| at the five
checked shapes. Needs a card and nvcc; builds under a temporary
directory.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RNA = "  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;"
EDITS = {
    "cvt_split": [(RNA, '  unsigned r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n"'
                        ' : "=r"(r) : "f"(v));\n  return r;')],
    "lo_trunc": [("  lo = tf32_rna(v - __uint_as_float(hi));",
                  "  lo = __float_as_uint(v - __uint_as_float(hi));")],
    "no_partial": [
        ("mma_tf32(part[i][j], al, bh[j], kk == 0);",
         "mma_tf32(acc[i][j], al, bh[j], false);"),
        ("mma_tf32(part[i][j], ah, bl[j], false);",
         "mma_tf32(acc[i][j], ah, bl[j], false);"),
        ("mma_tf32(part[i][j], ah, bh[j], false);",
         "mma_tf32(acc[i][j], ah, bh[j], false);"),
        ("acc[i][j][e] += part[i][j][e];", "{}")],
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA device visible", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.nn import cuda_conv as cc
    from paddle_tpu_torch.nn import fused_ln as fl
    from paddle_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    rows = []
    cs.log = lambda *a: rows.append(json.loads(a[1])) \
        if a and a[0] == "conv1x1_dw" else None
    orig = cuda_build.CSRC
    with tempfile.TemporaryDirectory() as tmp:
        for name in ["tree"] + sys.argv[1:]:
            src = orig
            if name != "tree":
                src = Path(tmp) / name
                shutil.copytree(orig, src)
                for old, new in EDITS[name]:
                    header = next((h for h in (src / "gemm_f32.cuh",
                                               src / "mma_tf32.cuh")
                                   if old in h.read_text()), None)
                    if header is None:
                        raise RuntimeError(f"{name}: {old!r} not in source")
                    header.write_text(header.read_text().replace(old, new))
            cuda_build.CSRC = src
            cuda_build._loaded.clear()
            cuda_build.build(["conv1x1_dw", "ln_matmul"])
            rows.clear()
            gen = torch.Generator(device="cuda").manual_seed(0)
            step = cs.phase_conv_kernels(torch, cc, gen)
            ln, _ = cs.phase_ln_kernels(torch, F, fl, gen)
            print(json.dumps({
                "variant": name, "conv1x1_dw_step_ms": step["kernel_ms"],
                "ln_matmul_ms": {r["case"]: r["kernel_ms"]
                                 for r in ln.values()},
                "conv1x1_dw_err_over_max": {
                    str(r["shape"]): r["max_abs_err"] / r["max_plain"]
                    for r in rows if "max_plain" in r}}), flush=True)
    cuda_build.CSRC = orig
    return 0


if __name__ == "__main__":
    sys.exit(main())
