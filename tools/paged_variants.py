#!/usr/bin/env python3
"""Times the split-context paged kernels (chip_smoke.py's phases 2 and 4:
paged_decode at lengths [0, 1, 16, 17, 1024, 300, 511, 64], paged_span at
the speculative [8, 5, 8, 64] and chunk [1, 128, 8, 64] shapes, plain and
int8) for the tree's plan and sources and for variants of them, in one
process on one card:

    python3 tools/paged_variants.py [variant ...]

Variants:
  part64, part256  partitions of 64 or 256 positions (the tree: 128)
  rows8, rows32    span row tiles of 8 or 32 rows (csrc/paged_span.cu's
                   kRows and the plan; the tree: 16)
Every variant runs chip_smoke.py's gates for these kernels (within 1e-4
of the plain versions, reruns and span rows bit-equal, no host
synchronisation). Prints, per variant, one JSON line: the partition, and
per row the device time of the entry's launches (profiler, both kernels
summed), the CUDA-event time around the call, and the device time of each
launch (merge, partials), in ms. Needs a card and nvcc; source variants
build under a temporary directory.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PLAN = {"part64": ("_PART_POSITIONS", 64),
        "part256": ("_PART_POSITIONS", 256)}
# source edits, each with the plan constants that must follow it
EDITS = {f"rows{r}": ([("constexpr int kRows = 16;",
                        f"constexpr int kRows = {r};")], {"_SPAN_ROWS": r})
         for r in (8, 32)}
ROWS = ("paged_decode", "paged_decode_int8", "paged_span", "paged_span_int8")


def main():
    import torch
    if not torch.cuda.is_available():
        print("paged_variants: no CUDA device visible", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.nn import cuda_attention as ca
    from paddle_tpu_torch.serve import kv_cache as kvc
    from paddle_tpu_torch.utils import cuda_build

    card = cs.gpu_line()
    print(card, flush=True)
    rows = []
    cs.log = lambda *a: rows.append((a[0], json.loads(a[1]))) \
        if len(a) == 2 and a[0] in ROWS else None
    orig = cuda_build.CSRC
    base = {key: getattr(ca, key) for key in
            ("_PART_POSITIONS", "_SPAN_ROWS")}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ["tree"] + sys.argv[1:]:
            src = orig
            for key, value in base.items():
                setattr(ca, key, value)
            if name in PLAN:
                setattr(ca, *PLAN[name])
            elif name != "tree":
                src = Path(tmp) / name
                shutil.copytree(orig, src)
                edits, consts = EDITS[name]
                source = src / "paged_span.cu"
                text = source.read_text()
                for old, new in edits:
                    if old not in text:
                        raise RuntimeError(f"{name}: {old!r} not in source")
                    text = text.replace(old, new)
                source.write_text(text)
                for key, value in consts.items():
                    setattr(ca, key, value)
            cuda_build.CSRC = src
            cuda_build._loaded.clear()
            cuda_build.build(["paged_decode", "paged_span"])
            rows.clear()
            gen = torch.Generator(device="cuda").manual_seed(0)
            cs.phase_paged(torch, F, ca, gen)
            cs.phase_span_kernels(torch, F, ca, kvc, gen, card)
            print(json.dumps({
                "variant": name, "partition": ca.paged_plan(64, 16, 64,
                                                            5).part,
                "rows": {f"{n} {r['case'][:20]}": [
                    r["device_ms"], r["kernel_ms"],
                    [t for _, t in r["device_rows"]]] for n, r in rows}}),
                flush=True)
    cuda_build.CSRC = orig
    for key, value in base.items():
        setattr(ca, key, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
