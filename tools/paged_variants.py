#!/usr/bin/env python3
"""Times the split-context paged kernels for the tree's plan and sources
and for other versions of them, in one process on one card:

    python3 tools/paged_variants.py [--bf16] [--sass] [VARIANT | DIR ...]

Rows: chip_smoke.py's phases 2 and 4 (paged_decode at lengths [0, 1, 16,
17, 1024, 300, 511, 64], paged_span at the speculative [8, 5, 8, 64] and
chunk [1, 128, 8, 64] shapes, f32 and int8 pools; left out with
``--bf16``) and its bf16-pool phase (paged_decode_bf16 at those lengths,
paged_span_bf16 at both shapes, D 64 and 128).

Variants:
  part64, part256  partitions of 64 or 256 positions (the tree: 128)
  rows8, rows32    span row tiles of 8 or 32 rows (csrc/paged_span.cu's
                   kRows and the plan; the tree: 16)
Each DIR holds another version of paddle_tpu_torch/csrc/ (its
paged_decode.cu and paged_span.cu are built from the DIR) whose entries
take the tree's arguments with the tree's meaning: for example the
parent commit's sources (``git archive``), whose bf16 main pass stages K
again and recomputes the scores where the tree's reads the ones its max
pass stored (the tree's wrapper hands it a workspace with room for the
scores it does not use); name that DIR ``recompute``. A DIR's launches
a call are reported, not gated, and its device rows listed as they are.

With ``--sass`` each DIR's f32 and int8 partials instances and merge
instances are compared, instruction for instruction (``cuobjdump -sass``,
addresses left out), with the tree's: a change to the bf16 branch that
leaves those instances compiled as they were prints "identical".

Every version runs the gates of chip_smoke.py's phases for these kernels
(the plain versions within 1e-4, bf16 pools beyond the rounding slack with
the mean error gate, reruns and span rows bit-equal, no host
synchronisation), then the versions take turns in order and in reverse
order through the bf16 phase again. Prints, per version and turn, one
JSON line: per row the profiler's device time of the call (all its
launches), the CUDA-event time around it, and each launch's device time,
in ms. Needs a card and nvcc; variants build under a temporary directory.
"""

import json
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PLAN = {"part64": {"_PART_POSITIONS": 64},
        "part256": {"_PART_POSITIONS": 256}}
# variant -> (source file, [(old, new)], plan constants that follow it)
EDITS = {f"rows{r}": ("paged_span.cu", [("constexpr int kRows = 16;",
                                         f"constexpr int kRows = {r};")],
                      {"_SPAN_ROWS": r})
         for r in (8, 32)}
ROWS = ("paged_decode", "paged_decode_int8", "paged_span", "paged_span_int8",
        "paged_decode_bf16", "paged_span_bf16")
SOURCES = ("paged_decode", "paged_span")
# the f32 (pool kind 0) and int8 (1) partials instances, and the merge
UNCHANGED = re.compile(r"partials_kernelILi\d+ELi\d+ELi[01]ELb0E|merge_kernel")


def sass(cuda_build, lib):
    """Each function's SASS in ``lib``, addresses and column padding left
    out."""
    tool = Path(cuda_build._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = m[1]
            funcs[name] = []
        elif name and "/*" in ln:
            # the listing pads its columns to the module's widest line
            funcs[name].append(" ".join(
                re.sub(r"/\*[0-9a-f]{4}\*/", "", ln).split()))
    return funcs


def sass_vs_tree(cuda_build, other):
    """Per f32/int8 partials or merge instance of the paged sources:
    whether ``other``'s SASS is the tree's, instruction for instruction."""
    out = {}
    for src in SOURCES:
        mine = sass(cuda_build, cuda_build._target(src))
        theirs = sass(cuda_build, cuda_build._target(src, other))
        for name in sorted(n for n in set(mine) | set(theirs)
                           if UNCHANGED.search(n)):
            a, b = mine.get(name) or [], theirs.get(name) or []
            diff = [(x, y) for x, y in zip(a, b) if x != y]
            out[f"{src} {name[:60]}"] = "identical" if a == b else (
                f"differs: {len(diff)} of {len(a)} / {len(b)} lines, "
                f"first {diff[:2]}")
    return out


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

    args = sys.argv[1:]
    bf16_only, with_sass = "--bf16" in args, "--sass" in args
    args = [a for a in args if a not in ("--bf16", "--sass")]
    card = cs.gpu_line()
    print(card, flush=True)
    rows = []
    cs.log = lambda *a: rows.append((a[0], json.loads(a[1]))) \
        if len(a) == 2 and a[0] in ROWS else None
    orig = cuda_build.CSRC
    base = {key: getattr(ca, key) for key in
            ("_PART_POSITIONS", "_SPAN_ROWS")}
    tmp = tempfile.mkdtemp(prefix="paged_variants_")
    dirs, consts, gated = {"tree": orig}, {"tree": {}}, {"tree": True}
    for a in args:
        if a in PLAN:
            dirs[a], consts[a], gated[a] = orig, PLAN[a], True
        elif a in EDITS:
            src, edits, c = EDITS[a]
            out = Path(tmp) / a
            shutil.copytree(orig, out)
            text = (out / src).read_text()
            for old, new in edits:
                if old not in text:
                    raise RuntimeError(f"{a}: {old!r} not in source")
                text = text.replace(old, new)
            (out / src).write_text(text)
            dirs[a], consts[a], gated[a] = out, c, True
        else:
            name = Path(a).name
            dirs[name], consts[name] = Path(a).resolve(), {}
            gated[name] = False           # its launch count is its own
    with ThreadPoolExecutor(len(dirs)) as pool:
        list(pool.map(lambda d: cuda_build.build(SOURCES, d),
                      dict.fromkeys(dirs.values())))
    if with_sass:
        for name, d in dirs.items():
            if not gated[name]:
                print(json.dumps({"sass_vs_tree": name,
                                  "functions": sass_vs_tree(cuda_build, d)}),
                      flush=True)

    def use(name):
        for key, value in {**base, **consts[name]}.items():
            setattr(ca, key, value)
        cuda_build.CSRC = dirs[name]
        cuda_build._loaded.clear()

    launches = cs.paged_launches
    current = ["tree"]

    def counted(name, r):
        if gated[current[0]]:
            return launches(name, r)
        return {"launches_per_call": sum(k for _, _, k in r),
                "rows": [[n[:40], t] for n, t, _ in r]}

    order = list(dirs)
    cs.paged_launches = counted
    try:
        for turn, names in enumerate((order, order[::-1])):
            for name in names:
                use(name)
                current[0] = name
                rows.clear()
                gen = torch.Generator(device="cuda").manual_seed(0)
                if turn == 0 and not bf16_only:
                    cs.phase_paged(torch, F, ca, gen)
                    cs.phase_span_kernels(torch, F, ca, kvc, gen, card)
                cs.phase_paged_bf16(torch, F, ca, kvc, gen, card)
                print(json.dumps({
                    "variant": name, "turn": turn + 1,
                    "partition": ca.paged_plan(64, 16, 64, 5).part,
                    "rows": {f"{n} {r['case'][:22]}": [
                        r.get("device_ms"), r["kernel_ms"],
                        r.get("launch_device_ms",
                              [t for _, t, _ in r.get("device_rows", [])])]
                        for n, r in rows}}), flush=True)
    finally:
        cs.paged_launches = launches
        use("tree")
        shutil.rmtree(tmp, ignore_errors=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
