#!/usr/bin/env python3
"""Times the flash-attention backward kernels (chip_smoke.py's phase 2:
flash_bwd_dq and flash_bwd_dkv at its cases, the training shape
[8, 4, 2048, 128] causal, [2, 8, 512, 128] with packed segments and
[17, 4, 2048, 128] causal past the stored ds's budget) for the tree's
plan and sources and for variants of them, in one process on one card:

    python3 tools/flash_bwd_variants.py [variant ...]
    python3 tools/flash_bwd_variants.py --sass [DIR]

With --sass it times nothing: it builds the tree's flash_bwd.cu and prints
the opcode mix of each large D = 128 instance's SASS (cuobjdump), over the
whole kernel and over its hot loop (from the first block barrier to the
last HMMA); given DIR, another version of paddle_tpu_torch/csrc/ (the
parent commit's, from ``git archive``), it also builds DIR's flash_bwd.cu
and says of every f32 instance (flash_bwd_dq_kernel, flash_bwd_dkv_kernel,
flash_bwd_dq_ds_kernel over Cfg) whether its SASS is DIR's, instruction
for instruction (the names' anonymous-namespace hash left out).

Variants:
  large, small   every shape on the large (64 resident rows, streamed
                 tiles of 32) or the small instance (32 rows, tiles of 16)
  split_per_use  the resident operands kept as f32 and split at every
                 fragment load, as the streamed ones are (the tree splits
                 them once, into hi/lo planes)
  bs16           the large instance with streamed tiles of 16 rows
  stages3        the large instance with streamed tiles of 16 rows in a
                 ring of 3 stages
  chunks1, chunks2  1 or 2 score partials (32 d each) in flight a warp
                 (the tree: all of D, 4 at D = 128)
  expf           p by expf instead of ex2.approx.ftz
  tree           the tree again (a control, last in a list)
Every variant runs chip_smoke.py's gates for these kernels (within 1e-4
of the plain versions relative to max(1, max |plain|), reruns bit-equal)
and the build's ptxas report (no spills); a variant that fails one prints
the failure and the next one runs. Prints, per variant, one JSON line:
per row (flash_bwd_dq and flash_bwd_dkv each both ways, with and without
the stored ds, and flash_attention_bwd, the whole backward) and case the
device time of its launches (profiler, ms), the CUDA-event time around
the call (ms) and TFLOP/s of f32 work, and the registers of each
instance. Needs a card and nvcc; source variants build under a temporary
directory.
"""

import collections
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# plan variants: the SM count the plan fills a wave of
PLAN = {"large": {"_SMS": 0}, "small": {"_SMS": 10 ** 9}}
LARGE = "using Large = Cfg<D, 8, 32, 2, 1>;"
CHUNKS = "static constexpr int CHUNKS = D / 32;"
# source edits, each with the large instance's (stream rows, stages)
EDITS = {
    "split_per_use": ([
        ("""      split_tf32(x.x, h.x, l.x);
      split_tf32(x.y, h.y, l.y);
      split_tf32(x.z, h.z, l.z);
      split_tf32(x.w, h.w, l.w);""",
         """      h = make_uint4(__float_as_uint(x.x), __float_as_uint(x.y),
                     __float_as_uint(x.z), __float_as_uint(x.w));
      l = h;"""),
        ("split_tf32(live ? __ldg(p) : 0.f, hi[at], lo[at]);",
         "hi[at] = __float_as_uint(live ? __ldg(p) : 0.f);"),
        ("""          ah[e] = hi[at];
          al[e] = lo[at];""",
         "          split_tf32(__uint_as_float(hi[at]), ah[e], al[e]);")],
        None),
    "bs16": ([(LARGE, "using Large = Cfg<D, 8, 16, 2, 1>;")], (16, 2)),
    "stages3": ([(LARGE, "using Large = Cfg<D, 8, 16, 3, 1>;")], (16, 3)),
    "chunks1": ([(CHUNKS, "static constexpr int CHUNKS = 1;")], None),
    "chunks2": ([(CHUNKS, "static constexpr int CHUNKS = 2;")], None),
    "expf": ([('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
               "y = expf(x / LOG2E);")], None),
}
ROWS = ("flash_bwd_dq", "flash_bwd_dkv", "flash_attention_bwd")


def opcodes(lines):
    """Counter of SASS opcodes (without modifiers) over cuobjdump lines."""
    ops = collections.Counter()
    for line in lines:
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if m:
            ops[m.group(1)] += 1
    return ops


def sass_mix():
    """The opcode mix of the large D = 128 instances, whole and hot loop."""
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.utils import cuda_build
    cuda_build.build(["flash_bwd"])
    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass",
                          str(cuda_build._target("flash_bwd"))],
                         capture_output=True, text=True, check=True).stdout
    for func in re.split(r"\n\s*Function : ", out)[1:]:
        name = func.split("\n", 1)[0]
        if "CfgILi128ELi8E" not in name:
            continue
        lines = func.splitlines()
        bar = next(i for i, l in enumerate(lines) if "BAR.SYNC" in l)
        last = max(i for i, l in enumerate(lines) if "HMMA" in l)
        whole, loop = opcodes(lines), opcodes(lines[bar:last + 1])
        print(json.dumps({
            "kernel": re.search(r"flash_bwd_\w+?_kernel", name)[0],
            "instructions": sum(whole.values()),
            "loop_instructions": sum(loop.values()),
            "loop_mix": dict(loop.most_common(16))}), flush=True)
    return 0


# the f32 instances: flash_bwd_<kernel>_kernel over Cfg (FromDs<Cfg>)
F32_INSTANCE = re.compile(r"flash_bwd_(?:dq|dkv|dq_ds)_kernelIN\w*?"
                          r"(?:FromDsINS_\d+)?CfgILi")


def functions(cuda_build, lib):
    """Each function's SASS in ``lib`` by its name with the anonymous
    namespace's hash left out, addresses and column padding too."""
    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}",
                          "", m[1])
            funcs[name] = []
        elif name and "/*" in ln:
            funcs[name].append(" ".join(
                re.sub(r"/\*[0-9a-f]{4}\*/", "", ln).split()))
    return funcs


def sass_vs(other):
    """Per f32 instance of flash_bwd.cu: whether DIR's SASS is the
    tree's, instruction for instruction."""
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.utils import cuda_build
    other = Path(other).resolve()
    cuda_build.build(["flash_bwd"])
    cuda_build.build(["flash_bwd"], other)
    mine = functions(cuda_build, cuda_build._target("flash_bwd"))
    theirs = functions(cuda_build, cuda_build._target("flash_bwd", other))
    names = sorted(n for n in set(mine) | set(theirs)
                   if F32_INSTANCE.search(n))
    out = {}
    for name in names:
        a, b = mine.get(name, []), theirs.get(name, [])
        diff = [(x, y) for x, y in zip(a, b) if x != y]
        out[name[-70:]] = "identical" if a and a == b else (
            f"differs: {len(diff)} of {len(a)} / {len(b)} lines, first "
            f"{diff[:2]}")
    print(json.dumps({"sass_vs": str(other), "f32_instances": len(names),
                      "functions": out}), flush=True)
    return 0 if names and all(v == "identical" for v in out.values()) \
        else 1


def main():
    if sys.argv[1:] == ["--sass"]:
        return sass_mix()
    if sys.argv[1:2] == ["--sass"]:
        sass_mix()
        return sass_vs(sys.argv[2])
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device visible", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.nn import cuda_attention as ca
    from paddle_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    rows = []
    cs.log = lambda *a: rows.append((a[0], json.loads(a[1]))) \
        if len(a) == 2 and a[0] in ROWS else None
    orig = cuda_build.CSRC
    base = {"_SMS": ca._SMS, "_BWD_TILES": dict(ca._BWD_TILES)}
    with tempfile.TemporaryDirectory() as tmp:
        for name in ["tree"] + sys.argv[1:]:
            src = orig
            for key, value in base.items():
                setattr(ca, key, value)
            if name in PLAN:
                for key, value in PLAN[name].items():
                    setattr(ca, key, value)
            elif name != "tree":
                src = Path(tmp) / name
                shutil.copytree(orig, src)
                edits, large = EDITS[name]
                for old, new in edits:       # in whichever file holds it
                    source = next((f for f in (src / "flash_bwd.cu",
                                               src / "flash_tiles.cuh")
                                   if old in f.read_text()), None)
                    if source is None:
                        raise RuntimeError(f"{name}: {old!r} not in source")
                    source.write_text(source.read_text().replace(old, new))
                if large is not None:
                    ca._BWD_TILES = {
                        D: (t[0]._replace(stream_rows=large[0],
                                          stages=large[1]), t[1])
                        for D, t in base["_BWD_TILES"].items()}
            cuda_build.CSRC = src
            cuda_build._loaded.clear()
            rows.clear()
            try:
                report = cuda_build.build(["flash_bwd"])
                regs = cs.bwd_registers(ca,
                                        str(report["flash_bwd"]["log"]))
                gen = torch.Generator(device="cuda").manual_seed(0)
                cs.phase_flash_bwd(torch, F, ca, gen)
            except RuntimeError as e:        # a gate: report, go on
                print(json.dumps({"variant": name, "failed": str(e)[:400]}),
                      flush=True)
                continue
            print(json.dumps({
                "variant": name,
                "rows": {f"{n} {r['variant']} {r['case']}": [
                    r["device_ms"], r["kernel_ms"], r["tflops"]]
                    for n, r in rows},
                "registers": {f"{r['kernel']} D{r['D']} {r['rows']}x"
                              f"{r['stream_rows']}x{r['stages']}":
                              r["registers"] for r in regs}}), flush=True)
    cuda_build.CSRC = orig
    for key, value in base.items():
        setattr(ca, key, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
