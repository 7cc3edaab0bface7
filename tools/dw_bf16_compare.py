#!/usr/bin/env python3
"""Times conv1x1_dw_bf16 at the 15 shapes of a ResNet-50 step (summed over
its 36 launches, chip_smoke.py's bf16 kernel phase) for the tree's source
and for other versions of it, beside cuBLAS's product on the same
operands, in one process on one card:

    python3 tools/dw_bf16_compare.py [DIR ...]

Each DIR holds another version of paddle_tpu_torch/csrc/ (at least
conv1x1_dw_bf16.cu and the headers it includes) whose C entry point takes
the tree's arguments with the tree's meaning, so that the tree's plan
(``cuda_conv._launch_plan``) launches it: for example the sources of an
earlier step of the same design. A DIR may also hold a ``plan.py`` whose
``plan(x, dy, sms, tree_plan)`` returns the ``(tile, splits, vec)`` to
launch that version with instead (another split of M, say). Every version is built with the tree's
nvcc flags into a temporary directory, checked against the plain version
at each shape (within chip_smoke.TOL of max(1, max |plain|), two runs
bit-equal), then timed with CUDA events (chip_smoke.time_ms: the call
from Python to its last kernel, L2 flushed before each call) and with
the profiler (chip_smoke.device_ms: the kernels' device time alone), the
versions and cuBLAS taking turns shape by shape. Prints one JSON line per
shape (with each version's device rows: the product and, where M is
split, split_reduce) and one for the step, and the card's name and power
limit. Needs a card and nvcc.
"""

import ctypes
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def build(nvcc, flags, srcdir, tmp, name):
    """The C entry point of ``srcdir/conv1x1_dw_bf16.cu`` built into
    ``tmp/name``, and the build's ptxas lines."""
    d = Path(tmp) / name
    shutil.copytree(srcdir, d)
    lib = d / "lib.so"
    out = subprocess.run([nvcc, *flags, "-o", str(lib),
                          str(d / "conv1x1_dw_bf16.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(str(lib)).conv1x1_dw_bf16_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    report = [ln.strip() for ln in (out.stdout + out.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    return fn, report


def call(torch, fn, x, dy, plan):
    tile, splits, vec = plan
    (m, cin), cout = x.shape, dy.shape[1]
    out = torch.empty(cin, cout, dtype=torch.float32, device="cuda")
    work = torch.empty(splits, cin, cout, dtype=torch.float32,
                       device="cuda") if splits > 1 else None
    err = fn(x.data_ptr(), dy.data_ptr(), out.data_ptr(),
             None if work is None else work.data_ptr(), m, cin, cout, splits,
             tile, vec, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: cudaError {err}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("dw_bf16_compare: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.nn import cuda_conv as cc
    from paddle_tpu_torch.utils import cuda_build

    print(cs.gpu_line(), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dirs = {"tree": cuda_build.CSRC,
            **{Path(d).name: Path(d).resolve() for d in sys.argv[1:]}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        fns, plans = {}, {}
        for name, d in dirs.items():
            fns[name], report = build(cuda_build._nvcc(),
                                      cuda_build.NVCC_FLAGS, d, tmp, name)
            print(name, json.dumps(report), flush=True)
            if (Path(d) / "plan.py").exists():
                spec = importlib.util.spec_from_file_location(
                    f"plan_{name}", Path(d) / "plan.py")
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                plans[name] = mod.plan
        step = {k: 0.0 for name in [*fns, "cublas"]
                for k in (name, name + "_device")}
        for shape, n in cs.RESNET50_DW.items():
            M, cin, cout = shape
            x = torch.randn(M, cin, generator=gen, device="cuda").bfloat16()
            dy = torch.randn(M, cout, generator=gen,
                             device="cuda").bfloat16()
            plan = cc._launch_plan(x, dy, sms)
            want = cc.conv1x1_dw_plain(x, dy)
            row = {"shape": list(shape), "launches_per_step": n,
                   "plan": list(plan)}
            plan_of = {name: plans[name](x, dy, sms, plan)
                       if name in plans else plan for name in fns}
            row.update({f"{name}_plan": list(p) for name, p in
                        plan_of.items() if p != plan})
            for name, fn in fns.items():
                got = call(torch, fn, x, dy, plan_of[name])
                again = call(torch, fn, x, dy, plan_of[name])
                torch.cuda.synchronize()
                cs.check_close(f"{name} {shape}", got, want, rel=True)
                if not torch.equal(got, again):
                    raise RuntimeError(f"{name} {shape}: two runs differ")
            runs = {name: (lambda fn=fn, p=plan_of[name]:
                           call(torch, fn, x, dy, p))
                    for name, fn in fns.items()}
            runs["cublas"] = lambda: torch.mm(x.t(), dy,
                                              out_dtype=torch.float32)
            for name, run in runs.items():
                row[name + "_ms"] = cs.time_ms(torch, run)
                row[name + "_device_ms"], row[name + "_device_rows"] = \
                    cs.device_ms(torch, run)
            for name in runs:
                step[name] += n * row[name + "_ms"]
                step[name + "_device"] += n * row[name + "_device_ms"]
            print(json.dumps(row), flush=True)
            del x, dy, want
        print("step (36 launches, ms)", json.dumps(step), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
