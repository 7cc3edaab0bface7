#!/usr/bin/env python3
"""Times the bf16 branches of the flash kernels and of ln_matmul for the
tree's sources and for other versions of them, in one process on one
card, beside the library call:

    python3 tools/bf16_compare.py [DIR ...]

Each DIR holds another version of paddle_tpu_torch/csrc/ (all of it:
every source is built from the DIR) whose entry points take the tree's
arguments with the tree's meaning, so that the tree's wrappers and plans
launch it: for example the sources of an earlier step of the same
design. Cases: chip_smoke.py's phase 11 at the training shape
(``flash_fwd_bf16``; ``flash_bwd_dkv_bf16`` storing ds and
``flash_bwd_dq_bf16`` reading it back, as ``flash_attention_bwd``
launches them; the whole backward) and ``ln_matmul_bf16`` at x
``[16384, 512]`` by w ``[512, 512]`` and ``[512, 2048]``, with and
without scale and bias. Every version's outputs are held to the plain
versions under chip_smoke.py's bf16 gate (the unrounded control failing
it) and rerun bit-equal, then timed with CUDA events (chip_smoke.time_ms,
L2 flushed before each call) and the profiler (chip_smoke.device_ms), the
versions and the library taking turns case by case. Prints the card's
name and power limit, each build's ptxas lines for the bf16 instances
and one JSON line per case. Needs a card and nvcc.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    import torch
    if not torch.cuda.is_available():
        print("bf16_compare: no CUDA device visible", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.nn import cuda_attention as ca
    from paddle_tpu_torch.nn import fused_ln as fl
    from paddle_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    print(cs.gpu_line(), flush=True)
    dirs = {"tree": cuda_build.CSRC,
            **{Path(d).name: Path(d).resolve() for d in sys.argv[1:]}}
    sources = ("flash_fwd", "flash_bwd", "ln_matmul")

    def use(name):
        cuda_build.CSRC = dirs[name]
        cuda_build._loaded.clear()

    for name in dirs:
        use(name)
        report = cuda_build.build(sources)
        print(name, json.dumps([
            ln.strip()[:100] for src in sources
            for ln in str(report[src]["log"]).splitlines()
            if "bf16" in ln or ("spill" in ln and " 0 bytes spill" not in ln)
        ]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(14)
    bf = torch.bfloat16
    cases = []
    # the flash kernels at the training shape
    B, H, T, D = 8, 4, 2048, 128
    q, k, v, do = (torch.randn(B, H, T, D, generator=gen, device="cuda")
                   .to(bf) for _ in range(4))
    o_ref, lse_ref = ca.flash_attention_plain(q, k, v, None, True)
    o_un = ca.flash_attention_plain(q.float(), k.float(), v.float(), None,
                                    True)[0].to(bf)
    delta = (do.float() * o_ref.float()).sum(-1)
    args = (q, k, v, None, do, lse_ref, delta, True)
    ds = torch.empty(B * H, T, T, dtype=bf, device="cuda")
    dk_ref, dv_ref = ca.flash_bwd_dkv_plain(*args)
    dq_ref = ca.flash_bwd_dq_plain(*args)
    f32 = (q.float(), k.float(), v.float(), None, do.float(), lse_ref,
           delta, True)
    dk_un, dv_un = (t.to(bf) for t in ca.flash_bwd_dkv_plain(*f32))
    dq_un = ca.flash_bwd_dq_plain(*f32).to(bf)
    cases.append(("flash_fwd_bf16 [8,4,2048,128] causal",
                  lambda: ca.flash_attention_fwd(q, k, v, None, True)[0],
                  [(o_ref, o_un)],
                  lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True)))
    cases.append(("flash_bwd_dkv_bf16 storing ds",
                  lambda: ca.flash_bwd_dkv(*args, ds=ds),
                  [(dk_ref, dk_un), (dv_ref, dv_un)], None))
    cases.append(("flash_bwd_dq_bf16 from ds",
                  lambda: ca.flash_bwd_dq(*args, ds=ds), [(dq_ref, dq_un)],
                  None))
    cases.append(("flash_attention_bwd bf16",
                  lambda: ca.flash_attention_bwd(q, k, v, None, o_ref,
                                                 lse_ref, do, True),
                  [(dq_ref, dq_un), (dk_ref, dk_un), (dv_ref, dv_un)],
                  None))
    # ln_matmul_bf16 at the transformer width
    M, K = 16384, 512
    x = (torch.randn(M, K, generator=gen, device="cuda") * 2 + 0.5).to(bf)
    sc = (1 + 0.1 * torch.randn(K, generator=gen, device="cuda")).to(bf)
    bi = (0.1 * torch.randn(K, generator=gen, device="cuda")).to(bf)
    for N in (512, 2048):
        w = (torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5
             ).to(bf)
        for aff in (False, True):
            s, b = (sc, bi) if aff else (None, None)
            want = fl.ln_matmul_reference(x, w, s, b)
            un = fl.ln_matmul_reference(
                x.float(), w.float(), None if s is None else s.float(),
                None if b is None else b.float()).to(bf)
            cases.append((f"ln_matmul_bf16 w [{K},{N}]"
                          + (" scale+bias" if aff else ""),
                          lambda w=w, s=s, b=b: fl.fused_ln_matmul(x, w, s,
                                                                   b),
                          [(want, un)],
                          lambda w=w, s=s, b=b: F.layer_norm(
                              x, (K,), s, b, 1e-6) @ w))
    for label, fn, refs, lib in cases:
        row = {"case": label}
        for name in dirs:
            use(name)
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            row[name + "_gate"] = [cs.bf16_gate(torch, f"{name} {label}", g,
                                                w, u)["share_off_above_noise"]
                                   for g, (w, u) in zip(got, refs)]
            again = fn()
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise RuntimeError(f"{name} {label}: reruns differ")
            row[name] = cs.time_ms(torch, fn)
            row[name + "_device"] = cs.device_ms(torch, fn)[0]
        if lib is not None:
            row["library"] = cs.time_ms(torch, lib)
            row["library_device"] = cs.device_ms(torch, lib)[0]
        print(json.dumps(row), flush=True)
    use("tree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
