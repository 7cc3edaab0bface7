#!/usr/bin/env python3
"""Times the bf16 branches of the flash kernels and of ln_matmul for the
tree's sources and for other versions of them, in one process on one
card, beside the library call:

    python3 tools/bf16_compare.py [--only=fwd,bwd,ln] [DIR | VARIANT ...]

Each DIR holds another version of paddle_tpu_torch/csrc/ (all of it:
every source is built from the DIR) whose entry points take the tree's
arguments with the tree's meaning, so that the tree's wrappers and plans
launch it: for example the parent commit's sources (``git archive``),
whose ``flash_fwd_bf16`` and ``ln_matmul_bf16`` take 16-byte aligned
operands on ``mma.sync`` where the tree's take them on ``wgmma`` (a DIR
is handed bf16 scale and bias widened to f32 within the timed call, as
the parent's wrapper widened them: the tree's wgmma route reads them as
bf16). Each
VARIANT is a text edit of the tree's sources, built under a temporary
directory (``a+b`` applies two):

  max_pass   flash_fwd_bf16's max pass alone (MAIN_PASS false: no second
             pass, O written as zeros): its share of the forward; timed,
             not gated
  serial2    flash_fwd_bf16's main pass without its overlap: the next
             tile's S issued after both halves of P . V are done
  no_exp     flash_fwd_bf16 with p = s log2 e - m log2 e in place of its
             exponential (what the exponentials cost); timed, not gated
  no_tma     flash_fwd_bf16 with no K or V tile loaded (the producer
             completes each stage's barrier at once; Q still lands): the
             time the warps and the products take alone; timed, not gated
  no_qk      flash_fwd_bf16 without the Q . K^T products (both passes
             mask and reduce whatever the registers hold); timed, not
             gated
  no_mask    flash_fwd_bf16 with no masks (every tile scaled as an inner
             one); timed, not gated
  fwd_stages2  flash_fwd_bf16's wgmma instances with 2 stages (the tree:
             4)
  ln_no_wtma ln_matmul_bf16's wgmma route with no w tile loaded (each
             stage's barrier completed at once): what streaming w costs;
             timed, not gated
  ln_serial  ln_matmul_bf16's wgmma route without its overlap: each
             k-block's chain waited for before the pair's second is issued
  ln_stages2, ln_stages3  ln_matmul_bf16's wgmma route with 2 or 3 w
             stages (the tree: 4)
  bwd_no_tma flash_bwd_dkv_bf16's wgmma route with no Q or dO tile loaded
             (the producer completes each stage's barrier at once; K and
             V still land): the time the warps and the products take
             alone; timed, not gated
  bwd_no_stash, bwd_stash  flash_bwd_dkv_bf16's wgmma route with P
             kept in registers while dP runs in every instance, or parked
             in shared memory in every instance at D = 128 (the tree parks
             it in the one-warpgroup instance at D = 128 alone, where
             ptxas spills without)
  bwd_stages2  the bf16 backward's wgmma instances with 2 stages (the
             tree: 3)
  dq_stages3 flash_bwd_dq_bf16 from the stored ds with 3 stages (the
             tree: 6)

Cases (``--only`` picks among them): ``fwd``, chip_smoke.py's
FLASH_BF16_CASES (the training shape [8,4,2048,128] causal, [1,8,1024,64]
causal, [2,8,512,128] with segments) beside SDPA on the same bf16 inputs;
``bwd``, ``flash_bwd_dkv_bf16`` storing ds and ``flash_bwd_dq_bf16``
reading it back at the three FLASH_BF16_CASES, as ``flash_attention_bwd``
launches them, and at the training shape both without the stored ds
(dk/dv storing none, dq recomputing),
delta (a DIR's, which has no delta kernel, by the plain PyTorch
reduction, as its wrapper computed it) and the whole backward (a DIR's
as its wrapper launched it: the plain delta, then its two kernels);
``ln``, ``ln_matmul_bf16`` at x [16384, 512]
by w [512, 512] and [512, 2048], with and without bf16 scale and bias,
beside bf16 ``F.layer_norm`` + ``torch.mm``. Every version's outputs are
held to the plain versions under chip_smoke.py's bf16 gate (the unrounded
control failing it), the forward's LSE within LSE_TOL, and rerun
bit-equal; then each is timed by the profiler's device time
(chip_smoke.device_ms) and CUDA events (chip_smoke.time_ms, the L2
flushed before each call), the versions taking turns in order and then
in reverse order. Prints the card's name and power limit (nvidia-smi),
each build's ptxas lines for the bf16 instances (registers, spills,
warnings) and one JSON line per case. Needs a card and nvcc.
"""

import json
import re
import shutil
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_MAX = "constexpr bool MAIN_PASS = true;"
_P2_ISSUE = """        if (next)                      // as in pass 1: a group either way
          issue(s, sp, it + 1);
        else
          wgmma::commit();
        wgmma::wait<1>();"""
_P2_HALF = """          wgmma::wait<1>();
          if (next) finish(s, sp, nk * C::BS);
          wgmma::wait<0>();"""
_P2_D64 = """        } else {
          wgmma::wait<0>();
          if (next) finish(s, sp, nk * C::BS);
        }
        release(it);"""
_EXPECT = "        if (lead) wgmma::mbar_expect_tx(&full[st], bytes);"
_LOAD1 = """        if (lead)
#pragma unroll
          for (int c = 0; c < 2 * C::SLABS; ++c)"""
_LOAD2 = """        if (lead)
#pragma unroll
          for (int c = 0; c < C::SLABS; ++c) {"""
_QK1 = """  for (int kk = 0; kk < 4; ++kk)
    wgmma::mma_ss<N, 0, 0>(s,"""
_QK2 = """    for (int kk = 0; kk < 4; ++kk)
      wgmma::mma_ss<N, 0, 0>(
          part,"""
_MASK = "      if (inside) {"
_EXP = "p = exp2_ftz(fmaf(p, LOG2E, mneg[(e >> 1) & 1]));"
_FWD_STAGES = ("using LargeW = CfgW<D, 2, 64, 4>;\ntemplate <int D>\n"
               "using SmallW = CfgW<D, 1, 64, 4>;")
_LN_WLOAD = """          wgmma::mbar_expect_tx(&full[st], C::W_STAGE);
#pragma unroll
          for (int j = 0; j < C::BN / 64; ++j)"""
_LN_STAGES = "using LnLarge = LnW<128, 4>;\nusing LnSmall = LnW<64, 4>;"
_LN_ISSUE = """        if (two) {
          issue(p1, kb + 1, it + 1);
          wgmma::wait<1>();
        } else {
          wgmma::wait<0>();
        }"""
_LN_SECOND = """        if (two) {
          wgmma::wait<0>();"""
_BWD_EXPECT = """        if (lead) {
          wgmma::mbar_expect_tx(&full[st], 2 * C::TILE);"""
_BWD_STASH = "  static constexpr bool STASH = SLABS == 2 && WG == 1;"
_BWD_STAGES = ("using LargeBW = CfgBW<D, 2, 3, 6>;\ntemplate <int D>\n"
               "using SmallBW = CfgBW<D, 1, 3, 6>;")

# variant -> (source file, [(old, new)], gated)
VARIANTS = {
    "max_pass": ("flash_fwd.cu", [(_MAX, _MAX.replace("true", "false"))],
                 False),
    "serial2": ("flash_fwd.cu", [
        (_P2_ISSUE, "        wgmma::wait<0>();"),
        (_P2_HALF, "          wgmma::wait<0>();"),
        (_P2_D64, "        } else {\n          wgmma::wait<0>();\n        }\n"
                  "        if (next) {\n"
                  "          issue(s, sp, it + 1);\n"
                  "          wgmma::wait<0>();\n"
                  "          finish(s, sp, nk * C::BS);\n"
                  "        }\n        release(it);")], True),
    "no_exp": ("flash_fwd.cu", [(_EXP, "p = fmaf(p, LOG2E, "
                                       "mneg[(e >> 1) & 1]);")], False),
    "no_tma": ("flash_fwd.cu", [
        (_EXPECT, "        if (lead) wgmma::mbar_arrive(&full[st]);"),
        (_LOAD1, _LOAD1.replace("if (lead)", "if (false)")),
        (_LOAD2, _LOAD2.replace("if (lead)", "if (false)"))], False),
    "no_qk": ("flash_fwd.cu", [(_QK1, _QK1.replace("< 4", "< 0")),
                               (_QK2, _QK2.replace("< 4", "< 0"))], False),
    "no_mask": ("flash_fwd.cu", [(_MASK, "      if (true) {")], False),
    "fwd_stages2": ("flash_fwd.cu", [(_FWD_STAGES, _FWD_STAGES.replace(
        "64, 4>", "64, 2>"))], True),
    "ln_no_wtma": ("ln_matmul.cu", [(_LN_WLOAD, _LN_WLOAD.replace(
        "mbar_expect_tx(&full[st], C::W_STAGE)", "mbar_arrive(&full[st])")
        .replace("j < C::BN / 64", "j < 0"))], False),
    "ln_serial": ("ln_matmul.cu", [
        (_LN_ISSUE, "        wgmma::wait<0>();"),
        (_LN_SECOND, "        if (two) {\n          issue(p1, kb + 1, it);\n"
                     "          wgmma::wait<0>();")], True),
    "ln_stages2": ("ln_matmul.cu", [(_LN_STAGES, _LN_STAGES.replace(
        ", 4>", ", 2>"))], True),
    "ln_stages3": ("ln_matmul.cu", [(_LN_STAGES, _LN_STAGES.replace(
        ", 4>", ", 3>"))], True),
    "bwd_no_tma": ("flash_bwd.cu", [(_BWD_EXPECT, """        if (lead) {
          wgmma::mbar_arrive(&full[st]);
          if (false)""")], False),
    "bwd_no_stash": ("flash_bwd.cu", [(_BWD_STASH, _BWD_STASH.replace(
        "SLABS == 2 && WG == 1", "false"))], True),
    "bwd_stash": ("flash_bwd.cu", [(_BWD_STASH, _BWD_STASH.replace(
        " && WG == 1", ""))], True),
    "bwd_stages2": ("flash_bwd.cu", [(_BWD_STAGES, _BWD_STAGES.replace(
        ", 3, 6>", ", 2, 6>"))], True),
    "dq_stages3": ("flash_bwd.cu", [(_BWD_STAGES, _BWD_STAGES.replace(
        ", 3, 6>", ", 3, 3>"))], True),
}
SOURCES = ("flash_fwd", "flash_bwd", "ln_matmul")


def variant_dir(name, tmp):
    """A copy of the tree's csrc/ with the variant's edits applied."""
    from paddle_tpu_torch.utils import cuda_build
    out = Path(tmp) / name
    shutil.copytree(cuda_build.CSRC, out)
    for part in name.split("+"):
        src, edits, _ = VARIANTS[part]
        text = (out / src).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {part}: not in source: "
                                   f"{old[:60]}")
            text = text.replace(old, new)
        (out / src).write_text(text)
    return out


def ptxas_lines(report):
    """The build's ptxas report of the bf16 instances in short: per entry
    its template arguments, registers and spill bytes, and how many
    warnings or notes of lost performance (ptxas's "serialized" wgmma)
    each source drew."""
    keep = []
    for src in SOURCES:
        entry, warned = "", 0
        for ln in str(report[src]["log"]).splitlines():
            if "Compiling entry" in ln:
                m = re.search(r"(\w*(?:bf16|wgmma)\w*?)I(NS_\w*?)E+v", ln)
                entry = f"{m[1][-24:]}<{m[2][-44:]}>" if m else ""
            elif "arning" in ln or "Performance Loss" in ln:
                warned += 1
            elif entry and "spill" in ln:
                m = re.search(r"(\d+) bytes spill stores", ln)
                keep.append(f"{entry}: spills {m[1] if m else '?'}")
            elif entry and "registers" in ln:
                keep[-1] += " regs " + re.search(r"Used (\d+)", ln)[1]
                entry = ""
        keep.append(f"{src}: {warned} warnings or performance notes")
    return keep


def bwd_cases(torch, ca, cs, gen, label, shape, causal, seg_rows, all_):
    """The backward's cases at one of FLASH_BF16_CASES: dk/dv storing ds
    and dq from it, as ``flash_attention_bwd`` launches them; with
    ``all_`` also both kernels without the stored ds, delta, and the
    whole backward. Each case's call takes whether it runs a DIR's
    sources (the parent's wrapper computed delta by the plain reduction
    and has no delta kernel)."""
    bf = torch.bfloat16
    B, H, T, D = shape
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(bf)
                   for _ in range(4))
    seg = None if seg_rows is None else torch.tensor(
        seg_rows, dtype=torch.int32, device="cuda")
    if seg is not None:
        do = do * (seg > 0)[:, None, :, None].to(bf)
    o, lse = ca.flash_attention_plain(q, k, v, seg, causal)
    delta = ca._delta(o, do)
    bargs = (q, k, v, seg, do, lse, delta, causal)
    ds = torch.empty(B * H, T, T, dtype=bf, device="cuda")
    dk_ref, dv_ref = ca.flash_bwd_dkv_plain(*bargs)
    dq_ref = ca.flash_bwd_dq_plain(*bargs)
    f32 = (q.float(), k.float(), v.float(), seg, do.float(), lse, delta,
           causal)
    dk_un, dv_un = (t.to(bf) for t in ca.flash_bwd_dkv_plain(*f32))
    dq_un = ca.flash_bwd_dq_plain(*f32).to(bf)
    dkv = [(dk_ref, dk_un), (dv_ref, dv_un)]

    def whole(parent):
        if not parent:
            return ca.flash_attention_bwd(q, k, v, seg, o, lse, do, causal)
        buf = torch.empty(B * H, T, T, dtype=bf, device="cuda")
        a = (q, k, v, seg, do, lse, ca._delta(o, do), causal)
        dk, dv = ca.flash_bwd_dkv(*a, ds=buf)
        return ca.flash_bwd_dq(*a, ds=buf), dk, dv

    out = [(f"flash_bwd_dkv_bf16 storing ds {label}",
            lambda _: ca.flash_bwd_dkv(*bargs, ds=ds), dkv, None, None),
           (f"flash_bwd_dq_bf16 from ds {label}",
            lambda _: ca.flash_bwd_dq(*bargs, ds=ds), [(dq_ref, dq_un)],
            None, None)]
    if all_:
        out += [(f"flash_bwd_dkv_bf16 storing no ds {label}",
                 lambda _: ca.flash_bwd_dkv(*bargs), dkv, None, None),
                (f"flash_bwd_dq_bf16 recomputing {label}",
                 lambda _: ca.flash_bwd_dq(*bargs), [(dq_ref, dq_un)], None,
                 None),
                (f"delta {label} (flash_bwd_delta_bf16; a DIR: the plain "
                 f"reduction)", lambda parent: ca._delta(o, do) if parent
                 else ca.flash_bwd_delta(o, do), delta, None, None),
                (f"flash_attention_bwd bf16 {label}", whole,
                 [(dq_ref, dq_un), *dkv], None, None)]
    return out


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

    args = sys.argv[1:]
    only = {"fwd", "bwd", "ln"}
    if args and args[0].startswith("--only="):
        only = set(args.pop(0)[len("--only="):].split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    print(cs.gpu_line(), flush=True)
    tmp = tempfile.mkdtemp(prefix="bf16_compare_")
    dirs, gated, other = {"tree": cuda_build.CSRC}, {"tree": True}, set()
    for a in args:
        if all(v in VARIANTS for v in a.split("+")):
            dirs[a] = variant_dir(a, tmp)
            gated[a] = all(VARIANTS[v][2] for v in a.split("+"))
        else:
            dirs[Path(a).name] = Path(a).resolve()
            gated[Path(a).name] = True
            other.add(Path(a).name)
    # the tree first, then every other version at once (a source a
    # version shares with the tree is not built again)
    reports = {"tree": cuda_build.build(SOURCES)}
    with ThreadPoolExecutor(len(dirs)) as pool:
        reports.update(zip(list(dirs)[1:], pool.map(
            lambda d: cuda_build.build(SOURCES, d), list(dirs.values())[1:])))
    for name, report in reports.items():
        print(name, json.dumps(ptxas_lines(report)), flush=True)

    def use(name):
        cuda_build.CSRC = dirs[name]
        cuda_build._loaded.clear()

    gen = torch.Generator(device="cuda").manual_seed(14)
    bf = torch.bfloat16
    cases = []      # (label, fn, [(want, unrounded)], lse_ref, library)
    if "fwd" in only:
        for label, shape, causal, seg_rows in cs.FLASH_BF16_CASES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       .to(bf) for _ in range(3))
            seg = None if seg_rows is None else torch.tensor(
                seg_rows, dtype=torch.int32, device="cuda")
            o_ref, lse_ref = ca.flash_attention_plain(q, k, v, seg, causal)
            o_un = ca.flash_attention_plain(q.float(), k.float(), v.float(),
                                            seg, causal)[0].to(bf)
            mask = None if seg is None else cs.visible_pairs(
                torch, shape[0], shape[2], causal, seg)[0][:, None]
            cases.append((
                f"flash_fwd_bf16 {label}",
                lambda _, q=q, k=k, v=v, seg=seg, causal=causal:
                    ca.flash_attention_fwd(q, k, v, seg, causal),
                [(o_ref, o_un)], lse_ref,
                lambda q=q, k=k, v=v, mask=mask, causal=causal:
                    F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask,
                        is_causal=causal and mask is None)))
    if "bwd" in only:
        for label, shape, causal, seg_rows in cs.FLASH_BF16_CASES:
            cases += bwd_cases(torch, ca, cs, gen, label, shape, causal,
                               seg_rows, label == cs.FLASH_BF16_CASES[0][0])
    if "ln" in only:
        M, K = 16384, 512
        x = (torch.randn(M, K, generator=gen, device="cuda") * 2 + 0.5
             ).to(bf)
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
                cases.append((
                    f"ln_matmul_bf16 w [{K},{N}]"
                    + (" scale+bias" if aff else ""),
                    lambda widen, w=w, s=s, b=b: fl.fused_ln_matmul(
                        x, w, *(t.float() if widen and t is not None else t
                                for t in (s, b))),
                    [(want, un)], None,
                    lambda w=w, s=s, b=b: F.layer_norm(x, (K,), s, b,
                                                       1e-6) @ w))
    order = list(dirs) + list(dirs)[::-1]
    # each case's call takes whether to widen bf16 scale and bias first (a
    # DIR's ln_matmul_bf16 reads f32 ones)
    for label, call, refs, lse_ref, lib in cases:
        row = {"case": label}
        for name in dirs:
            use(name)
            fn = (lambda c=call, o=name in other: c(o))
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            if isinstance(refs, torch.Tensor):   # delta: the plain one
                err = (got[0] - refs).abs().max().item()
                if not err <= cs.TOL * max(1.0, refs.abs().max().item()):
                    raise RuntimeError(f"{name} {label}: off by {err}")
                row[name + "_err"] = err
            elif gated[name]:
                row[name + "_gate"] = [
                    cs.bf16_gate(torch, f"{name} {label}", g, w,
                                 u)["share_off_above_noise"]
                    for g, (w, u) in zip(got, refs)]
                if lse_ref is not None:
                    err = (got[1] - lse_ref).abs().max().item()
                    if not err <= cs.LSE_TOL:
                        raise RuntimeError(f"{name} {label}: LSE off by "
                                           f"{err}")
                    row[name + "_lse"] = err
                again = fn()
                again = again if isinstance(again, tuple) else (again,)
                torch.cuda.synchronize()
                if not all(torch.equal(a, c) for a, c in zip(got, again)):
                    raise RuntimeError(f"{name} {label}: reruns differ")
        for name in order:
            use(name)
            fn = (lambda c=call, o=name in other: c(o))
            row.setdefault(name + "_device", []).append(
                cs.device_ms(torch, fn)[0])
            row.setdefault(name, []).append(cs.time_ms(torch, fn))
        if lib is not None:
            row["library_device"] = cs.device_ms(torch, lib)[0]
            row["library"] = cs.time_ms(torch, lib)
        print(json.dumps(row), flush=True)
    use("tree")
    shutil.rmtree(tmp, ignore_errors=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
