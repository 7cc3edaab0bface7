#!/usr/bin/env python3
"""Times the flash-attention forward kernel (chip_smoke.py's phase 2 rows
of flash_fwd: the serving slice [1, 8, 1024, 64] causal, [2, 8, 512, 128]
with packed segments, the training shape [8, 4, 2048, 128] causal, and
the segments case on views 4 bytes off 16) for the tree's plan and source
and for variants of them, in one process on one card:

    python3 tools/flash_fwd_variants.py [variant ...]

Variants:
  large, small   every shape on the large instance (8 warps, 128 query
                 rows, one warp a row group, K/V tiles of 32) or on the
                 small one (4 warps, 32 rows, two key splits of 16)
  small_ks1      the small instance without key splits: 2 warps over 32
                 rows, each taking whole tiles of 32
  small_ks4      the small instance with four key splits of 8 (8 warps)
  small_bs16     the small instance with tiles of 16, two splits of 8
                 (68 KB at D = 128: three blocks an SM)
  ks2            the large instance as 4 row groups of two key splits of
                 16 (64 rows, tiles of 32)
  bs16           the large instance with K/V tiles of 16
  stages3        the large instance with tiles of 16 in a ring of 3
                 stages
  split_kv       each K/V tile split once a block into (hi, lo) planes, at
                 one more barrier a tile, in both instances, the large one
                 with tiles of 16 (the tree: every warp splits what it
                 reads as its fragments load); compare with bs16
  all_masks      masks formed on every tile (the tree: only on tiles that
                 cross the diagonal, a segment or T)
  chunks1, chunks2  1 or 2 score partials (32 d each) in flight a warp
                 (the tree: all of D, 4 at D = 128)
  tree           the tree again (a control, last in a list)
Every variant runs chip_smoke.py's gates for the forward (O and LSE within
1e-4 of the plain version, reruns bit-equal) and the build's ptxas report
(no spills); a variant that fails one prints the failure and the next one
runs. Prints, per variant, one JSON line: per case the device time of the
kernel (profiler, ms), the CUDA-event time around the call (ms) and
TFLOP/s of 4 * D per visible pair, and the registers of each instance.
Needs a card and nvcc; source variants build under a temporary directory.
"""

import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# plan variants: the SM count the plan fills a wave of
PLAN = {"large": {"_SMS": 0}, "small": {"_SMS": 10 ** 9}}
LARGE = "using Large = Cfg<D, 8, 1, 32, 2, 1>;"
SMALL = "using Small = Cfg<D, 2, 2, 16, 2, 2>;"
CHUNKS = "static constexpr int CHUNKS = D / 32;"
# split_kv: the block splits each landed K/V tile into planes of (hi, lo)
# pairs, row pitches KP and VP in pairs that keep the 8-byte fragment loads
# free of bank conflicts (K: 2 * KP = 8 mod 32 words; V, read two rows
# apart: 4 * VP = 8 mod 32), and scores() and accumulate() read the pairs
SPLIT_CFG = """  static constexpr int KP = D + 4, VP = D + 2;
  static constexpr int SMEM_BYTES =
      4 * (2 * PLANE + STAGES * STAGE + 2 * BS * (KP + VP));"""
SPLIT_STAGE = """template <class C>
__device__ __forceinline__ void split_stage(uint2* kp, uint2* vp,
                                            const float* st) {
  constexpr int PER_ROW = C::D / 4;
  for (int i = threadIdx.x; i < C::BS * PER_ROW; i += C::NT) {
    const int r = i / PER_ROW, c = i % PER_ROW * 4;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float4 x =
          *reinterpret_cast<const float4*>(st + m * C::TILE + r * C::LD + c);
      uint4 a, b;
      split_tf32(x.x, a.x, a.y);
      split_tf32(x.y, a.z, a.w);
      split_tf32(x.z, b.x, b.y);
      split_tf32(x.w, b.z, b.w);
      uint2* dst = m ? vp + r * C::VP + c : kp + r * C::KP + c;
      reinterpret_cast<uint4*>(dst)[0] = a;
      reinterpret_cast<uint4*>(dst)[1] = b;
    }
  }
}

template <class C>
__global__ void"""
READ_PAIR = """template <class C, int V>
__device__ __forceinline__ void read_pair(const float* tile, int r, int c,
                                          unsigned& h, unsigned& l) {
  const uint2 x =
      reinterpret_cast<const uint2*>(tile)[r * (V ? C::VP : C::KP) + c];
  h = x.x;
  l = x.y;
}

// acc[j] = the warp's 16 resident rows"""
# source edits, each with the instance it changes: (index, (rows, stream
# rows, stages, key splits)) as the plan must then see it
EDITS = {
    "small_ks1": ([(SMALL, "using Small = Cfg<D, 2, 1, 32, 2, 2>;")],
                  (1, (32, 32, 2, 1))),
    "small_ks4": ([(SMALL, "using Small = Cfg<D, 2, 4, 8, 2, 2>;")],
                  (1, (32, 32, 2, 4))),
    "small_bs16": ([(SMALL, "using Small = Cfg<D, 2, 2, 8, 2, 3>;")],
                   (1, (32, 16, 2, 2))),
    "ks2": ([(LARGE, "using Large = Cfg<D, 4, 2, 16, 2, 1>;")],
            (0, (64, 32, 2, 2))),
    "bs16": ([(LARGE, "using Large = Cfg<D, 8, 1, 16, 2, 1>;")],
             (0, (128, 16, 2, 1))),
    "stages3": ([(LARGE, "using Large = Cfg<D, 8, 1, 16, 3, 1>;")],
                (0, (128, 16, 3, 1))),
    "split_kv": ([
        (LARGE, "using Large = Cfg<D, 8, 1, 16, 2, 1>;"),
        ("  static constexpr int SMEM_BYTES",
         "  static constexpr int KP = D + 4, VP = D + 2;\n"
         "  static constexpr int SMEM_BYTES"),
        ("STAGES * STAGE);", "STAGES * STAGE + 2 * BS * (KP + VP));"),
        ("template <class C>\n__global__ void", SPLIT_STAGE),
        ("  float* ring = smem + 2 * C::PLANE;\n",
         "  float* ring = smem + 2 * C::PLANE;\n"
         "  uint2* kp = reinterpret_cast<uint2*>(ring + C::STAGES * "
         "C::STAGE);\n  uint2* vp = kp + C::BS * C::KP;\n"),
        ("    const int k0 = kt * C::BS + sub0;",
         "    split_stage<C>(kp, vp, st);\n    __syncthreads();\n"
         "    const int k0 = kt * C::BS + sub0;"),
        ("st + sub0 * C::LD, wrow",
         "reinterpret_cast<const float*>(kp + sub0 * C::KP), wrow"),
        ("st + C::TILE + sub0 * C::LD, corr",
         "reinterpret_cast<const float*>(vp + sub0 * C::VP), corr"),
        ("// acc[j] = the warp's 16 resident rows", READ_PAIR),
        ("split_tf32(tile[(8 * j + g) * C::LD + k + t + 4 * h], bh[h],\n"
         "                       bl[h]);",
         "read_pair<C, 0>(tile, 8 * j + g, k + t + 4 * h, bh[h], bl[h]);"),
        ("split_tf32(tile[(8 * j + 2 * t + h) * C::LD + 8 * n + g], bh[h],\n"
         "                   bl[h]);",
         "read_pair<C, 1>(tile, 8 * j + 2 * t + h, 8 * n + g, bh[h], bl[h]);"),
    ], (0, (128, 16, 2, 1))),
    "all_masks": ([("const bool inside = !seg &&",
                    "const bool inside = false && !seg &&")], None),
    "chunks1": ([(CHUNKS, "static constexpr int CHUNKS = 1;")], None),
    "chunks2": ([(CHUNKS, "static constexpr int CHUNKS = 2;")], None),
}


def main():
    import torch
    if not torch.cuda.is_available():
        print("flash_fwd_variants: no CUDA device visible", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from paddle_tpu_torch.nn import cuda_attention as ca
    from paddle_tpu_torch.utils import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    rows = []
    cs.log = lambda *a: rows.append(json.loads(a[1])) \
        if len(a) == 2 and a[0] == "flash_fwd" else None
    orig = cuda_build.CSRC
    base = {"_SMS": ca._SMS, "_FWD_TILES": dict(ca._FWD_TILES)}
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
                edits, inst = EDITS[name]
                for old, new in edits:       # in whichever file holds it
                    source = next((f for f in (src / "flash_fwd.cu",
                                               src / "flash_tiles.cuh")
                                   if old in f.read_text()), None)
                    if source is None:
                        raise RuntimeError(f"{name}: {old!r} not in source")
                    source.write_text(source.read_text().replace(old, new))
                if inst is not None:
                    i, (r, bs, stages, ks) = inst
                    ca._FWD_TILES = {
                        D: tuple(t._replace(rows=r, stream_rows=bs,
                                            stages=stages, key_splits=ks)
                                 if j == i else t for j, t in enumerate(ts))
                        for D, ts in base["_FWD_TILES"].items()}
            cuda_build.CSRC = src
            cuda_build._loaded.clear()
            rows.clear()
            try:
                report = cuda_build.build(["flash_fwd"])
                regs = cs.fwd_registers(ca, str(report["flash_fwd"]["log"]))
                gen = torch.Generator(device="cuda").manual_seed(0)
                cs.phase_flash(torch, F, ca, gen)
            except RuntimeError as e:        # a gate: report, go on
                print(json.dumps({"variant": name, "failed": str(e)[:400]}),
                      flush=True)
                continue
            print(json.dumps({
                "variant": name,
                "rows": {r["case"]: [r["device_ms"], r["kernel_ms"],
                                     r["tflops"]] for r in rows},
                "registers": {f"D{r['D']} {r['rows']}x{r['stream_rows']}x"
                              f"{r['stages']}": r["registers"]
                              for r in regs}}), flush=True)
    cuda_build.CSRC = orig
    for key, value in base.items():
        setattr(ca, key, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
