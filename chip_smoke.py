#!/usr/bin/env python3
"""Drive paddle_tpu_torch's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

0. environment: the card's name and power limit, torch and CUDA versions,
   TF32 switched off (the f32 kernels and their plain versions are f32),
   and cuBLAS's reduced-precision reduction of bf16-output products off
   (JAX sums them in f32).
1. build: every CUDA kernel of the path from ``paddle_tpu_torch/csrc``
   with ``nvcc`` for ``sm_90a``, all sources at once; ptxas's registers
   and spills of every ``flash_fwd.cu`` and ``flash_bwd.cu`` instance on
   a line of their own, and a spill in any of them fails the run.
2. kernels: each kernel against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it, with times for the
   kernel, the plain version, one PyTorch library call as a yardstick,
   and the least time the card could take. The flash forward rows (the
   serving slice ``[1,8,1024,64]`` causal, ``[2,8,512,128]`` with
   segments, the training shape ``[8,4,2048,128]`` causal, and the
   segments case on views 4 bytes off 16, which take 4-byte copies) run
   on the split-TF32 route: each gives O and LSE against the plain
   version, a bit-equal rerun, its TFLOP/s and share of that route's
   bound and of the f32 CUDA-core bound, the profiler's device time of
   the kernel and of SDPA's forward beside the event time, and its
   launch plan (``flash_fwd_plan``) on a line of its own; T = 1 and a
   ragged T with padded segments are held to the plain version too. The
   flash backward rows (dq,
   dk/dv and the whole backward, at ``[8,4,2048,128]`` causal,
   ``[2,8,512,128]`` with segments and ``[17,4,2048,128]`` causal, the
   first training batch whose stored ds would pass the plan's 1 GiB)
   run on the split-TF32 route: dk/dv storing ds and not, dq from the
   stored ds and recomputing, the way the plan picks marked as the main
   path's; each gives its TFLOP/s and its share of that route's bound
   (``bound_ms``) and of the f32 CUDA-core bound, the device time of its
   launches from ``torch.profiler`` beside the event time (SDPA's
   backward too), and each case's launch plan (``flash_bwd_plan``) on a
   line of its own.
3. the slice: ``TransformerLM`` at the ``transformer_decode`` width
   (vocab 32000, dim 512, 6 layers, 8 heads, ffn 2048, max_len 1024,
   flash prefill) with seeded random weights, served by ``DecodeEngine``
   (8 slots, block 16, paged attention) and ``ContinuousBatchingScheduler``
   over 16 requests; launch counts, pool accounting and first tokens
   against the plain-attention forward are checked, then 8 decode ticks
   are profiled.
4. span kernels (run right after phase 2): ``paged_span`` against its
   plain version at the speculative shape ``[8, 5, 8, 64]`` and the chunk
   shape ``[1, 128, 8, 64]`` over contexts of 64-1024 positions;
   ``paged_span`` at ``Q = 1`` and each row at ``Q = 5`` bit-equal to
   ``paged_decode`` at ``start + j + 1``; ``paged_decode_int8`` and
   ``paged_span_int8`` against the dequantizing plain versions; times,
   bounds and the SDPA yardstick. The paged kernels are split-context
   pairs (partials over fixed partitions of the context, then an in-order
   merge): each paged row (phase 2's decode too) also gives the device
   time of the entry's two launches and of SDPA from ``torch.profiler``
   (the event time around the Python call can time the host), and the
   launch plan (partition, row tile, grid, live blocks) on a line
   of its own; reruns of all four entries must be bit-equal, spans across
   partition boundaries (Q = 5 and Q = 128, f32, int8 and bf16 pools)
   bit-equal to ``paged_decode`` row by row, and the six entries must run
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   synchronisation). The bf16-pool branches (``paged_decode_bf16`` at
   phase 2's lengths, D 64 and 128; ``paged_span_bf16`` at ``[8,5,8,64]``,
   ``[8,5,8,128]`` and ``[1,128,8,64]``) are held to their plain versions
   within TOL of max(1, max |plain|) beyond each entry's rounding slack
   (``paged_rounding_slack``: where a p lies within the scores' rounding of
   a bf16 midpoint, kernel and plain version may round it one ulp apart),
   with a mean error under ROUNDED_SHARE of the rounding's own effect (p is
   rounded), reruns bit-equal, times, the bytes bound and SDPA on the
   gathered bf16 context.
5. span serving at the ``transformer_decode`` width, on phase 3's model:
   (a) ``speculative=4, prefill_chunk=128`` over phase 3's 16 requests
   (launch counts, pool accounting, tokens against phase 3's); (b) the
   ``transformer_decode_spec`` leg, 8 slots of periodic 128-token prompts,
   ``speculative`` 0 against 4, token-identical, with accepted tokens/s,
   ms per tick and accept rate; (c) ``kv_dtype="int8"`` with
   ``prefill_chunk=128``, ``attention="paged"`` against ``"xla"`` over the
   16 requests, with tokens/s, bytes per token and int8/f32 agreement.
   A chunked prefill, speculative and plain ticks and int8 ticks are
   profiled, each window with the paged kernels' device time and share.
   Since the serving programs are CUDA graphs (phases 3 and 5 serve
   through them, each engine warmed before its counted run), phase 4 also
   captures each of the five serving entries alone in a graph and holds
   two replays against the plain version, and (d) serves the 16 requests
   through the graphs in seven modes: greedy; bf16 pools
   (``dtype=torch.bfloat16``) greedy, and with ``speculative=4,
   prefill_chunk=128``; ``speculative=4, prefill_chunk=128``; int8 with
   ``prefill_chunk=128``; sampled (temperature 0.8, top-k 50, top-p 0.95,
   seed 7) with and without ``speculative=4``. The bf16-pool modes also
   check 12,288 bytes a token and their tokens against the ``"xla"`` path
   (its own graphs) wherever the top-2 gap exceeds BF16_POOL_GAP_TOL. Each
   mode checks compile counts ``{prefill: 1, tick: 1}`` after
   ``warmup()`` and after the run, the kernels each graph captured,
   launch counts equal to replays times captured launches and the pools
   back at their start; greedy tokens must equal those of the same engine
   with its programs' bodies run eagerly, bit for bit, and sampled tokens
   those of a second engine of the same seed that was not warmed. Each
   mode prints ms per tick, tokens/s and TTFT p50 of the run and ms per
   tick and the device idle share over 8 steady ticks of the graphs; the
   greedy mode also of the eager bodies.
6. training: ``TransformerLM`` at the ``prep_transformer`` width (vocab
   32000, dim 512, 6 layers, 4 heads, ffn 2048, T 2048, flash attention)
   with seeded random weights, trained by ``Trainer`` with ``adam(1e-4)``
   for 8 steps on the benchmark's conflicting-pairs batch (8 x 2048).
   Step-0 gradients of every parameter are held against the
   plain-attention model first; then the launch counts (6 forward, 6 dq
   and 6 dk/dv launches per step), finite and falling losses are checked,
   and 2 more steps are profiled (with the flash backward kernels'
   device time and share).
7. conv and LayerNorm kernels: ``conv1x1_dw`` against its plain version
   at five shapes of the ResNet-50 step (within 1e-4 of max |plain|, two
   runs bit-equal), then timed at all 15 distinct shapes of the step's 36
   launches, summed per step; ``fused_ln_matmul`` (``ln_matmul``) over x
   ``[16384, 512]`` with w ``[512, 512]`` and ``[512, 2048]``, with and
   without scale and bias, its entry point's only caller. Both run on the
   split-TF32 tensor-core route (``csrc/gemm_f32.cuh``): each timed row
   gives its TFLOP/s and its share of that route's bound (three TF32
   products against 495 TFLOP/s, or the bytes) and of the f32 CUDA-core
   bound (67 TFLOP/s).
8. ResNet-50 training: the ``prep_resnet50`` configuration, nothing cut
   (``resnet50(1000)``, 7x7 stem, batch 128 at 224 x 224 x 3,
   ``momentum(0.1, 0.9)``, the conflicting-pairs batch, seeded random
   weights, f32) with ``set_conv1x1_impl("pallas")``. Step-0 gradients
   under ``"pallas"`` are held against ``"conv"`` (cuDNN) and
   ``"matmul"``, and each kernel launch against cuDNN's weight gradient,
   first; then 8 timed steps (36 ``conv1x1_dw`` launches each, finite
   losses) and, from the same weights and BN state, 3 timed steps under
   ``"conv"`` (not a gate). Then, again from that start and with cuDNN
   deterministic, loss curves: 32 steps under ``"pallas"``, whose last
   loss must lie below its first, and 8 under ``"matmul"`` and
   ``"conv"``; at each of the 8 steps the ``"pallas"`` loss must lie
   within 4 times the ``"matmul"``-``"conv"`` gap of the ``"matmul"``
   loss, and the same check must fail for ``"pallas"`` with every weight
   gradient 1% too large. Last, 2 profiled steps.
9. the ``bfloat16_compute`` policy, the JAX benchmarks' own, each part
   right after its f32 counterpart: (a) phase 5's greedy and bf16-pool
   graph serving of the 16 requests under the policy (captured under it:
   compile counts, launches under replay, tokens bit-equal to the eager
   bodies under the policy, steady ticks); (b) ``prep_transformer`` for 8
   steps
   under the policy: step-0 gradients against the same model with the
   flash kernels' plain versions in their place, within BF16_K of the
   policy's own effect plus one bf16 ulp of each parameter's largest
   gradient, 6 launches of each flash kernel a step, a falling loss, ms
   per step, tokens/s, peak memory and a profiled window; (c)
   ``conv1x1_dw_bf16`` on bf16 operands at the 15 shapes of a ResNet-50
   step: five against its plain version (within TOL of max(1, max
   |plain|)), two runs bit-equal, then timed beside its plain version,
   ``torch.mm(x.t(), dy, out_dtype=torch.float32)`` and the f32 kernel
   on the same values, with its bound by bytes and by operations at the
   data sheet's 989 TFLOP/s and at the card's bf16 ``mma.sync`` rate,
   measured here by ``tools/mma_bf16_peak.py``; (d) ``prep_resnet50``
   under the policy and ``"pallas"``: step-0 gradients against
   ``"matmul"`` and ``"conv"`` under the policy, each of the 36 launches
   against the plain version, exactly 36 ``conv1x1_dw_bf16`` and no f32
   launch a step, 8 timed steps beside 3 under ``"conv"``, the loss
   curves with the kernel's plain version as a second yardstick and a
   control of BF16_WRONG_DW, 2 profiled steps.
10. prefill/decode hand-off (run after 9 (a)): phase 3's 16 requests
    through a ``role="prefill"`` and a ``role="decode"`` scheduler, each
    with its own engine, the pages crossing as per-block blobs (each
    exactly ``bytes_per_block``) into ``adopt``, for f32, bf16 and int8
    pools; the greedy tokens bit-equal to a colocated engine's.
11. bf16 operands of the flash kernels and of ``ln_matmul`` (run after
    phase 2, and after phase 7's ``ln_matmul``), as the JAX kernels take
    them: (a) ``flash_fwd_bf16``, ``flash_bwd_dq_bf16`` and
    ``flash_bwd_dkv_bf16`` (and the backward's ``flash_bwd_delta_bf16``,
    within TOL of the plain delta relative to its largest entry) at
    ``[8,4,2048,128]`` causal, ``[1,8,1024,64]``
    causal and ``[2,8,512,128]`` with segments, and ``ln_matmul_bf16`` at
    x ``[16384,512]`` with w ``[512,512]`` and ``[512,2048]``, with and
    without scale and bias, each against its plain version under the
    bf16 gate (every entry within one bf16 ulp of the largest |plain|
    entry, at most BF16_SHARE of the entries above BF16_NOISE of it off;
    the LSE within LSE_TOL), with the plain version that leaves p, ds or
    y unrounded as a control that must fail the gate, reruns bit-equal,
    their ptxas reports free of spills, and the wrappers' refusals (mixed
    dtypes, bf16 views 2 bytes off 4, a stored ds of another dtype); each
    call's route logged (``flash_fwd_bf16``, ``flash_bwd_dkv_bf16``,
    ``flash_bwd_dq_bf16`` and ``ln_matmul_bf16`` take 16-byte aligned
    operands on ``wgmma`` fed by TMA, views 4 bytes off 16 on
    ``mma.sync``): the aligned calls must go by ``wgmma``, and the
    forward and backward at ``[2,8,512,128]`` with segments and
    ``ln_matmul_bf16`` at w ``[512,512]`` with scale and bias, again on
    views 4 bytes off 16, by ``mma.sync``, under the same gate; (b)
    the path: bf16 leaf q, k, v at ``[8,4,2048,128]`` causal through
    ``flash_attention``, a loss and ``.backward()``: exactly one launch
    of each of the four kernels (the forward and the backward's two by
    ``wgmma``), bf16
    gradients within the gate of the
    plain backward on the forward's saved O and LSE, and within
    BF16_PATH_SHARE of the plain versions' autograd end to end; (c) each
    kernel timed by events and by the
    profiler's device time beside its plain version, SDPA on the same
    bf16 inputs (forward, backward, and forward plus backward) or
    ``F.layer_norm`` plus ``torch.mm`` in bf16, and its bounds: bytes at
    3.35 TB/s, operations at 989 TFLOP/s and at the card's bf16
    ``mma.sync`` rate (``tools/mma_bf16_peak.py``, measured once in the
    run for this phase and phase 9 (c)).
12. the training loop (run after 9 (b)): ``prep_transformer`` under
    ``bfloat16_compute`` through the ``Trainer``'s grouped loop, over 3
    batches of 8 x 2048 (the conflicting pairs, rolled by 0, 1 and 2
    positions) in turn, ``adam(1e-4)``, one pass of 24 steps: (a)
    ``steps_per_call=8, pipeline_depth=3`` (the stager thread, 3 calls
    in flight), finite losses, the last below the first, and 6 x 24
    launches of each of ``flash_fwd``, ``flash_bwd_dq`` and
    ``flash_bwd_dkv``; (b) the same from the same weights with
    ``pipeline_depth=1``, and with ``steps_per_call=1``, and (a) again:
    parameters and Adam's m and v bit-equal to (a); (c) with
    ``saving_period=8`` into a temporary directory of the checkout, a
    ``FaultSchedule`` preempting at step 12 (one call at a time, so the
    stop lands at batch 16), then a fresh model and ``Trainer`` with
    ``resume=True`` finishing the pass in the pipelined loop, bit-equal to
    (a), once with synchronous and once with asynchronous saves; (d) ``grad_accum=2`` over the batch's two
    halves of 4 x 2048 against one step on the whole batch: every
    parameter's gradient within BF16_K of the policy's own effect plus
    one bf16 ulp of its largest (``_worst_of_effect``), 2 x 6 launches of
    each flash kernel in the step; (e) ms a step of (a) against the
    serial (b) (and of (a) again), the loss fetches of each, the seconds
    of a synchronous save and of an asynchronous one (the part on the
    loop's path and the background write), the checkpoint's bytes and the
    peak memory.
13. the MoE LM, remat and evaluators (run last, after the ResNet phases:
    a window of ``device_ms``, which counts the profiler's records, drops
    records after a large profiled window such as this phase's):
    ``prep_transformer`` with ``moe_experts=8`` (top-1, capacity factor
    1.25: C = 2560 slots an expert for the 16,384 tokens of a batch)
    under ``bfloat16_compute`` (the MoE layers run in f32, the residual
    stream's dtype, as JAX's do), loss mean CE + 0.01 x the Switch aux
    loss: (a) the ``Trainer`` with ``steps_per_call=4, pipeline_depth=2``
    and an ``EvaluatorSet(ClassificationError)`` over the logits (labels
    the batch's targets) for 8 steps: finite losses, the last below the
    first, 6 launches of each flash kernel a step, classification error
    plus accuracy 1 at every step, the pass's metrics equal to the
    aggregate of the steps' stats, the same losses and loss fetches as
    the run without the evaluator, each layer's routing stats (drop rate,
    expert fractions, C) after training, ms a step, peak memory and one
    profiled call; (b) one forward and backward from the same weights at
    ``remat`` None, ``"dots"`` and ``"full"``: loss and every gradient
    within 1e-5 of its largest entry of the plain step's (bit-equality
    logged), the flash forward launched once a block (``"dots"`` keeps its
    outputs) or twice (``"full"``), and ``"full"``'s peak below the
    plain one; (c) the MoE model at the serving width (8 heads, max_len
    1024, seeded weights) through the CUDA graphs over phase 3's 16
    requests, greedy and ``speculative=4, prefill_chunk=128``, with phase
    9's gates (tokens as the eager bodies', compile counts {1, 1}, each
    program capturing its paged kernel 6 times), and its ms a tick and
    tokens/s beside the dense model's of phase 9; (d) every activation
    and cost of the port on CUDA tensors against the same call on CPU
    copies, values and gradients within 1e-5 of max(1, max |cpu|).

14. observability (before phase 13): the ``obs`` package through the
    ``Trainer`` (the ``prep_transformer`` run of phase 12, 8 steps, serial
    and at ``steps_per_call=8, pipeline_depth=3``) and the engine and
    scheduler (phase 3's 16 requests through the CUDA graphs, greedy and
    ``speculative=4, prefill_chunk=128``), each with every hook off and
    on, in off-on-on-off turns (``Telemetry`` with health, memory and
    fence, a ``Tracer``,
    an ``AnomalyDetector``, a ``MetricsHub``; for serving a router lane
    and an ``SLOMonitor``): losses and tokens bit-equal, launch counts,
    replays and loss fetches equal; one step record a call with the JAX
    Trainer's keys, ``bytes_in_use`` within 1 MiB of
    ``torch.cuda.memory_allocated()``, ``grad_norm`` within 1e-5 of the
    gradients' own norm, ``est_mfu_pct`` set, the Chrome trace's
    ``dispatch`` spans paired with the steps, ``python -m
    paddle_tpu_torch.obs.report`` on the JSONL exiting 0; a NaN weight
    trips ``nonfinite`` and leaves one anomaly bundle whose armed
    ``torch.profiler`` capture holds CUDA kernel rows; one
    ``decode_tick`` record a tick whose tokens sum to those generated,
    24,576 KV bytes a token, one ``request`` record a request with the
    TTFT p50 of the requests' own stamps, a merged trace whose request
    flows are connected and whose lanes are monotonic. Logs each leg's ms
    a step or tick of every run with hooks off and on, the ms the hooks
    add and the phase's seconds.

Each serving and training path runs with the launch counts set to 0 just
before it and read just after; a kernel's ``launches`` in the final list
is the sum over those paths.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
``nvidia-smi``'s name and power limit, and before that one JSON object
listing every kernel with its launches on the main paths, error and times
(``conv1x1_dw``'s and ``conv1x1_dw_bf16``'s times and bounds summed over
the 36 launches of one ResNet-50 step, the bf16 entry with the card's
``mma.sync`` bound and the f32 kernel's time on the same values beside
its own; ``bound_ms`` is the bound of the kernel's route,
``cuda_core_bound_ms`` the f32 CUDA-core one beside it; the paged and
flash kernels add ``device_ms`` and ``library_device_ms``,
profiler device time per call; the flash backward's two entries are timed
at the training shape as the training path launches them, dk/dv storing
ds and dq reading it back; the bf16 flash entries likewise at the
training shape, ``ln_matmul_bf16`` at w ``[512,2048]`` with scale and
bias, each with ``mma_sync_bound_ms``).
"""

import gc
import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM data-sheet peaks the bounds are computed against
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12   # tensor cores, dense
BF16_FLOPS_PER_S = 989e12   # tensor cores, dense
TOL = 1e-4          # f32, kernel vs plain: summation order differs
# a bf16-pool paged kernel rounds p as its plain version does when its
# mean distance to it is under this share of the rounding's own effect
# (the plain version on f32 copies of the pools); a kernel that rounded
# nothing would sit at about 1
ROUNDED_SHARE = 0.1
# step-0 gradients, flash path vs plain-attention path, relative to each
# parameter's largest gradient: both f32, the plain path masks with -1e9
# and normalises with torch.softmax, the kernels sum in another order
GRAD_RTOL = 1e-3
REPLACES = {"flash_fwd": "paddle_tpu/nn/pallas_attention.py:108",
            "paged_decode": "paddle_tpu/nn/pallas_attention.py:585",
            "flash_bwd_dq": "paddle_tpu/nn/pallas_attention.py:162",
            "flash_bwd_dkv": "paddle_tpu/nn/pallas_attention.py:207",
            "paged_span": "paddle_tpu/nn/pallas_attention.py:711",
            "paged_span_int8": "paddle_tpu/nn/pallas_attention.py:711",
            "paged_decode_int8": "paddle_tpu/nn/pallas_attention.py:585",
            "paged_decode_bf16": "paddle_tpu/nn/pallas_attention.py:585",
            "paged_span_bf16": "paddle_tpu/nn/pallas_attention.py:711",
            "conv1x1_dw": "paddle_tpu/nn/pallas_conv.py:46",
            "conv1x1_dw_bf16": "paddle_tpu/nn/pallas_conv.py:46",
            "ln_matmul": "paddle_tpu/nn/fused_ln.py:63",
            "flash_fwd_bf16": "paddle_tpu/nn/pallas_attention.py:108",
            "flash_bwd_dq_bf16": "paddle_tpu/nn/pallas_attention.py:162",
            "flash_bwd_dkv_bf16": "paddle_tpu/nn/pallas_attention.py:207",
            # delta = rowsum(dO * O), which _flash_backward computes in XLA
            # outside its Pallas kernels: this kernel replaces no Pallas one
            "flash_bwd_delta_bf16": "paddle_tpu/nn/pallas_attention.py:439",
            "ln_matmul_bf16": "paddle_tpu/nn/fused_ln.py:63"}
# the paged kernels' device rows (partials and merge) in a profile window
PAGED_ROWS = ("paged::",)
# top-2 logit gap under which a token that differs between two f32 paths
# that sum in other orders is a near-tie, not a fault
GAP_TOL = 1e-3
# the same over bf16 pools between the "paged" path, which rounds p to
# bf16 before p.V as JAX's kernels do, and the "xla" path, which under
# float32 does not round its weights: each weight of every layer moves by
# up to 2^-9 of itself, which moved the toy model's logits by up to 1.5e-2
# (tests/test_torch_bf16_pools.py); a differing token is a near tie when
# its gap lies under this
BF16_POOL_GAP_TOL = 5e-2
# under bfloat16_compute a gradient or loss is held against the policy's
# own effect on it (the same computation under float32): two paths whose
# f32 values differ in their last bits round to bf16 one ulp apart where
# they straddle a rounding boundary, so their difference is a fraction of
# the policy's rounding, never its size; K as in tests/test_torch_bf16_*.py
BF16_K = 0.25
BF16_ULP = 2.0 ** -7     # one bf16 ulp, relative, at the bottom of a binade


def log(*args):
    print(*args, flush=True)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` per call, with the 50 MB L2 flushed
    before each call (CUDA events around each call alone)."""
    flush = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def device_ms(torch, fn, iters=20, warmup=3):
    """Device time of ``fn`` per call, from torch.profiler: the sum of the
    device-side rows (kernels, copies) of ``iters`` calls, each after an L2
    flush by a 128 MB device-to-device copy whose rows are left out; and
    the names of the rows kept. Unlike ``time_ms`` it cannot time the
    host: a wrapper whose Python outlasts its kernels shows only the
    kernels here. Each row comes as ``[name, ms per call, launches per
    call]``."""
    from torch.profiler import ProfilerActivity, profile
    src = torch.empty(128 * 2 ** 20 // 4, dtype=torch.float32, device="cuda")
    dst = torch.empty_like(src)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the profiler now and then returns a window without its device rows,
    # or with only some of the calls' (half of them, once); such a window
    # is taken again, up to five times. It also drops a few records of
    # short launches now and then (19 of 20 ln_stats launches, 39 and 38
    # of 40 copies of 512 values, through five retakes in a row): a row
    # within a tenth of a whole number of launches a call is kept, its
    # time a call taken from the records it has (its mean launch times
    # its launches a call)
    def per_call(count):
        n = round(count / iters)
        return n if n >= 1 and abs(count - n * iters) <= max(
            1, n * iters // 10) else 0

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # a lead-in of copies, whose rows are left out: late in a long
            # process a window lost the records of its first 3-4 launches
            # five retakes in a row (ln_gemm_wgmma, 16-17 of 20, also on
            # the parent's tree), while the same phase run alone kept all
            for _ in range(8):
                dst.copy_(src)
            for _ in range(iters):
                dst.copy_(src)
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and not e.key.startswith("Memcpy")]
        if rows and all(per_call(c) for _, _, c in rows):
            break
    else:
        raise RuntimeError(f"device_ms: the profiler recorded no device "
                           f"time, or not every call's: {rows}")
    ms = [(n, t / 1e3 / c * per_call(c), per_call(c)) for n, t, c in rows]
    return (sum(t for _, t, _ in ms),
            sorted([n[:60], t, k] for n, t, k in ms))


def paged_device_times(torch, fn, lib_fn):
    """Device time per call of a paged entry (all its launches) and of
    its SDPA yardstick, with the device rows each consists of."""
    ms, names = device_ms(torch, fn)
    lib_ms, lib_names = device_ms(torch, lib_fn)
    return {"device_ms": ms, "device_rows": names,
            "library_device_ms": lib_ms, "library_device_rows": lib_names}


# a paged call's kernels by the names the profiler gives them
PAGED_LAUNCH_NAMES = {"max_pass": "partials_kernel", "main_pass":
                      "pv_kernel", "merge": "merge_kernel"}


def paged_launches(name, rows):
    """Each launch's device time of a bf16-pool paged call from its device
    rows (``device_ms``: the max pass is partials_kernel's bf16 instance,
    the main pass pv_kernel); raises unless the call launched exactly the
    kernels the design says, ``ca.PAGED_BF16_KERNELS`` a call, one of
    each."""
    from paddle_tpu_torch.nn import cuda_attention as ca
    got = {key: sum(t for n, t, _ in rows if kern in n)
           for key, kern in PAGED_LAUNCH_NAMES.items()
           if any(kern in n for n, _, _ in rows)}
    launches = sum(k for _, _, k in rows)
    if launches != ca.PAGED_BF16_KERNELS or len(got) != launches:
        raise RuntimeError(f"{name}: {launches} launches a call "
                           f"({rows}); the design launches "
                           f"{ca.PAGED_BF16_KERNELS}")
    return {"launches_per_call": launches, **got}


def bound(nbytes, flops):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def split_tf32_bound(nbytes, flops):
    """The bound of an f32 product on the split-TF32 route
    (``csrc/gemm_f32.cuh``): three TF32 products per f32 product on the
    tensor cores, or the bytes."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = 3 * flops / TF32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def gemm_rates(row, nbytes, flops):
    """Adds to a product's timed row its achieved TFLOP/s, the route's
    bound (split TF32) as ``bound_ms`` and the f32 CUDA-core bound beside
    it, and the kernel's share of each."""
    row["bound_ms"], row["bound_by"] = split_tf32_bound(nbytes, flops)
    row["cuda_core_bound_ms"], row["cuda_core_bound_by"] = bound(nbytes,
                                                                 flops)
    row["tflops"] = flops / row["kernel_ms"] / 1e9
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row["share_of_cuda_core_bound"] = row["cuda_core_bound_ms"] \
        / row["kernel_ms"]
    return row


def check_close(name, got, want, rel=False, slack=None):
    """Max |got - want|, which must be <= TOL; with ``rel`` the limit is
    TOL * max(1, max |want|) (for tensors whose entries pass 1). With
    ``slack`` (a bf16 pool's ``paged_rounding_slack``, shaped like
    ``want``) each entry may also differ by its slack: where a p lies
    within the scores' rounding of a bf16 midpoint, the kernel and the
    plain version may round it one ulp apart."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    lim = TOL * max(1.0, want.abs().max().item()) if rel else TOL
    over = diff if slack is None else diff - slack
    if not over.max().item() <= lim:          # also catches NaN
        raise RuntimeError(f"{name}: max |kernel - plain| = {err}, beyond "
                           f"the rounding slack {over.max().item()} > {lim}")
    return err


def visible_pairs(torch, B, T, causal, seg):
    """``[B, T, T]`` visibility and the count of visible pairs (per
    head)."""
    vis = torch.ones(T, T, dtype=torch.bool, device="cuda")
    if causal:
        vis = torch.tril(vis)
    vis = vis.expand(B, T, T)
    if seg is not None:
        vis = vis & (seg[:, :, None] == seg[:, None, :]) \
            & (seg[:, :, None] > 0)
    return vis, int(vis.sum().item())


SEG_ROWS = [[1] * 200 + [2] * 150 + [3] * 100 + [0] * 62,
            [1] * 300 + [2] * 180 + [0] * 32]


# the forward's cases: the serving slice's prefill shape, a segments shape
# with padding tails, the training shape, and the segments case on views
# whose base lies 1 float (4 bytes) off 16 bytes
FWD_CASES = [("slice [1,8,1024,64] causal", (1, 8, 1024, 64), True, None, 0),
             ("[2,8,512,128] segments", (2, 8, 512, 128), False, SEG_ROWS,
              0),
             ("training [8,4,2048,128] causal", (8, 4, 2048, 128), True,
              None, 0),
             ("[2,8,512,128] segments, views 4 bytes off 16",
              (2, 8, 512, 128), False, SEG_ROWS, 1)]


# gates only: one token, and T off every tile size with segments whose
# padding tail ends mid-tile
FWD_EDGES = [((1, 2, 1, 64), True, None),
             ((2, 3, 100, 128), True, [[1] * 40 + [2] * 50 + [0] * 10,
                                       [1] * 97 + [0] * 3])]


def phase_flash(torch, F, ca, gen):
    """flash_fwd against its plain version at ``FWD_CASES``, O and LSE
    within TOL, reruns bit-equal, each case's launch plan
    (``flash_fwd_plan``) on a line of its own. Each row gives the event
    and the profiler's device time of the kernel and of SDPA's forward on
    the same f32 inputs (with an explicit mask where there are segments),
    the plain version's time, and through ``gemm_rates`` its TFLOP/s of
    4·D per visible pair and its share of the split-TF32 bound (the
    kernel's route, ``bound_ms``) and of the f32 CUDA-core bound. The
    case on views 4 bytes off 16 (``buf[1:].view``) takes 4-byte copies;
    SDPA is not run on those views (its kernel stops the process with a
    misaligned address there). Then ``FWD_EDGES``, held to the plain
    version and rerun, not timed."""
    from paddle_tpu_torch.nn.gemm_f32 import copy_width
    results = []
    for label, shape, causal, seg_rows, offset in FWD_CASES:
        B, H, T, D = shape
        plan = ca.flash_fwd_plan(B, H, T, D, causal)
        log("flash_fwd plan", json.dumps({"case": label,
                                          **plan._asdict()}))
        n = B * H * T * D
        q, k, v = (torch.randn(n + offset, generator=gen, device="cuda")
                   [offset:].view(shape) for _ in range(3))
        width = copy_width(q, k, v)
        if width != (1 if offset else 4):
            raise RuntimeError(f"flash_fwd {label}: copy width {width}")
        seg = None if seg_rows is None else torch.tensor(
            seg_rows, dtype=torch.int32, device="cuda")

        def fn():
            return ca.flash_attention_fwd(q, k, v, seg, causal)

        o, lse = fn()
        o_ref, lse_ref = ca.flash_attention_plain(q, k, v, seg, causal)
        torch.cuda.synchronize()
        err = max(check_close(f"flash {label} O", o, o_ref),
                  check_close(f"flash {label} LSE", lse, lse_ref))
        check_rerun(torch, f"flash_fwd {label} O", o, lambda: fn()[0])
        check_rerun(torch, f"flash_fwd {label} LSE", lse, lambda: fn()[1])
        del o_ref, lse_ref
        vis, pairs = visible_pairs(torch, B, T, causal, seg)
        nbytes = 4 * (4 * B * H * T * D + B * H * T) \
            + (0 if seg is None else 4 * B * T)
        flops = 4 * D * H * pairs
        mask = None if seg is None else vis[:, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=causal and mask is None)

        dev, dev_rows = device_ms(torch, fn)
        row = {"case": label, "copy_width": width, "max_abs_err": err,
               "kernel_ms": time_ms(torch, fn), "device_ms": dev,
               "device_rows": dev_rows,
               "plain_ms": time_ms(torch, lambda: ca.flash_attention_plain(
                   q, k, v, seg, causal)),
               "pairs_per_head": pairs, "bytes": nbytes, "flops": flops}
        if offset:       # SDPA's kernel faults on such views: not run
            row.update(library_ms=None, library_device_ms=None)
        else:
            row.update(library_ms=time_ms(torch, sdpa),
                       library_device_ms=device_ms(torch, sdpa)[0])
        gemm_rates(row, nbytes, flops)
        log("flash_fwd", json.dumps(row))
        results.append(row)
        del vis, mask
    for shape, causal, seg_rows in FWD_EDGES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(3))
        seg = None if seg_rows is None else torch.tensor(
            seg_rows, dtype=torch.int32, device="cuda")
        label = f"edge {list(shape)}{' causal' if causal else ''}" \
            f"{' segments' if seg is not None else ''}"
        o, lse = ca.flash_attention_fwd(q, k, v, seg, causal)
        o_ref, lse_ref = ca.flash_attention_plain(q, k, v, seg, causal)
        torch.cuda.synchronize()
        row = {"case": label, "max_abs_err": max(
            check_close(f"flash {label} O", o, o_ref),
            check_close(f"flash {label} LSE", lse, lse_ref))}
        check_rerun(torch, f"flash_fwd {label} O", o, lambda: ca.
                    flash_attention_fwd(q, k, v, seg, causal)[0])
        log("flash_fwd edge", json.dumps(row))
        results.append(row)
    return results


# the backward's cases: the training shape, a segments shape with padding
# tails, and the training model at the first batch whose ds buffer passes
# the plan's budget (1 GiB), where the whole backward recomputes in dq
BWD_CASES = [("training [8,4,2048,128] causal", (8, 4, 2048, 128), True,
              None),
             ("[2,8,512,128] segments", (2, 8, 512, 128), False, SEG_ROWS),
             ("past the ds budget [17,4,2048,128] causal",
              (17, 4, 2048, 128), True, None)]
BWD_VARIANTS = {("flash_bwd_dkv", True): "stores ds",
                ("flash_bwd_dkv", False): "stores no ds",
                ("flash_bwd_dq", True): "from the stored ds",
                ("flash_bwd_dq", False): "recomputes s and dp"}
OUTS = {"flash_bwd_dq": "q", "flash_bwd_dkv": "kv",
        "flash_attention_bwd": "qkv"}


def phase_flash_bwd(torch, F, ca, gen):
    """flash_bwd_dq and flash_bwd_dkv against their plain versions at
    ``BWD_CASES`` (dO zero on padding rows, as label -1 makes it in the
    model). Each kernel runs both ways its entry takes: dk/dv storing ds
    in a ``[B*H, T, T]`` buffer or not, dq reading that ds back (ds.k
    alone) or recomputing s and dp; the way the case's plan picks
    (``stored_ds``) is what ``flash_attention_bwd``, the training path,
    launches, and its row is marked ``main_path``. Errors are held to TOL
    relative to max(1, max |plain|): dv and dk of the first keys under
    causal masking sum over up to 2048 rows and pass 1. Bounds count the
    least work of each row's own function: dq recomputing q.k^T, dO.v^T
    and ds.k, 6*D operations per visible pair; dq from ds, ds.k, 2*D, and
    the visible ds entries read; dk/dv those two scores and p^T.dO,
    ds^T.q, 8*D, and storing ds the visible entries written; the whole
    backward five products, 10*D. Each row gives its TFLOP/s and its
    share of the split-TF32 bound (the kernels' route, ``bound_ms``) and
    of the f32 CUDA-core bound, and the device time of its launches from
    torch.profiler beside the event time. The library yardstick is the
    backward of F.scaled_dot_product_attention on the same f32 inputs
    (autograd of one SDPA forward; the forward itself is not timed). One
    line per case gives the launch plan. Reruns of every row must be
    bit-equal."""
    results = []
    for label, shape, causal, seg_rows in BWD_CASES:
        B, H, T, D = shape
        plan = ca.flash_bwd_plan(B, H, T, D, causal)
        log("flash_bwd plan", json.dumps({"case": label,
                                          **plan._asdict()}))
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(4))
        seg = None if seg_rows is None else torch.tensor(
            seg_rows, dtype=torch.int32, device="cuda")
        if seg is not None:
            do = do * (seg > 0)[:, None, :, None]
        o, lse = ca.flash_attention_fwd(q, k, v, seg, causal)
        delta = (do * o).sum(-1)
        args = (q, k, v, seg, do, lse, delta, causal)
        ds = torch.empty((B * H, T, T), dtype=torch.float32, device="cuda")
        # dk/dv storing ds runs before dq reads it
        calls = {
            ("flash_bwd_dkv", True): lambda: ca.flash_bwd_dkv(*args, ds=ds),
            ("flash_bwd_dkv", False): lambda: ca.flash_bwd_dkv(*args),
            ("flash_bwd_dq", True): lambda: (ca.flash_bwd_dq(*args, ds=ds),),
            ("flash_bwd_dq", False): lambda: (ca.flash_bwd_dq(*args),),
            ("flash_attention_bwd", plan.stored_ds):
                lambda: ca.flash_attention_bwd(q, k, v, seg, o, lse, do,
                                               causal)}
        plains = {"flash_bwd_dq": lambda: (ca.flash_bwd_dq_plain(*args),),
                  "flash_bwd_dkv": lambda: ca.flash_bwd_dkv_plain(*args),
                  "flash_attention_bwd": lambda: ca.flash_attention_bwd_plain(
                      q, k, v, seg, o, lse, do, causal)}
        errs = {}
        for (name, stored), fn in calls.items():
            got = fn()
            want = plains[name]()
            torch.cuda.synchronize()
            errs[name, stored] = max(
                check_close(f"{name} {label} d{x}", g, w, rel=True)
                for x, g, w in zip(OUTS[name], got, want))
            del want
            if not all(torch.equal(a, b) for a, b in zip(got, fn())):
                raise RuntimeError(f"{name} {label}: two runs differ")
        vis, pairs = visible_pairs(torch, B, T, causal, seg)
        td = 4 * B * H * T * D
        rowb = 4 * B * H * T
        segb = 0 if seg is None else 4 * B * T
        dsb = 4 * H * pairs                  # the visible entries of ds
        work = {  # (bytes, flops) of each row's own function
            ("flash_bwd_dq", False): (5 * td + 2 * rowb + segb,
                                      6 * D * H * pairs),
            ("flash_bwd_dq", True): (2 * td + dsb + segb, 2 * D * H * pairs),
            ("flash_bwd_dkv", False): (6 * td + 2 * rowb + segb,
                                       8 * D * H * pairs),
            ("flash_bwd_dkv", True): (6 * td + 2 * rowb + segb + dsb,
                                      8 * D * H * pairs),
            # q, k, v, O, dO, LSE in; dq, dk, dv out
            ("flash_attention_bwd", plan.stored_ds): (
                8 * td + rowb + segb, 10 * D * H * pairs)}
        mask = None if seg is None else vis[:, None]
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None)

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                       retain_graph=True)

        lib_ms = time_ms(torch, sdpa_bwd)
        lib_dev, _ = device_ms(torch, sdpa_bwd)
        del sdpa_out, qs, ks, vs, vis, mask
        plain_ms = {name: time_ms(torch, fn) for name, fn in plains.items()}
        rows = {}
        for (name, stored), fn in calls.items():
            dev, dev_rows = device_ms(torch, fn)
            row = {"case": label,
                   "variant": BWD_VARIANTS.get(
                       (name, stored), "dq from the stored ds" if stored
                       else "dq recomputes s and dp"),
                   "main_path": stored == plan.stored_ds,
                   "kernel_ms": time_ms(torch, fn), "device_ms": dev,
                   "device_rows": dev_rows, "plain_ms": plain_ms[name],
                   "library_ms": lib_ms, "library_device_ms": lib_dev,
                   "library_note": "SDPA backward: dq, dk and dv",
                   "pairs_per_head": pairs,
                   "max_abs_err": errs[name, stored]}
            if name == "flash_attention_bwd":
                row["note"] = "delta (one PyTorch reduction) + both kernels"
            rows[name, stored] = gemm_rates(row, *work[name, stored])
            log(name, json.dumps(row))
        results.append(rows)
        del ds
    return results


def main_path_row(rows, name):
    """The row of ``name`` launched the way the training path launches
    it."""
    return next(r for (n, _), r in rows.items() if n == name
                and r["main_path"])


# ptxas's -v report of a flash_bwd.cu instance: kernel (dq, dkv, or dq_ds:
# dq from stored ds), D, warps, rows of a streamed tile, stages (the
# template arguments of its Cfg)
BWD_INSTANCE = re.compile(r"flash_bwd_(dq|dkv|dq_ds)_kernel\w*?"
                          r"CfgILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi\d+E")


def ptxas_entries(pattern, log_text):
    """Registers and spills of every kernel entry in a ptxas ``-v`` log
    whose mangled name matches ``pattern``, keyed by the match's groups
    as ints."""
    found, cur = {}, None
    for line in log_text.splitlines():
        if "Compiling entry" in line:
            m = pattern.search(line)
            cur = tuple(int(x) if x.isdigit() else x for x in m.groups()) \
                if m else None
            if cur is not None:
                found[cur] = {}
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                found[cur].update(spill_stores=int(m[1]),
                                  spill_loads=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                found[cur]["registers"] = int(m[1])
    return found


def checked_entry(found, key, name):
    """``found[key]``, which must be a whole report with no spill."""
    rep = found.get(key, {})
    if len(rep) != 3:
        raise RuntimeError(f"{name}: no ptxas report for {key}")
    if rep["spill_stores"] or rep["spill_loads"]:
        raise RuntimeError(f"{name} {key} spills: {rep}")
    return rep


def bwd_registers(ca, log_text):
    """Registers and spills of every flash_bwd.cu instance from the build's
    ptxas report; any instance the plan can pick that spills, or that the
    report lacks, fails the run."""
    found = ptxas_entries(BWD_INSTANCE, log_text)
    out = []
    for D, tiles in ca._BWD_TILES.items():
        for t in tiles:
            for kernel in ("dq", "dkv", "dq_ds"):
                key = (kernel, D, t.rows // 8, t.stream_rows, t.stages)
                out.append({"kernel": f"flash_bwd_{kernel}", "D": D,
                            "rows": t.rows, "stream_rows": t.stream_rows,
                            "stages": t.stages,
                            **checked_entry(found, key, "flash_bwd")})
    return out


# ptxas's -v report of a flash_fwd.cu instance: D, row groups, key splits,
# keys a split takes of a tile, stages (the template arguments of its Cfg)
FWD_INSTANCE = re.compile(r"flash_fwd_kernel\w*?CfgILi(\d+)ELi(\d+)ELi(\d+)"
                          r"ELi(\d+)ELi(\d+)ELi\d+E")


def fwd_registers(ca, log_text):
    """Registers and spills of every flash_fwd.cu instance the plan can
    pick, from the build's ptxas report; a spill, or an instance the
    report lacks, fails the run."""
    found = ptxas_entries(FWD_INSTANCE, log_text)
    return [{"kernel": "flash_fwd", "D": D, "rows": t.rows,
             "stream_rows": t.stream_rows, "stages": t.stages,
             "key_splits": t.key_splits,
             **checked_entry(found, (D, t.rows // 16, t.key_splits,
                                     t.stream_rows // t.key_splits,
                                     t.stages), "flash_fwd")}
            for D, tiles in ca._FWD_TILES.items() for t in tiles]


# ptxas's -v report of a conv1x1_dw_bf16.cu instance: the wgmma route's
# WgCfg (rows, columns, stages, blocks an SM) and the mma.sync route's Cfg
# (rows, columns, blocks an SM) with its copy width
DW_WGMMA_INSTANCE = re.compile(r"dw_wgmmaINS_5WgCfgILi(\d+)ELi(\d+)ELi(\d+)"
                               r"ELi(\d+)E")
DW_MMA_INSTANCE = re.compile(r"dw_tiles_bf16INS_3CfgILi(\d+)ELi(\d+)ELi\d+"
                             r"ELi\d+ELi\d+ELi(\d+)EEELi(\d+)E")


# the bf16 instances of flash_fwd.cu (D, row groups, key tile, stages),
# flash_bwd.cu (kernel, D, warps, streamed tile, stages) and ln_matmul.cu
# (tile rows, tile columns, copy width)
FWD_BF16_INSTANCE = re.compile(r"flash_fwd_bf16_kernel\w*?CfgBILi(\d+)ELi(\d+)"
                               r"ELi(\d+)ELi(\d+)ELi\d+E")
BWD_BF16_INSTANCE = re.compile(r"flash_bwd_(dq|dkv|dq_ds)_bf16_kernel\w*?"
                               r"CfgBILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi\d+E")
LN_BF16_INSTANCE = re.compile(r"ln_gemm_bf16INS_4BCfgILi(\d+)ELi(\d+)ELi\d+"
                              r"ELi\d+ELi\d+ELi\d+EEELi(\d+)E")
# the wgmma instances of flash_fwd.cu (D, consumer warpgroups, key tile,
# stages: CfgW) and of ln_matmul.cu (strip rows, stages: LnW)
FWD_WGMMA_INSTANCE = re.compile(r"flash_fwd_wgmma_kernelINS_4CfgWILi(\d+)"
                                r"ELi(\d+)ELi(\d+)ELi(\d+)E")
# the bf16 backward's wgmma instances (kernel, D, consumer warpgroups,
# stages, dq-from-ds stages: CfgBW) and its delta kernel (D)
BWD_WGMMA_INSTANCE = re.compile(r"flash_bwd_(dkv|dq|dq_ds)_wgmma_kernelINS_"
                                r"\d+CfgBWILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E")
DELTA_INSTANCE = re.compile(r"flash_bwd_(delta)_kernelILi(\d+)E")
LN_WGMMA_INSTANCE = re.compile(r"ln_gemm_wgmmaINS_3LnWILi(\d+)ELi(\d+)E")
# ptxas's notes that it serialised a function's wgmma (C7510-C7520:
# registers, divergent paths, accumulators written inside a group)
WGMMA_SERIALISED = re.compile(r"C75\d\d\).*wgmma.*serialized")


def bf16_registers(ca, report):
    """Registers and spills of every bf16 flash and ln_matmul instance
    the plans can pick, on both routes, from the build's ptxas reports; a
    spill, or an instance a report lacks, fails the run. ptxas's notes
    that it serialised the wgmma of a function are counted per source
    (``wgmma_serialised``), not failed on."""
    from paddle_tpu_torch.nn import fused_ln as fl
    from paddle_tpu_torch.nn.gemm_f32 import TILES
    fwd_log = str(report["flash_fwd"]["log"])
    fwd = ptxas_entries(FWD_BF16_INSTANCE, fwd_log)
    fwd_wg = ptxas_entries(FWD_WGMMA_INSTANCE, fwd_log)
    bwd_log = str(report["flash_bwd"]["log"])
    bwd = ptxas_entries(BWD_BF16_INSTANCE, bwd_log)
    bwd_wg = ptxas_entries(BWD_WGMMA_INSTANCE, bwd_log)
    delta = ptxas_entries(DELTA_INSTANCE, bwd_log)
    ln = ptxas_entries(LN_BF16_INSTANCE, str(report["ln_matmul"]["log"]))
    ln_wg = ptxas_entries(LN_WGMMA_INSTANCE, str(report["ln_matmul"]["log"]))
    out = [{"kernel": "flash_fwd_bf16", "route": "mma_sync", "D": D,
            "rows": t.rows, "stream_rows": t.stream_rows,
            **checked_entry(fwd, (D, t.rows // 16, t.stream_rows, t.stages),
                            "flash_fwd_bf16")}
           for D, tiles in ca._FWD_TILES_BF16.items() for t in tiles]
    out += [{"kernel": "flash_fwd_bf16", "route": "wgmma", "D": D,
             "rows": t.rows, "stream_rows": t.stream_rows,
             "stages": t.stages,
             **checked_entry(fwd_wg, (D, t.rows // 64, t.stream_rows,
                                      t.stages), "flash_fwd_bf16 wgmma")}
            for D, tiles in ca._FWD_TILES_WGMMA.items() for t in tiles]
    out += [{"kernel": f"flash_bwd_{k}_bf16", "D": D, "rows": t.rows,
             "stream_rows": t.stream_rows,
             **checked_entry(bwd, (k, D, t.rows // 8, t.stream_rows,
                                   t.stages), "flash_bwd_bf16")}
            for D, tiles in ca._BWD_TILES_BF16.items() for t in tiles
            for k in ("dq", "dkv", "dq_ds")]
    out += [{"kernel": f"flash_bwd_{k}_bf16", "route": "wgmma", "D": D,
             "rows": t.rows, "stages": t.stages, "ds_stages": t.ds_stages,
             **checked_entry(bwd_wg, (k, D, t.rows // 64, t.stages,
                                      t.ds_stages), "flash_bwd_bf16 wgmma")}
            for D, tiles in ca._BWD_TILES_WGMMA.items() for t in tiles
            for k in ("dkv", "dq", "dq_ds")]
    out += [{"kernel": "flash_bwd_delta_bf16", "D": D,
             **checked_entry(delta, ("delta", D), "flash_bwd_delta_bf16")}
            for D in (64, 128)]
    out += [{"kernel": "ln_matmul_bf16", "route": "mma_sync",
             "tile": list(t[:2]), "vec": vec,
             **checked_entry(ln, (t.rows, t.cols, vec), "ln_matmul_bf16")}
            for t in TILES for vec in (2, 1)]
    out += [{"kernel": "ln_matmul_bf16", "route": "wgmma", "rows": t.rows,
             "stages": t.stages, "k_max": t.k_max,
             **checked_entry(ln_wg, (t.rows, t.stages),
                             "ln_matmul_bf16 wgmma")}
            for t in fl.WGMMA_LN]
    out.append({"wgmma_serialised": {
        src: len(WGMMA_SERIALISED.findall(str(report[src]["log"])))
        for src in ("flash_fwd", "flash_bwd", "ln_matmul",
                    "conv1x1_dw_bf16")}})
    return out


def dw_bf16_registers(log_text):
    """Registers and spills of every conv1x1_dw_bf16.cu instance the plan
    can pick, from the build's ptxas report; a spill, or an instance the
    report lacks, fails the run."""
    from paddle_tpu_torch.nn import gemm_bf16
    wg = ptxas_entries(DW_WGMMA_INSTANCE, log_text)
    mma = ptxas_entries(DW_MMA_INSTANCE, log_text)
    out = []
    for t in gemm_bf16.WGMMA_TILES:
        key = next((k for k in wg if (k[0], k[1], k[3]) == tuple(t)), None)
        out.append({"route": "wgmma", "tile": list(t[:2]), "stages":
                    key and key[2], "vec": 8,
                    **checked_entry(wg, key, "conv1x1_dw_bf16")})
    out += [{"route": "mma_sync", "tile": list(t[:2]), "vec": vec,
             **checked_entry(mma, (t.rows, t.cols, t.blocks_per_sm, vec),
                             "conv1x1_dw_bf16")}
            for t in gemm_bf16.MMA_TILES for vec in (2, 1)]
    return out


def check_rerun(torch, name, out, fn):
    """A rerun of ``fn`` must equal ``out`` bit for bit (no atomics)."""
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise RuntimeError(f"{name}: a rerun differs from the first run")


def paged_grid(ca, name, S, Q, H, D, bs, MB, start_l, n_l, pool=0):
    """The launch plan of a paged entry over a pool of kind ``pool`` and
    its partials grid: blocks in all, and live ones (a tile with live rows
    whose last position reaches the partition), counted on the host from
    the test's own lists; bf16 pools' main pass has its own shared memory
    (0 for other pools, which have none)."""
    plan = ca.paged_plan(MB, bs, D, Q, pool)
    W = MB * bs
    live = 0
    for st, n in zip(start_l, n_l):
        for r0 in range(0, min(n, Q), plan.rows):
            last = min(st + min(n, Q, r0 + plan.rows) - 1, W - 1)
            live += H * (last // plan.part + 1)
    return {"entry": name, "partition": plan.part, "row_tile": plan.rows,
            "smem_bytes": plan.smem, "main_pass_smem_bytes": plan.pv_smem,
            "grid": [S * plan.tiles, H, plan.parts],
            "blocks": S * plan.tiles * H * plan.parts, "live_blocks": live,
            "pool_blocks_per_block": plan.part // bs}


def phase_paged(torch, F, ca, gen):
    S, H, D, bs, MB, N = 8, 8, 64, 16, 64, 513
    lengths_l = [0, 1, 16, 17, 1024, 300, 511, 64]
    perm = (torch.randperm(N - 1, generator=gen, device="cuda") + 1).cpu()
    tables = torch.zeros(S, MB, dtype=torch.int32)
    nxt = 0
    for s, L in enumerate(lengths_l):
        nb = -(-L // bs)
        tables[s, :nb] = perm[nxt:nxt + nb]
        nxt += nb
    tables[7, :4] = tables[4, :4]        # slot 7 shares slot 4's blocks
    tables = tables.cuda()
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    q = torch.randn(S, H, D, generator=gen, device="cuda")
    pk = torch.randn(N, bs, H, D, generator=gen, device="cuda")
    pv = torch.randn(N, bs, H, D, generator=gen, device="cuda")
    out = ca.paged_decode_attention(q, pk, pv, tables, lengths)
    ref = ca.paged_decode_plain(q, pk, pv, tables, lengths)
    torch.cuda.synchronize()
    err = check_close("paged_decode", out, ref)
    if out[0].abs().max().item() != 0.0:
        raise RuntimeError("paged_decode: a length-0 slot must give zeros")
    check_rerun(torch, "paged_decode", out, lambda: ca.paged_decode_attention(
        q, pk, pv, tables, lengths))
    log("paged plan", json.dumps(paged_grid(ca, "paged_decode", S, 1, H, D,
                                            bs, MB, [L - 1 for L in
                                                     lengths_l],
                                            [int(L > 0) for L in
                                             lengths_l])))
    rows = {(int(tables[s, p // bs]), p % bs)
            for s, L in enumerate(lengths_l) for p in range(L)}
    nbytes = 4 * (2 * S * H * D + 2 * len(rows) * H * D + S * MB + S)
    flops = 4 * D * H * sum(lengths_l)
    b_ms, b_by = bound(nbytes, flops)
    W = MB * bs
    kg = pk[tables.long()].reshape(S, W, H, D).permute(0, 2, 1, 3)
    vg = pv[tables.long()].reshape(S, W, H, D).permute(0, 2, 1, 3)
    kg, vg = kg.contiguous(), vg.contiguous()
    live = (torch.arange(W, device="cuda")[None] < lengths[:, None])
    mask = live[:, None, None, :]
    q4 = q[:, :, None]
    run = lambda: ca.paged_decode_attention(q, pk, pv, tables,  # noqa
                                            lengths)
    lib = lambda: F.scaled_dot_product_attention(q4, kg, vg,  # noqa
                                                 attn_mask=mask)
    ms = time_ms(torch, run)
    plain_ms = time_ms(torch, lambda: ca.paged_decode_plain(
        q, pk, pv, tables, lengths))
    lib_ms = time_ms(torch, lib)
    row = {"case": f"S={S} H={H} D={D} bs={bs} MB={MB} N={N} "
                   f"lengths={lengths_l}", "max_abs_err": err,
           "kernel_ms": ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_note": "SDPA on the "
           "pre-gathered context, gather not timed", "bound_ms": b_ms,
           "bound_by": b_by, "bytes": nbytes, "flops": flops,
           **paged_device_times(torch, run, lib)}
    log("paged_decode", json.dumps(row))
    return row


def phase_slice(torch, np, pt):
    from paddle_tpu_torch.nn import cuda_attention as ca
    V, L = 32000, 6
    cfg = dict(vocab=V, dim=512, num_layers=L, num_heads=8, ffn_hidden=2048,
               max_len=1024)
    gen = torch.Generator(device="cuda").manual_seed(1234)
    t0 = time.perf_counter()
    model = pt.TransformerLM(**cfg, use_flash=True, device="cuda",
                             generator=gen)
    eng = pt.DecodeEngine(model, max_slots=8, block_size=16,
                          attention="paged")
    rng = np.random.RandomState(0)
    lens = rng.randint(16, 513, size=16)
    prompts = [[int(t) for t in rng.randint(0, V, n)] for n in lens]
    shared = [int(t) for t in rng.randint(0, V, 64)]
    for i in (2, 3):                   # two requests share a 64-token prefix
        prompts[i] = shared + prompts[i][:max(16, len(prompts[i]) - 64)]
    log(f"slice: model+engine built in {time.perf_counter() - t0:.2f} s; "
        f"prompt lengths {[len(p) for p in prompts]}")

    start_free = eng.cache.free_blocks
    eng.warmup()                       # both graphs captured before counting
    reqs, counts, tick_s, wall = run_requests(torch, pt, ca, eng, prompts,
                                              32)
    check_requests("slice", reqs, 32, V)
    if counts["flash_fwd"] != eng.prefills * L or eng.prefills != 16:
        raise RuntimeError(f"flash launches {counts['flash_fwd']} != "
                           f"prefills {eng.prefills} x {L}")
    if counts["paged_decode"] != eng.ticks * L or eng.ticks == 0:
        raise RuntimeError(f"paged_decode launches "
                           f"{counts['paged_decode']} != ticks "
                           f"{eng.ticks} x {L}")
    if eng.cache.free_blocks != start_free or eng.cache.allocator._rc:
        raise RuntimeError(f"pool leak: {eng.cache.free_blocks} "
                           f"reclaimable of {start_free}, live refcounts "
                           f"{eng.cache.allocator._rc}")
    if eng.cache.prefix_hit_blocks < 4:
        raise RuntimeError(f"shared 64-token prefix adopted only "
                           f"{eng.cache.prefix_hit_blocks} blocks")

    # first tokens against the plain-attention forward on the same weights
    ref = pt.TransformerLM(**cfg, use_flash=False, device="cuda")
    ref.load_state_dict(model.state_dict())
    checks = []
    with torch.no_grad():
        for r in reqs[:4]:
            P = len(r.prompt)
            ids = torch.tensor([r.prompt], device="cuda")
            want = ref(ids)[0, P - 1]
            padded = torch.as_tensor(eng.stage_prompt(r.prompt),
                                     dtype=torch.long, device="cuda")
            got = model.prefill(padded)[0][0, P - 1]
            if not torch.isfinite(got).all():
                raise RuntimeError(f"request {r.rid}: non-finite logits")
            diff = (got - want).abs().max().item()
            top2 = torch.topk(want, 2).values
            gap = (top2[0] - top2[1]).item()
            agree = int(torch.argmax(want)) == r.tokens[0]
            checks.append({"rid": r.rid, "prompt_len": P,
                           "first_token_agrees": agree,
                           "top2_gap": gap, "logit_max_abs_diff": diff})
            if diff > 1e-3:
                raise RuntimeError(f"request {r.rid}: prefill logits differ "
                                   f"from the plain forward by {diff}")
            if not agree and gap >= 1e-3:
                raise RuntimeError(f"request {r.rid}: first token "
                                   f"{r.tokens[0]} != plain argmax "
                                   f"{int(torch.argmax(want))} (gap {gap})")
    log("slice first-token checks", json.dumps(checks))

    ttft = sorted(r.ttft_ms for r in reqs)
    stats = {"requests": len(reqs), "prefills": eng.prefills,
             "ticks": eng.ticks, "decode_tokens": eng.tokens_generated,
             "wall_s": wall, "decode_tokens_per_s":
                 eng.tokens_generated / sum(tick_s),
             "ms_per_tick": 1e3 * sum(tick_s) / len(tick_s),
             "ttft_p50_ms": ttft[len(ttft) // 2],
             "prefix_hit_blocks": eng.cache.prefix_hit_blocks,
             "launches": counts,
             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    log("slice", json.dumps(stats))
    phase_profile(torch, np, pt, eng)
    return counts, model, ref, prompts, [r.tokens for r in reqs]


def paged_tables(torch, gen, spans, bs, MB, N):
    """``[S, MB]`` int32 tables giving each slot a disjoint random run of
    pool blocks covering ``spans[s]`` positions (block 0 stays the null
    block)."""
    perm = (torch.randperm(N - 1, generator=gen, device="cuda") + 1).cpu()
    tables = torch.zeros(len(spans), MB, dtype=torch.int32)
    nxt = 0
    for s, L in enumerate(spans):
        nb = -(-L // bs)
        tables[s, :nb] = perm[nxt:nxt + nb]
        nxt += nb
    return tables.cuda()


def covered_rows(tables, spans, bs):
    """Distinct (block, offset) pool rows that positions ``< spans[s]``
    occupy."""
    return {(int(tables[s, p // bs]), p % bs)
            for s, L in enumerate(spans) for p in range(L)}


def span_vis(torch, start, n, Q, W):
    """``[S, Q, W]`` visibility of the span rows: row j of slot s sees
    positions ``<= start[s] + j`` when ``n[s] > 0``; and the visible pairs
    of the live rows (``j < n[s]``), the work the kernel must do."""
    pos = start.long()[:, None] + torch.arange(Q, device="cuda")[None]
    vis = (torch.arange(W, device="cuda")[None, None] <= pos[..., None]) \
        & (n > 0)[:, None, None]
    live = torch.arange(Q, device="cuda")[None] < n[:, None]
    return vis, int((vis & live[..., None]).sum().item())


def phase_span_kernels(torch, F, ca, kvc, gen, card):
    """The span kernel at the speculative and chunk shapes, its Q = 1 and
    per-row bit-equality with paged_decode, and the int8 branches of both
    kernels, each against its plain version."""
    H, D, bs, MB, N = 8, 64, 16, 64, 513
    W = MB * bs
    pk = torch.randn(N, bs, H, D, generator=gen, device="cuda")
    pv = torch.randn(N, bs, H, D, generator=gen, device="cuda")
    qk, qv = kvc.quantize_rows(pk), kvc.quantize_rows(pv)
    cases = {
        "spec [8,5,8,64]": (5, [59, 123, 300, 511, 700, 1019, 250, 0],
                            [5, 5, 5, 5, 5, 5, 3, 0]),
        "chunk [1,128,8,64]": (128, [384], [128]),
    }
    rows = {}
    for label, (Q, start_l, n_l) in cases.items():
        spans = [st + n for st, n in zip(start_l, n_l)]
        tables = paged_tables(torch, gen, spans, bs, MB, N)
        start = torch.tensor(start_l, dtype=torch.int32, device="cuda")
        n = torch.tensor(n_l, dtype=torch.int32, device="cuda")
        S = len(start_l)
        q = torch.randn(S, Q, H, D, generator=gen, device="cuda")
        vis, pairs = span_vis(torch, start, n, Q, W)
        nrows = len(covered_rows(tables, spans, bs))
        mask = vis[:, None]
        for quant in (False, True):
            name = "paged_span_int8" if quant else "paged_span"
            kp, vp = (qk, qv) if quant else (pk, pv)
            out = ca.paged_span_attention(q, kp, vp, tables, start, n)
            ref = ca.paged_span_plain(q, kp, vp, tables, start, n)
            torch.cuda.synchronize()
            live = torch.arange(Q, device="cuda")[None] < n[:, None]
            err = check_close(f"{name} {label}", out[live], ref[live])
            if (n == 0).any() and out[n == 0].abs().max().item() != 0.0:
                raise RuntimeError(f"{name} {label}: n == 0 must give zeros")
            check_rerun(torch, f"{name} {label}", out,
                        lambda: ca.paged_span_attention(q, kp, vp, tables,
                                                        start, n))
            log("paged plan", json.dumps(paged_grid(
                ca, f"{name} {label}", S, Q, H, D, bs, MB, start_l, n_l,
                quant)))
            row_bytes = H * (D + 4) if quant else 4 * H * D
            nbytes = 2 * nrows * row_bytes + 4 * (2 * S * Q * H * D
                                                  + S * MB + 2 * S)
            b_ms, b_by = bound(nbytes, 4 * D * H * pairs)
            kg = kvc.gather_pages(kp, tables).permute(0, 2, 1, 3).contiguous()
            vg = kvc.gather_pages(vp, tables).permute(0, 2, 1, 3).contiguous()
            qt = q.transpose(1, 2).contiguous()
            run = lambda: ca.paged_span_attention(  # noqa: E731
                q, kp, vp, tables, start, n)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kg, vg, attn_mask=mask)
            rows[name, label] = {
                "case": f"{label} start={start_l} n={n_l}",
                "max_abs_err": err,
                "kernel_ms": time_ms(torch, run),
                "plain_ms": time_ms(torch, lambda: ca.paged_span_plain(
                    q, kp, vp, tables, start, n)),
                "library_ms": time_ms(torch, lib),
                **paged_device_times(torch, run, lib),
                "library_note": "SDPA with an explicit mask on the "
                "pre-gathered" + (", pre-dequantized" if quant else "")
                + " context, gather not timed",
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                "flops": 4 * D * H * pairs, "card": card}
            log(name, json.dumps(rows[name, label]))
        if Q == 5:
            # row j is paged_decode at start + j + 1, bit for bit; Q = 1
            # is the span kernel's own one-row launch
            out = ca.paged_span_attention(q, pk, pv, tables, start, n)
            one = ca.paged_span_attention(q[:, :1].contiguous(), pk, pv,
                                          tables, start, n.clamp(max=1))
            worst = 0.0
            for j in range(Q):
                lengths = torch.where(n > j, start + j + 1, 0).to(
                    torch.int32)
                dec = ca.paged_decode_attention(q[:, j].contiguous(), pk, pv,
                                                tables, lengths)
                live = n > j
                worst = max(worst, (out[live, j] - dec[live]).abs().max()
                            .item())
                if j == 0:
                    q1 = (one[:, 0] - dec).abs().max().item()
            torch.cuda.synchronize()
            if worst != 0.0 or q1 != 0.0:
                raise RuntimeError(f"paged_span vs paged_decode: Q=1 max "
                                   f"|diff| {q1}, per row at Q=5 {worst}; "
                                   f"must be 0.0")
            log("paged_span bit-equality", json.dumps(
                {"q1_max_abs_diff_vs_paged_decode": q1,
                 "q5_rows_max_abs_diff_vs_paged_decode": worst}))

    # int8 decode at phase 2's lengths
    S, lengths_l = 8, [0, 1, 16, 17, 1024, 300, 511, 64]
    tables = paged_tables(torch, gen, lengths_l, bs, MB, N)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    q = torch.randn(S, H, D, generator=gen, device="cuda")
    out = ca.paged_decode_attention(q, qk, qv, tables, lengths)
    ref = ca.paged_decode_plain(q, qk, qv, tables, lengths)
    torch.cuda.synchronize()
    err = check_close("paged_decode_int8", out, ref)
    if out[0].abs().max().item() != 0.0:
        raise RuntimeError("paged_decode_int8: length 0 must give zeros")
    check_rerun(torch, "paged_decode_int8", out,
                lambda: ca.paged_decode_attention(q, qk, qv, tables, lengths))
    nrows = len(covered_rows(tables, lengths_l, bs))
    nbytes = 2 * nrows * H * (D + 4) + 4 * (2 * S * H * D + S * MB + S)
    b_ms, b_by = bound(nbytes, 4 * D * H * sum(lengths_l))
    kg = kvc.gather_pages(qk, tables).permute(0, 2, 1, 3).contiguous()
    vg = kvc.gather_pages(qv, tables).permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(W, device="cuda")[None] < lengths[:, None])[
        :, None, None, :]
    run = lambda: ca.paged_decode_attention(q, qk, qv, tables,  # noqa
                                            lengths)
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None], kg, vg, attn_mask=mask)
    rows["paged_decode_int8"] = {
        "case": f"S={S} H={H} D={D} bs={bs} MB={MB} N={N} "
                f"lengths={lengths_l}", "max_abs_err": err,
        "kernel_ms": time_ms(torch, run),
        "plain_ms": time_ms(torch, lambda: ca.paged_decode_plain(
            q, qk, qv, tables, lengths)),
        "library_ms": time_ms(torch, lib),
        **paged_device_times(torch, run, lib),
        "library_note": "SDPA on the pre-gathered, pre-dequantized context, "
        "gather not timed", "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "flops": 4 * D * H * sum(lengths_l), "card": card}
    log("paged_decode_int8", json.dumps(rows["paged_decode_int8"]))
    pools = {"": (pk, pv), " int8": (qk, qv),
             " bf16": (pk.bfloat16(), pv.bfloat16())}
    paged_boundary_rows(torch, ca, gen, pools)
    paged_no_sync(torch, ca, gen, pools)
    kernels_in_graphs(torch, ca, gen, pools)
    return rows


def check_bf16_paged(torch, name, out, ref, unrounded, slack):
    """A bf16-pool paged entry against its plain version: within TOL of
    max(1, max |plain|) beyond the rounding slack (``check_close``), and
    rounding p as the plain version does: its mean distance to the plain
    version under ROUNDED_SHARE of the plain version's own distance to the
    same function on f32 copies of the pools (which rounds nothing). Returns
    the row's error figures."""
    err = check_close(name, out, ref, rel=True, slack=slack)
    mean = (out - ref).abs().mean().item()
    effect = (unrounded - ref).abs().mean().item()
    if not mean <= ROUNDED_SHARE * effect:
        raise RuntimeError(f"{name}: mean |kernel - plain| {mean} is not "
                           f"under {ROUNDED_SHARE} x the rounding's own "
                           f"effect {effect}: p is not rounded as the plain "
                           f"version rounds it")
    diff = (out - ref).abs()
    return {"max_abs_err": err,
            "max_abs_err_beyond_slack": (diff - slack).max().item(),
            "entries_past_tol": int((diff > TOL).sum().item()),
            "mean_abs_err": mean, "rounding_effect_mean": effect}


def phase_paged_bf16(torch, F, ca, kvc, gen, card):
    """The bf16-pool branches of the paged kernels: ``paged_decode_bf16``
    at phase 2's lengths (D 64 and 128) and ``paged_span_bf16`` at phase
    4's speculative and chunk shapes (and the speculative one at D 128),
    each against its plain version (``check_bf16_paged``), a rerun
    bit-equal, with times, the bytes bound and SDPA on the gathered bf16
    context as the yardstick; at D 64 the profiler's device time of the
    call and of SDPA, each launch's (max pass, main pass, merge) and the
    gate that a call launches the kernels the design says. The spans' rows against ``paged_decode_bf16``
    across partition boundaries, no host sync and the entries in CUDA
    graphs run in phase 4 over the same pools."""
    bs, MB, N, H = 16, 64, 513, 8
    W = MB * bs
    rows = {}
    dec_lengths = [0, 1, 16, 17, 1024, 300, 511, 64]
    cases = [("paged_decode_bf16", f"S=8 H={H} D={D} bs={bs} MB={MB} N={N} "
              f"lengths={dec_lengths}", D, 1, [L - 1 for L in dec_lengths],
              [int(L > 0) for L in dec_lengths]) for D in (64, 128)]
    cases += [("paged_span_bf16", f"spec [8,5,8,{D}]", D, 5,
               [59, 123, 300, 511, 700, 1019, 250, 0],
               [5, 5, 5, 5, 5, 5, 3, 0]) for D in (64, 128)]
    cases.append(("paged_span_bf16", "chunk [1,128,8,64]", 64, 128, [384],
                  [128]))
    for name, label, D, Q, start_l, n_l in cases:
        S = len(start_l)
        spans = [st + n for st, n in zip(start_l, n_l)]
        tables = paged_tables(torch, gen, spans, bs, MB, N)
        start = torch.tensor(start_l, dtype=torch.int32, device="cuda")
        n = torch.tensor(n_l, dtype=torch.int32, device="cuda")
        pk = torch.randn(N, bs, H, D, generator=gen,
                         device="cuda").bfloat16()
        pv = torch.randn(N, bs, H, D, generator=gen,
                         device="cuda").bfloat16()
        q = torch.randn(S, Q, H, D, generator=gen, device="cuda")
        live = torch.arange(Q, device="cuda")[None] < n[:, None]
        if Q == 1:
            q = q[:, 0].contiguous()
            lengths = torch.tensor([st + 1 if c else 0 for st, c in
                                    zip(start_l, n_l)], dtype=torch.int32,
                                   device="cuda")
            run = lambda: ca.paged_decode_attention(  # noqa: E731
                q, pk, pv, tables, lengths)
            plain = lambda kp=pk, vp=pv: ca.paged_decode_plain(  # noqa
                q, kp, vp, tables, lengths)
            slack = ca.paged_rounding_slack(q[:, None], pk, pv, tables,
                                            start.clamp(min=0), n)[:, 0]
            sel = slice(None)
        else:
            run = lambda: ca.paged_span_attention(  # noqa: E731
                q, pk, pv, tables, start, n)
            plain = lambda kp=pk, vp=pv: ca.paged_span_plain(  # noqa
                q, kp, vp, tables, start, n)
            slack = ca.paged_rounding_slack(q, pk, pv, tables, start, n)
            sel = live
        before = ca.launch_counts()[name]
        out = run()
        if ca.launch_counts()[name] != before + 1:
            raise RuntimeError(f"{name} {label}: the wrapper did not launch "
                               f"the bf16 kernel")
        ref = plain()
        torch.cuda.synchronize()
        err = check_bf16_paged(torch, f"{name} {label}", out[sel], ref[sel],
                               plain(pk.float(), pv.float())[sel], slack[sel])
        if (n == 0).any() and out[n == 0].abs().max().item() != 0.0:
            raise RuntimeError(f"{name} {label}: an inactive slot must give "
                               f"zeros")
        check_rerun(torch, f"{name} {label}", out, run)
        log("paged plan", json.dumps(paged_grid(
            ca, f"{name} {label}", S, Q, H, D, bs, MB, start_l, n_l,
            ca.POOL_BF16)))
        vis, pairs = span_vis(torch, start, n, Q, W)
        nrows = len(covered_rows(tables, spans, bs))
        nbytes = 2 * nrows * 2 * H * D + 4 * (2 * S * Q * H * D + S * MB
                                               + (2 if Q > 1 else 1) * S)
        b_ms, b_by = bound(nbytes, 4 * D * H * pairs)
        kg = kvc.gather_pages(pk, tables).permute(0, 2, 1, 3).contiguous()
        vg = kvc.gather_pages(pv, tables).permute(0, 2, 1, 3).contiguous()
        qt = (q[:, :, None] if Q == 1 else q.transpose(1, 2)).bfloat16()
        qt = qt.contiguous()
        mask = vis[:, None]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kg, vg, attn_mask=mask)
        rows[name, label] = {
            "case": f"{label} start={start_l} n={n_l}", **err,
            "kernel_ms": time_ms(torch, run),
            "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, lib),
            # profiler device time at D 64 (the kernels line's rows: decode
            # and the speculative span; and the chunk)
            **(paged_device_times(torch, run, lib) if D == 64 else {}),
            "library_note": "SDPA with an explicit mask on the pre-gathered "
            "bf16 context, q rounded to bf16, gather not timed",
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": 4 * D * H * pairs, "card": card}
        if D == 64:
            # each launch's device time, and how many a call makes
            rows[name, label]["launch_device_ms"] = paged_launches(
                f"{name} {label}", rows[name, label]["device_rows"])
        log(name, json.dumps(rows[name, label]))
    return rows


def paged_boundary_rows(torch, ca, gen, pools):
    """Spans across the plan's partition boundaries over each pool pair of
    ``pools`` (f32, int8, bf16): each live row bit-equal to the paged
    decode at ``start + j + 1``, at the speculative width and at a 128-row
    chunk."""
    N, bs, H, D = pools[""][0].shape
    MB = 64
    P = ca.paged_plan(MB, bs, D, 5).part
    W = MB * bs
    cases = {5: ([P - 3, 2 * P - 1, 3 * P - 4, P - 5, 4 * P - 2, W - 5, 0,
                  P - 1], [5, 5, 5, 5, 5, 5, 5, 3]),
             128: ([3 * P - 64, max(0, 2 * P - 100)], [128, 100])}
    worst, starts = {}, {}
    for Q, (start_l, n_l) in cases.items():
        start_l = [min(st, W - n) for st, n in zip(start_l, n_l)]
        starts[Q] = start_l
        spans = [st + n for st, n in zip(start_l, n_l)]
        tables = paged_tables(torch, gen, spans, bs, MB, N)
        start = torch.tensor(start_l, dtype=torch.int32, device="cuda")
        n = torch.tensor(n_l, dtype=torch.int32, device="cuda")
        q = torch.randn(len(start_l), Q, H, D, generator=gen, device="cuda")
        for tag, (kp, vp) in pools.items():
            out = ca.paged_span_attention(q, kp, vp, tables, start, n)
            diff = 0.0
            for j in range(Q):
                lengths = torch.where(n > j, start + j + 1, 0).to(
                    torch.int32)
                dec = ca.paged_decode_attention(q[:, j].contiguous(), kp, vp,
                                                tables, lengths)
                live = n > j
                diff = max(diff, (out[live, j] - dec[live]).abs().max()
                           .item())
            torch.cuda.synchronize()
            key = f"Q={Q}{tag}"
            worst[key] = diff
            if diff != 0.0:
                raise RuntimeError(f"paged_span {key} across partition "
                                   f"boundaries (P={P}): rows differ from "
                                   f"paged_decode by {diff}; must be 0.0")
    log("paged_span bit-equality across partitions", json.dumps(
        {"partition": P, "starts": starts,
         "max_abs_diff_vs_paged_decode": worst}))


def paged_no_sync(torch, ca, gen, pools):
    """The six paged entries (decode and span over each pool pair of
    ``pools``) once under ``set_sync_debug_mode("error")``: a wrapper that
    read a per-slot value on the host would raise."""
    N, bs, H, D = pools[""][0].shape
    lengths_l = [0, 1, 300, 1024]
    tables = paged_tables(torch, gen, lengths_l, bs, 64, N)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    start = torch.tensor([0, 100, 290, 1019], dtype=torch.int32,
                         device="cuda")
    n = torch.tensor([0, 5, 5, 5], dtype=torch.int32, device="cuda")
    q1 = torch.randn(4, H, D, generator=gen, device="cuda")
    q5 = torch.randn(4, 5, H, D, generator=gen, device="cuda")
    torch.cuda.synchronize()
    before = ca.launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for kp, vp in pools.values():
            ca.paged_decode_attention(q1, kp, vp, tables, lengths)
            ca.paged_span_attention(q5, kp, vp, tables, start, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = ca.launch_counts()
    names = [f"paged_{e}{tag.replace(' ', '_')}" for tag in pools
             for e in ("decode", "span")]
    if any(after[k] != before[k] + 1 for k in names):
        raise RuntimeError(f"paged no-sync run: launches {after} vs "
                           f"{before}")
    log("paged entries under sync debug mode \"error\": no synchronisation "
        "in", ", ".join(names))


def kernels_in_graphs(torch, ca, gen, pools):
    """The seven kernel entries of the serving programs (flash forward;
    paged decode and span over each pool pair of ``pools``), each captured
    alone in a CUDA graph (after one eager launch on the capture stream):
    two replays, each after new query values are copied into the captured
    input, held against the plain version on those values (bf16 pools with
    their rounding slack); the capture counts one launch and each replay
    adds it."""
    N, bs, H, D = pools[""][0].shape
    lengths_l = [0, 1, 300, 1024]
    tables = paged_tables(torch, gen, lengths_l, bs, 64, N)
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device="cuda")
    start = torch.tensor([0, 100, 290, 1019], dtype=torch.int32,
                         device="cuda")
    n = torch.tensor([0, 5, 3, 5], dtype=torch.int32, device="cuda")
    live = torch.arange(5, device="cuda")[None] < n[:, None]
    q1 = torch.randn(4, H, D, generator=gen, device="cuda")
    q5 = torch.randn(4, 5, H, D, generator=gen, device="cuda")
    fq, fk, fv = (torch.randn(1, 8, 1024, 64, generator=gen, device="cuda")
                  for _ in range(3))
    every = slice(None)
    cases = [("flash_fwd", fq, every,
              lambda: ca.flash_attention_fwd(fq, fk, fv, None, True)[0],
              lambda: ca.flash_attention_plain(fq, fk, fv, None, True)[0],
              None)]
    dec_start, dec_n = (lengths - 1).clamp(min=0), (lengths > 0).int()
    for tag, (kp, vp) in pools.items():
        tag = tag.replace(" ", "_")
        cases += [
            ("paged_decode" + tag, q1, every,
             lambda kp=kp, vp=vp: ca.paged_decode_attention(
                 q1, kp, vp, tables, lengths),
             lambda kp=kp, vp=vp: ca.paged_decode_plain(
                 q1, kp, vp, tables, lengths),
             lambda kp=kp, vp=vp: ca.paged_rounding_slack(
                 q1[:, None], kp, vp, tables, dec_start, dec_n)[:, 0]),
            ("paged_span" + tag, q5, live,
             lambda kp=kp, vp=vp: ca.paged_span_attention(
                 q5, kp, vp, tables, start, n),
             lambda kp=kp, vp=vp: ca.paged_span_plain(
                 q5, kp, vp, tables, start, n),
             lambda kp=kp, vp=vp: ca.paged_rounding_slack(
                 q5, kp, vp, tables, start, n))]
    errs = {}
    stream = torch.cuda.Stream()
    for name, q, rows, run, plain, slack in cases:
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            run()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with ca.capturing_launches() as captured, \
                torch.cuda.graph(graph, stream=stream):
            out = run()
        before = ca.launch_counts()
        worst = 0.0
        for _ in range(2):
            q.copy_(torch.randn(q.shape, generator=gen, device="cuda"))
            graph.replay()
            ca.count_replay(captured)
            torch.cuda.synchronize()
            want = plain()
            worst = max(worst, check_close(
                f"{name} in a graph", out[rows], want[rows],
                slack=None if slack is None else slack()[rows]))
        after = ca.launch_counts()
        if {k: v for k, v in captured.items() if v} != {name: 1} \
                or after[name] != before[name] + 2:
            raise RuntimeError(f"{name} in a graph: captured {captured}, "
                               f"launches {before[name]} -> {after[name]}")
        errs[name] = worst
    log("kernels in CUDA graphs (two replays each, max |kernel - plain|)",
        json.dumps(errs))


def first_diff(a, b):
    """Index of the first position where token lists differ, or None."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def top2_gap(torch, logits):
    top = torch.topk(logits.float(), 2).values
    return (top[0] - top[1]).item()


def ref_gap(torch, ref, prompt, toks, i):
    """Top-2 gap of the plain-attention forward's logits for token ``i``
    of a request (after its prompt and tokens ``< i``)."""
    ids = torch.tensor([prompt + toks[:i]], device="cuda")
    with torch.no_grad():
        return top2_gap(torch, ref(ids)[0, -1])


def run_requests(torch, pt, ca, eng, prompts, new):
    """Serve ``prompts`` through a scheduler with the launch counts set to
    0 just before and read just after; returns (requests, counts, summed
    tick seconds, wall seconds)."""
    sched = pt.ContinuousBatchingScheduler(eng)
    tick_s = []
    tick = eng.decode_tick

    def timed_tick():
        t = time.perf_counter()
        out = tick()                   # ends in a device-to-host copy
        tick_s.append(time.perf_counter() - t)
        return out

    eng.decode_tick = timed_tick
    torch.cuda.synchronize()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [sched.submit(p, new) for p in prompts]
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ca.launch_counts()
    del eng.decode_tick
    return reqs, counts, tick_s, wall


def check_requests(label, reqs, new, V):
    for r in reqs:
        if r.finish_reason != "length" or len(r.tokens) != new \
                or not all(0 <= t < V for t in r.tokens):
            raise RuntimeError(f"{label} request {r.rid}: "
                               f"{r.finish_reason}, {len(r.tokens)} tokens")


def compare_tokens(label, torch, want, got, gap_fn, tol=GAP_TOL):
    """Requests whose token lists differ, each with its first differing
    position and the top-2 gap there; raises when a gap is not under
    ``tol``."""
    diffs = []
    for rid, (a, b) in enumerate(zip(want, got)):
        i = first_diff(a, b)
        if i is None:
            continue
        gap = gap_fn(rid, i)
        diffs.append({"rid": rid, "position": i, "top2_gap": gap})
        if not gap < tol:
            raise RuntimeError(f"{label}: request {rid} differs at token {i} "
                               f"with a top-2 gap of {gap}")
    return diffs


def phase_span_serving(torch, np, pt, ca, model, ref, prompts, tokens, card):
    """(a) speculation + chunked prefill over phase 3's requests, (b) the
    speculative leg, (c) int8 pools, paged against xla."""
    V, L, new = 32000, 6, 32
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # (a)
    eng = pt.DecodeEngine(model, max_slots=8, block_size=16,
                          attention="paged", speculative=4,
                          prefill_chunk=128)
    start_free = eng.cache.free_blocks
    f32_bytes = eng.cache.kv_bytes_per_token
    eng.warmup()
    reqs, c, tick_s, wall = run_requests(torch, pt, ca, eng, prompts, new)
    add(c)
    check_requests("span (a)", reqs, new, V)
    if c["paged_span"] != (eng.prefill_chunks + eng.ticks) * L:
        raise RuntimeError(f"paged_span launches {c['paged_span']} != "
                           f"(chunks {eng.prefill_chunks} + ticks "
                           f"{eng.ticks}) x {L}")
    if c["paged_decode"] or c["flash_fwd"]:
        raise RuntimeError(f"span engine launched other kernels: {c}")
    if eng.cache.free_blocks != start_free or eng.cache.allocator._rc:
        raise RuntimeError("span (a): pool leak")
    got = [r.tokens for r in reqs]
    diffs = compare_tokens("span (a) vs phase 3", torch, tokens, got,
                           lambda rid, i: ref_gap(torch, ref, prompts[rid],
                                                  tokens[rid], i))
    log("span serving (a)", json.dumps({
        "engine": "speculative=4, prefill_chunk=128, paged, f32",
        "requests": len(reqs), "prefill_chunks": eng.prefill_chunks,
        "ticks": eng.ticks, "decode_tokens": eng.tokens_generated,
        "draft_accept_rate": eng.draft_accepted / max(1, eng.draft_proposed),
        "wall_s": wall, "ms_per_tick": 1e3 * sum(tick_s) / len(tick_s),
        "decode_tokens_per_s": eng.tokens_generated / sum(tick_s),
        "tokens_equal_phase3": sum(a == b for a, b in zip(tokens, got)),
        "differing": diffs, "launches": c, "card": card}))

    def chunked_prefill():
        while eng.prefill_step(0) is None:
            pass

    eng.begin_prefill(0, [int(t) for t in np.random.RandomState(2).randint(
        0, V, 512)], reserve_len=512 + new)
    log("span profile", json.dumps(profile_window(
        torch, chunked_prefill, "chunked prefill of a 512-token prompt: 4 "
        "chunks of 128 (f32), no other slot busy", PAGED_ROWS)))
    eng.evict(0)

    # (b) the transformer_decode_spec leg at full width
    rng = np.random.RandomState(0)
    period = rng.randint(1, V, 4)
    prompt = [int(t) for t in np.tile(period, 33)[:128]]
    legs, streams = {}, {}
    for k in (0, 4):
        eng = pt.DecodeEngine(model, max_slots=8, block_size=16,
                              attention="paged", speculative=k)
        torch.cuda.synchronize()
        ca.reset_launch_counts()
        for slot in range(8):
            eng.admit(slot, list(prompt), reserve_len=eng.context_width)
        for _ in range(4):
            eng.decode_tick()
        tok0, prop0, acc0 = (eng.tokens_generated, eng.draft_proposed,
                             eng.draft_accepted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(24):
            eng.decode_tick()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        add(ca.launch_counts())
        toks = eng.tokens_generated - tok0
        prop = eng.draft_proposed - prop0
        legs[k] = {"tokens": toks, "wall_s": wall,
                   "accepted_tokens_per_s": toks / wall,
                   "ms_per_tick": wall / 24 * 1e3,
                   "accept_rate": (eng.draft_accepted - acc0) / prop
                   if prop else None}
        streams[k] = [list(eng.history[s][128:]) for s in range(8)]
        log("span profile", json.dumps(profile_window(
            torch, lambda: [eng.decode_tick() for _ in range(4)],
            f"4 decode ticks, speculative={k}, 8 active slots",
            PAGED_ROWS)))
    for s in range(8):
        base = streams[0][s]
        if streams[4][s][:len(base)] != base:
            raise RuntimeError(f"spec leg: slot {s} speculative=4 tokens "
                               f"differ from speculative=0")
    log("span serving (b)", json.dumps({
        "leg": "transformer_decode_spec shape: 8 slots, periodic prompts "
               "(period 4, 128 tokens), 4 warm-up + 24 timed ticks",
        "speculative_0": legs[0], "speculative_4": legs[4],
        "speedup": legs[4]["accepted_tokens_per_s"]
        / legs[0]["accepted_tokens_per_s"],
        "tokens_identical": True,
        "compared_tokens_per_slot": len(streams[0][0]), "card": card}))

    # (c) int8 pools, paged against xla, over the 16 requests
    out, engines = {}, {}
    for impl in ("paged", "xla"):
        eng = pt.DecodeEngine(model, max_slots=8, block_size=16,
                              attention=impl, kv_dtype="int8",
                              prefill_chunk=128)
        start_free = eng.cache.free_blocks
        eng.warmup()
        reqs, c, tick_s, wall = run_requests(torch, pt, ca, eng, prompts,
                                             new)
        add(c)
        check_requests(f"int8 {impl}", reqs, new, V)
        if eng.cache.free_blocks != start_free or eng.cache.allocator._rc:
            raise RuntimeError(f"int8 {impl}: pool leak")
        out[impl] = ([r.tokens for r in reqs], tick_s, wall, c)
        engines[impl] = eng
    paged = out["paged"][0]
    c = out["paged"][3]
    if c["paged_span_int8"] != engines["paged"].prefill_chunks * L \
            or c["paged_decode_int8"] != engines["paged"].ticks * L:
        raise RuntimeError(f"int8 launches {c} vs chunks "
                           f"{engines['paged'].prefill_chunks} and ticks "
                           f"{engines['paged'].ticks} x {L}")

    eng = engines["paged"]
    rng = np.random.RandomState(3)
    for slot in range(8):
        eng.admit(slot, [int(t) for t in rng.randint(0, V, 128)],
                  reserve_len=128 + 12)
    eng.decode_tick()
    log("span profile", json.dumps(profile_window(
        torch, lambda: [eng.decode_tick() for _ in range(8)],
        "8 decode ticks, kv_dtype=int8, 8 active slots", PAGED_ROWS)))
    for slot in range(8):
        eng.evict(slot)

    diffs = compare_tokens(
        "int8 paged vs xla", torch, out["xla"][0], paged,
        lambda rid, i: replay_gap(torch, pt, model, {"kv_dtype": "int8"},
                                  prompts[rid], new, i))
    same = sum(a == b for x, y in zip(tokens, paged) for a, b in zip(x, y))
    tick_s = out["paged"][1]
    log("span serving (c)", json.dumps({
        "engine": "kv_dtype=int8, prefill_chunk=128",
        "paged_vs_xla_requests_equal": sum(
            a == b for a, b in zip(out["xla"][0], paged)),
        "paged_vs_xla_differing": diffs,
        "decode_tokens_per_s_paged": engines["paged"].tokens_generated
        / sum(tick_s),
        "ms_per_tick_paged": 1e3 * sum(tick_s) / len(tick_s),
        "ms_per_tick_xla": 1e3 * sum(out["xla"][1]) / len(out["xla"][1]),
        "kv_bytes_per_token_int8": engines["paged"].cache.kv_bytes_per_token,
        "kv_bytes_per_token_f32": f32_bytes,
        "int8_vs_f32_token_agreement": same / sum(len(t) for t in tokens),
        "int8_vs_f32_requests_equal": sum(a == b for a, b in zip(tokens,
                                                                paged)),
        "launches_paged": out["paged"][3], "launches_xla": out["xla"][3],
        "card": card}))
    return counts


def replay_gap(torch, pt, model, kw, prompt, new, i):
    """Top-2 gap of the logits token ``i`` of a request came from on a
    ``"paged"`` engine of arguments ``kw`` (chunked prefill of 128): the
    request replayed alone, the programs' bodies run eagerly."""
    eng = eager_body(pt.DecodeEngine(model, max_slots=1, block_size=16,
                                     attention="paged", prefill_chunk=128,
                                     **kw))
    seen = []
    for name in ("decode_step", "decode_span"):
        fn = getattr(model, name)
        setattr(model, name, lambda *a, _fn=fn, **k: seen.append(
            _fn(*a, **k)) or seen[-1])
    try:
        eng.admit(0, list(prompt), reserve_len=len(prompt) + new)
        n_last = (len(prompt) - 1) % 128 + 1
        logits = seen[-1][0][0, n_last - 1]
        for _ in range(i):
            eng.decode_tick()
            logits = seen[-1][0][0]
    finally:
        del model.decode_step, model.decode_span
    return top2_gap(torch, logits)


def eager_body(eng):
    """``eng`` with every call run through its programs' bodies eagerly,
    on the same static buffers: the function each CUDA graph captures,
    as the yardstick of the graphs (and a way to read the logits a call
    made)."""
    for prog in (eng._prefill, eng._tick):
        def launch(_prog=prog, **values):
            _prog.inputs.stage(**values)
            _prog.eager_out = _prog.run_eager()

        prog.launch = launch
        prog.fetch = lambda _prog=prog: _prog.eager_out.cpu().numpy()
    return eng


# the graph serving phase's modes: engine arguments and the kernel each
# program must capture, L times
SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 7}
GRAPH_MODES = [
    ("greedy", {}, "flash_fwd", "paged_decode"),
    ("bf16 pools", {"dtype": "bfloat16"}, "flash_fwd", "paged_decode_bf16"),
    ("bf16 pools, speculative=4, prefill_chunk=128",
     {"dtype": "bfloat16", "speculative": 4, "prefill_chunk": 128},
     "paged_span_bf16", "paged_span_bf16"),
    ("speculative=4, prefill_chunk=128",
     {"speculative": 4, "prefill_chunk": 128}, "paged_span", "paged_span"),
    ("int8, prefill_chunk=128", {"kv_dtype": "int8", "prefill_chunk": 128},
     "paged_span_int8", "paged_decode_int8"),
    ("sampled", {"sampling": SAMPLED}, "flash_fwd", "paged_decode"),
    ("sampled, speculative=4", {"sampling": SAMPLED, "speculative": 4},
     "flash_fwd", "paged_span"),
]


def serving_numbers(eng, reqs, tick_s, wall):
    ttft = sorted(r.ttft_ms for r in reqs)
    return {"ticks": eng.ticks, "decode_tokens": eng.tokens_generated,
            "wall_s": wall, "ms_per_tick": 1e3 * sum(tick_s) / len(tick_s),
            "decode_tokens_per_s": eng.tokens_generated / sum(tick_s),
            "ttft_p50_ms": ttft[len(ttft) // 2]}


def steady_ticks(torch, np, eng, window):
    """8 slots of 128-token prompts: ms per tick over 8 ticks after one,
    then the device busy time and idle share over 8 more under the
    profiler; the idle share also against the 8 unprofiled ticks' wall."""
    rng = np.random.RandomState(1)
    for slot in range(8):
        eng.admit(slot, [int(t) for t in rng.randint(0, 32000, 128)],
                  reserve_len=128 + 96)
    eng.decode_tick()
    torch.cuda.synchronize()
    tok0, t0 = eng.tokens_generated, time.perf_counter()
    for _ in range(8):
        eng.decode_tick()
    wall = time.perf_counter() - t0
    tokens = eng.tokens_generated - tok0
    prof = profile_window(torch, lambda: [eng.decode_tick()
                                          for _ in range(8)], window,
                          PAGED_ROWS)
    # the profiler's own host work stretches its window's wall time, so
    # the idle share is also given against the unprofiled ticks' wall
    out = {"ms_per_tick": wall / 8 * 1e3, "tokens_per_s": tokens / wall,
           "device_busy_ms_per_tick": prof["device_busy_ms"] / 8,
           "idle_share_of_unprofiled_wall": 1 - prof["device_busy_ms"]
           / (wall * 1e3), "profile": prof}
    for slot in range(8):
        eng.evict(slot)
    return out


def phase_graph_serving(torch, np, pt, ca, model, prompts, card,
                        modes=GRAPH_MODES, tag="", rows=None):
    """The serving programs as CUDA graphs at the transformer_decode
    width, in seven modes (greedy; bf16 pools greedy and with
    speculative=4, prefill_chunk=128; speculative=4 with
    prefill_chunk=128; int8 pools with prefill_chunk=128; sampled at
    temperature 0.8, top-k 50, top-p 0.95, with and without
    speculative=4), over phase 3's 16 requests of 32 tokens. In each mode: compile counts {prefill: 1, tick:
    1} after warmup and after the run; each program captured its kernel L
    times; the launch counts equal replays times captured launches; the
    pools return to their start; the greedy tokens equal, bit for bit,
    those of the same engine with its programs' bodies run eagerly; the
    sampled tokens equal those of a second seeded engine that was not
    warmed; the bf16-pool modes also ``bf16_pool_checks``. Then ms per
    tick, tokens/s, TTFT p50 and the idle share over 8 steady ticks of
    the graphs, and for greedy also of the eager bodies (what the graphs
    save). ``modes`` picks the
    modes; under a dtype policy (the caller's ``use_policy``) the graphs
    are captured and the eager bodies run under it, ``tag`` naming it in
    the log; ``rows``, a list, collects each mode's logged row."""
    V, L, new = 32000, 6, 32
    counts = {}
    progs = ("prefill", "tick")

    def engine(kw, attention="paged"):
        kw = dict(kw)
        if "sampling" in kw:
            kw["sampling"] = pt.SamplingConfig(**kw["sampling"])
        if "dtype" in kw:
            kw["dtype"] = getattr(torch, kw["dtype"])
        return pt.DecodeEngine(model, max_slots=8, block_size=16,
                               attention=attention, **kw)

    for label, kw, k_prefill, k_tick in modes:
        eng = engine(kw)
        start_free = eng.cache.free_blocks
        warm = eng.warmup()
        cap = {p.name: {k: v for k, v in p.captured.items() if v}
               for p in (eng._prefill, eng._tick)}
        if warm["compile_counts"] != {"prefill": 1, "tick": 1} \
                or cap != {"prefill": {k_prefill: L}, "tick": {k_tick: L}}:
            raise RuntimeError(f"graphs {label}: warmup {warm}, captured "
                               f"{cap}")
        before = {p.name: p.replays for p in (eng._prefill, eng._tick)}
        reqs, c, tick_s, wall = run_requests(torch, pt, ca, eng, prompts,
                                             new)
        reps = {p.name: p.replays - before[p.name]
                for p in (eng._prefill, eng._tick)}
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        check_requests(f"graphs {label}", reqs, new, V)
        want = {k: sum(reps[n] * cap[n].get(k, 0) for n in progs)
                for k in ca.KERNELS}
        if c != want or reps != {"prefill": eng.prefill_chunks,
                                 "tick": eng.ticks}:
            raise RuntimeError(f"graphs {label}: launches {c} != replays "
                               f"{reps} x captured {cap}")
        if eng.compile_counts() != {"prefill": 1, "tick": 1}:
            raise RuntimeError(f"graphs {label}: rebuilt, "
                               f"{eng.compile_counts()}")
        if eng.cache.free_blocks != start_free or eng.cache.allocator._rc:
            raise RuntimeError(f"graphs {label}: pool leak")
        got = [r.tokens for r in reqs]
        row = {"mode": label, "warmup": warm, "captured": cap,
               "replays": reps, "launches": c,
               "graph": serving_numbers(eng, reqs, tick_s, wall)}

        ref_eng = None
        if "sampling" in kw:
            cold = engine(kw)             # not warmed: captured on first use
            c_reqs, _, _, _ = run_requests(torch, pt, ca, cold, prompts, new)
            if [r.tokens for r in c_reqs] != got \
                    or cold.compile_counts() != {"prefill": 1, "tick": 1}:
                raise RuntimeError(f"graphs {label}: an unwarmed engine of "
                                   f"the same seed gave other tokens")
            row["unwarmed_engine_tokens_identical"] = True
            row["distinct_tokens"] = len({t for toks in got for t in toks})
        else:
            ref_eng = eager_body(engine(kw))
            e_reqs, e_c, e_tick_s, e_wall = run_requests(
                torch, pt, ca, ref_eng, prompts, new)
            eager = [r.tokens for r in e_reqs]
            row["eager"] = serving_numbers(ref_eng, e_reqs, e_tick_s, e_wall)
            row["eager_launches"] = e_c
            if got != eager:
                raise RuntimeError(
                    f"graphs {label}: tokens differ from the eager bodies' "
                    f"in {sum(a != b for a, b in zip(got, eager))} requests")
        if "dtype" in kw:
            row.update(bf16_pool_checks(torch, pt, ca, model, prompts, new,
                                        kw, eng, engine(kw, "xla"), got,
                                        counts))
        row["steady_graph"] = steady_ticks(
            torch, np, eng, f"graphs, {label}: 8 ticks, 8 active slots")
        if label == "greedy":
            # what the graphs save: the same ticks with the programs'
            # bodies run eagerly, once a policy
            row["steady_eager"] = steady_ticks(
                torch, np, ref_eng, f"eager bodies, {label}: 8 ticks, 8 "
                f"active slots")
        row["card"] = card
        log(f"graph serving{tag}", json.dumps(row))
        if rows is not None:
            rows.append(row)
        del eng, ref_eng
    return counts


def bf16_pool_checks(torch, pt, ca, model, prompts, new, kw, eng, xla, got,
                     counts):
    """A bf16-pool graph mode's own checks: half of f32's bytes a token at
    this width (6 layers x 2 x 8 heads x 64 x 2 bytes = 12,288), and the
    tokens against the "xla" path's (served through its own graphs) where
    the paged logits' top-2 gap is over BF16_POOL_GAP_TOL."""
    if eng.cache.kv_bytes_per_token != 12288 \
            or eng.cache.k.dtype != torch.bfloat16:
        raise RuntimeError(f"bf16 pools: {eng.cache.kv_bytes_per_token} "
                           f"bytes a token, pools {eng.cache.k.dtype}")
    xla.warmup()
    reqs, c, _, _ = run_requests(torch, pt, ca, xla, prompts, new)
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v
    if any(v for k, v in c.items() if k.startswith("paged")):
        raise RuntimeError(f"bf16 pools, xla: paged launches {c}")
    want = [r.tokens for r in reqs]
    pools = {k: v for k, v in kw.items() if k == "dtype"}
    pools["dtype"] = getattr(torch, pools["dtype"])
    diffs = compare_tokens(
        "bf16 pools, paged vs xla", torch, want, got,
        lambda rid, i: replay_gap(torch, pt, model, pools, prompts[rid],
                                  new, i), BF16_POOL_GAP_TOL)
    return {"kv_bytes_per_token": eng.cache.kv_bytes_per_token,
            "paged_vs_xla_requests_equal": sum(
                a == b for a, b in zip(want, got)),
            "paged_vs_xla_differing": diffs}


def phase_handoff(torch, np, pt, ca, kvc, model, prompts, card):
    """Prefill/decode disaggregation at the transformer_decode width over
    phase 3's 16 requests of 32 tokens, for f32, bf16 and int8 pools: a
    ``role="prefill"`` scheduler and a ``role="decode"`` one, each with
    its own engine (CUDA graphs, warmed), the hand-offs crossing as
    per-block blobs (each exactly ``bytes_per_block`` long) into
    ``adopt``; the greedy tokens must equal a colocated engine's bit for
    bit. Launch counts of the disaggregated runs are the path's."""
    V, new = 32000, 32
    counts = {}
    for label, kw in (("f32", {}), ("bf16", {"dtype": torch.bfloat16}),
                      ("int8", {"kv_dtype": "int8"})):
        def engine():
            eng = pt.DecodeEngine(model, max_slots=8, block_size=16,
                                  attention="paged", **kw)
            eng.warmup()
            return eng

        col = engine()
        reqs, _, _, _ = run_requests(torch, pt, ca, col, prompts, new)
        want = [r.tokens for r in reqs]
        del col
        pre = pt.ContinuousBatchingScheduler(engine(), role="prefill")
        dec = pt.ContinuousBatchingScheduler(engine(), role="decode")
        c = dec.engine.cache
        geom = dict(num_layers=c.num_layers, block_size=c.block_size,
                    num_heads=c.num_heads, head_dim=c.head_dim,
                    quantized=c.quantized, dtype=c.dtype)
        torch.cuda.synchronize()
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        subs = [pre.submit(p, new) for p in prompts]
        pending, blobs_n, wire_bytes, steps = [], 0, 0, 0
        while pre.queue or pre.prefilling or pre.running or pending \
                or dec.running:
            pre.step()
            pending += pre.pop_handoffs()
            waiting = []
            for item in pending:
                req, meta, kpages, vpages = item
                blobs = kvc.pages_to_blobs(kpages, vpages)
                if len(blobs) != meta["blocks"] or any(
                        len(b) != c.bytes_per_block for b in blobs):
                    raise RuntimeError(f"handoff {label}: blobs of "
                                       f"{sorted({len(b) for b in blobs})} "
                                       f"bytes, a block holds "
                                       f"{c.bytes_per_block}")
                if dec.adopt(meta, *kvc.blobs_to_pages(blobs, **geom)) \
                        is None:
                    waiting.append(item)
                else:
                    blobs_n += len(blobs)
                    wire_bytes += sum(len(b) for b in blobs)
            pending = waiting
            dec.step()
            steps += 1
            if steps > 10000:
                raise RuntimeError(f"handoff {label}: did not drain")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got_c = ca.launch_counts()
        for k, v in got_c.items():
            counts[k] = counts.get(k, 0) + v
        done = {r.rid: r for r in pre.completed + dec.completed}
        got = [done[r.rid].tokens for r in subs]
        if got != want:
            raise RuntimeError(f"handoff {label}: tokens differ from the "
                               f"colocated engine's in "
                               f"{sum(a != b for a, b in zip(got, want))} "
                               f"requests")
        check_requests(f"handoff {label}", [done[r.rid] for r in subs],
                       new, V)
        ttft = sorted(done[r.rid].ttft_ms for r in subs)
        log("handoff", json.dumps({
            "pools": label, "requests": len(subs), "adopted": len(
                dec.completed), "blobs": blobs_n,
            "bytes_per_block": c.bytes_per_block,
            "kv_bytes_per_token": c.kv_bytes_per_token,
            "wire_bytes": wire_bytes, "tokens_equal_colocated": True,
            "wall_s": wall, "ttft_p50_ms": ttft[len(ttft) // 2],
            "decode_ticks": dec.engine.ticks, "prefill_ticks":
                pre.engine.ticks, "compile_counts": {
                    "prefill": pre.engine.compile_counts(),
                    "decode": dec.engine.compile_counts()},
            "launches": got_c, "card": card}))
        if pre.engine.ticks or dec.engine.prefills:
            raise RuntimeError(f"handoff {label}: the prefill engine ticked "
                               f"or the decode engine prefilled")
    return counts


def phase_profile(torch, np, pt, eng):
    """Device busy share and time by kernel over 8 steady decode ticks of
    8 active slots (prompts of 128), from torch.profiler."""
    sched = pt.ContinuousBatchingScheduler(eng)
    rng = np.random.RandomState(1)
    for _ in range(8):
        sched.submit([int(t) for t in rng.randint(0, 32000, 128)], 12)
    sched.step()                       # 8 prefills and the first tick
    log("profile", json.dumps(profile_window(
        torch, lambda: [sched.step() for _ in range(8)],
        "8 decode ticks, 8 active slots", PAGED_ROWS)))
    sched.run()


def profile_window(torch, fn, window, kernels=()):
    """``fn`` run once under torch.profiler, ending in a synchronize."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_profile(prof, wall_ms, window, kernels)


def device_profile(prof, wall_ms, window, kernels=()):
    """Device busy time, idle share and the top device rows of a
    profiler window; with ``kernels`` (substrings of kernel names) also
    their device time and share of the busy time."""
    # device-side rows only (kernels, copies): the CPU ops that launched
    # them carry the same time again
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(r[2] for r in rows)
    top = sorted(rows, key=lambda r: -r[2])[:8]
    out = {"window": window, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
           else None,
           "top": [{"name": n[:80], "calls": c, "device_ms": t}
                   for n, c, t in top]}
    if kernels:
        ms = sum(t for n, _, t in rows if any(k in n for k in kernels))
        out.update(kernel_device_ms=ms,
                   kernel_share=ms / busy_ms if busy_ms else None)
    return out


def conflicting_pairs(np, batch_size, seq_len, vocab):
    """The ``prep_transformer`` batch (``bench.py``): input rows in
    identical pairs, independent random targets, so a causal model must
    split probability between two targets wherever they differ — a loss
    floor of ln 2 times the share of differing targets."""
    rng = np.random.RandomState(0)
    half = batch_size // 2
    inp_u = rng.randint(0, vocab, (half, seq_len))
    inp = np.concatenate([inp_u, inp_u], axis=0).astype(np.int32)
    tgt = rng.randint(0, vocab, (batch_size, seq_len)).astype(np.int32)
    conflict = float(np.mean(tgt[:half] != tgt[half:]))
    return inp, tgt, round(conflict * math.log(2.0), 4)


def _worst(grads, ref):
    """(name, rel) of the parameter whose gradient differs most from
    ``ref``'s, relative to the parameter's largest ``ref`` gradient."""
    worst = ("", 0.0)
    for n, want in ref.items():
        rel = ((grads[n] - want).abs().max()
               / want.abs().max().clamp_min(1e-30)).item()
        if not rel <= worst[1]:           # NaN counts as the worst
            worst = (n, rel)
    return worst


def _worst_of_effect(grads, ref, ref_f32):
    """(name, excess, err over effect) of the parameter whose gradient
    differs most from ``ref``'s against the bf16 limit: BF16_K of the
    policy's own effect on it (``max |ref - ref_f32|``) plus one bf16 ulp
    of its largest entry (BF16_ULP of max |ref|). A gradient rounded to
    bf16 (a weight's, through the cast's VJP) lands a whole ulp apart
    where two paths' f32 sums straddle a rounding boundary, while the
    policy's effect on an entry is its rounding, half an ulp: hence the
    second term. An excess of at most 1 passes."""
    worst = ("", 0.0, 0.0)
    for n, want in ref.items():
        err = (grads[n] - want).abs().max().item()
        effect = (want - ref_f32[n]).abs().max().item()
        excess = err / (BF16_K * effect + BF16_ULP * want.abs().max().item()
                        + 1e-30)
        if not excess <= worst[1]:
            worst = (n, excess, err / max(effect, 1e-30))
    return worst


def _param_grads(torch, model, loss_fn, batch, pol, pt):
    model.zero_grad(set_to_none=True)
    with pt.use_policy(pol):
        loss_fn(model(batch["x"], train=True), batch).mean().backward()
    out = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return out


def check_step0_grads(torch, pt, model, cfg, loss_fn, batch, pol):
    """Every parameter's gradient on ``batch`` through the kernels under
    ``pol``. Under float32: against the plain-attention model on the same
    weights, within GRAD_RTOL of the parameter's largest gradient. Under
    bfloat16_compute: against the same model with the flash kernels'
    plain versions (``flash_attention_plain`` under autograd) in their
    place, within BF16_K of the policy's own effect (those plain versions
    under float32 against under the policy) plus one bf16 ulp of the
    parameter's largest gradient (``_worst_of_effect``). The
    plain-attention model is no yardstick there: as in JAX, its softmax
    weights are rounded to bf16 before they meet v, which the flash path
    never does."""
    from paddle_tpu_torch.nn import attention as attn_mod
    from paddle_tpu_torch.nn import cuda_attention as ca
    grads = {"kernel": _param_grads(torch, model, loss_fn, batch, pol, pt)}
    if pol.compute_dtype == torch.float32:
        ref = pt.TransformerLM(**cfg, use_flash=False, device="cuda")
        ref.load_state_dict(model.state_dict())
        grads["plain"] = _param_grads(torch, ref, loss_fn, batch, pol, pt)
        worst = _worst(grads["kernel"], grads["plain"])
        lim = GRAD_RTOL
    else:
        kernel = attn_mod.flash_attention
        attn_mod.flash_attention = \
            lambda q, k, v, seg, causal: ca.flash_attention_plain(
                q, k, v, seg, causal)[0]
        try:
            grads["plain"] = _param_grads(torch, model, loss_fn, batch, pol,
                                          pt)
            grads["plain_f32"] = _param_grads(torch, model, loss_fn, batch,
                                              pt.float32, pt)
        finally:
            attn_mod.flash_attention = kernel
        worst = _worst_of_effect(grads["kernel"], grads["plain"],
                                 grads["plain_f32"])
        lim = 1.0
    if not worst[1] <= lim:
        raise RuntimeError(f"step-0 gradient of {worst[0]}: kernel vs plain "
                           f"attention differ by {worst[1]} (limit {lim})")
    wq = grads["kernel"]["blocks.0.attn.wq"].abs().max().item()
    if not wq > 0:
        raise RuntimeError("blocks.0.attn.wq got no gradient through the "
                           "flash backward")
    out = {"params": len(grads["plain"]), "worst_param": worst[0],
           "wq_grad_max": wq}
    if pol.compute_dtype == torch.float32:
        out["worst_rel_err"] = worst[1]
    else:
        out.update(worst_excess_of_bf16_limit=worst[1],
                   worst_err_over_policy_effect=worst[2])
    return out


def phase_train(torch, np, pt, pol):
    """The prep_transformer configuration trained for 8 steps through the
    flash forward and backward kernels under the dtype policy ``pol``
    (float32, or bfloat16_compute as the JAX benchmark runs it)."""
    from paddle_tpu_torch.nn import cuda_attention as ca
    V, L, B, T, steps = 32000, 6, 8, 2048, 8
    cfg = dict(vocab=V, dim=512, num_layers=L, num_heads=4, ffn_hidden=2048,
               max_len=T)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    model = pt.TransformerLM(**cfg, use_flash=True, device="cuda",
                             generator=gen)
    inp, tgt, loss_floor = conflicting_pairs(np, B, T, V)

    def loss_fn(out, b):
        return pt.softmax_cross_entropy(out.reshape(-1, V),
                                        b["y"].reshape(-1))

    small = {"x": torch.as_tensor(inp[:2], device="cuda"),
             "y": torch.as_tensor(tgt[:2], device="cuda")}
    tag = "" if pol.compute_dtype == torch.float32 else " bf16"
    grad_check = check_step0_grads(torch, pt, model, cfg, loss_fn, small,
                                   pol)
    log(f"train{tag} step-0 gradients", json.dumps(grad_check))

    trainer = pt.Trainer(model, loss_fn, pt.adam(1e-4), device="cuda")
    trainer.init()
    batch = {"x": inp, "y": tgt}
    marks, losses = [], []

    def handler(e):
        if isinstance(e, pt.train.BeginIteration):
            marks.append(time.perf_counter())
        elif isinstance(e, pt.train.EndIteration):
            marks.append(time.perf_counter())
            losses.append(e.cost)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    with pt.use_policy(pol):
        trainer.train(lambda: iter([batch] * steps), event_handler=handler,
                      log_period=0)
    torch.cuda.synchronize()
    counts = ca.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    want = {"flash_fwd": L * steps, "flash_bwd_dq": L * steps,
            "flash_bwd_dkv": L * steps}
    for name, n in want.items():
        if counts[name] != n:
            raise RuntimeError(f"train: {name} launched {counts[name]} "
                               f"times, expected {n} ({L} layers x {steps} "
                               f"steps)")
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        raise RuntimeError(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train: loss did not fall: {losses}")
    # each step ends in float(loss), a device sync: Begin -> EndIteration
    step_ms = [1e3 * (marks[2 * i + 1] - marks[2 * i]) for i in range(steps)]
    steady = step_ms[1:]
    ms = sum(steady) / len(steady)
    stats = {"config": "prep_transformer: vocab 32000, dim 512, 6 layers, "
                       "4 heads, ffn 2048, batch 8 x 2048, adam(1e-4), "
                       + ("f32" if not tag else "bfloat16_compute"),
             "steps": steps, "ms_per_step": ms, "step_ms": step_ms,
             "tokens_per_s": B * T / (ms / 1e3), "losses": losses,
             "loss_floor": loss_floor, "launches": counts,
             "peak_mem_gib": peak / 2 ** 30}
    log(f"train{tag}", json.dumps(stats))
    with pt.use_policy(pol):
        phase_train_profile(torch, trainer, batch, tag)
    return counts


def phase_train_profile(torch, trainer, batch, tag=""):
    """Device busy share and time by kernel over 2 training steps, with
    the flash backward kernels' device time and share."""
    log(f"train{tag} profile", json.dumps(profile_window(
        torch, lambda: trainer.train(lambda: iter([batch] * 2),
                                     log_period=0), "2 training steps",
        kernels=("flash_bwd",))))


LOOP_K, LOOP_W, LOOP_GROUPS = 8, 3, 3
LOOP_CFG = dict(vocab=32000, dim=512, num_layers=6, num_heads=4,
                ffn_hidden=2048, max_len=2048, use_flash=True)
LOOP_BATCH = 8


def _loop_state(trainer):
    """The parameters and Adam's m and v of ``trainer``, cloned on the
    card."""
    ts = trainer.train_state
    out = {f"param {n}": p.detach().clone() for n, p in ts.params.items()}
    for slot in ("m", "v"):
        out.update({f"adam {slot} {n}": t.clone()
                    for n, t in getattr(ts.opt_state, slot).items()})
    return out


def _not_bit_equal(torch, want, trainer):
    got = _loop_state(trainer)
    return [k for k in want if not torch.equal(want[k], got[k])]


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def phase_train_loop(torch, np, pt, card):
    """Phase 12: the ``Trainer``'s grouped loop, host pipeline,
    checkpoints, preemption and resume, and gradient accumulation at the
    ``prep_transformer`` width under ``bfloat16_compute``. Returns the
    launch counts of (a), the main path."""
    import shutil
    import tempfile
    from paddle_tpu_torch.nn import cuda_attention as ca
    from paddle_tpu_torch.train import checkpoint as ckpt
    cfg = LOOP_CFG
    V, L, B, T = cfg["vocab"], cfg["num_layers"], LOOP_BATCH, cfg["max_len"]
    K, W, steps = LOOP_K, LOOP_W, LOOP_K * LOOP_GROUPS
    pol = pt.bfloat16_compute
    gen = torch.Generator(device="cuda").manual_seed(4321)
    start = {k: v.clone() for k, v in pt.TransformerLM(
        **cfg, device="cuda", generator=gen).state_dict().items()}
    inp, tgt, loss_floor = conflicting_pairs(np, B, T, V)
    batches = [{"x": np.roll(inp, i, axis=1), "y": np.roll(tgt, i, axis=1)}
               for i in range(3)]

    def reader():
        return iter([batches[i % 3] for i in range(steps)])

    def loss_fn(out, b):
        return pt.softmax_cross_entropy(out.reshape(-1, V),
                                        b["y"].reshape(-1))

    def make(opt=None, **kw):
        model = pt.TransformerLM(**cfg, device="cuda")
        model.load_state_dict(start)
        tr = pt.Trainer(model, loss_fn, opt or pt.adam(1e-4),
                        device="cuda", **kw)
        tr.init()
        return tr

    def run(tr, rd=reader, policy=pol, **kw):
        losses = []

        def handler(e):
            if isinstance(e, pt.train.EndIteration):
                losses.append(e.cost)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with pt.use_policy(policy):
            tr.train(rd, event_handler=handler, log_period=0, **kw)
        torch.cuda.synchronize()
        return losses, time.perf_counter() - t0

    root = Path(__file__).resolve().parent
    stats = {"config": "prep_transformer: vocab 32000, dim 512, 6 layers, "
                       "4 heads, ffn 2048, batch 8 x 2048 (3 batches in "
                       "turn), adam(1e-4), bfloat16_compute",
             "steps": steps, "card": card}

    # (a) the main path: K steps a call, W calls in flight
    tr = make(steps_per_call=K, pipeline_depth=W)
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    losses, sec = run(tr)
    counts = ca.launch_counts()
    stats["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if counts[name] != L * steps:
            raise RuntimeError(f"train loop: {name} launched {counts[name]} "
                               f"times, expected {L} x {steps}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise RuntimeError(f"train loop: losses {losses}")
    want = _loop_state(tr)
    stats.update(pipelined_ms_per_step=1e3 * sec / steps,
                 pipelined_fetches=tr.host_fetches, losses=losses,
                 loss_floor=loss_floor, launches=counts)

    # (e) saves of this state, timed: synchronous, then asynchronous
    d = tempfile.mkdtemp(prefix=".train_loop_ckpt_", dir=root)
    try:
        t0 = time.perf_counter()
        tr.save(d, 0)
        stats["sync_save_s"] = time.perf_counter() - t0
        stats["checkpoint_bytes"] = _dir_bytes(Path(d) / "pass-00000")
        saver = ckpt.AsyncCheckpointer()
        t0 = time.perf_counter()
        saver.save(d, 1, pt.checkpoint_tree(tr.train_state,
                                            pt.jax_root(tr.model)))
        stats["async_save_path_s"] = time.perf_counter() - t0
        saver.close()
        stats["async_save_write_s"] = saver.records[-1]["write_ms"] / 1e3
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del tr
    torch.cuda.empty_cache()

    # (b) serial: one call at a time, then one step a call
    for label, kw in (("serial_k8", dict(steps_per_call=K)),
                      ("serial_k1", {})):
        tr = make(**kw)
        losses_b, sec = run(tr)
        bad = _not_bit_equal(torch, want, tr)
        if bad or losses_b != losses:
            raise RuntimeError(f"train loop: {label} differs from the "
                               f"pipelined run: {bad[:8]} (losses "
                               f"{losses_b} against {losses})")
        stats[f"{label}_ms_per_step"] = 1e3 * sec / steps
        stats[f"{label}_fetches"] = tr.host_fetches
        del tr
    if stats["pipelined_fetches"] != LOOP_GROUPS or \
            stats["serial_k1_fetches"] != steps:
        raise RuntimeError(f"train loop: fetches {stats}")
    # (a) again, timed after the serial runs: the first run of a
    # configuration pays for first-use allocations
    tr = make(steps_per_call=K, pipeline_depth=W)
    losses_a, sec = run(tr)
    bad = _not_bit_equal(torch, want, tr)
    if bad or losses_a != losses:
        raise RuntimeError(f"train loop: the pipelined rerun differs: "
                           f"{bad[:8]}")
    stats["pipelined_again_ms_per_step"] = 1e3 * sec / steps
    del tr

    # (c) preempted at step 12 and resumed, sync and async saves. The
    # preempted run goes one call at a time, so the stop lands on the
    # next group boundary, batch 16; with W calls in flight the request
    # is seen while a later group drains and the stop lands later (as in
    # JAX). The resumed run is the pipelined loop.
    for async_ in (False, True):
        d = tempfile.mkdtemp(prefix=".train_loop_ckpt_", dir=root)
        try:
            tr = make(steps_per_call=K,
                      faults=pt.FaultSchedule(preempt_at_step=12))
            try:
                run(tr, checkpoint_dir=d, saving_period=8,
                    checkpoint_async=async_)
            except pt.Preempted as p:
                where = p.next_batch
            else:
                raise RuntimeError("train loop: no preemption at step 12")
            if where != 2 * K:
                raise RuntimeError(f"train loop: the stop landed at batch "
                                   f"{where}, not {2 * K}")
            del tr
            tr = make(steps_per_call=K, pipeline_depth=W)
            run(tr, checkpoint_dir=d, saving_period=8,
                checkpoint_async=async_, resume=True)
            bad = _not_bit_equal(torch, want, tr)
            if bad or tr.train_state.step != steps:
                raise RuntimeError(f"train loop: preempted at batch {where} "
                                   f"and resumed (async {async_}), differs "
                                   f"from (a): {bad[:8]}, step "
                                   f"{tr.train_state.step}")
            stats[f"preempted_at_batch{'_async' if async_ else ''}"] = where
            del tr
        finally:
            shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()

    # (d) grad_accum=2 over the halves against one step on the batch
    grads = {}

    def capture(key):
        def init(params):
            return ()

        def update(g, state, params, step):
            grads[key] = {n: x.detach().clone() for n, x in g.items()}
            return {n: torch.zeros_like(x) for n, x in g.items()}, state
        return pt.optim.Optimizer(init, update)

    halves = [{"x": inp[:B // 2], "y": tgt[:B // 2]},
              {"x": inp[B // 2:], "y": tgt[B // 2:]}]
    ca.reset_launch_counts()
    run(make(opt=capture("accum"), grad_accum=2), rd=lambda: iter(halves))
    accum_counts = ca.launch_counts()
    run(make(opt=capture("whole")), rd=lambda: iter([batches[0]]))
    run(make(opt=capture("whole_f32")), rd=lambda: iter([batches[0]]),
        policy=pt.float32)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if accum_counts[name] != 2 * L:
            raise RuntimeError(f"train loop: grad_accum=2 launched {name} "
                               f"{accum_counts[name]} times, expected 2 x {L}")
    worst = _worst_of_effect(grads["accum"], grads["whole"],
                             grads["whole_f32"])
    if not worst[1] <= 1.0:
        raise RuntimeError(f"train loop: grad_accum=2 gradient of {worst[0]} "
                           f"at {worst[1]} of the bf16 limit")
    stats.update(accum_worst_param=worst[0],
                 accum_worst_excess_of_bf16_limit=worst[1],
                 accum_worst_err_over_policy_effect=worst[2],
                 accum_launches=accum_counts)
    log("train loop", json.dumps(stats))
    return counts


MOE_CFG = dict(vocab=32000, dim=512, num_layers=6, num_heads=4,
               ffn_hidden=2048, max_len=2048, use_flash=True, moe_experts=8)
MOE_BATCH, MOE_K, MOE_W, MOE_STEPS = 8, 4, 2, 8
# remat gradients against the plain step's, of each gradient's largest
# |entry| (JAX's own remat test bound)
REMAT_TOL = 1e-5
# costs and activations on the card against the same call on CPU copies,
# of max(1, max |cpu|)
CARD_CPU_TOL = 1e-5


def moe_capacity():
    """C of a training batch: ceil(N K / E x 1.25), N = B T, K = 1."""
    return math.ceil(MOE_BATCH * MOE_CFG["max_len"] / MOE_CFG["moe_experts"]
                     * 1.25)


def moe_evaluator(pt):
    """``EvaluatorSet(ClassificationError)`` over the logits of the
    ``(logits, aux)`` a MoE forward returns, recording each update's
    counts (so the pass's result can be held against their aggregate)."""
    from paddle_tpu_torch.train.evaluators import ClassificationError

    class LogitsError(ClassificationError):
        def __init__(self):
            super().__init__()
            self.seen = []

        def batch_stats(self, outputs, batch):
            return super().batch_stats(outputs[0], batch)

        def reset(self):
            super().reset()
            self.seen = []

        def update(self, stats):
            self.seen.append((int(stats["wrong"]), int(stats["total"])))
            super().update(stats)

    ev = LogitsError()
    return pt.EvaluatorSet(ev), ev


def moe_routing(torch, model, ids):
    """Each MoE layer's routing stats on ``ids`` (no gradient)."""
    rows = []

    def hook(mod, args, out):
        _, st = mod.forward(args[0], return_stats=True)
        rows.append({"drop_rate": st["drop_rate"].item(),
                     "expert_fraction": [round(f, 5) for f in
                                         st["expert_fraction"].tolist()],
                     "capacity": int(st["capacity"])})

    from paddle_tpu_torch.nn.moe import MoEFFN
    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, MoEFFN)]
    try:
        with torch.no_grad():
            model(ids)
    finally:
        for h in handles:
            h.remove()
    return rows


def phase_moe_train(torch, np, pt, ca, card, start, batch):
    """Phase 13 (a): the MoE TransformerLM trained through the Trainer's
    grouped, pipelined loop with an evaluator."""
    cfg = MOE_CFG
    V, L, E = cfg["vocab"], cfg["num_layers"], cfg["moe_experts"]
    steps = MOE_STEPS

    def forward(model, b, train):
        return model(b["x"], train=train, return_aux=True)

    def loss_fn(out, b):
        logits, aux = out
        ce = pt.softmax_cross_entropy(logits.reshape(-1, V),
                                      b["y"].reshape(-1))
        return ce + 0.01 * aux               # mean CE + 0.01 aux

    def run(evaluator):
        model = pt.TransformerLM(**cfg, device="cuda")
        model.load_state_dict(start)
        tr = pt.Trainer(model, loss_fn, pt.adam(1e-4), forward=forward,
                        evaluator=evaluator, steps_per_call=MOE_K,
                        pipeline_depth=MOE_W, device="cuda")
        tr.init()
        events = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        with pt.use_policy(pt.bfloat16_compute):
            tr.train(lambda: iter([batch] * steps),
                     event_handler=events.append, log_period=0)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        return tr, events, sec, ca.launch_counts(), \
            torch.cuda.max_memory_allocated()

    # the same run without the evaluator first (it also takes the first
    # use's costs off the timed run): the same losses and loss fetches
    # are wanted of the run with it (its stats leave the card in the
    # losses' copies)
    tr0, events0, sec0, _, peak0 = run(None)
    losses0 = [e.cost for e in events0
               if isinstance(e, pt.train.EndIteration)]
    fetches0 = tr0.host_fetches
    del tr0, events0
    gc.collect()                       # the peak below is the run's own
    torch.cuda.empty_cache()
    evaluator, ev = moe_evaluator(pt)
    tr, events, sec, counts, peak = run(evaluator)
    steps_m = [e for e in events if isinstance(e, pt.train.EndIteration)]
    passes = [e for e in events if isinstance(e, pt.train.EndPass)]
    losses = [e.cost for e in steps_m]
    if len(losses) != steps or not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise RuntimeError(f"moe train: losses {losses}")
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        if counts[name] != L * steps:
            raise RuntimeError(f"moe train: {name} launched {counts[name]} "
                               f"times, expected {L} x {steps}")
    for e in steps_m:
        m = e.metrics
        if abs(m["classification_error"] + m["accuracy"] - 1) > 1e-12:
            raise RuntimeError(f"moe train: step metrics {m}")
    wrong = sum(w for w, _ in ev.seen)
    total = sum(t for _, t in ev.seen)
    pm = passes[0].metrics
    if len(ev.seen) != steps or total != steps * batch["y"].size \
            or pm["classification_error"] != wrong / total \
            or pm["classification_error"] != \
            steps_m[-1].metrics["classification_error"]:
        raise RuntimeError(f"moe train: pass metrics {pm} against the "
                           f"steps' {wrong} / {total} ({len(ev.seen)} "
                           f"updates)")
    fetches = tr.host_fetches
    routing = moe_routing(torch, tr.model, torch.as_tensor(
        batch["x"], device="cuda"))
    if any(r["capacity"] != moe_capacity() for r in routing):
        raise RuntimeError(f"moe train: capacities {routing}")
    profile = profile_window(torch, lambda: tr.train(
        lambda: iter([batch] * MOE_K), log_period=0),
        f"{MOE_K} MoE training steps (one call)",
        kernels=("flash_fwd", "flash_bwd", "gemm", "Gemm"))
    del tr
    torch.cuda.empty_cache()
    if fetches0 != fetches or losses0 != losses:
        raise RuntimeError(f"moe train: without the evaluator fetches "
                           f"{fetches0} (with: {fetches}), losses "
                           f"{losses0} against {losses}")
    stats = {"config": "prep_transformer with moe_experts=8 (E 8, top-1, "
                       "capacity factor 1.25), batch 8 x 2048, adam(1e-4), "
                       "bfloat16_compute, loss mean CE + 0.01 aux, "
                       f"steps_per_call={MOE_K}, pipeline_depth={MOE_W}",
             "card": card, "steps": steps, "losses": losses,
             "ms_per_step": 1e3 * sec / steps,
             "ms_per_step_without_evaluator_first": 1e3 * sec0 / steps,
             "tokens_per_s": steps * batch["y"].size / sec,
             "peak_mem_gib": peak / 2 ** 30,
             "peak_mem_gib_without_evaluator_first": peak0 / 2 ** 30,
             "launches": counts,
             "host_fetches": fetches, "pass_metrics": pm,
             "step_metrics": [e.metrics for e in steps_m],
             "routing_after": routing, "profile": profile}
    log("moe train", json.dumps(stats))
    return counts


def phase_moe_remat(torch, pt, ca, card, start, batch):
    """Phase 13 (b): one forward and backward from the same weights at
    remat None, "dots" and "full": losses and gradients against the plain
    step, the flash launches the recompute implies, and each peak."""
    cfg = MOE_CFG
    V, L = cfg["vocab"], cfg["num_layers"]
    x = torch.as_tensor(batch["x"], device="cuda")
    y = torch.as_tensor(batch["y"], device="cuda").reshape(-1)
    out, paths = {}, {}
    ref = None
    for remat in (None, "dots", "full"):
        model = pt.TransformerLM(**cfg, remat=remat, device="cuda")
        model.load_state_dict(start)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        with pt.use_policy(pt.bfloat16_compute):
            logits, aux = model(x, train=True, return_aux=True)
            loss = pt.softmax_cross_entropy(logits.reshape(-1, V), y).mean() \
                + 0.01 * aux
            del logits
            loss.backward()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = ca.launch_counts()
        paths[str(remat)] = counts
        grads = {n: p.grad for n, p in model.named_parameters()}
        row = {"loss": loss.item(), "ms": 1e3 * sec,
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "peak_above_weights_gib":
                   (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
               "launches": {k: v for k, v in counts.items() if v}}
        want_fwd = 2 * L if remat == "full" else L
        if counts["flash_fwd"] != want_fwd or counts["flash_bwd_dq"] != L \
                or counts["flash_bwd_dkv"] != L:
            raise RuntimeError(f"moe remat {remat}: launches {counts}")
        if ref is None:
            ref = (loss.item(), grads)
        else:
            worst, bit_equal = ("", 0.0), loss.item() == ref[0]
            for n, want in ref[1].items():
                rel = ((grads[n] - want).abs().max()
                       / want.abs().max().clamp_min(1e-30)).item()
                bit_equal = bit_equal and torch.equal(grads[n], want)
                if not rel <= worst[1]:
                    worst = (n, rel)
            row.update(worst_param=worst[0], worst_rel_err=worst[1],
                       bit_equal=bit_equal,
                       loss_diff=abs(loss.item() - ref[0]))
            if not worst[1] <= REMAT_TOL or \
                    not abs(loss.item() - ref[0]) <= REMAT_TOL * abs(ref[0]):
                raise RuntimeError(f"moe remat {remat}: {row}")
            del grads
        out[str(remat)] = row
        del model, loss
    if not out["full"]["peak_gib"] < out["None"]["peak_gib"]:
        raise RuntimeError(f"moe remat: full's peak is not below the plain "
                           f"one: {out}")
    log("moe remat", json.dumps({"card": card, "runs": out}))
    del ref
    torch.cuda.empty_cache()
    total = {}
    for c in paths.values():
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def card_cpu_cases(torch, np):
    """(name, fn, float args, other args) for every activation and cost
    of the port, with inputs on the host."""
    from paddle_tpu_torch.nn import activations as A
    from paddle_tpu_torch.nn import costs as C
    r = np.random.RandomState(13)

    def f(*shape, scale=1.0, pos=False):
        a = r.rand(*shape) * 3 + 0.2 if pos else r.randn(*shape) * scale
        return torch.from_numpy(a.astype(np.float32))

    def i(hi, *shape):
        return torch.from_numpy(r.randint(0, hi, shape).astype(np.int64))

    B, N = 64, 32
    cases = [(f"act {n}", fn, [f(B, N, pos=n in ("log", "sqrt",
                                                  "reciprocal"),
                                 scale=20.0 if n == "brelu" else 3.0)], {})
             for n, fn in sorted(A.ACTIVATIONS.items())]
    cases.append(("act sequence_softmax", A.sequence_softmax, [f(B, N)],
                  {"lengths": i(N + 1, B)}))
    p = torch.softmax(f(B, N), -1)
    codes, signs = C.build_hsigmoid_codes(i(100, B), 100)
    gold = i(N, B)
    gold[::5] = -1
    cases += [
        ("cost cross_entropy_with_probs", C.cross_entropy_with_probs,
         [f(B, N, scale=2.0)], {"target_probs": p}),
        ("cost soft_binary_ce", C.soft_binary_ce, [f(B, N, pos=True) / 4],
         {"targets": f(B, N, pos=True) / 4}),
        ("cost binary_logistic", C.binary_logistic, [f(B, scale=4.0)],
         {"labels": i(2, B)}),
        ("cost multi_binary_ce", C.multi_binary_ce, [f(B, N, scale=3.0)],
         {"targets": i(2, B, N).float()}),
        ("cost mse", C.mse, [f(B, N), f(B, N)], {"weight": f(B, pos=True)}),
        ("cost smooth_l1_elementwise", C.smooth_l1_elementwise,
         [f(B, N, scale=2.0), f(B, N)], {"delta": 0.7}),
        ("cost smooth_l1", C.smooth_l1, [f(B, N, scale=2.0), f(B, N)], {}),
        ("cost huber_regression", C.huber_regression,
         [f(B, N, scale=2.0), f(B, N)], {}),
        ("cost huber_classification", C.huber_classification,
         [f(B, 1, scale=2.0)], {"label01": i(2, B).float()}),
        ("cost hinge", C.hinge, [f(B, 1, scale=2.0)],
         {"label01": i(2, B).float()}),
        ("cost rank_cost", C.rank_cost, [f(B, 1), f(B, 1)],
         {"label": f(B, pos=True) / 4}),
        ("cost lambda_rank_ndcg", C.lambda_rank_ndcg, [f(8, N)],
         {"relevance": i(4, 8, N).float(), "lengths": i(N + 1, 8)}),
        ("cost sum_cost", C.sum_cost, [f(B, N)], {}),
        ("cost nce_loss", C.nce_loss, [f(B, 16), f(100, 16), f(100)],
         {"labels": i(100, B), "noise_ids": i(100, B, 8),
          "noise_logprob": torch.log(f(100, pos=True))}),
        ("cost hsigmoid_loss", C.hsigmoid_loss, [f(B, 16), f(100, 16),
                                                 f(100)],
         {"labels": i(100, B), "codes": codes, "signs": signs}),
        ("cost cross_entropy_over_beam", C.cross_entropy_over_beam,
         [f(B, N, scale=2.0), f(B)], {"gold_idx": gold}),
    ]
    return cases


# the float inputs' keyword names of the costs that take them by keyword
CARD_CPU_KW = {"nce_loss": ("hidden", "table_w", "table_b"),
               "hsigmoid_loss": ("hidden", "node_w", "node_b"),
               "cross_entropy_over_beam": ("path_scores", "gold_score")}


def phase_costs_activations(torch, np, card):
    """Phase 13 (d): every activation and cost on CUDA tensors against the
    same call on CPU copies, values and gradients."""
    rows, worst = {}, 0.0
    for name, fn, floats, other in card_cpu_cases(torch, np):
        res = {}
        for dev in ("cpu", "cuda"):
            xs = [t.detach().to(dev).requires_grad_(True) for t in floats]
            kw = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
                  for k, v in other.items()}
            short = name.split()[-1]
            if short in CARD_CPU_KW:
                kw.update(zip(CARD_CPU_KW[short], xs))
                y = fn(**kw)
            else:
                y = fn(*xs, **kw)
            g = torch.linspace(-1, 1, y.numel(), device=dev).reshape(y.shape)
            (y * g).sum().backward()
            res[dev] = [y.detach().cpu()] + [x.grad.cpu() for x in xs]
        errs = []
        for got, want in zip(res["cuda"], res["cpu"]):
            lim = CARD_CPU_TOL * max(1.0, want.abs().max().item())
            err = (got - want).abs().max().item()
            errs.append(err / lim)
            if not err <= lim:
                raise RuntimeError(f"{name}: card against CPU {err} "
                                   f"(limit {lim})")
        rows[name] = max(errs)
        worst = max(worst, max(errs))
    log("costs and activations", json.dumps(
        {"card": card, "functions": len(rows),
         "worst_share_of_limit": worst, "share_of_limit": rows}))


def serving_summary(row):
    """A graph serving row's run and steady tick numbers."""
    g, s = row["graph"], row["steady_graph"]
    return {"run_ms_per_tick": g["ms_per_tick"],
            "run_tokens_per_s": g["decode_tokens_per_s"],
            "ttft_p50_ms": g["ttft_p50_ms"],
            "steady_ms_per_tick": s["ms_per_tick"],
            "steady_busy_ms_per_tick": s["device_busy_ms_per_tick"]}


def phase_moe(torch, np, pt, ca, card):
    """Phase 13: the MoE LM, remat and evaluators. Returns the launch
    counts of (a), (b) and (c)."""
    cfg = MOE_CFG
    V, T = cfg["vocab"], cfg["max_len"]
    gen = torch.Generator(device="cuda").manual_seed(2020)
    start = {k: v.clone() for k, v in pt.TransformerLM(
        **cfg, device="cuda", generator=gen).state_dict().items()}
    inp, tgt, loss_floor = conflicting_pairs(np, MOE_BATCH, T, V)
    # the targets are the next-token labels the evaluator scores
    batch = {"x": inp, "y": tgt, "label": tgt}
    log(f"moe: C = {moe_capacity()} slots an expert, loss floor "
        f"{loss_floor}")
    train_counts = phase_moe_train(torch, np, pt, ca, card, start, batch)
    remat_counts = phase_moe_remat(torch, pt, ca, card, start, batch)
    del start
    torch.cuda.empty_cache()
    # (c) serving the MoE model through the CUDA graphs
    scfg = dict(vocab=32000, dim=512, num_layers=6, num_heads=8,
                ffn_hidden=2048, max_len=1024, use_flash=True,
                moe_experts=8)
    rng = np.random.RandomState(0)
    lens = rng.randint(16, 513, size=16)
    prompts = [[int(t) for t in rng.randint(0, V, n)] for n in lens]
    shared = [int(t) for t in rng.randint(0, V, 64)]
    for i in (2, 3):                   # as phase 3's requests
        prompts[i] = shared + prompts[i][:max(16, len(prompts[i]) - 64)]
    rows = []
    model = pt.TransformerLM(**scfg, device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(1234))
    serve_counts = phase_graph_serving(
        torch, np, pt, ca, model, prompts, card,
        [GRAPH_MODES[0], GRAPH_MODES[3]], " moe", rows)
    del model
    torch.cuda.empty_cache()
    phase_costs_activations(torch, np, card)
    return {"moe training bf16": train_counts, "moe remat bf16": remat_counts,
            "moe graph serving": serve_counts}, rows


def resnet50_dw_shapes(batch, image):
    """``{(M, Cin, Cout): launches}`` of conv1x1_dw in one ResNet-50 step
    (7x7/2 stem and 3x3/2 max pool with SAME padding, then each
    bottleneck's c1 and c3 and its strided or widening shortcut)."""
    h = -(-(-(-image // 2)) // 2)
    shapes, cin = {}, 64

    def add(key):
        shapes[key] = shapes.get(key, 0) + 1

    for si, (f, n) in enumerate(zip([64, 128, 256, 512], [3, 4, 6, 3])):
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            add((batch * h * h, cin, f))                   # c1
            h = -(-h // stride)                            # c2 strides
            add((batch * h * h, f, 4 * f))                 # c3
            if stride != 1 or cin != 4 * f:
                add((batch * h * h, cin, 4 * f))           # shortcut
            cin = 4 * f
    return shapes


# the 15 distinct (M, Cin, Cout) of the 36 launches of a step at batch
# 128, 224 x 224, with their launches per step
RESNET50_DW = resnet50_dw_shapes(128, 224)
DW_CHECKED = [(401408, 64, 64), (401408, 64, 256), (100352, 256, 512),
              (25088, 1024, 256), (6272, 512, 2048)]


def dw_bytes_flops(M, cin, cout):
    return 4 * (M * cin + M * cout + cin * cout), 2 * M * cin * cout


def phase_conv_kernels(torch, cc, gen):
    """conv1x1_dw against its plain version at five shapes of the
    ResNet-50 step, within TOL of max |plain|, bit-equal over two runs;
    then the kernel, plain version and library call (``torch.mm(x.t(),
    dy)``, cuBLAS, TF32 off — the same call as the plain version) timed
    at every distinct shape of the step, with the kernel's TFLOP/s and
    its share of the split-TF32 bound and of the f32 CUDA-core bound, and
    summed over the step's 36 launches beside the summed bounds."""
    from paddle_tpu_torch.nn.gemm_f32 import TILES
    if sum(RESNET50_DW.values()) != 36 or len(RESNET50_DW) != 15:
        raise RuntimeError(f"RESNET50_DW lists {RESNET50_DW}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows, err = {}, 0.0
    step = {"kernel_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0, "cuda_core_bound_ms": 0.0, "bytes": 0,
            "flops": 0}
    for shape, n in RESNET50_DW.items():
        M, cin, cout = shape
        x = torch.randn(M, cin, generator=gen, device="cuda")
        dy = torch.randn(M, cout, generator=gen, device="cuda")
        row = {"shape": list(shape), "launches_per_step": n}
        if shape in DW_CHECKED:
            got = cc.conv1x1_dw(x, dy)
            want = cc.conv1x1_dw_plain(x, dy)
            again = cc.conv1x1_dw(x, dy)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            lim = TOL * want.abs().max().item()
            if not e <= lim:
                raise RuntimeError(f"conv1x1_dw {shape}: max |kernel - "
                                   f"plain| = {e} > {lim}")
            if not torch.equal(got, again):
                raise RuntimeError(f"conv1x1_dw {shape}: two runs differ")
            row["max_abs_err"], row["max_plain"] = e, lim / TOL
            err = max(err, e)
            del got, want, again
        nbytes, flops = dw_bytes_flops(M, cin, cout)
        tile, splits = cc._plan(M, cin, cout, sms)
        row.update(kernel_ms=time_ms(torch, lambda: cc.conv1x1_dw(x, dy)),
                   plain_ms=time_ms(torch,
                                    lambda: cc.conv1x1_dw_plain(x, dy)),
                   library_ms=time_ms(torch, lambda: torch.mm(x.t(), dy)),
                   tile=list(TILES[tile][:2]), splits=splits)
        gemm_rates(row, nbytes, flops)
        for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                  "cuda_core_bound_ms"):
            step[k] += n * row[k]
        step["bytes"] += n * nbytes
        step["flops"] += n * flops
        rows[shape] = row
        log("conv1x1_dw", json.dumps(row))
        del x, dy
    t_b = step["bytes"] / HBM_BYTES_PER_S * 1e3
    step.update(
        max_abs_err=err, launches=36,
        bound_by="operations" if 3 * step["flops"] / TF32_FLOPS_PER_S * 1e3
        >= t_b else "bytes",
        cuda_core_bound_by="operations" if step["flops"] / F32_FLOPS_PER_S
        * 1e3 >= t_b else "bytes",
        tflops=step["flops"] / step["kernel_ms"] / 1e9,
        share_of_bound=step["bound_ms"] / step["kernel_ms"],
        share_of_cuda_core_bound=step["cuda_core_bound_ms"]
        / step["kernel_ms"],
        bound_note="sums of the 36 launches' own bounds")
    log("conv1x1_dw step (36 launches)", json.dumps(step))
    return step


def phase_ln_kernels(torch, F, fl, gen):
    """fused_ln_matmul's kernel at the transformer width, with and without
    scale and bias: the entry point's launches (its only caller), then
    each against the plain version within TOL of max |plain|, timed beside
    it and beside ``F.layer_norm(...) @ w``, with its TFLOP/s and its share
    of the split-TF32 bound and of the f32 CUDA-core bound."""
    from paddle_tpu_torch.nn.gemm_f32 import TILES
    M, K = 16384, 512
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = torch.randn(M, K, generator=gen, device="cuda") * 2 + 0.5
    sc = 1 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    bi = 0.1 * torch.randn(K, generator=gen, device="cuda")
    cases = [(N, aff) for N in (512, 2048) for aff in (False, True)]
    ws = {N: torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5
          for N in (512, 2048)}
    torch.cuda.synchronize()
    fl.reset_launch_counts()
    outs = [fl.fused_ln_matmul(x, ws[N], *((sc, bi) if aff else ()))
            for N, aff in cases]
    torch.cuda.synchronize()
    counts = fl.launch_counts()
    rows = {}
    for (N, aff), got in zip(cases, outs):
        w = ws[N]
        s, b = (sc, bi) if aff else (None, None)
        want = fl.ln_matmul_reference(x, w, s, b)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        lim = TOL * want.abs().max().item()
        if not e <= lim:
            raise RuntimeError(f"ln_matmul [{M},{K}]x[{K},{N}]: max |kernel "
                               f"- plain| = {e} > {lim}")
        row = {"case": f"x [{M},{K}] w [{K},{N}]"
                       + (" scale+bias" if aff else ""),
               "max_abs_err": e, "max_plain": lim / TOL,
               "kernel_ms": time_ms(torch, lambda: fl.fused_ln_matmul(
                   x, w, s, b)),
               "plain_ms": time_ms(torch, lambda: fl.ln_matmul_reference(
                   x, w, s, b)),
               "library_ms": time_ms(torch, lambda: F.layer_norm(
                   x, (K,), s, b, 1e-6) @ w),
               "tile": list(TILES[fl._plan(M, N, sms)][:2])}
        gemm_rates(row, 4 * (M * K + K * N + M * N + 2 * K), 2 * M * K * N)
        log("ln_matmul", json.dumps(row))
        rows[N, aff] = row
    return rows, counts


def conflicting_images(np, batch_size, image, classes):
    """The ``prep_resnet50`` batch (``bench.py:155-170``): each image twice
    with two different labels, a loss floor of ln 2."""
    rng = np.random.RandomState(0)
    half = batch_size // 2
    x_u = rng.normal(size=(half, image, image, 3)).astype(np.float32)
    la = rng.randint(0, classes, size=half).astype(np.int32)
    lb = ((la + 1 + rng.randint(0, classes - 1, size=half))
          % classes).astype(np.int32)
    return {"x": np.concatenate([x_u, x_u], axis=0),
            "label": np.concatenate([la, lb])}


def resnet_step0_grads(torch, pt, cc, model, loss_fn, batch):
    """Step-0 gradients of every parameter from the same weights and BN
    state (restored after each pass), cuDNN deterministic.

    Gates (GRAD_RTOL of each parameter's largest gradient):
    - "pallas" against "conv" (cuDNN) over every parameter;
    - "pallas" against "matmul": both run the same forward and input-
      gradient products and differ only in who computes the 36 weight
      gradients (the kernel, or cuBLAS through autograd), so this holds
      the kernel on the path's own tensors, and every other gradient is
      bit-equal;
    - each of the 36 kernel launches of the "pallas" pass against
      cuDNN's weight gradient (``conv2d_weight``) of the same 1x1
      convolution on the same x and dy, with the shapes of those
      launches those of the kernel phase."""
    state = {n: b.clone() for n, b in model.named_buffers()}
    kernel_dw, dw_errs, seen = cc.conv1x1_dw, [], {}

    def checked_dw(x2d, dy2d):
        got = kernel_dw(x2d, dy2d)
        (M, cin), cout = x2d.shape, dy2d.shape[1]
        seen[M, cin, cout] = seen.get((M, cin, cout), 0) + 1
        want = torch.nn.grad.conv2d_weight(
            x2d.view(M, cin, 1, 1), (cout, cin, 1, 1),
            dy2d.view(M, cout, 1, 1))[:, :, 0, 0].T
        dw_errs.append(((got - want).abs().max()
                        / want.abs().max().clamp_min(1e-30)).item())
        return got

    def grads(impl, x):
        pt.set_conv1x1_impl(impl)
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(state[n])
        model.zero_grad(set_to_none=True)
        loss_fn(model(x, train=True), batch).mean().backward()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cc.conv1x1_dw = checked_dw
    try:
        g = {"pallas": grads("pallas", batch["x"])}
    finally:
        cc.conv1x1_dw = kernel_dw
    try:
        g["matmul"] = grads("matmul", batch["x"])
        g["conv"] = grads("conv", batch["x"])
    finally:
        torch.backends.cudnn.deterministic = det
        pt.set_conv1x1_impl("pallas")
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(state[n])
    for ref in ("conv", "matmul"):
        worst = _worst(g["pallas"], g[ref])
        if not worst[1] <= GRAD_RTOL:
            raise RuntimeError(f"step-0 gradient of {worst[0]}: pallas vs "
                               f"{ref} differ by {worst[1]} of its max")
    if seen != RESNET50_DW:
        raise RuntimeError(f"conv1x1_dw shapes of the step {seen} are not "
                           f"the kernel phase's {RESNET50_DW}")
    if len(dw_errs) != 36 or not max(dw_errs) <= GRAD_RTOL:
        raise RuntimeError(f"conv1x1_dw vs cuDNN's weight gradient on the "
                           f"path's tensors: {len(dw_errs)} launches, "
                           f"worst {max(dw_errs, default=None)}")
    others = [n for n, _ in model.named_parameters()
              if not (n.endswith("conv.w")
                      and getattr(model.get_submodule(n[:-2]), "kernel")
                      == (1, 1))]
    same = all(torch.equal(g["pallas"][n], g["matmul"][n]) for n in others)
    return {"params": len(g["conv"]),
            "pallas_vs_matmul_worst": list(_worst(g["pallas"],
                                                  g["matmul"])),
            "non_1x1_grads_bit_equal_pallas_matmul": same,
            "kernel_vs_cudnn_dw_worst": max(dw_errs),
            "pallas_vs_conv_worst": list(_worst(g["pallas"], g["conv"])),
            "matmul_vs_conv_worst": list(_worst(g["matmul"], g["conv"]))}


def timed_steps(torch, pt, trainer, batch, steps):
    """``steps`` training steps; returns (ms per step, losses)."""
    marks, losses = [], []

    def handler(e):
        if isinstance(e, (pt.train.BeginIteration, pt.train.EndIteration)):
            marks.append(time.perf_counter())
        if isinstance(e, pt.train.EndIteration):
            losses.append(e.cost)

    trainer.train(lambda: iter([batch] * steps), event_handler=handler,
                  log_period=0)
    torch.cuda.synchronize()
    # each step ends in float(loss), a device sync: Begin -> EndIteration
    return [1e3 * (marks[2 * i + 1] - marks[2 * i])
            for i in range(steps)], losses


# ResNet-50 loss curves: 8 steps are compared step by step across the
# lowerings; lr 0.1 from random weights without warm-up makes the loss
# fall for two steps and climb back past its start before it comes down,
# so the loss-falls gate reads the "pallas" curve after 32 steps
RESNET_STEPS, RESNET_FALL_STEPS = 8, 32
# the curve gate: CURVE_K times the gap between two sound curves, plus
# LOSS_RTOL of the loss for the f32 rounding of the loss itself (about 10
# ulps). From the same start this network carries a rounding-sized
# difference in the weights to 1e-3 of the loss in two steps and to
# 1e-2-1e-1 by step 8, where the curves' distances are of one size and
# any of them may be the largest: hence the factor
CURVE_K, LOSS_RTOL = 4.0, 1e-6
# the negative control: a weight gradient 1% too large must fail the
# curve gate
WRONG_DW = 1.01


def curve_excess(p, m, *cs):
    """The largest, over the first RESNET_STEPS steps, of ``|p - m|``
    over its limit: CURVE_K times the running largest ``|c - m|`` over
    the yardstick curves ``cs`` plus LOSS_RTOL of ``m``. At most 1
    passes."""
    gap, worst = 0.0, 0.0
    for i in range(RESNET_STEPS):
        gap = max([gap] + [abs(c[i] - m[i]) for c in cs])
        worst = max(worst, abs(p[i] - m[i])
                    / (CURVE_K * gap + LOSS_RTOL * abs(m[i])))
    return worst


def resnet_curves(torch, pt, cc, model, start, loss_fn, batch, pol,
                  wrong_dw=(WRONG_DW,)):
    """Loss curves from the same weights and BN state (``start``), cuDNN
    deterministic (``conv1x1_dw`` is already: its split of M depends on
    the shapes only), so that no curve carries cuDNN's run-to-run noise:
    ``"pallas"`` over RESNET_FALL_STEPS steps, ``"matmul"`` and
    ``"conv"`` over RESNET_STEPS.

    "matmul" differs from "pallas" only in who computes the 36 weight
    gradients of a step (cuBLAS through autograd, or the kernel), "conv"
    also in the 1x1 forward and input-gradient products (cuDNN). Both are
    sound lowerings, and the gap between their curves is how far this
    network carries a step's rounding. Gates: at each of the first
    RESNET_STEPS steps the "pallas" loss lies within CURVE_K times that
    gap (its running largest) of the "matmul" loss, plus LOSS_RTOL of the
    loss (``curve_excess`` at most 1); the same check fails for "pallas"
    with every weight gradient scaled by the last of ``wrong_dw`` (the
    controls run in order until one fails the check); the last "pallas"
    loss lies below its first. All under the dtype policy ``pol``.

    Under bfloat16_compute the gap is taken over a second yardstick too:
    "plain", the "pallas" lowering with the kernel's plain version
    (``conv1x1_dw_plain``: cuBLAS's f32 product of the widened operands)
    in its place. cuBLAS's and cuDNN's bf16 weight gradients round the
    same f32 sums to bf16 in nearly the same order, so "matmul" and
    "conv" agree far more closely with each other than either does with
    any other sound summation order; a dW summed in another order (the
    kernel's, or its plain version's) lands one bf16 ulp apart wherever a
    sum straddles a rounding boundary, and that is the noise the kernel's
    curve has to be held against."""
    def run(impl, steps):
        return resnet_run(torch, pt, model, start, loss_fn, batch, impl,
                          steps, pol)[1]

    det, kernel_dw = torch.backends.cudnn.deterministic, cc.conv1x1_dw
    torch.backends.cudnn.deterministic = True
    try:
        curves = {"pallas": run("pallas", RESNET_FALL_STEPS),
                  "matmul": run("matmul", RESNET_STEPS),
                  "conv": run("conv", RESNET_STEPS)}
        yard = ["conv"]
        if pol.compute_dtype != torch.float32:
            # the kernel's plain version as a lowering of its own
            cc.conv1x1_dw = cc.conv1x1_dw_plain
            curves["plain"] = run("pallas", RESNET_STEPS)
            yard.append("plain")
        controls = []
        for scale in wrong_dw:
            cc.conv1x1_dw = lambda x2d, dy2d, k=scale: k * kernel_dw(x2d,
                                                                     dy2d)
            curves["pallas_wrong_dw"] = run("pallas", RESNET_STEPS)
            controls.append([scale, curve_excess(
                curves["pallas_wrong_dw"], curves["matmul"],
                *(curves[y] for y in yard))])
            if controls[-1][1] > 1:
                break
    finally:
        cc.conv1x1_dw = kernel_dw
        torch.backends.cudnn.deterministic = det
    p, m = curves["pallas"], curves["matmul"]
    out = {"losses": curves, "yardsticks": yard,
           "excess": curve_excess(p, m, *(curves[y] for y in yard)),
           "wrong_dw": controls[-1][0], "excess_wrong_dw": controls[-1][1],
           "controls": controls}
    if not out["excess"] <= 1:
        raise RuntimeError(f"resnet: 'pallas' loss curve off 'matmul' by "
                           f"{out['excess']} of the limit: {out}")
    if not out["excess_wrong_dw"] > 1:
        raise RuntimeError(f"resnet: the curve gate passed a weight "
                           f"gradient {out['wrong_dw']}x too large: {out}")
    if not all(math.isfinite(x) for x in p) or not p[-1] < p[0]:
        raise RuntimeError(f"resnet: 'pallas' loss after "
                           f"{RESNET_FALL_STEPS} steps not below its "
                           f"first: {out}")
    return out


def resnet_run(torch, pt, model, start, loss_fn, batch, impl, steps, pol):
    """``steps`` steps under ``impl`` and the dtype policy ``pol`` from
    the weights and BN state ``start``, with a fresh momentum state;
    returns (ms per step, losses)."""
    model.load_state_dict(start)
    pt.set_conv1x1_impl(impl)
    trainer = pt.Trainer(model, loss_fn, pt.momentum(0.1, 0.9),
                         device="cuda")
    trainer.init()
    with pt.use_policy(pol):
        return timed_steps(torch, pt, trainer, batch, steps)


# the bf16 loss-curve gate's negative control. A bf16 step carries a bf16
# ulp of rounding in every weight gradient, and BatchNorm after every
# convolution makes the loss all but blind to the scale of a conv's
# update, so the curves part by as much for a dW summed in another order
# as for a dW 2x too large: a scan of 1.01, 1.02, 1.05, 1.1, 1.25, 1.5, 2
# and 4 on the card (NVIDIA H100 80GB HBM3, 700 W) first failed the gate
# at 4 (2.42 of its limit; 2 gave 0.48, 1.01 0.34)
BF16_WRONG_DW = (4.0,)


def resnet_step0_grads_bf16(torch, pt, cc, model, loss_fn, batch, pol):
    """Step-0 gradients under ``pol`` (bfloat16_compute) from the same
    weights and BN state (restored after each pass), cuDNN deterministic.

    Gates: "pallas" against "matmul" and against "conv", each parameter
    within BF16_K of the policy's own effect on its gradient ("pallas"
    under float32 against under the policy) plus one bf16 ulp of its
    largest entry (``_worst_of_effect``); each of the 36 kernel
    launches of the "pallas" pass is ``conv1x1_dw_bf16`` (no f32 launch),
    within TOL of max |plain| of ``conv1x1_dw_plain`` on the same bf16
    operands, at the shapes of the kernel phase."""
    state = {n: b.clone() for n, b in model.named_buffers()}
    kernel_dw, dw_errs, seen = cc.conv1x1_dw, [], {}

    def checked_dw(x2d, dy2d):
        got = kernel_dw(x2d, dy2d)
        (M, cin), cout = x2d.shape, dy2d.shape[1]
        seen[M, cin, cout] = seen.get((M, cin, cout), 0) + 1
        want = cc.conv1x1_dw_plain(x2d, dy2d)
        dw_errs.append(((got - want).abs().max()
                        / want.abs().max().clamp_min(1.0)).item())
        return got

    def grads(impl, p):
        pt.set_conv1x1_impl(impl)
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(state[n])
        model.zero_grad(set_to_none=True)
        with pt.use_policy(p):
            loss_fn(model(batch["x"], train=True), batch).mean().backward()
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters()}

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cc.conv1x1_dw = checked_dw
    cc.reset_launch_counts()
    try:
        g = {"pallas": grads("pallas", pol)}
        counts = cc.launch_counts()
    finally:
        cc.conv1x1_dw = kernel_dw
    try:
        g["matmul"] = grads("matmul", pol)
        g["conv"] = grads("conv", pol)
        g["pallas_f32"] = grads("pallas", pt.float32)
    finally:
        torch.backends.cudnn.deterministic = det
        pt.set_conv1x1_impl("pallas")
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(state[n])
    out = {"params": len(g["conv"]), "launches": counts}
    for ref in ("matmul", "conv"):
        worst = _worst_of_effect(g["pallas"], g[ref], g["pallas_f32"])
        out[f"pallas_vs_{ref}_worst_excess"] = list(worst)
        if not worst[1] <= 1:
            raise RuntimeError(f"bf16 step-0 gradient of {worst[0]}: "
                               f"pallas vs {ref} at {worst[1]} of the bf16 "
                               f"limit")
    if counts != {"conv1x1_dw": 0, "conv1x1_dw_bf16": 36}:
        raise RuntimeError(f"bf16 step: dW launches {counts}")
    if seen != RESNET50_DW:
        raise RuntimeError(f"conv1x1_dw_bf16 shapes of the step {seen} are "
                           f"not the kernel phase's {RESNET50_DW}")
    if len(dw_errs) != 36 or not max(dw_errs) <= TOL:
        raise RuntimeError(f"conv1x1_dw_bf16 vs its plain version on the "
                           f"path's tensors: {len(dw_errs)} launches, worst "
                           f"{max(dw_errs, default=None)}")
    out["kernel_vs_plain_dw_worst"] = max(dw_errs)
    out["pallas_vs_matmul_worst"] = list(_worst(g["pallas"], g["matmul"]))
    return out


def phase_resnet(torch, np, pt, cc, card, pol):
    """The prep_resnet50 configuration trained through the 1x1 dW kernel
    (``conv1x1_dw`` under float32, ``conv1x1_dw_bf16`` under
    bfloat16_compute) under the dtype policy ``pol``."""
    bf16 = pol.compute_dtype == torch.bfloat16
    tag, name = (" bf16", "conv1x1_dw_bf16") if bf16 else ("", "conv1x1_dw")
    B, image, classes, steps = 128, 224, 1000, RESNET_STEPS
    prev = pt.set_conv1x1_impl("pallas")
    try:
        gen = torch.Generator(device="cuda").manual_seed(5678)
        model = pt.resnet50(classes, device="cuda", generator=gen)
        host = conflicting_images(np, B, image, classes)
        # the batch lives on the card, as the JAX benchmark's sharded
        # batch does: steps time the step, not a host copy
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in host.items()}

        def loss_fn(out, b):
            return pt.softmax_cross_entropy(out, b["label"])

        if bf16:
            grad_check = resnet_step0_grads_bf16(torch, pt, cc, model,
                                                 loss_fn, batch, pol)
        else:
            grad_check = resnet_step0_grads(torch, pt, cc, model, loss_fn,
                                            batch)
        log(f"resnet{tag} step-0 gradients", json.dumps(grad_check))
        start = {k: v.clone() for k, v in model.state_dict().items()}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cc.reset_launch_counts()
        step_ms, losses = resnet_run(torch, pt, model, start, loss_fn,
                                     batch, "pallas", steps, pol)
        counts = cc.launch_counts()
        routes = cc.route_counts()
        peak = torch.cuda.max_memory_allocated()
        ms = sum(step_ms[1:]) / (steps - 1)
        conv_ms, conv_losses = resnet_run(torch, pt, model, start, loss_fn,
                                          batch, "conv", 3, pol)
        conv_steady = sum(conv_ms[1:]) / 2
        log(f"resnet{tag}", json.dumps({
            "config": "prep_resnet50: resnet50(1000), conv7 stem, batch 128 "
                      "x 224 x 224 x 3, momentum(0.1, 0.9), "
                      + ("bfloat16_compute" if bf16 else "f32")
                      + ", conv1x1 'pallas'",
            "steps": steps, "ms_per_step": ms, "step_ms": step_ms,
            "images_per_s": B / (ms / 1e3), "losses": losses,
            "loss_floor": round(math.log(2.0), 4), "launches": counts,
            "conv1x1_dw_bf16_routes": routes,
            "peak_mem_gib": peak / 2 ** 30,
            "conv_ab": {"impl": "conv", "step_ms": conv_ms,
                        "ms_per_step": conv_steady,
                        "images_per_s": B / (conv_steady / 1e3),
                        "losses": conv_losses,
                        "pallas_over_conv": ms / conv_steady},
            "card": card}))
        want = {"conv1x1_dw": 0, "conv1x1_dw_bf16": 0, name: 36 * steps}
        if counts != want:
            raise RuntimeError(f"resnet{tag}: dW launches {counts}, "
                               f"expected {want} (36 x {steps} steps)")
        want_routes = {"wgmma": 36 * steps if bf16 else 0, "mma_sync": 0}
        if routes != want_routes:
            raise RuntimeError(f"resnet{tag}: conv1x1_dw_bf16 routes "
                               f"{routes}, expected {want_routes}")
        if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
            raise RuntimeError(f"resnet{tag}: losses {losses}")
        log(f"resnet{tag} curves", json.dumps(resnet_curves(
            torch, pt, cc, model, start, loss_fn, batch, pol,
            BF16_WRONG_DW if bf16 else (WRONG_DW,))))
        pt.set_conv1x1_impl("pallas")
        trainer = pt.Trainer(model, loss_fn, pt.momentum(0.1, 0.9),
                             device="cuda")
        trainer.init()
        with pt.use_policy(pol):
            log(f"resnet{tag} profile", json.dumps(profile_window(
                torch, lambda: trainer.train(lambda: iter([batch] * 2),
                                             log_period=0),
                "2 training steps, conv1x1 'pallas'",
                kernels=("dw_tiles", "dw_wgmma", "split_reduce"))))
    finally:
        pt.set_conv1x1_impl(prev)
    return counts


# conv1x1_dw_bf16.cu's instances by route and tile index
INSTANCES = {"wgmma": ("WgLarge", "WgSmall"), "mma_sync": ("Large", "Small")}


def dw_bf16_bytes_flops(M, cin, cout):
    return 2 * (M * cin + M * cout) + 4 * cin * cout, 2 * M * cin * cout


def mma_bf16_rate(torch):
    """The card's bf16 ``mma.sync`` rate in FLOP/s, the best occupancy of
    ``tools/mma_bf16_peak.py`` (measured in this run)."""
    path = Path(__file__).resolve().parent / "tools" / "mma_bf16_peak.py"
    spec = importlib.util.spec_from_file_location("mma_bf16_peak", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rows = mod.measure(torch)
    log("mma_bf16_peak", json.dumps(rows))
    return max(r["bf16_tflops"] for r in rows) * 1e12


def bf16_bounds(row, nbytes, flops, mma_rate):
    """Adds to a timed row of ``conv1x1_dw_bf16`` its bound (the larger of
    the bytes at 3.35 TB/s and the operations at the data sheet's 989
    TFLOP/s of bf16, which the wgmma route can reach) and, beside it, the
    bound with the operations at the card's measured ``mma.sync`` rate,
    the instruction of the route for unaligned views; its TFLOP/s and
    share of each."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS_PER_S * 1e3
    t_m = flops / mma_rate * 1e3
    row.update(bytes_bound_ms=t_b, bound_ms=max(t_b, t_f),
               bound_by="bytes" if t_b >= t_f else "operations",
               mma_sync_bound_ms=max(t_b, t_m),
               mma_sync_bound_by="bytes" if t_b >= t_m else "operations",
               tflops=flops / row["kernel_ms"] / 1e9)
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    row["share_of_mma_sync_bound"] = row["mma_sync_bound_ms"] \
        / row["kernel_ms"]
    return row


def phase_conv_bf16_kernels(torch, cc, gen, mma_rate):
    """conv1x1_dw_bf16 on bf16 operands at the 15 distinct shapes of a
    ResNet-50 step: against its plain version at every one (within TOL of
    max(1, max |plain|)), two runs bit-equal, each shape's route and
    instance logged (the operands are fresh, so 16-byte aligned: the
    wgmma route, which the run requires); then the kernel, the
    plain version, the library call (``torch.mm(x.t(), dy,
    out_dtype=torch.float32)``: cuBLAS, bf16 operands, f32 output) and
    the f32 kernel ``conv1x1_dw`` on the same values widened, timed at
    every shape, and summed over the step's 36 launches beside the summed
    bounds (per launch: the step's sums over 36). The kernels' device time
    alone, beside cuBLAS's: ``tools/dw_bf16_compare.py``."""
    from paddle_tpu_torch.nn import gemm_bf16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    keys = ("kernel_ms", "plain_ms", "library_ms", "f32_kernel_ms",
            "bound_ms", "mma_sync_bound_ms", "bytes_bound_ms")
    step = {k: 0.0 for k in keys}
    step.update(bytes=0, flops=0)
    err = 0.0
    for shape, n in RESNET50_DW.items():
        M, cin, cout = shape
        x = torch.randn(M, cin, generator=gen, device="cuda").bfloat16()
        dy = torch.randn(M, cout, generator=gen, device="cuda").bfloat16()
        tile, splits, vec = cc._launch_plan(x, dy, sms)
        route = gemm_bf16.route(vec)
        row = {"shape": list(shape), "launches_per_step": n,
               "route": route, "instance": INSTANCES[route][tile],
               "tile": list(gemm_bf16.tiles(vec)[tile][:2]),
               "splits": splits, "copy_width": vec}
        if route != "wgmma":
            raise RuntimeError(f"conv1x1_dw_bf16 {shape}: fresh operands "
                               f"took the {route} route")
        got = cc.conv1x1_dw(x, dy)
        want = cc.conv1x1_dw_plain(x, dy)
        again = cc.conv1x1_dw(x, dy)
        torch.cuda.synchronize()
        e = check_close(f"conv1x1_dw_bf16 {shape}", got, want, rel=True)
        if not torch.equal(got, again):
            raise RuntimeError(f"conv1x1_dw_bf16 {shape}: two runs differ")
        row["max_abs_err"], row["max_plain"] = e, want.abs().max().item()
        row["err_over_max_plain"] = e / max(1.0, row["max_plain"])
        err = max(err, e)
        del got, want, again
        nbytes, flops = dw_bf16_bytes_flops(M, cin, cout)
        xf, dyf = x.float(), dy.float()
        row.update(
            kernel_ms=time_ms(torch, lambda: cc.conv1x1_dw(x, dy)),
            plain_ms=time_ms(torch, lambda: cc.conv1x1_dw_plain(x, dy)),
            library_ms=time_ms(torch, lambda: torch.mm(
                x.t(), dy, out_dtype=torch.float32)),
            f32_kernel_ms=time_ms(torch, lambda: cc.conv1x1_dw(xf, dyf)))
        bf16_bounds(row, nbytes, flops, mma_rate)
        for k in keys:
            step[k] += n * row[k]
        step["bytes"] += n * nbytes
        step["flops"] += n * flops
        log("conv1x1_dw_bf16", json.dumps(row))
        del x, dy, xf, dyf
    t_b = step["bytes"] / HBM_BYTES_PER_S * 1e3
    step.update(
        max_abs_err=err, launches=36,
        bound_by="operations" if step["flops"] / BF16_FLOPS_PER_S * 1e3
        >= t_b else "bytes",
        mma_sync_tflops=mma_rate / 1e12,
        tflops=step["flops"] / step["kernel_ms"] / 1e9,
        share_of_bound=step["bound_ms"] / step["kernel_ms"],
        share_of_mma_sync_bound=step["mma_sync_bound_ms"]
        / step["kernel_ms"],
        per_launch={k: step[k] / 36 for k in keys},
        library="torch.mm(x.t(), dy, out_dtype=torch.float32)",
        bound_note="sums of the 36 launches' own bounds")
    log("conv1x1_dw_bf16 step (36 launches)", json.dumps(step))
    return step


# ---------------------------------------------------------------------------
# bf16 operands of the flash kernels and of ln_matmul (phase 11)
# ---------------------------------------------------------------------------

# the bf16 flash cases: PERF.md section 6's rows 1, 3 and 4 (the training
# shape, the serving slice's prefill shape, the segments shape)
FLASH_BF16_CASES = [
    ("training [8,4,2048,128] causal", (8, 4, 2048, 128), True, None),
    ("slice [1,8,1024,64] causal", (1, 8, 1024, 64), True, None),
    ("[2,8,512,128] segments", (2, 8, 512, 128), False, SEG_ROWS)]
# The bf16 gate, in bf16 ulps: every entry within one ulp of the tensor's
# largest |plain| entry, and at most BF16_SHARE of the entries above
# BF16_NOISE of the largest off at all. Kernel and plain version sum the
# same exact bf16 products in f32 in other orders and their exponentials
# differ in the last bits, so a p, ds, y or output that straddles a bf16
# rounding boundary may land one ulp apart. Entries under the floor are
# f32 rounding noise (a query row that sees one key has dp - delta = 0 up
# to the order of two sums: its ds and dq are noise about 1e-8 of the
# largest dq). Set from the card: at these shapes 0.03-0.27% of the
# entries were off, and the control (p, ds or y left unrounded) put 38-42%
# off; the CPU parity tests against JAX hold 1% too.
BF16_SHARE = 0.01
BF16_NOISE = 2.0 ** -16
# the bf16 path's gradients against the plain versions' autograd end to
# end (plain forward, then the plain backward on its O and LSE): two
# rounding points in series, the forward's O (0.26% of its entries an
# ulp apart at the training shape) feeding delta = rowsum(dO * O) and so
# every ds of its row. The first reading on the card put 1.14% of dk's
# entries off (the backward alone on the same saved O: 0.20%); the
# control still puts 40% off
BF16_PATH_SHARE = 0.02
LSE_TOL = 1e-4


def bf16_gate(torch, name, got, want, control=None, share=BF16_SHARE):
    """``got`` (bf16) against its plain version ``want`` (bf16) under the
    bf16 gate (at most ``share`` of the entries above the noise floor
    off); with ``control`` (the plain version with p, ds or y left
    unrounded, rounded to bf16 at the end) also shows that the gate sees
    the rounding point: the control must fail it. Returns the figures."""
    if got.dtype != torch.bfloat16 or want.dtype != torch.bfloat16:
        raise RuntimeError(f"{name}: dtypes {got.dtype}, {want.dtype}")

    def figures(t):
        w = want.float()
        d = (t.float() - w).abs()
        top = w.abs().max().item()
        ulp = 2.0 ** (math.frexp(top)[1] - 8) if top else 0.0
        off = d > 0
        return {"max_abs_err": d.max().item(), "ulp_of_max": ulp,
                "max_err_ulps": d.max().item() / ulp if ulp else 0.0,
                "share_off": off.float().mean().item(),
                "share_off_above_noise": (off & (w.abs() > BF16_NOISE * top))
                .float().mean().item()}

    def passes(f):
        return f["max_abs_err"] <= f["ulp_of_max"] \
            and f["share_off_above_noise"] <= share

    row = figures(got)
    if not passes(row):                 # also catches NaN
        raise RuntimeError(f"{name}: outside the bf16 gate: {row}")
    if control is not None:
        c = figures(control)
        row["control_share_off"] = c["share_off_above_noise"]
        row["control_max_err_ulps"] = c["max_err_ulps"]
        if passes(c):
            raise RuntimeError(f"{name}: the unrounded control passes the "
                               f"bf16 gate ({c}): the gate does not see "
                               f"where p is rounded")
    return row


def refuse(name, fn, counts_fn):
    """``fn`` must raise ValueError and launch nothing."""
    before = counts_fn()
    try:
        fn()
    except ValueError as e:
        if counts_fn() != before:
            raise RuntimeError(f"{name}: a refused call launched a kernel")
        return str(e)[:80]
    raise RuntimeError(f"{name}: not refused")


def phase_flash_bf16(torch, F, ca, gen, mma_rate):
    """The bf16 branches of the flash kernels (``flash_fwd_bf16``,
    ``flash_bwd_dq_bf16``, ``flash_bwd_dkv_bf16``) at FLASH_BF16_CASES:
    O and each gradient held to its plain version under the bf16 gate,
    with the unrounded control failing it, the LSE within LSE_TOL, reruns
    bit-equal, each case's plans on a line of their own; then each kernel
    timed (events; at the training shape, the kernels line's, also the
    profiler's device time) beside its plain version, SDPA on the same
    bf16 inputs (forward, backward and forward+backward; an explicit mask
    for segments) and its bounds (bytes at 3.35 TB/s, operations at 989
    TFLOP/s and at the card's bf16 mma.sync rate). The backward's two kernels are timed as
    ``flash_attention_bwd`` launches them (dk/dv storing ds where the plan
    stores it, dq from it), and its delta kernel on its own (beside
    ``torch.bmm`` of the rows with ``out_dtype=torch.float32``). Each aligned call must go by ``wgmma`` (route counts), and the
    backward's delta within TOL of the plain one relative to its largest
    entry. Last, the wrappers' refusals: mixed dtypes, bf16 views 2 bytes
    off 4, a stored ds of the wrong dtype."""
    bf = torch.bfloat16
    rows = {}
    for label, shape, causal, seg_rows in FLASH_BF16_CASES:
        # profiler windows only where the kernels line reads them: each
        # is a chance for the profiler to drop part of a window
        profiled = label == FLASH_BF16_CASES[0][0]

        def dev(fn, profiled=profiled):
            return device_ms(torch, fn) if profiled else (None, None)

        B, H, T, D = shape
        fplan = ca.flash_fwd_plan(B, H, T, D, causal, bf)
        bplan = ca.flash_bwd_plan(B, H, T, D, causal, bf)
        log("flash bf16 plans", json.dumps({
            "case": label, "fwd": fplan._asdict(), "bwd": bplan._asdict()}))
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(bf) for _ in range(4))
        seg = None if seg_rows is None else torch.tensor(
            seg_rows, dtype=torch.int32, device="cuda")
        if seg is not None:
            do = do * (seg > 0)[:, None, :, None].to(bf)
        fwd = lambda: ca.flash_attention_fwd(q, k, v, seg, causal)  # noqa
        names = ("flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16")
        before = ca.launch_counts()
        routes = {n: ca.route_counts(n) for n in names}
        o, lse = fwd()
        bwd = lambda: ca.flash_attention_bwd(  # noqa: E731
            q, k, v, seg, o, lse, do, causal)
        grads = bwd()
        after = ca.launch_counts()
        route = {n: moved(routes[n], ca.route_counts(n)) for n in names}
        if moved(before, after) != {"flash_fwd_bf16": 1,
                                    "flash_bwd_dq_bf16": 1,
                                    "flash_bwd_dkv_bf16": 1,
                                    "flash_bwd_delta_bf16": 1}:
            raise RuntimeError(f"flash bf16 {label}: launches {before} -> "
                               f"{after}")
        log("flash bf16 routes", json.dumps({"case": label,
                                             "routes": route}))
        if route != {n: {"wgmma": 1} for n in names}:
            raise RuntimeError(f"flash bf16 {label}: aligned operands went "
                               f"by {route}, not all by wgmma")
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        o_ref, lse_ref = ca.flash_attention_plain(q, k, v, seg, causal)
        errs = {"O": bf16_gate(
            torch, f"flash_fwd_bf16 {label} O", o, o_ref,
            ca.flash_attention_plain(qf, kf, vf, seg, causal)[0].to(bf))}
        lse_err = (lse - lse_ref).abs().max().item()
        if not lse_err <= LSE_TOL:
            raise RuntimeError(f"flash_fwd_bf16 {label}: LSE off by "
                               f"{lse_err}")
        errs["LSE"] = lse_err
        del o_ref, lse_ref
        want = ca.flash_attention_bwd_plain(q, k, v, seg, o, lse, do, causal)
        unrounded = ca.flash_attention_bwd_plain(qf, kf, vf, seg, o.float(),
                                                 lse, dof, causal)
        for x, g, w, u in zip(("dq", "dk", "dv"), grads, want, unrounded):
            errs[x] = bf16_gate(torch, f"flash bf16 {label} {x}", g, w,
                                u.to(bf))
        del want, unrounded, qf, kf, vf, dof
        check_rerun(torch, f"flash_fwd_bf16 {label} O", o, lambda: fwd()[0])
        check_rerun(torch, f"flash_fwd_bf16 {label} LSE", lse,
                    lambda: fwd()[1])
        again = bwd()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            raise RuntimeError(f"flash bf16 {label}: backward reruns differ")
        del grads, again
        log("flash bf16 gate", json.dumps({"case": label, **errs}))

        # timing
        vis, pairs = visible_pairs(torch, B, T, causal, seg)
        mask = None if seg is None else vis[:, None]
        td = 2 * B * H * T * D               # a bf16 [B, H, T, D] tensor
        rowb = 4 * B * H * T
        segb = 0 if seg is None else 4 * B * T
        delta = ca.flash_bwd_delta(o, do)
        delta_ref = ca._delta(o, do)
        errs["delta"] = check_close(f"flash_bwd_delta_bf16 {label}", delta,
                                    delta_ref, rel=True)
        args = (q, k, v, seg, do, lse, delta, causal)
        ds = torch.empty((B * H, T, T), dtype=bf, device="cuda") \
            if bplan.stored_ds else None
        dsb = 2 * H * pairs if ds is not None else 0
        calls = {
            "flash_fwd_bf16": (fwd, lambda: ca.flash_attention_plain(
                q, k, v, seg, causal), 4 * td + rowb + segb,
                4 * D * H * pairs),
            "flash_bwd_dkv_bf16": (
                lambda: ca.flash_bwd_dkv(*args, ds=ds),
                lambda: ca.flash_bwd_dkv_plain(*args),
                6 * td + 2 * rowb + segb + dsb, 8 * D * H * pairs),
            "flash_bwd_dq_bf16": (
                lambda: ca.flash_bwd_dq(*args, ds=ds),
                lambda: ca.flash_bwd_dq_plain(*args),
                (2 * td + dsb if ds is not None else 5 * td + 2 * rowb)
                + segb, (2 if ds is not None else 6) * D * H * pairs),
            "flash_attention_bwd bf16": (
                bwd, lambda: ca.flash_attention_bwd_plain(
                    q, k, v, seg, o, lse, do, causal),
                8 * td + rowb + segb, 10 * D * H * pairs),
            # O and dO read once, delta written; a product and an add an
            # element
            "flash_bwd_delta_bf16": (
                lambda: ca.flash_bwd_delta(o, do), lambda: ca._delta(o, do),
                2 * td + rowb, 2 * B * H * T * D)}
        if ds is not None:
            ca.flash_bwd_dkv(*args, ds=ds)     # dq below reads this ds
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd():
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None)

        sdpa_out = sdpa_fwd()

        def sdpa_bwd():
            return torch.autograd.grad(sdpa_out, (qs, ks, vs), do,
                                       retain_graph=True)

        def sdpa_both():
            return torch.autograd.grad(sdpa_fwd(), (qs, ks, vs), do)

        def bmm_delta():
            # one call for delta: a batch of [1, D] x [D, 1] products of
            # the bf16 rows, summed in f32 as the kernel sums them
            return torch.bmm(o.view(-1, 1, D), do.view(-1, D, 1),
                             out_dtype=torch.float32).view(B, H, T)

        lib = {"fwd": (time_ms(torch, sdpa_fwd), dev(sdpa_fwd)[0]),
               "bwd": (time_ms(torch, sdpa_bwd), dev(sdpa_bwd)[0]),
               "both": (time_ms(torch, sdpa_both), dev(sdpa_both)[0]),
               "delta": (time_ms(torch, bmm_delta), dev(bmm_delta)[0])}
        bmm_err = (bmm_delta() - delta_ref).abs().max().item() / max(
            1.0, delta_ref.abs().max().item())
        del sdpa_out
        for name, (fn, plain, nbytes, flops) in calls.items():
            dev_t, dev_rows = dev(fn)
            key = {"flash_fwd_bf16": "fwd",
                   "flash_bwd_delta_bf16": "delta"}.get(name, "bwd")
            row = {"case": label, "kernel_ms": time_ms(torch, fn),
                   "device_ms": dev_t, "device_rows": dev_rows,
                   "plain_ms": time_ms(torch, plain, iters=5),
                   "library_ms": lib[key][0],
                   "library_device_ms": lib[key][1],
                   "library_note": "SDPA on the bf16 inputs, "
                   + ("forward" if key == "fwd" else "backward: dq, dk, dv")
                   + (" (explicit mask)" if mask is not None else "")
                   if key != "delta" else "torch.bmm of O's rows [N, 1, D] "
                   "by dO's [N, D, 1], out_dtype=torch.float32 (off the "
                   f"plain delta by {bmm_err} of its largest entry)",
                   "sdpa_fwd_bwd_ms": lib["both"][0],
                   "sdpa_fwd_bwd_device_ms": lib["both"][1],
                   "pairs_per_head": pairs, "stored_ds": ds is not None,
                   "max_abs_err": errs["delta"]
                   if key == "delta" else max(
                       errs[x]["max_abs_err"] for x in
                       (("O",) if key == "fwd" else ("dq", "dk", "dv")))}
            if name == "flash_fwd_bf16":
                row["note"] = ("bound of 4 D a visible pair; the kernel runs "
                               "6 D (a max pass over K, then the main pass)")
                row["kernel_flops"] = 6 * D * H * pairs
            row.update(bytes=nbytes, flops=flops)
            rows[name, label] = bf16_bounds(row, nbytes, flops, mma_rate)
            log(name, json.dumps(row))
        del vis, mask, ds, qs, ks, vs
    rows.update(flash_bf16_views(torch, ca, gen))
    # refusals
    q = torch.randn(1, 2, 64, 64, generator=gen, device="cuda").to(bf)
    o, lse = ca.flash_attention_fwd(q, q, q)
    odd = torch.randn(2 * 64 * 64 + 1, generator=gen,
                      device="cuda").to(bf)[1:].view(1, 2, 64, 64)
    refused = {
        "mixed q/k": refuse("flash bf16 mixed", lambda: ca.flash_attention_fwd(
            q, q.float(), q), ca.launch_counts),
        "mixed dO": refuse("flash bf16 mixed dO",
                           lambda: ca.flash_attention_bwd(
                               q, q, q, None, o, lse, o.float()),
                           ca.launch_counts),
        "2 bytes off 4": refuse("flash bf16 view", lambda:
                                ca.flash_attention_fwd(odd, q, q),
                                ca.launch_counts),
        "f32 ds": refuse("flash bf16 ds", lambda: ca.flash_bwd_dq(
            q, q, q, None, q, lse, lse,
            ds=torch.empty(2, 64, 64, device="cuda")), ca.launch_counts)}
    log("flash bf16 refusals", json.dumps(refused))
    return rows


def moved(before, after):
    """The counts that moved between two snapshots, by how much."""
    return {n: after[n] - before[n] for n in after if after[n] != before[n]}


def bf16_view(torch, gen, shape):
    """A bf16 ``shape`` of random values whose data starts 4 bytes off a
    16-byte boundary (a view into a larger buffer): the copy width TMA
    cannot take, which the mma.sync routes take."""
    n = math.prod(shape)
    buf = torch.randn(n + 8, generator=gen, device="cuda").to(
        torch.bfloat16)
    t = buf[2:2 + n].view(shape)
    assert t.data_ptr() % 16 == 4
    return t


def flash_bf16_views(torch, ca, gen):
    """``flash_fwd_bf16`` at ``[2,8,512,128]`` with segments on q, k, v
    views 4 bytes off 16: the call must go by ``mma.sync`` (one launch,
    route counted), O under the bf16 gate with the unrounded control
    failing it, the LSE within LSE_TOL, a bit-equal rerun; timed. Then
    the backward on those views and a dO view: ``flash_bwd_dkv_bf16`` and
    ``flash_bwd_dq_bf16`` by ``mma.sync`` too, dq, dk and dv under the
    gate with the control failing it, a bit-equal rerun; timed whole and
    kernel by kernel."""
    bf = torch.bfloat16
    label, shape, causal, seg_rows = FLASH_BF16_CASES[2]
    label += " on views 4 bytes off 16"
    q, k, v = (bf16_view(torch, gen, shape) for _ in range(3))
    seg = torch.tensor(seg_rows, dtype=torch.int32, device="cuda")
    fwd = lambda: ca.flash_attention_fwd(q, k, v, seg, causal)  # noqa: E731
    before, routes = ca.launch_counts(), ca.route_counts("flash_fwd_bf16")
    o, lse = fwd()
    route = moved(routes, ca.route_counts("flash_fwd_bf16"))
    if moved(before, ca.launch_counts()) != {"flash_fwd_bf16": 1} \
            or route != {"mma_sync": 1}:
        raise RuntimeError(f"flash_fwd_bf16 {label}: launches "
                           f"{moved(before, ca.launch_counts())}, routes "
                           f"{route}; expected one by mma_sync")
    o_ref, lse_ref = ca.flash_attention_plain(q, k, v, seg, causal)
    row = {"case": label, "routes": route,
           "plan": ca.flash_fwd_plan(*shape, causal, bf, ca.flash_copy_width(
               q, k, v))._asdict(),
           "O": bf16_gate(torch, f"flash_fwd_bf16 {label} O", o, o_ref,
                          ca.flash_attention_plain(
                              q.float(), k.float(), v.float(), seg,
                              causal)[0].to(bf))}
    row["max_abs_err"] = row["O"]["max_abs_err"]
    row["LSE"] = (lse - lse_ref).abs().max().item()
    if not row["LSE"] <= LSE_TOL:
        raise RuntimeError(f"flash_fwd_bf16 {label}: LSE off by "
                           f"{row['LSE']}")
    check_rerun(torch, f"flash_fwd_bf16 {label} O", o, lambda: fwd()[0])
    row["kernel_ms"] = time_ms(torch, fwd)
    log("flash_fwd_bf16 views", json.dumps(row))
    do = bf16_view(torch, gen, shape)
    do.mul_((seg > 0)[:, None, :, None].to(bf))
    names = ("flash_bwd_dkv_bf16", "flash_bwd_dq_bf16")
    routes = {n: ca.route_counts(n) for n in names}
    bwd = lambda: ca.flash_attention_bwd(  # noqa: E731
        q, k, v, seg, o, lse, do, causal)
    grads = bwd()
    route = {n: moved(routes[n], ca.route_counts(n)) for n in names}
    if route != {n: {"mma_sync": 1} for n in names}:
        raise RuntimeError(f"flash bf16 backward {label}: routes {route}; "
                           f"expected each by mma_sync")
    want = ca.flash_attention_bwd_plain(q, k, v, seg, o, lse, do, causal)
    unrounded = ca.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), seg, o.float(), lse, do.float(),
        causal)
    brow = {"case": label, "routes": route}
    for x, g, w, u in zip(("dq", "dk", "dv"), grads, want, unrounded):
        brow[x] = bf16_gate(torch, f"flash bf16 backward {label} {x}", g,
                            w, u.to(bf))
    again = bwd()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise RuntimeError(f"flash bf16 backward {label}: reruns differ")
    brow["max_abs_err"] = max(brow[x]["max_abs_err"]
                              for x in ("dq", "dk", "dv"))
    brow["kernel_ms"] = time_ms(torch, bwd)
    # each kernel of the backward alone on the views, as
    # flash_attention_bwd launches it (dk/dv storing ds where the plan
    # stores it, dq reading it back)
    delta = ca.flash_bwd_delta(o, do)
    B, H, T, D = shape
    ds = torch.empty((B * H, T, T), dtype=bf, device="cuda") \
        if ca.flash_bwd_plan(B, H, T, D, causal, bf).stored_ds else None
    brow["dkv_kernel_ms"] = time_ms(torch, lambda: ca.flash_bwd_dkv(
        q, k, v, seg, do, lse, delta, causal, None, ds))
    brow["dq_kernel_ms"] = time_ms(torch, lambda: ca.flash_bwd_dq(
        q, k, v, seg, do, lse, delta, causal, None, ds))
    brow["stored_ds"] = ds is not None
    log("flash bf16 backward views", json.dumps(brow))
    return {("flash_fwd_bf16", label): row,
            ("flash_attention_bwd bf16", label): brow}


def phase_flash_bf16_path(torch, ca, gen):
    """The bf16 path through the entry point a user calls: bf16 leaf q, k,
    v with ``requires_grad`` at the training shape ``[8,4,2048,128]``
    causal through ``flash_attention`` (``FlashAttentionFunction``), a
    loss and ``.backward()``, the launch counts set to 0 just before and
    read just after: exactly one ``flash_fwd_bf16``, one
    ``flash_bwd_delta_bf16``, one ``flash_bwd_dkv_bf16`` and one
    ``flash_bwd_dq_bf16``, no other kernel, each of the three flash
    kernels by ``wgmma``;
    bf16 gradients within the bf16 gate of the plain backward on the O and
    LSE the forward saved, and within BF16_PATH_SHARE of the plain
    versions' autograd end to end (plain forward, plain backward); O
    within the gate of the plain forward; the unrounded control failing
    each. Every figure is logged before any gate fails the run."""
    bf = torch.bfloat16
    B, H, T, D = 8, 4, 2048, 128
    base = [torch.randn(B, H, T, D, generator=gen, device="cuda").to(bf)
            for _ in range(4)]
    q, k, v = (t.clone().requires_grad_() for t in base[:3])
    do = base[3]
    torch.cuda.synchronize()
    ca.reset_launch_counts()
    out = ca.flash_attention(q, k, v, None, True)
    saved_o, saved_lse = out.grad_fn.saved_tensors[4:6]
    loss = (out.float() * do.float()).sum()
    loss.backward()
    torch.cuda.synchronize()
    counts = ca.launch_counts()
    want = {"flash_fwd_bf16": 1, "flash_bwd_dq_bf16": 1,
            "flash_bwd_dkv_bf16": 1, "flash_bwd_delta_bf16": 1}
    if {n: c for n, c in counts.items() if c} != want:
        raise RuntimeError(f"flash bf16 path: launches {counts}, expected "
                           f"{want}")
    routes = {n: ca.route_counts(n) for n in (
        "flash_fwd_bf16", "flash_bwd_dkv_bf16", "flash_bwd_dq_bf16")}
    if routes != {n: {"wgmma": 1, "mma_sync": 0} for n in routes}:
        raise RuntimeError(f"flash bf16 path: routes {routes}, expected "
                           f"one launch of each kernel by wgmma")
    if type(out.grad_fn).__name__ != "FlashAttentionFunctionBackward":
        raise RuntimeError(f"flash bf16 path: grad_fn {out.grad_fn}")
    f = [t.float() for t in base]
    o_ref, lse_ref = ca.flash_attention_plain(*base[:3], None, True)
    o_un, lse_un = ca.flash_attention_plain(*f[:3], None, True)
    checks = [("O", out.detach(), o_ref, o_un.to(bf), BF16_SHARE)]
    # the backward on what the forward saved, then end to end
    for tag, (o, lse), (ou, lu), share in (
            ("", (saved_o, saved_lse), (saved_o.float(), saved_lse),
             BF16_SHARE),
            (" end to end", (o_ref, lse_ref), (o_un, lse_un),
             BF16_PATH_SHARE)):
        ref = ca.flash_attention_bwd_plain(*base[:3], None, o, lse, do, True)
        un = ca.flash_attention_bwd_plain(*f[:3], None, ou, lu, f[3], True)
        checks += [(x + tag, t.grad, w, u.to(bf), share)
                   for x, t, w, u in zip(("dq", "dk", "dv"), (q, k, v), ref,
                                         un)]
        del ref, un
    res = {"launches": counts, "routes": routes,
           "loss": loss.item(),
           "grad_dtypes": [str(t.grad.dtype) for t in (q, k, v)]}
    failed = []
    for x, got, want, control, share in checks:
        try:
            res[x] = bf16_gate(torch, f"flash bf16 path {x}", got, want,
                               control, share)
        except RuntimeError as e:
            failed.append(str(e))
    log("flash bf16 path", json.dumps(res))
    if failed or any(t.grad.dtype != bf for t in (q, k, v)):
        raise RuntimeError(f"flash bf16 path: {failed or res['grad_dtypes']}")
    return counts


def phase_ln_bf16_kernels(torch, F, fl, gen, mma_rate):
    """``ln_matmul_bf16`` through ``fused_ln_matmul`` at the transformer
    width on bf16 x ``[16384, 512]`` and w ``[512, 512]``, ``[512, 2048]``,
    with and without bf16 scale and bias: the entry point's launches (its
    only caller, counts set to 0 before and read after), each against the
    plain version under the bf16 gate with the unrounded control (y not
    rounded to bf16) failing it, reruns bit-equal, timed beside the plain
    version and ``F.layer_norm(x, ...) @ w`` in bf16 (the profiler's
    device time and rows too: the statistics pass, the product and, with
    bf16 scale and bias, their two widening copies; the library's for the
    kernels line's case, w ``[512, 2048]`` with scale and bias), with its
    bounds; each call's plan and route logged,
    all four by ``wgmma``; then x on a view 4 bytes off 16 (w ``[512,
    512]``, scale and bias) by ``mma.sync``, under the same gate."""
    from paddle_tpu_torch.nn import gemm_bf16
    bf = torch.bfloat16
    M, K = 16384, 512
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = (torch.randn(M, K, generator=gen, device="cuda") * 2 + 0.5).to(bf)
    sc = (1 + 0.1 * torch.randn(K, generator=gen, device="cuda")).to(bf)
    bi = (0.1 * torch.randn(K, generator=gen, device="cuda")).to(bf)
    cases = [(N, aff) for N in (512, 2048) for aff in (False, True)]
    ws = {N: (torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5)
          .to(bf) for N in (512, 2048)}
    torch.cuda.synchronize()
    fl.reset_launch_counts()
    outs = [fl.fused_ln_matmul(x, ws[N], *((sc, bi) if aff else ()))
            for N, aff in cases]
    torch.cuda.synchronize()
    counts = fl.launch_counts()
    if counts != {"ln_matmul": 0, "ln_matmul_bf16": len(cases)}:
        raise RuntimeError(f"ln_matmul_bf16: launches {counts}")
    log("ln_matmul_bf16 routes", json.dumps(fl.route_counts()))
    if fl.route_counts() != {"wgmma": len(cases), "mma_sync": 0}:
        raise RuntimeError(f"ln_matmul_bf16: aligned operands went by "
                           f"{fl.route_counts()}, not all by wgmma")
    rows = {}
    for (N, aff), got in zip(cases, outs):
        w = ws[N]
        s, b = (sc, bi) if aff else (None, None)
        want = fl.ln_matmul_reference(x, w, s, b)
        unrounded = fl.ln_matmul_reference(
            x.float(), w.float(), None if s is None else s.float(),
            None if b is None else b.float()).to(bf)
        label = f"x [{M},{K}] w [{K},{N}]" + (" scale+bias" if aff else "")
        err = bf16_gate(torch, f"ln_matmul_bf16 {label}", got, want,
                        unrounded)
        check_rerun(torch, f"ln_matmul_bf16 {label}", got,
                    lambda: fl.fused_ln_matmul(x, w, s, b))
        del want, unrounded
        fn = lambda: fl.fused_ln_matmul(x, w, s, b)  # noqa: E731
        lib = lambda: F.layer_norm(x, (K,), s, b, 1e-6) @ w  # noqa: E731
        profiled = (N, aff) == (2048, True)
        dev_ms, dev_rows = device_ms(torch, fn)
        row = {"case": label, **err, "kernel_ms": time_ms(torch, fn),
               "device_ms": dev_ms, "device_rows": dev_rows,
               "plain_ms": time_ms(torch, lambda: fl.ln_matmul_reference(
                   x, w, s, b)),
               "library_ms": time_ms(torch, lib),
               "library_device_ms": device_ms(torch, lib)[0] if profiled
               else None,
               "library_note": "F.layer_norm + torch.mm, bf16",
               "plan": fl.ln_bf16_plan(M, K, N, gemm_bf16.copy_width(x, w),
                                       sms)._asdict()}
        nbytes = 2 * (M * K + K * N + M * N) + (4 * K if aff else 0)
        row.update(bytes=nbytes, flops=2 * M * K * N)
        rows[N, aff] = bf16_bounds(row, nbytes, 2 * M * K * N, mma_rate)
        log("ln_matmul_bf16", json.dumps(row))
    # x 4 bytes off 16: the mma.sync route, under the same gate
    xv = bf16_view(torch, gen, (M, K))
    xv.mul_(2).add_(0.5)
    w = ws[512]
    before, routes = fl.launch_counts(), fl.route_counts()
    got = fl.fused_ln_matmul(xv, w, sc, bi)
    route = moved(routes, fl.route_counts())
    if moved(before, fl.launch_counts()) != {"ln_matmul_bf16": 1} \
            or route != {"mma_sync": 1}:
        raise RuntimeError(f"ln_matmul_bf16 on a view: routes {route}, "
                           f"expected one by mma_sync")
    label = f"x [{M},{K}] 4 bytes off 16, w [{K},512] scale+bias"
    row = {"case": label, "routes": route, **bf16_gate(
        torch, f"ln_matmul_bf16 {label}", got,
        fl.ln_matmul_reference(xv, w, sc, bi),
        fl.ln_matmul_reference(xv.float(), w.float(), sc.float(),
                               bi.float()).to(bf)),
        "plan": fl.ln_bf16_plan(M, K, 512, gemm_bf16.copy_width(xv, w),
                                sms)._asdict()}
    check_rerun(torch, f"ln_matmul_bf16 {label}", got,
                lambda: fl.fused_ln_matmul(xv, w, sc, bi))
    row["kernel_ms"] = time_ms(torch, lambda: fl.fused_ln_matmul(xv, w, sc,
                                                                 bi))
    log("ln_matmul_bf16 view", json.dumps(row))
    refused = {"mixed x/w": refuse("ln bf16 mixed", lambda: fl.fused_ln_matmul(
        x, ws[512].float()), fl.launch_counts)}
    log("ln_matmul_bf16 refusals", json.dumps(refused))
    return rows, counts


# -- phase 14: observability ------------------------------------------------

OBS_STEPS = 8
# The step record's keys as the JAX Trainer's telemetry writes them
# (paddle_tpu/obs/telemetry.py emit_step): the fixed schema, and the rate
# keys a fenced (not pipelined, not profiled) record adds.
OBS_STEP_KEYS = {"kind", "ts", "pass", "step", "k_steps", "m", "loss",
                 "profiled", "host_stack_ms", "shard_ms", "dispatch_ms",
                 "device_ms", "replay_ms", "compile_count", "retrace_count",
                 "bytes_in_use", "peak_bytes", "grad_norm", "param_norm",
                 "update_norm", "update_ratio", "nonfinite_count",
                 "stage_ms", "drain_wait_ms", "overlap_frac", "fenced"}
OBS_RATE_KEYS = {"tokens_per_sec", "est_mfu_pct"}
OBS_SPEC = {"speculative": 4, "prefill_chunk": 128}


def transformer_train_flops(bs, seq, dim, layers, vocab, ffn):
    """Analytic FLOPs of one causal-LM training step (the formula of
    ``bench.py``'s ``transformer_train_flops``): 6 a parameter a token for
    the products (attention 4·d², FFN 2·d·ffn a layer, the tied readout
    vocab·d) plus causal attention, 6·layers·seq·d a token."""
    per_tok = (6.0 * (4 * dim * dim * layers + 2 * dim * ffn * layers
                      + vocab * dim)
               + 6.0 * layers * seq * dim)
    return per_tok * bs * seq


def _obs_train_run(torch, np, pt, obs, ca, start, batches, K, W, hooks,
                   out_dir, arm=False):
    """One 8-step run of the ``prep_transformer`` Trainer from ``start``
    under ``bfloat16_compute``, every obs hook on or all off; returns the
    run's numbers, records and checks."""
    cfg = LOOP_CFG
    V = cfg["vocab"]
    model = pt.TransformerLM(**cfg, device="cuda")
    model.load_state_dict(start)
    kw, mem, samples, grad_checks = {}, None, [], []
    if hooks:
        mem = obs.InMemorySink()
        tel = obs.Telemetry(
            sinks=[mem, obs.JsonlSink(str(out_dir / "run.jsonl"))],
            health=True, memory=True, fence=True,
            flops_per_step=transformer_train_flops(
                LOOP_BATCH, cfg["max_len"], cfg["dim"], cfg["num_layers"],
                V, cfg["ffn_hidden"]),
            tokens_per_step=LOOP_BATCH * cfg["max_len"])
        sample = tel.sample_memory

        def sample_memory():
            cur = sample()
            samples.append((cur, torch.cuda.memory_allocated()))
            return cur

        tel.sample_memory = sample_memory
        kw = dict(telemetry=tel, tracer=obs.Tracer(), metrics=obs.MetricsHub(),
                  anomaly=obs.AnomalyDetector(str(out_dir / "anomaly"),
                                              arm_profiler=arm))

    def loss_fn(out, b):
        return pt.softmax_cross_entropy(out.reshape(-1, V),
                                        b["y"].reshape(-1)).reshape(
            b["y"].shape)

    tr = pt.Trainer(model, loss_fn, pt.adam(1e-4), steps_per_call=K,
                    pipeline_depth=W, device="cuda", **kw)
    tr.init()
    losses, check_s = [], [0.0]

    def handler(e):
        if isinstance(e, pt.train.EndIteration):
            losses.append(e.cost)
        elif hooks and K == 1 and W == 1 and \
                type(e).__name__ == "TelemetryRecord" and \
                e.record.get("grad_norm") is not None:
            # the serial loop fires the record right after the call, while
            # .grad still holds that step's gradients: each one's f32 norm,
            # combined on the host (no large temporary, so the allocator's
            # state stays as the unchecked run leaves it); the check's own
            # time is taken off the run's
            t = time.perf_counter()
            own = math.sqrt(sum(float(p.grad.norm()) ** 2
                                for p in model.parameters()))
            grad_checks.append((e.record["grad_norm"], own))
            check_s[0] += time.perf_counter() - t

    torch.cuda.synchronize()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    with pt.use_policy(pt.bfloat16_compute):
        tr.train(lambda: iter(batches), event_handler=handler, log_period=0)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0 - check_s[0]
    counts = ca.launch_counts()
    run = {"losses": losses, "ms_per_step": 1e3 * sec / len(batches),
           "fetches": tr.host_fetches, "launches": counts,
           "samples": samples, "grad_checks": grad_checks, "trainer": tr,
           "records": list(mem.records) if mem is not None else []}
    if hooks:
        tr.telemetry.close()
        run["trace"] = tr.tracer.save(str(out_dir / "trace.json"))
        run["metrics"] = tr.metrics.snapshot()
    del model
    return run


def _obs_overhead(off, on, key):
    """ms with hooks off and on over the ABBA runs, and the share the
    hooks add."""
    a = [r[key] for r in off]
    b = [r[key] for r in on]
    return {f"{key}_off": a, f"{key}_on": b,
            f"hooks_{key}": sum(b) / len(b) - sum(a) / len(a),
            "overhead_share": sum(b) / sum(a) * len(a) / len(b) - 1}


def _obs_train_checks(torch, offs, ons, K, root, label):
    """The gates of one training mode, hooks on against hooks off (the
    first pair; the second pair's losses too)."""
    off, on = offs[0], ons[0]
    if any(r["losses"] != off["losses"] for r in offs + ons):
        raise RuntimeError(f"{label}: losses with hooks "
                           f"{[r['losses'] for r in ons]} != without "
                           f"{[r['losses'] for r in offs]}")
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    if any(on["launches"][n] != off["launches"][n] or
           on["launches"][n] != LOOP_CFG["num_layers"] * OBS_STEPS
           for n in flash):
        raise RuntimeError(f"{label}: flash launches on {on['launches']} "
                           f"off {off['launches']}")
    if on["fetches"] != off["fetches"] or on["fetches"] != OBS_STEPS // K:
        raise RuntimeError(f"{label}: host fetches on {on['fetches']}, off "
                           f"{off['fetches']}")
    steps = [r for r in on["records"] if r["kind"] == "step"]
    if len(steps) != OBS_STEPS // K:
        raise RuntimeError(f"{label}: {len(steps)} step records for "
                           f"{OBS_STEPS // K} calls")
    want = OBS_STEP_KEYS | (OBS_RATE_KEYS if K == 1 else set())
    for r in steps:
        if set(r) != want:
            raise RuntimeError(f"{label}: record keys {sorted(set(r))} != "
                               f"{sorted(want)}")
        if K == 1 and r["est_mfu_pct"] is None:
            raise RuntimeError(f"{label}: est_mfu_pct is None")
    if len(on["samples"]) != len(steps) or any(
            abs(cur - after) > 2 ** 20 for cur, after in on["samples"]):
        raise RuntimeError(f"{label}: bytes_in_use against "
                           f"memory_allocated {on['samples']}")
    if K == 1:
        if len(on["grad_checks"]) != OBS_STEPS or any(
                abs(g - own) > 1e-5 * own for g, own in on["grad_checks"]):
            raise RuntimeError(f"{label}: grad_norm against the gradients' "
                               f"own norm {on['grad_checks']}")
    doc = json.load(open(on["trace"]))
    disp = [e for e in doc["traceEvents"]
            if e.get("ph") == "X" and e["name"] == "dispatch"]
    paired = [e["args"]["batch"] + 1 if K == 1
              else e["args"]["step"] + r["k_steps"]
              for e, r in zip(disp, steps)]
    if len(disp) != len(steps) or paired != [r["step"] for r in steps]:
        raise RuntimeError(f"{label}: dispatch spans {paired} against "
                           f"steps {[r['step'] for r in steps]}")
    report = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.obs.report",
         str(Path(on["trace"]).parent / "run.jsonl")], capture_output=True,
        text=True, cwd=str(root), timeout=300)
    if report.returncode != 0:
        raise RuntimeError(f"{label}: obs.report exited "
                           f"{report.returncode}: {report.stderr[-2000:]}")
    return {**_obs_overhead(offs, ons, "ms_per_step"),
            "fetches": on["fetches"], "records": len(steps),
            "last_record": {k: steps[-1][k] for k in (
                "dispatch_ms", "device_ms", "drain_wait_ms", "stage_ms",
                "overlap_frac", "tokens_per_sec", "est_mfu_pct",
                "bytes_in_use", "peak_bytes", "grad_norm", "update_ratio")
                if k in steps[-1]},
            "report": report.stdout.strip().splitlines()[:12]}


def _obs_serve(torch, pt, obs, ca, model, prompts, mode, hooks):
    """phase 3's 16 requests of 32 tokens through the CUDA graphs, the
    scheduler with every hook on (a router lane stamping submission and
    finish) or all off."""
    kw = {}
    mem = obs.InMemorySink() if hooks else None
    if hooks:
        kw["telemetry"] = obs.Telemetry(sinks=[mem])
    eng = pt.DecodeEngine(model, max_slots=8, block_size=16, **mode, **kw)
    tracer = router = hub = None
    if hooks:
        tracer = obs.Tracer(clock=time.perf_counter)
        router = obs.Tracer(clock=time.perf_counter)
        hub = obs.MetricsHub()
        eng.tracer, eng.metrics = tracer, hub
    eng.warmup()
    sched = pt.ContinuousBatchingScheduler(eng, tracer=tracer, metrics=hub)
    replays0 = eng._tick.replays + eng._prefill.replays
    torch.cuda.synchronize()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = []
    for p in prompts:
        req = sched.submit(p, 32)
        if router is not None:
            router.complete("submit", req.submit_ts * 1e6,
                            flow_start=req.rid, rid=req.rid)
        reqs.append(req)
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ca.launch_counts()
    out = {"tokens": [r.tokens for r in reqs], "launches": counts,
           "replays": eng._tick.replays + eng._prefill.replays - replays0,
           "ticks": eng.ticks, "generated": eng.tokens_generated,
           "ms_per_tick": 1e3 * wall / max(1, eng.ticks), "wall_s": wall,
           "compile_counts": eng.compile_counts(), "reqs": reqs,
           "eng": eng}
    if hooks:
        for r in reqs:
            router.complete("terminal", r.finish_ts * 1e6, flow_end=r.rid,
                            rid=r.rid)
        out.update(records=list(mem.records), hub=hub,
                   trace=obs.merge_fleet_trace(router.events(),
                                               {0: tracer.events()}))
    return out


def _obs_serve_checks(obs, offs, ons, label, spec):
    """The gates of one serving mode, hooks on against hooks off (the
    first pair; the second pair's tokens too)."""
    off, on = offs[0], ons[0]
    if any(r["tokens"] != off["tokens"] for r in offs + ons):
        raise RuntimeError(f"{label}: tokens differ with hooks on")
    if on["replays"] != off["replays"] or on["launches"] != off["launches"] \
            or on["compile_counts"] != off["compile_counts"] \
            or on["compile_counts"] != {"prefill": 1, "tick": 1}:
        raise RuntimeError(f"{label}: replays {on['replays']} / "
                           f"{off['replays']}, launches {on['launches']} / "
                           f"{off['launches']}, compile counts "
                           f"{on['compile_counts']}")
    ticks = [r for r in on["records"] if r["kind"] == "decode_tick"]
    if len(ticks) != on["ticks"] or \
            sum(r["tokens"] for r in ticks) != on["generated"]:
        raise RuntimeError(f"{label}: {len(ticks)} decode_tick records for "
                           f"{on['ticks']} ticks, tokens "
                           f"{sum(r['tokens'] for r in ticks)} against "
                           f"{on['generated']}")
    if any(r["kv_bytes_per_token"] != 24576 for r in ticks):
        raise RuntimeError(f"{label}: kv_bytes_per_token "
                           f"{ticks[0]['kv_bytes_per_token']}")
    recs = [r for r in on["records"] if r["kind"] == "request"]
    own = obs.percentile([(r.first_token_ts - r.submit_ts) * 1e3
                          for r in on["reqs"]], 50)
    summ = obs.summarize_requests(on["records"])
    if len(recs) != len(on["reqs"]) or \
            summ["ttft_ms_p50"] != round(own, 4):
        raise RuntimeError(f"{label}: {len(recs)} request records, TTFT p50 "
                           f"{summ['ttft_ms_p50']} against {own}")
    tr = on["trace"]
    if not obs.lane_monotonic(tr) or not all(
            obs.flow_connected(tr, r.rid) for r in on["reqs"]):
        raise RuntimeError(f"{label}: merged trace not connected or not "
                           f"monotonic")
    if spec:
        if on["launches"]["paged_span"] < 1 or not any(
                r["draft_accept_rate"] is not None for r in ticks) or \
                sum(r["prefill_chunks"] for r in ticks) < 1:
            raise RuntimeError(f"{label}: no span launches, accept rate or "
                               f"chunks in the records")
    slo = obs.SLOMonitor(metrics=on["hub"])
    for r in recs:
        slo.observe(r)
    rows = {r["name"]: r for r in on["hub"].snapshot()}
    return {**_obs_overhead(offs, ons, "ms_per_tick"),
            "ticks": on["ticks"], "replays": on["replays"],
            "ttft_p50_ms": summ["ttft_ms_p50"],
            "tpot_p50_ms": summ["tpot_ms_p50"],
            "draft_accept_rate": summ["draft_accept_rate"],
            "prefill_chunks": summ["prefill_chunks"],
            "engine_ticks": rows["engine_ticks"]["value"],
            "slo": {k: v for k, v in slo.report().items()
                    if k in ("ttft_ms_p50", "tpot_ms_p99", "goodput_pct",
                             "burn_rate")}}


def phase_obs(torch, np, pt, ca, card, prompts):
    """Phase 14: the obs package through the Trainer, the engine and the
    scheduler. Returns the launch counts of its hooked paths."""
    import shutil
    import tempfile
    import paddle_tpu_torch.obs as obs
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    d = Path(tempfile.mkdtemp(prefix=".obs_phase_", dir=root))
    paths, stats = {}, {"card": card}
    try:
        cfg = LOOP_CFG
        V, B, T = cfg["vocab"], LOOP_BATCH, cfg["max_len"]
        gen = torch.Generator(device="cuda").manual_seed(4321)
        start = {k: v.clone() for k, v in pt.TransformerLM(
            **cfg, device="cuda", generator=gen).state_dict().items()}
        inp, tgt, _ = conflicting_pairs(np, B, T, V)
        batches = [{"x": np.roll(inp, i, axis=1), "y": np.roll(tgt, i, axis=1)}
                   for i in range(OBS_STEPS)]
        # (a) training: serial, then 8 steps a call with 3 in flight,
        # after two discarded steps with every hook on, so that no timed
        # run carries a first use (the first health reduces cost ~20 ms a
        # step)
        _obs_train_run(torch, np, pt, obs, ca, start, batches[:2], 1, 1,
                       True, d)
        # each mode runs off, on, on, off (the host's speed drifts within
        # a process; the overhead is taken over both pairs; serving, whose
        # runs are short, twice over)
        for K, W, label in ((1, 1, "train serial"),
                            (OBS_STEPS, 3, "train pipelined")):
            runs = {False: [], True: []}
            for i, hooks in enumerate((False, True, True, False)):
                sub = d / f"{label.replace(' ', '_')}_{i}"
                sub.mkdir()
                runs[hooks].append(_obs_train_run(
                    torch, np, pt, obs, ca, start, batches, K, W, hooks, sub))
            stats[label] = _obs_train_checks(torch, runs[False], runs[True],
                                             K, root, label)
            paths[f"observability {label}"] = runs[True][0]["launches"]
            del runs
            torch.cuda.empty_cache()
        # the poisoned run: a NaN weight in the fourth batch
        poisoned = [dict(b, weight=np.ones((B, T), np.float32))
                    for b in batches]
        poisoned[3]["weight"][0, 0] = np.nan
        sub = d / "poisoned"
        sub.mkdir()
        run = _obs_train_run(torch, np, pt, obs, ca, start, poisoned, 1, 1,
                             True, sub, arm=True)
        steps = [r for r in run["records"] if r["kind"] == "step"]
        det = run["trainer"].anomaly
        if steps[2]["nonfinite_count"] != 0 or \
                not steps[3]["nonfinite_count"] > 0:
            raise RuntimeError(f"poisoned run: nonfinite counts "
                               f"{[r['nonfinite_count'] for r in steps]}")
        if len(det.bundles) != 1 or det.verdicts[0].kind != "nonfinite":
            raise RuntimeError(f"poisoned run: bundles {det.bundles}, "
                               f"verdicts {det.verdicts}")
        prof = Path(det.bundles[0]) / "torch_profile"
        files = sorted(prof.glob("*.json")) if prof.exists() else []
        kernels = sum(1 for f in files for e in json.load(open(f))[
            "traceEvents"] if e.get("cat") == "kernel")
        if not files or kernels < 1:
            raise RuntimeError(f"poisoned run: profiler capture {files} "
                               f"with {kernels} kernel rows")
        stats["poisoned"] = {
            "nonfinite_counts": [r["nonfinite_count"] for r in steps],
            "bundle": Path(det.bundles[0]).name,
            "profiled_steps": [r["step"] for r in steps if r["profiled"]],
            "capture_kernel_rows": kernels,
            "snapshot": json.load(open(Path(det.bundles[0]) /
                                       "snapshot.json"))}
        del run, start
        torch.cuda.empty_cache()
        # (b), (c) serving at the transformer_decode width
        scfg = dict(vocab=V, dim=512, num_layers=6, num_heads=8,
                    ffn_hidden=2048, max_len=1024)
        model = pt.TransformerLM(**scfg, use_flash=True, device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(1234))
        for mode, label in (({}, "greedy"), (OBS_SPEC, "spec chunk")):
            runs = {False: [], True: []}
            for hooks in (False, True, True, False) * 2:
                runs[hooks].append(_obs_serve(torch, pt, obs, ca, model,
                                              prompts, mode, hooks))
            stats[label] = _obs_serve_checks(obs, runs[False], runs[True],
                                             label, bool(mode))
            paths[f"observability {label}"] = runs[True][0]["launches"]
            del runs
        del model
    finally:
        shutil.rmtree(d, ignore_errors=True)
    stats["phase_s"] = time.perf_counter() - t_phase
    log("observability", json.dumps(stats, default=str))
    return paths


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import cuda_attention as ca
    from paddle_tpu_torch.nn import cuda_conv as cc
    from paddle_tpu_torch.nn import fused_ln as fl
    from paddle_tpu_torch.serve import kv_cache as kvc
    from paddle_tpu_torch.utils import cuda_build

    card = gpu_line()
    log(f"gpu: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS would otherwise reduce bf16-output products in bf16; JAX sums
    # them in f32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    log("tf32: matmul off, cudnn off; bf16 reduced-precision reduction: "
        "off")

    t0 = time.perf_counter()
    sources = {**ca.KERNELS, **cc.KERNELS, **fl.KERNELS}
    report = cuda_build.build(sources.values())
    log(f"build: {time.perf_counter() - t0:.2f} s wall")
    for name, rep in report.items():
        log(f"build {name}: {rep['seconds']:.2f} s")
        for line in str(rep["log"]).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {line.strip()}")
    log("flash_fwd ptxas", json.dumps(fwd_registers(
        ca, str(report["flash_fwd"]["log"]))))
    log("flash_bwd ptxas", json.dumps(bwd_registers(
        ca, str(report["flash_bwd"]["log"]))))
    log("conv1x1_dw_bf16 ptxas", json.dumps(dw_bf16_registers(
        str(report["conv1x1_dw_bf16"]["log"]))))
    log("bf16 flash and ln ptxas", json.dumps(bf16_registers(ca, report)))

    gen = torch.Generator(device="cuda").manual_seed(0)
    clock = [time.perf_counter()]
    phase_s = {}

    def lap(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    flash = phase_flash(torch, F, ca, gen)
    lap("flash")
    bwd = phase_flash_bwd(torch, F, ca, gen)
    lap("flash_bwd")
    mma_rate = mma_bf16_rate(torch)
    # the bf16 phases draw from their own generator: the other phases'
    # inputs stay what they were
    gen16 = torch.Generator(device="cuda").manual_seed(14)
    flash16 = phase_flash_bf16(torch, F, ca, gen16, mma_rate)
    lap("flash bf16 kernels")
    flash16_counts = phase_flash_bf16_path(torch, ca, gen16)
    lap("flash bf16 path")
    paged = phase_paged(torch, F, ca, gen)
    lap("paged")
    span = phase_span_kernels(torch, F, ca, kvc, gen, card)
    lap("span kernels")
    half = phase_paged_bf16(torch, F, ca, kvc, gen, card)
    lap("bf16 paged kernels")
    serve_counts, model, ref, prompts, tokens = phase_slice(torch, np, pt)
    lap("slice")
    span_counts = phase_span_serving(torch, np, pt, ca, model, ref, prompts,
                                     tokens, card)
    lap("span serving")
    dense_rows = []
    graph_counts = phase_graph_serving(torch, np, pt, ca, model, prompts,
                                       card, rows=dense_rows)
    lap("graph serving")
    with pt.use_policy(pt.bfloat16_compute):
        # greedy, and both bf16-pool modes, under the policy
        graph_bf16_counts = phase_graph_serving(
            torch, np, pt, ca, model, prompts, card, GRAPH_MODES[:3],
            " bf16")
    lap("graph serving bf16")
    handoff_counts = phase_handoff(torch, np, pt, ca, kvc, model, prompts,
                                   card)
    lap("handoff")
    del model, ref
    train_counts = phase_train(torch, np, pt, pt.float32)
    lap("training")
    train_bf16_counts = phase_train(torch, np, pt, pt.bfloat16_compute)
    lap("training bf16")
    loop_counts = phase_train_loop(torch, np, pt, card)
    lap("train loop")
    dw = phase_conv_kernels(torch, cc, gen)
    lap("conv kernels")
    dw_bf16 = phase_conv_bf16_kernels(torch, cc, gen, mma_rate)
    lap("conv bf16 kernels")
    ln_rows, ln_counts = phase_ln_kernels(torch, F, fl, gen)
    lap("ln kernels")
    ln16_rows, ln16_counts = phase_ln_bf16_kernels(torch, F, fl, gen16,
                                                   mma_rate)
    lap("ln bf16 kernels")
    resnet_counts = phase_resnet(torch, np, pt, cc, card, pt.float32)
    lap("resnet")
    resnet_bf16_counts = phase_resnet(torch, np, pt, cc, card,
                                      pt.bfloat16_compute)
    lap("resnet bf16")
    obs_paths = phase_obs(torch, np, pt, ca, card, prompts)
    lap("observability")
    # last: its profiled windows (a training call's, the serving ticks')
    # are followed by no window that counts records (the kernel phases'
    # device_ms), which a large window before them has made drop records
    moe_paths, moe_rows = phase_moe(torch, np, pt, ca, card)
    log("moe serving against dense", json.dumps({
        m["mode"]: {"moe": serving_summary(m), "dense": serving_summary(d)}
        for m in moe_rows for d in dense_rows if d["mode"] == m["mode"]}))
    lap("moe")
    paths = {"serving": serve_counts, "span serving": span_counts,
             "graph serving": graph_counts,
             "graph serving bf16": graph_bf16_counts,
             "handoff": handoff_counts,
             "training": train_counts, "training bf16": train_bf16_counts,
             "train loop bf16": loop_counts,
             "resnet training": resnet_counts,
             "resnet training bf16": resnet_bf16_counts,
             "fused_ln_matmul": ln_counts,
             "flash_attention bf16": flash16_counts,
             "fused_ln_matmul bf16": ln16_counts, **obs_paths,
             **moe_paths}
    counts = {}
    for path in paths.values():
        for n, c in path.items():
            counts[n] = counts.get(n, 0) + c
    log("launches", json.dumps(paths))
    log("phase seconds", json.dumps(phase_s))

    def entry(name, row, err):
        return {"name": name, "route": "cuda",
                "source": f"paddle_tpu_torch/csrc/{sources[name]}.cu",
                "replaces": REPLACES[name], "launches": counts[name],
                "max_abs_err": err, "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "cuda_core_bound_ms": row.get("cuda_core_bound_ms",
                                              row["bound_ms"]),
                "library_ms": row["library_ms"],
                **{k: row[k] for k in ("device_ms", "library_device_ms",
                                       "mma_sync_bound_ms", "f32_kernel_ms")
                   if k in row}}

    kernels = [entry("flash_fwd", flash[0],
                     max(r["max_abs_err"] for r in flash)),
               entry("paged_decode", paged, paged["max_abs_err"])]
    # the backward kernels at the training shape as the training path
    # launches them (dk/dv storing ds, dq from it); errors over every case
    # and both ways of each kernel
    kernels += [entry(name, main_path_row(bwd[0], name),
                      max(row["max_abs_err"] for rows in bwd
                          for (n, _), row in rows.items() if n == name))
                for name in ("flash_bwd_dq", "flash_bwd_dkv")]
    # the span kernels at the speculative shape, errors over both shapes
    kernels += [entry(name, span[name, "spec [8,5,8,64]"],
                      max(span[name, c]["max_abs_err"]
                          for c in ("spec [8,5,8,64]", "chunk [1,128,8,64]")))
                for name in ("paged_span", "paged_span_int8")]
    kernels.append(entry("paged_decode_int8", span["paged_decode_int8"],
                         span["paged_decode_int8"]["max_abs_err"]))
    # the bf16 branches: decode at phase 2's lengths, the span at the
    # speculative shape, D 64; errors over every case of each
    for name, label in (("paged_decode_bf16",
                         next(lb for n, lb in half if n ==
                              "paged_decode_bf16")),
                        ("paged_span_bf16", "spec [8,5,8,64]")):
        kernels.append(entry(name, half[name, label], max(
            r["max_abs_err"] for (n, _), r in half.items() if n == name)))
    # conv1x1_dw and conv1x1_dw_bf16: summed over one ResNet-50 step's 36
    # launches
    kernels.append(entry("conv1x1_dw", dw, dw["max_abs_err"]))
    kernels.append(entry("conv1x1_dw_bf16", dw_bf16, dw_bf16["max_abs_err"]))
    # ln_matmul at the wider shape with scale and bias, errors over all
    kernels.append(entry("ln_matmul", ln_rows[2048, True],
                         max(r["max_abs_err"] for r in ln_rows.values())))
    # the bf16 branches: the flash kernels at the training shape (the
    # backward's two as flash_attention_bwd launches them), ln_matmul_bf16
    # at the wider shape with scale and bias; errors over every case
    train16 = FLASH_BF16_CASES[0][0]
    kernels += [entry(name, flash16[name, train16], max(
        r["max_abs_err"] for (n, _), r in flash16.items() if n == name))
        for name in ("flash_fwd_bf16", "flash_bwd_dq_bf16",
                     "flash_bwd_dkv_bf16", "flash_bwd_delta_bf16")]
    kernels.append(entry("ln_matmul_bf16", ln16_rows[2048, True],
                         max(r["max_abs_err"] for r in ln16_rows.values())))
    for k in kernels:
        if k["launches"] < 1:
            raise RuntimeError(f"{k['name']} never launched on the path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
