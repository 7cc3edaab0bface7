#!/usr/bin/env python3
"""What each observability hook costs the ``prep_transformer`` training
step (``chip_smoke.py``'s phase 12 configuration: dim 512, 6 layers, 4
heads, vocab 32000, batch 8 x 2048, ``adam(1e-4)``, ``bfloat16_compute``,
the serial loop).

    python3 tools/obs_overhead.py

Times 8 steps with the hooks off, all on, and each alone (the health
scalars, the memory sample, the fence, a bare record, the tracer), in
three rounds whose order alternates, after one discarded run; then the
host time of one health computation over the model's parameters, of one
step record and of one memory sample. Prints JSON lines: ms a step of
every run, the last record's breakdown per variant, and the host costs.
Needs a card; builds the attention kernels first.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.obs as obs
    from paddle_tpu_torch.nn import cuda_attention as ca
    from paddle_tpu_torch.obs.health import health_scalars
    from paddle_tpu_torch.utils import cuda_build

    card = cs.gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
        False
    cuda_build.build(ca.KERNELS.values())
    cfg = cs.LOOP_CFG
    V, B, T = cfg["vocab"], cs.LOOP_BATCH, cfg["max_len"]
    gen = torch.Generator(device="cuda").manual_seed(4321)
    start = {k: v.clone() for k, v in pt.TransformerLM(
        **cfg, device="cuda", generator=gen).state_dict().items()}
    inp, tgt, _ = cs.conflicting_pairs(np, B, T, V)
    batches = [{"x": np.roll(inp, i, axis=1), "y": np.roll(tgt, i, axis=1)}
               for i in range(8)]
    model = pt.TransformerLM(**cfg, device="cuda")

    def loss_fn(out, b):
        return pt.softmax_cross_entropy(out.reshape(-1, V),
                                        b["y"].reshape(-1)).reshape(
            b["y"].shape)

    def tel(**kw):
        return {"telemetry": obs.Telemetry(sinks=[obs.InMemorySink()],
                                           **kw)}

    variants = {
        "off": lambda: {},
        "all": lambda: dict(**tel(flops_per_step=1e12,
                                  tokens_per_step=B * T),
                            tracer=obs.Tracer(), metrics=obs.MetricsHub()),
        "health": lambda: tel(health=True, memory=False, fence=False),
        "memory": lambda: tel(health=False, memory=True, fence=False),
        "fence": lambda: tel(health=False, memory=False, fence=True),
        "bare": lambda: tel(health=False, memory=False, fence=False),
        "tracer": lambda: {"tracer": obs.Tracer()},
    }

    def run(name):
        model.load_state_dict(start)
        tr = pt.Trainer(model, loss_fn, pt.adam(1e-4), device="cuda",
                        **variants[name]())
        tr.init()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with pt.use_policy(pt.bfloat16_compute):
            tr.train(lambda: iter(batches), log_period=0)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / len(batches)
        last = {}
        if tr.telemetry is not None:
            steps = [r for r in tr.telemetry.sinks[0].records
                     if r["kind"] == "step"]
            last = {k: steps[-1][k] for k in ("dispatch_ms", "device_ms",
                                              "shard_ms")}
        return ms, last

    run("off")
    res = {k: [] for k in variants}
    order = list(variants)
    for rnd in range(3):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            res[name].append(run(name))
    print(json.dumps({"card": card, "ms_per_step": {
        k: [m for m, _ in v] for k, v in res.items()}}))
    print(json.dumps({"last_record": {k: v[-1][1] for k, v in res.items()}}))

    params = dict(model.named_parameters())
    grads = {n: torch.randn_like(p) for n, p in params.items()}
    loss = torch.ones((), device="cuda")
    n = 20
    for _ in range(3):
        health_scalars(grads, grads, params, loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        health_scalars(grads, grads, params, loss)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    telemetry = obs.Telemetry(sinks=[obs.InMemorySink()],
                              flops_per_step=1e12, tokens_per_step=B * T)
    for _ in range(n):
        telemetry.emit_step({"k_steps": 1, "dispatch_ms": 90.0,
                             "device_ms": 1.0})
    t3 = time.perf_counter()
    for _ in range(n):
        obs.device_memory_stats()
    t4 = time.perf_counter()
    print(json.dumps({"host_ms": {
        "health_launch": 1e3 * (t1 - t0) / n,
        "health_total": 1e3 * (t2 - t0) / n,
        "emit_step": 1e3 * (t3 - t2) / n,
        "memory_stats": 1e3 * (t4 - t3) / n}, "parameters": len(params)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
