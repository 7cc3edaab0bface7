"""The obs package on the card: the fence waits on the compute stream and
not on a side stream; the memory sample is the allocator's counter and the
card's total memory; the card's peak FLOPs; a small ``TransformerLM``'s
Trainer (serial, grouped, pipelined) and graph serving with every hook on
against every hook off: the same losses, tokens, launches, replays and loss
fetches, the health in the same fetch, records with the card's memory and
MFU, and no CUDA event recorded by the loop without hooks.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one;
run them on the card with ``python -m pytest --noconftest -q
tests/test_torch_obs_cuda.py``."""

import time

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_fence_waits_on_the_compute_stream_only(card):
    from paddle_tpu_torch.obs import fence
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e9))             # ~1 s on the side stream
    t0 = time.perf_counter()
    fence(card)
    waited = time.perf_counter() - t0
    assert waited < 0.2 and not side.query()
    torch.cuda._sleep(int(2e8))                 # on the compute stream
    fence(card)
    assert torch.cuda.current_stream().query()
    side.synchronize()


def test_memory_stats_and_peak_flops_of_the_card(card):
    from paddle_tpu_torch.obs import (PEAK_FLOPS, Telemetry,
                                      device_memory_stats, device_peak_flops)
    x = torch.empty(64 << 20, dtype=torch.uint8, device=card)
    stats = device_memory_stats()
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated()
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"] >= x.numel()
    assert stats["bytes_limit"] == \
        torch.cuda.get_device_properties(0).total_memory
    assert device_peak_flops() == PEAK_FLOPS.get(torch.cuda.get_device_name())
    rec = Telemetry().emit_step({"k_steps": 1, "dispatch_ms": 1.0,
                                 "device_ms": 1.0})
    assert abs(rec["bytes_in_use"] - torch.cuda.memory_allocated()) < 2 ** 20
    del x


def _trainer(hooks, **kw):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import obs
    gen = torch.Generator(device="cuda").manual_seed(3)
    model = pt.TransformerLM(97, dim=128, num_layers=2, num_heads=2,
                             ffn_hidden=128, max_len=128, use_flash=True,
                             device="cuda", generator=gen)
    mem = obs.InMemorySink()
    if hooks:
        kw.update(telemetry=obs.Telemetry(sinks=[mem], flops_per_step=1e9,
                                          tokens_per_step=512),
                  tracer=obs.Tracer(), metrics=obs.MetricsHub())
    tr = pt.Trainer(model, lambda out, b: pt.softmax_cross_entropy(
        out.reshape(-1, 97), b["y"].reshape(-1)), pt.adam(1e-3),
        device="cuda", **kw)
    tr.init()
    return tr, mem


@pytest.mark.parametrize("K,W", [(1, 1), (1, 3), (2, 1), (3, 2)])
def test_trainer_hooks_on_the_card(card, K, W, monkeypatch):
    from paddle_tpu_torch.nn import cuda_attention as ca
    rng = np.random.RandomState(0)
    batches = [{"x": rng.randint(0, 97, (4, 128)).astype(np.int32),
                "y": rng.randint(0, 97, (4, 128)).astype(np.int32)}
               for _ in range(6)]
    events = {"n": 0}
    record = torch.cuda.Event.record

    def counted(self, *a, **k):
        events["n"] += 1
        return record(self, *a, **k)

    monkeypatch.setattr(torch.cuda.Event, "record", counted)
    runs = {}
    for hooks in (False, True):
        tr, mem = _trainer(hooks, steps_per_call=K, pipeline_depth=W)
        costs = []
        events["n"] = 0
        ca.reset_launch_counts()
        tr.train(lambda: iter(batches), log_period=0,
                 event_handler=lambda e: costs.append(e.cost)
                 if type(e).__name__ == "EndIteration" else None)
        torch.cuda.synchronize()
        runs[hooks] = (costs, ca.launch_counts(), tr.host_fetches,
                       events["n"], mem.records)
    off, on = runs[False], runs[True]
    assert on[0] == off[0] and on[1] == off[1] and on[2] == off[2]
    # without hooks only the stager's copy events (one a call)
    assert off[3] == (len(batches) // K if (W > 1 and K > 1) else 0)
    steps = [r for r in on[4] if r["kind"] == "step"]
    assert len(steps) == on[2]
    for r in steps:
        assert r["bytes_in_use"] is not None and r["grad_norm"] > 0
        assert r["nonfinite_count"] == 0
        assert (r.get("est_mfu_pct") is not None) == \
            (r["device_ms"] is not None)


def test_graph_serving_hooks_on_the_card(card):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import obs
    from paddle_tpu_torch.nn import cuda_attention as ca
    gen = torch.Generator(device="cuda").manual_seed(5)
    model = pt.TransformerLM(97, dim=128, num_layers=2, num_heads=2,
                             ffn_hidden=128, max_len=128, use_flash=True,
                             device="cuda", generator=gen)
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, 97, n)]
               for n in (5, 17, 33, 9, 40, 12)]
    got = {}
    for hooks in (False, True):
        mem = obs.InMemorySink()
        eng = pt.DecodeEngine(model, max_slots=4, block_size=16,
                              speculative=2, prefill_chunk=16,
                              telemetry=obs.Telemetry(sinks=[mem])
                              if hooks else None)
        if hooks:
            eng.tracer = obs.Tracer(clock=time.perf_counter)
            eng.metrics = obs.MetricsHub()
        eng.warmup()
        sched = pt.ContinuousBatchingScheduler(eng, tracer=eng.tracer,
                                               metrics=eng.metrics)
        ca.reset_launch_counts()
        reqs = [sched.submit(p, 8) for p in prompts]
        sched.run()
        ticks = [r for r in mem.records if r["kind"] == "decode_tick"]
        got[hooks] = ([r.tokens for r in reqs], ca.launch_counts(),
                      eng._tick.replays, eng._prefill.replays,
                      eng.compile_counts(), len(ticks) == eng.ticks)
    assert got[True][:5] == got[False][:5]
    assert got[True][5]
