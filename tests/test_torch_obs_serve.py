"""The port's engine and scheduler with the obs hooks against the JAX
engine and scheduler (CPU, a fake clock; the JAX engine runs on copied
operands: it bumps host arrays a dispatched call may still read). A
TransformerLM of vocab 64, dim 32, 2 layers, 4 heads on bridged weights
serves the same requests, greedy, plain and with ``speculative=2,
prefill_chunk=4``, colocated and split into prefill and decode roles.

Held equal: the ``decode_tick`` records field by field apart from the
wall times, the ``request`` records apart from the timings, the
``evict`` records, the metric counters and gauges, the span names and
arguments in order, the ``serve_warmup`` compile record's keys. With the
hooks on, the port's tokens, compile counts and kernel calls are those
of the hooks off."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import paddle_tpu.obs as jobs
import paddle_tpu_torch.obs as tobs
from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.serve import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serve import DecodeEngine as JDecodeEngine
from paddle_tpu_torch import (ContinuousBatchingScheduler, DecodeEngine,
                              TransformerLM, load_jax_params)
from paddle_tpu_torch.nn import cuda_attention as ca

V, W, DIM, LAYERS, HEADS, FFN = 64, 32, 32, 2, 4, 64
BS = 4
TIMINGS = ("ttft_ms", "tpot_ms", "wall_ms")


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def models():
    jm = JTransformerLM(vocab=V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                        ffn_hidden=FFN, max_len=W, use_flash=True)
    vs = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, W), jnp.int32))
    tm = TransformerLM(V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                       ffn_hidden=FFN, max_len=W, use_flash=True,
                       device="cpu")
    load_jax_params(tm, vs)
    return jm, vs, tm


def _requests(seed=0, n=6):
    rng = np.random.RandomState(seed)
    shared = [int(t) for t in rng.randint(1, V, 8)]
    out = []
    for i in range(n):
        p = [int(t) for t in rng.randint(1, V, 3 + 2 * i)]
        if i in (1, 3):
            p = shared + p[:2]            # a shared 8-token prefix
        out.append((p, 3 + i % 4))
    return out


def _jax_engine(jm, vs, **kw):
    eng = JDecodeEngine(jm, vs, max_slots=2, block_size=BS,
                        attention="xla", **kw)
    jc = eng.cache
    jc.device_tables = lambda jc=jc: (
        jnp.array(np.copy(jc.tables)), jnp.array(np.copy(jc.lengths)))
    return eng


def _serve(side, models, hooks=True, engine_kw=None, sched_kw=None,
           deadlines=None, warm=True):
    jm, vs, tm = models
    mod = jobs if side == "jax" else tobs
    clock = FakeClock()
    mem = mod.InMemorySink()
    tel = mod.Telemetry(sinks=[mem]) if hooks else None
    tracer = mod.Tracer(clock=clock) if hooks else None
    hub = mod.MetricsHub(clock=clock) if hooks else None
    ekw = dict(engine_kw or {})
    if side == "jax":
        eng = _jax_engine(jm, vs, telemetry=tel, **ekw)
    else:
        eng = DecodeEngine(tm, max_slots=2, block_size=BS, device="cpu",
                           telemetry=tel, **ekw)
    eng.tracer, eng.metrics = tracer, hub
    if warm:
        eng.warmup()
    cls = JScheduler if side == "jax" else ContinuousBatchingScheduler
    sched = cls(eng, clock=clock, tracer=tracer, metrics=hub,
                **(sched_kw or {}))
    reqs = []
    for i, (p, m) in enumerate(_requests()):
        d = None if deadlines is None else deadlines[i]
        reqs.append(sched.submit(p, m, deadline_s=d))
        clock.t += 0.25
    while sched.step():
        clock.t += 1.0
    return {"eng": eng, "sched": sched, "recs": mem.records,
            "tracer": tracer, "hub": hub, "reqs": reqs}


def _spans(tracer):
    return [(e["name"], e.get("args", {})) for e in tracer.events()
            if e["ph"] in ("X", "i")]


def _flows(tracer):
    return [(e["ph"], e["id"]) for e in tracer.events()
            if e.get("cat") == "flow"]


MODES = {"greedy": {}, "spec_chunk": {"speculative": 2, "prefill_chunk": 4}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_records_spans_and_metrics_match_jax(models, mode):
    runs = {side: _serve(side, models, engine_kw=MODES[mode])
            for side in ("jax", "torch")}
    j, t = runs["jax"], runs["torch"]
    assert [r.tokens for r in t["reqs"]] == [r.tokens for r in j["reqs"]]
    assert [r["kind"] for r in t["recs"]] == [r["kind"] for r in j["recs"]]
    # serve_warmup: the same keys; no autotuner or program cache here
    (jw,), (tw,) = [[r for r in x["recs"] if r["kind"] == "compile"]
                    for x in (j, t)]
    assert set(tw) == set(jw) and tw["fingerprint"] == "serve_warmup"
    assert tw["cache_hit"] is None and tw["autotune_trials"] is None
    ticks = [[r for r in x["recs"] if r["kind"] == "decode_tick"]
             for x in (j, t)]
    assert len(ticks[1]) == t["eng"].ticks == j["eng"].ticks
    for jr, tr in zip(*ticks):
        assert set(tr) == set(jr)
        for key in jr:
            if key not in ("ts", "wall_ms", "tokens_per_sec"):
                assert tr[key] == jr[key], key
    assert sum(r["tokens"] for r in ticks[1]) == \
        t["eng"].tokens_generated
    if mode == "spec_chunk":
        assert any(r["draft_accept_rate"] is not None for r in ticks[1])
        assert sum(r["prefill_chunks"] for r in ticks[1]) > 0
    reqs = [[r for r in x["recs"] if r["kind"] == "request"]
            for x in (j, t)]
    assert len(reqs[1]) == len(_requests())
    for jr, tr in zip(*reqs):
        assert set(tr) == set(jr)
        assert {k: v for k, v in tr.items() if k not in TIMINGS + ("ts",)} \
            == {k: v for k, v in jr.items() if k not in TIMINGS + ("ts",)}
    assert _spans(t["tracer"]) == _spans(j["tracer"])
    assert _flows(t["tracer"]) == _flows(j["tracer"])

    def metric_rows(hub):
        return sorted((r["name"], tuple(sorted(r["labels"].items())),
                       r.get("value"), r.get("count"))
                      for r in hub.snapshot() if r["name"] != "engine_tick_ms")

    assert metric_rows(t["hub"]) == metric_rows(j["hub"])
    assert {r["name"]: r["count"] for r in t["hub"].snapshot()
            if r["name"] == "engine_tick_ms"} == \
        {r["name"]: r["count"] for r in j["hub"].snapshot()
         if r["name"] == "engine_tick_ms"}


def test_deadline_evictions_match_jax(models):
    """Running, prefilling and queued requests past their deadlines: the
    same ``evict`` records, finish reasons and eviction counters."""
    deadlines = [None, 2.0, 0.5, None, 1.0, 0.2]
    runs = {side: _serve(side, models, engine_kw={"prefill_chunk": 4},
                         deadlines=deadlines)
            for side in ("jax", "torch")}
    ev = [[{k: v for k, v in r.items() if k != "ts"}
           for r in x["recs"] if r["kind"] == "evict"]
          for x in (runs["jax"], runs["torch"])]
    assert ev[1] == ev[0] and ev[1]
    assert [r.finish_reason for r in runs["torch"]["reqs"]] == \
        [r.finish_reason for r in runs["jax"]["reqs"]]
    rows = [sorted((r["name"], tuple(sorted(r["labels"].items())),
                    r["value"]) for r in x["hub"].snapshot()
                   if r["name"].startswith("sched_"))
            for x in (runs["jax"], runs["torch"])]
    assert rows[1] == rows[0]


def test_handoff_spans_match_jax(models):
    """A prefill scheduler hands each request to a decode scheduler: the
    ``handoff_out`` and ``adopt`` spans, and the decode side's request
    records, as JAX's."""
    out = {}
    for side in ("jax", "torch"):
        jm, vs, tm = models
        mod = jobs if side == "jax" else tobs
        clock = FakeClock()
        tracer = mod.Tracer(clock=clock)
        mem = mod.InMemorySink()
        tel = mod.Telemetry(sinks=[mem])
        if side == "jax":
            engs = [_jax_engine(jm, vs) for _ in range(2)]
            cls = JScheduler
        else:
            engs = [DecodeEngine(tm, max_slots=2, block_size=BS,
                                 device="cpu") for _ in range(2)]
            cls = ContinuousBatchingScheduler
        pre = cls(engs[0], clock=clock, tracer=tracer, role="prefill")
        dec = cls(engs[1], telemetry=tel, clock=clock, tracer=tracer,
                  role="decode")
        for p, m in _requests()[:4]:
            pre.submit(p, m)
        waiting = []
        for _ in range(60):
            busy = pre.step()
            waiting += pre.pop_handoffs()
            while waiting and dec.adopt(*waiting[0][1:]) is not None:
                waiting.pop(0)
            busy = dec.step() or busy or bool(waiting)
            clock.t += 1.0
            if not busy:
                break
        assert not waiting and len(dec.completed) == 4
        out[side] = (_spans(tracer), _flows(tracer),
                     [{k: v for k, v in r.items()
                       if k not in TIMINGS + ("ts",)}
                      for r in mem.records if r["kind"] == "request"])
    assert out["torch"] == out["jax"]
    assert any(n == "handoff_out" for n, _ in out["torch"][0])
    assert any(n == "adopt" for n, _ in out["torch"][0])


@pytest.mark.parametrize("mode", sorted(MODES))
def test_hooks_do_not_change_tokens_or_kernel_calls(models, mode,
                                                    monkeypatch):
    calls = {"decode": 0, "span": 0, "fwd": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ca, "paged_decode_plain",
                        counted("decode", ca.paged_decode_plain))
    monkeypatch.setattr(ca, "paged_span_plain",
                        counted("span", ca.paged_span_plain))
    monkeypatch.setattr(ca, "flash_attention_plain",
                        counted("fwd", ca.flash_attention_plain))
    got = {}
    for hooks in (False, True):
        for k in calls:
            calls[k] = 0
        r = _serve("torch", models, hooks=hooks, engine_kw=MODES[mode])
        got[hooks] = ([q.tokens for q in r["reqs"]],
                      r["eng"].compile_counts(), dict(calls))
    assert got[True] == got[False]
    assert sum(got[True][2].values()) > 0


def test_merged_trace_with_a_router_lane_is_connected(models):
    """The scheduler's spans carry the request id as their flow step; a
    router lane stamping each request's submission (flow start) and
    finish (flow end) on the same clock merges with it into a trace whose
    every request flow is connected and whose lanes are monotonic."""
    clock = FakeClock()
    tracer = tobs.Tracer(clock=clock)
    router = tobs.Tracer(clock=clock)
    jm, vs, tm = models
    eng = DecodeEngine(tm, max_slots=2, block_size=BS, device="cpu")
    eng.tracer = tracer
    sched = ContinuousBatchingScheduler(eng, clock=clock, tracer=tracer)
    reqs = []
    for p, m in _requests():
        req = sched.submit(p, m)
        router.complete("submit", req.submit_ts * 1e6, flow_start=req.rid,
                        rid=req.rid)
        reqs.append(req)
        clock.t += 0.25
    while sched.step():
        clock.t += 1.0
    for req in reqs:
        router.complete("terminal", req.finish_ts * 1e6, flow_end=req.rid,
                        rid=req.rid)
    trace = tobs.merge_fleet_trace(router.events(), {0: tracer.events()})
    assert all(tobs.flow_connected(trace, r.rid) for r in reqs)
    assert tobs.lane_monotonic(trace)
    slo = tobs.SLOMonitor()
    for r in reqs:
        slo.observe(r.record())
    ttft = [r.ttft_ms for r in reqs]
    assert slo.report()["requests"] == len(reqs)
    assert tobs.summarize_requests([r.record() for r in reqs])[
        "ttft_ms_p50"] == round(tobs.percentile(ttft, 50), 4)
