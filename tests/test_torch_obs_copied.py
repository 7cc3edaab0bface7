"""The framework-free modules of the port's ``obs`` package against the
JAX package's: sinks, percentiles (P² streams, request and hand-off
summaries), metrics (counters, gauges, histogram buckets, exposition
text, delta drain and absorb), the SLO monitor's gauges, the fleet-trace
merge and its checks, the anomaly detector's verdicts and bundles, the
run report, the ``top`` dashboard, the tracer and the host heartbeats.
The same streams go through both; the outputs must be equal."""

import json
import logging
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu.obs as jobs
import paddle_tpu_torch.obs as tobs
from paddle_tpu.obs import anomaly as janomaly
from paddle_tpu.obs import fleet_trace as jfleet
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import report as jreport
from paddle_tpu.obs import slo as jslo
from paddle_tpu.obs import top as jtop
from paddle_tpu.parallel import multihost as jmh
from paddle_tpu_torch.obs import anomaly as tanomaly
from paddle_tpu_torch.obs import fleet_trace as tfleet
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import report as treport
from paddle_tpu_torch.obs import slo as tslo
from paddle_tpu_torch.obs import top as ttop
from paddle_tpu_torch.parallel import multihost as tmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ticking_hub(mod, retention=512):
    """A hub on a fake clock advancing 1 s a stamp."""
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    return mod.MetricsHub(clock=clock, retention=retention)


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

def test_jsonl_sink_rotation_same_files_as_jax(tmp_path):
    """JsonlSink(max_bytes=) rotates to ``<path>.1`` at the same records
    in both frameworks: the live and rotated files are byte-equal."""
    rec = {"kind": "step", "i": 0, "pad": "x" * 80}
    line_len = len(json.dumps(rec)) + 1
    files = {}
    for name, mod in (("jax", jobs), ("torch", tobs)):
        path = str(tmp_path / f"{name}.jsonl")
        sink = mod.JsonlSink(path, max_bytes=4 * line_len)
        for i in range(11):
            sink.emit({**rec, "i": i})
        sink.close()
        sink2 = mod.JsonlSink(path, max_bytes=4 * line_len)
        for i in range(11, 17):
            sink2.emit({**rec, "i": i})
        sink2.close()
        files[name] = (open(path).read(), open(path + ".1").read(),
                       sink.rotations + sink2.rotations)
        assert os.path.getsize(path) <= 4 * line_len
    assert files["torch"] == files["jax"]
    window = [r["i"] for r in
              tobs.JsonlSink.read(str(tmp_path / "torch.jsonl.1"))
              + tobs.JsonlSink.read(str(tmp_path / "torch.jsonl"))]
    assert window == list(range(17 - len(window), 17))


def test_jsonl_sink_oversized_record_and_thread_safety(tmp_path):
    path = str(tmp_path / "big.jsonl")
    sink = tobs.JsonlSink(path, max_bytes=16)
    sink.emit({"kind": "step", "pad": "y" * 100})   # one line > max_bytes
    sink.close()
    assert len(tobs.JsonlSink.read(path)) == 1
    path = str(tmp_path / "conc.jsonl")
    mem, jsonl = tobs.InMemorySink(), tobs.JsonlSink(path)

    def worker(tid):
        for i in range(200):
            rec = {"kind": "step", "tid": tid, "i": i, "pad": "x" * 200}
            mem.emit(rec)
            jsonl.emit(rec)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    jsonl.close()
    lines = [json.loads(line) for line in open(path) if line.strip()]
    assert len(mem.records) == len(lines) == 1600
    for tid in range(8):
        assert [r["i"] for r in lines if r["tid"] == tid] == \
            list(range(200))


def test_logging_sink_emits(caplog):
    sink = tobs.LoggingSink(level=logging.INFO)
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.telemetry"):
        sink.emit({"kind": "step", "step": 3, "dispatch_ms": 1.25,
                   "grad_norm": 0.5})
        sink.emit({"kind": "compile", "compile_count": 1, "wall_s": 0.1,
                   "hlo_flops": None, "fingerprint": "fp"})
    assert "step=3" in caplog.text and "compile" in caplog.text


# ---------------------------------------------------------------------------
# percentiles
# ---------------------------------------------------------------------------

def _streams():
    rng = np.random.RandomState(0)
    return {
        "constant": [7.25] * 100,
        "alternation": [float(i % 2) for i in range(1000)],
        "ramp_up": [float(i) for i in range(1, 1001)],
        "ramp_down": [float(i) for i in range(1000, 0, -1)],
        "lognormal": [float(v) for v in rng.lognormal(1.5, 1.5, 2000)],
        "five_sample": [5.0, 1.0, 4.0, 2.0, 3.0, 6.0, 0.5],
        "short": [3.0, 1.0],
    }


@pytest.mark.parametrize("stream", sorted(_streams()))
def test_p2_quantile_streams_equal_jax(stream):
    """Every prefix of each stream gives the same P² estimate (bit for
    bit) in both frameworks, and the same nearest-rank percentile."""
    vals = _streams()[stream]
    for p in (50, 95, 99):
        a, b = jobs.P2Quantile(p), tobs.P2Quantile(p)
        for i, v in enumerate(vals):
            a.observe(v)
            b.observe(v)
            if i < 10 or i % 97 == 0:
                assert a.value() == b.value()
        assert a.value() == b.value()
        assert tobs.percentile(vals, p) == jobs.percentile(vals, p)


def _request_stream(seed=0, n=60):
    rng = np.random.RandomState(seed)
    reasons = ["length", "eos", "timeout", "shed", "retried"]
    out = []
    for i in range(n):
        r = reasons[rng.randint(len(reasons))]
        out.append({
            "kind": "request", "rid": i, "finish_reason": r,
            "ttft_ms": float(rng.uniform(1, 100)),
            "tpot_ms": float(rng.uniform(1, 10)) if r != "shed" else None,
            "wall_ms": float(rng.uniform(10, 900)) if r != "shed" else 0.0,
            "new_tokens": int(rng.randint(0, 64)),
            "deadline_s": 0.5 if rng.rand() < 0.5 else None,
            "prefix_hit_blocks": int(rng.randint(0, 4)),
            "blocks_reserved": int(rng.randint(1, 9)),
            "cow_forks": int(rng.randint(0, 2)),
            "prefill_chunks": int(rng.randint(1, 5)),
            "draft_proposed": int(rng.randint(0, 40)),
            "draft_accepted": int(rng.randint(0, 20))})
        if i % 3 == 0:
            out.append({"kind": "decode_tick", "tick": i,
                        "retained_hits": int(rng.randint(0, 2)),
                        "prefix_hit_blocks": int(rng.randint(0, 3)),
                        "retained_blocks": i, "kv_bytes_per_token": 24576,
                        "quant_dtype": "float32", "tp_degree": 1})
        if i % 7 == 0:
            out.append({"kind": "kv_handoff", "wire_bytes": 4096 * i,
                        "blocks": i % 5, "transfer_ms": 0.1 * i,
                        "quant": "int8" if i % 2 else "float32"})
            out.append({"kind": "scale", "direction": "up" if i % 2
                        else "down", "reason": "burn", "replicas": i % 4})
    return out


def test_request_handoff_scale_summaries_equal_jax():
    recs = _request_stream()
    assert tobs.summarize_requests(recs) == jobs.summarize_requests(recs)
    assert tobs.summarize_handoffs(recs) == jobs.summarize_handoffs(recs)
    assert tobs.summarize_scale(recs) == jobs.summarize_scale(recs)
    assert tobs.summarize_requests([]) is None
    assert tobs.GOODPUT_REASONS == jobs.GOODPUT_REASONS


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_counter_gauge_ring_labels_scopes():
    hub = _ticking_hub(tmetrics)
    c = hub.counter("requests", "total requests")
    c.inc()
    c.inc(4)
    with pytest.raises(ValueError):
        c.inc(-1)
    c.inc(0)
    assert c.value == 5.0 and len(c.samples()) == 2
    g = hub.gauge("depth", "queue depth")
    assert g.value is None
    g.set(3)
    g.inc(2)
    g.dec()
    assert [v for _, v in g.samples()] == [3.0, 5.0, 4.0]
    ring = _ticking_hub(tmetrics, retention=4).counter("ticks")
    for _ in range(7):
        ring.inc()
    assert [v for _, v in ring.samples()] == [4.0, 5.0, 6.0, 7.0]
    a = hub.counter("rpc", "per-link", link="0")
    assert hub.counter("rpc", link="0") is a
    assert hub.counter("rpc", link="1") is not a
    with pytest.raises(ValueError):
        hub.gauge("rpc", link="2")
    sc = hub.scoped(replica="2").scoped(role="decode")
    sc.counter("ticks").inc()
    assert {"replica": "2", "role": "decode"} in [
        r["labels"] for r in hub.snapshot() if r["name"] == "ticks"]
    hub.counter("x", a="1", b="2").inc(5)
    hub.counter("x", a="1", b="3").inc(7)
    assert len(hub.query("x", a="1")) == 2
    assert hub.query("x", a="9") == []


def test_histogram_buckets_equal_jax():
    rng = np.random.RandomState(0)
    vals = [float(v) for v in rng.lognormal(1.5, 1.5, 500)] + [1.0, 10.0]
    out = {}
    for name, mod in (("jax", jmetrics), ("torch", tmetrics)):
        hub = _ticking_hub(mod)
        h = hub.histogram("lat", "latency", buckets=[1.0, 10.0, 100.0])
        d = hub.histogram("lat_default", "default buckets")
        for v in vals:
            h.observe(v)
            d.observe(v)
        out[name] = (h.counts, h.count, h.sum, d.buckets, d.counts,
                     mod.log_buckets(), mod.log_buckets(1e-3, 1e3, 1))
        with pytest.raises(ValueError):
            hub.histogram("bad", buckets=[2.0, 1.0])
        with pytest.raises(ValueError):
            h.merge([1, 2], 3.0, 3)
    assert out["torch"] == out["jax"]
    bounds = np.array([1.0, 10.0, 100.0])
    v = np.array(vals)
    assert out["torch"][0] == [int(np.sum(v <= 1.0)),
                               int(np.sum((v > 1.0) & (v <= 10.0))),
                               int(np.sum((v > 10.0) & (v <= 100.0))),
                               int(np.sum(v > bounds[-1]))]


def _fill_hub(hub):
    hub.counter("reqs", "total reqs", path='/v1/"gen"\\x').inc(12)
    hub.gauge("depth", "queue depth", replica="0").set(2.5)
    h = hub.histogram("lat_ms", "tick latency", buckets=[1.0, 10.0])
    for v in (0.5, 3.0, 3.0, 50.0):
        h.observe(v)
    hub.counter("sched_requests_finished", "by reason",
                reason="length").inc(3)


def test_exposition_text_equal_jax():
    texts = {}
    for name, mod in (("jax", jmetrics), ("torch", tmetrics)):
        hub = _ticking_hub(mod)
        _fill_hub(hub)
        texts[name] = hub.render()
        assert mod.parse_exposition(texts[name]) == \
            jmetrics.parse_exposition(texts[name])
    assert texts["torch"] == texts["jax"]
    parsed = tmetrics.parse_exposition(texts["torch"])
    samples = {(n, tuple(sorted(lb.items()))): v
               for n, lb, v in parsed["samples"]}
    assert samples[("reqs", (("path", '/v1/"gen"\\x'),))] == 12.0
    assert samples[("lat_ms_bucket", (("le", "+Inf"),))] == 4.0


def test_delta_drain_absorb_equal_jax_both_ways():
    """The same child history drains the same batches in both; a JAX
    parent absorbs the port's batches (and the reverse) into the same
    snapshot; a drained batch that is lost stays lost."""
    def child_rounds(mod):
        child = _ticking_hub(mod)
        child.counter("ticks").inc(3)
        child.gauge("depth").set(2)
        h = child.histogram("lat", buckets=[1.0, 10.0])
        h.observe(0.5)
        h.observe(5.0)
        b1 = child.drain_delta()
        assert child.drain_delta() == []
        child.counter("ticks").inc(2)
        h.observe(100.0)
        b2 = child.drain_delta()
        child.counter("ticks").inc(4)
        child.drain_delta()                   # shipped and lost
        child.counter("ticks").inc(1)
        return b1, b2, child.drain_delta()

    jb, tb = child_rounds(jmetrics), child_rounds(tmetrics)
    assert json.loads(json.dumps(tb)) == json.loads(json.dumps(jb))
    snaps = []
    for parent_mod, batches in ((jmetrics, tb), (tmetrics, jb),
                                (tmetrics, tb)):
        parent = _ticking_hub(parent_mod)
        for b in batches:
            parent.absorb_delta(json.loads(json.dumps(b)), replica="0")
        snaps.append(parent.snapshot())
    assert snaps[0] == snaps[1] == snaps[2]
    rows = {r["name"]: r for r in snaps[2]}
    assert rows["ticks"]["value"] == 6.0
    assert rows["lat"]["counts"] == [1, 1, 1]


def test_slo_monitor_gauges_equal_jax():
    def req(ms, reason="length"):
        return {"kind": "request", "finish_reason": reason, "ttft_ms": ms,
                "tpot_ms": ms / 10.0, "wall_ms": ms * 2.0, "new_tokens": 4,
                "deadline_s": 0.05}

    out = {}
    for name, mod, mmod in (("jax", jslo, jmetrics),
                            ("torch", tslo, tmetrics)):
        hub = _ticking_hub(mmod)
        with_m = mod.SLOMonitor(mod.SLOTargets(), metrics=hub)
        without = mod.SLOMonitor()
        for i in range(40):
            rec = req(10.0 + i, "timeout" if i % 9 == 0 else "length")
            with_m.observe(rec)
            without.observe(rec)
        assert with_m.report() == without.report()
        out[name] = (with_m.report(), hub.snapshot(), with_m.burn_rate())
    assert out["torch"] == out["jax"]
    rows = {r["name"]: r["value"] for r in out["torch"][1]}
    assert rows["slo_burn_rate"] == pytest.approx(out["torch"][0][
        "burn_rate"])


# ---------------------------------------------------------------------------
# fleet trace
# ---------------------------------------------------------------------------

def _fleet_events(mod_trace, clock):
    """A router lane (submit and terminal per request) and two replica
    lanes (queue wait, prefill, ticks), stamped on one fake clock."""
    router = mod_trace.Tracer(clock=clock)
    reps = {0: mod_trace.Tracer(clock=clock), 1: mod_trace.Tracer(clock=clock)}
    for rid in range(4):
        t0 = router.now_us()
        router.complete("submit", t0, router.now_us(), flow_start=rid,
                        rid=rid)
        rep = reps[rid % 2]
        rep.complete("queue_wait", t0, rep.now_us(), flow_step=rid, rid=rid)
        with rep.span("prefill_chunk", rid=rid):
            pass
        rep.complete("decode_tick", rep.now_us(), rep.now_us(),
                     flow_step=rid, active=1)
    for rid in range(4):
        router.complete("terminal", router.now_us(), flow_end=rid, rid=rid)
    return (router.events(), {r: t.events() for r, t in reps.items()})


def test_fleet_trace_merge_and_checks_equal_jax(tmp_path):
    from paddle_tpu.obs import trace as jtrace
    from paddle_tpu_torch.obs import trace as ttrace

    def clock_fn():
        t = [0.0]

        def clock():
            t[0] += 0.001
            return t[0]
        return clock

    merged = {}
    for name, tr, fl in (("jax", jtrace, jfleet), ("torch", ttrace, tfleet)):
        router, reps = _fleet_events(tr, clock_fn())
        trace = fl.merge_fleet_trace(router, reps)
        fl.save_fleet_trace(trace, str(tmp_path / f"{name}.json"))
        merged[name] = (trace, fl.flow_summary(trace),
                        [fl.flow_connected(trace, f) for f in range(5)],
                        fl.lane_monotonic(trace),
                        fl.merge_fleet_trace(router, reps, tail=3))

    def strip(tr):
        return [{k: v for k, v in e.items() if k != "cat" or v == "flow"}
                for e in tr["traceEvents"]]

    assert strip(merged["torch"][0]) == strip(merged["jax"][0])
    assert merged["torch"][1:4] == merged["jax"][1:4]
    assert strip(merged["torch"][4]) == strip(merged["jax"][4])
    assert merged["torch"][2] == [True, True, True, True, False]
    assert merged["torch"][3] is True
    assert json.load(open(tmp_path / "torch.json"))["traceEvents"]


# ---------------------------------------------------------------------------
# anomaly detector
# ---------------------------------------------------------------------------

def step_rec(step, *, wall=10.0, retrace=0, drain=None, mem=None,
             nonfinite=0, loss=0.5):
    return {"kind": "step", "ts": 0.0, "step": step, "k_steps": 1,
            "m": 1, "loss": loss, "host_stack_ms": None, "shard_ms": wall / 2,
            "dispatch_ms": wall / 2, "device_ms": None, "replay_ms": None,
            "drain_wait_ms": drain, "bytes_in_use": mem,
            "retrace_count": retrace, "nonfinite_count": nonfinite}


def _staged(step, shard=1.0, drain=10.0):
    r = step_rec(step, wall=2.0, drain=drain)
    r["shard_ms"], r["host_stack_ms"], r["stage_ms"] = shard, 1.0, 2.0
    return r


ANOMALY_STREAMS = {
    "slow_step": (dict(warmup=8),
                  [step_rec(i, wall=10.0 + 0.01 * i) for i in range(20)]
                  + [step_rec(99, wall=500.0), step_rec(100, wall=500.0)]),
    "retrace_burst": (dict(retrace_burst=3),
                      [step_rec(i) for i in range(5)]
                      + [step_rec(5 + i, retrace=rc)
                         for i, rc in enumerate((1, 2, 2, 3))]),
    "drain_stall_memory": (dict(drain_stall_ms=100.0, memory_frac=0.9,
                                memory_bytes_limit=1000),
                           [step_rec(i, drain=50.0, mem=500)
                            for i in range(4)]
                           + [step_rec(4, drain=120.0),
                              step_rec(5, drain=400.0),
                              step_rec(6, mem=950)]),
    "nonfinite_ring": (dict(ring_size=4),
                       [step_rec(i) for i in range(6)]
                       + [step_rec(6, nonfinite=3, loss=None),
                          step_rec(7, nonfinite=1)]),
    "staged_wall": (dict(warmup=8),
                    [_staged(i) for i in range(16)]
                    + [_staged(99, shard=800.0), _staged(100, drain=500.0)]),
    "profiled_skipped": (dict(warmup=8),
                         [step_rec(i) for i in range(16)]
                         + [dict(step_rec(99, wall=5000.0), profiled=True)]),
    "rearm": (dict(rearm=True),
              [step_rec(i, nonfinite=1) for i in range(3)]),
}


@pytest.mark.parametrize("stream", sorted(ANOMALY_STREAMS))
def test_anomaly_verdicts_and_bundles_equal_jax(stream, tmp_path):
    """The same record stream gives the same verdicts (kind, step, value,
    threshold, detail), the same bundle directories and the same
    ``verdict.json`` and ``telemetry_ring.jsonl`` in both frameworks."""
    kw, recs = ANOMALY_STREAMS[stream]
    out = {}
    for name, mod in (("jax", janomaly), ("torch", tanomaly)):
        root = tmp_path / name
        det = mod.AnomalyDetector(out_dir=str(root), **kw)
        per_rec = [[(v.kind, v.step, v.value, v.threshold, v.detail)
                    for v in det.observe(dict(r))] for r in recs]
        bundles = sorted(os.listdir(root)) if root.exists() else []
        files = {}
        for b in bundles:
            v = json.load(open(root / b / "verdict.json"))
            v.pop("ts")
            v["verdict"].pop("bundle")
            files[b] = (v, open(root / b / "telemetry_ring.jsonl").read())
        out[name] = (per_rec, bundles, files)
    assert out["torch"] == out["jax"]
    assert any(out["torch"][0]) == (stream != "profiled_skipped")


def test_anomaly_profiler_arming_reset_and_serving_kinds(tmp_path):
    det = tobs.AnomalyDetector(out_dir=str(tmp_path), arm_profiler=True)
    assert det.take_profiler_request() is None
    det.observe(step_rec(0, nonfinite=1))
    req = det.take_profiler_request()
    assert req.startswith(str(tmp_path)) and req.endswith("torch_profile")
    assert det.take_profiler_request() is None
    det.observe(step_rec(1, nonfinite=1))
    assert len(det.bundles) == 1
    det.reset()
    assert det._fired == set() and len(det._ring) == 0
    det.observe(step_rec(2, nonfinite=1))
    assert len(det.bundles) == 2
    assert tobs.ANOMALY_KINDS == jobs.ANOMALY_KINDS
    assert tobs.SERVING_ANOMALY_KINDS == jobs.SERVING_ANOMALY_KINDS


# ---------------------------------------------------------------------------
# run report and top
# ---------------------------------------------------------------------------

def _run_stream():
    recs = [{"kind": "compile", "ts": 1.0, "fingerprint": "a",
             "compile_count": 1, "retrace_count": 0, "wall_s": 2.5,
             "hlo_flops": None, "cache_hit": None, "autotune_trials": None}]
    for i in range(8):
        recs.append({"kind": "step", "ts": 2.0 + i, "pass": 0,
                     "step": 2 * (i + 1), "k_steps": 2, "m": 1,
                     "loss": 2.0 - 0.1 * i, "host_stack_ms": 1.0,
                     "shard_ms": 0.5, "dispatch_ms": 3.0 + i,
                     "device_ms": 90.0, "replay_ms": 0.2,
                     "compile_count": 1, "retrace_count": 0,
                     "bytes_in_use": 1000 + i, "peak_bytes": 1007,
                     "grad_norm": 1.5, "param_norm": 40.0,
                     "update_norm": 0.04, "update_ratio": 0.001,
                     "nonfinite_count": 0, "stage_ms": None,
                     "drain_wait_ms": None, "overlap_frac": None,
                     "profiled": False, "fenced": True,
                     "tokens_per_sec": 1e5, "est_mfu_pct": 30.0})
    recs.append({"kind": "anomaly", "anomaly_kind": "slow_step", "step": 3,
                 "detail": "test"})
    recs += _request_stream(1, 20)
    return recs


@pytest.mark.parametrize("with_summary", [True, False])
def test_report_summary_and_table_equal_jax(tmp_path, with_summary):
    recs = _run_stream()
    if with_summary:
        recs.append({"kind": "summary", "ts": 20.0, "steps_emitted": 8,
                     "compile_count": 1, "retrace_count": 0,
                     "hlo_flops_per_call": None, "peak_bytes": 1007,
                     "stager_leaked": False, "background_failures": 0,
                     "mean_dispatch_ms": 6.5, "tokens_per_sec": 1e5,
                     "est_mfu_pct": 30.0, "grad_norm": 1.5})
    path = str(tmp_path / "run.jsonl")
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")
    ts, js = (treport.summarize(treport.load_records(path)),
              jreport.summarize(jreport.load_records(path)))
    assert ts == js
    assert ts["from_summary_record"] is with_summary
    assert ts["anomalies"] == 1 and ts["steps"] == 8
    assert treport.format_summary(ts) == jreport.format_summary(js)
    assert treport.main([path]) == 0 and treport.main([path, "--json"]) == 0
    assert treport.main([str(tmp_path / "missing.jsonl")]) == 2


def test_report_runs_as_a_module(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with open(path, "w") as f:
        for r in _run_stream():
            f.write(json.dumps(r) + "\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.obs.report",
                          path], capture_output=True, text=True, env=env,
                         cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "est MFU" in out.stdout and "anomalies" in out.stdout


def test_top_renders_equal_jax(tmp_path, capsys):
    frames = {}
    for name, mod, mmod in (("jax", jtop, jmetrics), ("torch", ttop,
                                                       tmetrics)):
        hub = _ticking_hub(mmod)
        c = hub.counter("fleet_ticks", "ticks", replica="0")
        for _ in range(6):
            c.inc()
        hub.gauge("depth").set(3)
        h = hub.histogram("lat_ms", buckets=[1.0, 10.0])
        for v in (0.5, 2.0, 2.0, 20.0):
            h.observe(v)
        frames[name] = (mod.render(hub=hub), mod.sparkline([0, 1, 2, 3]),
                        mod.sparkline(list(range(100)), width=24))
    assert frames["torch"] == frames["jax"]
    assert "fleet_ticks{replica=0}" in frames["torch"][0]
    p = tmp_path / "tel.jsonl"
    p.write_text("\n".join(json.dumps(
        {"kind": "metrics", "tick": t, "metrics": [
            {"name": "fleet_ticks", "type": "counter", "labels": {},
             "value": float(2 * t)}]}) for t in (1, 2, 3)) + "\n")
    assert ttop.main(["--jsonl", str(p), "--once"]) == 0
    assert "total=6.00" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def test_tracer_spans_flows_and_chrome_format(tmp_path):
    tracer = tobs.Tracer()
    fid = tracer.new_flow()
    with tracer.span("stage", flow_start=fid, group=0):
        time.sleep(0.001)

    def other_thread():
        with tracer.span("dispatch", flow_step=fid):
            time.sleep(0.001)

    t = threading.Thread(target=other_thread, name="worker")
    t.start()
    t.join()
    with tracer.span("drain", flow_end=fid):
        pass
    tracer.instant("marker", step=3)
    doc = json.load(open(tracer.save(str(tmp_path / "trace.json"))))
    evs = doc["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"stage", "dispatch", "drain"}
    assert len({e["tid"] for e in xs}) == 2
    flows = {e["ph"]: e for e in evs if e.get("cat") == "flow"}
    assert set(flows) == {"s", "t", "f"} and flows["f"]["bp"] == "e"
    assert len([e for e in evs if e.get("ph") == "M"
                and e["name"] == "thread_name"]) == 2
    ts = [e.get("ts", -1.0) for e in evs]
    assert ts == sorted(ts)


def test_tracer_ring_tail_concurrency_and_tspan_null():
    tracer = tobs.Tracer(max_events=10)
    for i in range(50):
        with tracer.span("s", i=i):
            pass
    evs = [e for e in tracer.events() if e["ph"] == "X"]
    assert len(evs) == 10 and evs[-1]["args"]["i"] == 49
    assert tracer.dropped_events == 40
    assert [e for e in tracer.tail(0) if e["ph"] == "X"] == []
    with tobs.tspan(None, "anything", junk=1) as v:
        assert v is None
    tracer = tobs.Tracer()

    def worker(n):
        for _ in range(50):
            with tracer.span("w", n=n):
                pass

    threads = [threading.Thread(target=worker, args=(n,)) for n in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len([e for e in tracer.events() if e["ph"] == "X"]) == 200
    assert len(tracer.drain_events()) == 200 and tracer.events()


def test_profile_window_is_lazy_and_writes_a_torch_trace(tmp_path):
    """``profile_window`` starts nothing until ``with`` entry; on exit
    ``torch_profile`` has exported a Chrome trace holding the window's
    operators."""
    import torch
    tracer = tobs.Tracer()
    cm = tracer.profile_window(str(tmp_path / "prof"))
    assert [e for e in tracer.events() if e["ph"] == "X"] == []
    assert not (tmp_path / "prof").exists()
    with cm:
        torch.ones(64, 64) @ torch.ones(64, 64)
    spans = [e["name"] for e in tracer.events() if e["ph"] == "X"]
    assert spans == ["torch_profile"]
    (name,) = os.listdir(tmp_path / "prof")
    doc = json.load(open(tmp_path / "prof" / name))
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

def test_heartbeats_read_and_dead_hosts_equal_jax(tmp_path):
    """Beats written by either framework read the same in both; stale,
    missing, torn and retired files are judged the same way."""
    root = str(tmp_path)
    tmh.write_heartbeat(root, 0, seq=3, now=100.0, extra={"load": 2})
    jmh.write_heartbeat(root, 1, seq=1, now=50.0)
    tmh.write_heartbeat(root, 2, seq=9, now=99.0)
    with open(os.path.join(root, "heartbeats", "host-00007.json"), "w") as f:
        f.write("{torn")
    assert tmh.read_heartbeats(root) == jmh.read_heartbeats(root)
    beats = tmh.read_heartbeats(root)
    assert sorted(beats) == [0, 1, 2] and beats[0]["load"] == 2
    for kw in ({"now": 105.0}, {"now": 105.0, "expected_hosts": [0, 1, 5]},
               {}):
        assert tmh.detect_dead_hosts(root, 10.0, **kw) == \
            jmh.detect_dead_hosts(root, 10.0, **kw)
    assert tmh.detect_dead_hosts(root, 10.0, now=105.0) == [1]
    retired = tmh.retire_heartbeat(root, 2)
    assert retired.endswith(".retired") and os.path.exists(retired)
    assert tmh.retire_heartbeat(root, 2) is None
    assert sorted(tmh.read_heartbeats(root)) == sorted(
        jmh.read_heartbeats(root)) == [0, 1]
    assert tmh.heartbeat_path(root, 3) == jmh.heartbeat_path(root, 3)


def test_host_heartbeat_thread_beats_and_stops(tmp_path):
    hb = tmh.HostHeartbeat(str(tmp_path), interval_s=0.01)
    assert hb.host_id == 0
    with hb:
        deadline = time.time() + 5
        while hb.seq < 3 and time.time() < deadline:
            time.sleep(0.01)
    seq = tmh.read_heartbeats(str(tmp_path))[0]["seq"]
    assert seq >= 3
    time.sleep(0.05)
    assert tmh.read_heartbeats(str(tmp_path))[0]["seq"] == seq
