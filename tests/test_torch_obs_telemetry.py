"""The port's telemetry core, health scalars and StatSet against the JAX
package's: the same records and calls give the same finalized records,
counters and summaries; the health scalars of seeded gradients, updates
and parameters agree within 1e-6 relative and count injected NaN/Inf
exactly; the card-facing parts (peak FLOPs, memory, the fence) behave on
the CPU as the JAX CPU backend does. Also: the port's obs modules import
neither JAX nor the JAX package."""

import json
import logging
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.obs as jobs
import paddle_tpu_torch.obs as tobs
from paddle_tpu.obs import health as jhealth
from paddle_tpu.utils.stats import StatSet as JStatSet
from paddle_tpu_torch.obs import telemetry as ttel
from paddle_tpu_torch.utils import stats as tstats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_ts(recs):
    return [{k: v for k, v in r.items() if k != "ts"} for r in recs]


def _both(fn):
    """``fn(obs_module)`` through the JAX package and the port."""
    return fn(jobs), fn(tobs)


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

STEP_RECS = [
    {"k_steps": 2, "dispatch_ms": 1.0, "device_ms": 9.0, "loss": 2.5},
    {"k_steps": 1, "dispatch_ms": 1.0, "device_ms": 1.0},
    {"k_steps": 1, "dispatch_ms": 5000.0, "profiled": True},
    {"k_steps": 4, "dispatch_ms": 2.0, "drain_wait_ms": 7.0,
     "stage_ms": 3.0, "overlap_frac": 0.5},
    {"k_steps": 1, "dispatch_ms": 1.0, "device_ms": 2.0,
     "loss": float("nan")},
]


@pytest.mark.parametrize("kw", [
    {},
    {"flops_per_step": 1e9, "tokens_per_step": 1024, "peak_flops": 1e12},
    {"tokens_per_step": 100, "fence": False, "health": False,
     "memory": False},
])
def test_emit_step_records_and_summary_equal_jax(kw):
    """The finalized step records (rates, MFU, fixed schema, profiled and
    pipelined rules, NaN sanitised), compile records, events and the
    ``summary`` close record equal JAX's for the same inputs."""
    def run(mod):
        mem = mod.InMemorySink()
        tel = mod.Telemetry(sinks=[mem], **kw)
        tel.update_health({"grad_norm": np.float32(1.5),
                           "param_norm": np.float32(np.inf),
                           "nonfinite_count": np.int32(2)})
        for fp in (("a",), ("a",), ("b",)):
            if tel.observe_fingerprint(fp):
                tel.record_compile(fp, 0.25, meta={"k_steps": 1})
        out = [tel.emit_step(dict(r)) for r in STEP_RECS]
        tel.emit_event({"kind": "anomaly", "anomaly_kind": "nonfinite"})
        tel.stager_leaked = True
        tel.background_failures = 1
        summary = tel.summary()
        tel.close()
        tel.close()
        return _no_ts(out), _no_ts(mem.records), summary

    (jo, jm, js), (to, tm, ts) = _both(run)
    assert to == jo and tm == jm
    js.pop("pipelined_steps_per_sec", None)
    ts.pop("pipelined_steps_per_sec", None)
    assert ts == js
    assert [r["kind"] for r in tm].count("summary") == 1
    assert to[2].get("tokens_per_sec") is None        # profiled
    assert to[4]["loss"] is None                      # strict JSON


def test_mfu_and_tokens_per_sec_accounting():
    mem = tobs.InMemorySink()
    tel = tobs.Telemetry(sinks=[mem], flops_per_step=1e9,
                         tokens_per_step=1024, peak_flops=1e12)
    tel.emit_step({"k_steps": 2, "dispatch_ms": 1.0, "device_ms": 9.0})
    assert mem.records[-1]["est_mfu_pct"] == pytest.approx(20.0)
    assert mem.records[-1]["tokens_per_sec"] == pytest.approx(1024 / 5e-3)


def test_retrace_counter_and_one_shot_warning(caplog):
    tel = tobs.Telemetry(sinks=[tobs.InMemorySink()],
                         retrace_warn_threshold=2)
    with caplog.at_level(logging.WARNING,
                         logger="paddle_tpu_torch.telemetry"):
        assert tel.observe_fingerprint(("a",)) is True
        assert tel.observe_fingerprint(("a",)) is False
        tel.observe_fingerprint(("b",))
        assert "drop_last" not in caplog.text
        tel.observe_fingerprint(("c",))
        tel.observe_fingerprint(("d",))
    assert (tel.compile_count, tel.retrace_count) == (4, 3)
    assert len([r for r in caplog.records
                if "drop_last" in r.getMessage()]) == 1


def test_broken_sink_never_raises():
    class Boom:
        def emit(self, record):
            raise RuntimeError("sink died")

        def close(self):
            raise RuntimeError("close died")

    mem = tobs.InMemorySink()
    tel = tobs.Telemetry(sinks=[Boom(), mem])
    tel.emit_step({"k_steps": 1})
    tel.close()
    assert [r["kind"] for r in mem.records] == ["step", "summary"]


def test_peak_flops_table_and_unknown_card_one_shot_log(caplog):
    """The table holds the H100's dense bf16 spec-sheet peak keyed by
    its torch name; an unknown card logs one WARNING; the CPU has no
    entry (None), as JAX's CPU device does."""
    assert tobs.PEAK_FLOPS == {"NVIDIA H100 80GB HBM3": 989e12}

    class Card:
        device_kind = "NVIDIA H100 80GB HBM3"

    class Unknown:
        device_kind = "NVIDIA B999"

    assert tobs.device_peak_flops(Card()) == 989e12
    ttel._unknown_kinds_logged.discard("NVIDIA B999")
    with caplog.at_level(logging.WARNING,
                         logger="paddle_tpu_torch.telemetry"):
        assert tobs.device_peak_flops(Unknown()) is None
        assert tobs.device_peak_flops(Unknown()) is None
    assert len([r for r in caplog.records
                if "NVIDIA B999" in r.getMessage()]) == 1
    assert tobs.device_peak_flops("cpu") is None
    assert jobs.device_peak_flops() is None


def test_memory_stats_and_fence_on_the_cpu():
    """``{}`` on the CPU, so a record's ``bytes_in_use`` and
    ``peak_bytes`` are None, as the JAX CPU backend gives; the fence is a
    no-op there."""
    assert tobs.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert tobs.device_memory_stats() == {}
    ttel.fence(torch.device("cpu"))
    ttel.fence(None)
    (jrec,), (trec,) = _both(lambda m: [m.Telemetry(
        sinks=[m.InMemorySink()]).emit_step({"k_steps": 1})])
    assert trec["bytes_in_use"] is None and trec["peak_bytes"] is None
    assert jrec["bytes_in_use"] is None and jrec["peak_bytes"] is None


def test_memory_peak_is_the_max_of_samples(monkeypatch):
    """The per-pass peak is the maximum of the sampled bytes in use (the
    allocator's own peak only feeds the whole-run peak), reset by
    ``begin_pass``; no reset of the allocator's counter."""
    samples = iter([{"bytes_in_use": 10, "peak_bytes_in_use": 50,
                     "bytes_limit": 100},
                    {"bytes_in_use": 30, "peak_bytes_in_use": 60,
                     "bytes_limit": 100},
                    {"bytes_in_use": 20, "peak_bytes_in_use": 60,
                     "bytes_limit": 100}])
    monkeypatch.setattr(ttel, "device_memory_stats", lambda: next(samples))
    tel = tobs.Telemetry(sinks=[tobs.InMemorySink()])
    assert tel.sample_memory() == 10
    tel.sample_memory()
    assert (tel.peak_bytes, tel.peak_bytes_run) == (30, 60)
    tel.begin_pass(1)
    tel.sample_memory()
    assert (tel.peak_bytes, tel.peak_bytes_run) == (20, 60)


# ---------------------------------------------------------------------------
# health
# ---------------------------------------------------------------------------

def _health_inputs(seed, bad=None):
    rng = np.random.RandomState(seed)
    shapes = {"a": (7, 5), "b": {"w": (33,), "v": (4, 4, 3)}, "c": (1,)}

    def tree(scale):
        def leaf(s):
            return (rng.standard_normal(s) * scale).astype(np.float32)
        return {"a": leaf(shapes["a"]),
                "b": {"w": leaf(shapes["b"]["w"]),
                      "v": leaf(shapes["b"]["v"])},
                "c": leaf(shapes["c"])}

    grads, updates, params = tree(1.0), tree(1e-3), tree(3.0)
    if bad is not None:
        grads["b"]["v"][0, 1, 2] = bad[0]
        grads["a"][3, 3] = bad[1]
    return grads, updates, params, np.float32(2.25)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("seed,bad", [(0, None), (1, None),
                                      (2, (np.nan, np.inf)),
                                      (3, (-np.inf, 1.0))])
def test_health_scalars_equal_jax(seed, bad):
    grads, updates, params, loss = _health_inputs(seed, bad)
    j = jhealth.health_scalars(_map(jnp.asarray, grads),
                               _map(jnp.asarray, updates),
                               _map(jnp.asarray, params), jnp.asarray(loss))
    t = tobs.health_scalars(_map(torch.from_numpy, grads),
                            _map(torch.from_numpy, updates),
                            _map(torch.from_numpy, params),
                            torch.tensor(loss))
    assert set(t) == set(j) == set(tobs.HEALTH_KEYS) == set(jobs.HEALTH_KEYS)
    assert t["nonfinite_count"].dtype == torch.int32
    assert int(t["nonfinite_count"]) == int(j["nonfinite_count"])
    if bad is not None:
        assert int(t["nonfinite_count"]) == sum(not np.isfinite(b)
                                                for b in bad)
    for k in ("grad_norm", "param_norm", "update_norm", "update_ratio"):
        assert t[k].dtype == torch.float32
        a, b = float(t[k]), float(j[k])
        if np.isfinite(b):
            assert a == pytest.approx(b, rel=1e-6), k
        else:
            assert not np.isfinite(a), k
    nan_loss = tobs.health_scalars(_map(torch.from_numpy, grads), {}, {},
                                   torch.tensor(float("nan")))
    assert int(nan_loss["nonfinite_count"]) == \
        int(t["nonfinite_count"]) + 1
    assert float(tobs.tree_l2_norm({})) == 0.0
    assert int(tobs.tree_nonfinite_count([])) == 0


# ---------------------------------------------------------------------------
# StatSet
# ---------------------------------------------------------------------------

def test_statset_report_topn_and_to_dict_as_jax():
    out = []
    for cls in (JStatSet, tstats.StatSet):
        s = cls("t")
        for k, v in (("slow", 2.0), ("fast", 0.1), ("mid", 0.5),
                     ("mid", 0.25)):
            s.add(k, v)
        out.append((s.report(top_n=2), s.to_dict()))
        json.dumps(s.to_dict())
        s.reset()
        assert s.summary() == {}
    assert out[0] == out[1]
    lines = out[1][0].splitlines()
    assert "slow" in lines[1] and "mid" in lines[2] and "1 more" in lines[-1]


def test_statset_timer_sync_fences_and_barrier_stat(monkeypatch):
    calls = []
    monkeypatch.setattr(ttel, "fence", lambda dev=None: calls.append(dev))
    s = tstats.StatSet("t")
    with s.time("k", sync=torch.zeros(2)):
        pass
    with s.time("k"):
        pass
    assert calls == [torch.device("cpu")]
    assert s.summary()["k"]["count"] == 2
    b = tstats.BarrierStat()
    assert b.gather() == {}
    b.update(0.5)
    g = b.gather()
    assert g["step_time_spread"] == 0.0 and g["step_time_mean_s"] == 0.5
    assert b.summary()["samples"] == 1


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_obs_and_heartbeats_import_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch, paddle_tpu_torch.obs\n"
            "import paddle_tpu_torch.obs.report, paddle_tpu_torch.obs.top\n"
            "import paddle_tpu_torch.parallel.multihost\n"
            "import paddle_tpu_torch.utils.stats\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    for name in os.listdir(os.path.join(REPO, "paddle_tpu_torch", "obs")):
        if name.endswith(".py"):
            src = open(os.path.join(REPO, "paddle_tpu_torch", "obs",
                                    name)).read()
            assert "import jax" not in src and "paddle_tpu." not in \
                src.replace("paddle_tpu_torch.", ""), name
