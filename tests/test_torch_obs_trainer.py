"""The port's Trainer with the obs hooks against the JAX Trainer (f32,
CPU): a TransformerLM of vocab 61, dim 32, 2 layers, 2 heads, T 16, on
bridged weights, ``sgd(0.05)``, over the ragged-tail schedule of
``tests/test_obs.py`` (2·2·2 + 1 batches) in the serial, deferred-plain,
grouped and pipelined loops, with ``Telemetry`` on in both.

Held, with their tolerances:

- the kinds of the records in order, each kind's key set, the steps,
  ``k_steps``, ``m``, ``compile_count`` and ``retrace_count``: equal;
- the per-call health scalars: within 1e-4 relative (the same f32
  gradients summed in other orders; the count exactly);
- the per-call losses: within 1e-5;
- with the hooks on, the port's losses and parameters bit-equal to the
  hooks off, the same ``host_fetches`` and the same kernel calls (the
  plain versions the wrappers run on the CPU, counted);
- with every hook None, the fence and the profiler window are never
  called, and a process that cannot import the obs package trains to
  the same losses with the same kernel calls;
- the anomaly verdicts of the same record stream: equal in both
  frameworks' detectors; a NaN-poisoned batch trips ``nonfinite`` at the
  same step in both Trainers and leaves one bundle whose armed
  ``torch.profiler`` trace exists.
"""

import json
import logging
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.obs as jobs
import paddle_tpu_torch as pt
import paddle_tpu_torch.obs as tobs
from paddle_tpu import optim as jopt
from paddle_tpu.core.mesh import make_mesh
from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.nn import costs as jcosts
from paddle_tpu.train.trainer import Trainer as JTrainer
from paddle_tpu_torch.nn import cuda_attention as ca
from paddle_tpu_torch.obs import telemetry as ttel
from paddle_tpu_torch.obs import trace as ttrace
from paddle_tpu_torch.train import host_pipeline as thp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, DIM, LAYERS, HEADS, FFN, T, BS = 61, 32, 2, 2, 64, 16, 2
KW = dict(vocab=V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
          ffn_hidden=FFN, max_len=T)
LR = 0.05
MODES = [(1, 1, 1), (1, 1, 3), (2, 2, 1), (2, 2, 2)]


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randint(0, V, (BS, T)).astype(np.int32),
             "y": rng.randint(0, V, (BS, T)).astype(np.int32)}
            for _ in range(n)]


BATCHES = _batches(2 * 2 * 2 + 1)


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.fixture(scope="module")
def init_vars():
    jm = JTransformerLM(**KW)
    return _copy_tree(jm.init(jax.random.PRNGKey(0),
                              jnp.asarray(BATCHES[0]["x"])))


def _jax_run(init_vars, K, M, W, batches=BATCHES, passes=2, **kw):
    mem = jobs.InMemorySink()
    tel = jobs.Telemetry(sinks=[mem], **kw.pop("tel_kw", {}))
    tracer = jobs.Tracer()
    tr = JTrainer(JTransformerLM(**KW),
                  lambda out, b: jcosts.softmax_cross_entropy(out, b["y"]),
                  jopt.sgd(LR),
                  mesh=make_mesh({"data": 1}, devices=jax.devices()[:1]),
                  steps_per_call=K, grad_accum=M, pipeline_depth=W,
                  telemetry=tel, tracer=tracer, **kw)
    tr.init(jax.random.PRNGKey(0), batches[0])
    tr.train_state.params = jax.tree_util.tree_map(jnp.asarray,
                                                   init_vars["params"])
    tr.train_state.opt_state = tr.optimizer.init(tr.train_state.params)
    for _ in range(passes):                     # a second pass adds none
        tr.train(lambda: iter(batches), num_passes=1, log_period=0)
    return tr, mem.records, tracer


def _port_run(init_vars, K, M, W, hooks=True, batches=BATCHES, passes=2,
              use_flash=False, **kw):
    tm = pt.load_jax_params(pt.TransformerLM(**KW, use_flash=use_flash,
                                             device="cpu"), init_vars)
    mem = tobs.InMemorySink()
    if hooks:
        kw.setdefault("telemetry", tobs.Telemetry(
            sinks=[mem], **kw.pop("tel_kw", {})))
        kw.setdefault("tracer", tobs.Tracer())
        kw.setdefault("metrics", tobs.MetricsHub())
    tr = pt.Trainer(tm, lambda out, b: pt.softmax_cross_entropy(out, b["y"]),
                    pt.sgd(LR), steps_per_call=K, grad_accum=M,
                    pipeline_depth=W, device="cpu", **kw)
    tr.init(batches[0])
    costs = []

    def handler(e):
        if type(e).__name__ == "EndIteration":
            costs.append(e.cost)

    for _ in range(passes):
        tr.train(lambda: iter(batches), num_passes=1, log_period=0,
                 event_handler=handler)
    return tr, mem.records, costs


@pytest.mark.parametrize("K,M,W", MODES)
def test_records_match_the_jax_trainer(init_vars, K, M, W):
    jtr, jrecs, jtracer = _jax_run(init_vars, K, M, W)
    ttr, trecs, _ = _port_run(init_vars, K, M, W)
    kinds = ([r["kind"] for r in trecs], [r["kind"] for r in jrecs])
    if W == 1 or (K, M) == (1, 1):
        assert kinds[0] == kinds[1]
    else:                       # a compile lands where the stager lets it
        assert sorted(kinds[0]) == sorted(kinds[1])
    for kind in ("step", "compile"):
        jk = [r for r in jrecs if r["kind"] == kind]
        tk = [r for r in trecs if r["kind"] == kind]
        assert [set(r) for r in tk] == [set(r) for r in jk], kind
    assert (ttr.telemetry.compile_count, ttr.telemetry.retrace_count) == \
        (jtr.telemetry.compile_count, jtr.telemetry.retrace_count)
    if (K, M) == (2, 2):
        assert ttr.telemetry.retrace_count == 1
    js = [r for r in jrecs if r["kind"] == "step"]
    ts = [r for r in trecs if r["kind"] == "step"]
    for j, t in zip(js, ts):
        for key in ("pass", "step", "k_steps", "m", "compile_count",
                    "retrace_count", "nonfinite_count", "fenced",
                    "profiled"):
            assert t[key] == j[key], key
        assert t["loss"] == pytest.approx(j["loss"], abs=1e-5)
        for key in ("grad_norm", "param_norm", "update_norm",
                    "update_ratio"):
            assert t[key] == pytest.approx(j[key], rel=1e-4), key
        for key in ("stage_ms", "drain_wait_ms", "overlap_frac",
                    "device_ms"):
            assert (t[key] is None) == (j[key] is None), key
    # compile records: the same fingerprints (shapes, K and M), hlo_flops
    # None in the port
    jc = [r for r in jrecs if r["kind"] == "compile"]
    tc = [r for r in trecs if r["kind"] == "compile"]
    assert [(r["k_steps"], r["m"]) for r in tc] == \
        [(r["k_steps"], r["m"]) for r in jc]
    assert all(r["hlo_flops"] is None and r["wall_s"] > 0 for r in tc)


@pytest.mark.parametrize("K,M,W", MODES)
def test_main_thread_spans_match_the_jax_trainer(init_vars, K, M, W):
    """The training thread's span names, in order for the serial loops
    and as a multiset for the pipelined ones (the drain's place depends
    on the stager), equal JAX's; the stager thread's too."""
    _, _, jtracer = _jax_run(init_vars, K, M, W)
    ttr, _, _ = _port_run(init_vars, K, M, W)

    me = threading.get_ident()

    def names(tracer):
        evs = sorted((e for e in tracer.events() if e["ph"] == "X"),
                     key=lambda e: e["ts"])
        main = [e["name"] for e in evs if e["tid"] == me]
        other = sorted(e["name"] for e in evs if e["tid"] != me)
        return main, other

    (jm, jo), (tm, to) = names(jtracer), names(ttr.tracer)
    if W == 1 or (K, M) == (1, 1):
        assert tm == jm
    else:
        assert sorted(tm) == sorted(jm)
    assert to == jo


@pytest.mark.parametrize("K,M,W", MODES + [(3, 1, 2)])
def test_hooks_do_not_change_the_run(init_vars, K, M, W, monkeypatch):
    """Hooks on against hooks off in the port: the same losses and
    parameters bit for bit, the same loss fetches, the same kernel calls;
    off, no fence and no profiler window."""
    calls = {"fence": 0, "profile": 0, "fwd": 0, "bwd": 0}

    def counted(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ttel, "fence", counted("fence", ttel.fence))
    monkeypatch.setattr(ttrace, "torch_profile",
                        counted("profile", ttrace.torch_profile))
    monkeypatch.setattr(ca, "flash_attention_plain",
                        counted("fwd", ca.flash_attention_plain))
    monkeypatch.setattr(ca, "flash_attention_bwd_plain",
                        counted("bwd", ca.flash_attention_bwd_plain))
    runs = {}
    for on in (False, True):
        for k in calls:
            calls[k] = 0
        tr, recs, costs = _port_run(init_vars, K, M, W, hooks=on,
                                    use_flash=True, passes=1)
        runs[on] = (costs, [p.detach().clone()
                            for p in tr.model.parameters()],
                    tr.host_fetches, dict(calls), recs)
    off, on = runs[False], runs[True]
    assert off[0] == on[0]
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
    assert off[2] == on[2] == len([r for r in on[4] if r["kind"] == "step"])
    assert off[3]["fwd"] == on[3]["fwd"] > 0
    assert off[3]["bwd"] == on[3]["bwd"] > 0
    assert off[3]["fence"] == 0 and off[3]["profile"] == 0
    steps = [r for r in on[4] if r["kind"] == "step"]
    assert on[3]["fence"] == sum(r["device_ms"] is not None for r in steps)
    assert on[3]["fence"] == (len(steps) if W == 1 else 0)
    assert off[4] == []


def test_a_process_without_the_obs_package_trains_the_same(init_vars,
                                                            tmp_path):
    """With every hook None the loop never imports ``obs``: a process in
    which that import fails trains to the same losses with the same
    kernel calls as this one (which has it imported)."""
    np.save(tmp_path / "vars.npy", {"v": init_vars}, allow_pickle=True)
    code = f"""
import sys, json
sys.modules["paddle_tpu_torch.obs"] = None
import numpy as np
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import cuda_attention as ca
calls = {{"fwd": 0, "bwd": 0}}
for name, key in (("flash_attention_plain", "fwd"),
                  ("flash_attention_bwd_plain", "bwd")):
    fn = getattr(ca, name)
    def wrapped(*a, _fn=fn, _k=key, **k):
        calls[_k] += 1
        return _fn(*a, **k)
    setattr(ca, name, wrapped)
V = np.load({str(tmp_path / "vars.npy")!r}, allow_pickle=True).item()["v"]
rng = np.random.RandomState(0)
B = [{{"x": rng.randint(0, {V}, ({BS}, {T})).astype(np.int32),
      "y": rng.randint(0, {V}, ({BS}, {T})).astype(np.int32)}}
     for _ in range(9)]
out = {{}}
for K, M, W in {MODES!r}:
    tm = pt.load_jax_params(pt.TransformerLM(**{KW!r}, use_flash=True,
                                             device="cpu"), V)
    tr = pt.Trainer(tm, lambda o, b: pt.softmax_cross_entropy(o, b["y"]),
                    pt.sgd({LR}), steps_per_call=K, grad_accum=M,
                    pipeline_depth=W, device="cpu")
    tr.init(B[0])
    costs = []
    tr.train(lambda: iter(B), num_passes=1, log_period=0,
             event_handler=lambda e: costs.append(e.cost)
             if type(e).__name__ == "EndIteration" else None)
    out[f"{{K}}{{M}}{{W}}"] = [costs, tr.host_fetches]
out["calls"] = calls
assert "paddle_tpu_torch.obs.telemetry" not in sys.modules
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=REPO),
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    child = json.loads(res.stdout.strip().splitlines()[-1])
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ca.flash_attention_plain, ca.flash_attention_bwd_plain
    try:
        ca.flash_attention_plain = lambda *a, **k: (
            calls.__setitem__("fwd", calls["fwd"] + 1) or fwd(*a, **k))
        ca.flash_attention_bwd_plain = lambda *a, **k: (
            calls.__setitem__("bwd", calls["bwd"] + 1) or bwd(*a, **k))
        for K, M, W in MODES:
            tr, _, costs = _port_run(init_vars, K, M, W, hooks=False,
                                     use_flash=True, passes=1)
            assert child[f"{K}{M}{W}"] == [costs, tr.host_fetches]
    finally:
        ca.flash_attention_plain, ca.flash_attention_bwd_plain = fwd, bwd
    assert child["calls"] == calls


def test_nan_trips_the_same_verdict_in_both_trainers(init_vars, tmp_path):
    """A batch whose per-token weight holds a NaN poisons the second
    call's loss and gradients: both Trainers flag ``nonfinite`` at the
    same step, echo it as an ``anomaly`` record and leave one bundle; the
    port's snapshot names torch, the card and the policy, and its armed
    profiler capture holds a trace file."""
    batches = _batches(6, seed=3)       # a third call takes the capture
    for b in batches:
        b["weight"] = np.ones((BS, T), np.float32)
    batches[2]["weight"][0, 0] = np.nan
    poisoned = {}
    for name in ("jax", "torch"):
        det_mod = jobs if name == "jax" else tobs
        det = det_mod.AnomalyDetector(out_dir=str(tmp_path / name),
                                      arm_profiler=(name == "torch"))
        if name == "jax":
            _, recs, _ = _jax_run(init_vars, 2, 1, 1, batches=batches,
                                  passes=1, anomaly=det)
        else:
            _, recs, _ = _port_run(init_vars, 2, 1, 1, batches=batches,
                                   passes=1, anomaly=det)
        poisoned[name] = (recs, det)
    (jrecs, jdet), (trecs, tdet) = poisoned["jax"], poisoned["torch"]
    jsteps = [r for r in jrecs if r["kind"] == "step"]
    tsteps = [r for r in trecs if r["kind"] == "step"]
    assert tsteps[0]["nonfinite_count"] == jsteps[0]["nonfinite_count"] == 0
    assert tsteps[1]["nonfinite_count"] > 0
    assert jsteps[1]["nonfinite_count"] > 0
    assert [(v.kind, v.step) for v in tdet.verdicts][:1] == \
        [(v.kind, v.step) for v in jdet.verdicts][:1] == [("nonfinite", 4)]
    assert len(tdet.bundles) == 1
    anomalies = [r for r in trecs if r["kind"] == "anomaly"]
    assert anomalies[0]["anomaly_kind"] == "nonfinite"
    bundle = tdet.bundles[0]
    snap = json.load(open(os.path.join(bundle, "snapshot.json")))
    assert snap["torch_version"] == torch.__version__
    assert snap["device_kind"] == "cpu" and "policy" in snap
    prof = os.path.join(bundle, "torch_profile")
    assert os.listdir(prof) and any(r.get("profiled") for r in tsteps)
    # the port's record stream judged by both detectors: equal verdicts
    verdicts = []
    for mod, d in ((jobs, "j2"), (tobs, "t2")):
        det = mod.AnomalyDetector(out_dir=str(tmp_path / d))
        verdicts.append([[(v.kind, v.step, v.detail)
                          for v in det.observe(dict(r))]
                         for r in trecs if r["kind"] == "step"])
    assert verdicts[0] == verdicts[1]


def test_report_reads_the_trainer_jsonl(init_vars, tmp_path):
    path = str(tmp_path / "run.jsonl")
    tel = tobs.Telemetry(sinks=[tobs.JsonlSink(path)], tokens_per_step=32,
                         flops_per_step=1e9, peak_flops=1e12)
    tr, _, _ = _port_run(init_vars, 2, 2, 1, telemetry=tel)
    tel.close()
    from paddle_tpu_torch.obs import report
    s = report.summarize(report.load_records(path))
    assert s["from_summary_record"] is True and s["compiles"] == 2
    assert s["steps"] == 6 and s["est_mfu_pct"] is not None
    assert report.main([path]) == 0


def test_async_checkpoint_records_and_background_failures(init_vars,
                                                          tmp_path):
    mem = tobs.InMemorySink()
    tel = tobs.Telemetry(sinks=[mem])
    tm = pt.load_jax_params(pt.TransformerLM(**KW, device="cpu"), init_vars)
    tr = pt.Trainer(tm, lambda out, b: pt.softmax_cross_entropy(out, b["y"]),
                    pt.sgd(LR), steps_per_call=2, device="cpu",
                    telemetry=tel, tracer=tobs.Tracer())
    tr.init(BATCHES[0])
    tr.train(lambda: iter(BATCHES[:4]), num_passes=1, log_period=0,
             checkpoint_dir=str(tmp_path / "ck"), checkpoint_async=True,
             saving_period=2)
    ck = mem.by_kind("checkpoint")
    assert len(ck) == 3 and all(r["async"] and r["bytes"] > 0 for r in ck)
    saves = [e for e in tr.tracer.events() if e.get("name") ==
             "checkpoint_save"]
    assert len(saves) == 3
    fs = pt.FaultSchedule(fail_save_at=0)
    tr2 = pt.Trainer(tm, lambda out, b: pt.softmax_cross_entropy(out, b["y"]),
                     pt.sgd(LR), device="cpu", telemetry=tel, faults=fs)
    tr2.init(BATCHES[0])
    with pytest.raises(OSError):
        tr2.train(lambda: iter(BATCHES[:2]), num_passes=1, log_period=0,
                  checkpoint_dir=str(tmp_path / "ck2"),
                  checkpoint_async=True)
    assert tel.summary()["background_failures"] == 1


def test_stager_leak_reaches_the_summary(init_vars, monkeypatch):
    monkeypatch.setattr(thp.GroupStager, "close", lambda self: True)
    tr, _, _ = _port_run(init_vars, 2, 1, 2, passes=1)
    assert tr.telemetry.summary()["stager_leaked"] is True


def test_param_stats_and_stat_report_logged(init_vars, caplog):
    tm = pt.load_jax_params(pt.TransformerLM(**KW, device="cpu"), init_vars)
    tr = pt.Trainer(tm, lambda out, b: pt.softmax_cross_entropy(out, b["y"]),
                    pt.sgd(LR), steps_per_call=2, device="cpu",
                    param_stats_period=4,
                    telemetry=tobs.Telemetry(sinks=[tobs.InMemorySink()]))
    tr.init(BATCHES[0])
    with caplog.at_level(logging.INFO, logger="paddle_tpu_torch.trainer"):
        tr.train(lambda: iter(BATCHES[:8]), num_passes=1, log_period=4)
    text = caplog.text
    n_params = len(list(tm.parameters()))
    assert text.count("param ") == 2 * n_params
    assert "abs_max=" in text and "=== trainer ===" in text
    assert "grad_norm=" in text and "train_step" in text
    assert tr.stats.summary()["train_step"]["count"] == 4


def test_metrics_feed_from_step_records(init_vars):
    hub = tobs.MetricsHub()
    tr, recs, _ = _port_run(init_vars, 2, 2, 1, metrics=hub, passes=1,
                            tel_kw={"tokens_per_step": 32})
    rows = {r["name"]: r for r in hub.snapshot()}
    steps = [r for r in recs if r["kind"] == "step"]
    assert rows["train_steps"]["value"] == sum(r["k_steps"] for r in steps)
    assert rows["train_step_ms"]["count"] == len(steps)
    assert rows["train_loss"]["value"] == steps[-1]["loss"]
    assert rows["train_tokens_per_sec"]["value"] == \
        steps[-1]["tokens_per_sec"]
