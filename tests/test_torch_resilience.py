"""The port's fault plane, preemption and restart supervisor
(``paddle_tpu_torch/train/{faults,resilience}.py``) on the CPU: a seeded
sweep of faults (a crash before, during and after a save, a corrupt
latest pass, a preemption, a stager error) under ``run_resilient``
finishes bit-equal to the uninterrupted run, with and without dropout;
``request_stop`` and SIGTERM stop at a group boundary with a checkpoint
at that position; the supervisor's restart, give-up and clean-preemption
statuses; ``classify_failure``; the fault points against the JAX
package's ``FaultSchedule``, which this module copies. Comparisons are
bit for bit: a resumed run repeats the same operations on the same
values."""

import logging
import os
import signal
import time

import numpy as np
import pytest
import torch

from paddle_tpu.train import faults as jfaults
from paddle_tpu.train import resilience as jresilience
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.layers import Linear
from paddle_tpu_torch.train import (FaultSchedule, InjectedCrash, Preempted,
                                    SupervisorGaveUp, checkpoint as ckpt,
                                    faults as faults_lib, resilience,
                                    run_resilient)
from paddle_tpu_torch.train import trainer as trainer_mod

BS, N = 8, 16


class TMLP(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.hidden = Linear(20, 16, act="relu", device="cpu", generator=g)
        self.out = Linear(16, 10, device="cpu", generator=g)

    def forward(self, x, train=False):
        return self.out(self.hidden(x))


def _batches(n=N, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(BS, 20).astype(np.float32),
             "label": rng.randint(0, 10, (BS,)).astype(np.int32)}
            for _ in range(n)]


BATCHES = _batches()


def reader():
    return iter(BATCHES)


def make_trainer(faults=None, **kw):
    tr = pt.Trainer(TMLP(),
                    lambda out, b: pt.softmax_cross_entropy(out, b["label"]),
                    pt.adam(1e-3), faults=faults, device="cpu", **kw)
    tr.init()
    return tr


def params_of(tr_or_state):
    ts = getattr(tr_or_state, "train_state", tr_or_state)
    return [p.detach().clone() for p in ts.params.values()]


def assert_params_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def baseline(tmp_path, num_passes=2, saving_period=4, **kw):
    tr = make_trainer(**kw)
    tr.train(reader, num_passes=num_passes,
             checkpoint_dir=str(tmp_path / "baseline"),
             saving_period=saving_period, log_period=0)
    return params_of(tr)


# steps_per_call=2 over 16 batches x 2 passes; saving_period=4: boundary
# saves at batches 4/8/12/16 plus the pass-end save (save indices 0..4 in
# pass 0, 5..9 in pass 1)
SWEEP = [
    ("crash_before_save", dict(crash_at_step=1), {}),
    ("crash_after_save", dict(crash_at_step=5), {}),
    ("crash_during_save", dict(fail_save_at=1), {}),
    ("corrupt_latest_pass",
     dict(corrupt_checkpoint_file=4, crash_at_step=18), {}),
    ("preempt_mid_pass", dict(preempt_at_step=5), {}),
    ("stager_error", dict(stager_error_at_group=4), {"pipeline_depth": 2}),
    ("crash_async_save", dict(crash_at_step=11), {"pipeline_depth": 3}),
]


@pytest.mark.parametrize("name,fs_kw,tr_kw", SWEEP, ids=[s[0] for s in SWEEP])
def test_kill_anywhere_bit_equal(tmp_path, name, fs_kw, tr_kw):
    p0 = baseline(tmp_path, steps_per_call=2, **tr_kw)
    ck = str(tmp_path / "supervised")
    fs = FaultSchedule(**fs_kw)      # one instance: the fault fires once
    extra = {"checkpoint_async": True} if name == "crash_async_save" else {}
    res = run_resilient(
        lambda: make_trainer(faults=fs, steps_per_call=2, **tr_kw),
        reader, checkpoint_dir=ck, num_passes=2, saving_period=4,
        log_period=0, backoff_s=0.001, **extra)
    if res.status == "preempted":
        assert res.preempted is not None
        it = ckpt.load_checkpoint(ck)["iter"]
        assert int(it["preempted"]) == 1 and int(it["completed"]) == 0
        res = run_resilient(
            lambda: make_trainer(steps_per_call=2, **tr_kw),
            reader, checkpoint_dir=ck, num_passes=2, saving_period=4,
            log_period=0, backoff_s=0.001)
    assert res.status == "completed", (name, res)
    assert fs.fired, name
    assert_params_equal(p0, params_of(res.state))
    if name == "corrupt_latest_pass":
        assert res.fallbacks
        assert any(".corrupt" in d for d in os.listdir(ck))


@pytest.mark.parametrize("accum", [1, 2])
def test_kill_and_resume_with_dropout_bit_equal(tmp_path, accum):
    """Dropout draws follow (seed, step[, microbatch]): the resumed run
    draws the masks of the uninterrupted one."""
    kw = dict(vocab=31, dim=32, num_layers=2, num_heads=2, ffn_hidden=64,
              max_len=16, dropout=0.25, device="cpu")
    rng = np.random.RandomState(2)
    batches = [{"x": rng.randint(0, 31, (2, 16)).astype(np.int32),
                "y": rng.randint(0, 31, (2, 16)).astype(np.int32)}
               for _ in range(8)]

    def make(faults=None):
        tr = pt.Trainer(pt.TransformerLM(**kw),
                        lambda out, b: pt.softmax_cross_entropy(out, b["y"]),
                        pt.adam(1e-3), grad_accum=accum, faults=faults,
                        device="cpu")
        tr.init()
        return tr

    whole = make()
    whole.train(lambda: iter(batches), log_period=0, rng=11)
    fs = FaultSchedule(crash_at_step=6 // accum)
    res = run_resilient(lambda: make(fs), lambda: iter(batches),
                        checkpoint_dir=str(tmp_path), saving_period=2,
                        log_period=0, rng=11, backoff_s=0.001)
    assert res.status == "completed" and res.restarts == 1
    assert_params_equal(params_of(whole), params_of(res.state))


def test_supervisor_gives_up_on_deterministic_failure(tmp_path):
    with pytest.raises(SupervisorGaveUp, match="recurred"):
        run_resilient(
            lambda: make_trainer(faults=FaultSchedule(crash_at_step=2),
                                 steps_per_call=2),
            reader, checkpoint_dir=str(tmp_path / "ck"), num_passes=1,
            log_period=0, backoff_s=0.001, same_step_limit=3,
            max_restarts=10)


def test_supervisor_restart_budget(tmp_path):
    calls = {"n": 0}

    def flaky_reader():
        calls["n"] += 1
        raise OSError(f"flaky transport #{calls['n']}")

    with pytest.raises(SupervisorGaveUp, match="budget"):
        run_resilient(lambda: make_trainer(steps_per_call=2), flaky_reader,
                      checkpoint_dir=str(tmp_path / "ck"), num_passes=1,
                      log_period=0, backoff_s=0.001, max_restarts=2,
                      same_step_limit=99)
    assert calls["n"] == 3


def test_nan_is_fatal_not_retried(tmp_path):
    bad = [{"x": np.full((BS, 20), np.nan, np.float32),
            "label": np.zeros((BS,), np.int32)}]
    attempts = {"n": 0}

    def make():
        attempts["n"] += 1
        return make_trainer(nan_check=True)

    with pytest.raises(FloatingPointError):
        run_resilient(make, lambda: iter(bad),
                      checkpoint_dir=str(tmp_path / "ck"), num_passes=1,
                      log_period=0, backoff_s=0.001)
    assert attempts["n"] == 1


def test_heartbeat_is_refused(tmp_path):
    """``heartbeat_interval_s`` is taken (it was refused before the
    heartbeats were ported): the supervised run keeps host 0's heartbeat
    file fresh, stops its thread at the end, and the JAX package's
    ``read_heartbeats`` and ``detect_dead_hosts`` read the file as the
    port's do."""
    from paddle_tpu.parallel import multihost as jmh
    from paddle_tpu_torch.parallel import multihost as mh
    seen = []

    def slow_reader():
        for b in BATCHES:
            time.sleep(0.01)
            seen.append(os.path.exists(mh.heartbeat_path(str(tmp_path), 0)))
            yield b

    t0 = time.time()
    res = run_resilient(make_trainer, slow_reader,
                        checkpoint_dir=str(tmp_path), num_passes=1,
                        log_period=0, heartbeat_interval_s=0.02)
    assert res.status == "completed" and all(seen)
    beats = mh.read_heartbeats(str(tmp_path))
    assert set(beats) == {0} and beats[0]["seq"] >= 1
    assert beats[0]["ts"] >= t0 and beats[0]["pid"] == os.getpid()
    jbeats = jmh.read_heartbeats(str(tmp_path))
    assert {h: {k: v for k, v in b.items()} for h, b in beats.items()} == \
        jbeats
    assert mh.detect_dead_hosts(str(tmp_path), timeout_s=60.0) == []
    assert mh.detect_dead_hosts(str(tmp_path), 60.0,
                                expected_hosts=[0, 1]) == [1]
    # the thread stopped with the run: the beat no longer moves
    seq = beats[0]["seq"]
    time.sleep(0.1)
    assert mh.read_heartbeats(str(tmp_path))[0]["seq"] == seq


@pytest.mark.parametrize("exc,kind", [
    (ckpt.CorruptCheckpointError("crc"), "poisoned_checkpoint"),
    (FloatingPointError("nan"), "fatal"),
    (InjectedCrash("x", step=3), "crash"),
    (faults_lib.InjectedSaveError("disk"), "transient_io"),
    (OSError("flaky"), "transient_io"),
    (ValueError("other"), "crash"),
])
def test_classify_failure(exc, kind):
    assert resilience.classify_failure(exc) == kind


def test_fault_schedule_matches_the_jax_copy():
    """Every training point fires, once, at the same key as the JAX
    package's schedule, and ``describe()`` agrees."""
    kw = dict(seed=3, crash_at_step=2, preempt_at_step=4, fail_save_at=1,
              corrupt_checkpoint_file=2, slow_save=(0, 0.0),
              stager_error_at_group=6)
    ours, theirs = FaultSchedule(**kw), jfaults.FaultSchedule(**kw)
    for fs, crash, inj in ((ours, InjectedCrash, faults_lib.InjectedFault),
                           (theirs, jfaults.InjectedCrash,
                            jfaults.InjectedFault)):
        fs.maybe_crash_step(1)
        with pytest.raises(crash):
            fs.maybe_crash_step(2)
        fs.maybe_crash_step(2)                # disarmed
        assert fs.should_preempt(4) and not fs.should_preempt(4)
        with pytest.raises(inj):
            fs.maybe_stager_error(6)
        fs.maybe_stager_error(6)
        assert fs.on_write_begin(0) == 0
        with pytest.raises(OSError):
            fs.on_write_begin(0)
    assert ours.fired == theirs.fired
    assert ours.describe() == theirs.describe()


def test_faults_off_costs_nothing(tmp_path):
    """An attached but empty schedule changes nothing: the same fetches
    and the same parameters as faults=None."""
    off = make_trainer(steps_per_call=2)
    off.train(reader, log_period=0)
    empty = make_trainer(faults=FaultSchedule(), steps_per_call=2)
    empty.train(reader, log_period=0)
    assert off.host_fetches == empty.host_fetches == N // 2
    assert_params_equal(params_of(off), params_of(empty))


def test_request_stop_quiesces_and_resume_is_bit_equal(tmp_path):
    p0 = baseline(tmp_path, num_passes=2, saving_period=None)
    ck = str(tmp_path / "ck")
    tr = make_trainer()

    def handler(e):
        if isinstance(e, pt.train.EndIteration) and e.batch_id == 2 \
                and e.pass_id == 0:
            tr.request_stop("test")

    with pytest.raises(Preempted) as ei:
        tr.train(reader, num_passes=2, checkpoint_dir=ck, log_period=0,
                 event_handler=handler)
    assert ei.value.pass_id == 0 and ei.value.next_batch == 3
    it = ckpt.load_checkpoint(ck)["iter"]
    assert int(it["next_batch"]) == 3 and int(it["preempted"]) == 1
    assert int(it["batch_crc"]) == trainer_mod._batch_fingerprint(BATCHES[2])
    tr2 = make_trainer()
    tr2.train(reader, num_passes=2, checkpoint_dir=ck, resume=True,
              log_period=0)
    assert_params_equal(p0, params_of(tr2))


def test_preempt_lands_on_a_group_boundary_when_pipelined(tmp_path):
    ck = str(tmp_path / "ck")
    tr = make_trainer(steps_per_call=2, pipeline_depth=3,
                      faults=FaultSchedule(preempt_at_step=3))
    with pytest.raises(Preempted) as ei:
        tr.train(reader, num_passes=1, checkpoint_dir=ck, log_period=0,
                 checkpoint_async=True)
    # the request is seen at the next group boundary after step 3's
    # replay; the drain there leaves the state at exactly that position
    nb = ei.value.next_batch
    assert nb % 2 == 0 and nb >= 6
    loaded = ckpt.load_checkpoint(ck)
    assert int(loaded["step"]) == nb == tr.train_state.step
    assert int(loaded["iter"]["batch_crc"]) == \
        trainer_mod._batch_fingerprint(BATCHES[nb - 1])


def test_stop_request_scoped_to_one_train_call(tmp_path):
    ck = str(tmp_path / "ck")
    tr = make_trainer()

    def handler(e):
        if isinstance(e, pt.train.EndIteration) and e.batch_id == 1:
            tr.request_stop("once")

    with pytest.raises(Preempted):
        tr.train(reader, num_passes=1, checkpoint_dir=ck, log_period=0,
                 event_handler=handler)
    state = tr.train(reader, num_passes=1, checkpoint_dir=ck, resume=True,
                     log_period=0)
    assert state is tr.train_state
    assert int(ckpt.load_checkpoint(ck)["iter"]["completed"]) == 1


def test_sigterm_handler_requests_stop():
    tr = make_trainer()
    restore = resilience.install_preemption_handler(tr)
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.time() + 5
        while tr._stop_requested is None and time.time() < deadline:
            time.sleep(0.01)
        assert tr._stop_requested is not None
        assert "signal" in tr._stop_requested
    finally:
        restore()


def test_explicit_pass_restore_stays_strict(tmp_path):
    ck = str(tmp_path / "ck")
    make_trainer().train(reader, num_passes=1, checkpoint_dir=ck,
                         log_period=0)
    faults_lib.corrupt_one_file(os.path.join(ck, "pass-00000"))
    with pytest.raises(ckpt.CorruptCheckpointError):
        make_trainer().restore(ck, 0)
    assert os.path.isdir(os.path.join(ck, "pass-00000"))


def test_resume_starts_fresh_when_nothing_readable(tmp_path, caplog):
    p0 = baseline(tmp_path, num_passes=1, saving_period=None)
    ck = str(tmp_path / "ck")
    make_trainer().train(reader, num_passes=1, checkpoint_dir=ck,
                         log_period=0)
    faults_lib.corrupt_one_file(os.path.join(ck, "pass-00000"))
    tr2 = make_trainer()
    with caplog.at_level(logging.WARNING):
        tr2.train(reader, num_passes=1, checkpoint_dir=ck, resume=True,
                  log_period=0)
    assert any("starting from scratch" in r.message for r in caplog.records)
    assert tr2.last_quarantined
    assert_params_equal(p0, params_of(tr2))


def test_resume_warns_on_nondeterministic_reader(tmp_path, caplog):
    ck = str(tmp_path / "ck")
    tr = make_trainer()
    tr.train(reader, num_passes=1, checkpoint_dir=ck, saving_period=2,
             log_period=0)
    ckpt.save_checkpoint(ck, 0, {**pt.checkpoint_tree(tr.train_state,
                                                       pt.jax_root(tr.model)),
                                 "iter": {"pass": 0, "next_batch": 2,
                                          "completed": 0,
                                          "batch_crc": 12345}})
    with caplog.at_level(logging.WARNING):
        make_trainer().train(reader, num_passes=1, checkpoint_dir=ck,
                             resume=True, log_period=0)
    assert any("nondeterministic" in r.message for r in caplog.records)


def test_batch_fingerprint_matches_jax():
    from paddle_tpu.train.trainer import _batch_fingerprint as jfp
    for b in BATCHES[:3] + [{"b": np.arange(3), "a": {"z": np.ones(2),
                                                      "y": np.zeros(1)}}]:
        assert trainer_mod._batch_fingerprint(b) == jfp(b)


def test_supervisor_statuses_match_the_jax_supervisor():
    assert resilience.RunResult.__dataclass_fields__.keys() == \
        jresilience.RunResult.__dataclass_fields__.keys()
