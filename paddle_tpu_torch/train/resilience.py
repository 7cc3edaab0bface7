"""The restart supervisor — the port of ``paddle_tpu/train/resilience.py``.

- :func:`run_resilient` runs a training job under retry with exponential
  backoff and seeded jitter. Failures are classified
  (:func:`classify_failure`): a poisoned checkpoint is quarantined and
  the run falls back one pass (the ``load_latest_valid`` chain does the
  work during ``train(resume=True)``); transient I/O retries; a crash
  retries with resume; the same failure at the same step again and again
  (a deterministic bug) gives up loud. A non-finite loss
  (``FloatingPointError`` from ``nan_check``) is fatal at once: a
  restart replays the same batches into the same NaN.
- :func:`install_preemption_handler` turns SIGTERM/SIGINT into
  ``trainer.request_stop()``: the trainer stops at the next group
  boundary, writes a checkpoint at that position and raises
  :class:`~paddle_tpu_torch.train.faults.Preempted`, which the
  supervisor returns as status ``"preempted"`` and never retries.

``run_resilient(heartbeat_interval_s=)`` keeps this host's heartbeat
file under ``checkpoint_dir`` fresh for the whole supervised run
(:class:`~paddle_tpu_torch.parallel.multihost.HostHeartbeat`, host 0), so
a watchdog's ``detect_dead_hosts`` sees the truth.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import checkpoint as ckpt_lib
from .faults import InjectedCrash, Preempted

__all__ = ["run_resilient", "RunResult", "classify_failure",
           "install_preemption_handler", "SupervisorGaveUp", "Preempted"]

_log = logging.getLogger("paddle_tpu_torch.resilience")


class SupervisorGaveUp(RuntimeError):
    """The supervisor exhausted its restart budget, or the same failure
    recurred at the same step enough times to look deterministic. The
    original failure is chained (``__cause__``)."""


def classify_failure(exc: BaseException) -> str:
    """Map a training failure to a recovery policy:

    - ``"poisoned_checkpoint"`` — checkpoint integrity failure
      (:class:`~paddle_tpu_torch.train.checkpoint.CorruptCheckpointError`):
      quarantine the latest pass and fall back one pass before retrying.
    - ``"fatal"`` — deterministic poison (``FloatingPointError`` from
      ``nan_check``): a restart replays the same batches into the same
      NaN; re-raise immediately, loud.
    - ``"transient_io"`` — ``OSError`` family (flaky disk/transport):
      retry in place after backoff.
    - ``"crash"`` — everything else (including
      :class:`~paddle_tpu_torch.train.faults.InjectedCrash`): retry with
      resume from the newest valid checkpoint.
    """
    if isinstance(exc, ckpt_lib.CorruptCheckpointError):
        return "poisoned_checkpoint"
    if isinstance(exc, FloatingPointError):
        return "fatal"
    if isinstance(exc, InjectedCrash):
        return "crash"
    if isinstance(exc, OSError):
        return "transient_io"
    return "crash"


@dataclasses.dataclass
class RunResult:
    """What :func:`run_resilient` hands back: the terminal status
    (``"completed"`` | ``"preempted"``), the final ``TrainState`` (the
    preempted case returns the quiesced state the checkpoint captured),
    and the recovery ledger — restart count, checkpoint dirs quarantined
    by the fallback chain, and one dict per failed attempt."""
    status: str
    state: Any
    restarts: int
    fallbacks: List[str]
    attempts: List[Dict[str, Any]]
    preempted: Optional[Preempted] = None


def install_preemption_handler(trainer,
                               signals: Tuple[int, ...] = (signal.SIGTERM,
                                                           signal.SIGINT)):
    """Route SIGTERM/SIGINT into ``trainer.request_stop()`` — the
    preemption notice most schedulers send before reclaiming a host. The
    handler only sets a flag (async-signal-safe); the trainer quiesces at
    its next group boundary and exits via
    :class:`~paddle_tpu_torch.train.faults.Preempted`. Returns a ``restore()``
    callable reinstating the previous handlers (call it when the trainer
    is done — e.g. in a ``finally``). Main thread only (CPython's signal
    rule)."""
    prev = {}

    def handler(signum, frame):
        trainer.request_stop(f"signal {signum}")

    for s in signals:
        prev[s] = signal.signal(s, handler)

    def restore():
        for s, h in prev.items():
            signal.signal(s, h)

    return restore


def run_resilient(make_trainer_fn: Callable[[], Any], reader: Callable,
                  *, checkpoint_dir: str, num_passes: int = 1,
                  max_restarts: int = 3, backoff_s: float = 0.5,
                  backoff_max_s: float = 30.0, same_step_limit: int = 3,
                  seed: int = 0, classify: Callable = classify_failure,
                  sleep_fn: Callable[[float], None] = time.sleep,
                  install_signals: bool = False,
                  heartbeat_interval_s: Optional[float] = None,
                  **train_kwargs) -> RunResult:
    """Run a training job under the restart supervisor.

    Args:
      make_trainer_fn: zero-arg factory returning a FRESH, initialized
        :class:`~paddle_tpu_torch.train.trainer.Trainer` for each attempt (a
        crashed attempt's state and worker threads are dead weight —
        never reuse the instance).
      reader: the training reader callable, passed to every attempt's
        ``train()``. Must be deterministic for mid-pass resume to replay
        the interrupted pass exactly (the trainer's batch-fingerprint
        check warns when it is not).
      checkpoint_dir: the shared checkpoint root — the supervisor's only
        durable state. Every attempt runs ``resume=True`` against it.
      num_passes / **train_kwargs: forwarded to ``Trainer.train``
        (``saving_period``, ``checkpoint_async``, ``event_handler``, …).
      max_restarts: restart budget; exceeding it raises
        :class:`SupervisorGaveUp` chained to the last failure.
      backoff_s / backoff_max_s: exponential backoff base/cap between
        retries, with seeded multiplicative jitter (+0–25%) so a fleet
        of restarting workers doesn't stampede the checkpoint store.
      same_step_limit: a failure with the same (type, step) signature
        this many times in a row is treated as deterministic — give up
        loud instead of spending the budget on it.
      classify: failure → policy mapping (see :func:`classify_failure`).
      sleep_fn: injection point for tests (replaces ``time.sleep``).
      install_signals: also route SIGTERM/SIGINT to a graceful stop for
        the duration of each attempt (main thread only).
      heartbeat_interval_s: when set, keep this host's heartbeat file
        under ``checkpoint_dir`` fresh every that many seconds for the
        whole supervised run.

    Returns a :class:`RunResult`; raises :class:`SupervisorGaveUp` when
    the budget is spent, and re-raises ``"fatal"`` failures immediately.
    """
    rng = random.Random(seed)
    attempts: List[Dict[str, Any]] = []
    fallbacks: List[str] = []
    restarts = 0
    last_sig: Optional[Tuple[str, Optional[int]]] = None
    same_sig = 0
    heartbeat = None
    if heartbeat_interval_s is not None:
        from ..parallel.multihost import HostHeartbeat
        heartbeat = HostHeartbeat(checkpoint_dir,
                                  interval_s=heartbeat_interval_s).start()
    try:
        while True:
            trainer = make_trainer_fn()
            restore_signals = (install_preemption_handler(trainer)
                               if install_signals else None)
            try:
                state = trainer.train(reader, num_passes=num_passes,
                                      checkpoint_dir=checkpoint_dir,
                                      resume=True, **train_kwargs)
                fallbacks.extend(trainer.last_quarantined)
                return RunResult(status="completed", state=state,
                                 restarts=restarts, fallbacks=fallbacks,
                                 attempts=attempts)
            except Preempted as p:
                # the CLEAN exit: a graceful stop quiesced and
                # checkpointed — hand control back, never retry
                fallbacks.extend(trainer.last_quarantined)
                _log.warning("training preempted cleanly: %s", p)
                return RunResult(status="preempted",
                                 state=trainer.train_state,
                                 restarts=restarts, fallbacks=fallbacks,
                                 attempts=attempts, preempted=p)
            except Exception as exc:
                fallbacks.extend(trainer.last_quarantined)
                kind = classify(exc)
                step = getattr(exc, "step", None)
                if step is None and trainer.train_state is not None:
                    step = trainer.train_state.step
                attempts.append({"failure": kind,
                                 "error": f"{type(exc).__name__}: {exc}",
                                 "step": step})
                if kind == "fatal":
                    _log.error("fatal training failure (%s) — not "
                               "retrying: %s", type(exc).__name__, exc)
                    raise
                sig = (type(exc).__name__, step)
                same_sig = same_sig + 1 if sig == last_sig else 1
                last_sig = sig
                if same_sig >= same_step_limit:
                    raise SupervisorGaveUp(
                        f"failure {sig[0]} at step {sig[1]} recurred "
                        f"{same_sig}x — deterministic, giving up (see "
                        f"attempts ledger)") from exc
                restarts += 1
                if restarts > max_restarts:
                    raise SupervisorGaveUp(
                        f"restart budget exhausted ({max_restarts}); last "
                        f"failure {sig[0]} at step {sig[1]}") from exc
                if kind == "poisoned_checkpoint":
                    # belt and braces: the resume path quarantines on
                    # load, but a poison detected elsewhere (async-save
                    # fence, explicit restore) must not be re-read
                    pid = ckpt_lib.latest_pass(checkpoint_dir)
                    if pid is not None:
                        d = ckpt_lib._resolve_pass_dir(checkpoint_dir, pid)
                        fallbacks.append(ckpt_lib.quarantine_pass_dir(d))
                delay = min(backoff_max_s,
                            backoff_s * (2.0 ** (restarts - 1)))
                delay *= 1.0 + 0.25 * rng.random()
                _log.warning(
                    "training attempt failed (%s at step %s): %s — "
                    "restart %d/%d after %.2fs backoff",
                    kind, step, exc, restarts, max_restarts, delay)
                sleep_fn(delay)
            finally:
                if restore_signals is not None:
                    restore_signals()
    finally:
        if heartbeat is not None:
            heartbeat.stop()
