"""Deterministic fault injection for the training loop — the port of
``paddle_tpu/train/faults.py``, which is framework-free, so this is its
copy: a :class:`FaultSchedule` is a seeded, step-indexed description of
which named injection point fires when, threaded through the
:class:`~paddle_tpu_torch.train.Trainer`, the checkpoint writer
(``train/checkpoint.py``) and the host-pipeline stager
(``train/host_pipeline.py``).

Rules:

- **Off by default, nothing when off.** ``Trainer(faults=None)`` runs
  the loop without a single extra call: every injection point is behind
  an ``if faults is not None`` check on the host.
- **Deterministic.** Points are keyed by optimizer step, save index or
  group start, never by wall clock, so a schedule reproduces the same
  failure in every run and a kill-anywhere sweep can hold the recovered
  run bit for bit against the uninterrupted one.
- **One-shot.** Each armed point fires once and disarms (recorded in
  :attr:`FaultSchedule.fired`), so a supervisor's retry of the same work
  proceeds: the fault models a transient event.

Training points (who checks them):

- ``crash_at_step`` — the Trainer, after that optimizer step's host
  replay: raises :class:`InjectedCrash`.
- ``preempt_at_step`` — the Trainer, same place: requests a graceful
  stop, which drains, saves and raises :class:`Preempted` at the next
  group boundary.
- ``fail_save_at`` — ``checkpoint._write_pass_dir``, before any byte of
  the N-th save: raises :class:`InjectedSaveError`.
- ``corrupt_checkpoint_file`` — after the N-th save's atomic swap: flips
  one byte of the pass directory's first ``.npz`` (its manifest CRC no
  longer matches).
- ``slow_save`` — after the N-th save's swap: sleeps.
- ``stager_error_at_group`` — the host-pipeline stager thread, at the
  group that starts at that batch index: raises in the worker; the
  failure surfaces in the training thread.

The serving points (``kill_replica_at_tick``, ``stall_replica_at_tick``,
``drop_submit_at``, ``duplicate_submit_at``, ``sigkill_replica_at_tick``,
``transport_hang_at``, ``corrupt_reply_at``) are kept with the same
meaning as in the JAX package, for a serving fleet; the port has no
fleet yet, so nothing of the port checks them.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["FaultSchedule", "InjectedFault", "InjectedCrash",
           "InjectedSaveError", "Preempted", "corrupt_one_file"]

_log = logging.getLogger("paddle_tpu_torch.faults")


class InjectedFault(RuntimeError):
    """Base class for every scheduled fault (so tests and classifiers can
    tell injected failures from organic ones)."""


class InjectedCrash(InjectedFault):
    """Simulated process death at an optimizer step (``crash_at_step``)."""

    def __init__(self, msg: str, step: Optional[int] = None):
        super().__init__(msg)
        self.step = step


class InjectedSaveError(OSError):
    """Simulated I/O failure inside the checkpoint write path
    (``fail_save_at``) — an OSError so the supervisor classifies it as
    transient, like a real flaky disk."""


class Preempted(Exception):
    """Graceful-stop exit status: SIGTERM/SIGINT (or an injected
    preemption) was handled at a group boundary — the host pipeline was
    drained, a quiesced checkpoint was written, and training exited
    cleanly mid-run. The supervisor treats this as a CLEAN exit (status
    ``"preempted"``), never as a failure to retry."""

    def __init__(self, pass_id: int, next_batch: int, reason: str = ""):
        super().__init__(
            f"training preempted at pass {pass_id} batch {next_batch}"
            + (f" ({reason})" if reason else ""))
        self.pass_id = pass_id
        self.next_batch = next_batch
        self.reason = reason


class FaultSchedule:
    """A seeded, step-indexed fault plan (see module docstring for the
    points). All indices are 0-based except optimizer steps, which follow
    the trainer's 1-based host step count. Thread-safe: the save and
    stager points fire from worker threads.

    Args:
      seed: folds into nothing today but names the run (recorded in
        ``describe()``) — schedules are fully deterministic by
        construction, the seed exists so sweeps can label themselves.
      crash_at_step: optimizer step (int) after whose host replay an
        :class:`InjectedCrash` raises.
      preempt_at_step: optimizer step at which a graceful stop is
        requested (handled at the next group boundary).
      fail_save_at: save index (0-based count of checkpoint writes
        through this schedule) whose write raises
        :class:`InjectedSaveError` before writing anything.
      corrupt_checkpoint_file: save index whose landed pass dir gets one
        byte flipped in its first ``.npz`` (CRC now mismatches).
      slow_save: ``(save_index, seconds)`` — that save sleeps after its
        swap (worker thread for async saves).
      stager_error_at_group: pass-relative batch index of the group
        whose staging raises :class:`InjectedFault` in the stager
        thread.
    """

    def __init__(self, seed: int = 0, *,
                 crash_at_step: Optional[int] = None,
                 preempt_at_step: Optional[int] = None,
                 fail_save_at: Optional[int] = None,
                 corrupt_checkpoint_file: Optional[int] = None,
                 slow_save: Optional[Tuple[int, float]] = None,
                 stager_error_at_group: Optional[int] = None,
                 kill_replica_at_tick: Optional[Tuple[int, int]] = None,
                 stall_replica_at_tick:
                 Optional[Tuple[int, int, int]] = None,
                 drop_submit_at: Optional[int] = None,
                 duplicate_submit_at: Optional[int] = None,
                 sigkill_replica_at_tick:
                 Optional[Tuple[int, int]] = None,
                 transport_hang_at: Optional[Tuple[int, int]] = None,
                 corrupt_reply_at: Optional[Tuple[int, int]] = None):
        self.seed = int(seed)
        self.crash_at_step = crash_at_step
        self.preempt_at_step = preempt_at_step
        self.fail_save_at = fail_save_at
        self.corrupt_checkpoint_file = corrupt_checkpoint_file
        self.slow_save = slow_save
        self.stager_error_at_group = stager_error_at_group
        self.kill_replica_at_tick = kill_replica_at_tick
        self.stall_replica_at_tick = stall_replica_at_tick
        self.drop_submit_at = drop_submit_at
        self.duplicate_submit_at = duplicate_submit_at
        self.sigkill_replica_at_tick = sigkill_replica_at_tick
        self.transport_hang_at = transport_hang_at
        self.corrupt_reply_at = corrupt_reply_at
        self._lock = threading.Lock()
        self._save_count = 0
        # (point, key) tuples, in firing order — the sweep's assertions
        # and the supervisor's failure signatures both read this
        self.fired: List[Tuple[str, Any]] = []

    # -- bookkeeping ---------------------------------------------------------

    def _fire_once(self, point: str, key) -> bool:
        """Record ``(point, key)`` and return True exactly once."""
        with self._lock:
            if (point, key) in self.fired:
                return False
            self.fired.append((point, key))
        _log.warning("fault injection: %s fired (key=%r)", point, key)
        return True

    def describe(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "crash_at_step": self.crash_at_step,
                "preempt_at_step": self.preempt_at_step,
                "fail_save_at": self.fail_save_at,
                "corrupt_checkpoint_file": self.corrupt_checkpoint_file,
                "slow_save": self.slow_save,
                "stager_error_at_group": self.stager_error_at_group,
                "kill_replica_at_tick": self.kill_replica_at_tick,
                "stall_replica_at_tick": self.stall_replica_at_tick,
                "drop_submit_at": self.drop_submit_at,
                "duplicate_submit_at": self.duplicate_submit_at,
                "sigkill_replica_at_tick": self.sigkill_replica_at_tick,
                "transport_hang_at": self.transport_hang_at,
                "corrupt_reply_at": self.corrupt_reply_at,
                "fired": list(self.fired)}

    # -- trainer step points -------------------------------------------------

    def maybe_crash_step(self, step: int) -> None:
        """Raise :class:`InjectedCrash` when ``step`` is the armed crash
        step (one-shot). Called by the trainer after each optimizer
        step's host replay."""
        if self.crash_at_step is not None and step == self.crash_at_step \
                and self._fire_once("crash_at_step", step):
            raise InjectedCrash(f"injected crash at step {step}", step=step)

    def should_preempt(self, step: int) -> bool:
        """True (once) when ``step`` is the armed preemption step."""
        return (self.preempt_at_step is not None
                and step == self.preempt_at_step
                and self._fire_once("preempt_at_step", step))

    # -- checkpoint-writer points --------------------------------------------

    def on_write_begin(self, pass_id: int) -> int:
        """Called by ``checkpoint._write_pass_dir`` before any write.
        May raise :class:`InjectedSaveError` — the save never lands.
        Returns this save's index (passed back to
        :meth:`on_write_complete`)."""
        with self._lock:
            idx = self._save_count
            self._save_count += 1
        if self.fail_save_at is not None and idx == self.fail_save_at \
                and self._fire_once("fail_save_at", idx):
            raise InjectedSaveError(
                f"injected save failure (save #{idx}, pass {pass_id})")
        return idx

    def on_write_complete(self, final_dir: str, pass_id: int,
                          idx: int) -> None:
        """Called after the atomic swap landed ``final_dir``. May sleep
        (``slow_save``) or flip a byte in the pass's first ``.npz``
        (``corrupt_checkpoint_file``)."""
        if self.slow_save is not None and idx == self.slow_save[0] \
                and self._fire_once("slow_save", idx):
            time.sleep(float(self.slow_save[1]))
        if self.corrupt_checkpoint_file is not None \
                and idx == self.corrupt_checkpoint_file \
                and self._fire_once("corrupt_checkpoint_file", idx):
            corrupt_one_file(final_dir)

    # -- serving-fleet points ------------------------------------------------

    def kill_replica_for_tick(self, tick: int) -> Optional[int]:
        """The replica id to kill at fleet tick ``tick`` (one-shot), or
        None. Checked by ``ServingFleet.tick`` before any work."""
        if self.kill_replica_at_tick is not None \
                and tick == self.kill_replica_at_tick[0] \
                and self._fire_once("kill_replica_at_tick", tick):
            return int(self.kill_replica_at_tick[1])
        return None

    def stall_replica_for_tick(self, tick: int
                               ) -> Optional[Tuple[int, int]]:
        """``(replica, n_ticks)`` to stall starting at fleet tick
        ``tick`` (one-shot), or None."""
        if self.stall_replica_at_tick is not None \
                and tick == self.stall_replica_at_tick[0] \
                and self._fire_once("stall_replica_at_tick", tick):
            return (int(self.stall_replica_at_tick[1]),
                    int(self.stall_replica_at_tick[2]))
        return None

    def sigkill_replica_for_tick(self, tick: int) -> Optional[int]:
        """The replica id whose PROCESS gets SIGKILL at fleet tick
        ``tick`` (one-shot), or None. For in-process workers this
        degrades to the abstract kill — the point exists so the same
        schedule drills both replica modes."""
        if self.sigkill_replica_at_tick is not None \
                and tick == self.sigkill_replica_at_tick[0] \
                and self._fire_once("sigkill_replica_at_tick", tick):
            return int(self.sigkill_replica_at_tick[1])
        return None

    def should_hang_transport(self, tick: int, replica: int) -> bool:
        """True (once) when ``replica``'s reply to the tick message at
        fleet tick ``tick`` should be lost (the per-message-timeout
        drill)."""
        return (self.transport_hang_at is not None
                and (tick, replica) == (self.transport_hang_at[0],
                                        self.transport_hang_at[1])
                and self._fire_once("transport_hang_at",
                                    (tick, replica)))

    def should_corrupt_reply(self, tick: int, replica: int) -> bool:
        """True (once) when ``replica``'s reply at fleet tick ``tick``
        should arrive garbled (the classified-corruption drill)."""
        return (self.corrupt_reply_at is not None
                and (tick, replica) == (self.corrupt_reply_at[0],
                                        self.corrupt_reply_at[1])
                and self._fire_once("corrupt_reply_at",
                                    (tick, replica)))

    def should_drop_submit(self, rid: int) -> bool:
        """True (once) when fleet request ``rid``'s replica delivery
        should be lost."""
        return (self.drop_submit_at is not None
                and rid == self.drop_submit_at
                and self._fire_once("drop_submit_at", rid))

    def should_duplicate_submit(self, rid: int) -> bool:
        """True (once) when fleet request ``rid`` should be delivered
        twice."""
        return (self.duplicate_submit_at is not None
                and rid == self.duplicate_submit_at
                and self._fire_once("duplicate_submit_at", rid))

    # -- stager point --------------------------------------------------------

    def maybe_stager_error(self, buf_start: int) -> None:
        """Raise in the stager thread for the group starting at
        ``buf_start`` (one-shot)."""
        if self.stager_error_at_group is not None \
                and buf_start == self.stager_error_at_group \
                and self._fire_once("stager_error_at_group", buf_start):
            raise InjectedFault(
                f"injected stager error at group {buf_start}")


def corrupt_one_file(pass_dir: str) -> Optional[str]:
    """Flip one byte mid-file in ``pass_dir``'s first ``.npz`` — the
    manifest CRC (computed before the flip) no longer matches, so the
    next load raises and the fallback chain must quarantine. Returns the
    corrupted path (None when the dir holds no ``.npz``)."""
    for name in sorted(os.listdir(pass_dir)):
        if not name.endswith(".npz"):
            continue
        path = os.path.join(pass_dir, name)
        size = os.path.getsize(path)
        if size == 0:
            continue
        with open(path, "r+b") as f:
            f.seek(size // 2)
            b = f.read(1)
            f.seek(size // 2)
            f.write(bytes([b[0] ^ 0xFF]))
        _log.warning("fault injection: corrupted %s (byte %d flipped)",
                     path, size // 2)
        return path
    return None
