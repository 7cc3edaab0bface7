"""Structured tracing for the pipelined hot loop — thread-aware spans
emitted as Chrome Trace Event Format JSON.

The telemetry answers "how fast is each call"; the host pipeline makes
the answer multi-threaded (main loop + `GroupStager` thread). A
scalar-per-call JSONL cannot show *where* the overlap breaks down — that
needs a timeline a human can open. This module records begin/end spans
per thread and serializes them in the Trace Event Format
that Perfetto (https://ui.perfetto.dev) and `chrome://tracing` consume —
the same container ``torch.profiler`` exports its device traces in, so the
host-side story lines up with device profiles side by side.

Design rules:

- **Spans are host-side and cheap.** One `perf_counter_ns` pair + one
  locked deque append per span; no device interaction, no fences, no
  extra dispatches. The Trainer guards every span behind ``tracer is
  None`` (via :func:`tspan`), so tracing off is the byte-identical hot
  loop (``tests/test_trace.py`` pins it).
- **Thread-aware by construction.** Events carry the OS thread id;
  ``thread_name`` metadata events name the main loop and the
  ``host_pipeline.stager`` thread in the viewer.
- **Flow events link a group across threads.** A staged group's life —
  stack+shard on the stager thread, dispatch on the main thread, drain
  later still — is connected with ``s``/``t``/``f`` flow events sharing
  one flow id, so host/device overlap (or its absence) is visually
  auditable: the arrows cross threads exactly where the pipeline hides
  work.
- **Bounded memory.** The event buffer is a ring (``max_events``);
  long runs keep the most recent window, which is also what the anomaly
  flight recorder snapshots into a forensics bundle
  (:mod:`paddle_tpu_torch.obs.anomaly`).

Usage::

    from paddle_tpu_torch.obs import Tracer
    tracer = Tracer()
    trainer = Trainer(..., telemetry=tel, tracer=tracer)
    trainer.train(...)
    tracer.save("trace.json")      # open in ui.perfetto.dev

Programmatic device-profiler windows ride the same API:
``tracer.profile_window(log_dir)`` wraps a code region in a
``torch.profiler`` capture (CUDA activities on the card, exported as a
Chrome trace into ``log_dir``) *and* a host span, so the device capture
is findable from the host timeline.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Tracer", "tspan", "torch_profile"]

_log = logging.getLogger("paddle_tpu_torch.trace")

# Shared no-op context for tracer-off call sites: stateless, so one
# instance is safe across threads and reentrant use.
_NULL = contextlib.nullcontext()


def tspan(tracer: Optional["Tracer"], name: str, **kw):
    """Null-safe span helper: a real ``tracer.span(...)`` when tracing is
    on, the shared no-op context when ``tracer`` is None — the hot loop
    never branches further than this."""
    if tracer is None:
        return _NULL
    return tracer.span(name, **kw)


@contextlib.contextmanager
def torch_profile(log_dir: str):
    """Best-effort ``torch.profiler`` capture window: CPU activities, and
    CUDA ones when a card is visible; on exit the capture is exported as
    a Chrome trace, ``log_dir/trace_<pid>_<n>.json``. A profiler failure
    (a second profiler already active) is logged and the body still runs:
    a diagnostic capture must never kill the work it diagnoses."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:                        # pragma: no cover - profiler
        _log.exception("torch.profiler start in %r failed; continuing "
                       "without device capture", log_dir)
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    # the window's kernels must finish before it closes
                    torch.cuda.current_stream().synchronize()
                prof.__exit__(None, None, None)
                path = os.path.join(
                    log_dir, f"trace_{os.getpid()}_{next(_PROFILE_SEQ)}.json")
                prof.export_chrome_trace(path)
            except Exception:                # pragma: no cover - profiler
                _log.exception("torch.profiler stop/export failed")


_PROFILE_SEQ = itertools.count()


def _json_safe(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


class Tracer:
    """Thread-aware span recorder emitting Chrome Trace Event Format.

    Every finished span becomes one complete (``ph="X"``) event with
    microsecond ``ts``/``dur`` relative to the tracer's construction;
    optional flow ids attach ``s``/``t``/``f`` flow events at the span's
    start timestamp (inside the slice, so viewers bind the arrow to it).
    All methods are thread-safe; spans may begin and end on any thread
    (each span's events carry the thread it ran on).

    Args:
      max_events: ring-buffer bound on retained events (oldest dropped;
        ``dropped_events`` counts evictions). Metadata (process/thread
        names) is kept separately and never evicted.
      clock: optional injectable clock (``callable() -> seconds``).
        When set, every timestamp is ``clock() * 1e6`` — an ABSOLUTE
        microsecond time base shared by whoever else reads the same
        clock. This is the fleet-tracing mode: parent and
        child replicas all stamp spans with the message-carried fleet
        clock, so a SimClock drill's merged timeline is deterministic
        and cross-process spans land on one comparable axis. Default
        (None): ``perf_counter_ns`` relative to
        tracer construction.
    """

    def __init__(self, max_events: int = 200_000, clock=None):
        self.pid = os.getpid()
        self._clock = clock
        self._t0 = time.perf_counter_ns()
        self._events: collections.deque = collections.deque(
            maxlen=int(max_events))
        self._meta: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": self.pid, "tid": 0,
             "args": {"name": "paddle_tpu_torch"}}]
        self._lock = threading.Lock()
        self._seen_threads: Dict[int, str] = {}
        self._flow_seq = itertools.count(1)
        self.dropped_events = 0

    # -- clock / bookkeeping -------------------------------------------------

    def _now_us(self) -> float:
        if self._clock is not None:
            return float(self._clock()) * 1e6
        return (time.perf_counter_ns() - self._t0) / 1e3

    def now_us(self) -> float:
        """The tracer's current timestamp (us) — for callers recording
        already-timed spans via :meth:`complete`."""
        return self._now_us()

    def _note_thread(self, tid: int) -> None:
        # Compare the LIVE name every call, not just first-seen: OS thread
        # idents are recycled (a per-pass stager thread can inherit the
        # ident of pass 1's dead fill thread), and a stale cache would
        # merge two distinct threads' spans onto one mislabelled track.
        name = threading.current_thread().name
        if self._seen_threads.get(tid) == name:
            return
        with self._lock:
            if self._seen_threads.get(tid) != name:
                self._seen_threads[tid] = name
                self._meta.append(
                    {"ph": "M", "name": "thread_name", "pid": self.pid,
                     "tid": tid, "args": {"name": name}})

    def _append(self, evs: List[Dict[str, Any]]) -> None:
        with self._lock:
            room = self._events.maxlen - len(self._events)
            if room < len(evs):
                self.dropped_events += len(evs) - room
            self._events.extend(evs)

    # -- recording -----------------------------------------------------------

    def new_flow(self) -> int:
        """A fresh flow id for linking spans across threads."""
        return next(self._flow_seq)

    @contextlib.contextmanager
    def span(self, name: str, flow_start: Optional[int] = None,
             flow_step: Optional[int] = None, flow_end: Optional[int] = None,
             **args):
        """Record one span around the ``with`` body. ``flow_start`` /
        ``flow_step`` / ``flow_end`` emit the matching flow event (phases
        ``s``/``t``/``f``) bound to this span, linking it to the other
        spans carrying the same id."""
        tid = threading.get_ident()
        self._note_thread(tid)
        t0 = self._now_us()
        try:
            yield
        finally:
            self._emit_span(name, tid, t0, self._now_us(), flow_start,
                            flow_step, flow_end, args)

    def complete(self, name: str, t0_us: float,
                 t1_us: Optional[float] = None,
                 flow_start: Optional[int] = None,
                 flow_step: Optional[int] = None,
                 flow_end: Optional[int] = None, **args) -> None:
        """Record an ALREADY-TIMED span with explicit microsecond
        timestamps (the tracer's time base — with an injected clock,
        ``seconds * 1e6``). This is how retroactive spans are stamped:
        a scheduler records a request's queue wait only at admit time,
        from the request's own submit timestamp."""
        tid = threading.get_ident()
        self._note_thread(tid)
        self._emit_span(name, tid, float(t0_us),
                        float(t0_us if t1_us is None else t1_us),
                        flow_start, flow_step, flow_end, args)

    def _emit_span(self, name, tid, t0, t1, flow_start, flow_step,
                   flow_end, args) -> None:
        ev: Dict[str, Any] = {
            "ph": "X", "name": name, "cat": "paddle_tpu_torch",
            "pid": self.pid, "tid": tid,
            "ts": t0, "dur": max(t1 - t0, 0.001)}
        if args:
            ev["args"] = {k: _json_safe(v) for k, v in args.items()}
        evs = [ev]
        for fid, ph in ((flow_start, "s"), (flow_step, "t"),
                        (flow_end, "f")):
            if fid is None:
                continue
            fe = {"ph": ph, "name": "group", "cat": "flow",
                  "id": int(fid), "pid": self.pid, "tid": tid, "ts": t0}
            if ph == "f":
                fe["bp"] = "e"       # bind to the enclosing slice
            evs.append(fe)
        self._append(evs)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (``ph="i"``) — e.g. an anomaly verdict
        pinned onto the timeline at trigger time."""
        tid = threading.get_ident()
        self._note_thread(tid)
        ev: Dict[str, Any] = {
            "ph": "i", "name": name, "cat": "paddle_tpu_torch", "s": "t",
            "pid": self.pid, "tid": tid, "ts": self._now_us()}
        if args:
            ev["args"] = {k: _json_safe(v) for k, v in args.items()}
        self._append([ev])

    @contextlib.contextmanager
    def profile_window(self, log_dir: str, name: str = "torch_profile"):
        """A :func:`torch_profile` capture window recorded as a host span
        too, so the device capture is findable from the host timeline.
        Lazy like any context manager: nothing starts until ``with``
        entry (an unused return value must not leave the device profiler
        running)."""
        with self.span(name, log_dir=log_dir), torch_profile(log_dir):
            yield

    # -- output --------------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot: metadata events + every retained span/flow event."""
        with self._lock:
            return list(self._meta) + list(self._events)

    def drain_events(self) -> List[Dict[str, Any]]:
        """Pop every buffered span/flow/instant event (metadata stays).
        The child→parent span-batch shipping primitive: a
        process replica drains its tracer into each tick reply, so
        spans ride the transport the work already uses — no
        side-channel files, nothing to garbage-collect on a SIGKILL."""
        with self._lock:
            evs = list(self._events)
            self._events.clear()
        return evs

    def tail(self, n: int) -> List[Dict[str, Any]]:
        """Metadata + the most recent ``n`` events (the flight-recorder
        window); ``n <= 0`` returns metadata only (``[-0:]`` would be the
        whole ring)."""
        with self._lock:
            evs = list(self._events)
        n = int(n)
        return list(self._meta) + (evs[-n:] if n > 0 else [])

    def chrome_trace(self, events: Optional[List[Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
        """The Trace Event Format container (`traceEvents` sorted by
        timestamp — viewers do not require it, but the bench gate checks
        monotonicity on exactly this serialization)."""
        evs = self.events() if events is None else list(events)
        evs.sort(key=lambda e: e.get("ts", -1.0))
        clock = ("injected clock (absolute us)"
                 if self._clock is not None else
                 "perf_counter_ns (us since tracer construction)")
        return {"traceEvents": evs, "displayTimeUnit": "ms",
                "otherData": {"producer": "paddle_tpu_torch.obs.trace",
                              "clock": clock,
                              "dropped_events": self.dropped_events}}

    def save(self, path: str) -> str:
        """Write the Chrome trace JSON (open in ui.perfetto.dev)."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
