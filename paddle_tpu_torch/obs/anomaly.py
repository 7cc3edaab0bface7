"""Anomaly detection + flight recorder for the training hot loop
.

The telemetry stream and the trace ring (:mod:`.trace`) answer
questions a human asks *while watching*. Production runs misbehave at
step 40k with nobody watching — by the time someone looks, the JSONL has
scrolled past the interesting window and the trace ring has been
overwritten. This module watches the stream mechanically and, the moment
a run goes sideways, freezes the evidence to disk.

**Detector** (:meth:`AnomalyDetector.observe`, fed every telemetry step
record by the Trainer): rolling *robust* statistics — median + MAD, not
mean + stddev, because the contaminated samples the detector exists to
catch would drag a mean-based threshold toward themselves — over the
recent window, checking five conditions:

- ``nonfinite``   — the NaN/Inf health sentinel tripped (or the loss was
  NaN-sanitized to None): the run is poisoned *now*; later records only
  get worse.
- ``retrace_burst`` — ``retrace_count`` climbed ≥ N inside the window:
  something is feeding a stream of fresh shapes and every step pays a
  recompile.
- ``drain_stall``  — a pipelined drain blocked longer than the absolute
  threshold AND 3x the rolling drain median: in the healthy device-bound
  steady state every drain legitimately blocks for ~one group's device
  time, so only a wait that is also an outlier vs the run's own drain
  baseline counts as a stall (the window emptied and the host sat on a
  dead pipeline).
- ``memory_high_water`` — ``bytes_in_use`` crossed a fraction of the
  device's ``bytes_limit``: the step after this one may be the OOM.
- ``slow_step``    — the call's host wall is a ≥ ``slow_step_zscore``
  robust-z outlier vs the window median (warmup-gated): preemption,
  host interference, a competing process.

**Flight recorder** (on trigger): one forensics bundle directory —
``verdict.json`` (what fired, on which record), ``telemetry_ring.jsonl``
(the last ``ring_size`` step records), ``trace_tail.json`` (the recent
span window as a Chrome trace, when a :class:`~.trace.Tracer` is bound),
and ``snapshot.json`` (trainer config, torch and CUDA versions, the
card's name, the dtype policy, the CUDA_*/TORCH_* env) — everything a
postmortem needs, written once, cheap enough to leave armed in
production. Optionally (``arm_profiler=True``)
the next fused call is wrapped in a ``torch.profiler`` capture into
the bundle, so the device-side view of the anomaly's neighborhood is
kept too.

Each detector kind fires **once** per run by default (``rearm=False``):
the first bundle holds the onset — the interesting record — and a
misbehaving run must not bury the disk in bundles. Detection is
observation, not control: training continues (the hard stops remain
``Trainer(nan_check=True)``), and a detector crash is logged, never
raised into the hot loop.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = ["AnomalyDetector", "ServingAnomalyDetector", "Verdict",
           "ANOMALY_KINDS", "SERVING_ANOMALY_KINDS"]

_log = logging.getLogger("paddle_tpu_torch.anomaly")

ANOMALY_KINDS = ("nonfinite", "retrace_burst", "drain_stall",
                 "memory_high_water", "slow_step")

SERVING_ANOMALY_KINDS = ("tick_stall", "accept_collapse",
                         "prefix_hit_collapse", "retransmit_burst",
                         "queue_divergence")

# Step-record keys whose sum approximates the call's host-observable wall.
# Stager-staged records (stage_ms present — the fused pipeline): dispatch +
# drain wait ONLY, because there host_stack_ms/shard_ms were measured on
# the STAGER thread (already-hidden cost, trainer.py's semantic-shift
# note) and counting them would flag hidden staging spikes as slow steps.
# Everything else — serial records AND the plain deferred-fetch loop,
# whose shard_ms is genuine main-thread critical path — counts the full
# host-side breakdown (absent keys are simply skipped: device_ms is None
# unfenced, drain_wait_ms is None serial).
_WALL_KEYS_STAGED = ("dispatch_ms", "drain_wait_ms")
_WALL_KEYS_MAIN = ("host_stack_ms", "shard_ms", "dispatch_ms",
                   "device_ms", "drain_wait_ms")


@dataclasses.dataclass
class Verdict:
    """One detector trigger: what fired, the observed value vs threshold,
    and (after the dump) where the forensics bundle landed."""
    kind: str
    step: Optional[int]
    value: Optional[float]
    threshold: Optional[float]
    detail: str
    bundle: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _robust_z(x: float, history) -> tuple:
    """Robust z-score of ``x`` against ``history``: (x - median) / (1.4826
    * MAD), with a 5%-of-median floor on the scale so a constant history
    (MAD = 0) cannot make every later sample an infinite outlier."""
    arr = np.asarray(history, np.float64)
    med = float(np.median(arr))
    mad = float(np.median(np.abs(arr - med)))
    scale = 1.4826 * mad
    floor = max(abs(med), 1e-6) * 0.05
    scale = max(scale, floor)
    return (x - med) / scale, med


class AnomalyDetector:
    """Rolling anomaly detector + one-shot flight recorder.

    Args:
      out_dir: where forensics bundles land (``anomaly_NNN_<kind>/``
        subdirectories; created on first trigger, so arming the detector
        never touches the filesystem).
      window: rolling-statistics window (records).
      warmup: minimum history before ``slow_step`` may fire (the first
        call carries compile time; early medians are noise).
      slow_step_zscore: robust-z threshold for ``slow_step`` (the value
        must also exceed 1.5x the window median — belt and braces against
        a tiny scale floor).
      retrace_burst: ``retrace_count`` increase within the window that
        flags a burst.
      drain_stall_ms: ``drain_wait_ms`` floor for a stall; the wait must
        ALSO exceed 3x the rolling drain median (≥3 prior drains), so a
        device-bound run whose every drain is a legitimate
        group-compute-time wait never trips it.
      memory_frac: fraction of the device ``bytes_limit`` that counts as
        high water.
      memory_bytes_limit: override the device-reported limit (None =
        sample ``device_memory_stats()['bytes_limit']`` lazily; backends
        reporting none — CPU — disable the memory check).
      ring_size: telemetry records kept for the bundle.
      trace_tail: trace events snapshotted into the bundle.
      arm_profiler: on trigger, arm a ``torch.profiler`` capture for
        the next fused call (written under the bundle).
      rearm: allow a kind to fire more than once (default: first onset
        only).
    """

    def __init__(self, out_dir: str, window: int = 64, warmup: int = 8,
                 slow_step_zscore: float = 8.0, retrace_burst: int = 3,
                 drain_stall_ms: float = 5000.0,
                 memory_frac: float = 0.92,
                 memory_bytes_limit: Optional[int] = None,
                 ring_size: int = 256, trace_tail: int = 500,
                 arm_profiler: bool = False, rearm: bool = False):
        self.out_dir = out_dir
        self.window = int(window)
        self.warmup = int(warmup)
        self.slow_step_zscore = float(slow_step_zscore)
        self.retrace_burst = int(retrace_burst)
        self.drain_stall_ms = float(drain_stall_ms)
        self.memory_frac = float(memory_frac)
        self._mem_limit = memory_bytes_limit
        self.trace_tail = int(trace_tail)
        self.arm_profiler = bool(arm_profiler)
        self.rearm = bool(rearm)
        self._ring: collections.deque = collections.deque(
            maxlen=int(ring_size))
        self._walls: collections.deque = collections.deque(maxlen=window)
        self._drains: collections.deque = collections.deque(maxlen=window)
        self._retraces: collections.deque = collections.deque(maxlen=window)
        self._fired: set = set()
        self._tracer = None
        self._context_fn: Optional[Callable[[], Dict[str, Any]]] = None
        self._profiler_request: Optional[str] = None
        self.bundles: List[str] = []
        self.verdicts: List[Verdict] = []

    # -- wiring --------------------------------------------------------------

    def bind(self, tracer=None,
             context_fn: Optional[Callable[[], Dict[str, Any]]] = None
             ) -> None:
        """Attach the trace ring and the config/env snapshot source (the
        Trainer calls this at ``train()`` start)."""
        if tracer is not None:
            self._tracer = tracer
        if context_fn is not None:
            self._context_fn = context_fn

    def take_profiler_request(self) -> Optional[str]:
        """Pop the armed profiler-capture directory (None when unarmed).
        The Trainer polls this before each fused dispatch."""
        req, self._profiler_request = self._profiler_request, None
        return req

    def reset(self) -> None:
        """Re-arm every kind and clear the rolling state (bundles stay)."""
        self._fired.clear()
        self._ring.clear()
        self._walls.clear()
        self._drains.clear()
        self._retraces.clear()
        self._profiler_request = None

    # -- detection -----------------------------------------------------------

    def observe(self, rec: Dict[str, Any]) -> List[Verdict]:
        """Feed one telemetry step record; returns the verdicts triggered
        by it (usually empty). Never raises on malformed records — the
        detector must not be the thing that kills the run it watches."""
        if rec.get("kind", "step") != "step":
            return []
        self._ring.append(dict(rec))
        verdicts = []
        for check in (self._check_nonfinite, self._check_retrace_burst,
                      self._check_drain_stall, self._check_memory,
                      self._check_slow_step):
            try:
                v = check(rec)
            except Exception:
                _log.exception("anomaly check %s failed on record",
                               check.__name__)
                continue
            if v is not None and (self.rearm or v.kind not in self._fired):
                self._fired.add(v.kind)
                self._trigger(v, rec)
                verdicts.append(v)
        self._update_rolling(rec)
        return verdicts

    def _update_rolling(self, rec: Dict[str, Any]) -> None:
        wall = self._wall_ms(rec)
        if wall is not None:
            self._walls.append(wall)
        dw = rec.get("drain_wait_ms")
        if dw is not None and not rec.get("profiled"):
            self._drains.append(float(dw))
        rc = rec.get("retrace_count")
        if rc is not None:
            self._retraces.append(int(rc))

    @staticmethod
    def _wall_ms(rec: Dict[str, Any]) -> Optional[float]:
        if rec.get("profiled"):
            # anomaly-armed torch.profiler capture: its dispatch window
            # deliberately contains a compute fence — the flight recorder
            # must not trigger the detector that armed it
            return None
        keys = (_WALL_KEYS_STAGED if rec.get("stage_ms") is not None
                else _WALL_KEYS_MAIN)
        vals = [rec.get(k) for k in keys]
        vals = [v for v in vals if v is not None]
        return float(sum(vals)) if vals else None

    def _check_nonfinite(self, rec) -> Optional[Verdict]:
        bad = rec.get("nonfinite_count") or 0
        loss_nan = "loss" in rec and rec["loss"] is None
        if bad > 0 or loss_nan:
            return Verdict(
                kind="nonfinite", step=rec.get("step"),
                value=float(bad), threshold=0.0,
                detail=(f"NaN/Inf sentinel tripped: nonfinite_count={bad}"
                        + (", loss was NaN-sanitized" if loss_nan else "")))
        return None

    def _check_retrace_burst(self, rec) -> Optional[Verdict]:
        rc = rec.get("retrace_count")
        if rc is None or not self._retraces:
            return None
        rise = int(rc) - self._retraces[0]
        if rise >= self.retrace_burst:
            return Verdict(
                kind="retrace_burst", step=rec.get("step"),
                value=float(rise), threshold=float(self.retrace_burst),
                detail=(f"retrace_count rose by {rise} within the last "
                        f"{len(self._retraces)} records — a stream of "
                        f"fresh shapes is recompiling every step "
                        f"(ragged batches? dynamic lengths?)"))
        return None

    def _check_drain_stall(self, rec) -> Optional[Verdict]:
        dw = rec.get("drain_wait_ms")
        if dw is None or dw <= self.drain_stall_ms:
            return None
        # In the device-bound steady state EVERY drain legitimately blocks
        # for ~one group's device time, so an absolute wall alone would
        # flag healthy big-group runs. Require a baseline (>=3 prior
        # drains) and a 3x-median excess on top of the absolute floor.
        if len(self._drains) < 3:
            return None
        med = float(np.median(self._drains))
        if dw <= 3.0 * max(med, 1e-9):
            return None
        return Verdict(
            kind="drain_stall", step=rec.get("step"), value=float(dw),
            threshold=round(max(self.drain_stall_ms, 3.0 * med), 3),
            detail=(f"pipelined drain blocked {dw:.0f} ms fetching the "
                    f"call's losses ({dw / max(med, 1e-9):.1f}x the run's "
                    f"median drain of {med:.0f} ms) — the in-flight window "
                    f"ran dry (device stall? preempted neighbor?)"))

    def _check_memory(self, rec) -> Optional[Verdict]:
        cur = rec.get("bytes_in_use")
        if cur is None:
            return None
        if self._mem_limit is None:
            from .telemetry import device_memory_stats
            self._mem_limit = device_memory_stats().get("bytes_limit", 0)
        if not self._mem_limit:
            return None
        frac = cur / self._mem_limit
        if frac >= self.memory_frac:
            return Verdict(
                kind="memory_high_water", step=rec.get("step"),
                value=round(frac, 4), threshold=self.memory_frac,
                detail=(f"device memory at {100 * frac:.1f}% of "
                        f"bytes_limit ({cur} / {self._mem_limit}) — the "
                        f"next allocation spike may OOM"))
        return None

    def _check_slow_step(self, rec) -> Optional[Verdict]:
        wall = self._wall_ms(rec)
        if wall is None or len(self._walls) < self.warmup:
            return None
        z, med = _robust_z(wall, self._walls)
        if z >= self.slow_step_zscore and wall > 1.5 * med:
            return Verdict(
                kind="slow_step", step=rec.get("step"), value=round(wall, 3),
                threshold=round(self.slow_step_zscore, 2),
                detail=(f"call wall {wall:.1f} ms is a {z:.1f}-sigma robust "
                        f"outlier vs the window median {med:.1f} ms "
                        f"(preemption / host interference / IO stall?)"))
        return None

    # -- flight recorder -----------------------------------------------------

    def _trigger(self, verdict: Verdict, rec: Dict[str, Any]) -> None:
        try:
            self._dump_bundle(verdict, rec)
        except Exception:
            _log.exception("forensics-bundle dump failed for %s",
                           verdict.kind)
        self.verdicts.append(verdict)
        if self._tracer is not None:
            try:
                self._tracer.instant(f"ANOMALY:{verdict.kind}",
                                     step=verdict.step, value=verdict.value)
            except Exception:
                pass
        if self.arm_profiler and verdict.bundle:
            self._profiler_request = os.path.join(verdict.bundle,
                                                  "torch_profile")
        _log.warning("ANOMALY %s at step %s: %s%s", verdict.kind,
                     verdict.step, verdict.detail,
                     f" — forensics bundle: {verdict.bundle}"
                     if verdict.bundle else "")

    def _dump_bundle(self, verdict: Verdict, rec: Dict[str, Any]) -> str:
        seq = len(self.bundles)
        bundle = os.path.join(self.out_dir,
                              f"anomaly_{seq:03d}_{verdict.kind}")
        os.makedirs(bundle, exist_ok=True)
        verdict.bundle = bundle
        with open(os.path.join(bundle, "verdict.json"), "w") as f:
            json.dump({"ts": time.time(), "verdict": verdict.to_dict(),
                       "trigger_record": rec}, f, indent=2, default=str)
        with open(os.path.join(bundle, "telemetry_ring.jsonl"), "w") as f:
            for r in self._ring:
                f.write(json.dumps(r, default=str) + "\n")
        snapshot: Dict[str, Any] = {}
        if self._context_fn is not None:
            try:
                snapshot = self._context_fn()
            except Exception as e:
                snapshot = {"error": f"{type(e).__name__}: {e}"}
        with open(os.path.join(bundle, "snapshot.json"), "w") as f:
            json.dump(snapshot, f, indent=2, default=str)
        if self._tracer is not None:
            try:
                with open(os.path.join(bundle, "trace_tail.json"), "w") as f:
                    json.dump(self._tracer.chrome_trace(
                        self._tracer.tail(self.trace_tail)), f)
            except Exception:
                _log.exception("trace-tail dump failed")
        self.bundles.append(bundle)
        return bundle


class ServingAnomalyDetector(AnomalyDetector):
    """Serving-fleet anomaly detector: the
    same one-shot/rearm flight-recorder machinery, watching PER-REPLICA
    serving signals instead of training step records. One detector
    serves the whole fleet; each kind fires once per *replica* (the
    one-shot keys are ``"<kind>@r<replica>"``), so replica 1's stall
    is not hidden by replica 0's.

    The fleet feeds three seams, all mode-blind (the same calls work
    for in-process and subprocess replicas, because they consume the
    evidence the fleet already holds — its own tick view, terminal
    request records, transport counters):

    - :meth:`observe_fleet_tick` — per fleet tick, per live replica:

      - ``tick_stall``: the replica has work (running/queued) but its
        engine tick counter has not advanced for ``stall_ticks``
        consecutive fleet ticks — a wedged child, a stalled engine, a
        replica about to be declared dead.
      - ``queue_divergence``: the replica's queue grew monotonically by
        ≥ ``queue_growth`` across the rolling window — arrival rate has
        diverged from service rate (the precursor of mass timeouts).

    - :meth:`observe_serving` — per terminal request record:

      - ``accept_collapse``: speculative draft accept-rate was healthy
        (> 2x ``accept_floor`` at least once) and the last
        ``accept_window`` draft-carrying requests ALL came in at or
        under the floor — the draft model has stopped predicting the
        target (distribution shift, corrupted draft state).
      - ``prefix_hit_collapse``: prefix-cache hits existed earlier but
        the last ``prefix_window`` requests saw none — retention was
        evicted or session affinity broke.

    - :meth:`observe_transport` — per tick, per process replica, fed
      the cumulative transport counters:

      - ``retransmit_burst``: retransmits rose by ≥
        ``retransmit_burst`` within the rolling window — the link to
        that child is flapping.

    On trigger the bundle directory (``anomaly_NNN_<kind>_r<replica>``)
    holds ``verdict.json``, the replica's last-N fleet-tick ring
    (``tick_ring.jsonl``) and terminal-record tail
    (``records_tail.jsonl``), plus whatever fleet-level evidence is
    bound via :meth:`bind_fleet`: transport counters
    (``transport.json``), heartbeat payloads (``heartbeats.json``), and
    the merged fleet trace tail (``fleet_trace_tail.json``)."""

    def __init__(self, out_dir: str, stall_ticks: int = 3,
                 accept_floor: float = 0.2, accept_window: int = 6,
                 prefix_window: int = 6, retransmit_burst: int = 3,
                 queue_growth: int = 6, queue_window: int = 8, **kw):
        super().__init__(out_dir, **kw)
        self.stall_ticks = int(stall_ticks)
        self.accept_floor = float(accept_floor)
        self.accept_window = int(accept_window)
        self.prefix_window = int(prefix_window)
        # base class reuses the name for training retraces; keep ours
        # distinct
        self.retransmit_burst_n = int(retransmit_burst)
        self.queue_growth = int(queue_growth)
        self.queue_window = int(queue_window)
        self._rep: Dict[Any, Dict[str, Any]] = {}
        self._fleet_ctx: Dict[str, Callable[[], Any]] = {}
        self._serving_replica: Optional[int] = None

    # -- wiring --------------------------------------------------------------

    def bind_fleet(self, heartbeats: Optional[Callable[[], Any]] = None,
                   trace_tail: Optional[Callable[[], Any]] = None,
                   transport: Optional[Callable[[], Any]] = None) -> None:
        """Attach fleet-level evidence sources (zero-arg callables,
        each sampled at trigger time; a failing source is recorded as
        its error, never raised)."""
        for name, fn in (("heartbeats", heartbeats),
                         ("trace_tail", trace_tail),
                         ("transport", transport)):
            if fn is not None:
                self._fleet_ctx[name] = fn

    def _rstate(self, replica) -> Dict[str, Any]:
        st = self._rep.get(replica)
        if st is None:
            st = self._rep[replica] = {
                "tick_ring": collections.deque(maxlen=self._ring.maxlen),
                "records": collections.deque(maxlen=self._ring.maxlen),
                "static_ticks": 0, "last_engine_ticks": None,
                "accepts": collections.deque(maxlen=self.accept_window),
                "accept_healthy": False,
                "prefix": collections.deque(maxlen=self.prefix_window),
                "prefix_hits_total": 0,
                "queued": collections.deque(maxlen=self.queue_window),
                "retransmits": collections.deque(maxlen=self.window),
            }
        return st

    def reset(self) -> None:
        super().reset()
        self._rep.clear()

    # -- detection seams -----------------------------------------------------

    def observe_fleet_tick(self, replica, *, tick: int,
                           engine_ticks: Optional[int], queued: int,
                           busy: bool) -> List[Verdict]:
        """Feed one fleet-tick view of one live replica: the fleet's
        tick index, the replica's engine tick counter (its locally
        reported progress), queue depth, and whether it holds work."""
        st = self._rstate(replica)
        row = {"tick": int(tick), "engine_ticks": engine_ticks,
               "queued": int(queued), "busy": bool(busy)}
        st["tick_ring"].append(row)
        out: List[Verdict] = []
        if busy and engine_ticks is not None \
                and engine_ticks == st["last_engine_ticks"]:
            st["static_ticks"] += 1
        else:
            st["static_ticks"] = 0
        st["last_engine_ticks"] = engine_ticks
        if st["static_ticks"] >= self.stall_ticks:
            v = self._maybe_fire(replica, Verdict(
                kind="tick_stall", step=int(tick),
                value=float(st["static_ticks"]),
                threshold=float(self.stall_ticks),
                detail=(f"replica {replica} holds work but its engine "
                        f"tick counter has been static for "
                        f"{st['static_ticks']} consecutive fleet ticks "
                        f"(wedged child? stalled engine?)")), row)
            if v:
                out.append(v)
        st["queued"].append(int(queued))
        qs = st["queued"]
        if (len(qs) == qs.maxlen
                and all(b >= a for a, b in zip(qs, list(qs)[1:]))
                and qs[-1] - qs[0] >= self.queue_growth):
            v = self._maybe_fire(replica, Verdict(
                kind="queue_divergence", step=int(tick),
                value=float(qs[-1] - qs[0]),
                threshold=float(self.queue_growth),
                detail=(f"replica {replica} queue grew monotonically "
                        f"{qs[0]} -> {qs[-1]} over the last {len(qs)} "
                        f"ticks — arrivals have diverged from service "
                        f"rate")), row)
            if v:
                out.append(v)
        return out

    def observe_serving(self, replica, rec: Dict[str, Any]
                        ) -> List[Verdict]:
        """Feed one terminal ``kind="request"`` (or per-tick
        ``decode_tick``) record attributed to ``replica``."""
        if rec.get("kind") not in ("request", "decode_tick"):
            return []
        if rec.get("finish_reason") == "retried":
            return []
        st = self._rstate(replica)
        st["records"].append(dict(rec))
        out: List[Verdict] = []
        proposed = rec.get("draft_proposed") or 0
        if proposed:
            rate = (rec.get("draft_accepted") or 0) / proposed
            st["accepts"].append(rate)
            if rate > 2.0 * self.accept_floor:
                st["accept_healthy"] = True
            acc = st["accepts"]
            if (st["accept_healthy"] and len(acc) == acc.maxlen
                    and max(acc) <= self.accept_floor):
                v = self._maybe_fire(replica, Verdict(
                    kind="accept_collapse", step=rec.get("rid"),
                    value=round(max(acc), 4),
                    threshold=self.accept_floor,
                    detail=(f"replica {replica} draft accept-rate "
                            f"collapsed: last {len(acc)} draft-carrying "
                            f"requests all ≤ {self.accept_floor:.0%} "
                            f"after a healthy phase — the draft model "
                            f"has stopped predicting the target")), rec)
                if v:
                    out.append(v)
        hits = rec.get("prefix_hit_blocks")
        if hits is not None:
            st["prefix"].append(int(hits))
            st["prefix_hits_total"] += int(hits)
            pf = st["prefix"]
            before = st["prefix_hits_total"] - sum(pf)
            if len(pf) == pf.maxlen and sum(pf) == 0 and before > 0:
                v = self._maybe_fire(replica, Verdict(
                    kind="prefix_hit_collapse", step=rec.get("rid"),
                    value=0.0, threshold=1.0,
                    detail=(f"replica {replica} prefix-cache hits "
                            f"vanished: {before} blocks hit earlier, "
                            f"zero across the last {len(pf)} requests "
                            f"(retention evicted? affinity broken?)")),
                    rec)
                if v:
                    out.append(v)
        return out

    def observe_transport(self, replica, stats: Dict[str, Any]
                          ) -> List[Verdict]:
        """Feed a process replica's cumulative transport counters (the
        ``transport_stats()`` dict) once per fleet tick."""
        cur = stats.get("retransmits")
        if cur is None:
            return []
        st = self._rstate(replica)
        ring = st["retransmits"]
        rise = int(cur) - ring[0] if ring else 0
        ring.append(int(cur))
        if rise >= self.retransmit_burst_n:
            v = self._maybe_fire(replica, Verdict(
                kind="retransmit_burst", step=None, value=float(rise),
                threshold=float(self.retransmit_burst_n),
                detail=(f"replica {replica} transport retransmits rose "
                        f"by {rise} within the last {len(ring)} ticks — "
                        f"the link to that child is flapping")),
                dict(stats))
            return [v] if v else []
        return []

    # -- flight recorder -----------------------------------------------------

    def _maybe_fire(self, replica, verdict: Verdict,
                    rec: Dict[str, Any]) -> Optional[Verdict]:
        key = f"{verdict.kind}@r{replica}"
        if not self.rearm and key in self._fired:
            return None
        self._fired.add(key)
        self._serving_replica = replica
        try:
            self._trigger(verdict, rec)
        finally:
            self._serving_replica = None
        return verdict

    def _dump_bundle(self, verdict: Verdict, rec: Dict[str, Any]) -> str:
        rep = self._serving_replica
        if rep is None:
            return super()._dump_bundle(verdict, rec)
        seq = len(self.bundles)
        bundle = os.path.join(
            self.out_dir, f"anomaly_{seq:03d}_{verdict.kind}_r{rep}")
        os.makedirs(bundle, exist_ok=True)
        verdict.bundle = bundle
        st = self._rstate(rep)
        with open(os.path.join(bundle, "verdict.json"), "w") as f:
            json.dump({"ts": time.time(), "replica": rep,
                       "verdict": verdict.to_dict(),
                       "trigger_record": rec}, f, indent=2, default=str)
        with open(os.path.join(bundle, "tick_ring.jsonl"), "w") as f:
            for r in st["tick_ring"]:
                f.write(json.dumps(r, default=str) + "\n")
        with open(os.path.join(bundle, "records_tail.jsonl"), "w") as f:
            for r in st["records"]:
                f.write(json.dumps(r, default=str) + "\n")
        for name, fn in self._fleet_ctx.items():
            try:
                payload = fn()
            except Exception as e:
                payload = {"error": f"{type(e).__name__}: {e}"}
            fname = ("fleet_trace_tail.json" if name == "trace_tail"
                     else f"{name}.json")
            with open(os.path.join(bundle, fname), "w") as f:
                json.dump(payload, f, default=str)
        self.bundles.append(bundle)
        return bundle
