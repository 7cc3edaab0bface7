"""Fleet trace merge: one Chrome/Perfetto timeline from many tracers
.

A fleet drill produces span batches from several uncoordinated
:class:`~paddle_tpu_torch.obs.trace.Tracer` instances — the router's own, one
per in-process replica, and batches shipped back from subprocess
replicas piggybacked on tick replies. Each batch is internally
consistent (one time base: the fleet clock every message already
carries) but the identifiers are not mergeable as-is: every child
stamps its OS pid and OS thread idents, which collide across forks and
are nondeterministic run-to-run.

:func:`merge_fleet_trace` canonicalizes into ONE trace:

- **Lanes**: pid 0 is the fleet router; replica *r* becomes pid
  ``r + 1`` (named ``replica r``) regardless of the OS pid its spans
  were stamped with. Shipped ``ph="M"`` metadata is dropped and fresh
  process/thread names are emitted, so the viewer shows stable lanes.
- **Tids** are canonicalized per lane in first-appearance order (OS
  idents are nondeterministic; first-appearance order over a
  SimClock-stamped stream is not).
- **Flows**: spans already carry ``s``/``t``/``f`` flow events keyed by
  rid (the globally unique request id IS the flow id), so a request
  that is submitted at the router, killed with replica 0, resubmitted,
  and finished on replica 1 renders as one connected arrow chain
  across three lanes. :func:`flow_connected` checks exactly that.
- Events are stable-sorted by timestamp — with a SimClock drill the
  merged ``traceEvents`` list is deterministic across runs
  (``tests/test_fleet_obs.py`` pins it).
"""

from __future__ import annotations

import collections
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = ["merge_fleet_trace", "save_fleet_trace", "flow_summary",
           "flow_connected", "lane_monotonic"]

ROUTER_PID = 0

# equal-timestamp tie-break: flow starts sort before everything, flow
# ends after everything (see merge_fleet_trace)
_FLOW_PHASE_ORDER = {"s": 0, "f": 2}


def _canon(events: Iterable[Dict[str, Any]], pid: int,
           tidmap: Dict[Tuple[int, int], int]) -> List[Dict[str, Any]]:
    out = []
    for ev in events:
        if ev.get("ph") == "M":
            continue                 # re-emitted fresh per lane below
        ev = dict(ev)
        key = (pid, ev.get("tid", 0))
        if key not in tidmap:
            tidmap[key] = len([k for k in tidmap if k[0] == pid]) + 1
        ev["pid"] = pid
        ev["tid"] = tidmap[key]
        out.append(ev)
    return out


def merge_fleet_trace(
        router_events: Iterable[Dict[str, Any]],
        replica_events: Mapping[int, Iterable[Dict[str, Any]]],
        tail: Optional[int] = None) -> Dict[str, Any]:
    """Merge the router's events and per-replica span batches into one
    Chrome Trace Event Format dict. ``replica_events`` maps replica id
    → its (possibly concatenated) event batches; ``tail`` keeps only
    the most recent N non-metadata events after sorting (the anomaly
    bundle's flight-recorder view)."""
    tidmap: Dict[Tuple[int, int], int] = {}
    meta: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": ROUTER_PID, "tid": 0,
         "args": {"name": "fleet-router"}}]
    merged = _canon(router_events, ROUTER_PID, tidmap)
    for rid in sorted(replica_events):
        pid = int(rid) + 1
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": f"replica {rid}"}})
        merged.extend(_canon(replica_events[rid], pid, tidmap))
    # stable sort: equal-ts events keep lane/emit order, so SimClock
    # drills (many spans sharing one tick timestamp) stay deterministic.
    # Flow phases tie-break at equal ts ("s" first, "f" last): a
    # SimClock tick collapses a request's last decode, its finish and
    # its fleet-side terminal onto ONE timestamp, and journey order —
    # which flow_connected() audits — must still read s..t..f
    merged.sort(key=lambda e: (e.get("ts", -1.0),
                               _FLOW_PHASE_ORDER.get(e.get("ph"), 1)))
    if tail is not None and tail >= 0:
        merged = merged[-int(tail):] if tail else []
    return {"traceEvents": meta + merged, "displayTimeUnit": "ms",
            "otherData": {"producer": "paddle_tpu_torch.obs.fleet_trace",
                          "clock": "fleet clock (absolute us)",
                          "replicas": sorted(int(r)
                                             for r in replica_events)}}


def save_fleet_trace(trace: Dict[str, Any], path: str) -> str:
    """Write a merged trace as JSON (open in ui.perfetto.dev)."""
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def flow_summary(trace: Dict[str, Any]
                 ) -> Dict[int, List[Tuple[str, int]]]:
    """Flow id → the ordered ``(phase, pid)`` list of its flow events
    — the cross-process skeleton of each request's journey."""
    flows: Dict[int, List[Tuple[str, int]]] = collections.defaultdict(list)
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") in ("s", "t", "f") and ev.get("cat") == "flow":
            flows[int(ev["id"])].append((ev["ph"], ev.get("pid", -1)))
    return dict(flows)


def flow_connected(trace: Dict[str, Any], fid: int) -> bool:
    """True iff flow ``fid`` is one well-formed chain: starts with
    ``s``, ends with ``f``, every middle hop is ``t``. (Events are
    timestamp-ordered by the merge, so list order is journey order.)"""
    phases = [ph for ph, _ in flow_summary(trace).get(int(fid), [])]
    if len(phases) < 2 or phases[0] != "s" or phases[-1] != "f":
        return False
    return all(ph == "t" for ph in phases[1:-1])


def lane_monotonic(trace: Dict[str, Any]) -> bool:
    """True iff every lane's (pid's) non-metadata events are
    timestamp-monotonic — the merge-order sanity check the
    determinism test asserts."""
    last: Dict[int, float] = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "M":
            continue
        pid, ts = ev.get("pid", -1), ev.get("ts", 0.0)
        if ts < last.get(pid, float("-inf")):
            return False
        last[pid] = ts
    return True
