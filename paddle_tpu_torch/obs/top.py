"""``python -m paddle_tpu_torch.obs.top`` — live fleet text dashboard
.

Tails the evidence a serving fleet already writes to disk — heartbeat
files under ``<root>/heartbeats/`` (seq, age, queue depth, free
blocks/slots) and, when given, the telemetry JSONL of terminal request
records — and renders one screenful per interval: a per-replica
liveness table plus the streaming SLO block (:class:`SLOMonitor` over
the tail of the record stream: rolling p50/p95/p99 TTFT/TPOT, goodput,
error-budget burn rate).

Read-only by construction: it opens the same files the fleet writes
atomically and never talks to the fleet process, so it can watch a
drill, a bench run, or a production-style deployment without being
part of it. ``--once`` prints a single frame and exits (the testable
mode; also handy for cron/CI snapshots)::

    python -m paddle_tpu_torch.obs.top --root /tmp/fleet --jsonl tel.jsonl
    python -m paddle_tpu_torch.obs.top --root /tmp/fleet --once

The metrics block: when the record stream carries
``kind="metrics"`` registry snapshots (``fleet.emit_stats()`` with
``metrics=True``) — or a live :class:`~paddle_tpu_torch.obs.metrics.
MetricsHub` is passed to :func:`render` — each metric gets one line
with a unicode sparkline: counters render their per-snapshot RATE,
gauges their value history, histograms their bucket distribution.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

from ..parallel import multihost
from .report import load_records
from .slo import SLOMonitor, SLOTargets

__all__ = ["render", "main", "sparkline"]

_HB_COLS = ("seq", "queued", "running", "prefilling",
            "pending_new_tokens", "free_blocks", "free_slots")

_SPARK = "▁▂▃▄▅▆▇█"


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.2f}"
    return str(v)


def sparkline(values, width: int = 24) -> str:
    """Render a numeric series as a unicode sparkline, downsampled to
    ``width`` points (evenly strided). Constant series render flat at
    the lowest glyph; empty input renders empty."""
    vals = [float(v) for v in values if v is not None]
    if not vals:
        return ""
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int((v - lo) / (hi - lo) * len(_SPARK)))]
        for v in vals)


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}"
                          for k, v in sorted(labels.items())) + "}"


def _metrics_lines(hub=None,
                   snapshots: Optional[List[List[Dict[str, Any]]]] = None,
                   limit: int = 48) -> List[str]:
    """The metrics block: one ``name{labels}  <spark>  current`` line
    per labeled child. A live hub supplies ring-buffer history; a list
    of ``kind="metrics"`` snapshot payloads supplies per-snapshot
    history (counter lines show successive-difference rates either
    way; histogram lines show the bucket distribution + count/mean)."""
    series: "Dict[Tuple[str, Tuple], Dict[str, Any]]" = {}
    if hub is not None:
        snapshots = (snapshots or []) + [hub.snapshot()]
    for snap in snapshots or []:
        for row in snap:
            key = (row["name"],
                   tuple(sorted((row.get("labels") or {}).items())))
            ent = series.setdefault(
                key, {"type": row["type"],
                      "labels": dict(row.get("labels") or {}),
                      "values": [], "last": None})
            ent["last"] = row
            if row["type"] == "histogram":
                continue
            ent["values"].append(row.get("value"))
    if hub is not None:
        # ring-buffer history beats per-snapshot history when live
        for (name, lkey), ent in series.items():
            for q in hub.query(name, **dict(lkey)):
                if tuple(sorted(q["labels"].items())) == lkey:
                    vals = [v for _, v in q["samples"]]
                    if vals:
                        ent["values"] = vals
    lines: List[str] = []
    for (name, _), ent in sorted(series.items()):
        row = ent["last"]
        label = name + _label_str(ent["labels"])
        if ent["type"] == "histogram":
            counts = row.get("counts") or []
            cnt = row.get("count") or 0
            mean = (row["sum"] / cnt) if cnt else None
            lines.append(f"  {label:<44} {sparkline(counts):<24} "
                         f"n={cnt} mean={_fmt(mean)}")
            continue
        vals = [v for v in ent["values"] if v is not None]
        if ent["type"] == "counter":
            # rate: successive differences of the cumulative value
            deltas = [b - a for a, b in zip(vals, vals[1:])] or vals
            cur = vals[-1] if vals else None
            lines.append(f"  {label:<44} {sparkline(deltas):<24} "
                         f"total={_fmt(cur)}")
        else:
            cur = vals[-1] if vals else None
            lines.append(f"  {label:<44} {sparkline(vals):<24} "
                         f"now={_fmt(cur)}")
        if len(lines) >= limit:
            lines.append(f"  ... ({len(series) - limit} more)")
            break
    return lines


def render(root: Optional[str] = None, jsonl: Optional[str] = None, *,
           now: Optional[float] = None, window: int = 256,
           targets: Optional[SLOTargets] = None, hub=None) -> str:
    """One dashboard frame as a string (pure function of the files —
    what ``--once`` prints and what the test asserts on). ``hub``: an
    optional live :class:`~paddle_tpu_torch.obs.metrics.MetricsHub` to render
    the metrics block from directly (in-process dashboards/tests); the
    JSONL's ``kind="metrics"`` snapshots feed it otherwise."""
    now = time.time() if now is None else float(now)
    lines: List[str] = ["== paddle_tpu fleet top =="]
    beats: Dict[int, Dict] = (
        multihost.read_heartbeats(root) if root else {})
    if beats:
        hdr = ["replica", "age_s"] + list(_HB_COLS)
        rows = [hdr]
        for hid in sorted(beats):
            b = beats[hid]
            age = now - float(b.get("ts") or b.get("_mtime") or now)
            rows.append([str(hid), f"{age:.2f}"]
                        + [_fmt(b.get(c)) for c in _HB_COLS])
        widths = [max(len(r[i]) for r in rows)
                  for i in range(len(hdr))]
        for r in rows:
            lines.append("  " + "  ".join(
                c.rjust(w) for c, w in zip(r, widths)))
    else:
        lines.append("  (no heartbeats under "
                     f"{root!r})" if root else "  (no --root given)")
    snapshots: List[List[Dict[str, Any]]] = []
    if jsonl:
        mon = SLOMonitor(targets=targets, window=window)
        transport = 0
        fences = 0
        degrades = 0
        fleet_rec: Optional[Dict[str, Any]] = None
        try:
            records = load_records(jsonl)
        except OSError:
            records = []
        for rec in records:
            mon.observe(rec)
            if rec.get("kind") == "transport":
                transport += 1
            elif (rec.get("kind") == "fence"
                    and rec.get("source") != "replica"):
                # the child re-emits its own fence record post-readmit
                # (source="replica") — count the parent's verdicts only
                fences += 1
            elif rec.get("kind") == "degrade":
                degrades += 1
            elif rec.get("kind") == "fleet":
                fleet_rec = rec
            elif (rec.get("kind") == "metrics"
                    and rec.get("metrics") is not None):
                snapshots.append(rec["metrics"])
        rep = mon.report()
        lines.append("-- slo (streaming) --")
        lines.append(
            f"  requests={rep['requests']} retried="
            f"{rep['retried_attempts']} transport_events={transport}")
        lines.append(
            f"  goodput={_fmt(rep['goodput_pct'])}% window="
            f"{_fmt(rep['window_goodput_pct'])}% "
            f"burn_rate={_fmt(rep['burn_rate'])} "
            f"(budget {rep['error_budget_pct']}%)")
        for m in ("ttft_ms", "tpot_ms", "wall_ms"):
            lines.append(
                f"  {m}: p50={_fmt(rep[m + '_p50'])} "
                f"p95={_fmt(rep[m + '_p95'])} "
                f"p99={_fmt(rep[m + '_p99'])}")
        if rep["finish_reasons"]:
            reasons = " ".join(f"{k}={v}" for k, v in
                               sorted(rep["finish_reasons"].items()))
            lines.append(f"  finish: {reasons}")
        mb = (fleet_rec or {}).get("membership") or {}
        if fences or degrades or mb.get("readmitted") \
                or mb.get("false_deaths_averted"):
            # epoch-fenced membership: the fence/readmit
            # ledger plus the partition-degradation state, one line
            lines.append(
                f"  membership: fences={fences} "
                f"readmitted={mb.get('readmitted', 0)} "
                f"false_deaths_averted="
                f"{mb.get('false_deaths_averted', 0)} "
                f"degrade_events={degrades}"
                + (" [DEGRADED]" if mb.get("degraded") else ""))
        ch = (fleet_rec or {}).get("chaos") or {}
        if ch.get("frames_dropped") or ch.get("frames_delayed"):
            lines.append(
                f"  chaos: dropped={ch.get('frames_dropped', 0)} "
                f"delayed={ch.get('frames_delayed', 0)} "
                f"bytes_dropped={ch.get('bytes_dropped', 0)} "
                f"delay_s={ch.get('delay_injected_s', 0)}")
    if hub is not None or snapshots:
        mlines = _metrics_lines(hub=hub, snapshots=snapshots)
        if mlines:
            lines.append("-- metrics (registry) --")
            lines.extend(mlines)
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.obs.top",
        description="Live fleet dashboard over heartbeat files + "
                    "telemetry JSONL (read-only).")
    ap.add_argument("--root", default=None,
                    help="fleet root (reads <root>/heartbeats/)")
    ap.add_argument("--jsonl", default=None,
                    help="telemetry JSONL of request records")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="refresh period in seconds")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    ap.add_argument("--window", type=int, default=256,
                    help="burn-rate rolling window (requests)")
    ap.add_argument("--slo-goodput", type=float, default=99.0,
                    help="goodput objective in percent")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="optional absolute TTFT target (ms)")
    args = ap.parse_args(argv)
    targets = SLOTargets(goodput_pct=args.slo_goodput,
                         ttft_ms=args.slo_ttft_ms)
    while True:
        frame = render(args.root, args.jsonl, window=args.window,
                       targets=targets)
        if args.once:
            print(frame)
            return 0
        # clear + home, then the frame — plain ANSI, no curses dep
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0


if __name__ == "__main__":                      # pragma: no cover
    raise SystemExit(main())
