"""Run-summary CLI over a telemetry JSONL.

``python -m paddle_tpu_torch.obs.report run.jsonl`` prints one table a human
can read off a finished (or crashed) run's telemetry file: throughput,
MFU, compiles/retraces, pipeline overlap, anomalies, and the step-time
breakdown — the ``printAllStatus`` successor for files instead of
processes.

The final ``summary`` record (``Telemetry.close()``) is the
preferred source when present — it already aggregates the run the way
``Telemetry.summary()`` does (honest pipelined rates from record
timestamps, profiled records excluded). Without one (a crashed run that
never closed), the CLI falls back to aggregating the step records
directly, so a truncated JSONL still reports. ``kind="anomaly"`` records
(the Trainer echoes every detector verdict into the stream) and
NaN-sanitized losses feed the anomalies row.

``--json`` prints the summary dict instead of the table (machine
consumers); a rotated ``<path>.1`` sibling (``JsonlSink(max_bytes=...)``)
is read first automatically so the window spans both files.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
from typing import Any, Dict, List, Optional

from .percentiles import (summarize_handoffs, summarize_requests,
                          summarize_scale)

__all__ = ["load_records", "summarize", "format_summary", "main"]


def load_records(path: str, include_rotated: bool = True
                 ) -> List[Dict[str, Any]]:
    """Parse a telemetry JSONL back into record dicts; a rotated
    ``<path>.1`` sibling is prepended when present (oldest first).
    Truncated trailing lines (a crash mid-write is the use case) are
    skipped, not fatal."""
    paths = []
    if include_rotated and os.path.exists(path + ".1"):
        paths.append(path + ".1")
    paths.append(path)
    out: List[Dict[str, Any]] = []
    for p in paths:
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return out


def _mean(vals: List[float]) -> Optional[float]:
    vals = [v for v in vals if v is not None]
    return round(sum(vals) / len(vals), 4) if vals else None


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Aggregate a record stream into the run-summary dict the table
    renders. Prefers the final ``summary`` record; derives everything it
    can from the step records otherwise."""
    steps = [r for r in records if r.get("kind") == "step"]
    compiles = [r for r in records if r.get("kind") == "compile"]
    anomalies = [r for r in records if r.get("kind") == "anomaly"]
    attributions = [r for r in records if r.get("kind") == "attribution"]
    summary_rec = next((r for r in reversed(records)
                        if r.get("kind") == "summary"), None)

    out: Dict[str, Any] = {
        "records": len(records),
        "steps": len(steps),
        "optimizer_steps": sum(int(r.get("k_steps") or 1) for r in steps),
        "compiles": len(compiles),
        "compile_wall_s": round(sum(r.get("wall_s") or 0.0
                                    for r in compiles), 3),
        "anomalies": len(anomalies),
        # the Trainer echoes each Verdict with its trigger kind renamed
        # to anomaly_kind (the record "kind" slot holds "anomaly")
        "anomaly_kinds": sorted({a.get("anomaly_kind") or "?"
                                 for a in anomalies}),
        "attribution_reports": len(attributions),
        "from_summary_record": summary_rec is not None,
    }

    nan_steps = sum(1 for r in steps
                    if (r.get("nonfinite_count") or 0) > 0
                    or ("loss" in r and r.get("loss") is None))
    out["nonfinite_steps"] = nan_steps

    if steps:
        last = steps[-1]
        out["last_step"] = last.get("step")
        out["last_loss"] = last.get("loss")
        out["retraces"] = last.get("retrace_count")
        span = steps[-1].get("ts", 0) - steps[0].get("ts", 0)
        done = sum(int(r.get("k_steps") or 1) for r in steps[1:])
        if span > 0 and done:
            out["steps_per_sec"] = round(done / span, 3)
        out["est_mfu_pct"] = next(
            (r.get("est_mfu_pct") for r in reversed(steps)
             if r.get("est_mfu_pct") is not None), None)
        out["tokens_per_sec"] = next(
            (r.get("tokens_per_sec") for r in reversed(steps)
             if r.get("tokens_per_sec") is not None), None)
        for key in ("host_stack_ms", "shard_ms", "dispatch_ms", "device_ms",
                    "replay_ms", "stage_ms", "drain_wait_ms",
                    "overlap_frac"):
            m = _mean([r.get(key) for r in steps if not r.get("profiled")])
            if m is not None:
                out[f"mean_{key}"] = m
        out["peak_bytes"] = max((r.get("peak_bytes") or 0 for r in steps),
                                default=0) or None

    if summary_rec is not None:
        # the close-time aggregate wins where it exists (it excludes
        # profiled records and derives pipelined rates honestly)
        for key, val in summary_rec.items():
            if key in ("kind", "ts"):
                continue
            if val is not None:
                out[key] = val
    if attributions:
        att = attributions[-1]
        out["attribution_est_mfu_pct"] = att.get("est_mfu_pct")
        comm = att.get("comm") or {}
        out["attribution_exposed_comm_ms"] = comm.get("exposed_ms")
    # serving SLO percentiles: p50/p95/p99 TTFT/TPOT +
    # goodput-under-deadline over kind="request" records, when present
    serving = summarize_requests(records)
    if serving is not None:
        out["serving"] = serving
    # autoscaler decisions: kind="scale" events aggregate
    # into the serving block (up/down/replace counts, final capacity)
    scale = summarize_scale(records)
    if scale is not None:
        out.setdefault("serving", {})["scale"] = scale
    # prefill→decode KV handoffs: kind="kv_handoff" events
    # aggregate into the serving block (count, wire bytes, quant mix)
    handoffs = summarize_handoffs(records)
    if handoffs is not None:
        out.setdefault("serving", {})["handoffs"] = handoffs
    # transport-fault counters: the fleet counts
    # retransmits/timeouts/corrupt replies in `fleet.stats()` but the
    # report rendered none of it. Prefer the fleet's own aggregate
    # record (`fleet.emit_stats()`, carries retransmits — those never
    # appear as stream events); fall back to counting the transport
    # events the stream does carry.
    fleet_rec = next((r for r in reversed(records)
                      if r.get("kind") == "fleet"), None)
    tev = [r for r in records if r.get("kind") == "transport"]
    transport: Optional[Dict[str, Any]] = None
    # registry read-through: when the stream
    # carries a `kind="metrics"` snapshot, the per-link transport_*
    # counters ARE the totals (incremented at the same sites as the
    # attribute counters) — sum them across links. The fleet-record /
    # classified-event paths stay the dark-mode fallbacks.
    met_rec = next((r for r in reversed(records)
                    if r.get("kind") == "metrics"), None)
    if met_rec is not None:
        tot: Dict[str, int] = {}
        for row in met_rec.get("metrics") or ():
            name = row.get("name") or ""
            if (name.startswith("transport_")
                    and row.get("type") == "counter"
                    and name[len("transport_"):] in (
                        "errors", "retransmits", "timeouts",
                        "corrupt_replies")):
                k = name[len("transport_"):]
                tot[k] = tot.get(k, 0) + int(row.get("value") or 0)
        if tot:
            transport = {"errors": 0, "retransmits": 0, "timeouts": 0,
                         "corrupt_replies": 0, **tot}
    if transport is None and fleet_rec is not None \
            and fleet_rec.get("transport") is not None:
        transport = dict(fleet_rec["transport"])
    elif transport is None and tev:
        transport = dict(collections.Counter(
            r.get("event") or "?" for r in tev))
    if transport is not None:
        transport["events"] = len(tev)
        out.setdefault("serving", {})["transport"] = transport
    # the streaming-SLO aggregate (burn rate etc.) rides the same
    # fleet record when the monitor was on
    if fleet_rec is not None and fleet_rec.get("slo") is not None:
        out.setdefault("serving", {})["slo"] = fleet_rec["slo"]
    # epoch-fenced membership: prefer the fleet record's
    # counters — a fence can appear TWICE in the raw stream (the
    # parent's authoritative record plus the child's own forensics
    # record, tagged source="replica" and shipped post-readmit), so
    # raw kind="fence" counting is the dark fallback only, restricted
    # to the parent-side records.
    fences = [r for r in records if r.get("kind") == "fence"]
    degrades = [r for r in records if r.get("kind") == "degrade"]
    membership: Optional[Dict[str, Any]] = None
    if fleet_rec is not None and fleet_rec.get("membership") is not None:
        membership = dict(fleet_rec["membership"])
    elif fences or degrades:
        membership = {
            "fences": sum(1 for r in fences
                          if r.get("source") != "replica"),
            "readmitted": 0, "false_deaths_averted": 0,
            "degradations": sum(1 for r in degrades
                                if r.get("event") == "engaged"),
        }
    if membership is not None:
        membership["fence_records"] = len(fences)
        reasons = collections.Counter(
            r.get("reason") or "?" for r in fences
            if r.get("source") != "replica")
        if reasons:
            membership["fence_reasons"] = dict(reasons)
        if degrades:
            membership["degrade_events"] = len(degrades)
        if fleet_rec is not None and fleet_rec.get("chaos") is not None:
            membership["chaos"] = fleet_rec["chaos"]
        out.setdefault("serving", {})["membership"] = membership
    return out


_ROWS = (
    ("records", "records"),
    ("steps (records / optimizer)", None),        # composite
    ("steps/sec", "steps_per_sec"),
    ("pipelined steps/sec", "pipelined_steps_per_sec"),
    ("tokens/sec", "tokens_per_sec"),
    ("est MFU %", "est_mfu_pct"),
    ("static-attribution MFU %", "attribution_est_mfu_pct"),
    ("exposed comm ms (static)", "attribution_exposed_comm_ms"),
    ("compiles / retraces", None),                # composite
    ("compile wall s", "compile_wall_s"),
    ("mean dispatch ms", "mean_dispatch_ms"),
    ("mean device ms", "mean_device_ms"),
    ("mean stage ms", "mean_stage_ms"),
    ("mean drain wait ms", "mean_drain_wait_ms"),
    ("mean overlap frac", "mean_overlap_frac"),
    ("peak device bytes", "peak_bytes"),
    ("last step / loss", None),                   # composite
    ("nonfinite steps", "nonfinite_steps"),
    ("anomalies", None),                          # composite
    ("stager leaked", "stager_leaked"),
)


def format_summary(s: Dict[str, Any]) -> str:
    """Fixed-width table of one run summary."""
    lines = ["telemetry run summary"
             + ("  (from final summary record)"
                if s.get("from_summary_record") else "  (no summary record"
                " — aggregated from step records)")]
    for label, key in _ROWS:
        if key is None:
            if label.startswith("steps "):
                val = f"{s.get('steps')} / {s.get('optimizer_steps')}"
            elif label.startswith("compiles"):
                val = f"{s.get('compiles')} / {s.get('retraces', 0)}"
            elif label.startswith("last step"):
                if s.get("last_step") is None:
                    continue
                val = f"{s.get('last_step')} / {s.get('last_loss')}"
            else:
                n = s.get("anomalies", 0)
                if not n:
                    val = "0"
                else:
                    val = f"{n} ({', '.join(s.get('anomaly_kinds', []))})"
        else:
            val = s.get(key)
            if val is None:
                continue
        lines.append(f"  {label:<28}{val}")
    sv = s.get("serving")
    if sv and sv.get("requests") is not None:
        lines.append("serving requests")
        lines.append(f"  {'requests (terminal / retried)':<28}"
                     f"{sv.get('requests')} / "
                     f"{sv.get('retried_attempts')}")
        reasons = sv.get("finish_reasons") or {}
        if reasons:
            lines.append(f"  {'finish reasons':<28}"
                         + ", ".join(f"{k}={v}"
                                     for k, v in sorted(reasons.items())))
        for key, label in (("ttft_ms", "TTFT ms"),
                           ("tpot_ms", "TPOT ms"),
                           ("wall_ms", "wall ms")):
            ps = [sv.get(f"{key}_p{p}") for p in (50, 95, 99)]
            if any(v is not None for v in ps):
                lines.append(f"  {label + ' p50/p95/p99':<28}"
                             + " / ".join(str(v) for v in ps))
        if sv.get("goodput_pct") is not None:
            lines.append(f"  {'goodput under deadline':<28}"
                         f"{sv['goodput_pct']}% "
                         f"({sv.get('deadline_met')}/"
                         f"{sv.get('deadline_requests')}, "
                         f"{sv.get('goodput_tokens')} tokens)")
        # serving-throughput aggregates: only rendered when
        # the engine features actually fired
        if sv.get("prefix_hit_blocks"):
            lines.append(f"  {'prefix-cache block sharing':<28}"
                         f"{sv['prefix_hit_blocks']} blocks "
                         f"({sv.get('block_sharing_ratio')} of reserved, "
                         f"{sv.get('cow_forks', 0)} COW forks)")
        if sv.get("draft_accept_rate") is not None:
            lines.append(f"  {'speculative accept rate':<28}"
                         f"{sv['draft_accept_rate']}")
        if sv.get("prefill_chunks"):
            lines.append(f"  {'prefill chunks':<28}"
                         f"{sv['prefill_chunks']}")
        # retention + KV-capacity rows: rendered when the
        # retained LRU actually served hits / the stream carries the
        # pool's byte accounting
        if sv.get("retained_hits"):
            lines.append(f"  {'retained prefix hits':<28}"
                         f"{sv['retained_hits']} blocks "
                         f"(rate {sv.get('retention_hit_rate')}, "
                         f"{sv.get('retained_blocks')} retained now)")
        if sv.get("kv_bytes_per_token") is not None:
            tp = sv.get("tp_degree") or 1
            lines.append(f"  {'KV bytes/token':<28}"
                         f"{sv['kv_bytes_per_token']} "
                         f"({sv.get('quant_dtype')}"
                         + (f", per shard)" if tp > 1 else ")"))
        # the serving mesh shape: rendered whenever the tick
        # stream says the engine ran tensor-parallel
        if (sv.get("tp_degree") or 1) > 1:
            lines.append(f"  {'tensor-parallel mesh':<28}"
                         f"tp={sv['tp_degree']} "
                         f"(head-sharded KV, per-shard bytes)")
    # prefill→decode KV handoffs — rendered whenever the
    # disaggregated fleet actually streamed pages
    ho = (sv or {}).get("handoffs")
    if ho:
        lines.append("kv handoffs")
        lines.append(f"  {'handoffs (blocks / bytes)':<28}"
                     f"{ho['handoffs']} ({ho['blocks']} / "
                     f"{ho['wire_bytes']})")
        if ho.get("transfer_ms_mean") is not None:
            lines.append(f"  {'transfer ms mean/p95':<28}"
                         f"{ho['transfer_ms_mean']} / "
                         f"{ho.get('transfer_ms_p95')}")
        quants = ho.get("by_quant") or {}
        if quants:
            lines.append(f"  {'quant mix':<28}"
                         + ", ".join(f"{k}={v}" for k, v in
                                     sorted(quants.items())))
    # autoscaler decisions — rendered whenever scale events
    # exist, even for a stream with no request records
    sc = (sv or {}).get("scale")
    if sc:
        lines.append("autoscaler")
        lines.append(f"  {'scale events (up/down/repl)':<28}"
                     f"{sc['events']} ({sc['up']}/{sc['down']}/"
                     f"{sc['replace']})")
        lines.append(f"  {'final replicas':<28}{sc['final_replicas']}")
        reasons = sc.get("reasons") or {}
        if reasons:
            lines.append(f"  {'scale reasons':<28}"
                         + ", ".join(f"{k}={v}" for k, v in
                                     sorted(reasons.items())))
    # transport-fault counters — like the
    # autoscaler block, rendered whenever the evidence exists, even for
    # a stream with no request records
    tr = (sv or {}).get("transport")
    if tr:
        lines.append("transport")
        lines.append(f"  {'retransmits/timeouts/corrupt':<28}"
                     f"{tr.get('retransmits', 0)} / "
                     f"{tr.get('timeouts', tr.get('timeout', 0))} / "
                     f"{tr.get('corrupt_replies', tr.get('corrupt', 0))}")
        if tr.get("errors") is not None:
            lines.append(f"  {'transport errors':<28}{tr['errors']}")
        if tr.get("events"):
            lines.append(f"  {'transport events in stream':<28}"
                         f"{tr['events']}")
    # epoch-fenced membership + chaos plane — rendered
    # whenever fences, re-admissions or degradations happened
    mb = (sv or {}).get("membership")
    if mb and (mb.get("fences") or mb.get("readmitted")
               or mb.get("false_deaths_averted")
               or mb.get("degradations") or mb.get("chaos")):
        lines.append("membership")
        lines.append(f"  {'fences / readmitted':<28}"
                     f"{mb.get('fences', 0)} / {mb.get('readmitted', 0)}")
        if mb.get("false_deaths_averted"):
            lines.append(f"  {'false deaths averted':<28}"
                         f"{mb['false_deaths_averted']}")
        stale = (mb.get("stale_epoch_replies", 0)
                 + mb.get("stale_epoch_handoffs", 0)
                 + mb.get("stale_metric_deltas", 0))
        if stale:
            lines.append(f"  {'stale-epoch discards':<28}{stale} "
                         f"(replies {mb.get('stale_epoch_replies', 0)}, "
                         f"handoffs {mb.get('stale_epoch_handoffs', 0)}, "
                         f"metrics {mb.get('stale_metric_deltas', 0)})")
        reasons = mb.get("fence_reasons") or {}
        if reasons:
            lines.append(f"  {'fence reasons':<28}"
                         + ", ".join(f"{k}={v}" for k, v in
                                     sorted(reasons.items())))
        if mb.get("degradations"):
            lines.append(f"  {'degradations (engaged/rel.)':<28}"
                         f"{mb.get('degradations', 0)}/"
                         f"{mb.get('degrade_releases', 0)}"
                         + (" [degraded now]" if mb.get("degraded")
                            else ""))
        ch = mb.get("chaos")
        if ch:
            lines.append(f"  {'chaos frames drop/delay':<28}"
                         f"{ch.get('frames_dropped', 0)} / "
                         f"{ch.get('frames_delayed', 0)} "
                         f"({ch.get('bytes_dropped', 0)} bytes dropped, "
                         f"{ch.get('delay_injected_s', 0)}s injected)")
    slo = (sv or {}).get("slo")
    if slo:
        lines.append("slo (streaming)")
        lines.append(f"  {'burn rate':<28}{slo.get('burn_rate')} "
                     f"(budget {slo.get('error_budget_pct')}%, window "
                     f"goodput {slo.get('window_goodput_pct')}%)")
        ps = [slo.get(f"ttft_ms_p{p}") for p in (50, 95, 99)]
        if any(v is not None for v in ps):
            lines.append(f"  {'TTFT ms p50/p95/p99 (P2)':<28}"
                         + " / ".join(str(v) for v in ps))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.obs.report",
        description="Run-summary table from a telemetry JSONL "
                    "(throughput, MFU, retraces, overlap, anomalies).")
    p.add_argument("jsonl", help="telemetry JSONL path (a rotated "
                                 "<path>.1 sibling is read automatically)")
    p.add_argument("--json", action="store_true",
                   help="print the summary dict as JSON instead")
    args = p.parse_args(argv)
    try:
        records = load_records(args.jsonl)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not records:
        print("error: no records parsed", file=sys.stderr)
        return 2
    s = summarize(records)
    print(json.dumps(s) if args.json else format_summary(s))
    return 0


if __name__ == "__main__":
    sys.exit(main())
