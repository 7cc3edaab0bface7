"""Serving SLO percentile aggregation: p50/p95/p99
TTFT/TPOT and goodput-under-deadline over ``kind="request"`` telemetry
records, so scheduling policies are comparable as NUMBERS, not logs —
the SJF-vs-FCFS differential in the bench fleet gate is exactly two of
these summaries diffed.

Definitions (the serving-SLO vocabulary the scheduler emits):

- **TTFT / TPOT / wall percentiles** are computed over TERMINAL records
  only — ``finish_reason="retried"`` rows are resubmission lineage, not
  outcomes (counting them would double-weight every request a replica
  death touched).
- **Goodput-under-deadline**: of the deadline-carrying terminal
  requests, the fraction that actually FINISHED (``"length"``/``"eos"``)
  within their deadline. Timed-out, shed, and late completions all count
  against it — goodput is the number that keeps overload honest, because
  raw throughput still looks fine while every request misses its SLO.
- Percentiles use the **nearest-rank** method (no interpolation):
  deterministic, exact on small CI-sized samples, and p99 of N<100
  requests degrades to the max rather than inventing a value.
"""

from __future__ import annotations

import collections
import math
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["percentile", "P2Quantile", "summarize_requests",
           "summarize_scale", "summarize_handoffs", "GOODPUT_REASONS"]

# finish reasons that count as useful completed work
GOODPUT_REASONS = ("length", "eos")


def percentile(values: Iterable[Optional[float]],
               p: float) -> Optional[float]:
    """Nearest-rank percentile of the non-None values (None if empty):
    the smallest value with at least ``p``% of the sample at or below
    it. ``p=50`` of [1,2,3,4] is 2; ``p=99`` of any sample <= 100 items
    is the max."""
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    k = max(1, int(math.ceil(p / 100.0 * len(vals))))
    return vals[min(k, len(vals)) - 1]


class P2Quantile:
    """Streaming quantile estimate — the P² algorithm (Jain & Chlamtac,
    CACM 1985): five markers tracking (min, p/2, p, (1+p)/2, max) whose
    heights are adjusted with a piecewise-parabolic fit as observations
    arrive. O(1) memory and O(1) per observation, which is the point
: :func:`summarize_requests` is batch-only — it needs
    every record in hand — while a live SLO monitor must answer "what
    is p99 TTFT *right now*" over an unbounded stream. P² over a
    reservoir sample because the estimate is deterministic for a given
    stream (SimClock drills stay reproducible) and never holds more
    than five floats.

    Below five observations the estimate is EXACT: the raw values are
    kept and :meth:`value` answers with the same nearest-rank rule as
    :func:`percentile` (p99 of a 3-sample stream is the max, not an
    extrapolation).
    """

    def __init__(self, p: float):
        if not 0.0 < p < 100.0:
            raise ValueError(f"p must be in (0, 100), got {p}")
        self.p = float(p) / 100.0
        self.n = 0
        self._q: List[float] = []          # marker heights
        self._pos: List[float] = []        # actual marker positions
        self._want: List[float] = []       # desired marker positions
        self._dpos: List[float] = []       # desired-position increments

    def observe(self, x: float) -> None:
        x = float(x)
        self.n += 1
        if self.n <= 5:
            self._q.append(x)
            self._q.sort()
            if self.n == 5:
                p = self.p
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._want = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p,
                              3.0 + 2.0 * p, 5.0]
                self._dpos = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]
            return
        q, pos = self._q, self._pos
        # locate the cell; clamp the extremes to the observation
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if q[i] <= x < q[i + 1])
        for i in range(k + 1, 5):
            pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._dpos[i]
        # adjust the three interior markers toward their desired
        # positions — parabolic when the fit stays monotone, linear
        # otherwise (the P² fallback rule)
        for i in (1, 2, 3):
            d = self._want[i] - pos[i]
            if ((d >= 1.0 and pos[i + 1] - pos[i] > 1.0)
                    or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0)):
                d = 1.0 if d >= 1.0 else -1.0
                qn = q[i] + d / (pos[i + 1] - pos[i - 1]) * (
                    (pos[i] - pos[i - 1] + d) * (q[i + 1] - q[i])
                    / (pos[i + 1] - pos[i])
                    + (pos[i + 1] - pos[i] - d) * (q[i] - q[i - 1])
                    / (pos[i] - pos[i - 1]))
                if not q[i - 1] < qn < q[i + 1]:
                    j = i + int(d)
                    qn = q[i] + d * (q[j] - q[i]) / (pos[j] - pos[i])
                q[i] = qn
                pos[i] += d

    def value(self) -> Optional[float]:
        """The current estimate (None before any observation)."""
        if self.n == 0:
            return None
        if self.n < 5:
            return percentile(self._q, self.p * 100.0)
        return self._q[2]


def summarize_requests(records: List[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    """Aggregate ``kind="request"`` records into the SLO summary dict
    (None when the stream has no request records — training-only runs
    don't grow a serving block). See module docstring for semantics."""
    reqs = [r for r in records if r.get("kind") == "request"]
    if not reqs:
        return None
    terminal = [r for r in reqs if r.get("finish_reason") != "retried"]
    out: Dict[str, Any] = {
        "requests": len(terminal),
        "retried_attempts": len(reqs) - len(terminal),
        "finish_reasons": dict(collections.Counter(
            r.get("finish_reason") or "?" for r in terminal)),
        "new_tokens_total": sum(r.get("new_tokens") or 0
                                for r in terminal),
    }
    # latency percentiles exclude shed records: a shed does no work and
    # records wall_ms=0 by construction, so counting it would make p50
    # wall IMPROVE exactly when overload is worst. Timeouts stay in —
    # their latency was genuinely experienced.
    latency = [r for r in terminal if r.get("finish_reason") != "shed"]
    for key in ("ttft_ms", "tpot_ms", "wall_ms"):
        vals = [r.get(key) for r in latency]
        for p in (50, 95, 99):
            v = percentile(vals, p)
            out[f"{key}_p{p}"] = round(v, 4) if v is not None else None
    # serving-throughput aggregates: how much of the paged
    # pool the prefix cache deduplicated, how often COW actually forked,
    # and what fraction of speculative drafts the target model accepted
    hit = sum(r.get("prefix_hit_blocks") or 0 for r in terminal)
    reserved = sum(r.get("blocks_reserved") or 0 for r in terminal)
    out["prefix_hit_blocks"] = hit
    out["block_sharing_ratio"] = (round(hit / reserved, 4)
                                  if reserved else None)
    out["cow_forks"] = sum(r.get("cow_forks") or 0 for r in terminal)
    out["prefill_chunks"] = sum(r.get("prefill_chunks") or 0
                                for r in terminal)
    # weighted by draft volume, not a mean of per-request ratios — a
    # 2-draft request must not average equally with a 500-draft one
    proposed = sum(r.get("draft_proposed") or 0 for r in terminal)
    accepted = sum(r.get("draft_accepted") or 0 for r in terminal)
    out["draft_accept_rate"] = (round(accepted / proposed, 4)
                                if proposed else None)
    # retention + KV-capacity accounting: retained-LRU hits
    # ride the decode_tick stream as per-tick deltas; the hit RATE is
    # retained hits over all adopted prefix blocks (what fraction of
    # sharing came from blocks no live sequence held). kv_bytes_per_token
    # and quant_dtype are gauges — the last tick's value wins.
    ticks = [r for r in records if r.get("kind") == "decode_tick"]
    if ticks:
        rh = sum(r.get("retained_hits") or 0 for r in ticks)
        out["retained_hits"] = rh
        # rate over the SAME stream's adoption deltas (tick records
        # carry prefix_hit_blocks deltas too) — a terminal-record
        # denominator would mix attempt populations and could exceed 1
        tick_hits = sum(r.get("prefix_hit_blocks") or 0 for r in ticks)
        out["retention_hit_rate"] = (round(rh / tick_hits, 4)
                                     if tick_hits else None)
        out["retained_blocks"] = next(
            (r.get("retained_blocks") for r in reversed(ticks)
             if r.get("retained_blocks") is not None), None)
        out["kv_bytes_per_token"] = next(
            (r.get("kv_bytes_per_token") for r in reversed(ticks)
             if r.get("kv_bytes_per_token") is not None), None)
        out["quant_dtype"] = next(
            (r.get("quant_dtype") for r in reversed(ticks)
             if r.get("quant_dtype") is not None), None)
        # tensor-parallel mesh width: a gauge like the rest —
        # with tp > 1 the kv_bytes_per_token above is PER SHARD
        out["tp_degree"] = next(
            (r.get("tp_degree") for r in reversed(ticks)
             if r.get("tp_degree") is not None), None)
    dl = [r for r in terminal if r.get("deadline_s") is not None]
    met = [r for r in dl
           if r.get("finish_reason") in GOODPUT_REASONS
           and r.get("wall_ms") is not None
           and r["wall_ms"] <= r["deadline_s"] * 1e3]
    out["deadline_requests"] = len(dl)
    out["deadline_met"] = len(met)
    out["goodput_pct"] = (round(100.0 * len(met) / len(dl), 2)
                          if dl else None)
    out["goodput_tokens"] = sum(r.get("new_tokens") or 0 for r in met)
    out["shed"] = out["finish_reasons"].get("shed", 0)
    out["timeout"] = out["finish_reasons"].get("timeout", 0)
    return out


def summarize_scale(records: List[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    """Aggregate the autoscaler's ``kind="scale"`` events: how often
    capacity moved, which way, why, and where it ended up — so an
    elastic run is judgeable as numbers next to its latency percentiles.
    None when the stream has no scale events (fixed-capacity fleets
    don't grow the block)."""
    evs = [r for r in records if r.get("kind") == "scale"]
    if not evs:
        return None
    actions = collections.Counter(r.get("action") or "?" for r in evs)
    return {
        "events": len(evs),
        "up": actions.get("up", 0),
        "down": actions.get("down", 0),
        "replace": actions.get("replace", 0),
        "reasons": dict(collections.Counter(
            r.get("reason") or "?" for r in evs)),
        "final_replicas": evs[-1].get("replicas_after"),
        "max_replicas_seen": max((r.get("replicas_after") or 0)
                                 for r in evs),
    }


def summarize_handoffs(records: List[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    """Aggregate the fleet's ``kind="kv_handoff"`` events:
    how many finished prefills streamed their KV pages to a decode
    replica, how much hit the wire, and at which quantization — the
    disaggregation run's cost ledger next to its latency percentiles.
    None when the stream has no handoffs (colocated fleets don't grow
    the block)."""
    evs = [r for r in records if r.get("kind") == "kv_handoff"]
    if not evs:
        return None
    wire = [int(r.get("wire_bytes") or 0) for r in evs]
    blocks = [int(r.get("blocks") or 0) for r in evs]
    ms = [float(r["transfer_ms"]) for r in evs
          if r.get("transfer_ms") is not None]
    return {
        "handoffs": len(evs),
        "blocks": sum(blocks),
        "wire_bytes": sum(wire),
        "mean_blocks": round(sum(blocks) / len(evs), 2),
        "mean_wire_bytes": round(sum(wire) / len(evs), 1),
        "transfer_ms_mean": (round(sum(ms) / len(ms), 3)
                             if ms else None),
        "transfer_ms_p95": percentile(ms, 95) if ms else None,
        "by_quant": dict(collections.Counter(
            r.get("quant") or "?" for r in evs)),
    }
