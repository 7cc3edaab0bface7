"""Streaming SLO monitor over terminal request records.

:func:`~paddle_tpu_torch.obs.percentiles.summarize_requests` is a batch
aggregate — it answers "how did the run go" after every record is in
hand. A serving fleet needs the LIVE form of the same vocabulary:
rolling p50/p95/p99 TTFT/TPOT/wall (P² streaming estimators, O(1)
memory per quantile), goodput, and the **error-budget burn rate** an
SLO-derivative autoscaler steers on (the ROADMAP's named consumer —
:meth:`~paddle_tpu_torch.serve.fleet.ServingFleet.stats` publishes the
signal).

Burn-rate semantics (the SRE convention, windowed):

- The objective is ``targets.goodput_pct`` — at least that percentage
  of terminal requests must be *good*: finished (``"length"``/
  ``"eos"``), within their deadline when they carried one, and within
  the optional absolute TTFT/TPOT targets.
- The **error budget** is the allowed bad fraction,
  ``1 - goodput_pct/100``.
- The **burn rate** is the observed bad fraction over the rolling
  window divided by the budget: 1.0 means the fleet is consuming its
  budget exactly as fast as allowed; >1 means overspending (an alert /
  scale-up signal); 0 means no bad requests in the window.

Record semantics match :func:`summarize_requests` exactly: only
terminal records count (``finish_reason="retried"`` rows are lineage,
not outcomes), and shed records are excluded from the latency
estimators (a shed does no work and records ``wall_ms=0`` — counting
it would make p50 *improve* exactly when overload is worst) while
still burning error budget.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, Optional

from .percentiles import GOODPUT_REASONS, P2Quantile

__all__ = ["SLOTargets", "SLOMonitor"]

_METRICS = ("ttft_ms", "tpot_ms", "wall_ms")
_PERCENTILES = (50, 95, 99)


@dataclasses.dataclass
class SLOTargets:
    """The objective a request stream is judged against. ``ttft_ms`` /
    ``tpot_ms`` are optional absolute latency targets a finished
    request must also meet to count as good (None = finishing in
    budget is enough)."""
    goodput_pct: float = 99.0
    ttft_ms: Optional[float] = None
    tpot_ms: Optional[float] = None

    @property
    def error_budget(self) -> float:
        """Allowed bad fraction, floored so a 100% objective cannot
        divide by zero (burn rate saturates instead)."""
        return max(1e-9, 1.0 - self.goodput_pct / 100.0)


class SLOMonitor:
    """Windowed streaming SLO aggregate: feed every terminal
    ``kind="request"`` record through :meth:`observe`, read
    :meth:`report` any time.

    Args:
      targets: the :class:`SLOTargets` objective (default: 99% good,
        no absolute latency targets — deadline/finish semantics only).
      window: rolling window (requests) for the burn rate and the
        windowed goodput; the percentile estimators are whole-stream
        (P² is a running estimate, "rolling" in the sense of updated
        per record).
    """

    def __init__(self, targets: Optional[SLOTargets] = None,
                 window: int = 256, metrics=None):
        self.targets = targets or SLOTargets()
        self.window = int(window)
        # optional metrics registry: when set
        # (a MetricsHub or scoped view), every observe() publishes the
        # rolling percentiles and burn rate as gauges — report() stays
        # byte-identical either way
        self.metrics = metrics
        self._est = {m: {p: P2Quantile(p) for p in _PERCENTILES}
                     for m in _METRICS}
        self._recent: collections.deque = collections.deque(
            maxlen=self.window)          # good? per terminal request
        self.requests = 0
        self.retried_attempts = 0
        self.good = 0
        self.tokens = 0
        self.good_tokens = 0
        self.reasons: collections.Counter = collections.Counter()

    # -- ingestion ---------------------------------------------------------

    def _is_good(self, rec: Dict[str, Any]) -> bool:
        if rec.get("finish_reason") not in GOODPUT_REASONS:
            return False
        wall = rec.get("wall_ms")
        if (rec.get("deadline_s") is not None
                and (wall is None or wall > rec["deadline_s"] * 1e3)):
            return False
        if (self.targets.ttft_ms is not None
                and (rec.get("ttft_ms") is None
                     or rec["ttft_ms"] > self.targets.ttft_ms)):
            return False
        if (self.targets.tpot_ms is not None
                and rec.get("tpot_ms") is not None
                and rec["tpot_ms"] > self.targets.tpot_ms):
            return False
        return True

    def observe(self, rec: Dict[str, Any]) -> None:
        """Feed one telemetry record; non-request and retried-lineage
        records are ignored, so the whole stream can be piped
        through."""
        if rec.get("kind") != "request":
            return
        if rec.get("finish_reason") == "retried":
            self.retried_attempts += 1
            return
        self.requests += 1
        self.reasons[rec.get("finish_reason") or "?"] += 1
        self.tokens += int(rec.get("new_tokens") or 0)
        if rec.get("finish_reason") != "shed":
            for m in _METRICS:
                v = rec.get(m)
                if v is not None:
                    for est in self._est[m].values():
                        est.observe(float(v))
        good = self._is_good(rec)
        if good:
            self.good += 1
            self.good_tokens += int(rec.get("new_tokens") or 0)
        self._recent.append(good)
        if self.metrics is not None:
            for m in _METRICS:
                for p in _PERCENTILES:
                    v = self._est[m][p].value()
                    if v is not None:
                        self.metrics.gauge(
                            f"slo_{m}_p{p}",
                            f"rolling p{p} {m} (P2 estimate)").set(v)
            self.metrics.gauge(
                "slo_burn_rate",
                "windowed error-budget burn rate").set(self.burn_rate())

    # -- readout -----------------------------------------------------------

    def burn_rate(self) -> float:
        """Windowed error-budget burn rate (0.0 before any terminal
        record — no evidence is not an alert)."""
        if not self._recent:
            return 0.0
        bad = 1.0 - sum(self._recent) / len(self._recent)
        return bad / self.targets.error_budget

    def report(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "requests": self.requests,
            "retried_attempts": self.retried_attempts,
            "finish_reasons": dict(self.reasons),
            "new_tokens_total": self.tokens,
            "goodput_tokens": self.good_tokens,
            "goodput_pct": (round(100.0 * self.good / self.requests, 2)
                            if self.requests else None),
            "window": len(self._recent),
            "window_goodput_pct": (
                round(100.0 * sum(self._recent) / len(self._recent), 2)
                if self._recent else None),
            "error_budget_pct": round(
                100.0 * self.targets.error_budget, 4),
            "burn_rate": round(self.burn_rate(), 4),
            "targets": dataclasses.asdict(self.targets),
        }
        for m in _METRICS:
            for p in _PERCENTILES:
                v = self._est[m][p].value()
                out[f"{m}_p{p}"] = (round(v, 4)
                                    if v is not None else None)
        return out
