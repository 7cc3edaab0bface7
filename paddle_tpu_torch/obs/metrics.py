"""Fleet-wide typed time-series metrics registry.

PRs 2/4/6/17 gave the stack *records* (JSONL telemetry), *traces*
(Chrome/Perfetto flows), and *streaming SLO quantiles* — but every
counter still lives in an ad-hoc dict (``fleet.stats()``, transport
attribute counters, ``router_ms``, autoscaler EMAs, allocator gauges)
with no history, no types, no common query path, and no exposition
format. This module is the missing metrics plane:

- :class:`Counter` — monotone (``inc(n)`` with ``n < 0`` is a
  ``ValueError``; monotonicity is what makes cross-host delta merge and
  rate computation sound).
- :class:`Gauge` — last-write-wins scalar (``set``/``inc``/``dec``).
- :class:`Histogram` — fixed log-spaced buckets (:func:`log_buckets`)
  plus streaming sum/count. Fixed bounds, not adaptive: two replicas'
  histograms merge by adding per-bucket counts only when the bounds are
  byte-identical on both sides, which adaptive bucketing cannot
  guarantee.

Every metric is backed by a bounded ring-buffer time series — samples
``(ts, value)`` stamped by the hub's injected clock (the fleet's
SimClock in drills, so history is deterministic), with configurable
retention and oldest-first eviction. Labels
(``metric.labels(replica=..., role=..., link=...)``) key independent
children of one logical metric; the hub interns on the sorted label
set, so ``counter("x", a="1")`` from two call sites is the same object.

Cross-host protocol (the tracer's span-batch move, verbatim): a process
replica's hub accumulates locally; :meth:`MetricsHub.drain_delta` pops
the since-last-drain increments (counter deltas, gauge last-values,
histogram bucket/sum/count deltas) and the replica piggybacks them on
its tick reply — no side-channel, so deltas undelivered at SIGKILL
honestly die with the process. The parent merges with
:meth:`MetricsHub.absorb_delta`, namespacing per replica by merging a
``replica=<id>`` label. Because counters are monotone and histograms
share fixed bounds, the merge is plain addition and at-least-once
delivery stays exactly-once (the transport's seq/reply-cache dedup
means each drained batch reaches ``absorb_delta`` once).

Reads: :meth:`MetricsHub.snapshot` (current values, one dict per
labeled child), :meth:`MetricsHub.query` (ring-buffer history,
``since=`` filtered), and :meth:`MetricsHub.render` — Prometheus text
exposition (``# HELP``/``# TYPE``, escaped labels, cumulative
``_bucket{le=...}`` + ``_sum``/``_count`` for histograms) with
:func:`parse_exposition` as the inverse for round-trip tests and remote
scrapes. Prometheus text because it is the lingua franca every scrape
pipeline already parses, is human-readable in a terminal, and costs one
string format per sample — no new dependency, no binary schema.

Default-off doctrine (the observability contract of every hook): no
component constructs a hub on its own; every instrumentation site
guards on ``is not None`` and the dark path is byte-identical —
pinned by the instrumented-vs-dark twin drill in the bench fleet gate.
"""

from __future__ import annotations

import bisect
import collections
import math
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsHub",
           "log_buckets", "parse_exposition"]


def log_buckets(lo: float = 1e-4, hi: float = 1e4,
                per_decade: int = 2) -> List[float]:
    """Fixed log-spaced histogram bucket upper bounds, ``lo`` to ``hi``
    inclusive at ``per_decade`` bounds per decade. The default spans
    1e-4..1e4 — wide enough that one policy covers microsecond RTTs and
    multi-second step times, because FIXED bounds (never resized from
    data) are what make cross-host histogram merge plain addition."""
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    if per_decade < 1:
        raise ValueError(f"per_decade must be >= 1, got {per_decade}")
    n = int(round(math.log10(hi / lo) * per_decade))
    # 6 significant digits: stable float reprs so two hosts computing
    # the same policy render/compare byte-identical bounds
    return [float(f"{lo * 10 ** (i / per_decade):.6g}")
            for i in range(n + 1)]


_DEFAULT_BUCKETS = log_buckets()


class _Metric:
    """Common base: identity (name + labels), help text, and the
    bounded ``(ts, value)`` ring the hub's clock stamps."""

    kind = "untyped"

    def __init__(self, hub: "MetricsHub", name: str, help: str,
                 labels: Dict[str, str], retention: int):
        self.hub = hub
        self.name = name
        self.help = help
        self.label_values = dict(labels)
        self.series: collections.deque = collections.deque(
            maxlen=retention)

    def labels(self, **labels) -> "_Metric":
        """The sibling child of this metric with ``labels`` merged over
        this child's labels (get-or-create through the hub)."""
        merged = dict(self.label_values)
        merged.update({k: str(v) for k, v in labels.items()})
        return self.hub._get(self.kind, self.name, self.help, merged,
                             getattr(self, "buckets", None))

    def _stamp(self, value: float) -> None:
        self.series.append((self.hub.clock(), value))

    def samples(self, since: Optional[float] = None
                ) -> List[Tuple[float, float]]:
        """Ring-buffer history, optionally only samples with
        ``ts >= since``."""
        if since is None:
            return list(self.series)
        return [(t, v) for t, v in self.series if t >= since]


class Counter(_Metric):
    """Monotone counter. The series stamps the CUMULATIVE value at each
    increment, so rates are successive differences."""

    kind = "counter"

    def __init__(self, hub, name, help, labels, retention):
        super().__init__(hub, name, help, labels, retention)
        self.value = 0.0
        self._shipped = 0.0        # drained-up-to watermark

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name!r} is monotone; inc({n}) rejected")
        if n == 0:
            return
        self.value += n
        self._stamp(self.value)


class Gauge(_Metric):
    """Last-write-wins scalar (``value`` is None before the first
    set)."""

    kind = "gauge"

    def __init__(self, hub, name, help, labels, retention):
        super().__init__(hub, name, help, labels, retention)
        self.value: Optional[float] = None
        self._dirty = False        # set since last drain?

    def set(self, v: float) -> None:
        self.value = float(v)
        self._dirty = True
        self._stamp(self.value)

    def inc(self, n: float = 1.0) -> None:
        self.set((self.value or 0.0) + n)

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)


class Histogram(_Metric):
    """Fixed-bucket histogram with streaming sum/count. ``counts`` is
    per-bucket NON-cumulative (last slot is the +Inf overflow); the
    exposition renderer emits the Prometheus cumulative form. The ring
    series holds raw observations (the distribution-sparkline and
    ``query()`` source)."""

    kind = "histogram"

    def __init__(self, hub, name, help, labels, retention,
                 buckets: Optional[List[float]] = None):
        super().__init__(hub, name, help, labels, retention)
        bs = list(_DEFAULT_BUCKETS if buckets is None else buckets)
        if bs != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"buckets must be strictly increasing, "
                             f"got {bs}")
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)
        self.sum = 0.0
        self.count = 0
        self._shipped_counts = [0] * (len(bs) + 1)
        self._shipped_sum = 0.0
        self._shipped_count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        # le semantics: the first bound >= v owns the observation
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self._stamp(v)

    def merge(self, counts: List[int], sum_: float, count: int) -> None:
        """Add another histogram's (delta) counts into this one — the
        cross-host absorb path. Bounds must match exactly (fixed-bucket
        policy); raw observations do not travel, only the counts."""
        if len(counts) != len(self.counts):
            raise ValueError(
                f"histogram {self.name!r}: cannot merge {len(counts)} "
                f"bucket counts into {len(self.counts)}")
        for i, c in enumerate(counts):
            self.counts[i] += c
        self.sum += sum_
        self.count += count


class _Scoped:
    """Label-scoped facade over a hub: same ``counter``/``gauge``/
    ``histogram`` get-or-create surface with this scope's labels merged
    in automatically — how a fleet hands its engine/scheduler a
    ``replica=<i>``-namespaced view without those components knowing
    about fleet topology."""

    def __init__(self, hub: "MetricsHub", labels: Dict[str, str]):
        self.hub = hub
        self._labels = {k: str(v) for k, v in labels.items()}

    def _merge(self, labels):
        merged = dict(self._labels)
        merged.update(labels)
        return merged

    def counter(self, name, help="", **labels) -> Counter:
        return self.hub.counter(name, help, **self._merge(labels))

    def gauge(self, name, help="", **labels) -> Gauge:
        return self.hub.gauge(name, help, **self._merge(labels))

    def histogram(self, name, help="", buckets=None,
                  **labels) -> Histogram:
        return self.hub.histogram(name, help, buckets=buckets,
                                  **self._merge(labels))

    def scoped(self, **labels) -> "_Scoped":
        return _Scoped(self.hub, self._merge(labels))

    @property
    def clock(self) -> Callable[[], float]:
        return self.hub.clock


class MetricsHub:
    """The registry: get-or-create typed metrics keyed on
    ``(name, sorted labels)``, one clock, one retention policy.

    Args:
      clock: timestamp source for ring-buffer samples (callable → s).
        The fleet passes its own clock, so a SimClock drill's metric
        history is deterministic. Default: ``time.time``.
      retention: ring-buffer length per labeled child (oldest-first
        eviction beyond it). History is bounded BY CONSTRUCTION —
        a weeks-long serving process cannot leak memory through its
        own observability.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 retention: int = 512):
        if retention < 1:
            raise ValueError(f"retention must be >= 1, got {retention}")
        self.clock = clock if clock is not None else time.time
        self.retention = int(retention)
        self._lock = threading.RLock()
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            _Metric] = {}
        self._kinds: Dict[str, str] = {}      # name -> kind (one type)
        self._help: Dict[str, str] = {}
        self._bounds: Dict[str, List[float]] = {}

    # -- registration ------------------------------------------------------

    @staticmethod
    def _key(name: str, labels: Dict[str, str]
             ) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
        return (name, tuple(sorted((str(k), str(v))
                                   for k, v in labels.items())))

    def _get(self, kind: str, name: str, help: str,
             labels: Dict[str, str],
             buckets: Optional[List[float]] = None) -> _Metric:
        with self._lock:
            key = self._key(name, labels)
            m = self._metrics.get(key)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        f"metric {name!r} is a {m.kind}, not a {kind}")
                return m
            if self._kinds.setdefault(name, kind) != kind:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{self._kinds[name]}, cannot re-register as {kind}")
            if help and not self._help.get(name):
                self._help[name] = help
            h = self._help.get(name, "")
            lbl = dict(key[1])
            if kind == "counter":
                m = Counter(self, name, h, lbl, self.retention)
            elif kind == "gauge":
                m = Gauge(self, name, h, lbl, self.retention)
            else:
                bs = self._bounds.setdefault(
                    name, list(_DEFAULT_BUCKETS if buckets is None
                               else buckets))
                m = Histogram(self, name, h, lbl, self.retention,
                              buckets=bs)
            self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[List[float]] = None,
                  **labels) -> Histogram:
        return self._get("histogram", name, help, labels, buckets)

    def scoped(self, **labels) -> _Scoped:
        """A label-scoped facade (see :class:`_Scoped`)."""
        return _Scoped(self, labels)

    # -- reads -------------------------------------------------------------

    def snapshot(self) -> List[Dict[str, Any]]:
        """Current value of every labeled child, one dict each, sorted
        by (name, labels) for deterministic output."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for (name, lbl), m in sorted(self._metrics.items()):
                d: Dict[str, Any] = {"name": name, "type": m.kind,
                                     "labels": dict(lbl)}
                if isinstance(m, Histogram):
                    d.update(count=m.count, sum=m.sum,
                             buckets=list(m.buckets),
                             counts=list(m.counts))
                else:
                    d["value"] = m.value
                out.append(d)
        return out

    def query(self, name: str, since: Optional[float] = None,
              **labels) -> List[Dict[str, Any]]:
        """Ring-buffer history for every child of ``name`` whose labels
        are a superset of ``labels``: ``[{"labels": ..., "samples":
        [(ts, value), ...]}, ...]``."""
        want = {str(k): str(v) for k, v in labels.items()}
        out = []
        with self._lock:
            for (n, lbl), m in sorted(self._metrics.items()):
                if n != name:
                    continue
                have = dict(lbl)
                if any(have.get(k) != v for k, v in want.items()):
                    continue
                out.append({"labels": have,
                            "samples": m.samples(since)})
        return out

    # -- Prometheus text exposition ----------------------------------------

    @staticmethod
    def _esc(v: str) -> str:
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    @classmethod
    def _fmt_labels(cls, labels: Dict[str, str],
                    extra: Optional[Tuple[str, str]] = None) -> str:
        items = sorted(labels.items())
        if extra is not None:
            items = items + [extra]
        if not items:
            return ""
        return ("{" + ",".join(f'{k}="{cls._esc(v)}"'
                               for k, v in items) + "}")

    @staticmethod
    def _fmt_val(v: Optional[float]) -> str:
        if v is None:
            return "NaN"
        f = float(v)
        if f == int(f) and abs(f) < 1e15:
            return str(int(f))
        return repr(f)

    def render(self) -> str:
        """Prometheus-compatible text exposition of the whole registry
        (the remote-scrape payload; :func:`parse_exposition` is the
        inverse)."""
        by_name: Dict[str, List[_Metric]] = collections.OrderedDict()
        with self._lock:
            for (name, _), m in sorted(self._metrics.items()):
                by_name.setdefault(name, []).append(m)
            lines: List[str] = []
            for name, children in by_name.items():
                if self._help.get(name):
                    lines.append(f"# HELP {name} "
                                 f"{self._esc(self._help[name])}")
                lines.append(f"# TYPE {name} {children[0].kind}")
                for m in children:
                    if isinstance(m, Histogram):
                        cum = 0
                        for bound, c in zip(m.buckets, m.counts):
                            cum += c
                            lines.append(
                                f"{name}_bucket"
                                + self._fmt_labels(
                                    m.label_values,
                                    ("le", self._fmt_val(bound)))
                                + f" {cum}")
                        lines.append(
                            f"{name}_bucket"
                            + self._fmt_labels(m.label_values,
                                               ("le", "+Inf"))
                            + f" {m.count}")
                        lines.append(f"{name}_sum"
                                     + self._fmt_labels(m.label_values)
                                     + f" {self._fmt_val(m.sum)}")
                        lines.append(f"{name}_count"
                                     + self._fmt_labels(m.label_values)
                                     + f" {m.count}")
                    else:
                        lines.append(name
                                     + self._fmt_labels(m.label_values)
                                     + f" {self._fmt_val(m.value)}")
        return "\n".join(lines) + "\n"

    # -- cross-host delta protocol -----------------------------------------

    def drain_delta(self) -> List[Dict[str, Any]]:
        """Pop everything that changed since the last drain, as a
        JSON-able batch the tick reply carries (the tracer's span-batch
        move): counter increments, gauge last-values, histogram
        bucket/sum/count deltas. Draining advances the shipped
        watermark, so a batch lost with a SIGKILLed process honestly
        dies — the parent never sees it and never will."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for (name, lbl), m in sorted(self._metrics.items()):
                if isinstance(m, Counter):
                    d = m.value - m._shipped
                    if d:
                        out.append({"kind": "counter", "name": name,
                                    "help": m.help, "labels": dict(lbl),
                                    "inc": d})
                        m._shipped = m.value
                elif isinstance(m, Gauge):
                    if m._dirty and m.value is not None:
                        out.append({"kind": "gauge", "name": name,
                                    "help": m.help, "labels": dict(lbl),
                                    "value": m.value})
                        m._dirty = False
                else:
                    dc = [a - b for a, b in zip(m.counts,
                                                m._shipped_counts)]
                    if any(dc):
                        out.append({
                            "kind": "histogram", "name": name,
                            "help": m.help, "labels": dict(lbl),
                            "buckets": list(m.buckets), "counts": dc,
                            "sum": m.sum - m._shipped_sum,
                            "count": m.count - m._shipped_count})
                        m._shipped_counts = list(m.counts)
                        m._shipped_sum = m.sum
                        m._shipped_count = m.count
        return out

    def absorb_delta(self, deltas: List[Dict[str, Any]],
                     **extra_labels) -> None:
        """Merge a drained batch into this hub, with ``extra_labels``
        merged over each entry's own labels — the parent namespaces a
        replica's whole registry with ``replica=<id>`` in one call.
        Monotone counters and fixed-bound histograms make this plain
        addition; gauges are last-write-wins."""
        for d in deltas:
            labels = dict(d.get("labels") or {})
            labels.update({k: str(v) for k, v in extra_labels.items()})
            kind = d.get("kind")
            name = d["name"]
            help_ = d.get("help", "")
            if kind == "counter":
                self.counter(name, help_, **labels).inc(d["inc"])
            elif kind == "gauge":
                self.gauge(name, help_, **labels).set(d["value"])
            elif kind == "histogram":
                h = self.histogram(name, help_,
                                   buckets=d.get("buckets"), **labels)
                h.merge(d["counts"], d["sum"], d["count"])
            else:
                raise ValueError(f"unknown delta kind {kind!r}")


# one sample line: name, optional {labels}, value
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape(s: str) -> str:
    return (s.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def parse_exposition(text: str) -> Dict[str, Any]:
    """Parse Prometheus text exposition back into
    ``{"types": {name: kind}, "samples": [(name, labels, value)]}`` —
    the round-trip check for :meth:`MetricsHub.render` and the reader
    side of the ``metrics`` transport scrape op."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, body, raw = m.groups()
        labels = {k: _unescape(v)
                  for k, v in _LABEL_RE.findall(body or "")}
        try:
            val = float(raw)
        except ValueError:
            # histogram +Inf bucket bound parses; other junk is skipped
            if raw == "+Inf":
                val = math.inf
            else:
                continue
        samples.append((name, labels, val))
    return {"types": types, "samples": samples}
