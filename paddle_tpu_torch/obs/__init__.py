"""Observability — the port of ``paddle_tpu/obs`` (apart from its XLA
introspection: ``attribution``, ``hloprof``, ``xla_cache``,
``xla_flags``).

The layers:

- :mod:`~paddle_tpu_torch.obs.sinks` — record consumers (in-memory,
  JSONL file with rotation, logging); ``emit`` is thread-safe.
- :mod:`~paddle_tpu_torch.obs.health` — training-health scalars
  (grad/param/update norms, update ratio, NaN/Inf sentinel) computed on
  the card and fetched with the losses.
- :mod:`~paddle_tpu_torch.obs.telemetry` — :class:`Telemetry`: per-call
  step-time breakdown (host stack / shard / dispatch / fenced device /
  events replay), retraces keyed by step fingerprint, MFU and
  tokens/sec, device-memory sampling; :func:`fence`, the CUDA-event
  wait on the compute stream.
- :mod:`~paddle_tpu_torch.obs.trace` — :class:`Tracer`: thread-aware
  spans as Chrome Trace Event JSON with flow events, and
  :func:`torch_profile` capture windows.
- :mod:`~paddle_tpu_torch.obs.anomaly` — :class:`AnomalyDetector` and
  :class:`ServingAnomalyDetector`: rolling robust statistics over the
  record stream; on a trigger, a one-shot forensics bundle on disk.
- :mod:`~paddle_tpu_torch.obs.metrics` — :class:`MetricsHub`: typed
  counters, gauges and histograms, Prometheus exposition, delta drain
  and absorb; :mod:`~paddle_tpu_torch.obs.slo` — :class:`SLOMonitor`;
  :mod:`~paddle_tpu_torch.obs.percentiles` — request/hand-off
  summaries; :mod:`~paddle_tpu_torch.obs.fleet_trace` — merged
  multi-lane traces and their checks.
- ``python -m paddle_tpu_torch.obs.report run.jsonl`` — the run-summary
  table; ``python -m paddle_tpu_torch.obs.top`` — the heartbeat and
  telemetry dashboard.

Attach with ``Trainer(..., telemetry=Telemetry(sinks=[JsonlSink(path)]),
tracer=Tracer(), anomaly=AnomalyDetector(out_dir), metrics=MetricsHub())``
or ``DecodeEngine(..., telemetry=...)`` (``engine.tracer`` and
``engine.metrics`` are attributes) and
``ContinuousBatchingScheduler(engine, telemetry=, tracer=, metrics=)``.
With none attached the loops are unchanged: the same launches, no CUDA
event, no synchronize, no extra fetch.
"""

from .anomaly import (ANOMALY_KINDS, SERVING_ANOMALY_KINDS,
                      AnomalyDetector, ServingAnomalyDetector, Verdict)
from .fleet_trace import (flow_connected, flow_summary, lane_monotonic,
                          merge_fleet_trace, save_fleet_trace)
from .health import (HEALTH_KEYS, health_scalars, tree_l2_norm,
                     tree_nonfinite_count)
from .metrics import (Counter, Gauge, Histogram, MetricsHub,
                      log_buckets, parse_exposition)
from .percentiles import (GOODPUT_REASONS, P2Quantile, percentile,
                          summarize_handoffs, summarize_requests,
                          summarize_scale)
from .sinks import InMemorySink, JsonlSink, LoggingSink, Sink
from .slo import SLOMonitor, SLOTargets
from .telemetry import (PEAK_FLOPS, Telemetry, device_memory_stats,
                        device_peak_flops, fence)
from .trace import Tracer, torch_profile, tspan

__all__ = [
    "Telemetry", "Sink", "InMemorySink", "JsonlSink", "LoggingSink",
    "HEALTH_KEYS", "health_scalars", "tree_l2_norm", "tree_nonfinite_count",
    "PEAK_FLOPS", "device_peak_flops", "device_memory_stats", "fence",
    "Tracer", "tspan", "torch_profile",
    "AnomalyDetector", "ServingAnomalyDetector", "Verdict",
    "ANOMALY_KINDS", "SERVING_ANOMALY_KINDS",
    "percentile", "P2Quantile", "summarize_requests", "summarize_scale",
    "summarize_handoffs", "GOODPUT_REASONS",
    "SLOMonitor", "SLOTargets",
    "MetricsHub", "Counter", "Gauge", "Histogram", "log_buckets",
    "parse_exposition",
    "merge_fleet_trace", "save_fleet_trace", "flow_summary",
    "flow_connected", "lane_monotonic",
]
