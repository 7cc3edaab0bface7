"""Telemetry sinks — where :class:`~paddle_tpu_torch.obs.Telemetry`
records go.

A sink consumes finished record dicts (JSON-serializable by construction:
the Telemetry layer converts device scalars to Python floats before
emitting). Three built-ins cover the output surfaces: in-memory
(tests/notebooks), JSONL file (the machine-readable ``printAllStatus``
successor — one record per line, append-only, crash-tolerant), and the
logging module (human eyes).
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional

__all__ = ["Sink", "InMemorySink", "JsonlSink", "LoggingSink"]


class Sink:
    """Base sink: ``emit(record)`` consumes one record; ``close()`` releases
    resources. Sinks must tolerate being closed twice.

    THREAD-SAFETY CONTRACT: ``emit`` may be called from more
    than one thread. The obs layer is no longer single-threaded by
    construction — the hot loop runs main + stager + fill threads, and
    consumers (event handlers, anomaly tooling, user code holding the
    Telemetry) may emit from any of them — so every Sink implementation
    must make ``emit`` safe under concurrent callers (the built-ins
    lock; ``LoggingSink`` rides the stdlib logging module's own handler
    lock)."""

    def emit(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemorySink(Sink):
    """Keeps every record in ``self.records`` — the test/notebook sink.
    Emits are locked: two threads appending concurrently must both land
    (and ``by_kind`` must never iterate a list mid-resize)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def emit(self, record: Dict[str, Any]) -> None:
        with self._lock:
            self.records.append(record)

    def by_kind(self, kind: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [r for r in self.records if r.get("kind") == kind]


class JsonlSink(Sink):
    """One JSON object per line, flushed per emit (a record is never half
    on disk after a crash — the CRC'd-checkpoint philosophy applied to
    telemetry). The file opens lazily on first emit so constructing a
    Telemetry never touches the filesystem.

    ``max_bytes`` bounds the file: when the next
    record would push past it, the current file rotates to ``<path>.1``
    (replacing any previous ``.1``) and writing continues fresh — a
    week-long run keeps at most ~2x ``max_bytes`` of telemetry on disk
    instead of growing unboundedly, and the most recent window (the one
    a postmortem reads) is always intact. Rotation happens BEFORE the
    write, so no emitted record is ever split across files; a single
    record larger than ``max_bytes`` still lands whole. Default None:
    unbounded, the pre-rotation behavior."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = max_bytes
        self.rotations = 0
        self._f = None
        self._written = 0
        self._lock = threading.Lock()

    def emit(self, record: Dict[str, Any]) -> None:
        with self._lock:
            if self._f is None:
                self._f = open(self.path, "a")
                try:                               # append-mode resume
                    self._written = os.path.getsize(self.path)
                except OSError:
                    self._written = 0
            line = json.dumps(record) + "\n"
            if (self.max_bytes is not None and self._written > 0
                    and self._written + len(line) > self.max_bytes):
                self._f.close()
                os.replace(self.path, self.path + ".1")
                self.rotations += 1
                self._f = open(self.path, "a")
                self._written = 0
            self._f.write(line)
            self._f.flush()
            self._written += len(line)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        """Parse a JSONL telemetry file back into record dicts."""
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out


class LoggingSink(Sink):
    """Compact per-record line through the stdlib logging module."""

    _STEP_KEYS = ("step", "loss", "host_stack_ms", "shard_ms", "dispatch_ms",
                  "device_ms", "replay_ms", "retrace_count", "grad_norm",
                  "tokens_per_sec", "est_mfu_pct", "peak_bytes")

    def __init__(self, logger: Optional[logging.Logger] = None,
                 level: int = logging.INFO):
        self.logger = logger or logging.getLogger("paddle_tpu_torch.telemetry")
        self.level = level

    def emit(self, record: Dict[str, Any]) -> None:
        kind = record.get("kind", "step")
        if kind == "compile":
            self.logger.log(self.level,
                            "telemetry compile #%s wall=%.3fs flops=%s %s",
                            record.get("compile_count"),
                            record.get("wall_s", float("nan")),
                            record.get("hlo_flops"),
                            record.get("fingerprint", ""))
            return
        parts = []
        for k in self._STEP_KEYS:
            v = record.get(k)
            if v is None:
                continue
            parts.append(f"{k}={v:.4g}" if isinstance(v, float) else
                         f"{k}={v}")
        self.logger.log(self.level, "telemetry %s %s", kind, " ".join(parts))
