"""Hierarchical timers and stats — the port of ``paddle_tpu/utils/
stats.py`` (the ``Stat.h`` analog the Trainer keeps as ``self.stats``).

Work on the card is asynchronous, so a timer that should include it
fences: ``StatSet.time(key, sync=tensor_or_device)`` waits, before it
stops, on a CUDA event recorded on that device's compute stream.
:func:`profile_trace` is a ``torch.profiler`` window.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch

__all__ = ["StatSet", "BarrierStat", "global_stats", "timer",
           "profile_trace"]


def _sync(sync) -> None:
    """Fence on ``sync``: a tensor (its device) or a device."""
    from ..obs.telemetry import fence
    dev = sync.device if isinstance(sync, torch.Tensor) else sync
    fence(dev)


class _Stat:
    __slots__ = ("total", "count", "max")

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.max = 0.0

    def add(self, dt: float):
        self.total += dt
        self.count += 1
        self.max = max(self.max, dt)


class StatSet:
    def __init__(self, name: str = "stats"):
        self.name = name
        self._stats: Dict[str, _Stat] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def time(self, key: str, sync=None):
        """Time a block; ``sync=tensor_or_device`` fences on the card's
        compute stream before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _sync(sync)
            dt = time.perf_counter() - t0
            with self._lock:
                self._stats.setdefault(key, _Stat()).add(dt)

    def add(self, key: str, dt: float):
        with self._lock:
            self._stats.setdefault(key, _Stat()).add(dt)

    def reset(self):
        with self._lock:
            self._stats.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"total_s": s.total, "count": s.count,
                        "avg_ms": 1e3 * s.total / max(1, s.count),
                        "max_ms": 1e3 * s.max}
                    for k, s in self._stats.items()}

    def to_dict(self) -> Dict[str, object]:
        """JSON-ready export: name + the per-key summary."""
        return {"name": self.name, "stats": self.summary()}

    def report(self, top_n: Optional[int] = None) -> str:
        """Sorted summary, heaviest total time first (the ``printAllStatus``
        table); ``top_n`` caps the rows (None = all)."""
        rows = sorted(self.summary().items(),
                      key=lambda kv: kv[1]["total_s"], reverse=True)
        shown = rows if top_n is None else rows[:top_n]
        lines = [f"=== {self.name} ==="]
        for k, v in shown:
            lines.append(f"  {k:<30s} n={v['count']:<6d} "
                         f"avg={v['avg_ms']:8.2f}ms max={v['max_ms']:8.2f}ms "
                         f"total={v['total_s']:.2f}s")
        if top_n is not None and len(rows) > top_n:
            lines.append(f"  ... {len(rows) - top_n} more")
        return "\n".join(lines)


_global = StatSet("global")


def global_stats() -> StatSet:
    return _global


def timer(key: str, sync=None):
    return _global.time(key, sync=sync)


def profile_trace(logdir: str):
    """A ``torch.profiler`` window exporting a Chrome trace into
    ``logdir`` (:func:`paddle_tpu_torch.obs.trace.torch_profile`)."""
    from ..obs.trace import torch_profile
    return torch_profile(logdir)


class BarrierStat:
    """Imbalance telemetry across hosts — the ``BarrierStatSet`` analog:
    the spread of per-host step times. Training runs on one process until
    multi-GPU training is ported, so :meth:`gather` sees this host's
    sample alone and reports a spread of zero."""

    def __init__(self, name: str = "step_time"):
        self.name = name
        self._last: Optional[float] = None
        self._spreads = _Stat()

    def update(self, seconds: float) -> None:
        self._last = float(seconds)

    def gather(self) -> Dict[str, float]:
        """min/max/mean of the latest samples and their relative spread
        ((max-min)/mean); ``{}`` before the first sample."""
        import numpy as np
        times = np.array([np.float32(self._last if self._last is not None
                                     else np.nan)])
        times = times[np.isfinite(times)]
        if times.size == 0:
            return {}
        mn, mx, mean = float(times.min()), float(times.max()), \
            float(times.mean())
        spread = (mx - mn) / mean if mean else 0.0
        self._spreads.add(spread)
        return {f"{self.name}_min_s": mn, f"{self.name}_max_s": mx,
                f"{self.name}_mean_s": mean, f"{self.name}_spread": spread}

    def summary(self) -> Dict[str, float]:
        s = self._spreads
        return {"mean_spread": s.total / max(1, s.count),
                "max_spread": s.max, "samples": s.count}
