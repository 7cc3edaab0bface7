"""The telemetry core — the port of ``paddle_tpu/obs/telemetry.py``:
per-call step-time breakdown, compile/retrace tracking, MFU accounting
and device-memory sampling for the Trainer's loop, and the sink of the
serving engine's and scheduler's records.

Design rules, as in the JAX package:

- **Fencing.** A call returns as soon as its kernels are queued on the
  compute stream, so a wall clock around it measures *dispatch*, not
  compute. ``device_ms`` is the wall from the call's return to
  :func:`fence`: a CUDA event recorded on the compute stream after the
  call, then synchronized. It waits on that stream alone, never on the
  whole card (the host pipeline's side stream keeps copying), and exists
  only when ``Telemetry(fence=True)`` is attached.
- **Zero overhead when off.** With no Telemetry attached the Trainer's
  loop launches exactly what it launched before, records no event, calls
  no synchronize and makes no extra fetch (``tests/test_torch_obs*.py``
  pin it).
- **Compile observability.** The Trainer keys every call by its *step
  fingerprint* — (K, M, leaf shapes and dtypes) of the group — and
  reports a new fingerprint to :meth:`Telemetry.observe_fingerprint`:
  the first is the initial compile, each later one a retrace, counted
  exactly as JAX counts them. On the card a new fingerprint builds no
  program (kernels build at first use); ``wall_s`` is the first call's
  wall, and ``hlo_flops`` is None.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .health import HEALTH_KEYS
from .sinks import InMemorySink, Sink

__all__ = ["Telemetry", "PEAK_FLOPS", "device_peak_flops",
           "device_memory_stats", "fence"]

_log = logging.getLogger("paddle_tpu_torch.telemetry")

# Peak dense bf16 FLOP/s per card by ``torch.cuda.get_device_name()`` —
# the MFU denominator. NVIDIA H100 SXM5: 989.4 TFLOP/s dense bf16 tensor
# core (NVIDIA H100 Tensor Core GPU datasheet; 1,979 with sparsity).
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}

# card names whose missing PEAK_FLOPS entry was already logged — the
# fallback is one-shot per name per process, not silent and not spammy
_unknown_kinds_logged: set = set()


def _device_kind(device=None) -> str:
    """The card's name for ``device`` (an index, ``torch.device`` or
    string; default the current card), ``"cpu"`` without a card. An
    object with a ``device_kind`` attribute gives that."""
    kind = getattr(device, "device_kind", None)
    if kind is not None:
        return str(kind)
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def device_peak_flops(device=None) -> Optional[float]:
    """Spec-sheet peak FLOP/s of ``device`` (default: the current card);
    None when its name has no entry. An unknown card logs a one-shot
    WARNING (MFU silently reading None on new hardware is the quiet rot
    this layer exists to prevent); the CPU logs once at DEBUG."""
    kind = _device_kind(device)
    peak = PEAK_FLOPS.get(kind)
    if peak is None and kind not in _unknown_kinds_logged:
        _unknown_kinds_logged.add(kind)
        if kind != "cpu":
            _log.warning(
                "no PEAK_FLOPS entry for card %r — est_mfu_pct will be "
                "None; add its spec-sheet dense bf16 peak to "
                "obs.telemetry.PEAK_FLOPS (or pass Telemetry(peak_flops=))",
                kind)
        else:
            _log.debug("device kind %r has no peak-FLOPs entry (MFU "
                       "accounting disabled)", kind)
    return peak


def device_memory_stats(device=None) -> Dict[str, int]:
    """The card's allocator counters under the JAX names:
    ``bytes_in_use`` (``allocated_bytes.all.current``),
    ``peak_bytes_in_use`` (``allocated_bytes.all.peak``; never reset
    here, other code reads it) and ``bytes_limit`` (the card's total
    memory). ``{}`` on the CPU, as JAX's CPU backend reports nothing."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    try:
        stats = torch.cuda.memory_stats(device)
        total = torch.cuda.get_device_properties(
            torch.cuda.current_device() if device is None
            else device).total_memory
    except Exception:                  # pragma: no cover - CUDA runtime
        return {}
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}


def fence(device=None) -> None:
    """Wait until the work queued so far on ``device``'s current (compute)
    stream is done: a CUDA event recorded there, then synchronized. Other
    streams (the host pipeline's copies) are not waited on. A no-op on the
    CPU, where the work ran eagerly."""
    if device is None or torch.device(device).type != "cuda":
        return
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    event.synchronize()


def _scalar(x):
    """Device/npy scalar -> strict-JSON-safe value: finite floats pass
    through, NaN/Inf become None (json.dumps would emit bare ``NaN``
    literals otherwise — invalid per RFC 8259, breaking strict parsers on
    exactly the diagnostic file a NaN run produces). The
    ``nonfinite_count`` sentinel (always a finite count) carries the
    poisoned-run signal."""
    v = float(np.asarray(x))
    return v if np.isfinite(v) else None


class Telemetry:
    """Pluggable-sink telemetry for the training hot loop.

    Args:
      sinks: Sink instances (or the classes themselves — ``JsonlSink``
        still needs a path, so classes only work for no-arg sinks);
        defaults to one :class:`InMemorySink`.
      health: compute the health scalars (grad/param/update norms, NaN
        sentinel) on the device after each call's last step; they ride
        the call's loss fetch.
      memory: sample :func:`device_memory_stats` once per call.
      fence: wait for the call's work on the compute stream (a CUDA event
        recorded after the call, then synchronized) to measure
        ``device_ms``, the wall from the call's return to the fence.
      flops_per_step: analytic FLOPs per optimizer step (e.g. the
        transformer's training count), the only source of ``est_mfu_pct``
        (``hlo_flops`` stays None: the port has no HLO).
      tokens_per_step: tokens consumed per optimizer step — enables
        ``tokens_per_sec`` in step records.
      peak_flops: MFU denominator override (defaults to the spec-sheet
        table keyed by the card's name; None on the CPU, which disables
        MFU).
      retrace_warn_threshold: one-shot WARNING once ``retrace_count``
        reaches this many distinct step fingerprints beyond the first
        compile — the silent-recompile trap (each distinct ragged pass
        tail compiles a new program). The warning points at
        ``batched(drop_last=True)`` / padding to a fixed shape. The
        default (3) never fires for the healthy fused pattern (one
        full-group shape + one tail shape = 1 retrace).
    """

    def __init__(self, sinks: Optional[Sequence[Sink]] = None,
                 health: bool = True, memory: bool = True,
                 fence: bool = True,
                 flops_per_step: Optional[float] = None,
                 tokens_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 retrace_warn_threshold: int = 3):
        if sinks is None:
            sinks = [InMemorySink()]
        self.sinks: List[Sink] = [s() if isinstance(s, type) else s
                                  for s in sinks]
        self.health = health
        self.memory = memory
        self.fence = fence
        self.flops_per_step = flops_per_step
        self.tokens_per_step = tokens_per_step
        self._peak_flops = peak_flops
        # compile tracking
        self._fingerprints: Dict[Any, int] = {}
        self.compile_count = 0
        self.retrace_count = 0
        self.retrace_warn_threshold = int(retrace_warn_threshold)
        self._retrace_warned = False
        self.hlo_flops_per_call: Optional[float] = None
        # memory peaks
        self.peak_bytes: Optional[int] = None       # per-pass peak
        self.peak_bytes_run: Optional[int] = None   # whole-run peak
        # latest health scalars (host-side, refreshed per call)
        self.last_health: Dict[str, float] = {}
        self._steps_emitted = 0
        # set by host_pipeline when the stager thread missed its join
        # deadline at close — surfaced in summary() so a leak is visible
        # in the run's own output, not only in a log line
        self.stager_leaked = False
        # bumped by background workers (AsyncCheckpointer's write thread)
        # when their work fails — the failure also re-raises at the
        # owner's next fence, but the counter survives into summary()
        # even when the fence is never reached (interpreter exit)
        self.background_failures = 0
        self._closed = False

    # -- compile / retrace -------------------------------------------------

    def observe_fingerprint(self, fingerprint) -> bool:
        """Report a dispatch's step fingerprint. Returns True when it is
        NEW (this dispatch will trace + compile). The first fingerprint is
        the initial compile; later new ones increment ``retrace_count``."""
        if fingerprint in self._fingerprints:
            return False
        self._fingerprints[fingerprint] = self.compile_count
        self.compile_count += 1
        if self.compile_count > 1:
            self.retrace_count += 1
            if (not self._retrace_warned
                    and self.retrace_count >= self.retrace_warn_threshold):
                self._retrace_warned = True
                _log.warning(
                    "%d distinct step fingerprints have each compiled their "
                    "own program (%d retraces) — every distinct batch/group "
                    "shape is a silent recompile. Ragged pass tails are the "
                    "usual cause: use data.batched(..., drop_last=True), pad "
                    "batches to a fixed shape, or make the pass length a "
                    "multiple of steps_per_call*grad_accum.",
                    self.compile_count, self.retrace_count)
        return True

    def record_compile(self, fingerprint, wall_s: float,
                       hlo_flops: Optional[float] = None,
                       meta: Optional[Dict[str, Any]] = None,
                       cache_hit: Optional[bool] = None,
                       autotune_trials: Optional[int] = None) -> None:
        """Emit a compile record (fires once per new fingerprint).
        ``cache_hit``: whether the executable came out of the persistent
        compilation cache (None = cache not configured / unknown);
        ``autotune_trials``: kernel-tuner trials this compile paid
        (0 = every key was already cached). Both keys are always present
        on the record so downstream readers need no schema probe."""
        if hlo_flops is not None:
            self.hlo_flops_per_call = hlo_flops
        rec = {"kind": "compile", "ts": time.time(),
               "fingerprint": str(fingerprint),
               "compile_count": self.compile_count,
               "retrace_count": self.retrace_count,
               "wall_s": round(float(wall_s), 6),
               "hlo_flops": hlo_flops,
               "cache_hit": cache_hit,
               "autotune_trials": (None if autotune_trials is None
                                   else int(autotune_trials))}
        if meta:
            rec.update(meta)
        self._emit(rec)

    # -- memory ------------------------------------------------------------

    def begin_pass(self, pass_id: int) -> None:
        """Reset the per-pass memory peak (whole-run peak persists)."""
        self.peak_bytes = None

    def sample_memory(self) -> Optional[int]:
        """Sample device memory; returns current bytes-in-use (None when
        the backend reports nothing, e.g. CPU). The per-pass peak is the
        max of the bytes-in-use SAMPLES this pass (the device's own
        ``peak_bytes_in_use`` counter is process-monotonic — it never
        resets, so it can only feed the whole-run peak); sampling
        happens once per fused call, so short intra-call spikes between
        samples are not observed."""
        if not self.memory:
            return None
        stats = device_memory_stats()
        if not stats:
            return None
        cur = stats.get("bytes_in_use")
        dev_peak = stats.get("peak_bytes_in_use")
        if cur is not None:
            self.peak_bytes = max(self.peak_bytes or 0, cur)
        run_cand = dev_peak if dev_peak is not None else cur
        if run_cand is not None:
            self.peak_bytes_run = max(self.peak_bytes_run or 0, run_cand)
        return cur

    # -- step records --------------------------------------------------------

    def emit_step(self, record: Dict[str, Any]) -> Dict[str, Any]:
        """Finalize and emit one per-call step record. The caller provides
        the breakdown fields; this layer attaches compile counters, memory,
        health, and the throughput/MFU derivations. Returns the finalized
        record (the exact object the sinks received — the trainer hands it
        to ``events.TelemetryRecord``)."""
        rec = {"kind": "step", "ts": time.time()}
        rec.update(record)
        rec["compile_count"] = self.compile_count
        rec["retrace_count"] = self.retrace_count
        cur = self.sample_memory()
        rec["bytes_in_use"] = cur
        rec["peak_bytes"] = self.peak_bytes
        rec.update(self.last_health)
        for k in HEALTH_KEYS:          # fixed schema even with health=False
            rec.setdefault(k, None)
        # host-pipeline overlap keys: fixed schema; None outside pipelined
        # mode (stage_ms = background stack+shard wall, drain_wait_ms = the
        # blocking loss fetch at drain, overlap_frac = fraction of staging
        # cost hidden from the main thread)
        for k in ("stage_ms", "drain_wait_ms", "overlap_frac"):
            rec.setdefault(k, None)
        # throughput / MFU: prefer true device time (fenced); fall back to
        # dispatch wall when fencing is off (labelled by fenced=False).
        # PIPELINED records (drain_wait_ms present) get NO per-record
        # throughput/MFU: without a fence the per-call device time is
        # unknowable, and a group released late (boundary/pass-end
        # drain-all, host-bound windows) can drain with ~0 wait — deriving
        # a rate from dispatch+drain would inflate it arbitrarily (>100%
        # MFU). summary() derives the honest aggregate steps/s from the
        # record timestamps instead.
        k_steps = rec.get("k_steps") or 1
        dev_s = rec.get("device_ms")
        disp_s = rec.get("dispatch_ms")
        rec.setdefault("profiled", False)   # fixed schema
        pipelined = rec.get("drain_wait_ms") is not None
        # profiled calls (anomaly-armed torch.profiler capture) fence INSIDE
        # the dispatch window, so their dispatch_ms includes device compute
        # — no honest per-record rate can be derived from them either
        total_ms = (0.0 if pipelined or rec["profiled"]
                    else (dev_s or 0.0) + (disp_s or 0.0))
        rec["fenced"] = bool(self.fence and dev_s is not None)
        if total_ms > 0:
            per_step_s = total_ms * 1e-3 / k_steps
            if self.tokens_per_step:
                rec["tokens_per_sec"] = round(
                    self.tokens_per_step / per_step_s, 2)
            flops = self.flops_per_step
            if flops is None and self.hlo_flops_per_call:
                flops = self.hlo_flops_per_call / k_steps
            peak = (self._peak_flops if self._peak_flops is not None
                    else device_peak_flops())
            rec["est_mfu_pct"] = (
                round(100.0 * flops / per_step_s / peak, 2)
                if (flops and peak) else None)
        # strict-JSON guarantee: no bare NaN/Inf literals reach a sink
        # (a NaN loss would otherwise break every downstream parser)
        for k, v in rec.items():
            if isinstance(v, float) and not np.isfinite(v):
                rec[k] = None
        self._steps_emitted += 1
        self._emit(rec)
        return rec

    def emit_event(self, record: Dict[str, Any]) -> Dict[str, Any]:
        """Emit one non-step record to every sink — the carrier for
        ``kind="attribution"`` reports (``Trainer.attribution_report``)
        and ``kind="anomaly"`` verdicts, so a run's JSONL holds the whole
        story (``obs.report`` reads these back). Stamps ``ts`` and a
        ``kind`` (default ``"event"``) when absent."""
        rec = {"kind": record.get("kind", "event"), "ts": time.time()}
        rec.update(record)
        self._emit(rec)
        return rec

    def update_health(self, health_host: Dict[str, Any]) -> Dict[str, float]:
        """Record the latest fetched health scalars (host values for ONE
        optimizer step). Returns the JSON-safe dict it stored."""
        out = {}
        for k in HEALTH_KEYS:
            if k in health_host:
                out[k] = _scalar(health_host[k])
        self.last_health = out
        return out

    # -- plumbing ------------------------------------------------------------

    def _emit(self, rec: Dict[str, Any]) -> None:
        for s in self.sinks:
            try:
                s.emit(rec)
            except Exception:                    # a broken sink must never
                _log.exception("telemetry sink %r failed", s)  # kill training

    def close(self) -> None:
        """Emit one final ``summary`` record to every sink, then close
        them. The summary makes a run's JSONL self-contained — the
        aggregate view (mean breakdowns, retrace totals, peak memory,
        ``stager_leaked``) previously existed only in-process. Idempotent:
        a second close neither re-emits nor fails."""
        if not self._closed:
            self._closed = True
            try:
                self._emit({"kind": "summary", "ts": time.time(),
                            **self.summary()})
            except Exception:
                _log.exception("telemetry summary emit failed at close")
        for s in self.sinks:
            try:
                s.close()
            except Exception:
                _log.exception("telemetry sink %r close failed", s)

    # -- summaries -----------------------------------------------------------

    def summary(self) -> Dict[str, Any]:
        """Aggregate view of the run (the ``summary`` record's body)."""
        mem = self.peak_bytes_run
        out = {"steps_emitted": self._steps_emitted,
               "compile_count": self.compile_count,
               "retrace_count": self.retrace_count,
               "hlo_flops_per_call": self.hlo_flops_per_call,
               "peak_bytes": mem,
               "stager_leaked": self.stager_leaked,
               "background_failures": self.background_failures}
        for s in self.sinks:
            if isinstance(s, InMemorySink) and s.records:
                steps = s.by_kind("step")
                if steps:
                    for key in ("host_stack_ms", "shard_ms", "dispatch_ms",
                                "device_ms", "replay_ms", "stage_ms",
                                "drain_wait_ms", "overlap_frac"):
                        # profiled records fence inside their dispatch
                        # window (anomaly-armed capture) — their breakdown
                        # is not comparable, same rule as emit_step
                        vals = [r[key] for r in steps
                                if r.get(key) is not None
                                and not r.get("profiled")]
                        if vals:
                            out[f"mean_{key}"] = round(
                                float(np.mean(vals)), 4)
                    last = steps[-1]
                    for key in ("tokens_per_sec", "est_mfu_pct",
                                "grad_norm"):
                        if last.get(key) is not None:
                            out[key] = last[key]
                    # pipelined aggregate rate from record timestamps (the
                    # per-record rate is deliberately absent — see
                    # emit_step): steps completed between the first and
                    # last drained records over their wall span
                    piped = [r for r in steps
                             if r.get("drain_wait_ms") is not None]
                    if len(piped) >= 2:
                        span = piped[-1]["ts"] - piped[0]["ts"]
                        done = sum(r.get("k_steps") or 1
                                   for r in piped[1:])
                        if span > 0:
                            rate = done / span
                            out["pipelined_steps_per_sec"] = round(rate, 3)
                            if self.tokens_per_step:
                                out["pipelined_tokens_per_sec"] = round(
                                    rate * self.tokens_per_step, 2)
                break
        return out
