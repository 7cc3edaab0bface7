"""The host pipeline of ``Trainer(pipeline_depth=W)`` — the port of
``paddle_tpu/train/host_pipeline.py``.

With ``steps_per_call=K`` the trainer runs K optimizer steps a call and
fetches their K losses in one device-to-host copy. Serially the host
still waits on each call: it stacks the group's K·M host batches, copies
them to the card, launches the K steps, then waits for the losses before
it touches the next group. Three pieces take that wait off the card's
path; none of them changes what the card computes (``pipeline_depth > 1``
is bit-identical to the serial loop: the same kernels, in the same
order, on the same values):

- :class:`GroupStager` — one background thread that stacks the NEXT
  group into pinned host buffers and copies it to the card with
  ``non_blocking=True`` on a side CUDA stream, recording an event. The
  training thread makes its compute stream wait on that event before the
  group's first step and marks the copied tensors with ``record_stream``,
  so the caching allocator keeps them until the compute stream is done
  with them; the pinned buffers stay referenced until the group drains.
  Its input queue holds one raw group, so host memory stays bounded.
- the **window** — up to W calls in flight, their loss tensors not yet
  fetched (their events, costs and logging wait with them).
- the **drain** — FIFO, so events fire in the serial order. It runs when
  the window is full (the oldest call only), before every
  ``saving_period`` save (the save must see the state at exactly that
  group's last step, and ``nan_check``'s skip-the-poisoned-save rule
  needs the group's losses on the host), and at pass end.

On the CPU there are no streams: the stager stacks into plain tensors.

With telemetry attached each call's record carries ``stage_ms`` (the
stager's stack and copy wall, off the loop's path), ``drain_wait_ms``
(the blocking fetch at the drain) and ``overlap_frac`` (the share of the
staging cost hidden from the training thread: 1 - the time it waited
on the stager / the staging time). With a tracer the stager's ``stage``
span, the call's ``dispatch`` and the group's ``drain`` share one flow
id. A stager thread that misses its join deadline at close sets
``telemetry.stager_leaked``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["GroupStager", "StagedUnit", "StagedGroup", "FusedPipeline"]

_log = logging.getLogger("paddle_tpu_torch.host_pipeline")


@dataclasses.dataclass
class StagedUnit:
    """One call's slice of a group: the ``[k, m_eff, batch, ...]`` device
    tensors, the event that marks their copy done (None on the CPU), the
    pinned host buffers they were copied from, and the stager's stack and
    copy seconds."""
    offset: int          # first host-batch index within the group buffer
    m_eff: int
    batches: Dict[str, Any]
    event: Any
    host: List[Any]
    stack_s: float = 0.0
    shard_s: float = 0.0


@dataclasses.dataclass
class StagedGroup:
    buf_start: int       # pass-relative index of the group's first batch
    buf_len: int
    units: List[StagedUnit]
    boundary: bool       # crosses a saving_period checkpoint boundary
    crc: Optional[int]   # fingerprint of the group's last host batch
                         # (computed in the stager, for boundary groups)
    flow: Optional[int] = None   # tracer flow id: stage -> dispatch ->
                                 # drain


@dataclasses.dataclass
class _PendingGroup:
    """A group whose calls ran but whose losses are not yet fetched."""
    staged: StagedGroup
    results: List[tuple]     # per call, the Trainer._finalize_group layout
    overlap_frac: Optional[float] = None


class GroupStager:
    """One background staging thread with a depth-1 input queue.

    ``submit`` hands a raw group to the worker (blocking only while the
    worker still holds the previous one) and returns the seconds it
    blocked. ``get`` returns the next staged group in submission order
    with the seconds the caller waited for it. A worker exception
    re-raises in the caller at the next ``submit``/``get``.
    """

    _POLL_S = 0.05

    def __init__(self, stage_fn: Callable[[Any], Any],
                 join_timeout: float = 10.0):
        self._stage_fn = stage_fn
        self._join_timeout = float(join_timeout)
        self._in: queue.Queue = queue.Queue(maxsize=1)
        self._out: queue.Queue = queue.Queue()
        self._exc: List[BaseException] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="paddle_tpu_torch.host_pipeline.stager")
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                item = self._in.get(timeout=self._POLL_S)
            except queue.Empty:
                continue
            try:
                self._out.put(self._stage_fn(item))
            except BaseException as e:   # surface in the consumer
                self._exc.append(e)
                self._out.put(None)      # wake a blocked get()
                return

    def _check(self):
        if self._exc:
            raise self._exc[0]

    def submit(self, work) -> float:
        """Enqueue one raw group (waits while the worker holds one);
        returns the seconds waited."""
        t0 = time.perf_counter()
        while True:
            self._check()
            try:
                self._in.put(work, timeout=self._POLL_S)
                return time.perf_counter() - t0
            except queue.Full:
                continue

    def get(self, block: bool):
        """``(staged group, seconds waited)``; None when ``block=False``
        and nothing is staged yet."""
        t0 = time.perf_counter()
        while True:
            self._check()
            try:
                item = self._out.get(block=False) if not block else \
                    self._out.get(timeout=self._POLL_S)
            except queue.Empty:
                if not block:
                    return None
                continue
            if item is None:             # worker died; _check raises
                self._check()
                raise RuntimeError("host-pipeline stager exited unexpectedly")
            return item, time.perf_counter() - t0

    def close(self) -> bool:
        """Stop the worker and join it. Returns True when the thread
        missed the join deadline (stuck in a copy?): the daemon thread is
        then left behind, and the log names it."""
        self._stop.set()
        self._thread.join(timeout=self._join_timeout)
        if self._thread.is_alive():
            _log.warning(
                "host-pipeline stager thread %r did not exit within %.1fs "
                "of close(); leaving the daemon thread behind",
                self._thread.name, self._join_timeout)
            return True
        return False


class FusedPipeline:
    """Runs the grouped loop with ``pipeline_depth`` >= 2: groups flow
    reader -> stager thread -> calls -> window -> FIFO drain.

    The trainer owns the math (``_stage_group_work``, ``_run_staged``,
    ``_finalize_group``); this class owns the overlap and the drain
    policy. One instance per pass: pass end drains everything.
    """

    def __init__(self, trainer, pass_id, handler, costs, log_period,
                 saving_period, checkpoint_dir, checkpoint_keep, save_fn,
                 depth: int):
        self._tr = trainer
        self._pass_id = pass_id
        self._handler = handler
        self._costs = costs
        self._log_period = log_period
        self._saving_period = saving_period
        self._checkpoint_dir = checkpoint_dir
        self._checkpoint_keep = checkpoint_keep
        self._save_fn = save_fn
        self.depth = max(2, int(depth))
        self._stager = GroupStager(trainer._stage_group_work)
        self._window: collections.deque = collections.deque()
        self._n_submitted = 0
        self._n_dispatched = 0
        # backpressure wait in submit(), billed to the next dispatched
        # group's overlap
        self._carry_wait_s = 0.0

    def submit(self, buf, buf_start: int):
        """Hand one complete group buffer to the pipeline. Waits on the
        card only when the window or a checkpoint boundary forces a
        drain."""
        sp = self._saving_period
        end = buf_start + len(buf)
        boundary = bool(sp and self._checkpoint_dir
                        and end // sp > buf_start // sp)
        self._pump()                      # free the stager's output first
        self._carry_wait_s += self._stager.submit(
            (list(buf), buf_start, boundary))
        self._n_submitted += 1
        self._pump()

    def _pump(self):
        """Run every group already staged, without blocking."""
        while self._n_dispatched < self._n_submitted:
            got = self._stager.get(block=False)
            if got is None:
                return
            self._dispatch_staged(*got)

    def _dispatch_staged(self, sg: StagedGroup, wait_s: float):
        # make room BEFORE launching, so at most `depth` calls are ever
        # in flight
        while self._in_flight_calls() >= self.depth:
            self._drain_one()
        wait = wait_s + self._carry_wait_s
        self._carry_wait_s = 0.0
        results = [self._tr._run_staged(sg.buf_start, u, sg.flow)
                   for u in sg.units]
        stage_total = sum(u.stack_s + u.shard_s for u in sg.units)
        overlap = (max(0.0, min(1.0, 1.0 - wait / stage_total))
                   if stage_total > 0 else None)
        self._window.append(_PendingGroup(sg, results, overlap))
        self._n_dispatched += 1
        if sg.boundary:
            # the save inside _finalize_group must see the state at this
            # group's last step: no later group may run first
            self.drain_all()

    def _in_flight_calls(self) -> int:
        return sum(len(g.results) for g in self._window)

    def _drain_one(self):
        pg = self._window.popleft()
        tracer = self._tr.tracer
        # the drain span closes the group's flow (stage -> dispatch ->
        # drain)
        with (tracer.span("drain", flow_end=pg.staged.flow,
                          group=pg.staged.buf_start)
              if tracer is not None else contextlib.nullcontext()):
            self._tr._finalize_group(
                self._pass_id, pg.staged.buf_start, pg.staged.buf_len,
                pg.results, self._handler, self._costs, self._log_period,
                self._saving_period, self._checkpoint_dir,
                self._checkpoint_keep, self._save_fn,
                crc_fn=lambda: pg.staged.crc, drain_timing=True,
                overlap_frac=pg.overlap_frac)

    def drain_all(self):
        while self._window:
            self._drain_one()

    def flush(self):
        """Pass end: run everything still staging, then drain the whole
        window (FIFO)."""
        while self._n_dispatched < self._n_submitted:
            self._dispatch_staged(*self._stager.get(block=True))
        self.drain_all()

    def close(self):
        leaked = self._stager.close()
        if leaked and self._tr.telemetry is not None:
            self._tr.telemetry.stager_leaked = True
