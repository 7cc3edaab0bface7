"""Iteration-level (continuous-batching) request scheduling — the port of
``Request`` and ``ContinuousBatchingScheduler`` from
``paddle_tpu/serve/scheduler.py``, colocated or split between a prefill
and a decode scheduler.

Scheduling decisions happen between decode ticks: a queued request takes
a slot the moment one frees, and a finished request is evicted the moment
its last token lands; the tick's ``[S]`` shape never changes (the
engine's active mask absorbs the churn). ``policy="static"`` is the gang
baseline: a batch is admitted only when every slot is free.

Because admission happens between ticks, the queue order is the whole
policy: ``order="fcfs"`` admits in arrival order, ``"sjf"`` the shortest
decode budget first, ``"priority"`` the highest ``priority`` tier first
(arrival breaks every tie). A request may carry ``deadline_s``, a budget
from its submission: past it, a queued, prefilling or running request is
finished with ``finish_reason="timeout"`` between ticks and its blocks
return to the pool. With ``shed=True`` a deadline-carrying request whose
predicted completion already passes its deadline is rejected at
submission (``finish_reason="shed"``), which needs a tick-time estimate:
``est_tick_s`` as the prior, then an average over the observed intervals
between busy steps. The clock is injectable, so deadlines are tested
exactly with a fake one.

On a chunked engine (``prefill_chunk=C``) an admitted request prefills
one chunk per :meth:`~ContinuousBatchingScheduler.step`, between decode
ticks, so a long prompt does not stall the running slots. A speculative
tick may retire several tokens per slot; they pass the finish rules one
at a time, so eos and length stop exactly where the plain engine stops.

Prefill/decode disaggregation: a ``role="prefill"`` scheduler admits and
prefills only; the moment a request's first token lands (and the request
is not already finished) it exports the slot (``engine.export_slot``)
into :meth:`~ContinuousBatchingScheduler.pop_handoffs` and frees it. A
``role="decode"`` scheduler takes such a hand-off with
:meth:`~ContinuousBatchingScheduler.adopt` (``engine.adopt_slot``) and
decodes it to the end, its record keeping the original submission and
first-token times. ``role="both"`` (the default) is colocated serving.
The pages travel in the pool's own dtype; between processes they cross as
``kv_cache.pages_to_blobs`` / ``blobs_to_pages``.

Observability, as in the JAX scheduler: ``telemetry=`` (default the
engine's) gets one ``kind="request"`` record per finished request
(:meth:`Request.record`: TTFT, TPOT, wall, the sharing and speculation
stats) and one ``kind="evict"`` record per deadline eviction; ``tracer=``
gets ``queue_wait``, ``prefill_chunk``, ``decode_tick``, ``finish``,
``handoff_out`` and ``adopt`` spans keyed by the request id as their flow
id, and ``backpressure`` instants; ``metrics=`` the queue-depth gauges
and the finished and eviction counters. None of them is needed: each
site tests for None.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

__all__ = ["Request", "ContinuousBatchingScheduler", "ORDERS"]

# queue orders: arrival, shortest decode budget first, highest priority
# tier first (arrival breaks the ties of all three)
ORDERS = ("fcfs", "sjf", "priority")


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle timestamps.
    ``finish_reason`` is ``"length"``, ``"eos"``, ``"timeout"`` (its
    ``deadline_s`` from submission passed) or ``"shed"`` (rejected at
    submission). ``priority`` is the tier the ``"priority"`` order admits
    by, ``seq`` the scheduler's arrival index the orders break ties on;
    ``retries`` counts resubmissions of the request (given at
    ``submit``)."""
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    deadline_s: Optional[float] = None
    priority: int = 0
    retries: int = 0
    seq: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    submit_ts: float = 0.0
    first_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    finish_reason: Optional[str] = None
    # the engine's per-slot sharing stats, copied at finish (None for a
    # request that never took a slot)
    prefix_hit_blocks: Optional[int] = None
    blocks_reserved: Optional[int] = None
    cow_forks: Optional[int] = None
    prefill_chunks: Optional[int] = None
    draft_proposed: Optional[int] = None
    draft_accepted: Optional[int] = None

    @property
    def done(self) -> bool:
        return self.finish_ts is not None

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_ts is None:
            return None
        return (self.first_token_ts - self.submit_ts) * 1e3

    @property
    def tpot_ms(self) -> Optional[float]:
        """Mean time per token after the first; None until finished or
        with a single token."""
        if self.finish_ts is None or len(self.tokens) < 2:
            return None
        return ((self.finish_ts - self.first_token_ts) * 1e3
                / (len(self.tokens) - 1))

    def record(self) -> Dict[str, Any]:
        """The request's ``kind="request"`` telemetry record."""
        return {
            "kind": "request", "rid": self.rid,
            "prompt_len": len(self.prompt),
            "new_tokens": len(self.tokens),
            "slot": self.slot,
            "finish_reason": self.finish_reason,
            "deadline_s": self.deadline_s,
            "priority": self.priority,
            "retries": self.retries,
            "ttft_ms": round(self.ttft_ms, 4)
            if self.ttft_ms is not None else None,
            "tpot_ms": round(self.tpot_ms, 4)
            if self.tpot_ms is not None else None,
            # `is not None`: a fake clock may finish at exactly 0.0
            "wall_ms": round((self.finish_ts - self.submit_ts) * 1e3, 4)
            if self.finish_ts is not None else None,
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "blocks_reserved": self.blocks_reserved,
            "cow_forks": self.cow_forks,
            "prefill_chunks": self.prefill_chunks,
            # raw counts ride along so aggregates can weight by volume
            "draft_proposed": self.draft_proposed,
            "draft_accepted": self.draft_accepted,
            "draft_accept_rate": round(
                self.draft_accepted / self.draft_proposed, 4)
            if self.draft_proposed else None,
        }


class ContinuousBatchingScheduler:
    """Drives a :class:`~paddle_tpu_torch.serve.DecodeEngine` over a
    request queue.

    ``policy`` is ``"continuous"`` (admit between every tick) or
    ``"static"`` (the gang baseline); ``order`` one of :data:`ORDERS`;
    ``shed=True`` turns on submit-time shedding, with ``est_tick_s`` the
    prior tick time (no estimate and no observation: nothing is shed);
    ``clock`` the wall clock (default ``time.perf_counter``); ``role``
    ``"both"`` (colocated), ``"prefill"`` (hands each prefilled request
    off) or ``"decode"`` (also adopts hand-offs); ``telemetry``,
    ``tracer`` and ``metrics`` the observability hooks (see the module
    docstring; a tracer should share the scheduler's clock)."""

    def __init__(self, engine, telemetry=None, policy: str = "continuous",
                 order: str = "fcfs", shed: bool = False,
                 est_tick_s: Optional[float] = None,
                 clock=time.perf_counter, tracer=None,
                 role: str = "both", metrics=None):
        if policy not in ("continuous", "static"):
            raise ValueError(f"policy must be 'continuous'|'static', "
                             f"got {policy!r}")
        if order not in ORDERS:
            raise ValueError(f"order must be one of {ORDERS}, got {order!r}")
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"role must be 'both'|'prefill'|'decode', "
                             f"got {role!r}")
        self.engine = engine
        self.telemetry = (telemetry if telemetry is not None
                          else engine.telemetry)
        self.tracer = tracer
        self.metrics = metrics
        self.policy = policy
        self.order = order
        self.role = role
        self.shed = shed
        self.est_tick_s = est_tick_s
        self._clock = clock
        self.queue: List[Request] = []
        self.running: Dict[int, Request] = {}        # slot -> request
        self.prefilling: Dict[int, Request] = {}     # slot -> request
        self.completed: List[Request] = []
        self.last_backpressure: Optional[str] = None
        # prefilled requests awaiting transfer: (request, meta, kpages,
        # vpages), drained by pop_handoffs()
        self.handoffs: List[tuple] = []
        self._rid = itertools.count()
        self._seq = itertools.count()
        self._last_step_ts: Optional[float] = None
        self._was_busy = False

    # -- load model --------------------------------------------------------

    def pending_new_tokens(self) -> int:
        """Decode tokens still owed: the remaining budget of every running
        request plus the whole budget of every queued and prefilling one
        (a backlog in ticks times slots)."""
        run = sum(r.max_new_tokens - len(r.tokens)
                  for r in self.running.values())
        return (run + sum(r.max_new_tokens for r in self.queue)
                + sum(r.max_new_tokens for r in self.prefilling.values()))

    def prefill_backlog(self) -> int:
        """Prompt tokens not yet prefilled (queued and prefilling)."""
        return (sum(len(r.prompt) for r in self.queue)
                + sum(len(r.prompt) for r in self.prefilling.values()))

    def load_report(self) -> Dict[str, Any]:
        """The load payload a replica publishes, on which a router
        balances and an autoscaler senses: owed decode tokens, request
        counts, the prefill backlog and the replica's role."""
        return {"pending_new_tokens": self.pending_new_tokens(),
                "running": len(self.running), "queued": len(self.queue),
                "prefilling": len(self.prefilling),
                "prefill_backlog": self.prefill_backlog(),
                "role": self.role}

    def predicted_completion_s(self, max_new_tokens: int
                               ) -> Optional[float]:
        """Predicted seconds from submission to finish of a new request
        under the current backlog, or None without a tick-time estimate.
        The service rate is taken as ``max_slots`` tokens a tick (the
        full-batch bound), so the wait is ``backlog / max_slots`` ticks and
        the run ``max_new_tokens`` ticks: an underestimate under partial
        occupancy, which sheds less, not more."""
        if self.est_tick_s is None:
            return None
        ticks = (self.pending_new_tokens() / max(1, self.engine.max_slots)
                 + max_new_tokens)
        return ticks * self.est_tick_s

    # -- submission --------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_id: Optional[int] = None,
               deadline_s: Optional[float] = None,
               priority: int = 0, rid: Optional[int] = None,
               submit_ts: Optional[float] = None,
               retries: int = 0) -> Request:
        """Queue one request; the padded prefill array is staged now, off
        the tick loop. A shed request comes back finished. ``rid``,
        ``submit_ts`` and ``retries`` are for a resubmitted request: it
        keeps its id (the caller keeps ids unique) and its original
        submission time, so TTFT, wall time and the deadline run from the
        first submission."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        now = self._clock()
        req = Request(rid=next(self._rid) if rid is None else rid,
                      prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      deadline_s=deadline_s, priority=priority,
                      retries=retries, seq=next(self._seq),
                      submit_ts=now if submit_ts is None else submit_ts)
        if len(req.prompt) + max_new_tokens > self.engine.context_width:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new_tokens "
                f"{max_new_tokens} exceeds slot capacity "
                f"{self.engine.context_width}")
        if self.shed and deadline_s is not None:
            est = self.predicted_completion_s(max_new_tokens)
            waited = max(0.0, now - req.submit_ts)
            if est is not None and waited + est > deadline_s:
                self._finish(req, "shed")     # no slot, no blocks
                return req
        req._staged = self.engine.stage_prompt(req.prompt)
        self.queue.append(req)
        return req

    # -- the tick loop -----------------------------------------------------

    def _finish(self, req: Request, reason: str) -> None:
        """Stamp the reason and time; a request holding a slot (running or
        prefilling) copies the engine's per-slot stats and gives the slot's
        blocks back."""
        req.finish_ts = self._clock()
        req.finish_reason = reason
        slot = req.slot
        if slot is not None and (self.running.get(slot) is req
                                 or self.prefilling.get(slot) is req):
            st = self.engine.slot_stats[slot]
            for key in ("prefix_hit_blocks", "blocks_reserved", "cow_forks",
                        "prefill_chunks", "draft_proposed",
                        "draft_accepted"):
                setattr(req, key, st.get(key))
            self.running.pop(slot, None)
            self.prefilling.pop(slot, None)
            self.engine.evict(slot)
        self.completed.append(req)
        if self.metrics is not None:
            self.metrics.counter(
                "sched_requests_finished",
                "terminal requests by finish reason",
                reason=reason).inc()
        if self.tracer is not None:
            self.tracer.complete("finish", req.finish_ts * 1e6,
                                 flow_step=req.rid, rid=req.rid,
                                 reason=reason,
                                 new_tokens=len(req.tokens))
        if self.telemetry is not None:
            self.telemetry.emit_event(req.record())

    def _emit_evict(self, req: Request, where: str,
                    blocks_freed: int) -> None:
        """One ``kind="evict"`` record per deadline eviction, whether the
        request held a slot, was prefilling or was still queued."""
        if self.metrics is not None:
            self.metrics.counter(
                "sched_evictions",
                "deadline evictions by where the request was caught",
                where=where).inc()
        if self.telemetry is not None:
            self.telemetry.emit_event({
                "kind": "evict", "rid": req.rid, "where": where,
                "blocks_freed": blocks_freed,
                "deadline_s": req.deadline_s,
                "queued": len(self.queue), "running": len(self.running),
            })

    def _expire(self) -> None:
        """The deadline sweep, between ticks: a running or prefilling
        request past its deadline is finished and its blocks freed; a
        queued one is dropped before it takes a slot."""
        now = self._clock()

        def expired(req):
            return (req.deadline_s is not None
                    and now - req.submit_ts > req.deadline_s)

        for where, table in (("running", self.running),
                             ("prefilling", self.prefilling)):
            for slot, req in [(s, r) for s, r in table.items()
                              if expired(r)]:
                self._emit_evict(req, where,
                                 self.engine.cache.owned_count(slot))
                self._finish(req, "timeout")
        for req in [r for r in self.queue if expired(r)]:
            self.queue.remove(req)
            self._emit_evict(req, "queued", 0)
            self._finish(req, "timeout")

    def _admit_order(self) -> List[Request]:
        """The queue in admission order: arrival (fcfs), decode budget
        (sjf: prefill is one call whatever the prompt) or descending tier
        (priority), arrival breaking ties."""
        if self.order == "sjf":
            return sorted(self.queue, key=lambda r: (r.max_new_tokens,
                                                     r.seq))
        if self.order == "priority":
            return sorted(self.queue, key=lambda r: (-r.priority, r.seq))
        return list(self.queue)

    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self.running[slot]
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length")

    def _admit(self) -> None:
        self.last_backpressure = None
        if self.policy == "static" and (self.running or self.prefilling):
            return                       # gang: wait for the whole batch
        free = self.engine.free_slots()
        for req in self._admit_order():
            if not free:
                break
            # a tick appends the pending token before sampling, so the
            # cache holds prompt + all generated tokens but the last
            target = max(len(req.prompt) + req.max_new_tokens - 1,
                         len(req.prompt))
            probe = self.engine.admit_probe(target, include_slots=False)
            if not probe.ok:
                # pool backpressure: stop in policy order (a bypass by a
                # smaller request would starve the head)
                self.last_backpressure = probe.reason
                if self.tracer is not None:
                    self.tracer.instant("backpressure", rid=req.rid,
                                        reason=probe.reason,
                                        queued=len(self.queue))
                break
            self.queue.remove(req)
            if self.tracer is not None:
                # the wait in the queue, submission to now, on the
                # scheduler's clock
                self.tracer.complete("queue_wait", req.submit_ts * 1e6,
                                     self.tracer.now_us(),
                                     flow_step=req.rid, rid=req.rid)
            slot = free.pop(0)
            req.slot = slot
            self.engine.begin_prefill(slot, req.prompt, reserve_len=target,
                                      staged=req._staged)
            self.prefilling[slot] = req
            # the whole prompt on a one-shot engine, the first chunk on a
            # chunked one; the rest interleave with decode ticks
            self._advance_prefill(slot)

    def _advance_prefill(self, slot: int) -> None:
        """One prefill call for a reserved slot; the request runs once its
        first token lands."""
        if self.tracer is not None:
            with self.tracer.span("prefill_chunk",
                                  rid=self.prefilling[slot].rid, slot=slot):
                tok = self.engine.prefill_step(slot)
        else:
            tok = self.engine.prefill_step(slot)
        if tok is None:
            return
        req = self.prefilling.pop(slot)
        req.tokens.append(tok)
        req.first_token_ts = self._clock()
        self.running[slot] = req
        self._maybe_finish(slot, tok)
        if self.role == "prefill" and not req.done:
            # the prompt's pages and the pending first token leave for a
            # decode scheduler; a request finished at its first token
            # (eos, max_new_tokens 1) ends here
            self._hand_off(slot, req)

    def _hand_off(self, slot: int, req: Request) -> None:
        """Export a just-prefilled slot and free it here. The request
        leaves without a completed record: the adopting scheduler writes
        it, with the original submission and first-token times. The
        prefill side's stats (prefix hits, chunks) ride the meta into the
        decode slot's."""
        meta, kpages, vpages = self.engine.export_slot(slot)
        st = self.engine.slot_stats[slot]
        meta.update({
            "rid": req.rid, "prompt": list(req.prompt),
            "max_new_tokens": req.max_new_tokens,
            "eos_id": req.eos_id, "deadline_s": req.deadline_s,
            "priority": req.priority, "retries": req.retries,
            "submit_ts": req.submit_ts, "first_token": req.tokens[0],
            "first_token_ts": req.first_token_ts,
            "prefill_stats": {key: st.get(key, 0) for key in (
                "prefix_hit_blocks", "shared_len", "cow_forks",
                "prefill_chunks")}})
        del self.running[slot]
        self.engine.evict(slot)
        req.slot = None
        self.handoffs.append((req, meta, kpages, vpages))
        if self.tracer is not None:
            self.tracer.complete("handoff_out", self._clock() * 1e6,
                                 flow_step=req.rid, rid=req.rid,
                                 blocks=meta["blocks"])

    def pop_handoffs(self) -> List[tuple]:
        """Drain the prefilled requests awaiting transfer: ``(request,
        meta, kpages, vpages)`` tuples."""
        out, self.handoffs = self.handoffs, []
        return out

    def adopt(self, meta: Dict[str, Any], kpages,
              vpages) -> Optional[Request]:
        """Take a hand-off: check capacity, import its pages into a free
        slot and enter the request in ``running`` with its first token.
        None, and nothing changed, when no slot is free or the pool cannot
        hold the request's whole reservation (``last_backpressure`` says
        which)."""
        free = self.engine.free_slots()
        if not free:
            self.last_backpressure = "slots"
            return None
        prompt = [int(t) for t in meta["prompt"]]
        max_new = int(meta["max_new_tokens"])
        target = max(len(prompt) + max_new - 1, len(prompt))
        probe = self.engine.admit_probe(target, include_slots=False)
        if not probe.ok:
            self.last_backpressure = probe.reason
            return None
        req = Request(
            rid=int(meta["rid"]), prompt=prompt, max_new_tokens=max_new,
            eos_id=meta.get("eos_id"), deadline_s=meta.get("deadline_s"),
            priority=int(meta.get("priority") or 0),
            retries=int(meta.get("retries") or 0), seq=next(self._seq),
            submit_ts=meta["submit_ts"])
        slot = free[0]
        if not self.engine.adopt_slot(slot, prompt, int(meta["first_token"]),
                                      kpages, vpages, reserve_len=target):
            self.last_backpressure = "blocks"
            return None
        req.slot = slot
        req.tokens = [int(meta["first_token"])]
        req.first_token_ts = meta.get("first_token_ts")
        self.running[slot] = req
        # the decode slot's stats start from the prefill side's
        self.engine.slot_stats[slot].update(meta.get("prefill_stats") or {})
        self.last_backpressure = None
        if self.tracer is not None:
            self.tracer.complete("adopt", self._clock() * 1e6,
                                 flow_step=req.rid, rid=req.rid,
                                 slot=slot, blocks=meta.get("blocks"))
        return req

    def step(self) -> bool:
        """Expire deadlines, advance every prefilling slot by one chunk,
        admit, run one decode tick, collect finished requests. Returns
        True while work remains."""
        now = self._clock()
        if self._last_step_ts is not None and self._was_busy:
            # the tick-time estimate: an average over the intervals
            # between busy steps (after an idle one the interval is think
            # time, not tick time)
            dt = now - self._last_step_ts
            if dt > 0:
                self.est_tick_s = (dt if self.est_tick_s is None
                                   else 0.7 * self.est_tick_s + 0.3 * dt)
        self._last_step_ts = now
        self._expire()
        for slot in list(self.prefilling):
            self._advance_prefill(slot)
        self._admit()
        if self.running:
            active = len(self.running)
            t0 = self.tracer.now_us() if self.tracer is not None else None
            self.engine.decode_tick()
            accepted = self.engine.last_accepted
            n_tok = 0
            for slot, req in list(self.running.items()):
                for tok in accepted.get(slot, ()):
                    req.tokens.append(tok)
                    n_tok += 1
                    self._maybe_finish(slot, tok)
                    if req.done:
                        break
            if t0 is not None:
                self.tracer.complete("decode_tick", t0, self.tracer.now_us(),
                                     active=active, tokens=n_tok)
        if self.metrics is not None:
            self.metrics.gauge("sched_queue_depth",
                               "requests queued for admission").set(
                len(self.queue))
            self.metrics.gauge("sched_running",
                               "requests holding a decode slot").set(
                len(self.running))
            self.metrics.gauge("sched_prefilling",
                               "slots mid chunked prefill").set(
                len(self.prefilling))
        self._was_busy = bool(self.queue or self.running or self.prefilling)
        return self._was_busy

    def run(self, max_ticks: int = 100000) -> List[Request]:
        """Step until the queue drains; returns completed requests in
        completion order."""
        for _ in range(max_ticks):
            if not self.step():
                break
        else:
            raise RuntimeError(f"scheduler did not drain in "
                               f"{max_ticks} ticks")
        return self.completed
