"""Iteration-level (continuous-batching) request scheduling — the port of
``Request`` and ``ContinuousBatchingScheduler`` from
``paddle_tpu/serve/scheduler.py`` for colocated serving in arrival order.

Scheduling decisions happen between decode ticks: a queued request takes
a slot the moment one frees, and a finished request is evicted the moment
its last token lands; the tick's ``[S]`` shape never changes (the
engine's active mask absorbs the churn). ``policy="static"`` is the gang
baseline: a batch is admitted only when every slot is free.

On a chunked engine (``prefill_chunk=C``) an admitted request prefills
one chunk per :meth:`~ContinuousBatchingScheduler.step`, between decode
ticks, so a long prompt does not stall the running slots. A speculative
tick may retire several tokens per slot; they pass the finish rules one
at a time, so eos and length stop exactly where the plain engine stops.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional

__all__ = ["Request", "ContinuousBatchingScheduler"]


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle timestamps;
    ``finish_reason`` is ``"length"`` or ``"eos"``."""
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    submit_ts: float = 0.0
    first_token_ts: Optional[float] = None
    finish_ts: Optional[float] = None
    finish_reason: Optional[str] = None
    # the engine's per-slot sharing stats, copied at finish
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


class ContinuousBatchingScheduler:
    """Drives a :class:`~paddle_tpu_torch.serve.DecodeEngine` over a
    request queue, admitting in arrival order."""

    def __init__(self, engine, policy: str = "continuous"):
        if policy not in ("continuous", "static"):
            raise ValueError(f"policy must be 'continuous'|'static', "
                             f"got {policy!r}")
        self.engine = engine
        self.policy = policy
        self.queue: List[Request] = []
        self.running: Dict[int, Request] = {}        # slot -> request
        self.prefilling: Dict[int, Request] = {}     # slot -> request
        self.completed: List[Request] = []
        self.last_backpressure: Optional[str] = None
        self._rid = itertools.count()

    def submit(self, prompt: List[int], max_new_tokens: int,
               eos_id: Optional[int] = None) -> Request:
        """Queue one request; the padded prefill array is staged now, off
        the tick loop."""
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      submit_ts=time.perf_counter())
        if len(req.prompt) + max_new_tokens > self.engine.context_width:
            raise ValueError(
                f"prompt {len(req.prompt)} + max_new_tokens "
                f"{max_new_tokens} exceeds slot capacity "
                f"{self.engine.context_width}")
        req._staged = self.engine.stage_prompt(req.prompt)
        self.queue.append(req)
        return req

    def _finish(self, req: Request, reason: str) -> None:
        req.finish_ts = time.perf_counter()
        req.finish_reason = reason
        slot = req.slot
        st = self.engine.slot_stats[slot]
        for key in ("prefix_hit_blocks", "blocks_reserved", "cow_forks",
                    "prefill_chunks", "draft_proposed", "draft_accepted"):
            setattr(req, key, st.get(key))
        self.running.pop(slot, None)
        self.prefilling.pop(slot, None)
        self.engine.evict(slot)
        self.completed.append(req)

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
        while free and self.queue:
            req = self.queue[0]
            # a tick appends the pending token before sampling, so the
            # cache holds prompt + all generated tokens but the last
            target = max(len(req.prompt) + req.max_new_tokens - 1,
                         len(req.prompt))
            probe = self.engine.admit_probe(target, include_slots=False)
            if not probe.ok:
                # pool backpressure: stop in arrival order (no bypass)
                self.last_backpressure = probe.reason
                break
            self.queue.pop(0)
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
        tok = self.engine.prefill_step(slot)
        if tok is None:
            return
        req = self.prefilling.pop(slot)
        req.tokens.append(tok)
        req.first_token_ts = time.perf_counter()
        self.running[slot] = req
        self._maybe_finish(slot, tok)

    def step(self) -> bool:
        """Advance every prefilling slot by one chunk, admit, run one
        decode tick, collect finished requests. Returns True while work
        remains."""
        for slot in list(self.prefilling):
            self._advance_prefill(slot)
        self._admit()
        if self.running:
            self.engine.decode_tick()
            accepted = self.engine.last_accepted
            for slot, req in list(self.running.items()):
                for tok in accepted.get(slot, ()):
                    req.tokens.append(tok)
                    self._maybe_finish(slot, tok)
                    if req.done:
                        break
        return bool(self.queue or self.running or self.prefilling)

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
