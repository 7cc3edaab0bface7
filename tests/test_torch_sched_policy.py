"""The port's scheduler policy (CPU, a fake clock throughout): the sjf and
priority admission orders, submit-time shedding, deadlines that finish
queued, prefilling and running requests and return every block, the
tick-time estimate, the load numbers — each as the JAX scheduler's tests
say (``tests/test_fleet.py``, ``tests/test_serve.py``), and the same
finish reasons, tokens and admission order as the JAX scheduler on bridged
weights, and the same ``load_report`` payload (role included) step by
step for each role. Then the engine's programs run eagerly on their static buffers:
the greedy streams under admit/evict churn equal the model's own
token-by-token forward, with every buffer at one address throughout; and
a capture holds Python's cyclic garbage collection off (a collection
inside a CUDA graph capture can run a finalizer that invalidates it)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.serve import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serve import DecodeEngine as JDecodeEngine
from paddle_tpu_torch import (ContinuousBatchingScheduler, DecodeEngine,
                              TransformerLM, load_jax_params)
from paddle_tpu_torch.serve import ORDERS

V, W, DIM, LAYERS, HEADS, FFN = 64, 32, 32, 2, 4, 64
BS = 4


class FakeClock:
    """The scheduler's clock, advanced by the test."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def models():
    jm = JTransformerLM(vocab=V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                        ffn_hidden=FFN, max_len=W, use_flash=True)
    vs = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, W), jnp.int32))
    tm = TransformerLM(V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                       ffn_hidden=FFN, max_len=W, use_flash=True,
                       device="cpu")
    load_jax_params(tm, vs)
    return jm, vs, tm


def _engine(tm, **kw):
    kw.setdefault("max_slots", 2)
    return DecodeEngine(tm, block_size=BS, device="cpu", **kw)


def _drain(sched, clock, dt=1.0):
    while sched.step():
        clock.t += dt


def _all_free(eng):
    pool = list(eng.cache.allocator._free) + \
        list(eng.cache.allocator._retained)
    return (len(pool) == len(set(pool)) == eng.cache.num_blocks - 1
            and not eng.cache.allocator._rc and not eng.active.any())


# ---------------------------------------------------------------------------
# admission orders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order,first", [("sjf", "short"),
                                         ("priority", "vip"),
                                         ("fcfs", "long")])
def test_admission_orders(models, order, first):
    _, _, tm = models
    clock = FakeClock()
    sched = ContinuousBatchingScheduler(_engine(tm, max_slots=1),
                                        order=order, clock=clock)
    reqs = {"long": sched.submit([1, 2, 3], 8, priority=0),
            "short": sched.submit([4, 5], 2, priority=0),
            "vip": sched.submit([6, 7], 8, priority=3)}
    _drain(sched, clock, 0.25)
    got = min(reqs, key=lambda k: reqs[k].first_token_ts)
    assert got == first
    assert all(r.finish_reason == "length" for r in reqs.values())
    assert _all_free(sched.engine)


def test_order_ties_break_by_arrival_and_bad_order_raises(models):
    _, _, tm = models
    clock = FakeClock()
    sched = ContinuousBatchingScheduler(_engine(tm, max_slots=1),
                                        order="sjf", clock=clock)
    a = sched.submit([1, 2], 3)
    b = sched.submit([3, 4], 3)
    c = sched.submit([5, 6], 3)
    _drain(sched, clock)
    assert a.first_token_ts < b.first_token_ts < c.first_token_ts
    assert ORDERS == ("fcfs", "sjf", "priority")
    with pytest.raises(ValueError, match="order"):
        ContinuousBatchingScheduler(sched.engine, order="lifo")


# ---------------------------------------------------------------------------
# shedding and the load model
# ---------------------------------------------------------------------------

def test_shed_rejects_fast(models):
    _, _, tm = models
    eng = _engine(tm)
    clock = FakeClock()
    sched = ContinuousBatchingScheduler(eng, shed=True, est_tick_s=1.0,
                                        clock=clock)
    free0 = eng.cache.free_blocks
    keep = [sched.submit([1, 2, 3], 10) for _ in range(2)]
    assert sched.pending_new_tokens() == 20
    # 20 owed / 2 slots = 10 ticks of queue, 4 of run: past a 3 s deadline
    assert sched.predicted_completion_s(4) == 14.0
    shed = sched.submit([4, 5], 4, deadline_s=3.0)
    assert shed.done and shed.finish_reason == "shed"
    assert shed.slot is None and shed.tokens == [] and shed not in \
        sched.queue
    assert eng.cache.free_blocks == free0     # shed took no blocks
    ok = sched.submit([6, 7], 2, deadline_s=100.0)
    _drain(sched, clock)
    assert all(r.finish_reason == "length" for r in keep + [ok])
    assert sched.completed[0] is shed
    # without evidence nothing is shed
    s2 = ContinuousBatchingScheduler(_engine(tm, max_slots=1), shed=True)
    r = s2.submit([1, 2], 2, deadline_s=0.001)
    assert not r.done and len(s2.queue) == 1


def test_tick_estimate_and_load_report(models):
    _, _, tm = models
    clock = FakeClock()
    sched = ContinuousBatchingScheduler(_engine(tm, prefill_chunk=2),
                                        clock=clock)
    assert sched.predicted_completion_s(4) is None
    sched.submit([1, 2, 3, 4, 5], 3)
    sched.submit([6, 7, 8], 4)
    sched.submit([9], 2)
    assert sched.load_report() == {"pending_new_tokens": 9, "running": 0,
                                   "queued": 3, "prefilling": 0,
                                   "prefill_backlog": 9, "role": "both"}
    sched.step()                     # first chunks; nobody runs yet
    rep = sched.load_report()
    assert rep["prefilling"] == 2 and rep["queued"] == 1
    assert rep["prefill_backlog"] == 9
    # the estimate: the first busy interval, then 0.7 old + 0.3 new
    clock.t = 2.0
    sched.step()
    assert sched.est_tick_s == 2.0
    clock.t = 3.0
    sched.step()
    assert sched.est_tick_s == pytest.approx(0.7 * 2.0 + 0.3 * 1.0)
    _drain(sched, clock)
    est = sched.est_tick_s
    clock.t += 50.0                  # an idle lull is not tick time
    sched.step()
    assert sched.est_tick_s == est
    assert sched.pending_new_tokens() == 0


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------

def test_deadline_evicts_running_and_returns_blocks(models):
    _, _, tm = models
    eng = _engine(tm)
    clock = FakeClock()
    sched = ContinuousBatchingScheduler(eng, clock=clock)
    stuck = sched.submit([1, 2, 3, 4], 18, deadline_s=2.5)
    quick = sched.submit([5, 6, 7, 8], 3)
    sched.step()
    owned = list(eng.cache._owned[stuck.slot])
    assert owned
    clock.t += 1.0
    _drain(sched, clock)
    assert quick.finish_reason == "length"
    assert stuck.finish_reason == "timeout"
    assert 1 <= len(stuck.tokens) < 18
    assert stuck.blocks_reserved == len(owned)
    reclaimable = set(eng.cache.allocator._free) | set(
        eng.cache.allocator._retained)
    assert set(owned) <= reclaimable and _all_free(eng)


def test_deadline_drops_queued_request(models):
    _, _, tm = models
    eng = _engine(tm, max_slots=1)
    clock = FakeClock()
    sched = ContinuousBatchingScheduler(eng, clock=clock)
    long_req = sched.submit([1, 2, 3, 4], 10)
    starved = sched.submit([5, 6, 7, 8], 4, deadline_s=3.0)
    _drain(sched, clock)
    assert long_req.finish_reason == "length"
    assert starved.finish_reason == "timeout"
    assert starved.slot is None and starved.tokens == []
    assert starved.blocks_reserved is None and _all_free(eng)


def test_deadline_evicts_prefilling_request(models):
    """A chunked prefill past its deadline gives its slot and its whole
    reservation back before its first token."""
    _, _, tm = models
    eng = _engine(tm, prefill_chunk=2)
    clock = FakeClock()
    sched = ContinuousBatchingScheduler(eng, clock=clock)
    runner = sched.submit([1, 2], 6)
    slow = sched.submit(list(range(3, 23)), 4, deadline_s=2.5)   # 10 chunks
    sched.step()
    assert slow.slot in sched.prefilling
    owned = list(eng.cache._owned[slow.slot])
    clock.t += 1.0
    _drain(sched, clock)
    assert slow.finish_reason == "timeout" and slow.tokens == []
    assert slow.prefill_chunks == 3 and slow.blocks_reserved == len(owned)
    assert runner.finish_reason == "length" and len(runner.tokens) == 6
    assert _all_free(eng)


def test_deadline_none_is_unchanged_and_validation(models):
    _, _, tm = models
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(0, V, n)] for n in (3, 7, 5)]
    out = {}
    for deadline in (None, 1e9):
        clock = FakeClock()
        sched = ContinuousBatchingScheduler(_engine(tm), clock=clock)
        reqs = [sched.submit(p, 5, deadline_s=deadline) for p in prompts]
        _drain(sched, clock)
        out[deadline] = [(r.tokens, r.finish_reason) for r in reqs]
    assert out[None] == out[1e9]
    with pytest.raises(ValueError, match="deadline_s"):
        sched.submit([1, 2], 2, deadline_s=-1.0)


# ---------------------------------------------------------------------------
# against the JAX scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ORDERS)
def test_policy_matches_jax_scheduler(models, order):
    """The same submissions under the same fake clock: the same finish
    reasons, tokens and admission order as the JAX scheduler, shedding
    and deadlines included."""
    jm, vs, tm = models
    rng = np.random.RandomState(1)
    subs = [([int(t) for t in rng.randint(0, V, n)], m, d, p)
            for n, m, d, p in ((4, 9, None, 0), (6, 2, None, 1),
                               (3, 5, 6.5, 2), (5, 3, None, 0),
                               (2, 8, 1.5, 1), (7, 4, None, 3),
                               (3, 6, 40.0, 0), (4, 12, 5.0, 0))]
    out = {}
    for side in ("jax", "port"):
        clock = FakeClock()
        if side == "jax":
            eng = JDecodeEngine(jm, vs, max_slots=2, block_size=BS,
                                attention="xla")
            jc = eng.cache
            jc.device_tables = lambda jc=jc: (
                jnp.array(np.copy(jc.tables)), jnp.array(np.copy(jc.lengths)))
            sched = JScheduler(eng, order=order, shed=True, est_tick_s=0.1,
                               clock=clock)
        else:
            sched = ContinuousBatchingScheduler(
                _engine(tm), order=order, shed=True, est_tick_s=0.1,
                clock=clock)
        reqs = [sched.submit(p, m, deadline_s=d, priority=q)
                for p, m, d, q in subs]
        _drain(sched, clock)
        out[side] = ([(r.finish_reason, r.tokens, r.first_token_ts)
                      for r in reqs], [r.rid for r in sched.completed],
                     sched.est_tick_s)
    assert out["port"] == out["jax"]
    assert {r[0] for r in out["port"][0]} == {"length", "timeout", "shed"}


def _jax_engine(jm, vs, **kw):
    eng = JDecodeEngine(jm, vs, max_slots=2, block_size=BS,
                        attention="xla", **kw)
    jc = eng.cache
    jc.device_tables = lambda jc=jc: (
        jnp.array(np.copy(jc.tables)), jnp.array(np.copy(jc.lengths)))
    return eng


@pytest.mark.parametrize("role", ["both", "prefill", "decode"])
def test_load_report_matches_jax_scheduler(models, role):
    """The payload a replica publishes, dict for dict with the JAX
    scheduler's after the same submissions and after each step, for each
    role. A decode replica admits no prompts: each side's prefill replica
    hands its own requests off and the decode replica adopts them."""
    jm, vs, tm = models
    rng = np.random.RandomState(3)
    subs = [([int(t) for t in rng.randint(0, V, n)], m)
            for n, m in ((5, 4), (3, 6), (7, 2), (4, 5))]
    reports = {}
    for side in ("jax", "port"):
        if side == "jax":
            make = lambda r: JScheduler(  # noqa: E731
                _jax_engine(jm, vs, prefill_chunk=2), role=r)
        else:
            make = lambda r: ContinuousBatchingScheduler(  # noqa: E731
                _engine(tm, prefill_chunk=2), role=r)
        sched = make(role)
        feed = make("prefill") if role == "decode" else sched
        for p, m in subs:
            feed.submit(p, m)
        got = [sched.load_report()]
        for _ in range(8):
            if feed is not sched:
                feed.step()
                for _, meta, kpages, vpages in feed.pop_handoffs():
                    sched.adopt(meta, kpages, vpages)
            got.append(sched.load_report())
            sched.step()
            got.append(sched.load_report())
        reports[side] = got
    assert reports["port"] == reports["jax"]
    assert all(r["role"] == role for r in reports["port"])
    # the run did work: requests prefilled or decoded, and finished
    busy = "prefilling" if role == "prefill" else "running"
    assert any(r[busy] for r in reports["port"])
    assert reports["port"][-1]["pending_new_tokens"] < \
        max(r["pending_new_tokens"] for r in reports["port"])


# ---------------------------------------------------------------------------
# the programs' bodies on their static buffers
# ---------------------------------------------------------------------------

def _oracle(tm, prompt, n):
    """Greedy decode token by token through the model's own forward."""
    seq, out = list(prompt), []
    with torch.no_grad():
        for _ in range(n):
            tok = int(torch.argmax(tm(torch.tensor([seq]))[0, -1]))
            out.append(tok)
            seq.append(tok)
    return out


@pytest.mark.parametrize("kw", [{}, {"speculative": 3},
                                {"prefill_chunk": 3, "kv_dtype": "int8"}])
def test_static_buffers_give_greedy_streams_under_churn(models, kw):
    _, _, tm = models
    rng = np.random.RandomState(2)
    pre = [int(t) for t in rng.randint(0, V, 2 * BS)]
    prompts = [[int(t) for t in rng.randint(0, V, n)]
               for n in (5, 11, 3, 9)] + [pre + [1, 2], pre + [3]]
    new = [6, 3, 8, 5, 4, 7]
    eng = _engine(tm, max_slots=2, **kw)
    bufs = [t.data_ptr() for t in (*eng.cache.mirror(),
                                   *eng._prefill.inputs.dev.values(),
                                   *eng._tick.inputs.dev.values())]
    sched = ContinuousBatchingScheduler(eng)
    reqs = [sched.submit(p, m) for p, m in zip(prompts, new)]
    sched.run()
    assert eng.compile_counts() == {"prefill": 1, "tick": 1}
    assert [t.data_ptr() for t in (*eng.cache.mirror(),
                                   *eng._prefill.inputs.dev.values(),
                                   *eng._tick.inputs.dev.values())] == bufs
    assert _all_free(eng)
    if kw.get("kv_dtype") == "int8":
        # int8 pools drift from the f32 forward: the paged path against
        # the gather path over the same pools
        xla = ContinuousBatchingScheduler(_engine(tm, max_slots=2,
                                                  attention="xla", **kw))
        want = [xla.submit(p, m) for p, m in zip(prompts, new)]
        xla.run()
        assert [r.tokens for r in reqs] == [r.tokens for r in want]
    else:
        for p, m, r in zip(prompts, new, reqs):
            assert r.tokens == _oracle(tm, p, m)


@pytest.mark.parametrize("was_on", [True, False])
def test_capture_holds_garbage_collection_off(was_on):
    """``graphs._no_gc`` (around ``Program._capture``'s capture): the
    collector is off inside, and comes back as it was, also when the
    block raises."""
    import gc
    from paddle_tpu_torch.serve import graphs
    before = gc.isenabled()
    try:
        (gc.enable if was_on else gc.disable)()
        with graphs._no_gc():
            assert not gc.isenabled()
        assert gc.isenabled() == was_on
        with pytest.raises(RuntimeError):
            with graphs._no_gc():
                raise RuntimeError("capture failed")
        assert gc.isenabled() == was_on
    finally:
        (gc.enable if before else gc.disable)()
