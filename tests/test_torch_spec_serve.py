"""The port's span serving (f32, CPU): greedy tokens against the JAX engine
on bridged weights under admit/evict churn with ``speculative=3`` and with
``prefill_chunk=6`` (prefix sharing and an exact-duplicate prompt), the
speculative engine's stream equal to the plain engine's in fewer ticks,
chunked prefill interleaving a long admission with running slots' tokens,
and the capacity clamp and eos/length semantics under speculation.

The JAX engine gets copies of its tables and lengths each tick: its tick
may read ``cache.lengths`` after the host bumps them (ROADMAP, Queue 3).
Token comparisons are exact; each engine is deterministic on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.serve import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serve import DecodeEngine as JDecodeEngine
from paddle_tpu_torch import (ContinuousBatchingScheduler, DecodeEngine,
                              TransformerLM, load_jax_params)

V, W, DIM, LAYERS, HEADS, FFN = 64, 32, 32, 2, 4, 64
BS = 4


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
    kw.setdefault("max_slots", 3)
    return DecodeEngine(tm, block_size=BS, device="cpu", **kw)


def _jax_tokens(jm, vs, prompts, new, **kw):
    jeng = JDecodeEngine(jm, vs, max_slots=3, block_size=BS, **kw)
    jc = jeng.cache
    jc.device_tables = lambda: (jnp.array(np.copy(jc.tables)),
                                jnp.array(np.copy(jc.lengths)))
    js = JScheduler(jeng)
    reqs = [js.submit(list(p), m) for p, m in zip(prompts, new)]
    js.run()
    return [r.tokens for r in reqs]


def _run(eng, prompts, new):
    s = ContinuousBatchingScheduler(eng)
    reqs = [s.submit(list(p), m) for p, m in zip(prompts, new)]
    s.run()
    return [r.tokens for r in reqs], reqs


def _free_once(eng):
    pool = list(eng.cache.allocator._free) + \
        list(eng.cache.allocator._retained)
    return (len(pool) == len(set(pool)) == eng.cache.num_blocks - 1
            and not eng.cache.allocator._rc)


def test_speculative_tokens_match_jax_engine_under_churn(models):
    jm, vs, tm = models
    rng = np.random.RandomState(0)
    period = [int(t) for t in rng.randint(0, V, 3)]
    prompts = [[int(t) for t in rng.randint(0, V, n)] for n in (5, 11, 3)]
    prompts += [period * 4, period * 3 + [period[0]]]   # drafts that hit
    new = [6, 9, 4, 8, 7]
    want = _jax_tokens(jm, vs, prompts, new, attention="xla",
                       speculative=3)
    for impl in ("paged", "xla"):
        eng = _engine(tm, attention=impl, speculative=3)
        got, _ = _run(eng, prompts, new)
        assert got == want, impl
        assert eng.draft_proposed > 0 and _free_once(eng)


def test_chunked_prefill_with_sharing_matches_jax_engine(models):
    """Chunks of 6 over prompts that share a prefix, and two exact
    duplicates of a resident prompt: the second duplicate re-attends only
    its last position (writes masked) and forks the shared boundary block
    at its first decode write."""
    jm, vs, tm = models
    rng = np.random.RandomState(1)
    pre = [int(t) for t in rng.randint(0, V, 2 * BS)]
    donor = pre + [int(t) for t in rng.randint(0, V, 3)]
    prompts = [donor, [int(t) for t in rng.randint(0, V, 14)],
               pre + [9, 9], list(donor), list(donor)]
    new = [8, 5, 6, 4, 4]
    want = _jax_tokens(jm, vs, prompts, new, attention="xla",
                       prefill_chunk=6)
    eng = _engine(tm, prefill_chunk=6)
    got, reqs = _run(eng, prompts, new)
    assert got == want
    assert got[3] == got[4] == want[0][:4]
    assert eng.cache.prefix_hit_blocks >= 4 and eng.cache.cow_forks >= 1
    assert reqs[1].prefill_chunks == 3                  # ceil(14 / 6)
    assert reqs[3].prefill_chunks == 1                  # the last position
    assert _free_once(eng)


def test_speculative_equals_plain_engine_in_fewer_ticks(models):
    _, _, tm = models
    rng = np.random.RandomState(2)
    period = [int(t) for t in rng.randint(0, V, 4)]
    prompts = [period * 3, [int(t) for t in rng.randint(0, V, 6)],
               period * 2 + period[:2],
               [int(t) for t in rng.randint(0, V, 3)]]
    new = [12, 9, 10, 7]
    runs = {}
    for k in (0, 4):
        for chunk in (None, 5):
            eng = _engine(tm, speculative=k, prefill_chunk=chunk)
            runs[k, chunk] = (_run(eng, prompts, new)[0], eng)
    base = runs[0, None][0]
    assert all(toks == base for toks, _ in runs.values())
    spec = runs[4, None][1]
    assert spec.ticks < runs[0, None][1].ticks
    assert 0 < spec.draft_accepted <= spec.draft_proposed


def test_chunked_prefill_interleaves_with_running_slots(models):
    """The long-admission leg: a running request keeps getting tokens while
    a long prompt prefills chunk by chunk, and both streams equal the
    one-shot engine's."""
    _, _, tm = models
    rng = np.random.RandomState(3)
    short_prompt = [int(t) for t in rng.randint(0, V, 3)]
    long_prompt = [int(t) for t in rng.randint(0, V, 18)]
    out = {}
    for chunk in (4, None):
        eng = _engine(tm, max_slots=2, prefill_chunk=chunk)
        s = ContinuousBatchingScheduler(eng)
        short = s.submit(list(short_prompt), 12)
        for _ in range(2):
            s.step()
        before = len(short.tokens)
        long_req = s.submit(list(long_prompt), 3)
        while long_req.first_token_ts is None and s.step():
            pass
        interleaved = len(short.tokens) - before
        s.run()
        out[chunk] = (short.tokens, long_req, interleaved, eng)
    assert out[4][0] == out[None][0]
    assert out[4][1].tokens == out[None][1].tokens
    assert out[4][2] > out[None][2]                     # decode kept going
    assert out[4][1].prefill_chunks == 5                # ceil(18 / 4)
    assert out[4][3].prefill_chunks > out[None][3].prefill_chunks


def test_speculative_capacity_clamp_eos_and_length(models):
    _, _, tm = models
    rng = np.random.RandomState(4)
    # a reservation of 3 + 4 - 1 tokens clamps the span of 5 at its end
    eng = _engine(tm, max_slots=2, speculative=4)
    s = ContinuousBatchingScheduler(eng)
    req = s.submit([int(t) for t in rng.randint(0, V, 3)], 4)
    s.run()
    assert req.finish_reason == "length" and len(req.tokens) == 4
    assert _free_once(eng)
    # an eos inside an accepted window stops where the plain engine stops
    prompt = [int(t) for t in rng.randint(0, V, 5)] * 2
    plain, _ = _run(_engine(tm, max_slots=1), [prompt], [12])
    eos = plain[0][4]
    expect = plain[0][:plain[0].index(eos) + 1]
    assert len(expect) < 12
    for k in (0, 3):
        e = _engine(tm, max_slots=1, speculative=k)
        s = ContinuousBatchingScheduler(e)
        r = s.submit(list(prompt), 12, eos_id=eos)
        s.run()
        assert r.finish_reason == "eos" and r.tokens == expect, k
        assert _free_once(e)
    # length: a window that would overshoot max_new_tokens is cut there
    for m in (1, 2, 5):
        e = _engine(tm, max_slots=1, speculative=4)
        got, reqs = _run(e, [prompt], [m])
        assert got[0] == plain[0][:m] and reqs[0].finish_reason == "length"
