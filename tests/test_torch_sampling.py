"""The port's seeded sampling (f32, CPU) against the JAX package's: the
threefry-2x32 keys and uniform bits bit for bit, the temperature / top-k /
top-p filter, the categorical draws, the engine's validation, top_k=1
against greedy, seeded replay across engines warmed and not, and the
sampled engine against the JAX engine on bridged weights (plain tick,
chunked prefill, stochastic ``speculative=4``).

The rule for draws: the port computes the same uniforms as JAX, but
``log`` (in the Gumbel noise) and the f32 logits of the two forwards may
differ in the last bits. So a token stream must equal the JAX engine's,
or its first difference must sit at a decision whose margin is under
``MARGIN`` = 1e-4: the top-2 gap of the Gumbel-perturbed filtered logits
for a draw, ``|u - p(draft)|`` for an accept coin.

The filter's top-p cut compares an f32 cumulative sum with ``p``; the two
sides' ``exp`` and summation orders differ in the last bits, so an entry
whose preceding mass lies within ``BOUNDARY`` = 1e-5 of ``p`` may fall on
either side of the cut (with ``top_p=1.0`` the tail of tiny probabilities
does). Every other entry is kept or dropped on both sides alike.

The JAX engine gets copies of its tables and lengths each tick: its tick
may read ``cache.lengths`` after the host bumps them (ROADMAP, Queue 3)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.serve import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serve import DecodeEngine as JDecodeEngine
from paddle_tpu.serve import SamplingConfig as JSamplingConfig
from paddle_tpu.serve.engine import _filter_logits as j_filter_logits
from paddle_tpu.serve.engine import _sample_tokens as j_sample_tokens
from paddle_tpu_torch import (ContinuousBatchingScheduler, DecodeEngine,
                              SamplingConfig, TransformerLM, load_jax_params)
from paddle_tpu_torch.serve import sampling as sp

V, W, DIM, LAYERS, HEADS, FFN = 64, 32, 32, 2, 4, 64
BS = 4
MARGIN = 1e-4
FILTER_ATOL = 1e-6
BOUNDARY = 1e-5


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


def _key(k):
    """A JAX key array as the port's pair of Python ints."""
    a = np.asarray(k).astype(np.int64)
    return int(a[0]), int(a[1])


def _keys(ks):
    """A batch of JAX keys ``[..., 2]`` as the port's pair of tensors."""
    a = torch.from_numpy(np.asarray(ks).astype(np.int64))
    return a[..., 0], a[..., 1]


# ---------------------------------------------------------------------------
# threefry-2x32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 3, 11, -7, 2 ** 31 - 1])
def test_keys_and_uniform_bits_equal_jax(seed):
    assert sp.prng_key(seed) == _key(jax.random.PRNGKey(seed))
    for tick in (0, 1, 2, 17, 1000, 2 ** 31 - 1):
        jt = jax.random.fold_in(jax.random.PRNGKey(seed), tick)
        assert sp.fold_in(sp.prng_key(seed), tick) == _key(jt)
        # the tick's per-slot keys, from a counter tensor
        jks = jax.vmap(lambda s: jax.random.fold_in(jt, s))(jnp.arange(8))
        k0, k1 = sp.tick_keys(seed, torch.tensor([tick], dtype=torch.int32),
                              8)
        want = np.asarray(jks).astype(np.int64)
        np.testing.assert_array_equal(k0.numpy(), want[:, 0])
        np.testing.assert_array_equal(k1.numpy(), want[:, 1])
        # the bits, and the uniforms made from them, of each slot's key
        bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (300,)))(
            jks)).astype(np.int64)
        np.testing.assert_array_equal(
            sp.random_bits((k0, k1), 300, "cpu").numpy(), bits)
        u = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (300,)))(
            jks))
        np.testing.assert_array_equal(sp.uniform((k0, k1), 300).numpy(), u)
        u0 = np.asarray(jax.vmap(jax.random.uniform)(jks))
        np.testing.assert_array_equal(sp.uniform((k0, k1)).numpy(), u0)
        tiny = float(jnp.finfo(jnp.float32).tiny)
        ut = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (300,), minval=tiny))(jks))
        np.testing.assert_array_equal(
            sp.uniform((k0, k1), 300, minval=tiny).numpy(), ut)


def test_gumbel_within_ulps_of_jax():
    ks = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(5), s))(
        jnp.arange(16))
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (512,)))(ks))
    got = sp.gumbel(_keys(ks), 512, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=4e-7)


# ---------------------------------------------------------------------------
# the filter and the draws
# ---------------------------------------------------------------------------

def _tied_logits(seed, shape):
    """Random logits on a grid of 1/4, so equal values (ties at the top-k
    and top-p cut-offs) are common."""
    rng = np.random.RandomState(seed)
    return (np.round(rng.randn(*shape) * 8) / 4).astype(np.float32)


FILTERS = [(t, k, p) for t in (1.0, 0.7, 1.5) for k in (None, 1, 5, 50)
           for p in (None, 0.5, 0.9, 1.0)]


@pytest.mark.parametrize("temperature,top_k,top_p", FILTERS)
def test_filter_logits_equal_jax(temperature, top_k, top_p):
    x = _tied_logits(int(temperature * 10) + (top_k or 0), (6, 3, V))
    jcfg = JSamplingConfig(temperature=temperature, top_k=top_k,
                           top_p=top_p)
    cfg = SamplingConfig(temperature=temperature, top_k=top_k, top_p=top_p)
    want = np.asarray(j_filter_logits(jcfg, jnp.asarray(x)))
    got = sp.filter_logits(cfg, torch.from_numpy(x)).numpy()
    differ = np.isneginf(got) != np.isneginf(want)
    if differ.any():
        # only at the top-p cut, where the mass above the entry is p
        # within rounding (computed in f64 from the top-k survivors)
        assert top_p is not None and differ.sum() <= 2
        xk = np.asarray(j_filter_logits(JSamplingConfig(
            temperature=temperature, top_k=top_k), jnp.asarray(x)))
        for idx in np.argwhere(differ):
            row = xk[tuple(idx[:-1])].astype(np.float64)
            prob = np.exp(row - row.max())
            prob /= prob.sum()
            above = prob[row > row[idx[-1]]].sum()
            assert abs(above - top_p) < BOUNDARY, (idx, above)
    kept = ~np.isneginf(want) & ~differ
    assert kept.any(-1).all()                     # the head survives
    np.testing.assert_allclose(got[kept], want[kept], rtol=0,
                               atol=FILTER_ATOL)


def _pair(key):
    """A key of Python ints as a batch of one."""
    return torch.tensor([key[0]]), torch.tensor([key[1]])


def _draw_margin(cfg, logits_row, key):
    """Top-2 gap of the Gumbel-perturbed filtered logits of one draw."""
    g = sp.gumbel(_pair(key), logits_row.shape[-1], "cpu")[0]
    z = (g + sp.filter_logits(cfg, logits_row)).sort(descending=True).values
    return float(z[0] - z[1])


@pytest.mark.parametrize("top_k,top_p", [(None, None), (8, None),
                                         (None, 0.9), (16, 0.95)])
def test_sample_tokens_equal_jax_or_near_tie(top_k, top_p):
    rng = np.random.RandomState(1)
    x = (rng.randn(64, V) * 3).astype(np.float32)
    ks = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(9), s))(
        jnp.arange(64))
    jcfg = JSamplingConfig(temperature=0.8, top_k=top_k, top_p=top_p)
    cfg = SamplingConfig(temperature=0.8, top_k=top_k, top_p=top_p)
    want = np.asarray(j_sample_tokens(jcfg, jnp.asarray(x), ks))
    got = sp.sample_tokens(cfg, torch.from_numpy(x), _keys(ks)).numpy()
    for r in np.flatnonzero(got != want):
        assert _draw_margin(cfg, torch.from_numpy(x[r]),
                            _key(ks[r])) < MARGIN, r
    assert len(set(got.tolist())) > 8             # draws, not an argmax


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine(tm, **kw):
    kw.setdefault("max_slots", 3)
    return DecodeEngine(tm, block_size=BS, device="cpu", **kw)


def _serve(eng, prompts, new):
    s = ContinuousBatchingScheduler(eng)
    reqs = [s.submit(list(p), new) for p in prompts]
    s.run()
    return [r.tokens for r in reqs]


def test_validation_raises_as_jax(models):
    _, _, tm = models
    for bad in (SamplingConfig(temperature=0.0), SamplingConfig(top_k=0),
                SamplingConfig(top_k=V + 1), SamplingConfig(top_p=0.0),
                SamplingConfig(top_p=1.5)):
        with pytest.raises(ValueError):
            _engine(tm, sampling=bad)


def test_top_k_one_is_greedy(models):
    _, _, tm = models
    rng = np.random.RandomState(2)
    prompts = [[int(t) for t in rng.randint(0, V, n)] for n in (4, 9, 6)]
    for spec in (0, 4):
        greedy = _serve(_engine(tm, speculative=spec), prompts, 6)
        for seed in (11, 12):
            cfg = SamplingConfig(top_k=1, seed=seed)
            assert _serve(_engine(tm, sampling=cfg, speculative=spec),
                          prompts, 6) == greedy


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 4},
                                {"speculative": 4},
                                {"speculative": 3, "prefill_chunk": 5,
                                 "kv_dtype": "int8"}])
def test_seeded_replay_identical_warmed_or_not(models, kw):
    """A fixed seed replays the exact stream, with or without warmup()
    (warmup consumes no key), and another seed diverges; both programs
    are built once, whatever the churn."""
    _, _, tm = models
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(0, V, n)]
               for n in (4, 13, 6, 9, 3)]
    cfg = SamplingConfig(temperature=1.2, top_k=16, top_p=0.9, seed=3)
    warm = _engine(tm, sampling=cfg, **kw)
    report = warm.warmup()
    assert report["compile_counts"] == {"prefill": 1, "tick": 1}
    assert {"prefill_s", "tick_s", "wall_s", "autotune_trials",
            "xla_cache_hit"} <= set(report)
    assert report["autotune_trials"] is None
    a = _serve(warm, prompts, 8)
    cold = _engine(tm, sampling=cfg, **kw)
    assert cold.compile_counts() == {"prefill": 0, "tick": 0}
    b = _serve(cold, prompts, 8)
    c = _serve(_engine(tm, sampling=SamplingConfig(
        temperature=1.2, top_k=16, top_p=0.9, seed=4), **kw), prompts, 8)
    assert a == b
    assert a != c
    assert all(len(t) == 8 for t in a)
    assert warm.compile_counts() == cold.compile_counts() == {
        "prefill": 1, "tick": 1}


def test_stochastic_speculation_at_low_temperature_is_greedy(models):
    """At temperature -> 0 the rejection rule accepts exactly the drafts
    greedy verification accepts: the stream equals the greedy
    speculative engine's."""
    _, _, tm = models
    rng = np.random.RandomState(4)
    period = [int(t) for t in rng.randint(0, V, 3)]
    prompts = [period * 3, [int(t) for t in rng.randint(0, V, 5)]]
    greedy = _serve(_engine(tm, speculative=3), prompts, 8)
    cfg = SamplingConfig(temperature=1e-4, seed=7)
    assert _serve(_engine(tm, speculative=3, sampling=cfg), prompts,
                  8) == greedy


class _Recorder:
    """Records, per port model call, the logits and the counter the call's
    keys fold (the prefill counter, or the tick)."""

    def __init__(self, eng):
        self.calls = []
        model = eng.model
        for name in ("prefill", "decode_step", "decode_span"):
            fn = getattr(model, name)

            def wrapped(*a, _fn=fn, _name=name, **k):
                out = _fn(*a, **k)
                prog = eng._tick if _name == "decode_step" or (
                    _name == "decode_span"
                    and a[0].shape[0] == eng.max_slots
                    and eng.speculative) else eng._prefill
                counter = "tick" if prog is eng._tick else "counter"
                self.calls.append((prog.name, out[0].detach().clone(),
                                   int(prog.inputs.host[counter][0]),
                                   {n: v.copy() for n, v in
                                    prog.inputs.host.items()}))
                return out
            setattr(model, name, wrapped)
        self.model = model

    def close(self):
        for name in ("prefill", "decode_step", "decode_span"):
            delattr(self.model, name)


def _tick_margins(cfg, eng, logits, tick, inputs, slot):
    """The margins of the decisions that made ``slot``'s tokens in one
    tick: the draw of a plain tick; under speculation the accept coins of
    the walked drafts and the closing resample or bonus draw."""
    k0, k1 = sp.tick_keys(cfg.seed, torch.tensor([tick]), eng.max_slots)
    key = (int(k0[slot]), int(k1[slot]))
    if eng.speculative == 0:
        return [_draw_margin(cfg, logits[slot], key)]
    toks, n = inputs["tokens"][slot], int(inputs["n"][slot])
    x = sp.filter_logits(cfg, logits[slot])
    p = torch.softmax(x, -1)
    margins = []
    for j in range(n):
        rk = sp.fold_in(key, j)
        if j < n - 1:
            u = float(sp.uniform(_pair(sp.fold_in(rk, 0)))[0])
            pd = float(p[j, toks[j + 1]])
            margins.append(abs(u - pd))
            if u < pd:
                continue
            res_x = x[j].clone()
            res_x[toks[j + 1]] = float("-inf")
            g = sp.gumbel(_pair(sp.fold_in(rk, 1)), V, "cpu")[0]
            z = (g + res_x).sort(descending=True).values
            margins.append(float(z[0] - z[1]))
            return margins
        margins.append(_draw_margin(cfg, logits[slot, j],
                                    sp.fold_in(rk, 2)))
    return margins


def _lockstep(models, cfg_kw, prompts, new, **kw):
    """Serve ``prompts`` on the JAX and the port engine, one scheduler
    step at a time. Returns the port's token lists; at the first step
    whose tokens differ, asserts that the differing request's decisions in
    that step had a margin under MARGIN and stops."""
    jm, vs, tm = models
    jeng = JDecodeEngine(jm, vs, max_slots=3, block_size=BS,
                         attention="xla",
                         sampling=JSamplingConfig(**cfg_kw), **kw)
    jc = jeng.cache
    jc.device_tables = lambda: (jnp.array(np.copy(jc.tables)),
                                jnp.array(np.copy(jc.lengths)))
    js = JScheduler(jeng)
    cfg = SamplingConfig(**cfg_kw)
    eng = _engine(tm, sampling=cfg, **kw)
    ts = ContinuousBatchingScheduler(eng)
    jreqs = [js.submit(list(p), new) for p in prompts]
    treqs = [ts.submit(list(p), new) for p in prompts]
    rec = _Recorder(eng)
    try:
        while True:
            rec.calls.clear()
            busy = ts.step()
            js.step()
            for jr, tr in zip(jreqs, treqs):
                if jr.tokens == tr.tokens:
                    continue
                i = next((i for i, (a, b) in enumerate(
                    zip(jr.tokens, tr.tokens)) if a != b),
                    min(len(jr.tokens), len(tr.tokens)))
                if i == 0:         # the prefill's draw
                    _, lg, ctr, host = [c for c in rec.calls
                                        if c[0] == "prefill"][-1]
                    last = (int(host["n"][0]) if "n" in host
                            else int(host["length"][0])) - 1
                    margins = [_draw_margin(cfg, lg[0, last],
                                            sp.fold_in(sp.prng_key(
                                                cfg.seed), ctr))]
                else:
                    _, lg, tick, host = [c for c in rec.calls
                                         if c[0] == "tick"][-1]
                    margins = _tick_margins(cfg, eng, lg, tick, host,
                                            tr.slot)
                assert min(margins) < MARGIN, (
                    f"request {tr.rid} differs from the JAX engine at "
                    f"token {i} with decision margins {margins}")
                return [r.tokens for r in treqs]
            if not busy:
                break
    finally:
        rec.close()
    assert not js.step()
    assert [r.tokens for r in jreqs] == [r.tokens for r in treqs]
    assert all(len(r.tokens) == new for r in treqs)
    return [r.tokens for r in treqs]


CFG = {"temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 5}


@pytest.mark.parametrize("kw", [{}, {"prefill_chunk": 4},
                                {"speculative": 4}],
                         ids=["plain", "chunked", "speculative4"])
def test_sampled_engine_matches_jax_engine(models, kw):
    rng = np.random.RandomState(6)
    period = [int(t) for t in rng.randint(0, V, 3)]
    prompts = [[int(t) for t in rng.randint(0, V, n)] for n in (5, 11, 3)]
    prompts += [period * 4, period * 3 + [period[0]]]
    got = _lockstep(models, CFG, prompts, 8, **kw)
    assert len({t for toks in got for t in toks}) > 8


def test_sampled_engine_matches_jax_engine_at_temperature_one(models):
    """No filter and the raw temperature: the rejection rule accepts and
    rejects drafts both, on the periodic prompts."""
    rng = np.random.RandomState(8)
    period = [int(t) for t in rng.randint(0, V, 2)]
    prompts = [period * 5, [int(t) for t in rng.randint(0, V, 7)]]
    _lockstep(models, {"seed": 2}, prompts, 10, speculative=4)
