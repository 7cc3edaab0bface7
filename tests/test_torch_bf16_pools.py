"""Serving from bf16 KV pools (CPU): the port's ``DecodeEngine(dtype=
torch.bfloat16)`` against the JAX package's ``DecodeEngine(dtype=
jnp.bfloat16)`` on bridged weights, at the toy width of
``tests/test_torch_serve.py`` (vocab 64, dim 32, 2 layers, 4 heads of
8, block 4):

- under admit/evict churn with a shared-prefix pair, with
  ``speculative=2`` and with ``prefill_chunk=4``; the port's ``"paged"``
  path (the paged kernels' plain versions) against JAX's ``"paged"``
  (Pallas interpret mode), and ``"xla"`` against ``"xla"``; under
  ``float32`` and under ``bfloat16_compute``. Every call of the two
  engines' models is recorded (the logits each token came from), and the
  two runs are compared call by call: the logits within LOGIT_BOUND, the
  greedy tokens equal wherever JAX's top-2 gap exceeds 2 * LOGIT_BOUND;
  at the first token that differs at a smaller gap the two streams may
  part, and the comparison stops there;
- after a run without a near tie, the pools (below);
- the pool's dtype, ``quant_dtype``, ``kv_bytes_per_token`` and
  ``bytes_per_block`` against JAX's cache (256 bytes a token here,
  12,288 at the ``transformer_decode`` geometry: half of f32's), and the
  refusal of other pool dtypes;
- the ``"xla"`` path's ``_sdpa_row`` over a bf16 pool under ``float32``
  against JAX's: f32 q against K promoted to f32, f32 weights against V
  promoted to f32 (1e-6: f32 on both sides, other summation orders).

Tolerances, each a few times what was measured over every case.
LOGIT_BOUND on ``"xla"``, 1e-3 (measured at most 1.04e-4): both sides run
the same function on pools that agree but for entries one bf16 ulp apart
(below). On ``"paged"``, 5e-2 (measured at most 1.54e-2, under
``bfloat16_compute``; 3.8e-3 under ``float32``): JAX's kernel rounds p to
bf16 against a running max over each 4-key block, the plain version
against the row's max (the card's kernel does as the plain version), so
each weight of the first layer moves by up to 2^-9 of itself, and the
next layers and the readout carry that. Pools: the first layer's pools
(and every layer's on ``"xla"``) within one bf16 ulp of JAX's, with at
most 1% of the entries off (measured: one ulp, at most 0.03%): the two
sides' f32 projections lie an f32 ulp or so apart and round to bf16 on
either side of a midpoint only where they lie that close to it. On
``"paged"`` a later layer's projections carry the first layer's rounding
difference: its pools within POOL_PAGED_ULPS bf16 ulps of the layer's
largest entry (measured 1.0).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.core import dtypes as jdt
from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.nn.attention import MultiHeadAttention as JMHA
from paddle_tpu.serve import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serve import DecodeEngine as JDecodeEngine
from paddle_tpu.serve.kv_cache import PagedKVCache as JPagedKVCache
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn.attention import MultiHeadAttention
from paddle_tpu_torch.serve import PagedKVCache

V, W, DIM, LAYERS, HEADS, FFN = 64, 32, 32, 2, 4, 64
BS = 4
LOGIT_BOUND = {"xla": 1e-3, "paged": 5e-2}
POOL_ULP_SHARE = 0.01
POOL_PAGED_ULPS = 2
POLICIES = {"float32": (pt.float32, jdt.float32),
            "bfloat16_compute": (pt.bfloat16_compute, jdt.bfloat16_compute)}


@pytest.fixture(scope="module")
def models():
    jm = JTransformerLM(vocab=V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                        ffn_hidden=FFN, max_len=W, use_flash=True)
    vs = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, W), jnp.int32))
    tm = pt.TransformerLM(V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                          ffn_hidden=FFN, max_len=W, use_flash=True,
                          device="cpu")
    pt.load_jax_params(tm, vs)
    return jm, vs, tm


KINDS = ("prefill", "decode_step", "decode_span")


def _live(kind, logits, extra):
    """The rows of a model call a token may come from: decode_step's
    active slots ``extra = (active,)``, decode_span's live rows ``extra =
    (n, active)``; None for a prefill (its row is the prompt's last)."""
    if kind == "decode_step":
        return np.asarray(extra[0]).astype(bool)
    if kind == "decode_span":
        n, active = np.asarray(extra[0]), np.asarray(extra[1]).astype(bool)
        return active[:, None] & (np.arange(logits.shape[1])[None]
                                  < n[:, None])
    return None


def _extra(kind, args):
    """The positional arguments (after the ids and the pools) that say
    which rows are live: the same places in both packages' methods."""
    return {"prefill": (), "decode_step": args[3:4],
            "decode_span": args[3:5]}[kind]


def _record_jax(jm, calls):
    """Record each call of ``jm``'s serving methods inside the JAX
    engine's compiled programs as (kind, logits, live rows)."""
    apply = jm.apply

    def sink(kind, logits, *extra):
        logits = np.asarray(logits, np.float32)
        calls.append((kind, logits, _live(kind, logits, extra)))

    def wrapped(variables, *args, method=None, **kw):
        out = apply(variables, *args, method=method, **kw)
        if method in KINDS:
            jax.debug.callback(lambda *a, _k=method: sink(_k, *a), out[0],
                               *_extra(method, args), ordered=True)
        return out

    jm.apply = wrapped


def _record_port(tm, calls):
    """Record each call of the port model's serving methods (the engine's
    programs' bodies, run eagerly on the CPU)."""
    for kind in KINDS:
        fn = getattr(tm, kind)

        def wrapped(*args, _fn=fn, _kind=kind, **kw):
            out = _fn(*args, **kw)
            logits = out[0].float().numpy()
            extra = [np.asarray(a) for a in _extra(_kind, args)]
            calls.append((_kind, logits, _live(_kind, logits, extra)))
            return out

        tm.__dict__[kind] = wrapped


def _serve_jax(jm, vs, prompts, new, pol, **kw):
    calls = []
    _record_jax(jm, calls)
    try:
        with jdt.use_policy(pol):
            jeng = JDecodeEngine(jm, vs, max_slots=3, block_size=BS,
                                 dtype=jnp.bfloat16, **kw)
            # copies: the JAX engine bumps the lengths in place while a
            # CPU tick may still alias them (tests/test_torch_serve.py)
            jc = jeng.cache
            jc.device_tables = lambda: (jnp.array(np.copy(jc.tables)),
                                        jnp.array(np.copy(jc.lengths)))
            js = JScheduler(jeng)
            reqs = [js.submit(list(p), new) for p in prompts]
            js.run()
            jax.effects_barrier()
    finally:
        del jm.apply
    return [r.tokens for r in reqs], calls, jeng


def _serve_port(tm, prompts, new, pol, **kw):
    calls = []
    _record_port(tm, calls)
    try:
        eng = pt.DecodeEngine(tm, max_slots=3, block_size=BS, device="cpu",
                              dtype=torch.bfloat16, **kw)
        ts = pt.ContinuousBatchingScheduler(eng)
        reqs = [ts.submit(list(p), new) for p in prompts]
        with pt.use_policy(pol):
            ts.run()
    finally:
        for kind in KINDS:
            tm.__dict__.pop(kind)
    return [r.tokens for r in reqs], calls, eng


def _lockstep(jcalls, tcalls, prompts, bound):
    """Compare the two runs call by call: logits within ``bound`` on the
    live rows, tokens equal where JAX's top-2 gap exceeds twice it.
    Returns (largest logit difference, whether the streams parted)."""
    worst, prefills = 0.0, iter(prompts)     # FCFS: prefills in order
    for (kind, lj, live), (tkind, lt, tlive) in zip(jcalls, tcalls):
        assert kind == tkind
        if kind == "prefill":
            row = len(next(prefills)) - 1
            lj, lt = lj[0, row][None], lt[0, row][None]
        else:
            np.testing.assert_array_equal(live, tlive)
            lj, lt = lj[live], lt[live]
        if not len(lj):
            continue
        differ = np.argmax(lj, -1) != np.argmax(lt, -1)
        if differ.any():
            top2 = np.sort(lj[differ], -1)[:, -2:]
            gap = (top2[:, 1] - top2[:, 0]).max()
            assert gap <= 2 * bound, \
                f"{kind}: a token differs at a top-2 gap of {gap}"
            return worst, True
        worst = max(worst, float(np.abs(lj - lt).max()))
        assert worst <= bound, f"{kind}: logits differ by {worst}"
    assert len(jcalls) == len(tcalls)
    return worst, False


def _pools_close(jeng, eng, attention):
    """The non-null pool blocks against JAX's: a layer whose projections
    saw the same inputs on both sides (the first; every layer on "xla")
    within one bf16 ulp of each entry, at most POOL_ULP_SHARE of the
    entries off; a later layer on "paged" within POOL_PAGED_ULPS ulps of
    its largest entry."""
    for jp, tp in ((jeng.cache.k, eng.cache.k), (jeng.cache.v, eng.cache.v)):
        assert tp.dtype == torch.bfloat16 and jp.dtype == jnp.bfloat16
        for layer in range(tp.shape[0]):
            j = np.asarray(jp[layer].astype(jnp.float32))[1:]
            t = tp[layer].float().numpy()[1:]
            d = np.abs(t - j)
            if layer == 0 or attention == "xla":
                ulp = np.ldexp(1.0, np.frexp(np.abs(j))[1] - 8)
                assert (d <= ulp).all(), f"layer {layer}: {d.max()} apart"
                assert (d > 0).mean() <= POOL_ULP_SHARE
            else:
                top = np.ldexp(1.0, np.frexp(np.abs(j).max())[1] - 8)
                assert d.max() <= POOL_PAGED_ULPS * top, \
                    f"layer {layer}: {d.max()} apart"


def _prompts(seed):
    rng = np.random.RandomState(seed)
    pre = [int(t) for t in rng.randint(0, V, 2 * BS)]
    prompts = [[int(t) for t in rng.randint(0, V, n)]
               for n in (5, 11, 3, 9)]
    # a shared-prefix pair, the first admitted first, so that its blocks
    # are registered (a chunked prefill's at its last chunk) before the
    # second one's admission
    return [pre + [1, 2, 3]] + prompts + [pre + [4]]


CASES = {"churn": {}, "speculative=2": {"speculative": 2},
         "prefill_chunk=4": {"prefill_chunk": 4}}


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("attention", ["paged", "xla"])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_pool_engine_matches_jax(models, case, attention, policy):
    jm, vs, tm = models
    tpol, jpol = POLICIES[policy]
    prompts, new = _prompts(len(case)), 6
    kw = dict(attention=attention, **CASES[case])
    jtok, jcalls, jeng = _serve_jax(jm, vs, prompts, new, jpol, **kw)
    ttok, tcalls, eng = _serve_port(tm, prompts, new, tpol, **kw)
    _, parted = _lockstep(jcalls, tcalls, prompts, LOGIT_BOUND[attention])
    assert eng.cache.prefix_hit_blocks >= 2           # the pair shared
    if not parted:
        assert ttok == jtok
        _pools_close(jeng, eng, attention)


def test_bf16_pool_accounting_matches_jax():
    """256 bytes a token at the toy width, 12,288 at the transformer_decode
    geometry (6 layers, 8 heads of 64: half of f32's 24,576)."""
    for geom, per_token in (((LAYERS, HEADS, DIM // HEADS), 256),
                            ((6, 8, 64), 12288)):
        L, H, hd = geom
        kw = dict(num_layers=L, num_heads=H, head_dim=hd, num_blocks=3,
                  block_size=16, max_slots=1, max_blocks_per_seq=2)
        t = PagedKVCache(**kw, dtype=torch.bfloat16, device="cpu")
        j = JPagedKVCache(**kw, dtype=jnp.bfloat16)
        f = PagedKVCache(**kw, device="cpu")
        assert t.k.dtype == t.v.dtype == torch.bfloat16
        assert t.k.shape == (L, 3, 16, H, hd)
        assert t.kv_bytes_per_token == j.kv_bytes_per_token == per_token
        assert 2 * t.kv_bytes_per_token == f.kv_bytes_per_token
        assert t.bytes_per_block == j.bytes_per_block == 16 * per_token
        assert t.quant_dtype == j.quant_dtype == "bfloat16"
    kw = dict(num_layers=1, num_heads=1, head_dim=8, num_blocks=2,
              block_size=4, max_slots=1, max_blocks_per_seq=1)
    for bad in (torch.float16, torch.int8, torch.float64):
        with pytest.raises(ValueError, match="pool dtype"):
            PagedKVCache(**kw, dtype=bad, device="cpu")
    # int8 pools ignore dtype, as in JAX
    q = PagedKVCache(**kw, dtype=torch.float16, kv_dtype="int8",
                     device="cpu")
    assert q.quant_dtype == "int8"


def test_sdpa_row_over_a_bf16_pool_matches_jax():
    """The "xla" row over a bf16 pool under float32: the logits are f32 q
    against K widened to f32 and the f32 weights meet V widened to f32,
    as jnp promotes them (the port rounded the weights to bf16, and its
    q . K einsum refused the mixed dtypes)."""
    rng = np.random.RandomState(0)
    S, Wc, H, hd = 3, 12, 4, 8
    q = rng.randn(S, H, hd).astype(np.float32)
    kg = rng.randn(S, Wc, H, hd).astype(np.float32)
    vg = rng.randn(S, Wc, H, hd).astype(np.float32)
    eff = np.array([0, 5, 12], np.int32)
    jk = jnp.asarray(kg, jnp.bfloat16)
    jv = jnp.asarray(vg, jnp.bfloat16)
    want = np.asarray(JMHA._sdpa_row(jnp.asarray(q)[:, None], jk, jv,
                                     jnp.asarray(eff), jdt.float32, hd))
    tk = torch.from_numpy(np.array(jk.astype(jnp.float32))).bfloat16()
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).bfloat16()
    with pt.use_policy(pt.float32):
        got = MultiHeadAttention._sdpa_row(torch.from_numpy(q), tk, tv,
                                           torch.from_numpy(eff), hd)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[:, 0], atol=1e-6, rtol=0)
