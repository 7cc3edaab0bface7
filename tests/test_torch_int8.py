"""The port's int8 KV pools (f32 compute, CPU) against the JAX package:
``quantize_rows`` bit-equal, the quant-aware scatters leaving the same
pools, the dequantizing gather, the int8 branch of the paged decode and
paged span kernels' plain versions against the JAX kernels (Pallas
interpret mode) and their oracles, the capacity accounting, and the int8
engine's tokens against the JAX int8 engine, leak-free after copy-on-write
forks.

Tolerances: quantized values and scales exactly equal (same f32
operations, round half to even); attention outputs 2e-6 (f32, other
summation orders over at most 24 positions); gathers 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.nn import pallas_attention as jpa
from paddle_tpu.serve import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serve import DecodeEngine as JDecodeEngine
from paddle_tpu.serve import PagedKVCache as JPagedKVCache
from paddle_tpu.serve import kv_cache as jkvc
from paddle_tpu_torch import (ContinuousBatchingScheduler, DecodeEngine,
                              TransformerLM, load_jax_params)
from paddle_tpu_torch.nn import cuda_attention as ca
from paddle_tpu_torch.serve import PagedKVCache
from paddle_tpu_torch.serve import kv_cache as tkvc

V, W, DIM, LAYERS, HEADS, FFN = 64, 32, 32, 2, 4, 64
BS, MB = 4, 6
ATOL = 2e-6


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


def _t(a):
    return torch.from_numpy(np.array(a))


def _both_pools(rng, N, H, D):
    """The same int8 pool for both sides, quantized by the JAX package."""
    raw = rng.randn(N, BS, H, D).astype(np.float32)
    jq = jkvc.quantize_rows(jnp.asarray(raw))
    return jq, (_t(jq[0]), _t(jq[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_rows_bit_equal_to_jax(seed):
    rng = np.random.RandomState(seed)
    kv = rng.randn(3, 7, 4, 16).astype(np.float32) * (1 + 10 * seed)
    kv[0, 0, 0] = 0.0                          # amax 0: the 1e-8 floor
    kv[0, 1, 0, :4] = [0.5, -0.5, 1.5, 127.0]  # halves round to even
    kv[0, 1, 1] = 1e-9                         # below the floor
    jq, js = jkvc.quantize_rows(jnp.asarray(kv))
    tq, ts = tkvc.quantize_rows(torch.from_numpy(kv))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tkvc.dequantize_rows(tq, ts).numpy(),
        np.asarray(jkvc.dequantize_rows(jq, js)))


@pytest.mark.parametrize("quant", [False, True])
def test_scatters_leave_the_jax_pools(quant):
    """Prefill (with a shared prefix masked), token and span scatters
    (with ``write_from`` and padding rows) write the same pools as the
    JAX package; block 0, the null block, takes the masked rows in an
    unspecified order and is left out."""
    rng = np.random.RandomState(2)
    N, H, D, S = 12, 2, 8, 2
    if quant:
        jp = (jnp.zeros((N, BS, H, D), jnp.int8),
              jnp.zeros((N, BS, H), jnp.float32))
        tp = (torch.zeros(N, BS, H, D, dtype=torch.int8),
              torch.zeros(N, BS, H))
    else:
        jp = jnp.zeros((N, BS, H, D), jnp.float32)
        tp = torch.zeros(N, BS, H, D)
    table = np.array([[3, 1, 5, 7, 0, 0], [2, 4, 6, 8, 9, 10]], np.int32)
    pre = rng.randn(S, MB * BS, H, D).astype(np.float32)
    length, start = np.array([9, 6], np.int32), np.array([0, 4], np.int32)
    jp = jkvc.scatter_prefill_pages(jp, jnp.asarray(pre), jnp.asarray(table),
                                    jnp.asarray(length), jnp.asarray(start))
    tkvc.scatter_prefill_pages(tp, _t(pre), _t(table), _t(length), _t(start))
    tok = rng.randn(S, H, D).astype(np.float32)
    pos, act = np.array([9, 6], np.int32), np.array([True, False])
    jp = jkvc.scatter_token_pages(jp, jnp.asarray(tok), jnp.asarray(table),
                                  jnp.asarray(pos), jnp.asarray(act))
    tkvc.scatter_token_pages(tp, _t(tok), _t(table), _t(pos), _t(act))
    span = rng.randn(S, 5, H, D).astype(np.float32)
    st, n, wf = (np.array([10, 21], np.int32), np.array([5, 3], np.int32),
                 np.array([12, 0], np.int32))
    jp = jkvc.scatter_span_pages(jp, jnp.asarray(span), jnp.asarray(table),
                                 jnp.asarray(st), jnp.asarray(n),
                                 jnp.asarray(wf))
    tkvc.scatter_span_pages(tp, _t(span), _t(table), _t(st), _t(n), _t(wf))
    for j, t in zip(jp if quant else (jp,), tp if quant else (tp,)):
        np.testing.assert_array_equal(t.numpy()[1:], np.asarray(j)[1:])
    got = tkvc.gather_pages(tp, _t(table))
    want = jkvc.gather_pages(jp, jnp.asarray(table))
    assert got.dtype == torch.float32 and got.shape == want.shape
    live = table[:, :, None] != 0                       # not the null block
    live = np.repeat(live, BS, axis=2).reshape(S, MB * BS)
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-6, rtol=0)


def test_paged_decode_int8_plain_matches_jax_kernel_and_oracle():
    rng = np.random.RandomState(3)
    S, H, D, N = 4, 2, 16, 32
    jk, tk = _both_pools(rng, N, H, D)
    jv, tv = _both_pools(rng, N, H, D)
    q = rng.randn(S, H, D).astype(np.float32)
    tables = rng.randint(0, N, (S, MB)).astype(np.int32)
    lengths = np.array([5, 0, MB * BS, 12], np.int32)
    args = (jnp.asarray(tables), jnp.asarray(lengths))
    kern = jpa.paged_decode_attention(jnp.asarray(q), jk, jv, *args)
    oracle = jpa.paged_reference_attention(jnp.asarray(q), jk, jv, *args)
    got = ca.paged_decode_attention(_t(q), tk, tv, _t(tables), _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=ATOL,
                               rtol=0)
    assert not got[1].any()


def test_paged_span_int8_plain_matches_jax_kernel_and_oracle():
    rng = np.random.RandomState(4)
    S, Q, H, D, N = 3, 4, 2, 16, 32
    jk, tk = _both_pools(rng, N, H, D)
    jv, tv = _both_pools(rng, N, H, D)
    q = rng.randn(S, Q, H, D).astype(np.float32)
    tables = rng.randint(0, N, (S, MB)).astype(np.int32)
    start, n = np.array([2, 0, 9], np.int32), np.array([Q, 0, Q], np.int32)
    args = (jnp.asarray(tables), jnp.asarray(start), jnp.asarray(n))
    kern = jpa.paged_span_attention(jnp.asarray(q), jk, jv, *args)
    oracle = jpa.paged_span_reference_attention(jnp.asarray(q), jk, jv,
                                                *args)
    got = ca.paged_span_attention(_t(q), tk, tv, _t(tables), _t(start),
                                  _t(n))
    for s in range(S):
        if n[s] == 0:
            assert not got[s].any()
            continue
        for want in (kern, oracle):
            np.testing.assert_allclose(got[s, :n[s]].numpy(),
                                       np.asarray(want[s, :n[s]]),
                                       atol=ATOL, rtol=0)


def test_capacity_accounting_matches_jax():
    """At the serving width (6 layers, 8 heads, head dim 64) an int8 token
    costs 64 + 4 bytes per head-row against 256 for f32: 6528 against
    24576 bytes per token."""
    kw = dict(num_layers=6, num_heads=8, head_dim=64, num_blocks=3,
              block_size=16, max_slots=1, max_blocks_per_seq=2)
    for kv_dtype, per_token in ((None, 24576), ("int8", 6528)):
        t = PagedKVCache(**kw, kv_dtype=kv_dtype, device="cpu")
        j = JPagedKVCache(**kw, kv_dtype=kv_dtype)
        assert t.kv_bytes_per_token == j.kv_bytes_per_token == per_token
        assert t.bytes_per_block == j.bytes_per_block == 16 * per_token
        assert t.quant_dtype == j.quant_dtype
    q = PagedKVCache(**kw, kv_dtype="int8", device="cpu")
    assert q.k[0].dtype == torch.int8 and q.k[0].shape == (6, 3, 16, 8, 64)
    assert q.k[1].dtype == torch.float32 and q.k[1].shape == (6, 3, 16, 8)
    with pytest.raises(ValueError, match="kv_dtype"):
        PagedKVCache(**kw, kv_dtype="int4", device="cpu")


def test_int8_engine_tokens_match_jax_engine_under_churn(models):
    jm, vs, tm = models
    rng = np.random.RandomState(5)
    pre = [int(t) for t in rng.randint(0, V, 2 * BS)]
    prompts = [[int(t) for t in rng.randint(0, V, n)] for n in (5, 11, 3)]
    prompts += [pre + [1, 2, 3], pre + [4], list(pre)]
    new = 6
    jeng = JDecodeEngine(jm, vs, max_slots=3, block_size=BS,
                         attention="xla", kv_dtype="int8")
    # the JAX tick may read cache.lengths after the host bumps them
    # (ROADMAP, Queue 3): hand it copies
    jc = jeng.cache
    jc.device_tables = lambda: (jnp.array(np.copy(jc.tables)),
                                jnp.array(np.copy(jc.lengths)))
    js = JScheduler(jeng)
    jreqs = [js.submit(list(p), new) for p in prompts]
    js.run()
    for impl in ("paged", "xla"):
        eng = DecodeEngine(tm, max_slots=3, block_size=BS, attention=impl,
                           kv_dtype="int8", device="cpu")
        ts = ContinuousBatchingScheduler(eng)
        treqs = [ts.submit(list(p), new) for p in prompts]
        ts.run()
        assert [r.tokens for r in treqs] == [r.tokens for r in jreqs], impl
        assert eng.cache.prefix_hit_blocks >= 2


def test_int8_cow_forks_copy_scales_and_stay_leak_free(models):
    """Exact-duplicate prompts on int8 pools: the fork copies the scale
    page with its values (the sharers' tokens equal a solo run's) and
    every block returns to the pool."""
    _, _, tm = models
    prompt = [int(t) for t in np.random.RandomState(6).randint(0, V, 6)]
    out = {}
    for share in (True, False):
        eng = DecodeEngine(tm, max_slots=3, block_size=BS, kv_dtype="int8",
                           share_prefix=share, speculative=2, device="cpu")
        s = ContinuousBatchingScheduler(eng)
        reqs = [s.submit(list(prompt), 7) for _ in range(3)]
        s.run()
        out[share] = [r.tokens for r in reqs]
        pool = list(eng.cache.allocator._free) + \
            list(eng.cache.allocator._retained)
        assert len(pool) == len(set(pool)) == eng.cache.num_blocks - 1
        assert not eng.cache.allocator._rc
        if share:
            assert eng.cache.cow_forks >= 2
    assert out[True] == out[False]
    assert out[True][0] == out[True][1] == out[True][2]
