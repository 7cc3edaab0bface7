"""The port's paged span attention and ``decode_span`` (f32, CPU) against
the JAX package: ``paged_span_plain`` against JAX ``paged_span_attention``
(Pallas interpret mode) and its oracle over ragged starts, ``Q = 1``
against the paged decode, and ``TransformerLM.decode_span`` logits
against JAX's on bridged weights through both attention impls, with
shared-prefix ``write_from`` masking.

Tolerances: attention outputs 2e-6 (f32, other summation orders over at
most 24 positions); logits 1e-4 (f32 through two layers, as
``tests/test_torch_serve.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.nn import pallas_attention as jpa
from paddle_tpu.serve import kv_cache as jkvc
from paddle_tpu_torch import TransformerLM, load_jax_params
from paddle_tpu_torch.nn import cuda_attention as ca
from paddle_tpu_torch.serve import PagedKVCache
from paddle_tpu_torch.serve import kv_cache as tkvc

V, W, DIM, LAYERS, HEADS, FFN = 64, 24, 32, 2, 4, 64
BS, MB = 4, 6
ATOL = 2e-6
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JTransformerLM(vocab=V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                        ffn_hidden=FFN, max_len=W)
    vs = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, W), jnp.int32))
    tm = TransformerLM(V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                       ffn_hidden=FFN, max_len=W, device="cpu")
    load_jax_params(tm, vs)
    return jm, vs, tm


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("k", [0, 3])
def test_paged_span_plain_matches_jax_kernel_and_oracle(k):
    """Ragged starts: mid-block, an inactive slot with a stale start (zeros
    on every row), the block boundary with ``n < Q``, and the clamped tail
    ending at the table's last position."""
    rng = np.random.RandomState(k)
    S, H, D, N, Q = 4, 2, 16, 32, 1 + k
    pk = rng.randn(N, BS, H, D).astype(np.float32)
    pv = rng.randn(N, BS, H, D).astype(np.float32)
    tables = rng.randint(0, N, (S, MB)).astype(np.int32)
    q = rng.randn(S, Q, H, D).astype(np.float32)
    start = np.array([3, 7, 8, MB * BS - Q], np.int32)
    n = np.array([Q, 0, max(1, Q - 1), Q], np.int32)
    jargs = [jnp.asarray(a) for a in (q, pk, pv, tables, start, n)]
    kern = jpa.paged_span_attention(*jargs)
    oracle = jpa.paged_span_reference_attention(*jargs)
    got = ca.paged_span_attention(*(_t(a) for a in (q, pk, pv, tables,
                                                    start, n)))
    assert got.shape == (S, Q, H, D)
    for s in range(S):
        if n[s] == 0:
            assert not got[s].any()
            continue
        for want in (kern, oracle):
            np.testing.assert_allclose(got[s, :n[s]].numpy(),
                                       np.asarray(want[s, :n[s]]),
                                       atol=ATOL, rtol=0)
    # row j is the paged decode at length start + j + 1
    for j in range(Q):
        lengths = np.where(n > j, start + j + 1, 0).astype(np.int32)
        single = ca.paged_decode_attention(_t(q[:, j]), _t(pk), _t(pv),
                                           _t(tables), _t(lengths))
        live = n > j
        np.testing.assert_allclose(got[live, j].numpy(),
                                   single[live].numpy(), atol=ATOL, rtol=0)


def _prefilled_caches(jm, vs, ids, lens, P, kv_dtype):
    """A JAX and a port cache, each with the first ``P`` positions of every
    row of ``ids`` scattered from the JAX prefill's K/V."""
    B = ids.shape[0]
    hd = DIM // HEADS
    jc = jkvc.PagedKVCache(LAYERS, HEADS, hd, B * MB + 1, BS, max_slots=B,
                           max_blocks_per_seq=MB, kv_dtype=kv_dtype)
    tc = PagedKVCache(LAYERS, HEADS, hd, B * MB + 1, BS, max_slots=B,
                      max_blocks_per_seq=MB, kv_dtype=kv_dtype, device="cpu")
    _, (ks, vsv) = jax.jit(lambda v, i: jm.apply(v, i, method="prefill"))(
        vs, jnp.asarray(ids))
    for b in range(B):
        assert jc.ensure_capacity(b, lens[b]) and tc.ensure_capacity(
            b, lens[b])
    tbl = jnp.asarray(jc.tables)
    plen = jnp.full((B,), P, jnp.int32)
    for layer in range(LAYERS):
        for tpool, new in ((tc.k, ks), (tc.v, vsv)):
            tkvc.scatter_prefill_pages(tkvc.layer_pool(tpool, layer),
                                       _t(new[layer]), _t(tc.tables),
                                       _t(plen))
    scat = jax.vmap(jkvc.scatter_prefill_pages,
                    in_axes=(0, 0, None, None))
    jc.k = scat(jc.k, ks, tbl, plen)
    jc.v = scat(jc.v, vsv, tbl, plen)
    return jc, tc


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_span_logits_match_jax(models, kv_dtype):
    """Prefill a 3-token stub, then cover the rest of two ragged rows in
    spans of 5 through both models, the JAX side on its ``xla`` and
    ``paged`` (interpret) impls and the port on both of its own, every
    live row's logits within 1e-4; the second row's spans re-read a
    2-position prefix with ``write_from`` masking its writes."""
    jm, vs, tm = models
    rng = np.random.RandomState(7)
    B, P, Q = 2, 3, 5
    lens = [W, 14]
    ids = rng.randint(0, V, (B, W)).astype(np.int32)
    caches = {impl: _prefilled_caches(jm, vs, ids, lens, P, kv_dtype)
              for impl in ("xla", "paged")}
    jspan = jax.jit(lambda v, t, kv, s, n, a, wf, impl: jm.apply(
        v, t, kv, s, n, a, attn_impl=impl, write_from=wf,
        method="decode_span"), static_argnums=(7,))
    t = P
    while t < max(lens):
        n = np.array([max(0, min(Q, lens[b] - t)) for b in range(B)],
                     np.int32)
        start = np.array([t, t - 2], np.int32)       # row 1 re-reads 2
        nn = np.where(n > 0, n + np.array([0, 2]), 0).astype(np.int32)
        nn = np.minimum(nn, Q)
        chunk = np.zeros((B, Q), np.int32)
        for b in range(B):
            chunk[b, :nn[b]] = ids[b, start[b]:start[b] + nn[b]]
        wf = np.array([0, t], np.int32)
        active = nn > 0
        for impl, (jc, tc) in caches.items():
            jl, (jc.k, jc.v, _) = jspan(
                vs, jnp.asarray(chunk), (jc.k, jc.v, jnp.asarray(jc.tables)),
                jnp.asarray(start), jnp.asarray(nn), jnp.asarray(active),
                jnp.asarray(wf), impl)
            tl, _ = tm.decode_span(
                _t(chunk).long(), (tc.k, tc.v, _t(tc.tables)), _t(start),
                _t(nn), _t(active), attn_impl=impl, write_from=_t(wf))
            for b in range(B):
                np.testing.assert_allclose(
                    tl[b, :nn[b]].numpy(), np.asarray(jl[b, :nn[b]]),
                    atol=LOGIT_ATOL, rtol=0,
                    err_msg=f"{impl} slot {b} start {start[b]}")
        t += Q
    for jc, tc in caches.values():      # the same pools after all spans
        for jpool, tpool in ((jc.k, tc.k), (jc.v, tc.v)):
            if kv_dtype:
                want = np.asarray(jkvc.dequantize_rows(*jpool))
                got = tkvc.dequantize_rows(*tpool).numpy()
                # the projections differ in their last bits, so a value
                # at a rounding midpoint may land one step (one scale)
                # apart; everything else within f32 rounding
                step = np.asarray(jpool[1])[..., None]
                off = np.abs(got - want)[:, 1:]
                assert np.all(off <= 1.01 * step[:, 1:] + 1e-6)
                assert np.mean(off > 1e-5) < 0.01
            else:
                np.testing.assert_allclose(tpool.numpy()[:, 1:],
                                           np.asarray(jpool)[:, 1:],
                                           atol=1e-5, rtol=0)


def test_decode_span_xla_rows_equal_decode_steps(models):
    """The port's ``xla`` span runs each row through the decode step's own
    row chain: a span of 4 equals 4 decode steps on the same cache."""
    _, _, tm = models
    rng = np.random.RandomState(8)
    hd = DIM // HEADS
    toks = rng.randint(0, V, (1, 9)).astype(np.int64)
    outs = []
    for mode in ("span", "steps"):
        c = PagedKVCache(LAYERS, HEADS, hd, MB + 1, BS, max_slots=1,
                         max_blocks_per_seq=MB, device="cpu")
        assert c.ensure_capacity(0, 9)
        tbl = _t(c.tables)
        tm.decode_span(_t(toks[:, :5]), (c.k, c.v, tbl),
                       _t([0]).int(), _t([5]).int())
        if mode == "span":
            lg, _ = tm.decode_span(_t(toks[:, 5:9]), (c.k, c.v, tbl),
                                   _t([5]).int(), _t([4]).int())
            outs.append(lg[0])
        else:
            rows = [tm.decode_step(_t(toks[:, p]), (c.k, c.v, tbl),
                                   _t([p]))[0][0] for p in range(5, 9)]
            outs.append(torch.stack(rows))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(),
                               atol=1e-5, rtol=0)
