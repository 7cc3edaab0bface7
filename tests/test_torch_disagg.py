"""Prefill/decode disaggregation on the port (CPU): a ``role="prefill"``
scheduler hands each prefilled request off (``pop_handoffs``), its pages
cross as per-block blobs (``pages_to_blobs`` / ``blobs_to_pages``) and a
``role="decode"`` scheduler adopts them (``adopt``) and decodes to the
end; the greedy tokens must equal a colocated run's exactly, over f32,
bf16 and int8 pools, for ragged prompts and a copy-on-write shared prefix
(the prefill engine shares the prefix of the pair, the decode engine gets
the pages as they are). Each blob is exactly the pool's
``bytes_per_block``. ``adopt`` returns None and changes nothing when the
decode side has no free slot or too few blocks. The blobs are the JAX
package's byte for byte: a blob the port writes, read by JAX's
``blobs_to_pages``, equals the port's exported pages bit for bit, and the
reverse; a blob of another length is refused. Token comparisons are
exact: each engine is deterministic on the CPU and the adopting engine
rebuilds the state a colocated prefill leaves."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.serve import kv_cache as jkv
import paddle_tpu_torch as pt
from paddle_tpu_torch.serve import PagedKVCache, blobs_to_pages, \
    pages_to_blobs

V, W, DIM, LAYERS, HEADS, FFN = 64, 32, 32, 2, 4, 64
BS = 4
POOLS = {"f32": {}, "bf16": {"dtype": torch.bfloat16},
         "int8": {"kv_dtype": "int8"}}


@pytest.fixture(scope="module")
def model():
    jm = JTransformerLM(vocab=V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                        ffn_hidden=FFN, max_len=W, use_flash=True)
    vs = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, W), jnp.int32))
    tm = pt.TransformerLM(V, dim=DIM, num_layers=LAYERS, num_heads=HEADS,
                          ffn_hidden=FFN, max_len=W, use_flash=True,
                          device="cpu")
    return pt.load_jax_params(tm, vs)


def _engine(tm, pool, **kw):
    kw.setdefault("max_slots", 3)
    return pt.DecodeEngine(tm, block_size=BS, device="cpu", **POOLS[pool],
                           **kw)


def _wire(eng, kpages, vpages):
    """The pages through the wire format, as the receiving pool reads
    them; each blob checked against its ``bytes_per_block``."""
    blobs = pages_to_blobs(kpages, vpages)
    c = eng.cache
    assert all(len(b) == c.bytes_per_block for b in blobs)
    return blobs_to_pages(blobs, num_layers=c.num_layers,
                          block_size=c.block_size, num_heads=c.num_heads,
                          head_dim=c.head_dim, quantized=c.quantized,
                          dtype=c.dtype)


def _disaggregated(tm, pool, prompts, new):
    pre = pt.ContinuousBatchingScheduler(_engine(tm, pool), role="prefill")
    dec = pt.ContinuousBatchingScheduler(_engine(tm, pool), role="decode")
    subs = [pre.submit(list(p), n) for p, n in zip(prompts, new)]
    pending, adopted = [], 0
    for _ in range(1000):
        pre.step()
        pending += pre.pop_handoffs()
        waiting = []
        for req, meta, kpages, vpages in pending:
            assert meta["quant"] == dec.engine.cache.quant_dtype
            assert meta["length"] == len(meta["prompt"])
            got = dec.adopt(meta, *_wire(dec.engine, kpages, vpages))
            if got is None:
                waiting.append((req, meta, kpages, vpages))
            else:
                adopted += 1
                assert got.rid == req.rid and got.tokens == req.tokens
        pending = waiting
        dec.step()
        if not (pre.queue or pre.prefilling or pre.running or pending
                or dec.running):
            break
    done = {r.rid: r for r in pre.completed + dec.completed}
    assert len(done) == len(subs)
    return [done[r.rid] for r in subs], adopted, pre, dec


@pytest.mark.parametrize("pool", list(POOLS))
def test_handoff_tokens_equal_colocated(model, pool):
    rng = np.random.RandomState(7)
    pre = [int(t) for t in rng.randint(0, V, 2 * BS)]
    # ragged prompts, a shared-prefix pair (admitted apart, so the second
    # shares the first's registered blocks) and one request that ends at
    # its first token (never handed off)
    prompts = [pre + [1, 2, 3]] + [[int(t) for t in rng.randint(0, V, n)]
                                   for n in (5, 11, 3, 9)] + [pre + [4]]
    new = [6, 5, 6, 4, 1, 6]
    tm = model
    col = pt.ContinuousBatchingScheduler(_engine(tm, pool))
    want = [col.submit(list(p), n) for p, n in zip(prompts, new)]
    col.run()
    got, adopted, pre_s, dec_s = _disaggregated(tm, pool, prompts, new)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert adopted == len(prompts) - 1          # all but the 1-token one
    assert all(r.finish_reason == "length" for r in got)
    assert pre_s.engine.cache.prefix_hit_blocks >= 2     # the pair shared
    assert pre_s.engine.ticks == 0 and not pre_s.completed[1:]
    for r in got:
        assert r.first_token_ts is not None and r.submit_ts <= \
            r.first_token_ts
    # every block back in both pools
    for eng in (pre_s.engine, dec_s.engine):
        pool_ids = list(eng.cache.allocator._free) + \
            list(eng.cache.allocator._retained)
        assert len(pool_ids) == len(set(pool_ids)) == \
            eng.cache.num_blocks - 1
        assert not eng.cache.allocator._rc


def _one_handoff(tm, pool, prompt, new=4):
    pre = pt.ContinuousBatchingScheduler(_engine(tm, pool), role="prefill")
    pre.submit(list(prompt), new)
    pre.step()
    (item,) = pre.pop_handoffs()
    return item


@pytest.mark.parametrize("pool", ["f32", "bf16"])
def test_adopt_backpressure_changes_nothing(model, pool):
    rng = np.random.RandomState(8)
    items = [_one_handoff(model, pool, [int(t) for t in rng.randint(
        0, V, n)]) for n in (6, 9)]
    # no free slot
    dec = pt.ContinuousBatchingScheduler(_engine(model, pool, max_slots=1),
                                         role="decode")
    req, meta, kp, vp = items[0]
    assert dec.adopt(meta, kp, vp) is not None
    before = (dec.engine.cache.free_blocks, dict(dec.running),
              dec.engine.active.copy())
    req, meta, kp, vp = items[1]
    assert dec.adopt(meta, kp, vp) is None
    assert dec.last_backpressure == "slots"
    assert (dec.engine.cache.free_blocks, dict(dec.running)) == before[:2]
    assert (dec.engine.active == before[2]).all()
    # too few blocks for the whole reservation (9 + 4 - 1 tokens: 3)
    dec = pt.ContinuousBatchingScheduler(
        _engine(model, pool, max_slots=2, num_blocks=3), role="decode")
    free, lengths = dec.engine.cache.free_blocks, dec.engine.cache.lengths
    assert dec.adopt(meta, kp, vp) is None
    assert dec.last_backpressure == "blocks"
    assert dec.engine.cache.free_blocks == free and not dec.running
    assert not dec.engine.active.any() and not lengths.any()
    assert not dec.engine.cache.allocator._rc


def _filled(cls, quant, **kw):
    """A cache of either package whose slot 0 holds 7 tokens in blocks 3,
    1 (table order)."""
    c = cls(num_layers=2, num_heads=2, head_dim=8, num_blocks=5,
            block_size=4, max_slots=1, max_blocks_per_seq=2,
            kv_dtype="int8" if quant else None, **kw)
    c.allocator._free.remove(3)
    c.allocator._free.appendleft(3)
    c.ensure_capacity(0, 7)
    c.lengths[0] = 7
    return c


def _leaves(rng, quant):
    """Random pool leaves ``[2, 5, 4, 2, 8]`` (and int8's scales)."""
    shape = (2, 5, 4, 2, 8)
    if quant:
        return [rng.randint(-127, 128, shape).astype(np.int8),
                rng.rand(*shape[:-1]).astype(np.float32)]
    return [rng.randn(*shape).astype(np.float32)]


def _bits(a):
    """An array of either package as its raw bytes."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("pool", list(POOLS))
def test_blobs_are_the_jax_packages_byte_for_byte(pool):
    quant = pool == "int8"
    tdt = torch.bfloat16 if pool == "bf16" else torch.float32
    jdt = jnp.bfloat16 if pool == "bf16" else jnp.float32
    geom = dict(num_layers=2, block_size=4, num_heads=2, head_dim=8,
                quantized=quant)
    rng = np.random.RandomState(9)
    # the port writes, JAX reads
    t = _filled(PagedKVCache, quant, dtype=tdt, device="cpu")
    leaves = _leaves(rng, quant)
    if quant:
        t.k = tuple(torch.from_numpy(x) for x in leaves)
        t.v = tuple(torch.from_numpy(x.copy()[::-1].copy()) for x in leaves)
    else:
        t.k = torch.from_numpy(leaves[0]).to(tdt)
        t.v = torch.from_numpy(-leaves[0]).to(tdt)
    ids, tk, tv = t.export_pages(0)
    assert ids == [3, 1]
    blobs = pages_to_blobs(tk, tv)
    assert all(len(b) == t.bytes_per_block for b in blobs)
    jk, jv = jkv.blobs_to_pages(blobs, dtype=jdt, **geom)
    for a, b in zip(jax.tree_util.tree_leaves((jk, jv)),
                    jax.tree_util.tree_leaves((tk, tv))):
        assert _bits(a) == _bits(b)
    assert jkv.pages_to_blobs(jk, jv) == blobs
    # JAX writes, the port reads
    j = _filled(jkv.PagedKVCache, quant, dtype=jdt)
    leaves = _leaves(rng, quant)
    if quant:
        j.k = tuple(jnp.asarray(x) for x in leaves)
        j.v = tuple(jnp.asarray(x) * 1 for x in leaves)
    else:
        j.k = jnp.asarray(leaves[0], jdt)
        j.v = jnp.asarray(leaves[0] * 3, jdt)
    _, jk, jv = j.export_pages(0)
    blobs = jkv.pages_to_blobs(jk, jv)
    tk, tv = blobs_to_pages(blobs, dtype=tdt, **geom)
    for a, b in zip(jax.tree_util.tree_leaves((jk, jv)),
                    jax.tree_util.tree_leaves((tk, tv))):
        assert _bits(a) == _bits(b)
    assert pages_to_blobs(tk, tv) == blobs
    # a blob of another length, or none at all, is refused
    with pytest.raises(ValueError, match="bytes but this pool"):
        blobs_to_pages([blobs[0][:-1]], dtype=tdt, **geom)
    with pytest.raises(ValueError, match="zero page blobs"):
        blobs_to_pages([], dtype=tdt, **geom)


def test_imported_pages_land_at_the_receivers_blocks(model):
    """An adopted slot's pages sit at the decode pool's own block ids and
    read back equal to the exported ones; the reservation covers the
    whole decode."""
    item = _one_handoff(model, "bf16", list(range(1, 10)), new=7)
    req, meta, kp, vp = item
    dec = pt.ContinuousBatchingScheduler(_engine(model, "bf16"),
                                         role="decode")
    dec.engine.cache.allocator.alloc(2)          # shift the block ids
    got = dec.adopt(meta, kp, vp)
    slot = got.slot
    c = dec.engine.cache
    assert c.lengths[slot] == 9 and c.owned_count(slot) == 4   # 9 + 7 - 1
    ids, k2, v2 = c.export_pages(slot)
    assert ids[0] not in (1, 2) and len(ids) == meta["blocks"] == 3
    assert torch.equal(k2, kp) and torch.equal(v2, vp)
    assert dec.engine.history[slot] == list(range(1, 10)) + req.tokens
