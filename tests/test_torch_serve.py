"""The port's serving runtime (f32, CPU): greedy token identity with the
JAX engine on bridged weights under admit/evict churn and prefix sharing,
the allocator / prefix-cache / pool leak checks of tests/test_serve.py
replayed on the port, the no-card refusal of the entry points, and the
import isolation of the package and chip_smoke.py."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.serve import ContinuousBatchingScheduler as JScheduler
from paddle_tpu.serve import DecodeEngine as JDecodeEngine
import paddle_tpu_torch
from paddle_tpu_torch import (ContinuousBatchingScheduler, DecodeEngine,
                              TransformerLM, load_jax_params)
from paddle_tpu_torch.serve import (NULL_BLOCK, BlockAllocator,
                                    PagedKVCache, PrefixCache)

REPO = pathlib.Path(__file__).resolve().parents[1]
V, W, DIM, LAYERS, HEADS, FFN = 64, 32, 32, 2, 4, 64
BS = 4
LOGIT_ATOL = 1e-4    # f32 through two layers, different summation orders


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


def _free_once(eng):
    """Every non-null block exactly once across free list and retained LRU,
    and no live refcount."""
    pool = list(eng.cache.allocator._free) + \
        list(eng.cache.allocator._retained)
    return (len(pool) == len(set(pool)) == eng.cache.num_blocks - 1
            and not eng.cache.allocator._rc)


# ---------------------------------------------------------------------------
# greedy identity with the JAX engine
# ---------------------------------------------------------------------------

def test_greedy_tokens_match_jax_engine_under_churn(models):
    jm, vs, tm = models
    rng = np.random.RandomState(0)
    pre = [int(t) for t in rng.randint(0, V, 2 * BS)]
    prompts = [[int(t) for t in rng.randint(0, V, n)]
               for n in (5, 11, 3, 17, 8)]
    prompts += [pre + [1, 2, 3], pre + [4]]        # a shared-prefix pair
    new = 6

    jeng = JDecodeEngine(jm, vs, max_slots=3, block_size=BS,
                         attention="paged")
    # The JAX engine bumps cache.lengths in place while its tick is still
    # in flight; on the CPU, jnp.asarray may alias that numpy buffer, so a
    # tick can read length + 1 and emit a wrong token. Handing it copies
    # keeps the reference deterministic.
    jc = jeng.cache
    jc.device_tables = lambda: (jnp.array(np.copy(jc.tables)),
                                jnp.array(np.copy(jc.lengths)))
    js = JScheduler(jeng)
    jreqs = [js.submit(list(p), new) for p in prompts]
    js.run()
    eng = _engine(tm, attention="paged")
    ts = ContinuousBatchingScheduler(eng)
    treqs = [ts.submit(list(p), new) for p in prompts]
    ts.run()
    assert eng.cache.prefix_hit_blocks >= 2          # the pair shared

    # logits first: each generated position through both forwards, so a
    # flipped token shows as a near-tie, not as a silent mismatch
    fwd = jax.jit(lambda v, i: jm.apply(v, i))
    for p, jr, tr in zip(prompts, jreqs, treqs):
        seq = np.zeros((1, W), np.int32)
        full = p + tr.tokens[:-1]
        seq[0, :len(full)] = full
        lj = np.asarray(fwd(vs, jnp.asarray(seq)))[0]
        with torch.no_grad():
            lt = tm(torch.from_numpy(seq).long())[0].numpy()
        rows = slice(len(p) - 1, len(full))
        np.testing.assert_allclose(lt[rows], lj[rows], atol=LOGIT_ATOL,
                                   rtol=0)
        assert list(np.argmax(lt[rows], -1)) == tr.tokens
        top2 = np.sort(lj[rows], -1)[:, -2:]
        gaps = top2[:, 1] - top2[:, 0]
        assert tr.tokens == jr.tokens, \
            f"token flip with top-2 gaps {gaps.min():.2e}"


def test_paged_and_xla_decode_give_identical_tokens(models):
    _, _, tm = models
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, V, n)] for n in (4, 9, 13)]
    out = {}
    for impl in ("paged", "xla"):
        s = ContinuousBatchingScheduler(_engine(tm, attention=impl))
        reqs = [s.submit(list(p), 7) for p in prompts]
        s.run()
        out[impl] = [r.tokens for r in reqs]
    assert out["paged"] == out["xla"]


# ---------------------------------------------------------------------------
# host-side bookkeeping, replayed from tests/test_serve.py
# ---------------------------------------------------------------------------

def test_block_allocator_invariants_and_refcounts():
    a = BlockAllocator(6)
    assert a.num_free == 5
    assert a.alloc(3) == [1, 2, 3] and a.num_free == 2
    assert a.alloc(3) is None and a.num_free == 2
    a.free([2])
    assert a.alloc(3) == [4, 5, 2]               # FIFO reuse
    with pytest.raises(AssertionError):
        a.free([NULL_BLOCK])
    b = BlockAllocator(6)
    assert b.alloc(2) == [1, 2] and b.total_allocs == 2
    b.incref(1)
    assert b.ref_count(1) == 2 and b.decref(1) is False
    assert b.num_free == 3 and b.decref(1) is True and b.num_free == 4
    with pytest.raises(AssertionError, match="double free"):
        b.decref(1)
    with pytest.raises(AssertionError):
        b.incref(5)


def test_prefix_cache_chain_and_partial():
    pc = PrefixCache(block_size=4)
    prompt = list(range(10))
    pc.register(prompt, [7, 8, 9])
    m = pc.match(prompt)
    assert m.blocks == [7, 8, 9] and m.length == 10 and m.partial
    m = pc.match(list(range(8)) + [99, 98, 97])
    assert m.blocks == [7, 8] and m.length == 8 and not m.partial
    assert pc.match([0, 1, 2, 3, 99, 5, 6, 7]).blocks == [7]
    assert pc.match([99, 1, 2, 3]).blocks == []
    assert pc.match([9, 9, 9, 9] + list(range(4, 8))).blocks == []
    pc.invalidate_block(8)
    assert pc.match(prompt).blocks == [7]


def test_cache_capacity_and_free():
    c = PagedKVCache(num_layers=1, num_heads=2, head_dim=4, num_blocks=5,
                     block_size=BS, max_slots=2, max_blocks_per_seq=6,
                     device="cpu")
    assert c.context_width == 6 * BS
    assert c.ensure_capacity(0, 9) and c.free_blocks == 1
    assert not c.ensure_capacity(1, 9) and c.free_blocks == 1
    assert c.ensure_capacity(1, 3)
    c.free_slot(0)
    assert c.free_blocks == 3
    assert (c.tables[0] == NULL_BLOCK).all() and c.lengths[0] == 0


def test_shared_prefix_fewer_allocs_and_leak_free(models):
    _, _, tm = models
    rng = np.random.RandomState(2)
    pre = [int(t) for t in rng.randint(0, V, 2 * BS)]
    prompts = [pre + [int(t) for t in rng.randint(0, V, 3)]
               for _ in range(4)]

    def run(share):
        eng = _engine(tm, max_slots=4, share_prefix=share)
        s = ContinuousBatchingScheduler(eng)
        reqs = [s.submit(list(p), 5) for p in prompts]
        s.run()
        return eng, [r.tokens for r in reqs], reqs

    eng_on, toks_on, reqs_on = run(True)
    eng_off, toks_off, _ = run(False)
    assert toks_on == toks_off
    assert (eng_on.cache.allocator.total_allocs
            < eng_off.cache.allocator.total_allocs)
    assert eng_on.cache.prefix_hit_blocks >= 2
    assert _free_once(eng_on) and _free_once(eng_off)
    assert any((r.prefix_hit_blocks or 0) > 0 for r in reqs_on)


def test_cow_fork_on_duplicate_prompts(models):
    _, _, tm = models
    prompt = [int(t) for t in np.random.RandomState(3).randint(0, V, 6)]
    eng = _engine(tm, max_slots=4)
    s = ContinuousBatchingScheduler(eng)
    r1, r2 = s.submit(list(prompt), 5), s.submit(list(prompt), 5)
    s.run()
    assert r1.tokens == r2.tokens and eng.cache.cow_forks >= 1
    assert (r1.cow_forks or 0) + (r2.cow_forks or 0) >= 1
    solo_s = ContinuousBatchingScheduler(_engine(tm, share_prefix=False))
    solo = solo_s.submit(list(prompt), 5)
    solo_s.run()
    assert solo.tokens == r1.tokens
    assert _free_once(eng)


def test_retention_hits_and_reclaim_under_pressure_leak_free(models):
    _, _, tm = models
    rng = np.random.RandomState(4)
    pre = [int(t) for t in rng.randint(0, V, 2 * BS)]
    eng = _engine(tm, max_slots=2)
    s = ContinuousBatchingScheduler(eng)
    first = s.submit(pre + [1, 2], 4)
    s.run()
    assert eng.cache.retained_blocks > 0          # parked, not freed
    s2 = ContinuousBatchingScheduler(eng)
    again = s2.submit(pre + [1, 2], 4)
    s2.run()
    assert eng.cache.retained_hits >= 2 and again.tokens == first.tokens
    assert _free_once(eng)
    # a small pool: churn through distinct prompts forces lazy reclaims
    small = _engine(tm, max_slots=2, num_blocks=2 * 3 + 1)
    for i in range(4):
        sc = ContinuousBatchingScheduler(small)
        for j in range(3):
            sc.submit([int(t) for t in rng.randint(0, V, 4 + i + j)], 5)
        sc.run()
    assert small.cache.allocator.retained_reclaims > 0
    assert _free_once(small)
    assert small.cache.free_blocks == small.cache.num_blocks - 1
    probe = small.admit_probe(small.cache.free_blocks * BS,
                              include_slots=False)
    assert probe.ok and probe.free_blocks == (probe.raw_free_blocks
                                              + probe.retained_blocks)


def test_backpressure_width_and_reservation_checks(models):
    _, _, tm = models
    eng = _engine(tm, max_slots=2, num_blocks=4)     # 3 usable blocks
    s = ContinuousBatchingScheduler(eng)
    a = s.submit(list(range(1, 9)), 4)               # 11 tokens: 3 blocks
    b = s.submit(list(range(1, 5)), 2)
    s.step()
    assert a.slot is not None and b.slot is None
    assert s.last_backpressure == "blocks"
    s.run()
    assert a.finish_reason == b.finish_reason == "length"
    assert eng.admit_probe(W + 1).reason == "width"
    with pytest.raises(ValueError):
        s.submit(list(range(W)), 1)
    slot = eng.free_slots()[0]
    eng.admit(slot, [1, 2, 3, 4])                    # reserves one block
    with pytest.raises(RuntimeError, match="past its reservation"):
        eng.decode_tick()


def test_static_policy_gangs(models):
    _, _, tm = models
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9]]
    toks, ticks = {}, {}
    for policy in ("continuous", "static"):
        eng = _engine(tm, max_slots=2)
        s = ContinuousBatchingScheduler(eng, policy=policy)
        reqs = [s.submit(p, n) for p, n in zip(prompts, (2, 8, 3))]
        s.run()
        toks[policy] = [r.tokens for r in reqs]
        ticks[policy] = eng.ticks
    assert toks["static"] == toks["continuous"]
    assert ticks["static"] > ticks["continuous"]


# ---------------------------------------------------------------------------
# entry points and import isolation
# ---------------------------------------------------------------------------

def test_entry_points_need_a_card_unless_cpu_is_asked(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for a box "
                    "without one")
    _, _, tm = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(V, dim=DIM, num_layers=1, num_heads=HEADS,
                      ffn_hidden=FFN, max_len=W)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tm)


def test_paged_kv_cache_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal is for a box "
                    "without one")
    kw = dict(num_layers=1, num_heads=2, head_dim=4, num_blocks=5,
              block_size=BS, max_slots=2, max_blocks_per_seq=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCache(**kw)
    assert PagedKVCache(**kw, device="cpu").k.device.type == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax_or_paddle_tpu():
    files = sorted(pathlib.Path(paddle_tpu_torch.__file__).parent.rglob(
        "*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "paddle_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"
    code = ("import sys; before = set(sys.modules); import paddle_tpu_torch, "
            "chip_smoke; added = set(sys.modules) - before; "
            "bad = sorted(m for m in added if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
