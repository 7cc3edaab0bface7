"""The port's ``BlockAllocator.is_retained`` and ``PrefixCache.__len__``
against the JAX cache's, driven in lockstep (host bookkeeping, CPU):

- a seeded random sequence of allocator operations (alloc, incref,
  decref with and without retention, free) on both allocators, with
  ``is_retained`` of every block, the free and retained counts equal
  after each operation;
- a prefix cache registering full-block chains and partial tails, then
  invalidating blocks: ``len`` equal after each step;
- two ``PagedKVCache`` objects admitting, registering and freeing slots
  that share prefixes with retention on: ``is_retained`` of every block
  and ``len(prefix_cache)`` equal at each step.

Comparisons are exact."""

import numpy as np
import pytest

from paddle_tpu.serve import kv_cache as jkvc
from paddle_tpu_torch.serve import kv_cache as tkvc

N_BLOCKS = 12


def _same_blocks(ja, ta):
    for b in range(N_BLOCKS):
        assert ta.is_retained(b) == ja.is_retained(b), b
        assert ta.ref_count(b) == ja.ref_count(b), b
    assert ta.num_free == ja.num_free
    assert ta.num_retained == ja.num_retained


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_is_retained_in_lockstep(seed):
    rng = np.random.RandomState(seed)
    ja, ta = jkvc.BlockAllocator(N_BLOCKS), tkvc.BlockAllocator(N_BLOCKS)
    owned, saw_retained = [], False
    for _ in range(200):
        op = rng.randint(4)
        if op == 0 or not owned:
            n = int(rng.randint(1, 4))
            got_j, got_t = ja.alloc(n), ta.alloc(n)
            assert got_j == got_t
            owned += got_t or []
        elif op == 1:
            b = owned[rng.randint(len(owned))]
            assert ja.incref(b) == ta.incref(b)
            owned.append(b)
        else:
            b = owned.pop(rng.randint(len(owned)))
            retain = op == 3
            assert ja.decref(b, retain=retain) == ta.decref(b, retain=retain)
        _same_blocks(ja, ta)
        saw_retained |= ta.num_retained > 0
    assert saw_retained
    assert not ta.is_retained(tkvc.NULL_BLOCK)


def test_prefix_cache_len_in_lockstep():
    jp, tp = jkvc.PrefixCache(block_size=4), tkvc.PrefixCache(block_size=4)
    assert len(tp) == len(jp) == 0
    steps = [("reg", list(range(10)), [7, 8, 9]),        # 2 full + a tail
             ("reg", list(range(8)) + [5], [7, 8, 3]),  # another tail
             ("reg", [9] * 12, [1, 2, 4]),               # 3 full, no tail
             ("inv", 8), ("inv", 4), ("inv", 11),
             ("reg", list(range(6)), [5, 6])]
    for step in steps:
        for pc in (jp, tp):
            if step[0] == "reg":
                pc.register(step[1], step[2])
            else:
                pc.invalidate_block(step[1])
        assert len(tp) == len(jp), step
    assert len(tp) > 0


def test_cache_retention_in_lockstep():
    """Slots sharing a prefix are admitted, registered and freed with
    retention on; the retained LRU and the prefix index agree."""
    kw = dict(num_layers=1, num_heads=1, head_dim=4, num_blocks=N_BLOCKS,
              block_size=4, max_slots=3, max_blocks_per_seq=4,
              share_prefix=True, retain_prefix=True)
    jc = jkvc.PagedKVCache(**kw)
    tc = tkvc.PagedKVCache(**kw, device="cpu")
    pre = list(range(100, 108))
    prompts = [pre + [1, 2], pre + [3], [7] * 9, pre + [1, 2], [8] * 5,
               [9] * 13]
    live = {}
    for i, prompt in enumerate(prompts):
        slot = i % 3
        if slot in live:
            jc.free_slot(slot)
            tc.free_slot(slot)
        for c in (jc, tc):
            m = c.match_prefix(prompt)
            if m is not None and m.blocks:
                c.adopt_prefix(slot, m)
            assert c.ensure_capacity(slot, len(prompt) + 2)
            c.lengths[slot] = len(prompt)
            c.register_prefix(slot, prompt)
        live[slot] = prompt
        _same_blocks(jc.allocator, tc.allocator)
        assert len(tc.prefix_cache) == len(jc.prefix_cache)
    for slot in list(live):
        jc.free_slot(slot)
        tc.free_slot(slot)
        _same_blocks(jc.allocator, tc.allocator)
        assert len(tc.prefix_cache) == len(jc.prefix_cache)
    assert tc.allocator.num_retained > 0 and len(tc.prefix_cache) > 0
