"""Paged KV cache — the port of ``paddle_tpu/serve/kv_cache.py`` on one
device, with f32, bf16 or int8 pools.

The cache is one pool of fixed-size blocks per layer (``[L, N, bs, H,
hd]``) and each sequence holds an ordered block table of pool indices;
allocation is block-granular and freed blocks are reusable at once.

- **Device side**: :func:`gather_pages`, :func:`scatter_prefill`,
  :func:`scatter_token`, :func:`scatter_span` and their quant-aware
  ``*_pages`` wrappers, :func:`quantize_rows` / :func:`dequantize_rows`.
  The scatters write the pool IN PLACE (the JAX engine donated its pools
  to the compiled programs and got new ones back; here the same storage
  is updated).
- **Host side**: :class:`BlockAllocator` (refcounts and the retained
  LRU), :class:`PrefixCache` (content-hashed prompt prefixes) and
  :class:`PagedKVCache` (the pools plus the authoritative host tables
  and lengths). Admission and eviction edit these small numpy arrays
  between decode ticks.

**bf16 pools** (``dtype=torch.bfloat16``): the scatters round the f32
projections to bf16 (half the bytes per token of f32); the paged kernels
widen the rows on chip and the ``"xla"`` path reads them as JAX promotes
them.

**Int8 pools** (``kv_dtype="int8"``): each pool is the tuple ``(int8
values [L, N, bs, H, hd], f32 scales [L, N, bs, H])``, one symmetric scale
per token row per head, so a later token landing in the same block never
requantizes the resident ones. Rows are quantized on scatter and
dequantized by the consumer: the paged kernels on chip, the ``"xla"``
path in :func:`gather_pages`.

Block 0 is the **null block**: unallocated table entries and masked-off
scatter rows point at it, so every scatter is total; its contents are
finite garbage, always masked by the length before use.

**Hand-off** (prefill/decode disaggregation): :meth:`PagedKVCache.
export_pages` reads a slot's pages out in table order, in the pool's own
dtype, :func:`pages_to_blobs` packs them into one ``bytes`` blob per
block, byte for byte the JAX package's layout (K leaves then V leaves,
each C-contiguous; int8 values then f32 scales; bf16 as its raw 16-bit
words), :func:`blobs_to_pages` unpacks them on the receiving side, and
:meth:`PagedKVCache.import_pages` adopts them at the receiver's own block
ids.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from .graphs import StagedInts

__all__ = ["BlockAllocator", "PagedKVCache", "PrefixCache", "PrefixMatch",
           "gather_pages", "scatter_prefill", "scatter_token",
           "scatter_span", "scatter_prefill_pages", "scatter_token_pages",
           "scatter_span_pages", "quantize_rows", "dequantize_rows",
           "layer_pool", "pages_to_blobs", "blobs_to_pages", "NULL_BLOCK"]

NULL_BLOCK = 0


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

def quantize_rows(kv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row-per-head int8 quantization: ``kv [..., hd]`` ->
    ``(int8 [..., hd], f32 scale [...])`` with ``scale = max(amax, 1e-8) /
    127`` over the head dim, values rounded half to even and clipped to
    +-127 — bit-equal to the JAX package's ``quantize_rows``."""
    amax = kv.float().abs().amax(-1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(kv / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows`: ``float(q) * scale`` in f32."""
    return q.float() * scale[..., None]


def layer_pool(pool, layer: int):
    """Layer ``layer`` of an ``[L, ...]`` pool, plain or an int8 tuple."""
    if isinstance(pool, tuple):
        return pool[0][layer], pool[1][layer]
    return pool[layer]


def gather_pages(pages, table: torch.Tensor) -> torch.Tensor:
    """One layer's pool ``[N, bs, H, hd]`` gathered through ``table``
    ``[S, MB]`` into position order ``[S, MB*bs, H, hd]``; rows past a
    sequence's length are unspecified. An int8 ``(values, scales)`` pool
    gathers dequantized f32 values."""
    S, MB = table.shape
    idx = table.long()
    if isinstance(pages, tuple):
        vals, scales = pages
        _, bs, H, hd = vals.shape
        return dequantize_rows(vals[idx], scales[idx]).reshape(
            S, MB * bs, H, hd)
    _, bs, H, hd = pages.shape
    return pages[idx].reshape(S, MB * bs, H, hd)


def scatter_prefill(pages, kv, table, length, start=0) -> torch.Tensor:
    """Write a prefill's K (or V) rows ``kv`` ``[B, W, ...]`` (positions
    ``0..W-1``) into the pool ``[N, bs, ...]``, in place. Only rows in
    ``[start, length)`` are live — the rest go to the null block;
    ``start`` masks a prefix-cache hit, whose rows already live in
    co-owned blocks that a sharer must never write. ``table`` ``[B,
    MB]``, ``length``/``start`` ``[B]`` (or a scalar ``start``)."""
    B, W = kv.shape[:2]
    bs = pages.shape[1]
    dev = pages.device
    start = torch.as_tensor(start, dtype=torch.int64, device=dev)
    start = start.expand(B) if start.dim() == 0 else start.long()
    pos = torch.arange(W, device=dev)
    live = (pos[None] < length.long()[:, None]) & (pos[None] >= start[:, None])
    blk = torch.where(live, table.long()[:, pos // bs],
                      torch.full_like(live, NULL_BLOCK, dtype=torch.long))
    off = (pos % bs).expand(B, W)
    pages[blk, off] = kv.to(pages.dtype)
    return pages


def scatter_token(pages, kv, table, position, active) -> torch.Tensor:
    """Write one decode step's K (or V) ``kv`` ``[S, ...]`` at each
    slot's ``position`` ``[S]``, in place; inactive slots write the null
    block."""
    S = kv.shape[0]
    bs = pages.shape[1]
    position = position.long()
    rows = table.long()[torch.arange(S, device=pages.device), position // bs]
    blk = torch.where(active, rows, torch.full_like(rows, NULL_BLOCK))
    pages[blk, position % bs] = kv.to(pages.dtype)
    return pages


def scatter_span(pages, kv, table, start, n, write_from=None
                 ) -> torch.Tensor:
    """Write a span of consecutive tokens' K (or V) ``kv`` ``[S, Q, ...]``
    for every slot, in place: token ``j`` of slot ``s`` lands at position
    ``start[s] + j``; only tokens ``j < n[s]`` are live (draft padding and
    a chunk's tail go to the null block). ``write_from`` ``[S]``
    (optional) also masks positions below it — a chunk re-reading a fully
    shared prefix for its logits must not write the co-owned pages."""
    S, Q = kv.shape[:2]
    bs = pages.shape[1]
    MB = table.shape[1]
    dev = pages.device
    pos = start.long()[:, None] + torch.arange(Q, device=dev)[None]  # [S, Q]
    live = torch.arange(Q, device=dev)[None] < n.long()[:, None]
    if write_from is not None:
        live = live & (pos >= write_from.long()[:, None])
    # masked-off rows may point past the table; they go to the null block
    idx = torch.div(pos, bs, rounding_mode="floor").clamp(0, MB - 1)
    blk = torch.where(live, torch.gather(table.long(), 1, idx),
                      torch.full_like(idx, NULL_BLOCK))
    pages[blk, pos % bs] = kv.to(pages.dtype)
    return pages


# quant-aware wrappers: a plain pool takes the values as they are; an int8
# (values, scales) pool quantizes on scatter and writes the int8 rows and
# their scales through the same block/offset routing

def scatter_prefill_pages(pages, kv, table, length, start=0):
    if isinstance(pages, tuple):
        q, s = quantize_rows(kv)
        return (scatter_prefill(pages[0], q, table, length, start),
                scatter_prefill(pages[1], s, table, length, start))
    return scatter_prefill(pages, kv, table, length, start)


def scatter_token_pages(pages, kv, table, position, active):
    if isinstance(pages, tuple):
        q, s = quantize_rows(kv)
        return (scatter_token(pages[0], q, table, position, active),
                scatter_token(pages[1], s, table, position, active))
    return scatter_token(pages, kv, table, position, active)


def scatter_span_pages(pages, kv, table, start, n, write_from=None):
    if isinstance(pages, tuple):
        q, s = quantize_rows(kv)
        return (scatter_span(pages[0], q, table, start, n, write_from),
                scatter_span(pages[1], s, table, start, n, write_from))
    return scatter_span(pages, kv, table, start, n, write_from)


# ---------------------------------------------------------------------------
# the hand-off's wire format
# ---------------------------------------------------------------------------

# each pool dtype as numpy carries it over the wire: bf16 as its raw 16-bit
# words (numpy has no bfloat16)
_WIRE = {torch.float32: np.float32, torch.bfloat16: np.int16,
         torch.int8: np.int8}


def _wire(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as the numpy array of its wire bytes."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def pages_to_blobs(kpages, vpages) -> List[bytes]:
    """Pack exported pages (CPU tensors ``[L, nb, bs, H, hd]`` in the
    pool's dtype, or ``(int8 values, f32 scales [L, nb, bs, H])`` tuples)
    into one ``bytes`` blob per block: K leaves then V leaves, each
    C-contiguous, the JAX package's ``pages_to_blobs`` byte for byte.
    Each blob is exactly the pool's ``bytes_per_block`` long."""
    leaves = [*(kpages if isinstance(kpages, tuple) else (kpages,)),
              *(vpages if isinstance(vpages, tuple) else (vpages,))]
    arrays = [_wire(t.cpu()) for t in leaves]
    return [b"".join(np.ascontiguousarray(a[:, j]).tobytes()
                     for a in arrays)
            for j in range(arrays[0].shape[1])]


def blobs_to_pages(blobs: List[bytes], *, num_layers: int,
                   block_size: int, num_heads: int, head_dim: int,
                   quantized: bool, dtype=torch.float32):
    """Rebuild ``(kpages, vpages)`` (CPU tensors, as
    :meth:`PagedKVCache.export_pages` gives them) from per-block blobs,
    given the receiving pool's own geometry and dtype. A blob of another
    length means the two pools disagree and is refused (ValueError), as
    is an empty hand-off."""
    if not blobs:
        raise ValueError("handoff carries zero page blobs")
    L, bs, H, hd = num_layers, block_size, num_heads, head_dim
    specs = ([((L, bs, H, hd), torch.int8), ((L, bs, H), torch.float32)]
             if quantized else [((L, bs, H, hd), dtype)])
    if any(d not in _WIRE for _, d in specs):
        raise ValueError(f"no wire format for pool dtype {dtype}")
    sizes = [int(np.prod(shape)) * np.dtype(_WIRE[d]).itemsize
             for shape, d in specs]
    per_blob = 2 * sum(sizes)
    cols: List[List[np.ndarray]] = [[] for _ in range(2 * len(specs))]
    for blob in blobs:
        if len(blob) != per_blob:
            raise ValueError(
                f"handoff blob is {len(blob)} bytes but this pool's "
                f"geometry expects {per_blob} — replica pool shapes "
                f"disagree")
        off = 0
        for i, col in enumerate(cols):
            shape, d = specs[i % len(specs)]
            col.append(np.frombuffer(blob, dtype=_WIRE[d],
                                     count=int(np.prod(shape)),
                                     offset=off).reshape(shape))
            off += sizes[i % len(specs)]

    def leaf(i):
        t = torch.from_numpy(np.stack(cols[i], axis=1))
        return t.view(torch.bfloat16) if specs[i % len(specs)][1] \
            == torch.bfloat16 else t

    n = len(specs)
    k = tuple(leaf(i) for i in range(n))
    v = tuple(leaf(n + i) for i in range(n))
    return (k, v) if quantized else (k[0], v[0])


# ---------------------------------------------------------------------------
# host side
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Refcounted FIFO free list over block ids ``1..num_blocks-1``.

    ``alloc`` hands out blocks at refcount 1, ``incref`` adds an owner (a
    prefix-cache hit), ``decref`` frees a block exactly once — when its
    last owner drops it. ``decref(block, retain=True)`` parks a
    last-owner block in the retained LRU instead: its pages stay
    reachable through the prefix cache, and ``alloc`` recycles retained
    blocks (oldest first, through ``reclaim_hook``) only when the free
    list runs dry. ``incref`` of a retained block revives it at
    refcount 1."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least one non-null block")
        self.num_blocks = num_blocks
        self._free = collections.deque(range(1, num_blocks))
        self._rc: Dict[int, int] = {}
        # rc == 0 for every member; insertion order = LRU order
        self._retained: "collections.OrderedDict[int, bool]" = \
            collections.OrderedDict()
        self.reclaim_hook = None
        self.retained_reclaims = 0
        self.total_allocs = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_retained(self) -> int:
        return len(self._retained)

    @property
    def reclaimable(self) -> int:
        """Free plus lazily reclaimable retained blocks."""
        return len(self._free) + len(self._retained)

    def is_retained(self, block: int) -> bool:
        """Whether ``block`` parks in the retained LRU (no owner, its
        prefix registration kept)."""
        return block in self._retained

    def ref_count(self, block: int) -> int:
        return self._rc.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` block ids at refcount 1, or None (and no change)."""
        if n > self.reclaimable:
            return None
        while len(self._free) < n:
            blk, _ = self._retained.popitem(last=False)
            if self.reclaim_hook is not None:
                self.reclaim_hook(blk)
            self._free.append(blk)
            self.retained_reclaims += 1
        got = [self._free.popleft() for _ in range(n)]
        for b in got:
            self._rc[b] = 1
        self.total_allocs += len(got)
        return got

    def incref(self, block: int) -> bool:
        """One more owner; True when the block was revived out of the
        retained LRU."""
        assert block != NULL_BLOCK, "cannot adopt the null block"
        if block in self._retained:
            del self._retained[block]
            self._rc[block] = 1
            return True
        assert self._rc.get(block, 0) > 0, \
            f"incref of unallocated block {block}"
        self._rc[block] += 1
        return False

    def decref(self, block: int, retain: bool = False) -> bool:
        """Drop one owner; True when it was the last (the block went to
        the free list, or to the retained LRU with ``retain``)."""
        assert block != NULL_BLOCK, "cannot free the null block"
        rc = self._rc.get(block, 0)
        assert rc > 0, f"decref of free block {block} (double free)"
        if rc > 1:
            self._rc[block] = rc - 1
            return False
        del self._rc[block]
        if retain:
            self._retained[block] = True
        else:
            self._free.append(block)
        return True

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            self.decref(b)


@dataclasses.dataclass
class PrefixMatch:
    """The blocks to adopt (table order) and the tokens they cover;
    ``partial`` marks the last block as the donor's partial boundary
    block, which the sharer must fork before writing into it."""
    blocks: List[int]
    length: int
    partial: bool = False

    @property
    def hit_blocks(self) -> int:
        return len(self.blocks)


class PrefixCache:
    """Content-addressed index of resident prompt-prefix blocks. Keys are
    cumulative: ``h_i = (h_{i-1}, tokens of block i)``, so a hit means the
    whole prefix matches. Full blocks map ``h_i -> block``; a prompt's
    partial boundary block maps ``(h_parent, tail) -> block`` and is only
    shared on an exact tail match. The cache holds no references: an
    entry is dropped the moment its block is freed or reclaimed."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._full: Dict[Tuple, int] = {}
        self._partial: Dict[Tuple, int] = {}
        self._by_block: Dict[int, List[Tuple[str, Tuple]]] = {}

    def __len__(self) -> int:
        """Registered entries: full-block chains plus partial tails."""
        return len(self._full) + len(self._partial)

    @staticmethod
    def _chain(parent, chunk) -> Tuple:
        return (parent, tuple(int(t) for t in chunk))

    def match(self, tokens: List[int]) -> PrefixMatch:
        """Longest resident prefix: full-block chain hits, then an
        exact-tail partial hit."""
        bs = self.block_size
        blocks: List[int] = []
        parent: Tuple = ()
        nf = len(tokens) // bs
        for i in range(nf):
            key = self._chain(parent, tokens[i * bs:(i + 1) * bs])
            b = self._full.get(key)
            if b is None:
                break
            blocks.append(b)
            parent = key
        matched = len(blocks) * bs
        rem = tokens[matched:]
        if len(blocks) == nf and rem:
            pb = self._partial.get(self._chain(parent, rem))
            if pb is not None:
                return PrefixMatch(blocks + [pb], len(tokens), partial=True)
        return PrefixMatch(blocks, matched)

    def register(self, tokens: List[int], blocks: List[int]) -> int:
        """Publish a prefilled prompt's blocks; the first writer wins.
        Returns the number of new entries."""
        bs = self.block_size
        added = 0
        parent: Tuple = ()
        nf = len(tokens) // bs
        for i in range(nf):
            key = self._chain(parent, tokens[i * bs:(i + 1) * bs])
            if key not in self._full:
                self._full[key] = blocks[i]
                self._by_block.setdefault(blocks[i], []).append(
                    ("full", key))
                added += 1
            parent = key
        rem = tokens[nf * bs:]
        if rem and nf < len(blocks):
            key = self._chain(parent, rem)
            if key not in self._partial:
                self._partial[key] = blocks[nf]
                self._by_block.setdefault(blocks[nf], []).append(
                    ("partial", key))
                added += 1
        return added

    def covers(self, block: int) -> bool:
        return block in self._by_block

    def invalidate_block(self, block: int) -> None:
        for kind, key in self._by_block.pop(block, ()):
            table = self._full if kind == "full" else self._partial
            if table.get(key) == block:
                del table[key]


class PagedKVCache:
    """Device pools ``k``/``v`` plus the host tables ``[max_slots,
    max_blocks_per_seq]`` and lengths ``[max_slots]`` for up to
    ``max_slots`` sequences. With ``kv_dtype`` ``None``/``"f32"`` each
    pool is ``[L, N, bs, H, hd]`` at ``dtype`` (``torch.float32`` or
    ``torch.bfloat16``); with ``"int8"`` it is the tuple ``(int8 [L, N,
    bs, H, hd], f32 scales [L, N, bs, H])`` and ``dtype`` is not used. The
    pools live on ``device``, the card unless the caller passes
    ``"cpu"`` (:func:`~paddle_tpu_torch.core.device.resolve_device`)."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 num_blocks: int, block_size: int, max_slots: int,
                 max_blocks_per_seq: int, dtype=torch.float32,
                 share_prefix: bool = False, kv_dtype: Optional[str] = None,
                 retain_prefix: bool = True, device="cuda"):
        if kv_dtype not in (None, "f32", "float32", "int8"):
            raise ValueError(f"kv_dtype must be None|'f32'|'int8', "
                             f"got {kv_dtype!r}")
        if kv_dtype != "int8" and dtype not in (torch.float32,
                                                torch.bfloat16):
            raise ValueError(f"pool dtype must be torch.float32 or "
                             f"torch.bfloat16, got {dtype}")
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_slots = max_slots
        self.max_blocks_per_seq = max_blocks_per_seq
        self.dtype = dtype
        self.quantized = kv_dtype == "int8"
        device = resolve_device(device)
        shape = (num_layers, num_blocks, block_size, num_heads, head_dim)
        if self.quantized:
            def pool():
                return (torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=device))
        else:
            def pool():
                return torch.zeros(shape, dtype=dtype, device=device)
        self.k = pool()
        self.v = pool()
        self.device = device
        self.allocator = BlockAllocator(num_blocks)
        self.tables = np.zeros((max_slots, max_blocks_per_seq), np.int32)
        self.lengths = np.zeros((max_slots,), np.int32)
        # the persistent device mirror of tables and lengths that the
        # serving programs (CUDA graphs on the card) read
        self._mirror = StagedInts({"tables": (max_slots, max_blocks_per_seq),
                                   "lengths": (max_slots,)}, device)
        self._owned: List[List[int]] = [[] for _ in range(max_slots)]
        # table indices this slot ADOPTED, and its reserved fork target
        self._adopted: List[set] = [set() for _ in range(max_slots)]
        self._fork_reserve: List[Optional[int]] = [None] * max_slots
        self.prefix_cache = PrefixCache(block_size) if share_prefix \
            else None
        self.retain_prefix = bool(retain_prefix and share_prefix)
        if self.prefix_cache is not None:
            self.allocator.reclaim_hook = \
                self.prefix_cache.invalidate_block
        self.prefix_hit_blocks = 0
        self.cow_forks = 0
        self.retained_hits = 0

    @property
    def quant_dtype(self) -> str:
        return "int8" if self.quantized else str(self.dtype).split(".")[-1]

    @property
    def kv_bytes_per_token(self) -> int:
        """Device bytes one resident token costs across all layers, K and
        V: ``hd`` int8 values plus one f32 scale per head when quantized,
        ``hd`` elements of ``dtype`` otherwise."""
        if self.quantized:
            per_head = self.head_dim * 1 + 4
        else:
            per_head = self.head_dim * self.dtype.itemsize
        return 2 * self.num_layers * self.num_heads * per_head

    @property
    def bytes_per_block(self) -> int:
        """Device bytes one pool block costs (both pools, scales
        included)."""
        return self.kv_bytes_per_token * self.block_size

    def export_pages(self, slot: int):
        """Read out the pages covering ``slot``'s length for a hand-off:
        ``(block_ids, kpages, vpages)``, the pages CPU tensors ``[L, nb,
        bs, H, hd]`` in the pool's dtype (``(values, scales)`` tuples for
        int8 pools) in table order. Block ids do not travel: the receiver
        places the pages at its own blocks. A shared block exports like
        any other (a read); the reservation past the length does not."""
        nb = self.blocks_needed(int(self.lengths[slot]))
        ids = [int(b) for b in self.tables[slot, :nb]]
        sel = torch.tensor(ids, dtype=torch.long, device=self.device)

        def take(pool):
            if isinstance(pool, tuple):
                return tuple(t[:, sel].cpu() for t in pool)
            return pool[:, sel].cpu()

        return ids, take(self.k), take(self.v)

    def import_pages(self, slot: int, kpages, vpages, length: int,
                     reserve_len: Optional[int] = None) -> bool:
        """Adopt handed-off pages into the empty ``slot``: allocate blocks
        for ``max(length, reserve_len)`` tokens (the whole decode
        reservation), write the pages at this pool's own block ids (cast
        to the pool's dtype, as JAX's ``jnp.asarray(pages, dtype)``) and
        set the length. False, and nothing changed, when the pool cannot
        supply the blocks."""
        assert not self._owned[slot], "import_pages on a non-empty slot"
        target = max(int(length), int(reserve_len or 0))
        if not self.ensure_capacity(slot, target):
            return False
        nb = self.blocks_needed(int(length))
        sel = torch.tensor(self._owned[slot][:nb], dtype=torch.long,
                           device=self.device)

        def put(pool, pages):
            for t, p in zip(pool if isinstance(pool, tuple) else (pool,),
                            pages if isinstance(pages, tuple) else (pages,)):
                t[:, sel] = p.to(device=t.device, dtype=t.dtype)

        put(self.k, kpages)
        put(self.v, vpages)
        self.lengths[slot] = int(length)
        return True

    def copy_block(self, src: int, dst: int) -> None:
        """Copy pool block ``src`` to ``dst`` in every layer of both pools,
        scale pages with their values (the copy-on-write fork)."""
        for pool in (self.k, self.v):
            for t in (pool if isinstance(pool, tuple) else (pool,)):
                t[:, dst] = t[:, src]

    @property
    def context_width(self) -> int:
        """Per-slot context capacity ``max_blocks_per_seq * block_size``."""
        return self.max_blocks_per_seq * self.block_size

    @property
    def free_blocks(self) -> int:
        """Spare capacity including retained (reclaimable) blocks."""
        return self.allocator.reclaimable

    @property
    def retained_blocks(self) -> int:
        return self.allocator.num_retained

    def blocks_needed(self, length: int) -> int:
        return -(-length // self.block_size)

    def owned_count(self, slot: int) -> int:
        return len(self._owned[slot])

    def ensure_capacity(self, slot: int, new_len: int) -> bool:
        """Grow ``slot``'s table to cover ``new_len`` tokens; False (and
        no change) when the pool cannot supply the blocks."""
        if new_len > self.context_width:
            raise ValueError(f"length {new_len} exceeds slot capacity "
                             f"{self.context_width}")
        need = self.blocks_needed(new_len) - len(self._owned[slot])
        if need <= 0:
            return True
        got = self.allocator.alloc(need)
        if got is None:
            return False
        start = len(self._owned[slot])
        self._owned[slot].extend(got)
        self.tables[slot, start:start + len(got)] = got
        return True

    def free_slot(self, slot: int) -> None:
        """Decref ``slot``'s blocks in reverse table order (a retained
        chain's tail is then older in the LRU than its root) and clear
        the row. Pool contents are not wiped: they are always masked by
        the length."""
        for b in reversed(self._owned[slot]):
            self._decref(b)
        if self._fork_reserve[slot] is not None:
            self._decref(self._fork_reserve[slot])
            self._fork_reserve[slot] = None
        self._owned[slot] = []
        self._adopted[slot] = set()
        self.tables[slot] = NULL_BLOCK
        self.lengths[slot] = 0

    def _decref(self, block: int) -> bool:
        retain = (self.retain_prefix and self.prefix_cache is not None
                  and self.prefix_cache.covers(block))
        dropped = self.allocator.decref(block, retain=retain)
        if dropped and not retain and self.prefix_cache is not None:
            self.prefix_cache.invalidate_block(block)
        return dropped

    # -- copy-on-write prefix sharing --------------------------------------
    #
    # The slot that allocated a block writes it in place; a slot that
    # adopted it through the prefix cache forks before its first write.
    # Only an exact-duplicate prompt's partial boundary block is ever in
    # that position, so admission reserves one fork block for it.

    def match_prefix(self, tokens: List[int]) -> Optional[PrefixMatch]:
        if self.prefix_cache is None:
            return None
        return self.prefix_cache.match(tokens)

    def adopt_prefix(self, slot: int, match: PrefixMatch) -> None:
        """Map ``match``'s blocks into the empty ``slot`` by reference;
        a partial match also reserves the fork target."""
        assert not self._owned[slot], "adopt_prefix on a non-empty slot"
        for i, b in enumerate(match.blocks):
            if self.allocator.incref(b):
                self.retained_hits += 1
            self.tables[slot, i] = b
        self._owned[slot] = list(match.blocks)
        self._adopted[slot] = set(range(len(match.blocks)))
        self.prefix_hit_blocks += len(match.blocks)
        if match.partial:
            got = self.allocator.alloc(1)
            if got is None:
                self.free_slot(slot)
                raise RuntimeError(
                    f"KV pool exhausted reserving the COW fork block for "
                    f"slot {slot} — gate admissions on can_admit()")
            self._fork_reserve[slot] = got[0]

    def register_prefix(self, slot: int, tokens: List[int]) -> int:
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.register(tokens, self._owned[slot])

    def cow_targets(self, slot: int, lo: int, hi: int) -> List[int]:
        """Table indices of ``slot``'s adopted, still shared blocks that
        cover write positions ``[lo, hi]``; an adopted block whose
        co-owners all left is promoted to write-in-place."""
        bs = self.block_size
        out = []
        for i in sorted(self._adopted[slot]):
            if not lo // bs <= i <= hi // bs:
                continue
            if self.allocator.ref_count(self._owned[slot][i]) > 1:
                out.append(i)
            else:
                self._adopted[slot].discard(i)
        return out

    def fork_block(self, slot: int, index: int) -> Tuple[int, int]:
        """Point ``slot``'s entry ``index`` at its reserved fork block (or
        a fresh one) and decref the shared original. Returns ``(src,
        dst)``; the caller copies the pages."""
        src = self._owned[slot][index]
        dst = self._fork_reserve[slot]
        if dst is None:
            got = self.allocator.alloc(1)
            if got is None:
                raise RuntimeError(
                    f"KV pool exhausted forking shared block {src} for "
                    f"slot {slot} — admission must reserve fork headroom")
            dst = got[0]
        else:
            self._fork_reserve[slot] = None
        self._owned[slot][index] = dst
        self.tables[slot, index] = dst
        self._adopted[slot].discard(index)
        self._decref(src)
        self.cow_forks += 1
        return src, dst

    def device_tables(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Copy the host tables and lengths into their persistent int32
        device mirror (one non-blocking copy from a pinned stage on the
        card) and return the mirror ``(tables [S, MB], lengths [S])``: the
        same two tensors on every call, which a captured graph reads at
        fixed addresses. The copy is a snapshot: host edits after it reach
        the device at the next call."""
        self._mirror.stage(tables=self.tables, lengths=self.lengths)
        return self.mirror()

    def mirror(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device mirror ``(tables, lengths)`` as the last
        :meth:`device_tables` left it, without a copy: what a serving
        program's body reads."""
        return self._mirror.dev["tables"], self._mirror.dev["lengths"]
