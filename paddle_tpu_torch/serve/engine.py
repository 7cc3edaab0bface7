"""The decode engine — the port of ``DecodeEngine`` from
``paddle_tpu/serve/engine.py`` for greedy single-device serving.

Two entry points serve any number of concurrent ragged requests:

- **prefill**: one-shot at the fixed padded width ``[1, W]`` (``W`` = the
  per-slot context capacity), scattering rows ``[shared, P)`` of every
  layer's K/V into the slot's blocks and taking the first token from
  logits row ``P - 1``; or, with ``prefill_chunk=C``, ``ceil(P / C)``
  span calls of ``C`` tokens each that the scheduler interleaves with
  decode ticks;
- the **decode tick** at the fixed slot count ``[S]``: every active slot
  appends its pending token and gets the greedy next one; inactive lanes
  are masked. With ``speculative=k`` the tick appends the pending token
  plus ``k`` n-gram self-drafted guesses, verifies them in one span call
  and retires the longest draft prefix the model reproduced plus the
  model's own next token — the same stream as the plain tick.

Copy-on-write prefix sharing (``share_prefix=True``): admission maps
every resident full-block prefix hit into the slot's table by reference;
an exact-duplicate prompt also shares its partial boundary block and forks
it (one-block device copy, scale pages included) before the first write
there. With ``retain_prefix`` the evicted registered blocks park in a
retained LRU. ``kv_dtype="int8"`` keeps the pools as int8 values with f32
row scales.

The JAX engine compiled its two programs once and donated the KV pools to
them; here PyTorch runs eagerly and the pools are updated in place.
:meth:`launch_counts` reads the kernel wrappers' launch counters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..nn import cuda_attention
from .kv_cache import PagedKVCache, layer_pool, scatter_prefill_pages

__all__ = ["DecodeEngine", "AdmitProbe"]


@dataclasses.dataclass
class AdmitProbe:
    """Admission verdict: ``reason`` is the first failing constraint —
    ``"width"`` (never clears), ``"slots"`` (clears at the next eviction)
    or ``"blocks"`` (pool saturation). ``free_blocks`` counts reclaimable
    capacity (free plus retained); ``raw_free_blocks`` the free list
    alone."""
    ok: bool
    reason: Optional[str]
    blocks_needed: int
    free_blocks: int
    free_slots: int
    raw_free_blocks: int = 0
    retained_blocks: int = 0


class DecodeEngine:
    """Serving runtime for a :class:`~paddle_tpu_torch.models.
    TransformerLM`.

    Args:
      model: the TransformerLM, already on ``device``.
      max_slots: decode batch width S, the most concurrent sequences.
      block_size: KV tokens per pool block.
      num_blocks: pool size (default: every slot at full context, plus
        the null block).
      max_blocks_per_seq: per-slot table width (default
        ``model.max_len // block_size``); the slot capacity
        ``max_blocks_per_seq * block_size`` must stay within
        ``model.max_len``.
      attention: ``"paged"`` (the paged-decode and paged-span kernels;
        their plain versions for CPU tensors) or ``"xla"`` (gather +
        masked softmax, one query row at a time).
      share_prefix / retain_prefix: copy-on-write prefix sharing and
        retention of evicted prefix blocks.
      speculative: n-gram self-drafted tokens verified per tick (0 =
        off); greedy verification keeps the token stream of the plain
        tick.
      prefill_chunk: prefill chunk width C (None = one-shot prefill at
        the full width); a prompt of P tokens prefills in ``ceil(P / C)``
        span calls.
      kv_dtype: ``None``/``"f32"`` (f32 pools) or ``"int8"`` (int8 values
        and f32 row scales, dequantized by the consumer).
      device: where the pools live (default ``"cuda"``); must match the
        model's parameters.
    """

    def __init__(self, model, *, max_slots: int = 4, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 max_blocks_per_seq: Optional[int] = None,
                 attention: str = "paged", share_prefix: bool = True,
                 retain_prefix: bool = True, speculative: int = 0,
                 prefill_chunk: Optional[int] = None,
                 kv_dtype: Optional[str] = None, device="cuda"):
        want = resolve_device(device)
        self.device = next(model.parameters()).device
        if self.device.type != want.type:
            raise ValueError(f"model parameters are on {self.device}, the "
                             f"engine was asked for {want}")
        if attention not in ("paged", "xla"):
            raise ValueError(f"attention must be 'paged'|'xla', "
                             f"got {attention!r}")
        if speculative < 0:
            raise ValueError(f"speculative must be >= 0, got {speculative}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        self.model = model
        self.attention = attention
        self.speculative = int(speculative)
        self.prefill_chunk = prefill_chunk
        attn = model.blocks[0].attn
        if max_blocks_per_seq is None:
            max_blocks_per_seq = max(1, model.max_len // block_size)
        if max_blocks_per_seq * block_size > model.max_len:
            raise ValueError(
                f"slot capacity {max_blocks_per_seq * block_size} exceeds "
                f"model.max_len={model.max_len} (positions are embedded)")
        if num_blocks is None:
            num_blocks = max_slots * max_blocks_per_seq + 1
        self.cache = PagedKVCache(
            len(model.blocks), attn.num_heads, attn.head_dim, num_blocks,
            block_size, max_slots=max_slots,
            max_blocks_per_seq=max_blocks_per_seq,
            share_prefix=share_prefix, kv_dtype=kv_dtype,
            retain_prefix=retain_prefix, device=self.device)
        self.max_slots = max_slots
        self.active = np.zeros((max_slots,), bool)
        self.tokens = np.zeros((max_slots,), np.int32)   # next to decode
        # per-slot token history (prompt + accepted tokens), the drafter's
        # corpus, with bigram/token -> (latest, previous-latest) index
        # maps kept on append so a proposal is O(k)
        self.history: List[List[int]] = [[] for _ in range(max_slots)]
        self._bigram_idx: List[Dict] = [{} for _ in range(max_slots)]
        self._unigram_idx: List[Dict] = [{} for _ in range(max_slots)]
        # prefilling slots: slot -> prompt, cursor, shared_len, staged
        self._prefilling: Dict[int, Dict[str, Any]] = {}
        self.ticks = 0
        self.tokens_generated = 0
        self.prefills = 0                # completed prefills
        self.prefill_chunks = 0          # prefill calls (chunks)
        self.draft_proposed = 0
        self.draft_accepted = 0
        self.slot_stats: List[Dict[str, int]] = [{} for _ in
                                                 range(max_slots)]
        # the tokens each slot retired in the last tick (one for the plain
        # tick, up to 1 + k under speculation) — the scheduler's view
        self.last_accepted: Dict[int, List[int]] = {}
        self._W = self.cache.context_width
        self._K1 = 1 + self.speculative

    @property
    def context_width(self) -> int:
        return self._W

    @staticmethod
    def launch_counts() -> Dict[str, int]:
        """Hand-written kernel launches (flash prefill, paged decode,
        paged span, plain and int8) since the counters were last reset."""
        return cuda_attention.launch_counts()

    def free_slots(self) -> List[int]:
        return [s for s in range(self.max_slots)
                if not self.active[s] and s not in self._prefilling]

    def admit_probe(self, total_len: int,
                    include_slots: bool = True) -> AdmitProbe:
        """The first failing admission constraint for a sequence that may
        grow to ``total_len`` tokens, in never-clears-first order. Prefix
        hits are ignored: the probe is the no-sharing bound, so an
        admitted request can never strand mid-decode."""
        blocks_needed = self.cache.blocks_needed(total_len)
        free_slots = len(self.free_slots())
        reclaimable = self.cache.free_blocks
        if total_len > self._W:
            reason = "width"
        elif include_slots and free_slots == 0:
            reason = "slots"
        elif blocks_needed > reclaimable:
            reason = "blocks"
        else:
            reason = None
        return AdmitProbe(ok=reason is None, reason=reason,
                          blocks_needed=blocks_needed,
                          free_blocks=reclaimable, free_slots=free_slots,
                          raw_free_blocks=self.cache.allocator.num_free,
                          retained_blocks=self.cache.retained_blocks)

    def can_admit(self, total_len: int) -> bool:
        """Whether the pool can host a sequence of up to ``total_len``
        tokens (slot availability excluded)."""
        return self.admit_probe(total_len, include_slots=False).ok

    # -- request lifecycle -------------------------------------------------

    def stage_prompt(self, prompt: List[int]) -> np.ndarray:
        """The prompt padded to the fixed prefill width ``[1, W]``; a
        chunked engine takes the raw ids ``[1, P]`` (it builds each
        ``C``-token chunk at prefill time)."""
        P = len(prompt)
        if not 0 < P <= self._W:
            raise ValueError(f"prompt length {P} not in [1, {self._W}]")
        if self.prefill_chunk is not None:
            return np.asarray([prompt], np.int32)
        ids = np.zeros((1, self._W), np.int32)
        ids[0, :P] = prompt
        return ids

    def _reserve(self, slot: int, prompt: List[int],
                 reserve_len: Optional[int]) -> Dict[str, int]:
        """Prefix-cache adoption plus the worst-case block reservation."""
        P = len(prompt)
        target = max(P, reserve_len or P)
        match = self.cache.match_prefix(prompt)
        shared_len, hit_blocks = 0, 0
        if match is not None and match.blocks:
            self.cache.adopt_prefix(slot, match)
            shared_len, hit_blocks = match.length, match.hit_blocks
        if not self.cache.ensure_capacity(slot, target):
            self.cache.free_slot(slot)
            raise RuntimeError(
                f"KV pool exhausted admitting slot {slot} "
                f"(need {self.cache.blocks_needed(target)} blocks, "
                f"{self.cache.free_blocks} free) — gate admissions on "
                f"can_admit()")
        stats = {"prefix_hit_blocks": hit_blocks, "shared_len": shared_len,
                 "blocks_reserved": self.cache.owned_count(slot),
                 "cow_forks": 0, "prefill_chunks": 0,
                 "draft_proposed": 0, "draft_accepted": 0}
        self.slot_stats[slot] = stats
        return stats

    def admit(self, slot: int, prompt: List[int],
              reserve_len: Optional[int] = None,
              staged: Optional[np.ndarray] = None) -> int:
        """Prefill ``prompt`` into ``slot`` and return the first token;
        ``reserve_len`` reserves blocks for the sequence's full growth. A
        chunked engine runs every chunk here; the scheduler interleaves
        them with ticks instead."""
        self.begin_prefill(slot, prompt, reserve_len=reserve_len,
                           staged=staged)
        while True:
            tok = self.prefill_step(slot)
            if tok is not None:
                return tok

    def begin_prefill(self, slot: int, prompt: List[int],
                      reserve_len: Optional[int] = None,
                      staged: Optional[np.ndarray] = None) -> None:
        """Reserve ``slot`` for ``prompt`` and queue its prefill."""
        assert not self.active[slot], f"slot {slot} is occupied"
        assert slot not in self._prefilling, f"slot {slot} is prefilling"
        P = len(prompt)
        if not 0 < P <= self._W:
            raise ValueError(f"prompt length {P} not in [1, {self._W}]")
        shared = self._reserve(slot, prompt, reserve_len)["shared_len"]
        # an exact-duplicate prompt shares every block; still re-attend
        # the final position (writes masked) for the first-token logits
        self._prefilling[slot] = {"prompt": list(prompt),
                                  "cursor": min(shared, P - 1),
                                  "shared_len": shared, "staged": staged}

    @torch.no_grad()
    def prefill_step(self, slot: int) -> Optional[int]:
        """Run one prefill call for a :meth:`begin_prefill`'d slot: the
        whole prompt, or its next ``C``-token chunk. Returns the first
        generated token when the prompt is done (the slot is then live
        for decode ticks), else None."""
        st = self._prefilling[slot]
        prompt, P = st["prompt"], len(st["prompt"])
        dev = self.device
        table = torch.tensor(self.cache.tables[slot:slot + 1], device=dev)
        shared = torch.tensor([st["shared_len"]], device=dev)
        if self.prefill_chunk is None:
            ids = st["staged"] if st["staged"] is not None \
                else self.stage_prompt(prompt)
            logits, (ks, vs) = self.model.prefill(
                torch.as_tensor(ids, dtype=torch.long, device=dev))
            length = torch.tensor([P], device=dev)
            for layer in range(self.cache.num_layers):
                scatter_prefill_pages(layer_pool(self.cache.k, layer),
                                      ks[layer], table, length, shared)
                scatter_prefill_pages(layer_pool(self.cache.v, layer),
                                      vs[layer], table, length, shared)
            last = logits[0, P - 1]
            st["cursor"] = P
        else:
            C, cur = self.prefill_chunk, st["cursor"]
            n = min(C, P - cur)
            ids = np.zeros((1, C), np.int64)
            ids[0, :n] = prompt[cur:cur + n]
            logits, _ = self.model.decode_span(
                torch.as_tensor(ids, device=dev),
                (self.cache.k, self.cache.v, table),
                torch.tensor([cur], dtype=torch.int32, device=dev),
                torch.tensor([n], dtype=torch.int32, device=dev),
                torch.ones(1, dtype=torch.bool, device=dev),
                attn_impl=self.attention, write_from=shared)
            last = logits[0, n - 1]
            st["cursor"] = cur + n
        self.slot_stats[slot]["prefill_chunks"] += 1
        self.prefill_chunks += 1
        if st["cursor"] < P:
            return None
        del self._prefilling[slot]
        tok = int(torch.argmax(last))
        self.prefills += 1
        self.cache.lengths[slot] = P
        self.active[slot] = True
        self.tokens[slot] = tok
        self.history[slot] = []
        self._bigram_idx[slot] = {}
        self._unigram_idx[slot] = {}
        self._history_append(slot, list(prompt) + [tok])
        self.cache.register_prefix(slot, prompt)
        return tok

    def evict(self, slot: int) -> None:
        """Free ``slot``'s blocks (shared blocks survive until their last
        owner lets go); the lane masks off at the next tick."""
        self.cache.free_slot(slot)
        self.active[slot] = False
        self.tokens[slot] = 0
        self.history[slot] = []
        self._bigram_idx[slot] = {}
        self._unigram_idx[slot] = {}
        self._prefilling.pop(slot, None)

    # -- speculation -------------------------------------------------------

    def _history_append(self, slot: int, toks: List[int]) -> None:
        """Append accepted tokens to the slot's history and keep the
        drafter's occurrence maps current (each key holds its latest and
        previous-latest index)."""
        h = self.history[slot]
        big, uni = self._bigram_idx[slot], self._unigram_idx[slot]
        for t in toks:
            h.append(t)
            j = len(h) - 1
            if j >= 1:
                key = (h[j - 1], t)
                big[key] = (j - 1, big.get(key, (None,))[0])
            uni[t] = (j, uni.get(t, (None,))[0])

    def _propose_drafts(self, slot: int) -> List[int]:
        """N-gram self-drafting (prompt-lookup decoding): the continuation
        of the most recent earlier occurrence of the history's tail bigram
        (else its last token), padded with the last proposed or known
        token. A wrong draft costs only a masked verify row."""
        k = self.speculative
        h = self.history[slot]
        cont: List[int] = []
        if len(h) >= 2:
            cur, *prev = self._bigram_idx[slot].get((h[-2], h[-1]),
                                                    (None, None))
            i = prev[0] if cur == len(h) - 2 else cur
            if i is not None:
                cont = h[i + 2:i + 2 + k]
        if not cont and h:
            cur, *prev = self._unigram_idx[slot].get(h[-1], (None, None))
            i = prev[0] if cur == len(h) - 1 else cur
            if i is not None:
                cont = h[i + 1:i + 1 + k]
        pad = cont[-1] if cont else h[-1]
        return (cont + [pad] * k)[:k]

    # -- the tick ----------------------------------------------------------

    def _pre_tick_guard(self) -> np.ndarray:
        """Each active slot must own the block its next write lands in, and
        an adopted shared block in the write range forks first (the
        copy-on-write point). Returns the live token count per slot ``n
        [S]``: 1 + the drafts that fit the slot's reservation."""
        n = np.zeros((self.max_slots,), np.int32)
        bs = self.cache.block_size
        for slot in np.flatnonzero(self.active):
            p = int(self.cache.lengths[slot])
            need = self.cache.blocks_needed(p + 1)
            owned = self.cache.owned_count(slot)
            if need > owned:
                raise RuntimeError(
                    f"slot {slot} decoding past its reservation (length "
                    f"{p} needs block {need}, owns {owned}) — admit with a "
                    f"larger reserve_len or call cache.ensure_capacity")
            n[slot] = max(1, min(self._K1, owned * bs - p))
            for idx in self.cache.cow_targets(slot, p, p + int(n[slot]) - 1):
                src, dst = self.cache.fork_block(slot, idx)
                self.cache.copy_block(src, dst)
                self.slot_stats[slot]["cow_forks"] += 1
        return n

    @torch.no_grad()
    def decode_tick(self) -> np.ndarray:
        """One decode step over every slot: append each active slot's
        pending token (and, with ``speculative=k``, its drafts) to its KV
        and return the new token front ``[S]`` (inactive lanes 0).
        :attr:`last_accepted` maps each active slot to the tokens it
        retired this tick."""
        n = self._pre_tick_guard()
        tables, lengths = self.cache.device_tables()
        dev = self.device
        active = torch.tensor(self.active, device=dev)
        kv = (self.cache.k, self.cache.v, tables)
        # the pending token, then the drafts
        toks = np.zeros((self.max_slots, self._K1), np.int64)
        toks[:, 0] = self.tokens
        drafted = 0
        if self.speculative == 0:
            logits, _ = self.model.decode_step(
                torch.as_tensor(toks[:, 0], device=dev), kv, lengths, active,
                attn_impl=self.attention)
            nxt = torch.argmax(logits, dim=-1)[:, None]
        else:
            for slot in np.flatnonzero(self.active):
                toks[slot, 1:] = self._propose_drafts(slot)
                drafted += int(n[slot]) - 1
            logits, _ = self.model.decode_span(
                torch.as_tensor(toks, device=dev), kv, lengths,
                torch.as_tensor(n, device=dev), active,
                attn_impl=self.attention)
            nxt = torch.argmax(logits, dim=-1)                # [S, 1+k]
        nxt = nxt.to(torch.int32).cpu().numpy()
        self.last_accepted = {}
        front = np.zeros((self.max_slots,), np.int32)
        retired = accepted_drafts = 0
        for slot in np.flatnonzero(self.active):
            # the longest draft prefix the model reproduced, plus the
            # model's own token after it: the plain tick's stream
            take = 1
            while take < int(n[slot]) \
                    and int(toks[slot, take]) == int(nxt[slot, take - 1]):
                take += 1
            accepted = [int(t) for t in nxt[slot, :take]]
            self.cache.lengths[slot] += take
            self.last_accepted[slot] = accepted
            front[slot] = accepted[-1]
            self._history_append(slot, accepted)
            retired += take
            accepted_drafts += take - 1
            st = self.slot_stats[slot]
            st["draft_proposed"] += int(n[slot]) - 1
            st["draft_accepted"] += take - 1
        self.tokens = front
        self.ticks += 1
        self.tokens_generated += retired
        self.draft_proposed += drafted
        self.draft_accepted += accepted_drafts
        return front.copy()
