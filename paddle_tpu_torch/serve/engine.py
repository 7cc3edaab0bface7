"""The decode engine — the port of ``DecodeEngine`` from
``paddle_tpu/serve/engine.py`` on one device: two programs built once,
serving any number of concurrent ragged requests.

- **prefill**: one-shot at the fixed padded width ``[1, W]`` (``W`` = the
  per-slot context capacity), scattering rows ``[shared, P)`` of every
  layer's K/V into the slot's blocks and taking the first token from
  logits row ``P - 1`` (a device gather); or, with ``prefill_chunk=C``, a
  span call at the fixed chunk width ``[1, C]``, run ``ceil(P / C)``
  times, which the scheduler interleaves with decode ticks;
- the **decode tick** at the fixed slot count ``[S]``: every active slot
  appends its pending token and gets the next one; inactive lanes are
  masked. With ``speculative=k`` the tick is ``[S, 1 + k]``: the pending
  token plus ``k`` n-gram self-drafted guesses verified in one span call.
  Greedy verification retires the longest draft prefix the model
  reproduced plus the model's own next token — the plain tick's stream.

On the card each program is a CUDA graph, captured on first use or by
:meth:`DecodeEngine.warmup` and replayed on every later call: the
counterpart of the JAX engine's two ``jax.jit`` programs, and
:meth:`DecodeEngine.compile_counts` counts the captures. Every per-call
value (ids, lengths, starts, masks, counters, the block tables) reaches
the graph through a device buffer at a fixed address
(:mod:`~paddle_tpu_torch.serve.graphs`); the KV pools are updated in
place. A capture or replay that fails raises: there is no eager path on
the card. On the CPU the same bodies run eagerly on the same buffers.

Sampling is greedy (argmax) by default. ``sampling=SamplingConfig(...)``
draws with temperature / top-k / top-p from per-slot, per-tick keys
(``fold_in(fold_in(PRNGKey(seed), tick), slot)``, computed inside the
graph from a device counter), the JAX package's threefry-2x32 stream bit
for bit. With speculation it verifies by the rejection rule of [S3]: a
draft ``d`` is accepted with probability ``p(d)`` of the filtered target
distribution, a rejection resamples from ``p`` with ``d`` excluded, and a
run of accepted drafts ends in a bonus sample — three key roles (0, 1,
2) folded into each row's key, all in one replay; the host walks the
accept prefix.

Copy-on-write prefix sharing (``share_prefix=True``): admission maps
every resident full-block prefix hit into the slot's table by reference;
an exact-duplicate prompt also shares its partial boundary block and forks
it (one-block device copy, scale pages included, outside any graph)
before the first write there. With ``retain_prefix`` the evicted
registered blocks park in a retained LRU. ``dtype=torch.bfloat16`` keeps
the pools in bf16 (half the bytes a token of f32), ``kv_dtype="int8"`` as
int8 values with f32 row scales.

Prefill/decode disaggregation: :meth:`DecodeEngine.export_slot` packages a
just-prefilled slot (its pages in the pool's dtype, its length and block
count) and :meth:`DecodeEngine.adopt_slot` adopts it into another
engine's free slot, rebuilding the pending token, history, drafter maps
and prefix registration, so the adopting engine's first tick is the one a
colocated engine would run.

:meth:`launch_counts` reads the kernel wrappers' launch counters, which a
replay advances by the launches its capture saw.

Observability, as in the JAX engine: ``telemetry=`` (a
:class:`~paddle_tpu_torch.obs.Telemetry`) gets one ``kind="decode_tick"``
record a tick (wall, active slots, tokens, free blocks, accept rate,
bytes a token, and the sharing and chunk counters as per-tick deltas) and
a ``record_compile("serve_warmup", ...)`` from :meth:`DecodeEngine.
warmup`; the ``tracer`` attribute (a :class:`~paddle_tpu_torch.obs.
Tracer`) gets ``prefill_dispatch`` and ``engine_tick`` spans, the
``metrics`` attribute (a :class:`~paddle_tpu_torch.obs.MetricsHub`) the
engine's tick histogram, counters and gauges. All of it is host work
around a program's launch and fetch, never inside a capture: the graphs,
their replays and their launches are the same with and without it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..nn import cuda_attention
from .graphs import GraphPool, Program
from .kv_cache import PagedKVCache, layer_pool, scatter_prefill_pages
from .sampling import (SamplingConfig, categorical, filter_logits, fold_in,
                       prng_key, sample_tokens, tick_keys, uniform)

__all__ = ["DecodeEngine", "AdmitProbe", "SamplingConfig"]


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
        tick, sampled verification the [S3] rejection rule.
      prefill_chunk: prefill chunk width C (None = one-shot prefill at
        the full width); a prompt of P tokens prefills in ``ceil(P / C)``
        span calls.
      sampling: a :class:`SamplingConfig` for seeded stochastic decoding
        (None = greedy).
      dtype: the pools' dtype, ``torch.float32`` (default) or
        ``torch.bfloat16`` (the scatters round the f32 projections; the
        paged kernels' bf16 branches read them).
      kv_dtype: ``None``/``"f32"`` (pools at ``dtype``) or ``"int8"``
        (int8 values and f32 row scales, dequantized by the consumer;
        ``dtype`` is not used).
      telemetry: optional :class:`~paddle_tpu_torch.obs.Telemetry`; the
        engine emits one ``kind="decode_tick"`` record a tick, and the
        scheduler adds its per-request records through the same object.
      device: where the pools live (default ``"cuda"``); must match the
        model's parameters.

    Dtype policy: the programs run under the policy current when they are
    built, as the JAX engine's jitted programs keep the policy they were
    traced under. On the card that is the capture, at :meth:`warmup` or
    first use: an engine warmed under ``float32`` replays f32 programs
    inside a later ``use_policy(bfloat16_compute)``, and the reverse. So
    warm (or first serve) inside the policy the engine is to run. On the
    CPU the bodies run eagerly and read the policy at every call. The
    pools hold ``dtype`` under either policy (the projections return f32
    and the scatters round them to the pool's dtype).
    """

    def __init__(self, model, *, max_slots: int = 4, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 max_blocks_per_seq: Optional[int] = None,
                 attention: str = "paged", share_prefix: bool = True,
                 retain_prefix: bool = True, speculative: int = 0,
                 prefill_chunk: Optional[int] = None,
                 sampling: Optional[SamplingConfig] = None,
                 telemetry=None, dtype=torch.float32,
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
        if sampling is not None:
            sampling.validate(model.emb.vocab)
        self.model = model
        self.telemetry = telemetry
        # optional Tracer and MetricsHub, assigned by the caller; None
        # costs one attribute test a call
        self.tracer = None
        self.metrics = None
        self._tick_counters: Dict[str, int] = {}
        self._metrics_tick_counters: Dict[str, int] = {}
        self.attention = attention
        self.speculative = int(speculative)
        self.prefill_chunk = prefill_chunk
        self.sampling = sampling
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
            max_blocks_per_seq=max_blocks_per_seq, dtype=dtype,
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

        # the two programs; their per-call values are int32 device buffers
        pool = GraphPool(self.device)
        S, K1 = max_slots, self._K1
        if prefill_chunk is None:
            self._prefill = Program(
                "prefill", self._prefill_body,
                {"ids": (1, self._W), "length": (1,), "start": (1,),
                 "slot": (1,), "counter": (1,)}, pool)
        else:
            self._prefill = Program(
                "prefill", self._chunk_body,
                {"ids": (1, prefill_chunk), "start": (1,), "n": (1,),
                 "write_from": (1,), "slot": (1,), "counter": (1,)}, pool)
        shapes = {"tokens": (S,) if self.speculative == 0 else (S, K1),
                  "n": (S,), "active": (S,), "tick": (1,)}
        if self.speculative == 0:
            del shapes["n"]
        self._tick = Program("tick", self._tick_body, shapes, pool)

    @property
    def context_width(self) -> int:
        return self._W

    @staticmethod
    def launch_counts() -> Dict[str, int]:
        """Hand-written kernel launches (flash prefill, paged decode,
        paged span, over f32, bf16 and int8 pools) since the counters were
        last reset, those of graph replays included."""
        return cuda_attention.launch_counts()

    def compile_counts(self) -> Dict[str, int]:
        """Programs built per entry point: CUDA graphs captured on the
        card, first uses on the CPU. Both 1 after :meth:`warmup` (or the
        first prefill and tick) and for the engine's lifetime after:
        admissions, evictions, adoptions, speculation, chunking, sharing
        and the pool dtype change only the contents of the programs'
        buffers."""
        return {"prefill": self._prefill.builds, "tick": self._tick.builds}

    # -- the programs' bodies ----------------------------------------------
    #
    # Each reads its program's device inputs, the cache's device mirror
    # and the pools, and returns one int32 tensor. Nothing in them reads a
    # device value on the host or copies a host value to the device, so
    # they can be captured.

    def _first_token(self, last: torch.Tensor,
                     counter: torch.Tensor) -> torch.Tensor:
        """``last [1, V]`` -> the first token ``[1]``: argmax, or a draw
        with the key ``fold_in(PRNGKey(seed), counter)``."""
        cfg = self.sampling
        if cfg is None:
            return torch.argmax(last, dim=-1).int()
        key = fold_in(prng_key(cfg.seed), counter)
        return sample_tokens(cfg, last, key).int()

    @staticmethod
    def _row(logits: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """Row ``index [1]`` of ``logits [1, T, V]`` -> ``[1, V]``, gathered
        on the device."""
        idx = index.long()[:, None, None].expand(-1, 1, logits.shape[-1])
        return logits.gather(1, idx)[:, 0]

    def _prefill_body(self) -> torch.Tensor:
        i = self._prefill.inputs.dev
        tables, _ = self.cache.mirror()
        table = tables.index_select(0, i["slot"].long())
        logits, (ks, vs) = self.model.prefill(i["ids"].long())
        for layer in range(self.cache.num_layers):
            scatter_prefill_pages(layer_pool(self.cache.k, layer),
                                  ks[layer], table, i["length"], i["start"])
            scatter_prefill_pages(layer_pool(self.cache.v, layer),
                                  vs[layer], table, i["length"], i["start"])
        return self._first_token(self._row(logits, i["length"] - 1),
                                 i["counter"])

    def _chunk_body(self) -> torch.Tensor:
        i = self._prefill.inputs.dev
        tables, _ = self.cache.mirror()
        table = tables.index_select(0, i["slot"].long())
        logits, _ = self.model.decode_span(
            i["ids"].long(), (self.cache.k, self.cache.v, table),
            i["start"], i["n"], torch.ones_like(i["n"], dtype=torch.bool),
            attn_impl=self.attention, write_from=i["write_from"])
        return self._first_token(self._row(logits, i["n"] - 1),
                                 i["counter"])

    def _tick_body(self) -> torch.Tensor:
        i = self._tick.inputs.dev
        tables, lengths = self.cache.mirror()
        kv = (self.cache.k, self.cache.v, tables)
        active = i["active"] != 0
        cfg = self.sampling
        if self.speculative == 0:
            logits, _ = self.model.decode_step(
                i["tokens"].long(), kv, lengths, active,
                attn_impl=self.attention)
            if cfg is None:
                return torch.argmax(logits, dim=-1).int()
            keys = tick_keys(cfg.seed, i["tick"], self.max_slots)
            return sample_tokens(cfg, logits, keys).int()
        logits, _ = self.model.decode_span(
            i["tokens"].long(), kv, lengths, i["n"], active,
            attn_impl=self.attention)
        if cfg is None:
            return torch.argmax(logits, dim=-1).int()        # [S, 1+k]
        return self._verify_sampled(cfg, logits, i["tokens"].long(),
                                    i["tick"])

    def _verify_sampled(self, cfg, logits, tokens, tick) -> torch.Tensor:
        """The [S3] rejection rule over a verify span, ``logits [S, Q, V]``
        with ``Q = 1 + k`` and ``tokens [S, Q]`` (pending, drafts). Draft
        row ``j``'s proposal is a point mass at ``tokens[:, j + 1]``: it is
        accepted when a uniform ``u`` lands under ``p_j(draft)``, and a
        rejection resamples from ``p_j`` with the draft excluded
        (``norm(max(p - q, 0))``); the bonus is a draw from each row's
        ``p``. Row ``j`` of slot ``s`` draws from ``fold_in(fold_in(key_s,
        j), role)`` with role 0 (the coin), 1 (the resample), 2 (the
        bonus). Returns ``[S, 3k + 1]``: the accept bits ``[S, k]``, the
        resamples ``[S, k]`` and the bonus samples ``[S, 1 + k]``."""
        x = filter_logits(cfg, logits)                       # [S, Q, V]
        S, Q = tokens.shape
        k0, k1 = tick_keys(cfg.seed, tick, S)
        rows = torch.arange(Q, dtype=torch.int64, device=x.device)
        rk = fold_in((k0[:, None], k1[:, None]), rows[None, :])  # [S, Q]

        def role(c, last=Q):
            r0, r1 = fold_in(rk, c)
            return r0[:, :last], r1[:, :last]

        u = uniform(role(0))                                 # [S, Q]
        drafts = tokens[:, 1:, None]                         # [S, k, 1]
        # p_j(draft) as JAX's softmax computes it: exp(x - max) / sum
        e = torch.exp(x[:, :-1] - x[:, :-1].amax(-1, keepdim=True))
        p_draft = (e.gather(-1, drafts) / e.sum(-1, keepdim=True))[..., 0]
        accept = u[:, :-1] < p_draft                         # [S, k]
        res_x = x[:, :-1].scatter(-1, drafts, float("-inf"))
        resample = categorical(role(1, Q - 1), res_x)        # [S, k]
        bonus = categorical(role(2), x)                      # [S, Q]
        return torch.cat([accept.int(), resample.int(), bonus.int()], dim=1)

    # -- warmup ------------------------------------------------------------

    def warmup(self) -> Dict[str, Any]:
        """Build both programs now, before the first request: each runs
        once on all-inactive dummy operands (zero ids, length 1 into slot
        0's all-null table row, every tick lane masked off), so the stray
        writes land only in the null block, and the host counters the keys
        fold (ticks, prefill calls) are left as they were: warmed and
        unwarmed engines emit identical streams. On the card that is each
        program's capture; :meth:`compile_counts` is ``{prefill: 1, tick:
        1}`` after it.

        Returns the start-up breakdown: ``prefill_s``, ``tick_s``,
        ``wall_s`` and ``compile_counts``. The JAX engine's
        ``autotune_trials``, ``autotune_cache_hit``,
        ``xla_cache_entries_added`` and ``xla_cache_hit`` are ``None``:
        the port has no autotuner and no persistent cache of built
        programs yet (a captured graph lives as long as its process)."""
        if self.active.any() or self._prefilling:
            raise RuntimeError("warmup() must run before any admission "
                               "(fresh engine)")
        t0 = time.perf_counter()
        self.cache.device_tables()
        if self.prefill_chunk is None:
            self._prefill.launch(ids=0, length=1, start=0, slot=0,
                                 counter=self._prefill_counter())
        else:
            self._prefill.launch(ids=0, start=0, n=1, write_from=0, slot=0,
                                 counter=self._prefill_counter())
        self._prefill.fetch()
        t1 = time.perf_counter()
        self.cache.device_tables()
        if self.speculative == 0:
            self._tick.launch(tokens=0, active=0, tick=self.ticks)
        else:
            self._tick.launch(tokens=0, n=0, active=0, tick=self.ticks)
        self._tick.fetch()
        t2 = time.perf_counter()
        if self.telemetry is not None:
            self.telemetry.record_compile(
                "serve_warmup", t2 - t0, cache_hit=None,
                autotune_trials=None,
                meta={"warmup": True, "prefill_s": round(t1 - t0, 6),
                      "tick_s": round(t2 - t1, 6)})
        return {"prefill_s": t1 - t0, "tick_s": t2 - t1, "wall_s": t2 - t0,
                "autotune_trials": None, "autotune_cache_hit": None,
                "xla_cache_entries_added": None, "xla_cache_hit": None,
                "compile_counts": self.compile_counts()}

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

    def _prefill_counter(self) -> int:
        """The first-token key's counter of the next prefill call,
        ``1 + prefill_chunks + ticks`` (the JAX engine's
        ``_prefill_key``); greedy engines stage it unused."""
        return 1 + self.prefill_chunks + self.ticks

    def prefill_step(self, slot: int) -> Optional[int]:
        """Run one prefill call for a :meth:`begin_prefill`'d slot: the
        whole prompt, or its next ``C``-token chunk. Returns the first
        generated token when the prompt is done (the slot is then live
        for decode ticks), else None (without waiting for the device)."""
        st = self._prefilling[slot]
        prompt, P = st["prompt"], len(st["prompt"])
        tr0 = self.tracer.now_us() if self.tracer is not None else None
        self.cache.device_tables()
        if self.prefill_chunk is None:
            ids = st["staged"] if st["staged"] is not None \
                else self.stage_prompt(prompt)
            self._prefill.launch(ids=ids, length=P, start=st["shared_len"],
                                 slot=slot, counter=self._prefill_counter())
            st["cursor"] = P
        else:
            C, cur = self.prefill_chunk, st["cursor"]
            n = min(C, P - cur)
            ids = np.zeros((1, C), np.int32)
            ids[0, :n] = prompt[cur:cur + n]
            self._prefill.launch(ids=ids, start=cur, n=n,
                                 write_from=st["shared_len"], slot=slot,
                                 counter=self._prefill_counter())
            st["cursor"] = cur + n
        self.slot_stats[slot]["prefill_chunks"] += 1
        self.prefill_chunks += 1
        if tr0 is not None:
            self.tracer.complete("prefill_dispatch", tr0,
                                 self.tracer.now_us(), slot=slot,
                                 done=st["cursor"] >= P)
        if st["cursor"] < P:
            return None
        del self._prefilling[slot]
        tok = int(self._prefill.fetch()[0])
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

    # -- prefill/decode disaggregation --------------------------------------

    def export_slot(self, slot: int):
        """Package the live ``slot`` for a hand-off to another engine:
        ``(meta, kpages, vpages)``, meta with the KV ``length``, the
        ``blocks`` that cover it and the pool's ``quant`` dtype, the pages
        as :meth:`PagedKVCache.export_pages` gives them. Exported once the
        first token exists and before any tick, the pages cover exactly
        the prompt; the pending token's K/V is written by the adopting
        engine's first tick."""
        assert self.active[slot], f"slot {slot} is not live"
        length = int(self.cache.lengths[slot])
        ids, kpages, vpages = self.cache.export_pages(slot)
        meta = {"length": length, "blocks": len(ids),
                "quant": self.cache.quant_dtype}
        return meta, kpages, vpages

    def adopt_slot(self, slot: int, prompt: List[int], first_token: int,
                   kpages, vpages,
                   reserve_len: Optional[int] = None) -> bool:
        """Adopt a handed-off sequence into the free ``slot``: import its
        pages at this pool's own blocks, then rebuild the host state a
        finished prefill leaves (the pending token, the history of prompt
        and first token, the drafter's maps, the prefix registration, the
        slot's stats), so the first tick here is the one a colocated
        engine would run. False, and nothing changed, when the pool cannot
        supply the blocks."""
        assert not self.active[slot], f"slot {slot} is occupied"
        assert slot not in self._prefilling, f"slot {slot} is prefilling"
        P = len(prompt)
        if not 0 < P <= self._W:
            raise ValueError(f"prompt length {P} not in [1, {self._W}]")
        if not self.cache.import_pages(slot, kpages, vpages, P,
                                       reserve_len=reserve_len):
            return False
        tok = int(first_token)
        self.active[slot] = True
        self.tokens[slot] = tok
        self.history[slot] = []
        self._bigram_idx[slot] = {}
        self._unigram_idx[slot] = {}
        self._history_append(slot, list(prompt) + [tok])
        self.cache.register_prefix(slot, prompt)
        self.slot_stats[slot] = {
            "prefix_hit_blocks": 0, "shared_len": 0,
            "blocks_reserved": self.cache.owned_count(slot),
            "cow_forks": 0, "prefill_chunks": 0,
            "draft_proposed": 0, "draft_accepted": 0}
        return True

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


    def decode_tick(self) -> np.ndarray:
        """One decode step over every slot: append each active slot's
        pending token (and, with ``speculative=k``, its drafts) to its KV
        and return the new token front ``[S]`` (inactive lanes 0).
        :attr:`last_accepted` maps each active slot to the tokens it
        retired this tick."""
        t0 = time.perf_counter()
        tr0 = self.tracer.now_us() if self.tracer is not None else None
        n_active = int(self.active.sum())
        n = self._pre_tick_guard()
        self.cache.device_tables()
        k = self.speculative
        drafted = 0
        if k == 0:
            self._tick.launch(tokens=self.tokens, active=self.active,
                              tick=self.ticks)
            # the plain tick advances every active slot by one: the bump
            # runs while the device works (the device mirror is a
            # snapshot taken before it)
            self.cache.lengths[self.active] += 1
        else:
            # the pending token, then the drafts
            toks = np.zeros((self.max_slots, self._K1), np.int32)
            for slot in np.flatnonzero(self.active):
                toks[slot, 0] = self.tokens[slot]
                toks[slot, 1:] = self._propose_drafts(slot)
                drafted += int(n[slot]) - 1
            self._tick.launch(tokens=toks, n=n, active=self.active,
                              tick=self.ticks)
        out = self._tick.fetch()
        stochastic = k > 0 and self.sampling is not None
        self.last_accepted = {}
        front = np.zeros((self.max_slots,), np.int32)
        retired = accepted_drafts = 0
        for slot in np.flatnonzero(self.active):
            live = int(n[slot])
            if k == 0:
                accepted = [int(out[slot])]
            elif stochastic:
                # [S3] walk: accept drafts while the row's coin lands under
                # p(draft); the stopping row's token is the residual
                # resample, or the bonus from the last live row when every
                # draft survived
                acc, res, bon = out[slot, :k], out[slot, k:2 * k], \
                    out[slot, 2 * k:]
                take = 0
                while take < live - 1 and acc[take]:
                    take += 1
                accepted = [int(t) for t in toks[slot, 1:1 + take]]
                accepted.append(int(res[take] if take < live - 1
                                    else bon[live - 1]))
            else:
                # the longest draft prefix the model reproduced, plus the
                # model's own token after it: the plain tick's stream
                take = 1
                while take < live and int(toks[slot, take]) \
                        == int(out[slot, take - 1]):
                    take += 1
                accepted = [int(t) for t in out[slot, :take]]
            if k:
                self.cache.lengths[slot] += len(accepted)
            self.last_accepted[slot] = accepted
            front[slot] = accepted[-1]
            self._history_append(slot, accepted)
            retired += len(accepted)
            accepted_drafts += len(accepted) - 1
            st = self.slot_stats[slot]
            st["draft_proposed"] += live - 1
            st["draft_accepted"] += len(accepted) - 1
        self.tokens = front
        self.ticks += 1
        self.tokens_generated += retired
        self.draft_proposed += drafted
        self.draft_accepted += accepted_drafts
        if tr0 is not None:
            self.tracer.complete("engine_tick", tr0, self.tracer.now_us(),
                                 tick=self.ticks, active=n_active,
                                 tokens=retired,
                                 accepted_drafts=accepted_drafts)
        if self.telemetry is not None:
            self._emit_tick(t0, n_active, retired, drafted, accepted_drafts)
        if self.metrics is not None:
            self._publish_tick(t0, n_active, retired)
        return front.copy()

    # -- observability -----------------------------------------------------

    def _emit_tick(self, t0, n_active, tokens, drafted, accepted) -> None:
        """One ``kind="decode_tick"`` record with the JAX engine's keys.
        The sharing and chunk counters are per-tick deltas (an admission's
        hits show on the next record), so every field sums over records;
        ``retained_blocks``, ``kv_bytes_per_token`` and ``quant_dtype``
        are gauges."""
        wall = time.perf_counter() - t0
        snap = {"prefix_hit_blocks": self.cache.prefix_hit_blocks,
                "cow_forks": self.cache.cow_forks,
                "prefill_chunks": self.prefill_chunks,
                "retained_hits": self.cache.retained_hits}
        delta = {key: val - self._tick_counters.get(key, 0)
                 for key, val in snap.items()}
        self._tick_counters = snap
        self.telemetry.emit_event({
            "kind": "decode_tick", "tick": self.ticks,
            "active_slots": n_active, "wall_ms": round(wall * 1e3, 4),
            "tokens": tokens,
            "tokens_per_sec": round(tokens / wall, 2) if wall else None,
            "free_blocks": self.cache.free_blocks,
            "draft_accept_rate": (round(accepted / drafted, 4)
                                  if drafted else None),
            "retained_blocks": self.cache.retained_blocks,
            "kv_bytes_per_token": self.cache.kv_bytes_per_token,
            "quant_dtype": self.cache.quant_dtype,
            "tp_degree": 1,
            **delta,
        })

    def _publish_tick(self, t0, n_active, tokens) -> None:
        """The engine's metrics: tick wall, ticks, tokens, active slots,
        pool occupancy, and the sharing/speculation counters as per-tick
        increments (from a baseline of its own, apart from the
        telemetry's)."""
        m = self.metrics
        m.histogram("engine_tick_ms",
                    "compiled decode tick wall time (ms)").observe(
            (time.perf_counter() - t0) * 1e3)
        m.counter("engine_ticks", "decode ticks executed").inc()
        m.counter("engine_tokens",
                  "tokens retired across all slots").inc(tokens)
        m.gauge("engine_active_slots", "slots decoding this tick").set(
            n_active)
        m.gauge("engine_kv_free_blocks",
                "free blocks in the paged KV pool").set(
            self.cache.free_blocks)
        m.gauge("engine_kv_occupancy",
                "reserved fraction of the paged KV pool").set(
            1.0 - self.cache.free_blocks / self.cache.num_blocks)
        snap = {"engine_prefix_hit_blocks": self.cache.prefix_hit_blocks,
                "engine_cow_forks": self.cache.cow_forks,
                "engine_prefill_chunks": self.prefill_chunks,
                "engine_draft_proposed": self.draft_proposed,
                "engine_draft_accepted": self.draft_accepted}
        for key, val in snap.items():
            d = val - self._metrics_tick_counters.get(key, 0)
            if d:
                m.counter(key, "cumulative engine counter").inc(d)
        self._metrics_tick_counters = snap
