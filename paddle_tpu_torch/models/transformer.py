"""Decoder-only transformer LM — the port of ``TransformerBlock`` (dense
FFN, optional dropout) and ``TransformerLM`` from
``paddle_tpu/models/transformer.py``: ``embed``, ``head``, the training
``forward``, and the serving entry points ``prefill``, ``decode_step``
and ``decode_span``. MoE, ``remat`` and ``residual_sharding`` are not
ported yet.

The JAX model runs its block stack as one ``lax.scan`` over stacked
per-layer parameters; here it is a Python loop over an ``nn.ModuleList``.
Parameter names follow the JAX variable paths (``blocks.{i}.attn.wq`` is
``block{i}/attn/wq``), which is what ``utils/bridge.py`` relies on.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.device import resolve_device
from ..nn.attention import MultiHeadAttention
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..serve.kv_cache import layer_pool

__all__ = ["TransformerBlock", "TransformerLM"]


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + MHA(LN(x))`` then ``x + FFN(LN(x))`` with a
    dense two-layer gelu MLP; with ``dropout > 0`` both sublayer outputs
    pass through :class:`Dropout` in training, drawing from
    ``dropout_generator``."""

    def __init__(self, dim: int, num_heads: int, ffn_hidden: int,
                 use_flash: bool = False, dropout: float = 0.0, device=None,
                 generator=None, dropout_generator=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, use_flash=use_flash,
                                       device=device, generator=generator)
        self.ln2 = LayerNorm(dim, device=device)
        self.ffn1 = Linear(dim, ffn_hidden, act="gelu", device=device,
                           generator=generator)
        self.ffn2 = Linear(ffn_hidden, dim, device=device,
                           generator=generator)
        self.dropout = Dropout(dropout, dropout_generator) if dropout \
            else None

    def _maybe_drop(self, x, train: bool):
        return self.dropout(x, train=True) \
            if self.dropout is not None and train else x

    def forward(self, x, train: bool = False, segments=None,
                return_kv: bool = False):
        a = self.attn(self.ln1(x), causal=True, segments=segments,
                      return_kv=return_kv)
        if return_kv:
            a, kv = a
        h = x + self._maybe_drop(a, train)
        out = h + self._maybe_drop(self.ffn2(self.ffn1(self.ln2(h))), train)
        return (out, kv) if return_kv else out

    def decode_step(self, x, pages_k, pages_v, tables, positions, active,
                    attn_impl: str = "xla"):
        """The block with attention swapped for
        :meth:`MultiHeadAttention.decode`; returns ``(out, pages_k,
        pages_v)`` with this layer's pools updated in place."""
        a, pages_k, pages_v = self.attn.decode(
            self.ln1(x), pages_k, pages_v, tables, positions, active,
            impl=attn_impl)
        h = x + a
        return h + self.ffn2(self.ffn1(self.ln2(h))), pages_k, pages_v

    def decode_span(self, x, pages_k, pages_v, tables, start, n, active,
                    attn_impl: str = "xla", write_from=None):
        """The block with attention swapped for
        :meth:`MultiHeadAttention.decode_span`; ``x`` ``[S, Q, D]``.
        Returns ``(out, pages_k, pages_v)`` with this layer's pools updated
        in place."""
        a, pages_k, pages_v = self.attn.decode_span(
            self.ln1(x), pages_k, pages_v, tables, start, n, active,
            impl=attn_impl, write_from=write_from)
        h = x + a
        return h + self.ffn2(self.ffn1(self.ln2(h))), pages_k, pages_v


class TransformerLM(nn.Module):
    """``ids [B, T] -> logits [B, T, vocab]`` with tied input/output
    embeddings. Built on ``device`` (default ``"cuda"``; without a card
    pass ``device="cpu"``), with weights drawn from ``generator`` (default:
    a generator on ``device`` seeded with 0). With ``dropout > 0`` every
    block's dropout draws from ``dropout_generator`` (default: one on
    ``device`` seeded with 0, shared by the blocks)."""

    JAX_ROOT = "transformer_lm"     # the JAX model's name (utils/bridge.py)

    def __init__(self, vocab: int, dim: int = 128, num_layers: int = 2,
                 num_heads: int = 4, ffn_hidden: int = 256,
                 max_len: int = 512, use_flash: bool = False,
                 dropout: float = 0.0, device="cuda", generator=None,
                 dropout_generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if dropout and dropout_generator is None:
            dropout_generator = torch.Generator(device=device).manual_seed(0)
        self.max_len = max_len
        self.emb = Embedding(vocab, dim, device=device, generator=generator)
        self.pos = Embedding(max_len, dim, std=0.02, device=device,
                             generator=generator)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, ffn_hidden, use_flash, dropout,
                             device=device, generator=generator,
                             dropout_generator=dropout_generator)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(dim, device=device)

    def embed(self, ids, positions=None):
        """Token plus positional embedding."""
        pos = torch.arange(ids.shape[1], device=ids.device)[None] \
            if positions is None else positions
        return self.emb(ids) + self.pos(pos)

    def head(self, x):
        """Final LN and tied readout."""
        return self.emb.attend(self.ln_f(x))

    def forward(self, ids, train: bool = False, return_aux: bool = False,
                segments=None, positions=None):
        """``train`` turns dropout on; ``return_aux`` also returns the
        summed auxiliary loss, zero for the dense FFN.
        ``segments``/``positions``: packed-sequence metadata; attention
        stays within each packed sub-sequence."""
        if ids.shape[1] > self.max_len:
            raise ValueError(f"T={ids.shape[1]} exceeds "
                             f"max_len={self.max_len}")
        x = self.embed(ids, positions)
        for blk in self.blocks:
            x = blk(x, train=train, segments=segments)
        logits = self.head(x)
        if return_aux:
            return logits, torch.zeros((), dtype=torch.float32,
                                       device=logits.device)
        return logits

    @torch.no_grad()
    def prefill(self, ids, positions=None):
        """Serving prefill: ``ids [B, W] -> (logits [B, W, vocab], (k,
        v))`` with ``k``/``v`` the per-layer projections ``[L, B, W, H,
        hd]``. ``W`` is the engine's fixed padded width; rows past a
        sequence's length are unspecified (causal masking keeps them out
        of every valid row)."""
        if ids.shape[1] > self.max_len:
            raise ValueError(f"T={ids.shape[1]} exceeds "
                             f"max_len={self.max_len}")
        x = self.embed(ids, positions)
        ks, vs = [], []
        for blk in self.blocks:
            x, (k, v) = blk(x, return_kv=True)
            ks.append(k)
            vs.append(v)
        return self.head(x), (torch.stack(ks), torch.stack(vs))

    @torch.no_grad()
    def decode_step(self, token, kv, positions, active=None,
                    attn_impl: str = "xla"):
        """Serving decode tick: one new token per slot. ``token [S]``;
        ``kv = (pages_k, pages_v, tables)`` with pools ``[L, N, bs, H,
        hd]`` (or int8 ``(values, scales)`` tuples) and ``tables [S,
        MB]``; ``positions [S]`` the new token's
        0-based position; ``active [S]`` bool (default all). Returns
        ``(logits [S, vocab], kv)``; the pools are updated in place."""
        pages_k, pages_v, tables = kv
        if active is None:
            active = torch.ones(token.shape[0], dtype=torch.bool,
                                device=token.device)
        # inactive slots may carry any position; the clamp only guards
        # the embedding lookup and is the identity for valid positions
        pos_idx = positions.clamp(max=self.max_len - 1)
        x = self.emb(token[:, None]) + self.pos(pos_idx[:, None])
        for i, blk in enumerate(self.blocks):
            x, _, _ = blk.decode_step(x, layer_pool(pages_k, i),
                                      layer_pool(pages_v, i), tables,
                                      positions, active, attn_impl)
        return self.head(x)[:, 0], (pages_k, pages_v, tables)

    @torch.no_grad()
    def decode_span(self, tokens, kv, start, n, active=None,
                    attn_impl: str = "xla", write_from=None):
        """Serving span step: ``Q`` consecutive new tokens per slot, shared
        by the speculative verify tick (``Q = 1 + k``) and chunked prefill
        (``Q = C``). ``tokens [S, Q]`` (token ``j`` of slot ``s`` at
        position ``start[s] + j``); ``kv`` as in :meth:`decode_step`;
        ``n [S]`` live tokens per slot (rows past ``n`` are padding);
        ``write_from [S]`` an optional scatter floor for shared-prefix
        re-reads. Returns ``(logits [S, Q, vocab], kv)``; the pools are
        updated in place."""
        pages_k, pages_v, tables = kv
        S, Q = tokens.shape
        if active is None:
            active = torch.ones(S, dtype=torch.bool, device=tokens.device)
        pos = (start.long()[:, None]
               + torch.arange(Q, device=tokens.device)[None]).clamp(
                   max=self.max_len - 1)
        x = self.emb(tokens) + self.pos(pos)
        for i, blk in enumerate(self.blocks):
            x, _, _ = blk.decode_span(x, layer_pool(pages_k, i),
                                      layer_pool(pages_v, i), tables, start,
                                      n, active, attn_impl, write_from)
        return self.head(x), (pages_k, pages_v, tables)
