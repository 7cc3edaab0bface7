"""Multi-head attention — the port of ``MultiHeadAttention`` from
``paddle_tpu/nn/attention.py``: the ``"xla"`` (materialized scores) and
``"flash"`` (fused kernel) forward, the paged-KV ``decode`` step and the
multi-token ``decode_span`` (speculative verify, chunked prefill), over
f32, bf16 or int8 pools.

The q/k/v/o projections have no bias and are the policy's product
(:func:`~.policy_dot.policy_dot`): bf16 operands under
``bfloat16_compute``, an f32 result under every policy, so the flash and
paged kernels see f32 operands; the pools hold the engine's KV dtype (f32,
bf16, or int8 with scales). The context is cast to the compute dtype after
attention, as in JAX; on the ``"xla"`` path each product runs in the dtype
``jnp`` promotes its operands to: f32 q against a bf16 pool's K in f32,
the compute-dtype softmax weights against an f32 ``v`` in f32, and bf16
against bf16 only under ``bfloat16_compute`` over a bf16 pool. Masking
constants follow
the JAX package: the materialized path masks with ``-1e9``; the kernels
start their running max at ``-1e30``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.dtypes import current_policy
from .cuda_attention import (flash_attention, paged_decode_attention,
                             paged_span_attention)
from ..core.initializers import xavier_uniform_
from .policy_dot import policy_dot

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(nn.Module):
    """Scaled-dot-product self-attention with optional causal and
    packed-segment masking: the ``"xla"`` impl (materialized scores; any
    ``mask=``, cross-attention) or, with ``use_flash=True``, the
    ``"flash"`` impl (the fused kernel; ``causal=`` and ``segments=``
    only). Parameters ``wq``/``wk``/``wv``/``wo`` are ``[in, out]``.
    ``head_dim`` (default ``dim // num_heads``) sets the width of each
    head and so of the paged pools a serving engine builds; ``out_dim``
    (default ``dim``) the output projection's width. The flash and paged
    kernels take the head widths they take at the default (64, 128)."""

    def __init__(self, dim: int, num_heads: int, use_flash: bool = False,
                 head_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, device=None,
                 generator=None):
        super().__init__()
        self.attention_impl = "flash" if use_flash else "xla"
        self.num_heads = num_heads
        self.head_dim = head_dim or dim // num_heads
        inner = num_heads * self.head_dim
        shapes = {"wq": (dim, inner), "wk": (dim, inner),
                  "wv": (dim, inner), "wo": (inner, out_dim or dim)}
        for name, shape in shapes.items():
            p = nn.Parameter(torch.empty(shape, device=device))
            xavier_uniform_(p, generator)
            setattr(self, name, p)

    def _heads(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return policy_dot(x, w).reshape(*x.shape[:2], self.num_heads,
                                        self.head_dim)

    def forward(self, q_in, kv_in=None, mask=None, causal: bool = False,
                segments=None, return_kv: bool = False):
        """``q_in`` ``[B, Tq, D]``; ``kv_in`` defaults to ``q_in``;
        ``mask`` ``[B, Tq, Tk]`` (1 = attend); ``segments`` ``[B, T]``
        packed ids (1-based, 0 = padding). ``return_kv`` also returns the
        projected ``(k, v)`` ``[B, Tk, H, hd]`` that serving prefill
        scatters into the paged pools."""
        kv_in = q_in if kv_in is None else kv_in
        pol = current_policy()
        hd = self.head_dim
        q = self._heads(q_in, self.wq)
        k = self._heads(kv_in, self.wk)
        v = self._heads(kv_in, self.wv)
        if self.attention_impl == "flash":
            if mask is not None or kv_in is not q_in:
                raise ValueError("the flash impl is self-attention with "
                                 "causal=/segments= only; build without "
                                 "use_flash for mask= or cross-attention")
            seg = None if segments is None else \
                segments.to(torch.int32).contiguous()
            ctx = flash_attention(q.transpose(1, 2).contiguous(),
                                  k.transpose(1, 2).contiguous(),
                                  v.transpose(1, 2).contiguous(), seg,
                                  causal)
            ctx = ctx.transpose(1, 2).to(pol.compute_dtype)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
            logits = logits.float()
            if causal:
                Tq, Tk = logits.shape[-2:]
                cm = torch.tril(torch.ones(Tq, Tk, dtype=torch.bool,
                                           device=logits.device))
                logits = logits.masked_fill(~cm, -1e9)
            if segments is not None:
                sm = (segments[:, :, None] == segments[:, None, :]) \
                    & (segments[:, :, None] > 0)
                logits = logits.masked_fill(~sm[:, None], -1e9)
            if mask is not None:
                logits = logits.masked_fill(~(mask[:, None] > 0), -1e9)
            w = torch.softmax(logits, dim=-1).to(pol.compute_dtype)
            ctx = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
        ctx = ctx.reshape(*q_in.shape[:2], self.num_heads * hd)
        out = policy_dot(ctx, self.wo)
        if return_kv:
            return out, (k, v)
        return out

    def decode(self, q_in, pages_k, pages_v, tables, positions, active,
               impl: str = "xla"):
        """One decode step (q_len = 1) against this layer's paged pool:
        project the new token, write its K/V into the pool, attend over
        the slot's ragged context. ``q_in`` ``[S, 1, D]``; pools ``[N, bs,
        H, hd]`` or int8 ``(values, scales)`` tuples (quantized on
        scatter); ``positions`` ``[S]`` the new token's 0-based position;
        ``active`` ``[S]`` bool (inactive slots write the null block and
        output zeros). ``impl``: ``"paged"`` = the paged-decode kernel,
        ``"xla"`` = gather + masked softmax. Returns ``(out [S, 1, D],
        pages_k, pages_v)``; the pools are updated in place (the JAX
        engine donated them to the compiled tick instead)."""
        from ..serve.kv_cache import gather_pages, scatter_token_pages
        pol = current_policy()
        S = q_in.shape[0]
        q = self._heads(q_in, self.wq)[:, 0]            # [S, h, hd]
        k = self._heads(q_in, self.wk)[:, 0]
        v = self._heads(q_in, self.wv)[:, 0]
        scatter_token_pages(pages_k, k, tables, positions, active)
        scatter_token_pages(pages_v, v, tables, positions, active)
        # the new token sees itself: effective length = position + 1
        eff_len = torch.where(active, positions + 1,
                              torch.zeros_like(positions))
        if impl == "paged":
            ctx = paged_decode_attention(q.contiguous(), pages_k, pages_v,
                                         tables, eff_len.to(torch.int32))
        elif impl == "xla":
            ctx = self._sdpa_row(q, gather_pages(pages_k, tables),
                                 gather_pages(pages_v, tables), eff_len,
                                 self.head_dim)
        else:
            raise ValueError(f"decode impl must be 'paged'|'xla', "
                             f"got {impl!r}")
        ctx = ctx.to(pol.compute_dtype).reshape(S, 1, -1)
        return policy_dot(ctx, self.wo), pages_k, pages_v

    def decode_span(self, q_in, pages_k, pages_v, tables, start, n, active,
                    impl: str = "xla", write_from=None):
        """A span of consecutive new tokens per slot against this layer's
        paged pool — the speculative verify tick (``Q = 1 + k``) and
        chunked prefill (``Q = chunk``). ``q_in`` ``[S, Q, D]``: token
        ``j`` of slot ``s`` sits at position ``start[s] + j``; ``n`` ``[S]``
        live tokens per slot (rows ``>= n`` are padding: null-block
        scatter, output ignored); ``active`` ``[S]``; ``write_from``
        ``[S]`` (optional) masks the scatter below it, so a chunk
        re-attending a shared prefix never writes co-owned pages.
        ``impl``: ``"paged"`` = the paged-span kernel, ``"xla"`` = row
        ``j`` through :meth:`_sdpa_row` at ``eff_len = start + j + 1``, the
        decode step's own chain. Returns ``(out [S, Q, D], pages_k,
        pages_v)``; the pools are updated in place."""
        from ..serve.kv_cache import gather_pages, scatter_span_pages
        if impl not in ("xla", "paged"):
            raise ValueError(f"decode_span impl must be 'paged'|'xla', "
                             f"got {impl!r}")
        pol = current_policy()
        S, Q = q_in.shape[:2]
        q = self._heads(q_in, self.wq)                  # [S, Q, h, hd]
        k = self._heads(q_in, self.wk)
        v = self._heads(q_in, self.wv)
        n_eff = torch.where(active, n, torch.zeros_like(n))
        scatter_span_pages(pages_k, k, tables, start, n_eff, write_from)
        scatter_span_pages(pages_v, v, tables, start, n_eff, write_from)
        if impl == "paged":
            ctx = paged_span_attention(q.contiguous(), pages_k, pages_v,
                                       tables, start.to(torch.int32),
                                       n_eff.to(torch.int32))
        else:
            kg = gather_pages(pages_k, tables)          # [S, W, h, hd]
            vg = gather_pages(pages_v, tables)
            rows = []
            for j in range(Q):
                # row j sees start + j + 1 positions, itself included; the
                # later span rows sit past its mask
                eff_len = torch.where(active & (j < n_eff), start + j + 1,
                                      torch.zeros_like(start))
                rows.append(self._sdpa_row(q[:, j], kg, vg, eff_len,
                                           self.head_dim))
            ctx = torch.stack(rows, dim=1)
        ctx = ctx.to(pol.compute_dtype).reshape(S, Q, -1)
        return policy_dot(ctx, self.wo), pages_k, pages_v

    @staticmethod
    def _sdpa_row(q, kg, vg, eff_len, hd):
        """One query row per slot against the gathered context ``kg``/``vg``
        ``[S, W, h, hd]`` -> ``[S, h, hd]``: logits masked with ``-1e9``
        past ``eff_len``, and a length-0 lane zeroed (its softmax would
        average stale pages)."""
        pol = current_policy()
        W = kg.shape[1]
        # each product in the dtype jnp promotes its operands to: f32 q
        # against a bf16 pool's K in f32; the compute-dtype weights
        # against V in the wider of the two (bf16 only when both are)
        dt = torch.promote_types(q.dtype, kg.dtype)
        logits = torch.einsum("shd,swhd->shw", q.to(dt), kg.to(dt)) \
            / math.sqrt(hd)
        logits = logits.float()
        live = torch.arange(W, device=q.device)[None] < eff_len[:, None]
        logits = logits.masked_fill(~live[:, None], -1e9)
        w = torch.softmax(logits, dim=-1).to(pol.compute_dtype)
        dt = torch.promote_types(w.dtype, vg.dtype)
        ctx = torch.einsum("shw,swhd->shd", w.to(dt), vg.to(dt))
        return torch.where((eff_len > 0)[:, None, None], ctx,
                           torch.zeros_like(ctx))
