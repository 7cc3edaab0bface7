"""Decoder-only transformer LM — the port of ``TransformerBlock`` and
``TransformerLM`` from ``paddle_tpu/models/transformer.py``: ``embed``,
``head``, the training ``forward`` (dense or mixture-of-experts FFNs,
dropout, ``remat``), and the serving entry points ``prefill``,
``decode_step`` and ``decode_span``. ``residual_sharding`` (multi-device)
is not ported.

The JAX model runs its block stack as one ``lax.scan`` over stacked
per-layer parameters; here it is a Python loop over an ``nn.ModuleList``.
Parameter names follow the JAX variable paths (``blocks.{i}.attn.wq`` is
``block{i}/attn/wq``, ``blocks.{i}.ffn.w1`` is ``block{i}/ffn/w1``), which
is what ``utils/bridge.py`` relies on.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..core.device import resolve_device
from ..core.dtypes import current_policy, use_policy
from ..nn.attention import MultiHeadAttention
from ..nn.layers import Dropout, Embedding, LayerNorm, Linear
from ..nn.moe import MoEFFN
from ..serve.kv_cache import layer_pool

__all__ = ["TransformerBlock", "TransformerLM", "remat_policy"]


def remat_policy(name):
    """Validate a ``remat`` value as JAX's ``remat_policy`` does and return
    the selective-checkpoint policy it stands for: ``"dots"`` (or
    ``True``) saves the outputs of the products and of the flash forward
    and recomputes the rest (JAX's ``dots_saveable``); ``"full"`` (None)
    saves nothing inside a block. Anything else raises ``ValueError``
    with JAX's message."""
    if name is True or name == "dots":
        return _save_products
    if name == "full":
        return None
    raise ValueError(f"remat must be None, 'dots', or 'full'; got {name!r}")


def _save_products(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy of ``torch.utils.checkpoint``'s selective
    checkpointing: keep the outputs of the products (``mm``, ``bmm``,
    ``addmm``) and of the flash forward (O and LSE, the op
    ``paddle_tpu_torch::flash_fwd``); recompute anything else."""
    saved = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
             torch.ops.paddle_tpu_torch.flash_fwd)
    return (_ckpt.CheckpointPolicy.MUST_SAVE
            if getattr(op, "overloadpacket", None) in saved
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


class TransformerBlock(nn.Module):
    """Pre-LN block: ``x + MHA(LN(x))`` then ``x + FFN(LN(x))``; the FFN is
    a dense two-layer gelu MLP or, with ``moe_experts > 0``, an
    :class:`~paddle_tpu_torch.nn.moe.MoEFFN` of that many experts. With
    ``dropout > 0`` both sublayer outputs pass through :class:`Dropout` in
    training, drawing from ``dropout_generator``. ``forward`` returns
    ``(out, aux)``, aux the MoE load-balancing loss (an f32 zero for the
    dense FFN), and ``(out, aux, (k, v))`` with ``return_kv``."""

    def __init__(self, dim: int, num_heads: int, ffn_hidden: int,
                 use_flash: bool = False, dropout: float = 0.0,
                 moe_experts: int = 0, device=None, generator=None,
                 dropout_generator=None):
        super().__init__()
        self.ln1 = LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, use_flash=use_flash,
                                       device=device, generator=generator)
        self.ln2 = LayerNorm(dim, device=device)
        self.moe_experts = moe_experts
        if moe_experts > 0:
            self.ffn = MoEFFN(dim, moe_experts, ffn_hidden, device=device,
                              generator=generator)
        else:
            self.ffn1 = Linear(dim, ffn_hidden, act="gelu", device=device,
                               generator=generator)
            self.ffn2 = Linear(ffn_hidden, dim, device=device,
                               generator=generator)
        self.dropout = Dropout(dropout, dropout_generator) if dropout \
            else None

    def _maybe_drop(self, x, train: bool):
        return self.dropout(x, train=True) \
            if self.dropout is not None and train else x

    def _ffn(self, z):
        """The FFN sublayer on the normalised ``z`` (serving: no aux)."""
        return self.ffn(z) if self.moe_experts > 0 \
            else self.ffn2(self.ffn1(z))

    def forward(self, x, train: bool = False, segments=None,
                return_kv: bool = False):
        a = self.attn(self.ln1(x), causal=True, segments=segments,
                      return_kv=return_kv)
        if return_kv:
            a, kv = a
        h = x + self._maybe_drop(a, train)
        z = self.ln2(h)
        if self.moe_experts > 0:
            y, aux = self.ffn(z, return_aux=True)
        else:
            y = self._ffn(z)
            aux = torch.zeros((), dtype=torch.float32, device=z.device)
        out = h + self._maybe_drop(y, train)
        return (out, aux, kv) if return_kv else (out, aux)

    def decode_step(self, x, pages_k, pages_v, tables, positions, active,
                    attn_impl: str = "xla"):
        """The block with attention swapped for
        :meth:`MultiHeadAttention.decode`; returns ``(out, pages_k,
        pages_v)`` with this layer's pools updated in place."""
        a, pages_k, pages_v = self.attn.decode(
            self.ln1(x), pages_k, pages_v, tables, positions, active,
            impl=attn_impl)
        h = x + a
        return h + self._ffn(self.ln2(h)), pages_k, pages_v

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
        return h + self._ffn(self.ln2(h)), pages_k, pages_v


class TransformerLM(nn.Module):
    """``ids [B, T] -> logits [B, T, vocab]`` with tied input/output
    embeddings. Built on ``device`` (default ``"cuda"``; without a card
    pass ``device="cpu"``), with weights drawn from ``generator`` (default:
    a generator on ``device`` seeded with 0). With ``dropout > 0`` every
    block's dropout draws from ``dropout_generator`` (default: one on
    ``device`` seeded with 0, shared by the blocks).

    ``moe_experts=E`` gives every block an E-expert
    :class:`~paddle_tpu_torch.nn.moe.MoEFFN` of hidden width
    ``ffn_hidden``. ``remat`` (None, ``True``/``"dots"``, ``"full"``,
    checked at construction as JAX's ``remat_policy``) recomputes each
    block's activations in the backward with
    ``torch.utils.checkpoint`` (non-reentrant): ``"full"`` saves only the
    block's input, ``"dots"`` also the products' and the flash forward's
    outputs (selective checkpointing). It applies where gradients are
    recorded, changes no parameter and is refused in training with
    ``dropout > 0``, as in JAX. ``residual_sharding`` raises
    ``NotImplementedError``."""

    JAX_ROOT = "transformer_lm"     # the JAX model's name (utils/bridge.py)

    def __init__(self, vocab: int, dim: int = 128, num_layers: int = 2,
                 num_heads: int = 4, ffn_hidden: int = 256,
                 max_len: int = 512, use_flash: bool = False,
                 dropout: float = 0.0, moe_experts: int = 0, remat=None,
                 residual_sharding=None, device="cuda", generator=None,
                 dropout_generator=None):
        super().__init__()
        if residual_sharding is not None:
            raise NotImplementedError(
                "TransformerLM(residual_sharding=...): multi-device "
                "training is not ported yet")
        if remat is not None:
            remat_policy(remat)              # validate eagerly, as JAX
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if dropout and dropout_generator is None:
            dropout_generator = torch.Generator(device=device).manual_seed(0)
        self.max_len = max_len
        self.remat = remat
        self.dropout_rate = dropout
        self.emb = Embedding(vocab, dim, device=device, generator=generator)
        self.pos = Embedding(max_len, dim, std=0.02, device=device,
                             generator=generator)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, ffn_hidden, use_flash, dropout,
                             moe_experts, device=device, generator=generator,
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
        blocks' summed MoE load-balancing loss (f32, zero for dense FFNs).
        ``segments``/``positions``: packed-sequence metadata; attention
        stays within each packed sub-sequence."""
        if ids.shape[1] > self.max_len:
            raise ValueError(f"T={ids.shape[1]} exceeds "
                             f"max_len={self.max_len}")
        x = self.embed(ids, positions)
        run = self._remat_block() if torch.is_grad_enabled() else None
        if run is not None and train and self.dropout_rate > 0:
            raise ValueError("remat scan-over-layers requires dropout == 0 "
                             "(rngs do not thread through the stacked "
                             "block)")
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in self.blocks:
            if run is None:
                x, aux = blk(x, train=train, segments=segments)
            else:
                x, aux = run(blk, x, train, segments)
            aux_total = aux_total + aux
        logits = self.head(x)
        if return_aux:
            return logits, aux_total
        return logits

    def _remat_block(self):
        """``run(blk, x, train, segments)`` under ``remat``'s checkpoint,
        or None without remat. The recompute runs in the backward, which
        may run on autograd's device thread, where the caller's dtype
        policy is not current: the block runs under the policy of its
        forward both times."""
        if self.remat is None:
            return None
        policy = remat_policy(self.remat)
        kw = {} if policy is None else {"context_fn": functools.partial(
            _ckpt.create_selective_checkpoint_contexts, policy)}
        dtype_policy = current_policy()

        def block(blk, x, train, segments):
            with use_policy(dtype_policy):
                return blk(x, train=train, segments=segments)

        def run(blk, x, train, segments):
            return _ckpt.checkpoint(block, blk, x, train, segments,
                                    use_reentrant=False, **kw)
        return run

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
            x, _, (k, v) = blk(x, return_kv=True)
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
