"""Mixture-of-experts FFN — the port of ``MoEFFN`` from
``paddle_tpu/nn/moe.py``, step by step in its static dispatch/combine
formulation: a softmax router, top-k choices, a fixed per-expert capacity
``C``, one-hot ``[N, E, C]`` dispatch and combine tensors, and the expert
FFNs batched over the expert axis. Every shape is fixed by ``x``'s shape
in Python and nothing reads a device value on the host, so a serving
engine captures it in a CUDA graph like any other layer.

Routing is JAX's exactly: the top-k choices are taken in K rounds of
``argmax`` (the first of equal probabilities, as ``jax.lax.top_k`` takes
the lower index first; ``torch.topk``'s order among ties is unspecified
on the card), and the choices claim capacity slots in choice-major order
(every token's first choice before any second choice), counted in
integers whatever ``x``'s dtype. Overflowing (token, choice) pairs are
dropped (they contribute zero). Capacity is shared by every token of a
call, so a token's output depends on the other tokens of that call, as
in JAX.

The layer ignores the dtype policy, as the JAX layer does (it has no
``cast_compute``): the dispatch and combine tensors take ``x``'s dtype
and each product the dtype ``jnp`` promotes its operands to, so under
``bfloat16_compute`` the transformer's f32 residual stream makes it f32
throughout.
Multi-device expert sharding (JAX's ``moe_sharding_rules``) is not
ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core import initializers as I
from . import activations

__all__ = ["MoEFFN"]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean one-hot over a last axis of ``n`` (no host sync)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the dtype ``jnp`` promotes the operands to."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


class MoEFFN(nn.Module):
    """Top-k routed expert FFN, ``x [B, T, D] -> [B, T, D]``.

    Parameters (JAX's names and layouts): ``wg [D, E]`` (the router,
    Xavier-uniform), ``w1 [E, D, hidden]``, ``b1 [E, hidden]``, ``w2 [E,
    hidden, D]``, ``b2 [E, D]`` (fan-in uniform over JAX's fans, zero
    biases). ``C = max(1, ceil(N K / E * capacity_factor))`` for the
    ``N = B T`` tokens of a call. ``renormalize`` divides the K gates of a
    token by their sum (K > 1).

    ``forward(x, return_aux=True)`` also returns the Switch
    load-balancing loss over first choices, ``E * sum_e(frac_e *
    mean_prob_e)`` in f32; ``return_stats=True`` a dict of ``drop_rate``
    (the share of (token, choice) pairs dropped), ``expert_fraction``
    (each expert's share of first choices) and ``capacity`` (C, int32),
    all device tensors. Both: ``(out, aux, stats)``.
    """

    def __init__(self, dim: int, num_experts: int, hidden: int,
                 capacity_factor: float = 1.25, act="gelu", top_k: int = 1,
                 renormalize: bool = True, device=None, generator=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k must be in [1, {num_experts}], "
                             f"got {top_k}")
        self.num_experts = num_experts
        self.hidden = hidden
        self.capacity_factor = capacity_factor
        self.act = activations.get(act)
        self.top_k = top_k
        self.renormalize = renormalize
        E = num_experts
        inits = {"wg": ((dim, E), I.xavier_uniform),
                 "w1": ((E, dim, hidden), I.fan_in_uniform),
                 "b1": ((E, hidden), I.zeros),
                 "w2": ((E, hidden, dim), I.fan_in_uniform),
                 "b2": ((E, dim), I.zeros)}
        for name, (shape, init) in inits.items():
            p = nn.Parameter(torch.empty(shape, device=device))
            init(p, generator)
            setattr(self, name, p)

    def capacity(self, tokens: int) -> int:
        """Each expert's slots for a call of ``tokens`` tokens."""
        return max(1, math.ceil(tokens * self.top_k / self.num_experts
                                * self.capacity_factor))

    def forward(self, x: torch.Tensor, return_aux: bool = False,
                return_stats: bool = False):
        B, T, D = x.shape
        E, K = self.num_experts, self.top_k
        N = B * T
        C = self.capacity(N)
        dt = x.dtype
        xf = x.reshape(N, D)
        probs = torch.softmax(_einsum("nd,de->ne", xf, self.wg), dim=-1)

        # top-k by K rounds of argmax; the gates gather from probs, so
        # the gradient reaches the router through them
        pick = probs.detach()
        idx, gates = [], []
        for _ in range(K):
            i = torch.argmax(pick, dim=-1)                      # [N]
            idx.append(i)
            gates.append(probs.gather(-1, i[:, None])[:, 0])
            pick = pick.masked_fill(_one_hot(i, E), -1.0)
        top_gates = torch.stack(gates, -1)                      # [N, K]
        if self.renormalize and K > 1:
            top_gates = top_gates / top_gates.sum(
                -1, keepdim=True).clamp_min(1e-9)

        # capacity, choice-major; slots counted in int64
        counts = torch.zeros(E, dtype=torch.int64, device=x.device)
        kept_total = torch.zeros((), dtype=torch.int64, device=x.device)
        slots = torch.arange(C, device=x.device)
        dispatch = combine = None
        for j in range(K):
            onehot = _one_hot(idx[j], E).long()                 # [N, E]
            # the running count down the tokens, as a scan along the
            # inner axis of the [E, N] transpose (a scan down the outer
            # axis of [N, E] runs E lanes wide on the card)
            run = torch.cumsum(onehot.T.contiguous(), 1).T
            pos = (run - 1 + counts[None]) * onehot
            kept = (pos < C) & (onehot > 0)
            disp = ((pos.clamp(0, C - 1)[..., None] == slots)
                    & kept[..., None]).to(dt)                   # [N, E, C]
            comb = disp * top_gates[:, j, None, None].to(dt)
            # 0 + v is v for these non-negative entries: the first round
            # takes its tensors as they are
            dispatch = disp if dispatch is None else dispatch + disp
            combine = comb if combine is None else combine + comb
            counts = counts + (onehot * kept).sum(0)
            kept_total = kept_total + kept.sum()

        expert_in = _einsum("nd,nec->ecd", xf, dispatch)        # [E, C, D]
        h = self.act(_einsum("ecd,edh->ech", expert_in, self.w1)
                     + self.b1[:, None, :])
        expert_out = _einsum("ech,ehd->ecd", h, self.w2) \
            + self.b2[:, None, :]
        out = _einsum("ecd,nec->nd", expert_out, combine).reshape(B, T, D)
        if not (return_aux or return_stats):
            return out
        frac = _one_hot(idx[0], E).float().mean(0)
        aux = E * (frac * probs.float().mean(0)).sum()
        if not return_stats:
            return out, aux
        stats = {"drop_rate": 1.0 - kept_total.float() / (N * K),
                 "expert_fraction": frac,
                 "capacity": torch.full((), C, dtype=torch.int32,
                                        device=x.device)}
        if not return_aux:
            return out, stats
        return out, aux, stats
