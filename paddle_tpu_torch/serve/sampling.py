"""Seeded stochastic decoding — the port of ``SamplingConfig``,
``_filter_logits`` and ``_sample_tokens`` from
``paddle_tpu/serve/engine.py``, with the port's own copy of the JAX
package's counter-based generator.

The JAX engine draws from threefry-2x32 (JAX's default ``PRNGKey``
implementation, under its partitionable layout of random bits). That
generator is pure 32-bit integer arithmetic, so it is written here in
plain torch integer ops: uint32 values held in int64 tensors, masked to
32 bits after every addition and shift. Three things follow:

- the same keys and the same uniform bits as JAX on the same seed, so a
  sampled token stream can be held against the JAX engine;
- a generator without state: a key is a function of the seed and
  counters, so a captured CUDA graph computes its keys from counters that
  live in device buffers, with nothing to register;
- the same draws on the CPU and on the card.

A key is a pair ``(k0, k1)`` of uint32 values: Python ints (a constant
key, computed on the host) or int64 tensors of one shape (a batch of
keys). Nothing here reads a tensor's value on the host or copies a
Python value to the device, so the draws can run inside a CUDA graph.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["SamplingConfig", "prng_key", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical", "filter_logits",
           "sample_tokens", "tick_keys"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = torch.finfo(torch.float32).tiny

Key = Tuple[Union[int, torch.Tensor], Union[int, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Stochastic decoding knobs. Applied inside the tick with a per-slot,
    per-tick key (``fold_in(fold_in(PRNGKey(seed), tick), slot)``), so a
    fixed seed replays the exact token stream. Filters compose in the
    conventional order: temperature scaling, then top-k truncation, then
    top-p (nucleus) truncation."""
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0

    def validate(self, vocab: int) -> None:
        if not self.temperature > 0:
            raise ValueError(f"temperature must be > 0 (greedy is "
                             f"sampling=None), got {self.temperature}")
        if self.top_k is not None and not 1 <= self.top_k <= vocab:
            raise ValueError(f"top_k must be in [1, {vocab}], "
                             f"got {self.top_k}")
        if self.top_p is not None and not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


# ---------------------------------------------------------------------------
# threefry-2x32
# ---------------------------------------------------------------------------

def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _threefry2x32(k0, k1, x0, x1) -> Key:
    """The threefry-2x32 block (20 rounds) of key ``(k0, k1)`` over the
    counters ``(x0, x1)``; all uint32 values in int64 tensors (or Python
    ints), broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def _u32(v):
    """``v`` (an int or an integer tensor) as uint32 values: a Python int,
    or an int64 tensor on ``v``'s device."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _MASK
    return int(v) & _MASK


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``(0, seed mod
    2**32)``, as Python ints."""
    return 0, _u32(seed)


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: the block of ``key`` over the counters
    ``(0, data)``. ``data`` (an int or an integer tensor) broadcasts
    against the key batch; a key of ints folded with an int stays ints."""
    k0, k1 = key
    return _threefry2x32(k0, k1, 0, _u32(data))


def random_bits(key: Key, n: int, device) -> torch.Tensor:
    """``n`` 32-bit words of each key of the batch, ``[*batch, n]`` on
    ``device`` (the partitionable layout: word ``i`` is ``y0 ^ y1`` of the
    block over the counters ``(0, i)``)."""
    k0, k1 = (k[..., None] if isinstance(k, torch.Tensor) else k
              for k in key)
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = _threefry2x32(k0, k1, 0, i)
    return y0 ^ y1


def uniform(key: Key, n: Optional[int] = None, minval: float = 0.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform`` in f32 over ``[minval, 1)``: ``[*batch, n]``,
    or ``[*batch]`` with ``n=None`` (a scalar draw per key). The top 23
    bits of each word become the mantissa of a float in ``[1, 2)``, less
    1; with ``minval`` the result is ``max(minval, f * (1 - minval) +
    minval)`` in f32, as JAX computes it. ``device`` defaults to the
    key's."""
    if device is None:
        device = next(k.device for k in key if isinstance(k, torch.Tensor))
    bits = random_bits(key, 1 if n is None else n, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if minval:
        lo = np.float32(minval)
        f = torch.clamp_min(f * float(np.float32(1.0) - lo) + float(lo),
                            float(lo))
    return f[..., 0] if n is None else f


def gumbel(key: Key, n: int, device) -> torch.Tensor:
    """Standard Gumbel noise ``[*batch, n]``: ``-log(-log(u))`` with ``u``
    uniform over ``[tiny, 1)`` (JAX's low-dynamic-range sampler)."""
    return -torch.log(-torch.log(uniform(key, n, _F32_TINY, device)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, one key per row:
    ``argmax(gumbel + logits)`` (the first index on ties), int64
    ``[*batch]``. ``-inf`` logits are never drawn."""
    return torch.argmax(gumbel(key, logits.shape[-1], logits.device) + logits,
                        dim=-1)


def tick_keys(seed: int, tick: torch.Tensor, slots: int) -> Key:
    """The tick's per-slot keys ``fold_in(fold_in(PRNGKey(seed), tick),
    slot)`` for ``slot < slots``, ``[slots]`` each; ``tick`` a one-entry
    tensor (a device counter: nothing here reads its value on the
    host)."""
    k0, k1 = fold_in(prng_key(seed), tick)
    s = torch.arange(slots, dtype=torch.int64, device=tick.device)
    return fold_in((k0, k1), s)


# ---------------------------------------------------------------------------
# the filtered target distribution and its draws
# ---------------------------------------------------------------------------

def filter_logits(cfg: SamplingConfig, logits: torch.Tensor) -> torch.Tensor:
    """Temperature -> top-k -> top-p filtering over the last axis (any
    leading shape), in f32: the filtered logits define the target
    distribution that plain sampling and the speculative rejection rule
    draw from. Top-k keeps the values at or above the k-th largest; top-p
    keeps the values at or above the smallest of the descending sorted
    values whose preceding probability mass is below p (the head always
    survives both). Dropped entries are ``-inf``."""
    x = logits.float() / cfg.temperature
    if cfg.top_k is not None:
        kth = torch.topk(x, cfg.top_k, dim=-1).values[..., -1:]
        x = x.masked_fill(~(x >= kth), float("-inf"))
    if cfg.top_p is not None:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        # softmax as JAX writes it: exp(x - max) / sum
        e = torch.exp(sorted_x - sorted_x[..., :1])
        probs = e / e.sum(-1, keepdim=True)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < cfg.top_p
        cutoff = sorted_x.masked_fill(~keep, float("inf")).amin(
            -1, keepdim=True)
        x = x.masked_fill(~(x >= cutoff), float("-inf"))
    return x


def sample_tokens(cfg: SamplingConfig, logits: torch.Tensor,
                  key: Key) -> torch.Tensor:
    """Draws from the filtered target distribution: ``logits [*batch, V]``
    and a key per row -> int64 ``[*batch]``."""
    return categorical(key, filter_logits(cfg, logits))
