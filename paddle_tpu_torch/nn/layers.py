"""Main-path layers — the port of ``Linear``, ``Embedding``,
``LayerNorm`` and ``Dropout`` from ``paddle_tpu/nn/layers.py``.

Parameters keep the JAX package's names and layouts (``Linear.w`` is
``[in, out]`` and applied as ``x @ w``), so weights cross from a JAX
checkpoint by path name with no transposes (``utils/bridge.py``).
Initializers follow ``paddle_tpu/core/initializers.py`` in distribution;
they draw from an explicit :class:`torch.Generator`, so the values differ
from JAX's for the same seed.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.dtypes import current_policy
from . import activations

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "fan_in_uniform_",
           "xavier_uniform_", "normal_"]


def fan_in_uniform_(t: torch.Tensor, generator=None) -> torch.Tensor:
    """U(-s, s) with s = 1/sqrt(fan_in) for ``[in, out]``
    (``initializers.fan_in_uniform``)."""
    s = 1.0 / math.sqrt(max(1, t.shape[0]))
    with torch.no_grad():
        return t.uniform_(-s, s, generator=generator)


def xavier_uniform_(t: torch.Tensor, generator=None) -> torch.Tensor:
    """U(-s, s) with s = sqrt(6 / (fan_in + fan_out)) for ``[in, out]``."""
    s = math.sqrt(6.0 / (t.shape[0] + t.shape[1]))
    with torch.no_grad():
        return t.uniform_(-s, s, generator=generator)


def normal_(t: torch.Tensor, std: float, generator=None) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


class Linear(nn.Module):
    """``act(x @ w + b)`` with ``w`` ``[in, out]``; the product runs in
    the policy's compute dtype and is returned in its accumulate dtype."""

    def __init__(self, in_features: int, features: int, act="",
                 device=None, generator=None):
        super().__init__()
        self.act = activations.get(act)
        self.w = nn.Parameter(torch.empty(in_features, features,
                                          device=device))
        fan_in_uniform_(self.w, generator)
        self.b = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pol = current_policy()
        y = (pol.cast_compute(x) @ pol.cast_compute(self.w)).to(
            pol.accum_dtype)
        return self.act(y + self.b)


class Embedding(nn.Module):
    """Table lookup ``w[ids]``; out-of-range ids (padding = -1, or past
    the vocabulary) give zero rows where ``torch``'s lookup would raise.
    :meth:`attend` is the tied readout ``x @ w.T``."""

    def __init__(self, vocab: int, dim: int, std: Optional[float] = None,
                 device=None, generator=None):
        super().__init__()
        self.vocab = vocab
        self.dim = dim
        self.w = nn.Parameter(torch.empty(vocab, dim, device=device))
        normal_(self.w, 1.0 / math.sqrt(dim) if std is None else std,
                generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        valid = (ids >= 0) & (ids < self.vocab)
        out = self.w[ids.clamp(0, self.vocab - 1)]
        return out * valid.unsqueeze(-1).to(out.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w.T


class LayerNorm(nn.Module):
    """Layer normalization with f32 statistics and eps ``1e-6`` (torch's
    default is ``1e-5``); the result is cast back to the input dtype."""

    eps = 1e-6

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.scale + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout: in training each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``; the
    identity when ``train`` is false or the rate is 0. The mask is drawn
    from ``generator`` (default: one on the input's device seeded with 0,
    made at first use), so it differs from JAX's for the same seed."""

    def __init__(self, rate: float, generator=None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train or self.rate <= 0.0:
            return x
        if self.generator is None:
            self.generator = torch.Generator(device=x.device).manual_seed(0)
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))
