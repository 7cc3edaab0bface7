"""Parameter initializers — the port of ``paddle_tpu/core/initializers.py``.

The JAX initializers are ``(rng, shape, dtype) -> array`` functions; here
each is an in-place fill ``init(t, generator=None) -> t`` of an existing
tensor, drawing from an explicit :class:`torch.Generator`. The
distributions, their bounds and standard deviations, and the fan rule
(:func:`fans`, JAX's ``_fans``: ``[in, out]`` for a matrix, receptive
field times channels for an HWIO kernel or any stacked leading axes)
are JAX's; the values differ from JAX's for the same seed. ``constant``,
``normal``, ``uniform`` and ``orthogonal`` take their settings and return
the fill, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch

__all__ = ["zeros", "ones", "constant", "normal", "uniform",
           "fan_in_uniform", "xavier_uniform", "xavier_normal",
           "msra_normal", "lecun_normal", "orthogonal", "fans",
           "fan_in_uniform_", "xavier_uniform_", "msra_normal_", "normal_"]

Init = Callable[..., torch.Tensor]


def fans(shape: Sequence[int]) -> Tuple[int, int]:
    """``(fan_in, fan_out)`` of a parameter shape, JAX's ``_fans``: 1 for
    a scalar, the length for a vector, ``[in, out]`` for a matrix, and
    for more axes the last two times the product of the leading ones."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def _uniform(t: torch.Tensor, s: float, generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-s, s, generator=generator)


def normal_(t: torch.Tensor, std: float, generator=None,
            mean: float = 0.0) -> torch.Tensor:
    """Fill ``t`` from N(mean, std²)."""
    with torch.no_grad():
        return t.normal_(mean, std, generator=generator)


def zeros(t: torch.Tensor, generator=None) -> torch.Tensor:
    with torch.no_grad():
        return t.zero_()


def ones(t: torch.Tensor, generator=None) -> torch.Tensor:
    with torch.no_grad():
        return t.fill_(1.0)


def constant(value: float) -> Init:
    def _init(t: torch.Tensor, generator=None) -> torch.Tensor:
        with torch.no_grad():
            return t.fill_(value)
    return _init


def normal(stddev: float = 0.01, mean: float = 0.0) -> Init:
    def _init(t: torch.Tensor, generator=None) -> torch.Tensor:
        return normal_(t, stddev, generator, mean)
    return _init


def uniform(scale: float = 0.01) -> Init:
    def _init(t: torch.Tensor, generator=None) -> torch.Tensor:
        return _uniform(t, scale, generator)
    return _init


def fan_in_uniform(t: torch.Tensor, generator=None) -> torch.Tensor:
    """U(-s, s) with s = 1/sqrt(fan_in), the reference's default."""
    fan_in, _ = fans(t.shape)
    return _uniform(t, 1.0 / math.sqrt(max(1, fan_in)), generator)


def xavier_uniform(t: torch.Tensor, generator=None) -> torch.Tensor:
    """U(-s, s) with s = sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = fans(t.shape)
    return _uniform(t, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def xavier_normal(t: torch.Tensor, generator=None) -> torch.Tensor:
    """N(0, 2 / (fan_in + fan_out))."""
    fan_in, fan_out = fans(t.shape)
    return normal_(t, math.sqrt(2.0 / (fan_in + fan_out)), generator)


def msra_normal(t: torch.Tensor, generator=None) -> torch.Tensor:
    """N(0, 2 / fan_in) (He)."""
    fan_in, _ = fans(t.shape)
    return normal_(t, math.sqrt(2.0 / max(1, fan_in)), generator)


def lecun_normal(t: torch.Tensor, generator=None) -> torch.Tensor:
    """N(0, 1 / fan_in)."""
    fan_in, _ = fans(t.shape)
    return normal_(t, math.sqrt(1.0 / max(1, fan_in)), generator)


def orthogonal(scale: float = 1.0) -> Init:
    """``scale`` times a matrix with orthonormal columns (rows, where
    there are fewer rows than columns) over ``[prod(shape[:-1]),
    shape[-1]]``: the Q of a QR of a Gaussian matrix, its columns' signs
    fixed by R's diagonal. A vector or scalar takes ``normal(0.01)``."""
    def _init(t: torch.Tensor, generator=None) -> torch.Tensor:
        if t.dim() < 2:
            return normal_(t, 0.01, generator)
        rows, cols = math.prod(t.shape[:-1]), t.shape[-1]
        a = torch.empty(max(rows, cols), min(rows, cols),
                        dtype=torch.float32, device=t.device)
        normal_(a, 1.0, generator)
        q, r = torch.linalg.qr(a)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        with torch.no_grad():
            return t.copy_((scale * q[:rows, :cols]).reshape(t.shape))
    return _init


# the names the port's layers used before this module held them
fan_in_uniform_ = fan_in_uniform
xavier_uniform_ = xavier_uniform
msra_normal_ = msra_normal
