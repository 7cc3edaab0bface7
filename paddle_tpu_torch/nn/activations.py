"""Activations — the port of ``paddle_tpu/nn/activations.py``: every
activation of the JAX module under its name, and :func:`get` over JAX's
table of config names (``"abs"``, ``"log"`` and ``"sqrt"`` name
:func:`abs_act`, :func:`log_act` and :func:`sqrt_act`; ``""``,
``"linear"`` and ``"identity"`` the identity). Each computes in its
input's dtype, as the JAX functions do.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "abs_act", "brelu", "elu", "exp", "gelu", "get",
           "identity", "leaky_relu", "log_act", "reciprocal", "relu",
           "sequence_softmax", "sigmoid", "silu", "softmax", "softrelu",
           "softsign", "sqrt_act", "square", "stanh", "tanh"]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def brelu(x: torch.Tensor, t_min: float = 0.0,
          t_max: float = 24.0) -> torch.Tensor:
    """Bounded ReLU: ``x`` clipped to ``[t_min, t_max]``."""
    return torch.clamp(x, t_min, t_max)


def tanh(x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x)


def stanh(x: torch.Tensor, a: float = 1.7159,
          b: float = 2.0 / 3.0) -> torch.Tensor:
    """Scaled tanh (LeCun): ``a * tanh(b * x)``."""
    return a * torch.tanh(b * x)


def softrelu(x: torch.Tensor, threshold: float = 40.0) -> torch.Tensor:
    """``log(1 + exp(x))`` with ``x`` clipped to ``[-threshold,
    threshold]`` first, as the reference does."""
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


def abs_act(x: torch.Tensor) -> torch.Tensor:
    return torch.abs(x)


def square(x: torch.Tensor) -> torch.Tensor:
    return x * x


def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


def log_act(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x)


def sqrt_act(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x)


def reciprocal(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / x


def softsign(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + torch.abs(x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, alpha)


def elu(x: torch.Tensor) -> torch.Tensor:
    return F.elu(x)


def sequence_softmax(x: torch.Tensor, lengths=None,
                     mask=None) -> torch.Tensor:
    """Softmax over the time axis of ``[B, T]`` (or ``[B, T, 1]``) scores
    honouring sequence validity: ``lengths [B]`` or ``mask [B, T]`` (> 0 =
    valid). Invalid steps are masked with ``-1e9`` before the softmax,
    then zeroed and the rest renormalised (a row with no valid step gives
    zeros)."""
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    if squeeze:
        x = x[..., 0]
    if mask is None and lengths is not None:
        t = x.shape[1]
        mask = (torch.arange(t, device=x.device)[None, :]
                < lengths[:, None]).to(x.dtype)
    if mask is not None:
        x = torch.where(mask > 0, x, torch.full_like(x, -1e9))
    out = torch.softmax(x, dim=1)
    if mask is not None:
        out = out * mask
        out = out / out.sum(dim=1, keepdim=True).clamp_min(1e-9)
    return out[..., None] if squeeze else out


ACTIVATIONS = {
    "": identity,
    "linear": identity,
    "identity": identity,
    "sigmoid": sigmoid,
    "softmax": softmax,
    "relu": relu,
    "brelu": brelu,
    "tanh": tanh,
    "stanh": stanh,
    "softrelu": softrelu,
    "abs": abs_act,
    "square": square,
    "exp": exp,
    "log": log_act,
    "sqrt": sqrt_act,
    "reciprocal": reciprocal,
    "softsign": softsign,
    "gelu": gelu,
    "silu": silu,
    "leaky_relu": leaky_relu,
    "elu": elu,
}


class UnknownActivation(KeyError, ValueError):
    """A name not in :data:`ACTIVATIONS`: a ``KeyError``, as JAX's ``get``
    raises, and a ``ValueError``, as the port's raised before it held the
    whole table."""


def get(name) -> Callable[[torch.Tensor], torch.Tensor]:
    """An activation by config name, or a callable passed through."""
    if callable(name):
        return name
    if name not in ACTIVATIONS:
        raise UnknownActivation(f"unknown activation '{name}'; have "
                                f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]
