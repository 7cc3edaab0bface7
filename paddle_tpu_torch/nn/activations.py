"""Activations the port's models use — the port of the matching entries
of ``paddle_tpu/nn/activations.py``."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["gelu", "get", "relu"]


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


_ACTS = {"": _identity, "gelu": gelu, "relu": relu}


def get(act) -> Callable[[torch.Tensor], torch.Tensor]:
    """An activation by name (``""`` is the identity) or a callable."""
    if callable(act):
        return act
    try:
        return _ACTS[act]
    except KeyError:
        raise ValueError(f"unknown activation {act!r}; the port has "
                         f"{sorted(k for k in _ACTS if k)}") from None
