"""Dtype policy: params kept in one dtype, compute optionally cast to
another, reductions accumulated in a third — the port of
``paddle_tpu/core/dtypes.py``. :data:`float32` runs everything in f32;
:data:`bfloat16_compute` (what the JAX benchmarks train under) keeps the
parameters and the optimizer in f32, casts the operands of products and
convolutions to bf16, and accumulates products and losses in f32.

The policy in force is the innermost :func:`use_policy` of the calling
thread, read when a layer runs its forward. Autograd runs the backward of
a CUDA tensor on a device thread of its own, where the policy is
:data:`float32`: no backward reads the policy, each takes its dtypes from
the tensors it saved.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

__all__ = ["Policy", "float32", "bfloat16_compute", "current_policy",
           "use_policy", "canonicalize"]


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_accum(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.accum_dtype)


float32 = Policy()
bfloat16_compute = Policy(param_dtype=torch.float32,
                          compute_dtype=torch.bfloat16,
                          accum_dtype=torch.float32)

_tls = threading.local()


def _stack() -> list:
    if not hasattr(_tls, "stack"):
        _tls.stack = [float32]
    return _tls.stack


def current_policy() -> Policy:
    return _stack()[-1]


@contextlib.contextmanager
def use_policy(policy: Policy):
    _stack().append(policy)
    try:
        yield policy
    finally:
        _stack().pop()


_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int32": torch.int32, "int8": torch.int8}


def canonicalize(name):
    """A dtype name (``"float32"``, ``"bfloat16"``, ``"float16"``,
    ``"int32"``, ``"int8"``) as its ``torch`` dtype; anything else is
    returned as it is."""
    if isinstance(name, str):
        return _NAMES[name]
    return name
