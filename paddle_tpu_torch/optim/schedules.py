"""Learning-rate schedules — the port of ``paddle_tpu/optim/schedules.py``.

A schedule is a plain ``step -> multiplier`` function of an int step,
applied to the base learning rate by multiplication: constant, poly,
caffe_poly, exp, discexp, linear, manual (piecewise constant),
warmup_linear, cosine_decay, and ``chain`` to multiply several.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = ["constant", "poly", "caffe_poly", "exponential", "discexp",
           "linear", "manual", "warmup_linear", "cosine_decay", "chain"]

Schedule = Callable[[int], float]


def constant() -> Schedule:
    return lambda step: 1.0


def poly(a: float, b: float) -> Schedule:
    """``(1 + a*t)^(-b)``."""
    return lambda step: (1.0 + a * step) ** (-b)


def caffe_poly(a: float, b: float, max_steps: int) -> Schedule:
    """``(1 - min(t, max)/max)^b``; ``a`` is unused, as in the JAX
    package."""
    return lambda step: (1.0 - min(step, max_steps) / max_steps) ** b


def exponential(a: float, b: float) -> Schedule:
    """``a^(t/b)``."""
    return lambda step: a ** (step / b)


def discexp(a: float, b: float) -> Schedule:
    """``a^floor(t/b)``."""
    return lambda step: a ** math.floor(step / b)


def linear(a: float, b: float) -> Schedule:
    """``max(1 - a*t, b)``."""
    return lambda step: max(1.0 - a * step, b)


def manual(boundaries: Sequence[int], values: Sequence[float]) -> Schedule:
    """Piecewise constant: ``values[i]`` from step ``boundaries[i-1]`` on."""
    bs, vs = list(boundaries), list(values)
    if len(vs) != len(bs) + 1:
        raise ValueError("manual: need one more value than boundaries")

    def sched(step):
        mult = vs[0]
        for b, v in zip(bs, vs[1:]):
            if step >= b:
                mult = v
        return mult
    return sched


def warmup_linear(warmup_steps: int) -> Schedule:
    return lambda step: min(1.0, (step + 1) / max(1, warmup_steps))


def cosine_decay(decay_steps: int, alpha: float = 0.0) -> Schedule:
    def sched(step):
        t = min(step, decay_steps) / decay_steps
        return alpha + (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t))
    return sched


def chain(*schedules: Schedule) -> Schedule:
    """The product of the schedules (e.g. warmup times cosine)."""
    def sched(step):
        m = 1.0
        for s in schedules:
            m = m * s(step)
        return m
    return sched
