"""First-order optimizers — the port of ``sgd``, ``momentum``, ``adam``,
``chain``, ``clip_by_global_norm``, ``weight_decay``, ``global_norm`` and
``apply_updates`` from ``paddle_tpu/optim/optimizers.py``.

The idiom: functions over a model's named parameters, ``params =
dict(model.named_parameters())``. An :class:`Optimizer` is ``(init,
update)`` as in the JAX package: ``state = init(params)`` and ``updates,
state = update(grads, state, params, step)``, where ``grads`` and
``updates`` are dicts keyed like ``params`` and ``step`` is an int that
counts from 0. Unlike JAX, ``update`` changes the state's tensors in place
(and returns the same state), and :func:`apply_updates` adds the updates
to the parameters in place under ``torch.no_grad()``. State slots (Adam's
m and v, momentum's velocity) are f32. The math is the JAX package's:
Adam's update is ``-lr(step) * (m / bc1) / (sqrt(v / bc2) + eps)`` with
``t = step + 1`` and the bias corrections ``bc = 1 - b**t`` in f32.
Adagrad, FTRL, LAMB and the rest are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from . import schedules as S

__all__ = ["AdamState", "Optimizer", "adam", "apply_updates", "chain",
           "clip_by_global_norm", "global_norm", "momentum", "sgd",
           "weight_decay"]

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A gradient transform: ``state = init(params)``; ``updates, state =
    update(grads, state, params, step)``. ``updates`` are deltas added to
    the parameters."""
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Tensors, int], Tuple[Tensors, Any]]

    def apply(self, grads: Tensors, state, params: Tensors, step: int):
        """One update applied to ``params`` in place; returns the state."""
        updates, state = self.update(grads, state, params, step)
        apply_updates(params, updates)
        return state


class AdamState(NamedTuple):
    m: Tensors
    v: Tensors


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> Tensors:
    """``p += u`` in place for every parameter, cast to its dtype."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))
    return params


@torch.no_grad()
def global_norm(tree: Tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, in f32."""
    sq = [t.float().square().sum() for t in tree.values()]
    if not sq:
        return torch.zeros(())
    return torch.sqrt(torch.stack(sq).sum())


def _zeros(params: Tensors) -> Tensors:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


def _lr_fn(lr, schedule) -> Callable[[int], float]:
    if callable(lr):
        if schedule is not None:
            raise ValueError("pass either a callable lr or (base lr + "
                             "schedule), not both")
        return lr
    sched = schedule or S.constant()
    return lambda step: lr * sched(step)


def sgd(lr, schedule=None) -> Optimizer:
    """Plain SGD: ``-lr(step) * g``."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        lr_t = lrf(step)
        return {n: -lr_t * g.float() for n, g in grads.items()}, state
    return Optimizer(init, update)


def momentum(lr, mu: float = 0.9, nesterov: bool = False,
             schedule=None) -> Optimizer:
    """SGD with (Nesterov) momentum: ``v = mu*v - lr*g``; the update is
    ``v``, or ``mu*v - lr*g`` again with ``nesterov``."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return _zeros(params)

    @torch.no_grad()
    def update(grads, vel, params, step):
        lr_t = lrf(step)
        upd = {}
        for n, g in grads.items():
            g32 = g.float()
            v = vel[n].mul_(mu).sub_(lr_t * g32)
            upd[n] = mu * v - lr_t * g32 if nesterov else v.clone()
        return upd, vel
    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         schedule=None) -> Optimizer:
    """Adam with bias correction; the state is :class:`AdamState` of f32
    ``m`` and ``v``."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return AdamState(_zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, st, params, step):
        t = np.float32(step + 1)
        lr_t = lrf(step)
        # in f32, as the JAX step computes them: 1 - 0.999 alone is off
        # by 1.3e-5 relative to its f64 value
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        upd = {}
        for n, g in grads.items():
            g32 = g.float()
            m = st.m[n].mul_(b1).add_((1 - b1) * g32)
            v = st.v[n].mul_(b2).add_((1 - b2) * g32.square())
            upd[n] = -lr_t * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        return upd, st
    return Optimizer(init, update)


def chain(*transforms: Optimizer) -> Optimizer:
    """Compose gradient transforms left to right (clip, decay, rule)."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, states, params, step):
        new_states = []
        cur = grads
        for t, st in zip(transforms, states):
            cur, ns = t.update(cur, st, params, step)
            new_states.append(ns)
        return cur, tuple(new_states)
    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    """Scale every gradient by ``min(1, max_norm / global_norm)``."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
        return {n: g * scale.to(g.device) for n, g in grads.items()}, state
    return Optimizer(init, update)


def weight_decay(decay: float) -> Optimizer:
    """L2 decay added to the gradients before the rule: ``g + decay*p``."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        return {n: g + decay * params[n].to(g.dtype)
                for n, g in grads.items()}, state
    return Optimizer(init, update)

