"""First-order optimizers — the port of ``paddle_tpu/optim/optimizers.py``:
the rules ``sgd``, ``momentum``, ``adagrad``, ``decayed_adagrad``,
``adadelta``, ``rmsprop``, ``adam``, ``adamax``, ``ftrl`` and ``lamb``; the
transforms ``chain``, ``clip_by_global_norm``, ``clip_by_value``,
``weight_decay``, ``l1_decay`` and ``static_pruning``; ``polyak_average``
(:class:`EMA`), ``global_norm`` and ``apply_updates``.

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

Each state has the JAX state's structure: a params-shaped dict where JAX
keeps a params-shaped tree, and a NamedTuple with the JAX NamedTuple's
fields in their order (``AdamState(m, v)``, ``RMSPropState(ms, mg,
mom)``, ...), so that ``utils/bridge.py`` and the checkpoint carry it
across frameworks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Tuple

import numpy as np
import torch

from . import schedules as S

__all__ = ["AdaDeltaState", "AdamState", "AdamaxState", "EMA", "FtrlState",
           "LambState", "Optimizer", "PruningState", "RMSPropState",
           "adadelta", "adagrad", "adam", "adamax", "apply_updates", "chain",
           "clip_by_global_norm", "clip_by_value", "decayed_adagrad", "ftrl",
           "global_norm", "l1_decay", "lamb", "momentum", "polyak_average",
           "rmsprop", "sgd", "static_pruning", "weight_decay"]

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


class AdaDeltaState(NamedTuple):
    accum: Tensors
    accum_update: Tensors


class RMSPropState(NamedTuple):
    ms: Tensors
    mg: Tensors
    mom: Tensors


class AdamaxState(NamedTuple):
    m: Tensors
    u: Tensors


class FtrlState(NamedTuple):
    n: Tensors
    z: Tensors


class LambState(NamedTuple):
    m: Tensors
    v: Tensors


class PruningState(NamedTuple):
    inner: Any
    mask: Tensors
    first: torch.Tensor         # 0-d bool: the first update is pending


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


def adagrad(lr, eps: float = 1e-6, schedule=None) -> Optimizer:
    """Adagrad: ``a += g**2``; the update is ``-lr * g / (sqrt(a) + eps)``.
    The state is the params-shaped accumulator."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return _zeros(params)

    @torch.no_grad()
    def update(grads, accum, params, step):
        lr_t = lrf(step)
        upd = {}
        for n, g in grads.items():
            g32 = g.float()
            a = accum[n].add_(g32.square())
            upd[n] = -lr_t * g32 / (torch.sqrt(a) + eps)
        return upd, accum
    return Optimizer(init, update)


def decayed_adagrad(lr, rho: float = 0.95, eps: float = 1e-6,
                    schedule=None) -> Optimizer:
    """Adagrad over a decayed accumulator: ``a = rho*a + (1-rho)*g**2``."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return _zeros(params)

    @torch.no_grad()
    def update(grads, accum, params, step):
        lr_t = lrf(step)
        upd = {}
        for n, g in grads.items():
            g32 = g.float()
            a = accum[n].mul_(rho).add_((1 - rho) * g32.square())
            upd[n] = -lr_t * g32 / (torch.sqrt(a) + eps)
        return upd, accum
    return Optimizer(init, update)


def adadelta(rho: float = 0.95, eps: float = 1e-6, lr: float = 1.0,
             schedule=None) -> Optimizer:
    """AdaDelta: :class:`AdaDeltaState` of the decayed squared gradient and
    the decayed squared update; the update is ``-lr * sqrt(au + eps) /
    sqrt(a + eps) * g``."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return AdaDeltaState(_zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, st, params, step):
        lr_t = lrf(step)
        upd = {}
        for n, g in grads.items():
            g32 = g.float()
            a = st.accum[n].mul_(rho).add_((1 - rho) * g32.square())
            au = st.accum_update[n]
            u = -lr_t * torch.sqrt(au + eps) / torch.sqrt(a + eps) * g32
            au.mul_(rho).add_((1 - rho) * u.square())
            upd[n] = u
        return upd, st
    return Optimizer(init, update)


def rmsprop(lr, rho: float = 0.95, eps: float = 1e-6,
            momentum_coef: float = 0.0, centered: bool = True,
            schedule=None) -> Optimizer:
    """RMSProp, centered by default (E[g] kept beside E[g**2]), with an
    optional momentum on the scaled step: :class:`RMSPropState` of ``ms``,
    ``mg`` and ``mom``."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return RMSPropState(_zeros(params), _zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, st, params, step):
        lr_t = lrf(step)
        upd = {}
        for n, g in grads.items():
            g32 = g.float()
            ms = st.ms[n].mul_(rho).add_((1 - rho) * g32.square())
            if centered:
                mg = st.mg[n].mul_(rho).add_((1 - rho) * g32)
                denom = torch.sqrt(ms - mg.square() + eps)
            else:
                denom = torch.sqrt(ms + eps)
            raw = -lr_t * g32 / denom
            if momentum_coef > 0:
                upd[n] = st.mom[n].mul_(momentum_coef).add_(raw).clone()
            else:
                upd[n] = raw
        return upd, st
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


def adamax(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           schedule=None) -> Optimizer:
    """Adamax: :class:`AdamaxState` of the first moment and the decayed
    infinity norm ``u = max(b2*u, |g|)``; the update is ``-lr / (1 -
    b1**t) * m / (u + eps)``."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return AdamaxState(_zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, st, params, step):
        t = np.float32(step + 1)
        lr_t = lrf(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        upd = {}
        for n, g in grads.items():
            g32 = g.float()
            m = st.m[n].mul_(b1).add_((1 - b1) * g32)
            u = torch.maximum(st.u[n].mul_(b2), g32.abs(), out=st.u[n])
            upd[n] = -lr_t / bc1 * m / (u + eps)
        return upd, st
    return Optimizer(init, update)


def ftrl(lr, lambda1: float = 0.0, lambda2: float = 0.0, beta: float = 1.0,
         schedule=None) -> Optimizer:
    """FTRL-proximal: :class:`FtrlState` of ``n`` (summed squared
    gradients) and ``z``; the update moves each parameter to its closed-form
    proximal value (0 where ``|z| <= lambda1``)."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return FtrlState(_zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, st, params, step):
        lr_t = lrf(step)
        upd = {}
        for name, g in grads.items():
            g32 = g.float()
            p32 = params[name].float()
            n = st.n[name]
            new_n = n + g32 * g32
            sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr_t
            z = st.z[name]
            z.copy_(z + g32 - sigma * p32)
            new_p = torch.where(
                z.abs() <= lambda1, torch.zeros_like(z),
                -(z - torch.sign(z) * lambda1)
                / ((beta + torch.sqrt(new_n)) / lr_t + lambda2))
            n.copy_(new_n)
            upd[name] = new_p - p32
        return upd, st
    return Optimizer(init, update)


def lamb(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         wd: float = 0.0, schedule=None) -> Optimizer:
    """LAMB: Adam's direction plus decoupled decay ``wd * p``, scaled per
    tensor by the trust ratio ``|p| / |r|`` (1 where either norm is 0):
    :class:`LambState` of ``m`` and ``v``."""
    lrf = _lr_fn(lr, schedule)

    def init(params):
        return LambState(_zeros(params), _zeros(params))

    @torch.no_grad()
    def update(grads, st, params, step):
        t = np.float32(step + 1)
        lr_t = lrf(step)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        upd = {}
        for n, g in grads.items():
            g32 = g.float()
            p32 = params[n].float()
            m = st.m[n].mul_(b1).add_((1 - b1) * g32)
            v = st.v[n].mul_(b2).add_((1 - b2) * g32.square())
            r = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p32
            p_norm = torch.linalg.vector_norm(p32)
            r_norm = torch.linalg.vector_norm(r)
            trust = torch.where((p_norm > 0) & (r_norm > 0),
                                p_norm / r_norm, torch.ones_like(p_norm))
            upd[n] = -lr_t * trust * r
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



def clip_by_value(limit: float) -> Optimizer:
    """Clip every gradient entry to ``[-limit, limit]``."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        return {n: torch.clamp(g, -limit, limit)
                for n, g in grads.items()}, state
    return Optimizer(init, update)


def l1_decay(decay: float) -> Optimizer:
    """L1 subgradient decay added to the gradients: ``g + decay *
    sign(p)``."""

    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params, step):
        return {n: g + decay * torch.sign(params[n].to(g.dtype))
                for n, g in grads.items()}, state
    return Optimizer(init, update)


def polyak_average(decay: float = 0.999) -> "EMA":
    return EMA(decay)


@dataclasses.dataclass(frozen=True)
class EMA:
    """Polyak (exponential moving) averaging of the parameters: ``avg =
    init(params)`` (an f32 copy), then ``update(avg, params)`` sets ``avg
    = decay * avg + (1 - decay) * p`` in place and returns it. Apply the
    average around evaluation."""
    decay: float = 0.999

    @torch.no_grad()
    def init(self, params: Tensors) -> Tensors:
        return {n: p.detach().float().clone() for n, p in params.items()}

    @torch.no_grad()
    def update(self, avg: Tensors, params: Tensors, step=None) -> Tensors:
        d = self.decay
        for n, a in avg.items():
            a.mul_(d).add_((1 - d) * params[n].float())
        return avg


def _prune_mask(p: torch.Tensor, sparsity: float) -> torch.Tensor:
    flat = p.detach().float().abs().reshape(-1)
    k = int(sparsity * flat.numel())
    if k == 0:
        return torch.ones_like(p, dtype=torch.float32)
    # rank by magnitude, ties broken by position (a stable sort, as
    # jnp.argsort): exactly k entries pruned even when many are equal, so a
    # zero-initialised bias loses k entries, not all of them
    order = torch.sort(flat, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(flat.numel(), device=flat.device)
    return (rank >= k).to(torch.float32).reshape(p.shape)


def static_pruning(inner: Optimizer, sparsity: float) -> Optimizer:
    """Static magnitude pruning around ``inner``: a mask per tensor, fixed
    at ``init`` from the parameters' magnitudes at the given sparsity,
    masks every gradient and update; the first update also sets the pruned
    weights to exactly 0. The state is :class:`PruningState` ``(inner,
    mask, first)``."""
    assert 0.0 <= sparsity < 1.0

    def init(params):
        dev = next(iter(params.values())).device if params else None
        return PruningState(inner.init(params),
                            {n: _prune_mask(p, sparsity)
                             for n, p in params.items()},
                            torch.ones((), dtype=torch.bool, device=dev))

    @torch.no_grad()
    def update(grads, st, params, step):
        grads = {n: g * st.mask[n].to(g.dtype) for n, g in grads.items()}
        upd, new_inner = inner.update(grads, st.inner, params, step)
        out = {}
        for n, u in upd.items():
            m = st.mask[n]
            u = u * m.to(u.dtype)
            out[n] = torch.where(st.first & (m < 0.5),
                                 -params[n].to(u.dtype), u)
        st.first.fill_(False)
        return out, PruningState(new_inner, st.mask, st.first)
    return Optimizer(init, update)
