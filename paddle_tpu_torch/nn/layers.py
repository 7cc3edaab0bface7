"""Main-path layers — the port of ``Linear``, ``Embedding``,
``LayerNorm``, ``Dropout``, ``Conv2D``, ``Pool2D``, ``GlobalPool`` and
``BatchNorm`` from ``paddle_tpu/nn/layers.py``.

Parameters keep the JAX package's names and layouts (``Linear.w`` is
``[in, out]`` and applied as ``x @ w``; ``Conv2D.w`` is HWIO), so weights
cross from a JAX checkpoint by path name with no transposes
(``utils/bridge.py``). Images are NHWC at every module's interface, as in
JAX; a convolution hands cuDNN the NCHW view of the NHWC tensor, which is
channels-last, so nothing is copied. Initializers are
``core/initializers.py``'s, which follow ``paddle_tpu/core/initializers.py``
in distribution; they draw from an explicit :class:`torch.Generator`, so
the values differ from JAX's for the same seed.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core import initializers as I
from ..core.dtypes import current_policy
from ..core.initializers import (fan_in_uniform_, msra_normal_, normal_,
                                 xavier_uniform_)
from . import activations
from .policy_dot import policy_dot

__all__ = ["Linear", "Embedding", "LayerNorm", "Dropout", "Conv2D",
           "Pool2D", "GlobalPool", "BatchNorm", "set_conv1x1_impl",
           "fan_in_uniform_", "msra_normal_", "xavier_uniform_", "normal_"]

Pair = Union[int, Tuple[int, int]]


class Linear(nn.Module):
    """``act(x @ w + b)`` with ``w`` ``[in, out]``; the product runs in
    the policy's compute dtype and is returned in its accumulate dtype
    (:func:`~.policy_dot.policy_dot`), and the f32 bias is added there.
    ``use_bias=False`` leaves out ``b`` (no parameter, as the JAX tree has
    none); ``w_init``/``b_init`` are :mod:`~..core.initializers` fills."""

    def __init__(self, in_features: int, features: int, act="",
                 use_bias: bool = True, w_init=I.fan_in_uniform,
                 b_init=I.zeros, device=None, generator=None):
        super().__init__()
        self.act = activations.get(act)
        self.w = nn.Parameter(torch.empty(in_features, features,
                                          device=device))
        w_init(self.w, generator)
        self.b = None
        if use_bias:
            self.b = nn.Parameter(torch.empty(features, device=device))
            b_init(self.b, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = policy_dot(x, self.w)
        return self.act(y if self.b is None else y + self.b)


class Embedding(nn.Module):
    """Table lookup ``w[ids]``; out-of-range ids (padding = -1, or past
    the vocabulary) give zero rows where ``torch``'s lookup would raise.
    :meth:`attend` is the tied readout ``x @ w.T``. ``w_init`` (an
    initializer of ``core/initializers.py``, ``(tensor, generator)``)
    fills the table; without one it is N(0, ``std``²), ``std`` default
    ``1 / sqrt(dim)`` as in JAX."""

    def __init__(self, vocab: int, dim: int, std: Optional[float] = None,
                 w_init=None, device=None, generator=None):
        super().__init__()
        self.vocab = vocab
        self.dim = dim
        self.w = nn.Parameter(torch.empty(vocab, dim, device=device))
        if w_init is not None:
            w_init(self.w, generator)
        else:
            normal_(self.w, 1.0 / math.sqrt(dim) if std is None else std,
                    generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        valid = (ids >= 0) & (ids < self.vocab)
        out = self.w[ids.clamp(0, self.vocab - 1)]
        return out * valid.unsqueeze(-1).to(out.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ w.T`` in ``x``'s dtype whatever the policy, as in JAX (the
        transformer's readout takes f32 activations)."""
        return x @ self.w.T


class LayerNorm(nn.Module):
    """Layer normalization with f32 statistics and ``eps`` (default
    ``1e-6``, JAX's; torch's is ``1e-5``); ``use_scale``/``use_bias`` keep
    the affine ``scale`` and ``bias`` parameters (without one, the module
    has no such parameter, as in JAX). The result is cast back to the
    input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, use_scale: bool = True,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device)) \
            if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim, device=device)) \
            if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        if self.scale is not None:
            y = y * self.scale
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


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


def _pair(v: Pair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_padding(padding):
    """Normalize padding: "SAME"/"VALID", int p, (pad_h, pad_w), or explicit
    [(lo, hi), (lo, hi)] — matching the kernel/stride (h, w) convention."""
    if isinstance(padding, str):
        return padding
    if isinstance(padding, int):
        return [(padding, padding), (padding, padding)]
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        return [tuple(p) for p in padding]
    ph, pw = padding
    return [(ph, ph), (pw, pw)]


def _pads(padding, size: Sequence[int], window: Tuple[int, int],
          stride: Tuple[int, int], dilation: Tuple[int, int] = (1, 1)):
    """``[(lo, hi), (lo, hi)]`` over H and W with ``lax``'s rules: SAME
    pads ``max((ceil(n / s) - 1) * s + (k - 1) * d + 1 - n, 0)`` in all,
    the low side taking the smaller half — asymmetric at stride 2, where
    ``torch``'s own padding is symmetric."""
    if padding == "VALID":
        return [(0, 0), (0, 0)]
    if padding != "SAME":
        return [tuple(p) for p in padding]
    out = []
    for n, k, s, d in zip(size, window, stride, dilation):
        total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
        out.append((total // 2, total - total // 2))
    return out


def _pad_nhwc(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
    (hl, hh), (wl, wh) = pads
    if not (hl or hh or wl or wh):
        return x
    return F.pad(x, (0, 0, wl, wh, hl, hh), value=value)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """The NCHW view of an NHWC tensor (channels-last, no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


# How 1x1 convs lower: "conv" = the convolution (cuDNN on the card);
# "matmul" = reshape + product; "pallas" = the product forward with the
# conv1x1_dw CUDA kernel for the weight gradient (nn/cuda_conv.py). The
# JAX name "pallas" is kept so one switch selects the same path on both.
_CONV1X1_IMPL = "conv"


def set_conv1x1_impl(impl: str) -> str:
    """Select the 1x1-conv lowering globally; returns the previous value.
    Read at every call (JAX reads it when a step is traced), so it takes
    effect at the next forward."""
    global _CONV1X1_IMPL
    if impl not in ("conv", "matmul", "pallas"):
        raise ValueError(f"unknown 1x1-conv lowering {impl!r}")
    prev, _CONV1X1_IMPL = _CONV1X1_IMPL, impl
    return prev


class Conv2D(nn.Module):
    """2-D convolution over NHWC activations with an HWIO kernel ``w``
    ``[kh, kw, in_channels // groups, features]`` and, with ``use_bias``,
    ``b [features]``. A 1x1 kernel without padding, dilation or groups
    takes the product path that :func:`set_conv1x1_impl` selects; every
    other convolution is ``F.conv2d`` after an explicit ``lax``-rule pad.
    The JAX layer's space-to-depth rewrite of the 7x7/2 stem is the same
    math to f32 roundoff (under ``bfloat16_compute`` to one bf16 ulp of
    the output), so the plain convolution stands in for it. Every branch
    casts ``x`` and ``w`` to the policy's compute dtype and returns it, as
    the JAX layer does (a bf16 convolution sums in f32 and rounds once).
    ``in_channels`` is given here; JAX infers it at init. ``w_init`` (an
    initializer of ``core/initializers.py``) fills ``w``, MSRA normal by
    default as in JAX."""

    def __init__(self, in_channels: int, features: int, kernel: Pair,
                 stride: Pair = 1, padding="SAME", dilation: Pair = 1,
                 groups: int = 1, act="", use_bias: bool = True,
                 w_init=msra_normal_, device=None, generator=None):
        super().__init__()
        self.features = features
        self.kernel = _pair(kernel)
        self.stride = _pair(stride)
        self.padding = _conv_padding(padding)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.act = activations.get(act)
        kh, kw = self.kernel
        self.w = nn.Parameter(torch.empty(kh, kw, in_channels // groups,
                                          features, device=device))
        w_init(self.w, generator)
        self.b = nn.Parameter(torch.zeros(features, device=device)) \
            if use_bias else None

    def _is_1x1(self) -> bool:
        pad_free = (self.padding in ("SAME", "VALID")
                    or all(p == (0, 0) for p in self.padding))
        return (self.kernel == (1, 1) and self.dilation == (1, 1)
                and self.groups == 1 and pad_free)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pol = current_policy()
        xc, w = pol.cast_compute(x), pol.cast_compute(self.w)
        if self._is_1x1() and _CONV1X1_IMPL != "conv":
            from . import cuda_conv
            y = cuda_conv.conv1x1_strided(
                xc, w.reshape(w.shape[2], self.features), self.stride,
                kernel_dw=_CONV1X1_IMPL == "pallas")
        else:
            pads = _pads(self.padding, xc.shape[1:3], self.kernel,
                         self.stride, self.dilation)
            y = _nhwc(F.conv2d(_nchw(_pad_nhwc(xc, pads)),
                               w.permute(3, 2, 0, 1), stride=self.stride,
                               dilation=self.dilation, groups=self.groups))
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return self.act(y)


class Pool2D(nn.Module):
    """Max or average pooling over NHWC with ``lax``'s padding rules: a
    max pool pads with ``-inf``; a SAME average divides each window's sum
    by its count of real (unpadded) entries, a VALID one by the window
    size."""

    def __init__(self, kind: str, window: Pair,
                 stride: Optional[Pair] = None, padding="VALID"):
        super().__init__()
        if kind not in ("max", "avg"):
            raise ValueError(f"unknown pooling {kind!r}")
        self.kind = kind
        self.window = _pair(window)
        self.stride = _pair(stride if stride is not None else window)
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _pads(self.padding, x.shape[1:3], self.window, self.stride)
        if self.kind == "max":
            xp = _pad_nhwc(x, pads, float("-inf"))
            return _nhwc(F.max_pool2d(_nchw(xp), self.window, self.stride))

        def window_sum(t):
            return _nhwc(F.avg_pool2d(_nchw(_pad_nhwc(t, pads)), self.window,
                                      self.stride, divisor_override=1))

        s = window_sum(x)
        if self.padding == "VALID":
            return s / (self.window[0] * self.window[1])
        cnt = window_sum(torch.ones(x.shape[:3] + (1,), dtype=x.dtype,
                                    device=x.device))
        return s / cnt.clamp_min(1.0)


class GlobalPool(nn.Module):
    """Global spatial pooling, NHWC to ``[N, C]``."""

    def __init__(self, kind: str = "avg"):
        super().__init__()
        if kind not in ("max", "avg"):
            raise ValueError(f"unknown pooling {kind!r}")
        self.kind = kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax((1, 2)) if self.kind == "max" else x.mean((1, 2))


class _BNTrainNorm(torch.autograd.Function):
    """``(x - mean) * inv * gamma + beta`` with the closed-form batch-norm
    backward of the JAX ``_bn_train_norm`` ``custom_vjp``: two reductions,
    ``sum(dy)`` and ``sum(dy * xhat)``, then ``dx = gamma * inv * (dy -
    sum(dy) / n - xhat * sum(dy * xhat) / n)``. That is the total
    derivative (the batch statistics' dependence on ``x`` folded in), so
    ``mean`` and ``inv`` get no gradient."""

    @staticmethod
    def forward(ctx, x, mean, inv, gamma, beta):
        ctx.save_for_backward(x, mean, inv, gamma)
        xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        return xhat * gamma.to(x.dtype) + beta.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, inv, gamma = ctx.saved_tensors
        axes = tuple(range(x.dim() - 1))
        n = x.numel() // x.shape[-1]
        xhat = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        dbeta = dy.sum(axes, dtype=torch.float32)
        dgamma = (dy * xhat).sum(axes, dtype=torch.float32)
        scale = (gamma * inv).to(x.dtype)
        dx = scale * (dy - (dbeta / n).to(x.dtype)
                      - xhat * (dgamma / n).to(x.dtype))
        return dx, None, None, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


class BatchNorm(nn.Module):
    """Batch normalization over the last (channel) axis with running
    statistics in the buffers ``mean`` and ``var`` (the JAX ``"state"``
    collection). Not ``torch``'s: in training the batch variance is the
    biased one-pass ``max(E[x^2] - E[x]^2, 0)`` in f32, and the running
    statistics move as ``momentum * old + (1 - momentum) * batch`` with
    momentum 0.9; eps is 1e-5. ``train=False`` normalizes with the running
    statistics."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5, use_scale_shift: bool = True,
                 device=None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        if use_scale_shift:
            self.scale = nn.Parameter(torch.ones(features, device=device))
            self.shift = nn.Parameter(torch.zeros(features, device=device))
        else:
            self.scale = self.shift = None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        affine = self.scale is not None
        if train:
            axes = tuple(range(x.dim() - 1))
            n = x.numel() // x.shape[-1]
            # the closed-form backward carries the statistics' gradient
            xf = (x.detach() if affine else x).float()
            mean = xf.sum(axes) / n
            var = ((xf * xf).sum(axes) / n - mean * mean).clamp_min(0.0)
            m = self.momentum
            with torch.no_grad():
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps)
        if train and affine:
            return _BNTrainNorm.apply(x, mean, inv, self.scale, self.shift)
        y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
        if affine:
            y = y * self.scale.to(x.dtype) + self.shift.to(x.dtype)
        return y
