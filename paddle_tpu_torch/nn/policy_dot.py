"""The dtype policy's product — the port of ``jnp.dot(cast_compute(x),
cast_compute(w), preferred_element_type=accum_dtype)``, which ``Linear``,
``MultiHeadAttention``'s projections and the ResNet head run in the JAX
package.

Under :data:`~paddle_tpu_torch.core.dtypes.float32` it is ``x @ w`` in f32.
Under a policy whose compute dtype differs from its accumulate dtype
(:data:`~paddle_tpu_torch.core.dtypes.bfloat16_compute`) it is
:class:`PolicyDot`: both operands cast to bf16, their products summed and
returned in f32, never rounded to bf16 first. On the CPU the operands are
widened back to f32 and multiplied there (products of bf16 values are
exact in f32, so this is the JAX CPU result up to the order of the sum);
on the card it is one cuBLAS product with bf16 operands and an f32 output
(``torch.mm(..., out_dtype=torch.float32)``), on the tensor cores. This
product lies outside any Pallas kernel of the JAX package, which leaves
it to XLA, so a library call is the port's counterpart.

The backward is JAX's VJP of that dot: each operand's gradient is the f32
cotangent times the other operand's bf16 value, summed in f32, rounded to
the operand's compute dtype (the gradient of the cast) and widened to the
operand's own dtype. cuBLAS has no f32 x bf16 product, so on the card the
cotangent ``g`` is split into bf16 halves, ``hi = bf16(g)`` and ``lo =
bf16(g - hi)``, and the two products are added in f32: ``g - hi - lo`` is
about 2^-16 of ``|g|``, far below the bf16 rounding that follows, so a
gradient differs from JAX's by at most one bf16 ulp, and only where the
f32 sum lies within that residue of a rounding boundary. The backward
reads no policy (autograd may run it on another thread): its dtypes come
from the saved operands.
"""

from __future__ import annotations

import torch

from ..core.dtypes import current_policy

__all__ = ["PolicyDot", "policy_dot"]


def policy_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` under the current policy: operands in its
    compute dtype, the result in its accumulate dtype."""
    pol = current_policy()
    if pol.compute_dtype == pol.accum_dtype:
        return (pol.cast_compute(x) @ pol.cast_compute(w)).to(pol.accum_dtype)
    return PolicyDot.apply(x, w, pol.compute_dtype, pol.accum_dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` of two operands of one dtype, summed and
    returned in ``out_dtype``."""
    if a.device.type == "cpu":
        return a.to(out_dtype) @ b.to(out_dtype)
    return torch.mm(a, b, out_dtype=out_dtype)


def _mm_wide(a: torch.Tensor, b: torch.Tensor, low) -> torch.Tensor:
    """``a @ b`` in f32 where one operand is f32 and the other is of the
    compute dtype ``low``; on the card the f32 operand is split into
    ``low`` halves (see the module's note)."""
    if a.device.type == "cpu":
        return a.float() @ b.float()
    if a.dtype == low:
        hi = b.to(low)
        return _mm(a, hi, torch.float32) + _mm(
            a, (b - hi.float()).to(low), torch.float32)
    hi = a.to(low)
    return _mm(hi, b, torch.float32) + _mm(
        (a - hi.float()).to(low), b, torch.float32)


class PolicyDot(torch.autograd.Function):
    """``x [..., K] @ w [K, N]`` with operands cast to ``compute`` and the
    sum returned in ``accum``; the backward is JAX's VJP (module note)."""

    @staticmethod
    def forward(ctx, x, w, compute, accum):
        xc, wc = x.to(compute), w.to(compute)
        ctx.save_for_backward(xc, wc)
        ctx.in_dtypes = (x.dtype, w.dtype)
        y = _mm(xc.reshape(-1, xc.shape[-1]), wc, accum)
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        low = xc.dtype
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm_wide(g2, wc.T, low).to(low).to(ctx.in_dtypes[0]) \
                .reshape(xc.shape)
        if ctx.needs_input_grad[1]:
            x2 = xc.reshape(-1, xc.shape[-1])
            dw = _mm_wide(x2.T, g2, low).to(low).to(ctx.in_dtypes[1])
        return dx, dw, None, None
