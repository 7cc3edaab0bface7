"""The port's convolution, pooling and batch-norm layers against the JAX
package's (f32, CPU), on numpy inputs from a seed and bridged weights:

- ``Conv2D`` 1x1 under each ``set_conv1x1_impl`` lowering, at stride 1
  and 2, against the JAX layer's ``"pallas"`` path (``dw_pallas`` in
  interpret mode): output and the gradients of ``w``, ``b`` and ``x``;
- 3x3 convolutions at stride 1 and 2 on even and odd sizes, dilated and
  grouped, and the 7x7/2 stem with 3 input channels (JAX's space-to-depth
  rewrite on even sizes): ``lax``'s SAME padding is asymmetric at stride
  2;
- ``Pool2D`` max and average, SAME and VALID;
- ``BatchNorm`` with and without scale and shift, in training (output,
  gradients, the updated running ``mean``/``var``) and in evaluation on
  given running statistics;
- ``conv1x1_dw_plain`` against JAX's ``dw_pallas`` at M = 160, 34 and
  6144 (three 2048-row chunks).

Tolerances: outputs and gradients rtol and atol 1e-5 (f32, the same
math summed in other orders), a 3x3 or 7x7 weight gradient atol 1e-4
(sums over every output position and tap); relative to the tensor's
largest entry 1e-5 for BatchNorm's input gradient, whose closed form
cancels three terms, and for ``dw_pallas``, a sum of up to 6144
products whose entries range over orders of magnitude.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import pallas_conv
from paddle_tpu.nn.layers import set_conv1x1_impl as jset_impl
import paddle_tpu_torch as pt
from paddle_tpu_torch.nn import cuda_conv as cc
from paddle_tpu_torch.nn.layers import BatchNorm, Conv2D, Pool2D

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(seed, *shape):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _jax_conv(features, kernel, stride, x, impl, **kw):
    """JAX ``Conv2D`` under ``impl``: its variables, output and the
    gradients of ``sum(y * dy)`` with respect to params and x."""
    m = jnn.Conv2D(features, kernel, stride=stride, padding="SAME",
                   name="c", **kw)
    prev = jset_impl(impl)
    try:
        variables = m.init(jax.random.PRNGKey(0), jnp.asarray(x))
        y = m.apply(variables, jnp.asarray(x))
        dy = jnp.asarray(_np(7, *y.shape))
        gp, gx = jax.grad(lambda p, xx: jnp.sum(
            m.apply({"params": p}, xx) * dy), argnums=(0, 1))(
                variables["params"], jnp.asarray(x))
    finally:
        jset_impl(prev)
    return variables, np.asarray(y), np.array(dy), gp["c"], np.asarray(gx)


def _port_conv(cin, features, kernel, stride, variables, x, dy, impl,
               **kw):
    conv = Conv2D(cin, features, kernel, stride=stride, device="cpu", **kw)
    pt.load_jax_params(conv, variables)
    xt = torch.from_numpy(x).requires_grad_()
    prev = pt.set_conv1x1_impl(impl)
    try:
        y = conv(xt)
        (y * torch.from_numpy(dy)).sum().backward()
    finally:
        pt.set_conv1x1_impl(prev)
    return y.detach().numpy(), conv, xt.grad.numpy()


@pytest.mark.parametrize("impl", ["conv", "matmul", "pallas"])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1x1_matches_jax_pallas_path(impl, stride):
    x = _np(0, 2, 8, 8, 6)
    variables, y_j, dy, g_j, gx_j = _jax_conv(10, 1, stride, x, "pallas")
    y, conv, gx = _port_conv(6, 10, 1, stride, variables, x, dy, impl)
    np.testing.assert_allclose(y, y_j, **TOL)
    np.testing.assert_allclose(conv.w.grad.numpy(), np.asarray(g_j["w"]),
                               **TOL)
    np.testing.assert_allclose(conv.b.grad.numpy(), np.asarray(g_j["b"]),
                               **TOL)
    np.testing.assert_allclose(gx, gx_j, **TOL)


@pytest.mark.parametrize("cin,features,kernel,stride,size,kw", [
    (4, 8, 3, 1, 8, {}), (4, 8, 3, 1, 7, {}), (4, 8, 3, 2, 8, {}),
    (4, 8, 3, 2, 7, {}), (3, 16, 7, 2, 16, {}), (3, 16, 7, 2, 15, {}),
    (4, 8, 3, 1, 9, {"dilation": 2}), (4, 8, 3, 2, 8, {"groups": 2})])
def test_conv_same_padding_matches_jax(cin, features, kernel, stride, size,
                                       kw):
    x = _np(1, 2, size, size, cin)
    variables, y_j, dy, g_j, gx_j = _jax_conv(features, kernel, stride, x,
                                               "conv", **kw)
    y, conv, gx = _port_conv(cin, features, kernel, stride, variables, x,
                             dy, "pallas", **kw)
    assert y.shape == y_j.shape
    np.testing.assert_allclose(y, y_j, **TOL)
    np.testing.assert_allclose(conv.w.grad.numpy(), np.asarray(g_j["w"]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(gx, gx_j, **TOL)


@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("size", [8, 9])
def test_pool_matches_jax(kind, padding, size):
    x = _np(2, 2, size, size, 5)
    m = jnn.Pool2D(kind, 3, stride=2, padding=padding)
    want = np.asarray(m.apply({}, jnp.asarray(x)))
    got = Pool2D(kind, 3, stride=2, padding=padding)(torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_global_pool_matches_jax():
    x = _np(3, 2, 5, 6, 4)
    for kind in ("max", "avg"):
        want = np.asarray(jnn.GlobalPool(kind).apply({}, jnp.asarray(x)))
        got = pt.nn.GlobalPool(kind)(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax(train, affine):
    c = 6
    x = _np(6, 4, 5, 5, c) * 2 + 0.5
    dy = _np(8, 4, 5, 5, c)
    state = {"mean": 0.1 * _np(9, c), "var": 1 + np.abs(_np(10, c))}
    params = {"scale": 1 + 0.1 * _np(4, c), "shift": 0.1 * _np(5, c)}
    variables = {"params": {"bn": params if affine else {}},
                 "state": {"bn": state}}
    m = jnn.BatchNorm(use_scale_shift=affine, name="bn")

    def f(p, xx):
        out = m.apply({"params": p, "state": variables["state"]}, xx,
                      train=train, mutable=("state",))
        return jnp.sum(out[0] * dy), out

    (_, (y_j, new)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"],
                                         jnp.asarray(x))
    bn = BatchNorm(c, use_scale_shift=affine, device="cpu")
    pt.load_jax_params(bn, variables if affine else
                       {"state": variables["state"]})
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt, train=train)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    gxj = np.asarray(gx)
    np.testing.assert_allclose(xt.grad.numpy(), gxj, rtol=0,
                               atol=1e-5 * np.abs(gxj).max())
    if affine:
        np.testing.assert_allclose(bn.scale.grad.numpy(),
                                   np.asarray(gp["bn"]["scale"]), **TOL)
        np.testing.assert_allclose(bn.shift.grad.numpy(),
                                   np.asarray(gp["bn"]["shift"]), **TOL)
    want_state = new["state"]["bn"] if train else state
    np.testing.assert_allclose(bn.mean.numpy(),
                               np.asarray(want_state["mean"]), **TOL)
    np.testing.assert_allclose(bn.var.numpy(),
                               np.asarray(want_state["var"]), **TOL)
    if train:       # the running statistics moved
        assert not np.allclose(bn.mean.numpy(), state["mean"])


@pytest.mark.parametrize("m,cin,cout", [(160, 8, 24), (34, 8, 8),
                                        (6144, 16, 32)])
def test_conv1x1_dw_plain_matches_dw_pallas(m, cin, cout):
    x, dy = _np(11, m, cin), _np(12, m, cout)
    want = np.asarray(pallas_conv.dw_pallas(jnp.asarray(x), jnp.asarray(dy)))
    got = cc.conv1x1_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
